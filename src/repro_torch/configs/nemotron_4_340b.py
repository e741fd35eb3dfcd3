"""Nemotron-4-340B [arXiv:2402.16819] — dense GQA + squared-ReLU MLP.

96L, d_model=18432, 96 heads (GQA kv=8), d_ff=73728, vocab 256000.
The capacity-planning flagship: 340B params cannot fit v5e HBM without the
WSMC planner choosing FSDP + factored/low-precision optimizer state.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, ATTN, MLP_DENSE

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    unit=(BlockSpec(mixer=ATTN, mlp=MLP_DENSE, window=None),),
    activation="squared_relu",
    rope_theta=10_000.0,
)
