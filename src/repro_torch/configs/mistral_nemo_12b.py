"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407] — dense, 128k ctx.

40L, d_model=5120, 32 heads (GQA kv=8), head_dim=128, d_ff=14336 (SwiGLU),
vocab 131072, full attention.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, ATTN, MLP_DENSE

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    unit=(BlockSpec(mixer=ATTN, mlp=MLP_DENSE, window=None),),
    activation="swiglu",
    rope_theta=1_000_000.0,
)
