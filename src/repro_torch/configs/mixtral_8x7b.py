"""Mixtral-8x7B [arXiv:2401.04088; hf] — 8-expert top-2 MoE with SWA.

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336 per expert (SwiGLU),
vocab 32000, sliding window 4096.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, ATTN, MLP_MOE

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    unit=(BlockSpec(mixer=ATTN, mlp=MLP_MOE, window=4096),),
    activation="swiglu",
    n_experts=8,
    top_k=2,
    capacity_factor=1.25,
    rope_theta=1_000_000.0,
)
