"""Gemma-3-12B [hf:google/gemma-3 family] — 5 local : 1 global, 128k context.

48L, d_model=3840, 16 heads (GQA kv=8), head_dim=256, d_ff=15360 (GeGLU),
vocab 262144. Local window 1024; every 6th layer global. Unit = 6 layers,
8 repeats.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, ATTN, MLP_DENSE

_LOCAL = BlockSpec(mixer=ATTN, mlp=MLP_DENSE, window=1024)
_GLOBAL = BlockSpec(mixer=ATTN, mlp=MLP_DENSE, window=None)

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    unit=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    activation="geglu",
    rope_theta=1_000_000.0,
    logits_softcap=30.0,
    tie_embeddings=True,
)
