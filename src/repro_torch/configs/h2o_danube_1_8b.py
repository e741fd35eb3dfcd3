"""H2O-Danube-1.8B [arXiv:2401.16818; hf] — llama+mistral mix with SWA.

24L, d_model=2560, 32 heads (GQA kv=8), d_ff=6912 (SwiGLU), vocab 32000,
sliding-window attention (mistral-style, window 4096).
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, ATTN, MLP_DENSE

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    unit=(BlockSpec(mixer=ATTN, mlp=MLP_DENSE, window=4096),),
    activation="swiglu",
)
