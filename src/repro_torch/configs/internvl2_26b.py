"""InternVL2-26B [arXiv:2404.16821; hf] — InternViT-6B + InternLM2-20B.

Backbone (this config): 48L, d_model=6144, 48 heads (GQA kv=8), head_dim=128,
d_ff=16384 (SwiGLU), vocab 92553. The InternViT vision tower is a STUB per
the assignment: input_specs() provides 1024 precomputed patch embeddings
(b, 1024, d_model) which the model prepends to the token embeddings.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, ATTN, MLP_DENSE

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    unit=(BlockSpec(mixer=ATTN, mlp=MLP_DENSE, window=None),),
    activation="swiglu",
    n_prefix_embeds=1024,
)
