"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427] — RG-LRU + local attention.

38 blocks, d_model=4096, local-attn 16 heads but MQA kv=1, d_ff=12288
(GeGLU), vocab 256000, lru_width=4096, window 2048. Pattern: (rec, rec,
attn) ×12 + (rec, rec) tail = 38.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, ATTN, RGLRU, MLP_DENSE

_REC = BlockSpec(mixer=RGLRU, mlp=MLP_DENSE)
_ATT = BlockSpec(mixer=ATTN, mlp=MLP_DENSE, window=2048)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    unit=(_REC, _REC, _ATT),
    tail=(_REC, _REC),
    activation="geglu",
    lru_width=4096,
    conv_width=4,
    tie_embeddings=True,
)
