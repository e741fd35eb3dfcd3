"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE top-1.

48L, d_model=5120, 40 heads (GQA kv=8), d_ff=8192 per expert, vocab 202048,
16 experts top-1. iRoPE pattern: 3 chunked-local (8192) : 1 global-NoPE.
Early-fusion multimodal frontend is a STUB (text tokens only; the vision
tower contributes via n_prefix_embeds=0 here — Scout's text path).
Note: HF Scout interleaves a shared expert; we fold it into the routed
experts (documented deviation, DESIGN.md §9).
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, ATTN, MLP_MOE

_LOCAL = BlockSpec(mixer=ATTN, mlp=MLP_MOE, chunk=8192)
_GLOBAL = BlockSpec(mixer=ATTN, mlp=MLP_MOE, window=None, rope=False)

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    unit=(_LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    activation="swiglu",
    n_experts=16,
    top_k=1,
    capacity_factor=1.25,
    rope_theta=500_000.0,
)
