"""MusicGen-medium [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

48L, d_model=1536, 24 heads (MHA: kv=24), d_ff=6144 (GELU), vocab 2048
(EnCodec codebook). Modality frontend (EnCodec encoder + delay-pattern
interleave) is a STUB per the assignment: input_specs() provides the token
stream directly; the backbone is a standard full-attention decoder.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, ATTN, MLP_DENSE

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    unit=(BlockSpec(mixer=ATTN, mlp=MLP_DENSE, window=None),),
    activation="gelu",
    # Audio frontend stub: 0 prefix embeds — EnCodec tokens ARE the stream.
    n_prefix_embeds=0,
)
