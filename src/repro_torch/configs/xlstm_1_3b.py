"""xLSTM-1.3B [arXiv:2405.04517] — sLSTM + mLSTM blocks, no separate FFN.

48 blocks, d_model=2048, 4 heads, vocab 50304, d_ff=0 (the mLSTM block embeds
a 2x up-projection; the sLSTM block carries a 4/3 GLU ff). Pattern: xLSTM[7:1]
— 7 mLSTM : 1 sLSTM per unit, 6 unit repeats.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, MLSTM, SLSTM, MLP_NONE

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    unit=tuple([BlockSpec(mixer=MLSTM, mlp=MLP_NONE)] * 7
               + [BlockSpec(mixer=SLSTM, mlp=MLP_NONE)]),
    activation="gelu",
    mlstm_proj_factor=2.0,
    mlstm_qk_blocksize=4,
    slstm_ff_factor=4.0 / 3.0,
    tie_embeddings=False,
)
