"""Entry points of the attention kernels, the counterpart of the reference
package's kernels/ops.py for the functions ported so far.

There is no backend switch here: a CUDA tensor goes to the hand-written CUDA
kernel (or raises), a CPU tensor to the kernel's plain PyTorch version. The
plain versions can be asked for by name on either device through
`models.attention.AttnSettings(backend="naive")`.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_fwd, flash_attention_plain,
)
from repro_torch.kernels.paged_decode import (  # noqa: F401
    paged_decode_attention, paged_decode_attention_plain,
)
from repro_torch.kernels.paged_prefill import (  # noqa: F401
    paged_prefill_attention, paged_prefill_attention_plain,
)


def flash_attention(q, k, v, qpos, kpos, *, window: Optional[int] = None,
                    chunk: Optional[int] = None):
    """q [b,s,K,G,hd]; k/v [b,s,K,hd]; qpos/kpos [b,s] -> [b,s,K,G,hd]."""
    b, s, K, G, hd = q.shape
    out = flash_attention_fwd(q.reshape(b, s, K * G, hd), k, v, qpos, kpos,
                              window=window, chunk=chunk)
    return out.reshape(b, s, K, G, hd)
