"""Entry points of the attention kernels, the counterpart of the reference
package's kernels/ops.py for the two paged functions.

There is no backend switch here: a CUDA tensor goes to the hand-written CUDA
kernel (or raises), a CPU tensor to the kernel's plain PyTorch version. The
plain versions can be asked for by name on either device through
`models.attention.AttnSettings(backend="naive")`.
"""
from __future__ import annotations

from repro_torch.kernels.paged_decode import (  # noqa: F401
    paged_decode_attention, paged_decode_attention_plain,
)
from repro_torch.kernels.paged_prefill import (  # noqa: F401
    paged_prefill_attention, paged_prefill_attention_plain,
)
