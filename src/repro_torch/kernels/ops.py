"""Entry points of the kernels, the counterpart of the reference package's
kernels/ops.py for the functions ported so far.

A CUDA tensor goes to the hand-written CUDA kernel (or raises), a CPU tensor
to the kernel's plain PyTorch version. The plain versions can be asked for
by name on either device: attention through
`models.attention.AttnSettings(backend="naive")`, the mLSTM scan through
`mlstm_scan(backend="naive")` (`models.ModelSettings(mlstm_backend=...)`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention_fwd, decode_attention_plain,
)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_fwd, flash_attention_plain,
)
from repro_torch.kernels.flash_attention_bwd import (  # noqa: F401
    flash_attention_bwd, flash_attention_bwd_plain,
)
from repro_torch.kernels.mlstm_scan import (  # noqa: F401
    NEG_INF, mlstm_scan_fwd, mlstm_scan_plain,
)
from repro_torch.kernels.paged_decode import (  # noqa: F401
    paged_decode_attention, paged_decode_attention_plain,
)
from repro_torch.kernels.paged_prefill import (  # noqa: F401
    paged_prefill_attention, paged_prefill_attention_plain,
)

MLSTM_BACKENDS = ("kernel", "naive")


def decode_attention(q, k_cache, v_cache, cache_pos, positions, *,
                     window: Optional[int] = None,
                     chunk: Optional[int] = None, kv_block: int = 512):
    """Ring decode: q [b,K,G,hd]; caches [b,L,K,hd]; cache_pos [b,L];
    positions [b] -> [b,K,G,hd] (decode_attention_fwd: the CUDA kernel for
    a CUDA tensor, its plain version for a CPU tensor)."""
    return decode_attention_fwd(q, k_cache, v_cache, cache_pos, positions,
                                window=window, chunk=chunk,
                                kv_block=kv_block)


def flash_attention(q, k, v, qpos, kpos, *, window: Optional[int] = None,
                    chunk: Optional[int] = None):
    """q [b,s,K,G,hd]; k/v [b,s,K,hd]; qpos/kpos [b,s] -> [b,s,K,G,hd]."""
    b, s, K, G, hd = q.shape
    out = flash_attention_fwd(q.reshape(b, s, K * G, hd), k, v, qpos, kpos,
                              window=window, chunk=chunk)
    return out.reshape(b, s, K, G, hd)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel with lse, the
    dQ / dK-dV kernels for the gradient (each wrapper's plain version for
    CPU tensors; never the plain version for a CUDA tensor). q [b,s,H,hd];
    k/v [b,s,K,hd]."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, window, chunk):
        out, lse = flash_attention_fwd(q, k, v, qpos, kpos, window=window,
                                       chunk=chunk, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, qpos, kpos)
        ctx.window, ctx.chunk = window, chunk
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, qpos, kpos = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.to(q.dtype),
                                         qpos, kpos, window=ctx.window,
                                         chunk=ctx.chunk)
        return dq, dk, dv, None, None, None, None


def flash_attention_trainable(q, k, v, qpos, kpos, *,
                              window: Optional[int] = None,
                              chunk: Optional[int] = None):
    """Differentiable flash attention (forward kernel + dQ / dK-dV kernels),
    the counterpart of the reference's ops.flash_attention_trainable.
    q [b,s,K,G,hd]; k/v [b,s,K,hd]; qpos/kpos [b,s] -> [b,s,K,G,hd]. The
    gradients are dq [b,s,K,G,hd] and dk/dv [b,s,K,hd] in the inputs' dtype
    (GQA taken natively: no repeat of K/V to the query heads), none for the
    positions."""
    b, s, K, G, hd = q.shape
    out = _FlashAttention.apply(q.reshape(b, s, K * G, hd), k, v, qpos, kpos,
                                window, chunk)
    return out.reshape(b, s, K, G, hd)


# ---------------------------------------------------------------------------
# mLSTM chunked scan
# ---------------------------------------------------------------------------

def mlstm_scan(q, k, v, i_gate, f_gate, *, chunk: int = 128,
               backend: str = "kernel", initial=None):
    """q, k [b,s,h,dk]; v [b,s,h,dv]; gates [b,s,h].

    `initial` optionally continues a sequence mid-prompt from carried state
    (C [b,h,dk,dv], n [b,h,dk], m [b,h,1]) — serving chunked prefill; None
    is a fresh sequence. backend "kernel" folds the heads into
    mlstm_scan_fwd (the CUDA kernel on the card), "naive" into its plain
    version. Returns (out [b,s,h,dv], state (C [b,h,dk,dv], n [b,h,dk],
    m [b,h,1])), new tensors.

    A length above the chunk that the chunk does not divide (a whole prompt
    of 200 at chunk 128) is padded to a multiple of it with
    state-transparent steps, as chunked prefill pads its chunks (i = -1e30,
    f = 1e4: the state passes through them unchanged), where the
    reference's scan refuses it (its fault F6); mlstm_scan_fwd and the
    plain version themselves still refuse such a length, as the
    reference's scan does."""
    if backend not in MLSTM_BACKENDS:
        raise ValueError(f"mlstm backend {backend!r} not in {MLSTM_BACKENDS}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    pad = (-s) % int(chunk) if s > int(chunk) else 0
    if pad:
        def tail(t, fill):
            return torch.cat([t, t.new_full((b, pad) + tuple(t.shape[2:]),
                                            fill)], dim=1)
        out, st = mlstm_scan(tail(q, 0.0), tail(k, 0.0), tail(v, 0.0),
                             tail(i_gate, NEG_INF), tail(f_gate, 1e4),
                             chunk=chunk, backend=backend, initial=initial)
        return out[:, :s], st

    def fold(t):
        return t.movedim(2, 1).reshape((b * h, s) + tuple(t.shape[3:]))

    init_f = (None if initial is None
              else (initial[0].reshape(b * h, dk, dv),
                    initial[1].reshape(b * h, dk),
                    initial[2].reshape(b * h, 1)))
    fn = mlstm_scan_fwd if backend == "kernel" else mlstm_scan_plain
    out, (C, n, m) = fn(fold(q), fold(k), fold(v), fold(i_gate),
                        fold(f_gate), chunk=chunk, initial=init_f)
    out = out.reshape(b, h, s, dv).movedim(1, 2)
    return out, (C.reshape(b, h, dk, dv), n.reshape(b, h, dk),
                 m.reshape(b, h, 1))


def mlstm_decode_step(q, k, v, i_gate, f_gate, state):
    """Single-token mLSTM update in plain PyTorch (the reference package has
    no kernel for it). q, k [b,h,dk]; v [b,h,dv]; gates [b,h]; state (C, n,
    m [b,h,1]) -> (out [b,h,dv], new state), new tensors."""
    C, n, m = state
    m = m[..., 0]
    dk = q.shape[-1]
    ig = i_gate.float()
    logf = F.logsigmoid(f_gate.float())
    m_new = torch.maximum(logf + m, ig)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(ig - m_new)
    kf, vf = k.float(), v.float()
    C = fp[..., None, None] * C + ip[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = fp[..., None] * n + ip[..., None] * kf
    qs = q.float() / float(np.sqrt(dk))
    num = torch.einsum("bhk,bhkv->bhv", qs, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qs, n).abs(),
                        torch.exp(-m_new))
    out = (num / den[..., None]).to(v.dtype)
    return out, (C, n, m_new[..., None])
