"""Flash attention forward: wrapper of the CUDA kernel, and the plain PyTorch
version.

Replaces the TPU kernel kernels/flash_attention.py · flash_attention_fwd of
the reference package: GQA attention of a whole sequence over itself under
the causal / window / chunk position mask, the attention of whole-prompt
prefill and of the training forward (with the row log-sum-exp the backward
kernel reads). On this card the function is bound by operations for prompts above
a few hundred positions and by bytes for short ones; the kernel keeps the
online-softmax state on chip, reads each K/V tile once for the G query heads
that share it, and skips tiles from the positions themselves
(csrc/flash_attention.cu). bf16 inputs run its tensor-core body (mma.sync,
cp.async), f32 inputs its CUDA-core body; the launch reports which one ran
(`last_body`).

The wrapper launches the kernel for CUDA tensors and raises if it cannot;
it takes the plain version only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import _Q_DTYPES

SOURCE = "flash_attention.cu"

NEG_INF = -1e30

# launches of the CUDA kernel made by flash_attention_fwd (and by nothing
# else): a run can show that its path went through the kernel
launches = 0
# the body the last launch ran, as the C entry point reports it
BODIES = {0: "cuda-core f32", 1: "tensor-core bf16"}
last_body = None

_fn = None


def _bound():
    global _fn
    if _fn is None:
        fn = build.library(SOURCE).flash_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 9 + [ctypes.c_float,
                                           ctypes.POINTER(i), p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def compute_dtype(t) -> torch.dtype:
    """The plain versions' arithmetic type: f32, or f64 for f64 inputs (so
    that torch.autograd.gradcheck can run through them)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def flash_attention_plain(q, k, v, qpos, kpos, *,
                          window: Optional[int] = None,
                          chunk: Optional[int] = None,
                          return_lse: bool = False):
    """The plain PyTorch version: dense masked softmax in f32 (f64 for f64
    inputs). q [b,sq,H,hd]; k/v [b,sk,K,hd]; qpos [b,sq], kpos [b,sk] ->
    out [b,sq,H,hd] in q's dtype (+ lse [b,sq,H] in the arithmetic type).
    Masked scores are -1e30 and their weight 0, so a row that sees nothing
    gives 0, as the kernel does."""
    from repro_torch.configs.base import BlockSpec
    from repro_torch.models.attention import _mask
    ct = compute_dtype(q)
    b, sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.to(ct).reshape(b, sq, K, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(ct)) * float(
        1.0 / np.sqrt(hd))
    mask = _mask(qpos, kpos, BlockSpec(window=window, chunk=chunk))
    mask = mask[:, None, None]                          # [b, 1, 1, sq, sk]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = torch.clamp(p.sum(dim=-1), min=1e-30)           # [b, K, G, sq]
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(ct))
    o = o / l.permute(0, 3, 1, 2)[..., None]
    out = o.reshape(b, sq, H, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = (m[..., 0] + torch.log(l)).permute(0, 3, 1, 2).reshape(b, sq, H)
    return out, lse


def check_head_dim(dtype, hd: int) -> None:
    """The tensor-core bodies (bf16) read rows in 16-byte pieces: hd must
    be a multiple of 8 (and at most 256)."""
    if dtype == torch.bfloat16 and (hd % 8 or hd > 256):
        raise ValueError(f"bf16 head_dim {hd} not supported (a multiple of "
                         "8, at most 256)")


def _aligned(t):
    """Contiguous, with a 16-byte aligned base (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_fwd(q, k, v, qpos, kpos, *,
                        window: Optional[int] = None,
                        chunk: Optional[int] = None,
                        return_lse: bool = False):
    """q [b,sq,H,hd] (f32 or bf16); k/v [b,sk,K,hd] in q's dtype, H a
    multiple of K (query head h reads kv head h // (H // K)); qpos [b,sq],
    kpos [b,sk] int32 (-1 = padding). Returns out [b,sq,H,hd] in q's dtype
    (+ lse [b,sq,H] f32 when return_lse). bf16 needs hd a multiple of 8.

    CUDA tensors go to the CUDA kernel (built at first use; a failed build
    or launch raises); CPU tensors to the plain version. Any sq and sk: the
    positions decide what is visible, not the indices."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, qpos, kpos, window=window,
                                     chunk=chunk, return_lse=return_lse)
    global launches, last_body
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (f32, bf16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("k/v must have q's dtype")
    b, sq, H, hd = q.shape
    check_head_dim(q.dtype, hd)
    sk, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, sk, K, hd) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} must be "
                         f"[{b}, sk, K, {hd}]")
    if K < 1 or H % K:
        raise ValueError(f"{H} query heads do not split over {K} kv heads")
    if tuple(qpos.shape) != (b, sq) or tuple(kpos.shape) != (b, sk):
        raise ValueError("qpos must be [b, sq] and kpos [b, sk]")
    if qpos.dtype != torch.int32 or kpos.dtype != torch.int32:
        raise TypeError("qpos/kpos must be int32")
    if sq == 0 or sk == 0 or b == 0:
        raise ValueError(f"empty attention: b={b}, sq={sq}, sk={sk}")
    for name, t in (("k", k), ("v", v), ("qpos", qpos), ("kpos", kpos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    qpos, kpos = qpos.contiguous(), kpos.contiguous()
    o = torch.empty_like(q)
    lse = (torch.empty((b, sq, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    body = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        rc = _bound()(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
            build.ptr(lse), build.ptr(qpos), build.ptr(kpos), b, sq, sk, K,
            H // K, hd, _Q_DTYPES[q.dtype], int(window or 0),
            int(chunk or 0), ctypes.c_float(1.0 / np.sqrt(hd)),
            ctypes.byref(body), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_launch failed (code {rc}; -1 = shape not "
            f"supported) for q {tuple(q.shape)}, k {tuple(k.shape)}")
    launches += 1
    last_body = BODIES[body.value]
    return (o, lse) if return_lse else o
