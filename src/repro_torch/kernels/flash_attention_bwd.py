"""Flash attention backward: wrapper of the CUDA kernels, and the plain
PyTorch version.

Replaces the TPU kernels kernels/flash_attention_bwd.py · flash_attention_bwd
(_dq_kernel and _dkv_kernel) of the reference package: dQ, dK, dV of the GQA
attention of a sequence over itself from the forward's saved row
log-sum-exp, recomputing p = exp(s - lse) under the same position mask
(causal / window / chunk). On this card the function is bound by operations
(five products of 2 * head_dim operations per visible pair and query head);
the kernels keep the [queries, keys] tiles on chip, take GQA natively (dK/dV
per kv head, summed over its G query heads inside the kernel, where the
reference repeats K/V to every head) and skip tiles from the positions
themselves (csrc/flash_attention_bwd.cu). bf16 inputs run their tensor-core
bodies (mma.sync, cp.async), f32 inputs their CUDA-core bodies; the launch
reports which one ran (`last_body`).

The wrapper launches the kernels for CUDA tensors and raises if it cannot;
it takes the plain version only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (BODIES, _aligned,
                                                 check_head_dim,
                                                 compute_dtype)
from repro_torch.kernels.paged_decode import _Q_DTYPES

SOURCE = "flash_attention_bwd.cu"

# launches of the CUDA kernels made by flash_attention_bwd (one per call:
# the dQ and dK/dV kernels go out together), and by nothing else
launches = 0
# the body the last launch ran (flash_attention.BODIES), as the C entry
# point reports it
last_body = None
# query heads per kv head the bf16 body takes: its dK/dV kernel packs a
# query tile's G heads into 32 rows (the f32 body takes up to 64)
BF16_MAX_G = 32

_fn = None


def _bound():
    global _fn
    if _fn is None:
        fn = build.library(SOURCE).flash_attention_bwd_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 9 + [ctypes.c_float,
                                            ctypes.POINTER(i), p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_bwd_plain(q, k, v, out, lse, do, qpos, kpos, *,
                              window: Optional[int] = None,
                              chunk: Optional[int] = None):
    """The plain PyTorch version: dense recomputation with the reference's
    formulas, in f32 (f64 for f64 inputs). q, out, do [b,sq,H,hd]; k/v
    [b,sk,K,hd]; lse [b,sq,H]; qpos [b,sq], kpos [b,sk] -> (dq [b,sq,H,hd],
    dk, dv [b,sk,K,hd]) in the inputs' dtypes:
    D = rowsum(dO * O), p = where(mask, exp(s - lse), 0) with s = (q /
    sqrt(hd)) . k, dv = p^T dO, ds = p * (dO v^T - D), dq = ds k / sqrt(hd),
    dk = ds^T q / sqrt(hd)."""
    from repro_torch.configs.base import BlockSpec
    from repro_torch.models.attention import _mask
    ct = compute_dtype(q)
    b, sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = float(1.0 / np.sqrt(hd))
    qs = q.to(ct).reshape(b, sq, K, G, hd) * scale
    dof = do.to(ct).reshape(b, sq, K, G, hd)
    kf, vf = k.to(ct), v.to(ct)
    dvec = (dof * out.to(ct).reshape(b, sq, K, G, hd)).sum(-1)  # [b,sq,K,G]
    s = torch.einsum("bqkgh,bskh->bkgqs", qs, kf)
    mask = _mask(qpos, kpos, BlockSpec(window=window, chunk=chunk))
    mask = mask[:, None, None]                          # [b, 1, 1, sq, sk]
    rows = lse.to(ct).reshape(b, sq, K, G).permute(0, 2, 3, 1)[..., None]
    p = torch.where(mask, torch.exp(s - rows), torch.zeros_like(s))
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    ds = p * (dp - dvec.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qs)
    return (dq.reshape(b, sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q, k, v, out, lse, do, qpos, kpos, *,
                        window: Optional[int] = None,
                        chunk: Optional[int] = None):
    """q, out, do [b,sq,H,hd] (f32 or bf16, one dtype); k/v [b,sk,K,hd] in
    q's dtype, H a multiple of K; lse [b,sq,H] f32 (the forward's,
    -1e30 for a row that sees nothing); qpos [b,sq], kpos [b,sk] int32
    (-1 = padding). Returns (dq [b,sq,H,hd], dk, dv [b,sk,K,hd]) in q's
    dtype; a pair that is not visible contributes nothing, so a row that
    sees nothing gets zero gradients. bf16 needs hd a multiple of 8 and at
    most BF16_MAX_G (32) query heads per kv head.

    CUDA tensors go to the CUDA kernels (built at first use; a failed build
    or launch raises); CPU tensors to the plain version. D = rowsum(dO * O)
    is computed here, before the launch."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, out, lse, do, qpos, kpos,
                                         window=window, chunk=chunk)
    global launches, last_body
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (f32, bf16)")
    for name, t in (("k", k), ("v", v), ("out", out), ("do", do)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype}, q {q.dtype}: one dtype")
    b, sq, H, hd = q.shape
    check_head_dim(q.dtype, hd)
    sk, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, sk, K, hd) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} must be "
                         f"[{b}, sk, K, {hd}]")
    if K < 1 or H % K:
        raise ValueError(f"{H} query heads do not split over {K} kv heads")
    if q.dtype == torch.bfloat16 and H // K > BF16_MAX_G:
        raise ValueError(f"bf16 backward with {H // K} query heads per kv "
                         f"head not supported (at most {BF16_MAX_G})")
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must be q's shape {tuple(q.shape)}")
    if tuple(lse.shape) != (b, sq, H) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 [{b}, {sq}, {H}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if tuple(qpos.shape) != (b, sq) or tuple(kpos.shape) != (b, sk):
        raise ValueError("qpos must be [b, sq] and kpos [b, sk]")
    if qpos.dtype != torch.int32 or kpos.dtype != torch.int32:
        raise TypeError("qpos/kpos must be int32")
    if sq == 0 or sk == 0 or b == 0:
        raise ValueError(f"empty attention: b={b}, sq={sq}, sk={sk}")
    for name, t in (("k", k), ("v", v), ("out", out), ("lse", lse),
                    ("do", do), ("qpos", qpos), ("kpos", kpos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    dvec = (do.float() * out.float()).sum(-1).contiguous()
    lse, qpos, kpos = lse.contiguous(), qpos.contiguous(), kpos.contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # autograd runs a backward on its own thread: the stream is the one
    # current on q's device there (autograd makes it the forward's stream)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    body = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        rc = _bound()(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(do),
            build.ptr(lse), build.ptr(dvec), build.ptr(qpos), build.ptr(kpos),
            build.ptr(dq), build.ptr(dk), build.ptr(dv), b, sq, sk, K,
            H // K, hd, _Q_DTYPES[q.dtype], int(window or 0),
            int(chunk or 0), ctypes.c_float(1.0 / np.sqrt(hd)),
            ctypes.byref(body), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_bwd_launch failed (code {rc}; -1 = shape not "
            f"supported) for q {tuple(q.shape)}, k {tuple(k.shape)}")
    launches += 1
    last_body = BODIES[body.value]
    return dq, dk, dv
