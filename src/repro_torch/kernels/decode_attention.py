"""Ring decode attention: wrapper of the CUDA kernel, and its plain PyTorch
version.

Replaces the TPU kernel kernels/decode_attention.py · decode_attention_fwd
of the reference package: one query token per lane against that lane's
ring-buffer KV cache (slot = position % L). On this card the function is
bound by bytes (each lane's ring K and V are read once, with 4*G*hd
operations per row), so the kernel streams the visible rows from device
memory into registers, 16 bytes a lane with several rows in flight, keeps
the softmax state in registers, and splits the ring over thread blocks
where lanes x kv heads would leave most of the card idle
(csrc/ring_decode.cu over the body of csrc/decode_stream.cuh).

Numerics (the reference kernel's): f32 math on f32 / bf16 inputs, scale
1/sqrt(hd), masked scores -1e30, denominator max(l, 1e-30), so a lane that
sees no position (inert: position < 0, or an empty ring) gives exact zeros.

The wrapper launches the kernel for CUDA tensors and raises if it cannot;
it takes the plain version only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import _POOL_CODECS, _Q_DTYPES

SOURCE = "ring_decode.cu"

NEG_INF = -1e30

# launches of the CUDA kernel made by decode_attention_fwd (and by nothing
# else): a run can show that its path went through the kernel
launches = 0

_fn = None


def _bound():
    global _fn
    if _fn is None:
        lib = build.library(SOURCE)
        fn = lib.ring_decode_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 9 + [ctypes.c_float, i, i, p, p]
        fn.restype = ctypes.c_int
        lib.ring_decode_splits.argtypes = [i] * 5
        lib.ring_decode_splits.restype = i
        _fn = (fn, lib.ring_decode_splits)
    return _fn


def decode_attention_plain(q, k_cache, v_cache, cache_pos, positions, *,
                           window: Optional[int] = None,
                           chunk: Optional[int] = None):
    """The plain PyTorch version: dense masked softmax over the whole ring
    in f32, the kernel's arithmetic (masked scores -1e30, denominator
    max(l, 1e-30): a lane that sees nothing gives zeros). The counterpart
    of the reference's ref.decode_attention_ref, which gives such a lane
    the mean of its ring's values instead."""
    from repro_torch.configs.base import BlockSpec
    from repro_torch.models.attention import _mask
    hd = q.shape[-1]
    s = torch.einsum("bkgh,blkh->bkgl", q.float(), k_cache.float()) \
        / float(np.sqrt(hd))
    msk = _mask(positions[:, None], cache_pos,
                BlockSpec(window=window, chunk=chunk))[:, :, None]
    s = torch.where(msk, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(msk, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgl,blkh->bkgh", p, v_cache.float())
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def decode_attention_fwd(q, k_cache, v_cache, cache_pos, positions, *,
                         window: Optional[int] = None,
                         chunk: Optional[int] = None, kv_block: int = 512):
    """Decode against per-lane rings: q [b,K,G,hd] (f32 / bf16); k_cache,
    v_cache [b,L,K,hd] (f32 / bf16, any L); cache_pos [b,L] int32 (-1 =
    empty slot); positions [b] int32 (< 0 = inert lane) -> [b,K,G,hd] in
    q's dtype. `kv_block` caps the ring positions of a tile, the unit the
    ring is split over thread blocks in (64 at most).

    CUDA tensors go to the CUDA kernel (built at first use; a failed build
    or launch raises); CPU tensors to the plain version."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, cache_pos,
                                      positions, window=window, chunk=chunk)
    global launches
    if q.dim() != 4:
        raise ValueError(f"q must be [b, K, G, hd], got {tuple(q.shape)}")
    b, K, G, hd = q.shape
    L = k_cache.shape[1]
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (f32, bf16)")
    if k_cache.dtype not in (torch.float32, torch.bfloat16) or \
            v_cache.dtype != k_cache.dtype:
        raise TypeError(f"cache dtypes {k_cache.dtype}/{v_cache.dtype} not "
                        "supported (f32, bf16)")
    want = (b, L, K, hd)
    if tuple(k_cache.shape) != want or tuple(v_cache.shape) != want:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} != {want}")
    if tuple(cache_pos.shape) != (b, L) or tuple(positions.shape) != (b,):
        raise ValueError("cache_pos must be [b, L], positions [b]")
    for name, t in (("cache_pos", cache_pos), ("positions", positions)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("cache_pos", cache_pos), ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if L < 1 or hd > 256:
        raise ValueError(f"ring of {L} slots, head_dim {hd}: the kernel "
                         "takes L >= 1 and head_dim <= 256")
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    cache_pos, positions = cache_pos.contiguous(), positions.contiguous()
    o = torch.empty_like(q)
    launch, splits = _bound()
    nsplit = int(splits(b, K, hd, L, int(kv_block)))
    part = None
    if nsplit > 1:
        part = torch.empty((b, K, nsplit, G, hd + 2), dtype=torch.float32,
                           device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = launch(
            build.ptr(q), build.ptr(o), build.ptr(k_cache),
            build.ptr(v_cache), build.ptr(cache_pos), build.ptr(positions),
            b, L, K, G, hd, _Q_DTYPES[q.dtype], _POOL_CODECS[k_cache.dtype],
            int(window or 0), int(chunk or 0),
            ctypes.c_float(1.0 / np.sqrt(hd)), int(kv_block), nsplit,
            build.ptr(part), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"ring_decode_launch failed (code {rc}; -1 = shape not "
            f"supported) for q {tuple(q.shape)}, ring of {L}")
    launches += 1
    return o
