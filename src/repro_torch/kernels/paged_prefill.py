"""Paged flash-prefill: wrapper of the CUDA kernels, and the plain PyTorch
version.

Replaces the TPU kernel kernels/prefill_attention.py ·
paged_prefill_attention_fwd of the reference package. On this card the
function is bound by operations at serving shapes (a chunk of 256 queries
against thousands of positions) and by bytes only for short contexts. The
design keeps what the capacity model prices for the tiled kernel
(predictor.prefill_transient_bytes(kernel="tiled")): no [chunk, context]
score matrix and no fp copy of a quantised pool in device memory. A write
kernel stores the chunk (quantise-on-write), then a tiled online-softmax
kernel attends over the post-write pool (csrc/paged_prefill.cu,
csrc/paged_attend.cuh).

The pool leaves are updated IN PLACE. The wrapper launches the kernels for
CUDA tensors and raises if it cannot; it takes the plain version only for
tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import _Q_DTYPES, check_pool_args

SOURCE = "paged_prefill.cu"

# launches of the CUDA kernel pair (write + attend count as one) made by
# paged_prefill_attention, and by nothing else
launches = 0

_fn = None


def _bound():
    global _fn
    if _fn is None:
        fn = build.library(SOURCE).paged_prefill_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 11 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_prefill_attention_plain(q, k_new, v_new, k_pool, v_pool, pool_pos,
                                  block_tables, positions, *,
                                  window: Optional[int] = None,
                                  chunk: Optional[int] = None,
                                  k_scales=None, v_scales=None,
                                  dequant_dtype=torch.bfloat16):
    """The plain PyTorch version: scatter the chunk through the tables,
    gather every table entry back into a virtual ring (rows of a quantised
    pool dequantised to `dequant_dtype`: bf16 as the reference package's
    gather path, or float32 for the values the kernel computes with) and
    run dense masked softmax over it. Padding rows and
    rows whose logical block is unmapped write NOTHING (they are filtered
    out before the scatter, so no scratch block is assumed), and padding
    rows give 0, as the kernel does. Pool leaves are updated in
    place; returns o [b,C,K,G,hd]."""
    from repro_torch.configs.base import BlockSpec
    from repro_torch.models import attention as A
    cache = {"kb": k_pool, "vb": v_pool, "pos": pool_pos}
    if k_scales is not None:
        cache["ks"], cache["vs"] = k_scales, v_scales
    bs = pool_pos.shape[1]
    m_blocks = block_tables.shape[1]
    lb = torch.div(positions.long(), bs, rounding_mode="floor")
    phys = torch.gather(block_tables.long(), 1,
                        torch.clamp(lb, 0, m_blocks - 1))
    keep = (positions >= 0) & (lb < m_blocks) & (phys >= 0)   # [b, C]
    phys, off = phys[keep], (positions.long() % bs)[keep]
    kind = A.paged_quant_kind(cache)
    kq, ks = A.quantize_kv(k_new[keep], kind)
    vq, vs = A.quantize_kv(v_new[keep], kind)
    k_pool.index_put_((phys, off), kq.to(k_pool.dtype))
    v_pool.index_put_((phys, off), vq.to(v_pool.dtype))
    pool_pos.index_put_((phys, off), positions[keep])
    if kind != "none":
        k_scales.index_put_((phys, off), ks)
        v_scales.index_put_((phys, off), vs)
    blk = BlockSpec(window=window, chunk=chunk)
    virt = A._paged_gather(cache, block_tables, dequant_dtype)
    mask = A._mask(positions, virt["pos"], blk)
    o = A._sdpa(q, virt["k"], virt["v"], mask)
    seen = mask.any(dim=-1)                                  # [b, C]
    return torch.where(seen[:, :, None, None, None], o, torch.zeros_like(o))


def paged_prefill_attention(q, k_new, v_new, k_pool, v_pool, pool_pos,
                            block_tables, positions, *,
                            window: Optional[int] = None,
                            chunk: Optional[int] = None,
                            k_scales=None, v_scales=None):
    """Chunked prefill through a paged KV pool: write the chunk's K/V into
    the pool via the block tables (quantise-on-write for int8/int4 pools)
    and flash-attend the chunk's queries over history + chunk.

    q [b,C,K,G,hd]; k_new/v_new [b,C,K,hd]; pools [n_blocks,block,K,hd]
    (f32, bf16, int8, or uint8-packed int4 with f32 `k_scales`/`v_scales`);
    pool_pos [n_blocks,block] int32; block_tables [b,max_blocks] int32;
    positions [b,C] int32 (-1 = padding). Returns o [b,C,K,G,hd]; the pool
    leaves (and scales) are updated in place.

    CUDA tensors go to the CUDA kernels (built at first use; a failed build
    or launch raises); CPU tensors to the plain version."""
    if not q.is_cuda:
        return paged_prefill_attention_plain(
            q, k_new, v_new, k_pool, v_pool, pool_pos, block_tables,
            positions, window=window, chunk=chunk, k_scales=k_scales,
            v_scales=v_scales)
    global launches
    b, C, K, G, hd = q.shape
    codec = check_pool_args(q, k_pool, v_pool, pool_pos, block_tables,
                            positions, k_scales, v_scales, K, hd)
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError("k_new/v_new must have q's dtype")
    if tuple(k_new.shape) != (b, C, K, hd) or k_new.shape != v_new.shape:
        raise ValueError(f"k_new/v_new must be {(b, C, K, hd)}")
    if tuple(positions.shape) != (b, C) or block_tables.shape[0] != b:
        raise ValueError("positions must be [b, C], block_tables [b, mB]")
    m_blocks = block_tables.shape[1]
    bs = pool_pos.shape[1]
    q = q.contiguous()
    k_new = k_new.contiguous()
    v_new = v_new.contiguous()
    tables = block_tables.contiguous()
    positions = positions.contiguous()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _bound()(
            build.ptr(q), build.ptr(k_new), build.ptr(v_new), build.ptr(o),
            build.ptr(k_pool), build.ptr(v_pool), build.ptr(k_scales),
            build.ptr(v_scales), build.ptr(pool_pos), build.ptr(tables),
            build.ptr(positions), b, C, K, G, hd, bs, m_blocks,
            _Q_DTYPES[q.dtype], codec, int(window or 0), int(chunk or 0),
            ctypes.c_float(1.0 / np.sqrt(hd)), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"paged_prefill_launch failed (code {rc}; -1 = shape not "
            f"supported) for q {tuple(q.shape)}, block {bs}, codec {codec}")
    launches += 1
    return o
