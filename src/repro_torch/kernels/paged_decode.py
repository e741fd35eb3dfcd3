"""Paged decode attention: wrapper of the CUDA kernel, and its plain PyTorch
version.

Replaces the TPU kernel kernels/decode_attention.py ·
paged_decode_attention_fwd of the reference package. On this card the
function is bound by bytes (each mapped K and V row of a lane is read once,
with 4*G*hd operations per row), so the kernel reads codes and scales
straight from the pool through the block table and never writes a gathered
or dequantised copy; thread blocks over (context split, kv head, lane) keep
the softmax state on chip, and where lanes x kv heads would leave most of
the card idle the context is split over blocks and merged by a second small
kernel (csrc/paged_decode.cu, csrc/paged_attend.cuh).

The wrapper launches the kernel for CUDA tensors and raises if it cannot;
it takes the plain version only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build

SOURCE = "paged_decode.cu"

# launches of the CUDA kernel made by paged_decode_attention (and by nothing
# else): a run can show that its path went through the kernel
launches = 0

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODECS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.uint8: 3}

_fn = None


def _bound():
    global _fn
    if _fn is None:
        lib = build.library(SOURCE)
        fn = lib.paged_decode_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 10 + [ctypes.c_float, i, p, p]
        fn.restype = ctypes.c_int
        lib.paged_decode_splits.argtypes = [i] * 5
        lib.paged_decode_splits.restype = i
        _fn = (fn, lib.paged_decode_splits)
    return _fn


def check_pool_args(q, k_pool, v_pool, pool_pos, block_tables, positions,
                    k_scales, v_scales, K: int, hd: int):
    """Shared argument checks of the two paged kernels; returns the pool
    codec id. Raises on anything the kernels do not take."""
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (f32, bf16)")
    if k_pool.dtype not in _POOL_CODECS or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not "
                        "supported (f32, bf16, int8, uint8 = packed int4)")
    codec = _POOL_CODECS[k_pool.dtype]
    quant = codec >= 2
    if quant and (k_scales is None or v_scales is None):
        raise ValueError("quantised pool needs k_scales/v_scales")
    n_blocks, bs = pool_pos.shape
    hd_s = hd // 2 if codec == 3 else hd
    if codec == 3 and hd % 2:
        raise ValueError(f"packed int4 needs an even head_dim, got {hd}")
    want = (n_blocks, bs, K, hd_s)
    if tuple(k_pool.shape) != want or tuple(v_pool.shape) != want:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} != {want}")
    if quant:
        for s in (k_scales, v_scales):
            if s.dtype != torch.float32 or tuple(s.shape) != (n_blocks, bs,
                                                              K):
                raise ValueError("scales must be f32 [n_blocks, block, K]")
    for name, t in (("pool_pos", pool_pos), ("block_tables", block_tables),
                    ("positions", positions)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("pool_pos", pool_pos), ("k_scales", k_scales),
                    ("v_scales", v_scales)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the kernel reads "
                             "and the prefill kernel writes it in place)")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    return codec


def merge_block_mass(bm, bl):
    """Per-block (max, sumexp) [b, mB, K, G] -> each logical block's share
    of the softmax, averaged over heads: [b, mB]. Plain tensor code on
    either device, as in the reference package (outside its kernel)."""
    M = bm.amax(dim=1, keepdim=True)
    w = bl * torch.exp(bm - M)
    mass = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-30)
    return mass.mean(dim=(2, 3))


def paged_decode_attention_plain(q, k_pool, v_pool, pool_pos, block_tables,
                                 positions, *, window: Optional[int] = None,
                                 chunk: Optional[int] = None,
                                 k_scales=None, v_scales=None,
                                 return_mass: bool = False,
                                 dequant_dtype=torch.bfloat16):
    """The plain PyTorch version: gather every table entry into a virtual
    ring, dense masked softmax. Rows of a quantised pool are dequantised to
    `dequant_dtype`: bf16 by default, the rounding the reference package's
    gather path has; float32 gives the values the kernel computes with (it
    dequantises in registers and never rounds a row).
    A lane that sees nothing (inert: position -1 or empty table) gives 0,
    as the kernel does. `return_mass` adds the per-block softmax share
    [b, max_blocks] (heads averaged)."""
    from repro_torch.configs.base import BlockSpec
    from repro_torch.models import attention as A
    cache = {"kb": k_pool, "vb": v_pool, "pos": pool_pos}
    if k_scales is not None:
        cache["ks"], cache["vs"] = k_scales, v_scales
    blk = BlockSpec(window=window, chunk=chunk)
    b, m_blocks = block_tables.shape
    bs = pool_pos.shape[1]
    virt = A._paged_gather(cache, block_tables, dequant_dtype)
    o, p = A._decode_attend(q[:, None], virt, blk, positions,
                            return_probs=True)
    seen = A._mask(positions[:, None], virt["pos"], blk).any(dim=-1)  # [b,1]
    o = torch.where(seen[:, :, None, None, None], o, torch.zeros_like(o))
    if not return_mass:
        return o[:, 0]
    p = torch.where(seen[:, None, None, :, None], p, torch.zeros_like(p))
    mass = p.mean(dim=(1, 2))[:, 0].reshape(b, m_blocks, bs).sum(-1)
    return o[:, 0], mass


def paged_decode_attention(q, k_pool, v_pool, pool_pos, block_tables,
                           positions, *, window: Optional[int] = None,
                           chunk: Optional[int] = None,
                           k_scales=None, v_scales=None,
                           return_mass: bool = False):
    """Decode through a paged KV pool: q [b,K,G,hd]; pools
    [n_blocks,block,K,hd] (f32, bf16, int8, or uint8-packed int4 with
    per-row f32 `k_scales`/`v_scales` [n_blocks,block,K]); pool_pos
    [n_blocks,block] int32; block_tables [b,max_blocks] int32 (-1 =
    unassigned); positions [b] int32 -> [b,K,G,hd], or (out, mass
    [b,max_blocks]) with `return_mass`.

    CUDA tensors go to the CUDA kernel (built at first use; a failed build
    or launch raises); CPU tensors to the plain version."""
    if not q.is_cuda:
        return paged_decode_attention_plain(
            q, k_pool, v_pool, pool_pos, block_tables, positions,
            window=window, chunk=chunk, k_scales=k_scales,
            v_scales=v_scales, return_mass=return_mass)
    global launches
    b, K, G, hd = q.shape
    codec = check_pool_args(q, k_pool, v_pool, pool_pos, block_tables,
                            positions, k_scales, v_scales, K, hd)
    m_blocks = block_tables.shape[1]
    bs = pool_pos.shape[1]
    if tuple(positions.shape) != (b,) or block_tables.shape[0] != b:
        raise ValueError("positions must be [b], block_tables [b, mB]")
    q = q.contiguous()
    tables = block_tables.contiguous()
    positions = positions.contiguous()
    o = torch.empty_like(q)
    bm = bl = None
    if return_mass:
        bm = torch.full((b, m_blocks, K, G), -1e30, dtype=torch.float32,
                        device=q.device)
        bl = torch.zeros((b, m_blocks, K, G), dtype=torch.float32,
                         device=q.device)
    launch, splits = _bound()
    # the context is split over thread blocks where lanes x kv heads would
    # leave the card idle; the splits' partial sums live in `part`
    nsplit = int(splits(b, K, hd, bs, m_blocks))
    part = None
    if nsplit > 1:
        part = torch.empty((b, K, nsplit, G, hd + 2), dtype=torch.float32,
                           device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = launch(
            build.ptr(q), build.ptr(o), build.ptr(k_pool), build.ptr(v_pool),
            build.ptr(k_scales), build.ptr(v_scales), build.ptr(pool_pos),
            build.ptr(tables), build.ptr(positions), build.ptr(bm),
            build.ptr(bl), b, K, G, hd, bs, m_blocks, _Q_DTYPES[q.dtype],
            codec, int(window or 0), int(chunk or 0),
            ctypes.c_float(1.0 / np.sqrt(hd)), nsplit, build.ptr(part),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"paged_decode_launch failed (code {rc}; -1 = shape not "
            f"supported) for q {tuple(q.shape)}, block {bs}, codec {codec}")
    launches += 1
    if return_mass:
        return o, merge_block_mass(bm, bl)
    return o
