"""Gradient compression for the data-parallel all-reduce: int8 with a
per-tensor scale and stochastic rounding (unbiased).

The random draws come from an explicit `torch.Generator`: they are not the
reference package's `jax.random` bits, so the two agree in distribution,
not bit for bit. The collective form (`compressed_psum`) belongs to the
parallel layer, which is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def quantize_int8(x: torch.Tensor, gen: torch.Generator):
    """Stochastic-rounding int8 quantization: each element rounds up with
    probability equal to its distance from the floor. Returns (q int8,
    scale f32 0-d)."""
    xf = x.to(torch.float32)
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax / 127.0, min=1e-30)
    y = xf / scale
    lo = torch.floor(y)
    u = torch.rand(x.shape, generator=gen, dtype=torch.float32,
                   device=x.device)
    q = lo + (u < (y - lo)).to(torch.float32)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale, dtype=torch.float32):
    return (q.to(torch.float32) * scale).to(dtype)


def compress_roundtrip(tree, gen: torch.Generator):
    """Quantize and dequantize every leaf (the compressed all-reduce's
    payload, simulated inside a train step), leaves drawn in tree order
    from `gen`. Returns a new tree in the leaves' dtypes."""
    def one(leaf):
        q, s = quantize_int8(leaf, gen)
        return dequantize_int8(q, s, leaf.dtype)
    return tree_map(one, tree)
