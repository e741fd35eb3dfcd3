"""Gradient compression for the data-parallel all-reduce: int8 with a
per-tensor scale and stochastic rounding (unbiased).

The random draws come from an explicit `torch.Generator`: they are not the
reference package's `jax.random` bits, so the two agree in distribution,
not bit for bit. `compressed_psum` is the collective form: the mean over a
process group with an int8 payload summed in int32.
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


def compressed_psum(x: torch.Tensor, group, gen: torch.Generator):
    """The int8-payload mean of `x` over the ranks of `group`: (1) an
    all-reduce max agrees on one scale, amax / 127; (2) each rank rounds
    x / scale stochastically to int8 (draws from `gen`); (3) the codes are
    summed as int32 (no overflow below 2^24 ranks); (4) the sum times the
    scale over the rank count, in x's dtype. The codes travel as int32, as
    the reference's psum sums them."""
    from repro_torch.parallel import comm
    xf = x.to(torch.float32)
    amax = comm.all_reduce(torch.max(torch.abs(xf)), group, op="max")
    scale = torch.clamp(amax / 127.0, min=1e-30)
    y = xf / scale
    lo = torch.floor(y)
    u = torch.rand(x.shape, generator=gen, dtype=torch.float32,
                   device=x.device)
    q = torch.clamp(lo + (u < (y - lo)).to(torch.float32), -127, 127).to(
        torch.int8)
    total = comm.all_reduce(q.to(torch.int32), group)
    n = comm.group_size(group)
    return (total.to(torch.float32) * scale / n).to(x.dtype)
