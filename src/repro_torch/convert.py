"""Hand-over of parameters, paged pools and ring caches between the
reference package and this one.

The reference side passes numpy arrays (bf16 leaves upcast to float32, which
is exact); this module turns such a tree into the tensors this package's
functions take, and a tree of this package's tensors back into numpy
(`to_numpy`). It imports numpy and torch only: the tests are the only
callers that hold a tree made by the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import require_device


def _to_tensor(a, dtype, device):
    t = torch.from_numpy(np.array(a))     # a copy: torch wants it writable
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(numpy_tree, param_dtype="bfloat16", device="cuda"):
    """A parameter tree of numpy arrays (same nesting and leaf layout as the
    reference package's `init_params`) -> this package's params: every
    floating leaf cast to `param_dtype`, on `device` (default "cuda";
    raises without a CUDA device; the tests pass "cpu")."""
    dt = torch_dtype(param_dtype)
    device = require_device(device)
    return _map(numpy_tree, lambda a: _to_tensor(a, dt, device))


_POOL_FLOAT = ("kb", "vb", "k", "v")


def pool_from_jax(numpy_tree, device="cuda", fp_dtype=torch.bfloat16):
    """A paged pool or a ring cache tree of numpy arrays (the reference
    package's `init_paged_pool` / `init_cache` layouts) -> this package's
    tensors on `device` (default "cuda"; raises without a CUDA device).
    Integer leaves (codes, positions) keep their dtype; fp payload leaves
    "kb"/"vb" (pool) and "k"/"v" (ring) are cast to `fp_dtype` (bf16
    payloads arrive upcast to float32); scale leaves stay float32."""
    device = require_device(device)
    def conv(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if isinstance(v, (dict, list, tuple)):
                    out[k] = conv(v)
                else:
                    a = np.asarray(v)
                    fp = k in _POOL_FLOAT and a.dtype.kind == "f"
                    out[k] = _to_tensor(a, fp_dtype if fp else None, device)
            return out
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return _to_tensor(tree, None, device)
    return conv(numpy_tree)


def to_numpy(tree):
    """A tree of this package's tensors (params, a paged pool, ring caches)
    -> the same nesting of numpy arrays for the reference package: bf16
    leaves upcast to float32 (exact), every other dtype kept."""
    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _map(tree, conv)
