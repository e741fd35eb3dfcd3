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

from repro_torch.models.model import init_params, require_device
from repro_torch.tree import tree_leaves, tree_map


def _to_tensor(a, dtype, device):
    t = torch.from_numpy(np.array(a))     # a copy: torch wants it writable
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(numpy_tree, cfg, device="cuda", mesh=None,
                    spec_tree=None):
    """A parameter tree of numpy arrays (same nesting and leaf layout as the
    reference package's `init_params` for `cfg`) -> this package's params
    on `device` (default "cuda"; raises without a CUDA device; the tests
    pass "cpu"). Each leaf gets the dtype the reference gives it, which
    the numpy tree cannot carry (bf16 leaves arrive upcast to float32): it
    is read off this package's own `init_params` tree for `cfg`, built on
    the meta device as a template (no memory, no values). So projections
    take cfg.param_dtype and leaves the reference keeps in f32 (the mLSTM
    gate projections and biases, the sLSTM recurrence and bias) stay f32.
    A leaf whose shape differs from the template's raises ValueError.

    With a `mesh` (`launch.mesh.Mesh`) the result is this rank's shards:
    each leaf cut on the host by `parallel.sharding.local_slice` under
    `spec_tree` (default: `param_specs` of the config's
    `default_strategy` on the mesh), a GLU `wi` (an `axes.GluSpec` leaf)
    half by half, so that every package sees the same weights."""
    device = require_device(device)
    gen = torch.Generator().manual_seed(0)
    template = init_params(gen, cfg, device="meta")
    if mesh is not None:
        from repro_torch.parallel import sharding as S
        specs = spec_tree if spec_tree is not None else S.param_specs(
            cfg, template, S.default_strategy(cfg, mesh), mesh)
        leaves = iter(tree_leaves(specs))

    def conv(a, t):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"leaf of shape {a.shape}, template "
                             f"{tuple(t.shape)}")
        if mesh is not None:
            a = S.local_slice(a, next(leaves), mesh)
        return _to_tensor(a, t.dtype, device)

    return _zip_map(numpy_tree, template, conv)


def _zip_map(tree, template, fn):
    if isinstance(tree, dict):
        if sorted(tree) != sorted(template):
            raise ValueError(f"keys {sorted(tree)} != {sorted(template)}")
        return {k: _zip_map(tree[k], t, fn) for k, t in template.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(template):
            raise ValueError(f"{len(tree)} entries, template {len(template)}")
        return [_zip_map(v, t, fn) for v, t in zip(tree, template)]
    return fn(tree, template)


def opt_state_from_jax(numpy_tree, params, ocfg):
    """The reference package's optimizer state for `ocfg` as a tree of
    numpy arrays ({"m", "v", "count"} for AdamW, {"f", "count"} for
    Adafactor; bf16 leaves upcast to float32) -> this package's state for
    `params`, on their device. Each leaf takes the dtype this package's
    `optim.optimizers.init_state` gives it (a template built on the meta
    device: AdamW moments in the optimizer's accumulator dtype, Adafactor
    statistics in f32, "count" int32). A leaf whose shape differs from the
    template's raises ValueError."""
    from repro_torch.optim import optimizers as opt
    device = tree_leaves(params)[0].device
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), params)
    template = opt.init_state(ocfg, meta)

    def conv(a, t):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"leaf of shape {a.shape}, template "
                             f"{tuple(t.shape)}")
        return torch.from_numpy(np.array(a)).to(device=device,
                                                dtype=t.dtype)

    return _zip_map(numpy_tree, template, conv)


# payload leaves cast to `fp_dtype` (pool "kb"/"vb", ring "k"/"v"), and
# per-lane leaves the reference keeps in bf16 (conv tails of the mLSTM and
# RG-LRU blocks); every other floating leaf (scales, recurrent states) is f32
_POOL_FLOAT = ("kb", "vb", "k", "v")
_POOL_BF16 = ("conv",)


def pool_from_jax(numpy_tree, device="cuda", fp_dtype=torch.bfloat16):
    """A paged pool (its per-lane rings and states included), a slot pool
    or a ring cache tree of numpy arrays (the reference package's
    `init_paged_pool` / `init_slot_pool` / `init_cache` layouts) -> this
    package's tensors on `device` (default "cuda"; raises without a CUDA
    device). Integer leaves (codes, positions) keep their dtype; fp payload
    leaves "kb"/"vb" (pool) and "k"/"v" (ring) are cast to `fp_dtype` (bf16
    payloads arrive upcast to float32); the per-lane "conv" tails of
    recurrent blocks to bf16; scale leaves and the recurrent states (mLSTM
    C, n, m; sLSTM c, n, h, m; RG-LRU h) stay float32."""
    device = require_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if isinstance(v, (dict, list, tuple)):
                    out[k] = conv(v)
                    continue
                a = np.asarray(v)
                dt = None
                if a.dtype.kind == "f" and k in _POOL_FLOAT:
                    dt = fp_dtype
                elif a.dtype.kind == "f" and k in _POOL_BF16:
                    dt = torch.bfloat16
                out[k] = _to_tensor(a, dt, device)
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
    return tree_map(conv, tree)
