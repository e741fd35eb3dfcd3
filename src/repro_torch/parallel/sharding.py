"""Sharding strategies: the `Strategy` record the WSMC planner and
profiler pick, its logical-axis rules and `default_strategy`; and the
execution half, after the reference package's parallel/sharding.py: a
partition spec (`axes.Spec`) for every parameter, cache and input leaf by
path-based logical-axis rules, each rank's local shard of a tree, and the
gathers that rebuild full leaves where they are used.

Default strategy: batch over ("pod","data"), FSDP (ZeRO-3 style weight
sharding) over "data" on the d_model dim of every weight, TP over "model"
on heads/FFN/vocab/experts-inner dims. Optimizer state inherits parameter
specs (ZeRO).

Strategy knobs the WSMC planner can flip:
  ep       — shard the expert dim over "model" (EP) instead of intra-expert TP
  kv_shard — "heads" | "seq": decode KV-cache layout. kv_heads < 16 pads on
             the model axis, so small-kv archs default to sequence sharding.

A mesh is anything with `axis_names` and a `shape` mapping
(`launch.mesh.Mesh`, or a plain `{axis: size}` for `default_strategy`; None
= no mesh). The port's stacked unit leaves may be one tensor [repeats, ...]
or the list of its per-repeat tensors (the trainer's autograd leaves): both
take the reference's ("layers",) + ... spec.

Nothing is placed with DTensor: every rank holds plain local tensors (the
hand kernels take them), `local_shard` cuts them, and `Gatherer` all-gathers
a unit's weights just before the unit runs, keeping what autograd saves of
them as the shard. This module imports torch only inside the functions
that run collectives: the planner imports it.

The spec tree's "model" entries execute for serving and training
(tensor parallelism: the rank's heads, FFN columns and vocab rows stay
local, `parallel.comm.model_axis` combines them; FSDP's `Gatherer`
gathers over the data axes only). A GLU MLP's `wi` holds [gate | val] on
its last dim (2 x d_ff), and `models.model.mlp_apply` splits it in two: a
rank's shard of that dim is its slice of each half, [gate_r | val_r], not
a contiguous cut (which would give rank 0 all of the gate).
`param_specs` gives such a leaf an `axes.GluSpec` (equal to the plain
spec), the one mark of that layout: `local_slice` (so `local_shard`,
`init_local_params` and `convert.params_from_jax`) cuts a leaf under one
so, and `gather_leaf` undoes the cut when it rebuilds the whole leaf (a
checkpoint's save); the element count is the spec tree's shard either
way.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import axes as pax


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str = "fsdp_tp"
    ep: bool = False
    kv_shard: str = "heads"          # heads | seq
    fsdp: bool = True                # False => pure DP + TP (weights replicated
                                     # over "data"; small models)
    pipeline: bool = False           # layer stack split over the "pipe" axis
                                     # (1F1B runtime schedule owns the stages)

    def rules(self) -> Dict[str, Any]:
        rules = dict(pax.DEFAULT_RULES)
        if self.ep:
            rules["experts"] = "model"
            rules["mlp"] = None
            rules["mlp_act"] = None
        if self.kv_shard == "seq":
            rules["kv_seq"] = "model"
            rules["kv_heads"] = None
        if not self.fsdp:
            rules["embed_w"] = None
        if self.pipeline:
            rules["layers"] = "pipe"
        return rules


def default_strategy(cfg: ModelConfig,
                     mesh_shape: Optional[Mapping[str, int]] = None
                     ) -> Strategy:
    """Pick kv layout, EP and pipelining from the mesh axes (a Mesh or
    {axis: size}; None = no mesh, planned as a model axis of 16)."""
    mesh_shape = getattr(mesh_shape, "shape", mesh_shape)
    model_size = 16
    pipeline = False
    if mesh_shape is not None and "model" in mesh_shape:
        model_size = int(mesh_shape["model"])
    if mesh_shape is not None and "pipe" in mesh_shape:
        pipeline = int(mesh_shape["pipe"]) > 1
    kv = "heads" if cfg.n_kv_heads % model_size == 0 else "seq"
    # EP when the expert count tiles the axis (-56% compute vs intra-expert
    # TP on llama4); otherwise dense TP inside experts.
    ep = cfg.is_moe and cfg.n_experts % model_size == 0
    return Strategy(kv_shard=kv, ep=ep, pipeline=pipeline)


# ---------------------------------------------------------------------------
# Path-rule resolution
# ---------------------------------------------------------------------------

def _path_names(path) -> Tuple[Tuple[str, ...], bool]:
    """(names along path, stacked?) — stacked = under params['units']."""
    names = tuple(f"[{p}]" if isinstance(p, int) else str(p) for p in path)
    return names, bool(names) and names[0] == "units"


# (context, name, effective_ndim) -> logical axes (no leading "layers")
def _param_axes(names, ndim) -> Tuple[Optional[str], ...]:
    name = names[-1]
    in_mixer = "mixer" in names
    in_mlp = "mlp" in names
    if name == "table":
        return ("vocab", "embed_w")
    if name in ("norm", "norm2", "final_norm", "b", "b_i", "b_f"):
        return (None,) * ndim
    if name in ("gate_r", "gate_i", "a_param"):
        return ("lru",)
    if name == "gnorm":
        return ("inner",)
    if name == "router":
        return ("embed_w", "experts")
    if in_mlp and name == "wi":
        return ("experts", "embed_w", "mlp") if ndim == 3 else ("embed_w", "mlp")
    if in_mlp and name == "wo":
        return ("experts", "mlp", "embed_w") if ndim == 3 else ("mlp", "embed_w")
    if in_mixer:
        if name == "wq" and ndim == 3:        # mLSTM block-diagonal q/k
            return ("inner", None, None)
        if name == "wk" and ndim == 3:
            return ("inner", None, None)
        if name == "wq":
            return ("embed_w", "q_w")
        if name in ("wk", "wv"):
            return ("embed_w", "kv_w")
        if name == "wo":
            return ("q_w", "embed_w")
        if name == "w_up":
            return ("embed_w", "inner")
        if name == "w_down":
            return ("inner", "embed_w")
        if name == "conv":
            return (None, "inner") if ndim == 2 else (None,) * ndim
        if name in ("w_i", "w_f"):
            return ("inner", None)
        if name == "w":                       # sLSTM input projection
            return ("embed_w", None)
        if name == "r":                       # sLSTM per-head recurrence
            return (None, None, None)
        if name == "w_ff":
            return ("embed_w", "mlp")
        if name == "w_ff_out":
            return ("mlp", "embed_w")
        if name in ("w_x", "w_y"):
            return ("embed_w", "lru")
        if name == "w_out":
            return ("lru", "embed_w")
    # rglru conv lives under mixer too ("conv" handled above); fallback:
    return (None,) * ndim


def _cache_axes(name, ndim) -> Tuple[Optional[str], ...]:
    if name in ("k", "v"):
        return ("batch", "kv_seq", "kv_heads", None)
    if name == "pos":
        return ("batch", "kv_seq")
    # recurrent states: batch-sharded only (small vs KV caches)
    return ("batch",) + (None,) * (ndim - 1)


def _is_leaf(x) -> bool:
    """A tensor-like leaf, or a per-repeat list of them (a stacked leaf)."""
    if isinstance(x, dict):
        return False
    if isinstance(x, (list, tuple)):
        return bool(x) and not isinstance(x[0], (dict, list, tuple))
    return True


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, (list, tuple)):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def _map_leaves(fn, tree, path=()):
    """fn(path, leaf) over a params / cache tree, a per-repeat list taken
    as one leaf; a new tree of the same dicts and lists."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    return [_map_leaves(fn, v, path + (i,)) for i, v in enumerate(tree)]


# ---------------------------------------------------------------------------
# Spec-tree builders
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig, params, strategy: Strategy, mesh):
    """A Spec for every leaf of `params` (tensors of the full shapes, e.g.
    on the meta device)."""
    rules = strategy.rules()

    def leaf_spec(path, leaf):
        names, stacked = _path_names(path)
        shape = _shape(leaf)
        logical = _param_axes(names, len(shape) - (1 if stacked else 0))
        if stacked:
            logical = ("layers",) + logical
        spec = pax.logical_to_spec(logical, rules=rules, mesh=mesh,
                                   shape=shape)
        return pax.GluSpec(spec) if _is_glu_leaf(cfg, path) else spec

    return _map_leaves(leaf_spec, params)


def cache_specs(cfg: ModelConfig, cache, strategy: Strategy, mesh):
    rules = strategy.rules()

    def leaf_spec(path, leaf):
        names, stacked = _path_names(path)
        shape = _shape(leaf)
        logical = _cache_axes(names[-1], len(shape) - (1 if stacked else 0))
        if stacked:
            logical = ("layers",) + logical
        return pax.logical_to_spec(logical, rules=rules, mesh=mesh,
                                   shape=shape)

    return _map_leaves(leaf_spec, cache)


def input_specs_sharding(inputs, strategy: Strategy, mesh):
    rules = strategy.rules()

    def spec_for(name, leaf):
        if name in ("tokens", "targets"):
            logical = ("batch", None)
        elif name == "positions":
            logical = ("batch",)
        elif name == "prefix_embeds":
            logical = ("batch", None, None)
        else:
            logical = (None,) * len(leaf.shape)
        return pax.logical_to_spec(logical, rules=rules, mesh=mesh,
                                   shape=tuple(leaf.shape))

    return {k: spec_for(k, v) for k, v in inputs.items()}


def scalar_spec(mesh=None) -> pax.Spec:
    return pax.Spec()


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------

def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one Spec entry names (outermost first)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _slices(shape, spec, mesh):
    """This rank's slice of each dimension of a leaf of `shape`."""
    out = []
    for dim, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        idx, n = 0, 1
        for a in entry_axes(e):
            idx = idx * mesh.shape[a] + mesh.coords[a]
            n *= mesh.shape[a]
        if dim % n:
            raise ValueError(f"dimension {dim} does not split over {e}")
        out.append(slice(idx * (dim // n), (idx + 1) * (dim // n)))
    return tuple(out)


def local_slice(x, spec, mesh):
    """This rank's block of `x` (a torch tensor or numpy array; a view).
    Under a `GluSpec` the last dim is [gate | val] and each half is cut
    alike: the block is [gate_r | val_r] (a copy where the last dim
    splits)."""
    glu = isinstance(spec, pax.GluSpec)
    sl = _slices(x.shape, spec, mesh)
    last = sl[-1] if sl else None
    if not glu or last is None or last.stop - last.start == x.shape[-1]:
        return x[sl]
    half, n = x.shape[-1] // 2, last.stop - last.start
    if x.shape[-1] % 2 or n % 2:
        raise ValueError(f"GLU dim {x.shape[-1]} does not split in halves "
                         f"over {spec[-1]}")
    lo = last.start // 2
    parts = [x[sl[:-1] + (slice(h + lo, h + lo + n // 2),)]
             for h in (0, half)]
    if isinstance(x, np.ndarray):
        return np.concatenate(parts, axis=-1)
    import torch
    return torch.cat(parts, dim=-1)


def _is_glu_leaf(cfg: ModelConfig, path) -> bool:
    """A GLU MLP's `wi` ([gate | val] on its last dim)."""
    names, _ = _path_names(path)
    return (bool(names) and names[-1] == "wi" and "mlp" in names
            and cfg.activation in ("swiglu", "geglu"))


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in _slices(shape, spec, mesh))


def local_shard(tree, spec_tree, mesh):
    """This rank's slice of every leaf of `tree` under `spec_tree`, each
    in storage of its own (the full leaves can be freed); a `GluSpec` leaf
    cut half by half."""
    from repro_torch.tree import tree_map

    def one(t, spec):
        import torch
        return local_slice(t, spec, mesh).clone(
            memory_format=torch.contiguous_format)

    return tree_map(one, tree, spec_tree)


def _gather_axes(spec, mesh, axes):
    """(dim, axis) pairs to all-gather, innermost axis of a dimension
    first; only axes of `axes` (all when None) of size > 1."""
    out = []
    for d, e in enumerate(spec):
        for a in reversed(entry_axes(e)):
            if mesh.shape[a] > 1 and (axes is None or a in axes):
                out.append((d, a))
    return out


def _unglu(x, pieces: int):
    """[gate_0 | val_0 | gate_1 | val_1 | ...] (`pieces` blocks along the
    last dim, as the ranks' GLU cuts concatenate) -> [gate | val]."""
    w = x.shape[-1] // (2 * pieces)
    return x.unflatten(-1, (pieces, 2, w)).transpose(-3, -2).flatten(-3)


def _gather(local, spec, mesh, axes, gather):
    """`gather(tensor, group, dim)` over the (dim, axis) pairs of
    _gather_axes; a `GluSpec` leaf's gathered last dim put back in
    [gate | val] order."""
    pieces = 1
    for d, a in _gather_axes(spec, mesh, axes):
        local = gather(local, mesh.groups[a], d)
        if d == len(spec) - 1:
            pieces *= mesh.shape[a]
    if pieces > 1 and isinstance(spec, pax.GluSpec):
        local = _unglu(local, pieces)
    return local


def gather_leaf(local, spec, mesh, axes: Optional[Sequence[str]] = None):
    """The leaf rebuilt from this rank's shard: all-gathered over the mesh
    axes its spec names (`axes` limits which), a `GluSpec` leaf in
    [gate | val] order. Autograd reduce-scatters (sums) the gradient back
    to the shard."""
    from repro_torch.parallel import comm
    return _gather(local, spec, mesh, axes, comm.AllGather.apply)


def gather_tree(local_tree, spec_tree, mesh,
                axes: Optional[Sequence[str]] = None):
    """gather_leaf over every leaf of a tree (forward: all-gather; backward:
    reduce-scatter of the gradient); a `GluSpec` leaf in [gate | val]
    order."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t, s: gather_leaf(t, s, mesh, axes), local_tree,
                    spec_tree)


def _gather_plain(local, spec, mesh, axes):
    from repro_torch.parallel import comm
    return _gather(local, spec, mesh, axes, comm.all_gather)


def unit_specs(spec_tree):
    """The per-repeat specs of params["units"]: each unit leaf's spec
    without its leading ("layers") entry (of the same kind)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda s: type(s)(s[1:]), spec_tree["units"])


class Gatherer:
    """Gathers a sharded parameter tree where it is used (ZeRO-3): the
    non-unit leaves as the forward starts, each unit repeat's leaves as the
    repeat runs (`unit_wrapper`), over the mesh axes in `axes` (the FSDP
    axes: a pipeline stage keeps its own layers, and a model axis its
    tensor-parallel shards, which the model code combines). A weight
    gathered by the function a `saving()` context yields is kept, wherever
    autograd saves
    it (or a view of it) inside that context, as its shard, and gathered
    again when the backward needs it: a rank holds its shards plus one
    unit's gathered weights."""

    def __init__(self, spec_tree, mesh, axes: Sequence[str]):
        self.specs, self.mesh, self.axes = spec_tree, mesh, tuple(axes)
        self.units = unit_specs(spec_tree)

    def gather(self, tree, spec_tree):
        """Full leaves of `tree` (autograd reduce-scatters their
        gradients)."""
        from repro_torch.tree import tree_map
        return tree_map(lambda t, s: gather_leaf(t, s, self.mesh, self.axes),
                        tree, spec_tree)

    @contextlib.contextmanager
    def saving(self):
        """Yields gather(tree, spec_tree) whose weights autograd saves, in
        this context, as their shards. The weights it gathers stay alive
        for the context (their storage identifies them)."""
        import torch
        from repro_torch.tree import tree_map
        live = {}                   # storage pointer -> (shard, spec)

        def gather(tree, spec_tree):
            def one(t, spec):
                full = gather_leaf(t, spec, self.mesh, self.axes)
                if full is not t:
                    live[full.untyped_storage().data_ptr()] = (t.detach(),
                                                               spec)
                return full
            return tree_map(one, tree, spec_tree)

        def pack(t):
            hit = live.get(t.untyped_storage().data_ptr()) if t.numel() \
                else None
            if hit is None:
                return t
            return (hit, t.size(), t.stride(), t.storage_offset())

        def unpack(p):
            if isinstance(p, torch.Tensor):
                return p
            (shard, spec), size, stride, offset = p
            with torch.no_grad():
                full = _gather_plain(shard, spec, self.mesh, self.axes)
            return full.as_strided(size, stride, offset)

        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                yield gather
        finally:
            live.clear()

    def outer(self, params, gather):
        """params with every leaf outside "units" gathered by `gather`."""
        out = gather({k: v for k, v in params.items() if k != "units"},
                     {k: v for k, v in self.specs.items() if k != "units"})
        out["units"] = params["units"]
        return out

    def unit_wrapper(self, remat: Any = None):
        """unit_body -> the body on the unit's local shards, gathered as it
        starts. Without remat the gathered weights autograd saves stay
        shards (saving()); under a remat wrapper the gather runs inside the
        checkpointed body (which saves nothing), so its recompute gathers
        again."""
        def wrap(f):
            if remat is not None:
                return remat(lambda x, up: f(x, self.gather(up, self.units)))

            def body(x, unit_params):
                with self.saving() as gather:
                    return f(x, gather(unit_params, self.units))
            return body
        return wrap


def _per_leaf(draw, fn):
    """A stand-in for layers._normal that calls fn(leaf) on each leaf it
    draws (not on the slices a stacked leaf is drawn in)."""
    depth = [0]

    def normal(g, shape, dtype, dev):
        depth[0] += 1
        try:
            out = draw(g, shape, dtype, dev)
        finally:
            depth[0] -= 1
        return out if depth[0] else fn(out)
    return normal


def _draw_local(draw, gen, shape, dtype, dev, spec, mesh):
    """This rank's block of a leaf that `draw` (layers._normal) would make
    whole: a leaf of three or more axes slice by slice along its leading
    axis, as `draw` makes it, each slice drawn (the same draws in the same
    order) and only this rank's kept, cut at once; a smaller leaf drawn
    whole and cut."""
    import torch
    if len(shape) < 3:
        return local_slice(draw(gen, shape, dtype, dev), spec, mesh).clone()
    mine = _slices(shape, spec, mesh)[0]
    out = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                      device=dev)
    inner = type(spec)(spec[1:])
    for r in range(shape[0]):
        piece = _draw_local(draw, gen, shape[1:], dtype, dev, inner, mesh)
        if mine.start <= r < mine.stop:
            out[r - mine.start] = piece
    return out


def init_local_params(gen, cfg: ModelConfig, device, spec_tree, mesh):
    """models.init_params(gen, cfg, device) as this rank's shards: the
    same draws from `gen` in the same order, each random leaf cut to its
    shard as it is drawn (a stacked or expert leaf slice by slice along
    its leading axes, `_draw_local`), so neither the full tree nor a full
    stacked leaf ever exists on the device: the peak while drawing is this
    rank's shards plus one 2-D draw (the largest: the embedding table, in
    f32 and in the param dtype, before its cut). The leaves made otherwise
    (norms, conv taps, RG-LRU gates) are small and cut after. `spec_tree`
    is `param_specs`'s (its `GluSpec` leaves are cut half by half)."""
    from repro_torch.models import layers
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map, tree_paths
    draw, drawn = layers._normal, []
    layers._normal = _per_leaf(draw, lambda t: drawn.append(t) or t)
    try:
        abstract = init_params(None, cfg, device="meta")
    finally:
        layers._normal = draw
    spec_of = {id(t): s for (_, t), (_, s) in zip(tree_paths(abstract),
                                                  tree_paths(spec_tree))}
    order, cut = iter([spec_of[id(t)] for t in drawn]), set()

    def keep(g, shape, dtype, dev):
        t = _draw_local(draw, g, tuple(shape), dtype, dev, next(order), mesh)
        cut.add(id(t))
        return t

    layers._normal = keep
    try:
        params = init_params(gen, cfg, device=device)
    finally:
        layers._normal = draw
    return tree_map(lambda t, s: t if id(t) in cut
                    else local_slice(t, s, mesh).clone(), params, spec_tree)
