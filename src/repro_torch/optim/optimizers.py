"""Optimizers with capacity-relevant state layouts, after the reference
package's optim/optimizers.py.

The WSMC planner treats the optimizer as a memory knob:
  adamw_f32  — m, v in f32 (8 bytes/param of state)        fastest, largest
  adamw_bf16 — m, v in bf16 (4 bytes/param)                minor quality cost
  adafactor  — factored second moment (~0 bytes/param)     cheapest

The reference's order of operations and dtypes are kept: f32 arithmetic,
state in `_acc_dtype`, parameters cast back to their own dtype. Where the
reference returns new arrays, `apply_updates` and `clip_by_global_norm`
update the tensors IN PLACE (under torch.no_grad()) and return the same
trees. Leaves with a leading stacking axis (the unit pattern's [repeats,
...]) are updated one slice at a time: the update is elementwise along that
axis, and the f32 temporaries of a whole full-width leaf would be
gigabytes. A stacked MoE expert leaf [repeats, E, ...] is cut to one
expert's matrix a slice, for the same reason.

On a mesh (`spec_tree` and `mesh` given, the leaves this rank's shards)
every reduction over a leaf spans its shards: the global norm sums each
leaf's squares over the mesh axes that shard it (a replicated leaf counts
once), and Adafactor's row and column means and its update RMS reduce over
the axes that shard the reduced dimensions. Adafactor factors a stacked
[repeats, d] leaf across its repeats (the reference's own, fault F7), so on
a pipe mesh its column moment reduces over the pipe stages too. A model
axis is one more such axis: a GLU `wi` split over it holds [gate_r |
val_r] columns, and its column moment the same columns (`state_specs`
keeps its `axes.GluSpec`); means and norms are sums, which the columns'
order does not change. A MoE expert leaf [repeats, E, d, 2f] is the
same: under tensor parallelism inside the experts its last dim is split
over "model" (the row moment's mean reduces over it), under expert
parallelism its expert dim (each expert's moments stay local, and the
update's RMS and the global norm sum the expert shards once). The state
mirrors the parameters' specs (`state_specs`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.parallel.axes import Spec
from repro_torch.parallel.sharding import entry_axes
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw_f32"          # adamw_f32 | adamw_bf16 | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # adafactor
    decay_rate: float = 0.8
    clip_threshold: float = 1.0

    @property
    def state_bytes_per_param(self) -> float:
        """Closed-form state footprint (the predictor's Eq.7 'retrievable'
        term; excludes the params themselves)."""
        return {"adamw_f32": 8.0, "adamw_bf16": 4.0,
                "adafactor": 0.05}[self.kind]


KINDS = ("adamw_f32", "adamw_bf16", "adafactor")


def _acc_dtype(ocfg: OptimizerConfig) -> torch.dtype:
    return torch.bfloat16 if ocfg.kind == "adamw_bf16" else torch.float32


def _slices(t: torch.Tensor):
    """Views of t's 2-d matrices, its leading axes unbound in row-major
    order (a stack over repeats [R, a, b], a stacked MoE expert leaf
    [R, E, a, b]), when it has 3 or more dims; else t itself. A slice of
    a stacked expert leaf is one expert's matrix: a whole [E, d, 2f]
    slice's f32 temporaries would be gigabytes a layer."""
    if t.dim() < 3:
        return [t]
    return [s for u in t.unbind(0) for s in _slices(u)]


# ---------------------------------------------------------------------------

def init_state(ocfg: OptimizerConfig, params) -> Any:
    """Zero state on each parameter's device; "count" is a 0-d int32
    tensor."""
    dev = tree_leaves(params)[0].device
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if ocfg.kind in ("adamw_f32", "adamw_bf16"):
        dt = _acc_dtype(ocfg)

        def zeros(p):
            return torch.zeros(p.shape, dtype=dt, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": count}
    if ocfg.kind == "adafactor":
        def factored(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"f": tree_map(factored, params), "count": count}
    raise ValueError(ocfg.kind)


def state_specs(ocfg: OptimizerConfig, param_spec_tree):
    """Specs for the optimizer state, mirroring the params'."""
    if ocfg.kind in ("adamw_f32", "adamw_bf16"):
        return {"m": param_spec_tree, "v": param_spec_tree, "count": Spec()}

    def one(spec):
        if len(spec) >= 2:
            return {"vr": Spec(spec[:-1]),
                    "vc": type(spec)(tuple(spec[:-2]) + (spec[-1],))}
        return {"v": Spec(spec)}
    return {"f": tree_map(one, param_spec_tree), "count": Spec()}


# ---------------------------------------------------------------------------

@torch.no_grad()
def apply_updates(ocfg: OptimizerConfig, params, grads, state, lr,
                  spec_tree=None, mesh=None):
    """One update IN PLACE: params and state leaves are overwritten, and the
    same trees returned as (params, state). lr: a float or 0-d tensor. On
    a mesh, the leaves are shards under `spec_tree`."""
    if ocfg.kind in ("adamw_f32", "adamw_bf16"):
        return _adamw(ocfg, params, grads, state, float(lr))
    if ocfg.kind == "adafactor":
        return _adafactor(ocfg, params, grads, state, float(lr), spec_tree,
                          mesh)
    raise ValueError(ocfg.kind)


class _Shards:
    """Reductions over one leaf that span its shards: the mesh axes (of
    size > 1) splitting each of its dimensions."""

    def __init__(self, p, spec, mesh):
        self.mesh = mesh
        spec = tuple(spec or ()) + (None,) * p.dim()
        self.axes = [tuple(a for a in entry_axes(e) if mesh is not None
                           and mesh.shape[a] > 1) for e in spec[:p.dim()]]
        self.numel = p.numel()
        for ax in self.axes:
            for a in ax:
                self.numel *= mesh.shape[a]

    def _reduce(self, t, axes):
        from repro_torch.parallel import comm
        for a in axes:
            t = comm.all_reduce(t, self.mesh.groups[a])
        return t

    def mean(self, t, dim, p_dim, keepdim=False):
        """t.mean(dim), t's dimension `dim` being the leaf's `p_dim`."""
        axes = self.axes[p_dim]
        if not axes:
            return t.mean(dim=dim, keepdim=keepdim)
        n = t.shape[dim]
        for a in axes:
            n *= self.mesh.shape[a]
        return self._reduce(t.sum(dim=dim, keepdim=keepdim), axes) / n

    def total(self, t):
        """A sum over the whole leaf from this shard's partial sum."""
        return self._reduce(t, sorted({a for ax in self.axes for a in ax}))


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _count_f32(state, device) -> torch.Tensor:
    """state["count"] + 1 (in place), as a 0-d f32 tensor on `device`."""
    state["count"] += 1
    return _f32(state["count"]).to(device)


def _adamw(ocfg, params, grads, state, lr):
    cf = _count_f32(state, tree_leaves(params)[0].device)
    bc1 = 1.0 - ocfg.b1 ** cf
    bc2 = 1.0 - ocfg.b2 ** cf

    def upd(p, g, m, v):
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m),
                                  _slices(v)):
            gf = _f32(gs)
            mf = ocfg.b1 * _f32(ms) + (1 - ocfg.b1) * gf
            vf = ocfg.b2 * _f32(vs) + (1 - ocfg.b2) * gf * gf
            step = (mf / bc1) / (torch.sqrt(vf / bc2) + ocfg.eps)
            pf = _f32(ps)
            pf = pf - lr * (step + ocfg.weight_decay * pf)
            ps.copy_(pf)
            ms.copy_(mf)
            vs.copy_(vf)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, state


def _factored_slices(p, f):
    """The statistics of p slice by slice, as _slices(p) cuts p: a leaf
    [..., a, b] of 3 or more dims has vr [..., a] / vc [..., b], cut along
    the same leading axes in the same order (views); a 2-d leaf's whole
    (vr, vc) (a stacked [R, d] norm is factored over both axes, as in the
    reference); a 1-d leaf's v."""
    if p.dim() >= 3:
        vr, vc = f["vr"], f["vc"]
        return [{"vr": a, "vc": b}
                for a, b in zip(vr.view(-1, vr.shape[-1]).unbind(0),
                                vc.view(-1, vc.shape[-1]).unbind(0))]
    return [f]


def _adafactor_step(gs, f, sh, rank):
    """The second-moment step of one slice from its (already updated)
    statistics f; sh reduces across the leaf's shards, whose last `rank`
    dimensions the slice is."""
    gf = _f32(gs)
    if gs.dim() >= 2:
        vr, vc = f["vr"], f["vc"]
        denom = (vr[..., None] / torch.clamp(
            sh.mean(vr, -1, rank - 2, keepdim=True)[..., None], min=1e-30)
            ) * vc[..., None, :]
        return gf / torch.sqrt(torch.clamp(denom, min=1e-30))
    return gf / torch.sqrt(torch.clamp(f["v"], min=1e-30))


def _adafactor(ocfg, params, grads, state, lr, spec_tree=None, mesh=None):
    cf = _count_f32(state, tree_leaves(params)[0].device)
    rho = torch.clamp(1.0 - cf ** (-ocfg.decay_rate), max=0.999)

    def upd(p, g, f, spec=None):
        fs = _factored_slices(p, f)
        sh = _Shards(p, spec, mesh)
        r = p.dim()
        # the statistics first, and the sum of step^2 over the whole leaf:
        # the update is clipped by the leaf's RMS, not a slice's
        sq = torch.zeros((), dtype=torch.float32, device=p.device)
        for gs, fl in zip(_slices(g), fs):
            gf = _f32(gs)
            g2 = gf * gf + 1e-30
            if gs.dim() >= 2:
                fl["vr"].copy_(rho * fl["vr"]
                               + (1 - rho) * sh.mean(g2, -1, r - 1))
                fl["vc"].copy_(rho * fl["vc"]
                               + (1 - rho) * sh.mean(g2, -2, r - 2))
            else:
                fl["v"].copy_(rho * fl["v"] + (1 - rho) * g2)
            st = _adafactor_step(gs, fl, sh, r)
            sq += (st * st).sum()
        rms = torch.sqrt(sh.total(sq) / sh.numel + 1e-30)
        div = torch.clamp(rms / ocfg.clip_threshold, min=1.0)
        for ps, gs, fl in zip(_slices(p), _slices(g), fs):
            st = _adafactor_step(gs, fl, sh, r) / div
            pf = _f32(ps)
            pf = pf - lr * (st + ocfg.weight_decay * pf)
            ps.copy_(pf)

    if spec_tree is None:
        tree_map(upd, params, grads, state["f"])
    else:
        tree_map(upd, params, grads, state["f"], spec_tree)
    return params, state


# ---------------------------------------------------------------------------

@torch.no_grad()
def global_norm(tree, spec_tree=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-d tensor). On a
    mesh the leaves are shards under `spec_tree`: the squares of the leaves
    each set of mesh axes shards are summed over those axes."""
    if spec_tree is None:
        total = None
        for x in tree_leaves(tree):
            for xs in _slices(x):
                t = (_f32(xs) ** 2).sum()
                total = t if total is None else total + t
        return torch.sqrt(total)
    parts = {}
    for x, spec in zip(tree_leaves(tree), tree_leaves(spec_tree)):
        sh = _Shards(x, spec, mesh)
        key = tuple(sorted({a for ax in sh.axes for a in ax}))
        t = sum((_f32(xs) ** 2).sum() for xs in _slices(x))
        parts[key] = (sh, parts[key][1] + t) if key in parts else (sh, t)
    return torch.sqrt(sum(sh.total(t) for sh, t in parts.values()))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float, spec_tree=None, mesh=None):
    """Scale every leaf IN PLACE by min(1, max_norm / norm) (in f32, cast
    back to the leaf's dtype); returns (the same tree, the norm before)."""
    norm = global_norm(tree, spec_tree, mesh)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for x in tree_leaves(tree):
        for xs in _slices(x):
            xs.copy_(_f32(xs) * scale)
    return tree, norm
