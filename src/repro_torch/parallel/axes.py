"""Logical-axis system: models name tensor dimensions with *logical* axes; a
strategy maps logical names onto physical mesh axes (MaxText-style), after
the reference package's parallel/axes.py.

A partition spec here is a `Spec`: a tuple with one entry per dimension,
each None (replicated), a mesh axis name, or a tuple of names (the
dimension split over their product, the first name outermost). It equals
the tuple of the reference's PartitionSpec for the same leaf.

In the port every rank computes on local tensors, so the reference's
activation annotations (`shard`, `axis_rules`) have no counterpart;
weights are gathered where they are used (`sharding.Gatherer`). This
module imports no torch: the planner reads it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]

# Default logical->physical rules for the production 2-D/3-D meshes.
# "pod" is present only in the multi-pod mesh; missing axes are dropped.
DEFAULT_RULES: Dict[str, Axis] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,             # sequence kept local by default (SP overrides)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "inner": "model",        # xLSTM inner (v/output) dim
    "lru": "model",          # RG-LRU width
    "mlp_act": "model",
    "kv_seq": None,          # KV-cache sequence dim (SP decode overrides -> "model")
    # weights
    "embed_w": "data",       # FSDP axis for the d_model dim of weights
    "mlp": "model",          # TP axis for FFN hidden
    "q_w": "model",          # TP for flattened q/o projection dim (heads*hd)
    "kv_w": "model",         # TP for flattened k/v projection dim
    "vocab": "model",
    "experts": None,         # experts dim (EP strategy overrides -> "model")
    "layers": None,          # stacked-scan leading dim
    "conv": None,
}


class Spec(tuple):
    """A partition spec: one entry per dimension. A leaf, not a node, of
    the trees in `repro_torch.tree`."""

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec names, in order."""
        out = []
        for e in self:
            out += [] if e is None else [e] if isinstance(e, str) else list(e)
        return tuple(out)


class GluSpec(Spec):
    """The Spec of a GLU MLP's `wi`, whose last dim is [gate | val]: equal
    to the plain Spec (and to the reference's PartitionSpec), and telling
    `sharding.local_slice` / `gather_leaf` that a rank's block of that dim
    is [gate_r | val_r], each half cut alike."""


def np_prod(xs):
    r = 1
    for x in xs:
        r *= x
    return r


def logical_to_spec(logical: Sequence[Optional[str]],
                    rules: Optional[Dict[str, Axis]] = None,
                    mesh=None,
                    shape: Optional[Sequence[int]] = None) -> Spec:
    """Map logical axis names to a Spec under `rules` (DEFAULT_RULES when
    None) and `mesh` (anything with `axis_names` and a `shape` mapping;
    None names no axis).

    With `shape`, mesh axes that do not evenly divide their dimension are
    dropped (an even split is what a local shard needs)."""
    rules = rules if rules is not None else DEFAULT_RULES
    mesh_axes = set(mesh.axis_names) if mesh is not None else set()
    used = set()
    out = []
    for i, name in enumerate(logical):
        ax = rules.get(name) if name is not None else None
        if ax is None:
            out.append(None)
            continue
        cands = (ax,) if isinstance(ax, str) else tuple(ax)
        picked = []
        dim = shape[i] if shape is not None else None
        for a in cands:
            if a not in mesh_axes or a in used:
                continue
            if dim is not None:
                size = mesh.shape[a]
                if dim % (size * int(np_prod([mesh.shape[p] for p in picked])
                                     or 1)):
                    continue
            picked.append(a)
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return Spec(out)
