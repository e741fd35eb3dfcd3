"""Trees of tensors: nested dicts and lists, as the parameter, optimizer
state and cache trees of this package are (the reference package's pytrees).
Dicts are walked in their own key order, lists and tuples in order; a
tuple subclass (a partition spec, `parallel.axes.Spec`) is a leaf."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _seq(x) -> bool:
    return isinstance(x, list) or type(x) is tuple


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest` (same
    structure), in a new tree of `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _seq(tree):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)]: the path holds each dict key and list index on the
    way to the leaf, as the reference's tree_flatten_with_path keys do."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in tree_paths(v, prefix + (k,))]
    if _seq(tree):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, prefix + (i,))]
    return [(prefix, tree)]
