"""Atomic, async checkpointing in the reference package's on-disk format.

Layout:  <dir>/step_<n>/manifest.json + arrays.npz   (tmp dir + rename commit)

The format is the reference's own, so a checkpoint written by either package
restores in the other: leaves are keyed by their tree path (dict keys and
list indices joined by "//"), bf16 leaves are stored as a uint16 view with
the dtype name "bfloat16" in the manifest (npz has no bfloat16; the view is
taken through torch, no ml_dtypes).

- save(): the copy to host memory happens synchronously (a consistent
  snapshot), the write runs on a background thread with async_=True. From
  a mesh (`mesh`, `spec_tree`: the leaves are this rank's shards) every
  rank joins the all-gather of each leaf, and rank 0 alone writes.
- restore(): tensors in the target tree's layout and dtypes, on `device`.
  With a mesh and a spec tree each rank takes its own slice of every
  leaf, whatever mesh saved it (elastic re-mesh: what `data:2` saved
  restores onto `pipe:2`, or onto one device), bit for bit.
- Fault tolerance: latest_step() skips uncommitted (tmp) dirs; a partial
  save never shadows the previous good step.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.model import require_device
from repro_torch.parallel import sharding as S
from repro_torch.tree import tree_leaves, tree_map, tree_paths

_SEP = "//"

_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.bfloat16: "bfloat16", torch.float16: "float16",
          torch.int32: "int32", torch.int64: "int64", torch.int8: "int8",
          torch.uint8: "uint8", torch.bool: "bool"}


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_storable(t: torch.Tensor):
    """(numpy array for the npz, dtype name for the manifest): a host copy,
    never a view of the tensor, which the train loop updates in place while
    an async write runs."""
    t = t.detach().to("cpu", copy=True)
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_storable(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _refuse_model_axis(mesh):
    """A tensor-parallel layout (a GLU wi cut half by half) is not saved
    or restored: its leaves would need the halves' gather."""
    if mesh is not None and mesh.axis_size("model") > 1:
        raise NotImplementedError("a mesh checkpoint of a model axis above "
                                  "1 is not ported: ROADMAP queue A item 5")


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
         async_: bool = False, mesh=None,
         spec_tree=None) -> Optional[threading.Thread]:
    _refuse_model_axis(mesh)
    flat: Dict[str, np.ndarray] = {}
    leaves = {}
    specs = (tree_leaves(spec_tree) if spec_tree is not None
             else [None] * len(tree_paths(tree)))
    writer = mesh is None or mesh.rank == 0
    for (path, leaf), spec in zip(tree_paths(tree), specs):
        if spec is not None:
            with torch.no_grad():
                leaf = S.gather_leaf(leaf, spec, mesh)
        if not writer:
            continue
        k = _key(path)
        flat[k], name = _to_storable(leaf)
        leaves[k] = {"shape": list(leaf.shape), "dtype": name}
    if not writer:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    meta = {"step": step, "extra": extra or {}, "leaves": leaves}

    def _write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name[len("step_"):]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, target_tree, step: Optional[int] = None,
            device="cuda", mesh=None, spec_tree=None):
    """Restore into the structure of `target_tree` (tensors; their shapes
    and dtypes are the target's) on `device` (default "cuda"; raises
    without a CUDA device). With `mesh` and `spec_tree` the target's
    leaves are this rank's shards, and each gets its slice of the stored
    leaf. Returns (tree, manifest dict)."""
    _refuse_model_axis(mesh)
    dev = require_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = np.load(os.path.join(d, "arrays.npz"))
    out = {}
    specs = (tree_leaves(spec_tree) if spec_tree is not None
             else [None] * len(tree_paths(target_tree)))
    for (path, ref), spec in zip(tree_paths(target_tree), specs):
        key = _key(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if mesh is not None and spec is not None:
            arr = S.local_slice(arr, spec, mesh)    # copied below, alone
        t = _from_storable(arr, manifest["leaves"][key]["dtype"])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: ckpt shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        out[key] = t.to(device=dev, dtype=ref.dtype)
    it = iter(tree_paths(target_tree))
    return tree_map(lambda _: out[_key(next(it)[0])], target_tree), manifest
