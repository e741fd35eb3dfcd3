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
  restores onto `pipe:2`, what `model:2` saved onto one device or
  `data:2`), bit for bit.
- A tensor-parallel layout is saved in the reference's layout: a GLU
  `wi` (and the optimizer state that mirrors its last dim), whose rank
  blocks are [gate_r | val_r] under an `axes.GluSpec`, is written as the
  whole [gate | val] (`sharding.gather_leaf`) and cut so again on restore
  (`sharding.local_slice`). A MoE arch's expert leaves, split over the
  experts (EP) or inside them (TP), are written whole the same way, so a
  checkpoint of one layout restores onto the other, one device or data:2.
- Fault tolerance: latest_step() skips uncommitted (tmp) dirs; a partial
  save never shadows the previous good step.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
import zipfile
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
    """A tensor of its own (a copy: `arr` may map the file)."""
    if name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _npz_members(path: str) -> Dict[str, np.ndarray]:
    """{key: array} of an .npz. A member stored without compression (as
    np.savez writes them) is a read-only np.memmap of its bytes in the
    file, so that a rank restoring its slice of a leaf reads that slice
    alone; any other member is read whole by np.load."""
    lazy = np.load(path)
    out = {k: None for k in lazy.files}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            key = info.filename[:-len(".npy")]
            if info.compress_type != zipfile.ZIP_STORED or key not in out:
                continue
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            if shape and int(np.prod(shape)) and not dtype.hasobject:
                out[key] = np.memmap(f, dtype=dtype, mode="r",
                                     offset=f.tell(), shape=shape,
                                     order="F" if fortran else "C")
    return {k: lazy[k] if v is None else v for k, v in out.items()}


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
         async_: bool = False, mesh=None,
         spec_tree=None) -> Optional[threading.Thread]:
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


# elements of a leaf checksummed at a time (bounds the int64 copy)
_FP_CHUNK = 1 << 26
_WORDS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _checksum(t: torch.Tensor) -> int:
    """sum_i (2i + 1) * word_i mod 2**64 over the leaf's elements read as
    signed integers of their width, on the leaf's device: one flipped bit
    changes it (an odd weight times a power of two below 2**64), and
    integer sums agree in any order, on any device."""
    flat = t.detach().contiguous().reshape(-1).view(_WORDS[t.element_size()])
    total = 0
    for i in range(0, flat.numel(), _FP_CHUNK):
        w = flat[i:i + _FP_CHUNK].to(torch.int64)
        pos = torch.arange(i, i + w.numel(), dtype=torch.int64,
                           device=w.device) * 2 + 1
        total += int((w * pos).sum())
    return total % (1 << 64)


def fingerprint(tree) -> str:
    """A digest of every leaf's shape, dtype and bits (`_checksum`),
    computed where the leaves lie: two trees whose leaves are equal bit
    for bit have the same fingerprint, and a leaf that differs in one bit
    changes it."""
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(f"{tuple(t.shape)} {t.dtype};".encode())
        h.update(_checksum(t).to_bytes(8, "little"))
    return h.hexdigest()[:16]


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
    dev = require_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = _npz_members(os.path.join(d, "arrays.npz"))
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
