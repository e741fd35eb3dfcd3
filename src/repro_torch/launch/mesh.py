"""Meshes over `torch.distributed`, after the reference package's
launch/mesh.py, and the local rank launcher.

A `Mesh` names its axes in canonical order (pod, pipe, data, model, then
unknown axes), holds their sizes, this rank's coordinate on each axis and
one process group per axis (the ranks that share every other coordinate).
Ranks are laid out row-major over the axes, so the last axis is the
innermost: on `{"pipe": 2, "data": 2}` ranks 0 and 1 are stage 0. An
abstract mesh (`make_production_mesh`) has sizes only: it is what planning
reads (`axis_names`, `shape`), and nothing runs on it.

`spawn_ranks(fn, world, backend, device)` starts `world` local processes,
one rank each, joins them into one process group and runs `fn(device,
*args)` in each; under `torchrun` it runs `fn` in the calling process over
the world `torchrun` made. The backend is always the caller's: `nccl`
needs one CUDA device per rank and is refused with more ranks than
devices; `gloo` runs on the CPU, and with ranks that share one card (the
collectives then cross the host: `parallel.comm`).
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

# Physical placement order for planned meshes: the weakest links go
# outermost (pipelining tolerates them), TP innermost.
CANONICAL_AXES = ("pod", "pipe", "data", "model")

# how long a collective may wait for the other ranks before it fails
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass
class Mesh:
    axis_names: tuple
    shape: Dict[str, int]
    coords: Dict[str, int] = dataclasses.field(default_factory=dict)
    groups: Optional[Dict[str, Any]] = None
    rank: Optional[int] = None

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= int(self.shape[a])
        return n

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def rank_at(self, **coords) -> int:
        """The global rank at this rank's coordinates with `coords`
        replaced (row-major over axis_names)."""
        c = dict(self.coords, **coords)
        r = 0
        for a in self.axis_names:
            r = r * int(self.shape[a]) + int(c[a])
        return r


def _ordered(mesh_shape: Mapping[str, int]):
    return sorted(mesh_shape.items(),
                  key=lambda kv: (CANONICAL_AXES.index(kv[0])
                                  if kv[0] in CANONICAL_AXES
                                  else len(CANONICAL_AXES), kv[0]))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract production mesh (16 x 16, or 2 x 16 x 16 with a pod
    axis): sizes only, no processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axis_names=axes, shape=dict(zip(axes, shape)))


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh over the first prod(shape) ranks of the live process group
    (or of a world of one when no group is initialised), axes in the given
    order. Every rank of the world must call it (process groups are made
    collectively); a rank outside the mesh gets no coordinates."""
    import torch.distributed as dist
    axes, sizes = tuple(axes), tuple(int(n) for n in shape)
    n = 1
    for s in sizes:
        n *= s
    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else 1
    rank = dist.get_rank() if live else 0
    if n > world:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} needs {n} ranks; "
                         f"the world has {world}")
    mesh = Mesh(axis_names=axes, shape=dict(zip(axes, sizes)), rank=rank)
    if rank < n:
        rest = rank
        for a, s in reversed(list(zip(axes, sizes))):
            mesh.coords[a] = rest % s
            rest //= s
    if not live:
        return mesh
    mesh.groups = {}
    for i, a in enumerate(axes):
        others = [range(s) for j, s in enumerate(sizes) if j != i]
        for fixed in itertools.product(*others):
            ranks = []
            for k in range(sizes[i]):
                c = list(fixed)
                c.insert(i, k)
                r = 0
                for ax, s in zip(c, sizes):
                    r = r * s + ax
                ranks.append(r)
            g = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[a] = g
    return mesh


def build_mesh(mesh_shape: Mapping[str, int],
               world: Optional[int] = None) -> Mesh:
    """A *planned* mesh from an {axis: size} dict (the ExecutionPlan
    output): axes ordered canonically (pod, pipe, data, model, unknown axes
    last), over the first prod(sizes) ranks of the world (default: the
    live process group's size, 1 without one)."""
    import torch.distributed as dist
    items = _ordered(mesh_shape)
    n = 1
    for _, s in items:
        n *= int(s)
    if world is None:
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
    if n > world:
        raise ValueError(f"planned mesh {dict(mesh_shape)} needs {n} "
                         f"devices; only {world} available")
    return make_mesh([s for _, s in items], [a for a, _ in items])


# ---------------------------------------------------------------------------
# The local rank launcher
# ---------------------------------------------------------------------------

BACKENDS = ("nccl", "gloo")


def under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def rank_device(kind: str, local_rank: int):
    """cuda:(local_rank % device count) for kind "cuda" (raising without a
    CUDA device), else the CPU."""
    import torch
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank was asked for but "
                               "torch.cuda.is_available() is False")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def check_backend(backend: str, world: int, kind: str):
    """Refuse a backend that cannot carry `world` ranks on `kind` devices,
    before any process starts."""
    import torch
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("nccl needs CUDA ranks; use gloo on the CPU")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > n:
            raise ValueError(f"nccl needs one device per rank: {world} ranks"
                             f", {n} CUDA devices visible; pass gloo to "
                             "share a card")


def _matmul_flags():
    import torch
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def _set_matmul_flags(flags):
    import torch
    matmul, cudnn, prec = flags
    torch.set_float32_matmul_precision(prec)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _rank_main(rank, world, backend, kind, init_method, flags, out_dir, fn,
               args):
    """One spawned rank: the parent's matmul flags (a fresh interpreter
    does not inherit them), the process group, fn, its pickled result."""
    import torch.distributed as dist
    try:
        import torch
        _set_matmul_flags(flags)
        device = rank_device(kind, rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:                       # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=COLLECTIVE_TIMEOUT)
        result = fn(device, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        # no rank closes its connections while another may still be making
        # its own: gloo's connectFullMesh of a group (dist.new_group) can
        # return on one member before its peers have read the handshake,
        # and a member that then exits fails them with "Connection closed
        # by peer" (a rank that ran no collective on a new group)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:            # reported, then the rank exits non-zero
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def cli_rank(device, main: Callable, argv):
    """One spawned rank of a CLI: main(argv), rank 0 printing and the
    others silent."""
    import torch.distributed as dist
    if dist.get_rank() != 0:
        sys.stdout = open(os.devnull, "w")
    return main(argv)


def spawn_ranks(fn: Callable, world: int, backend: str, device: str = "cuda",
                args: Sequence = (), timeout: Optional[float] = None
                ) -> List[Any]:
    """Run fn(device, *args) on `world` ranks; returns each rank's result,
    by rank. fn must be importable by name (spawned processes import it).

    Under torchrun the world is torchrun's: fn runs here, over its process
    group, and the result is this rank's alone (a list of one). Otherwise
    `world` processes are spawned, joined through a file store in a fresh
    temporary directory; a rank that fails stops the others and raises
    RuntimeError, and `timeout` seconds without an end raise TimeoutError.
    CUDA kernels are built once here before the ranks start."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    if under_torchrun():
        w = int(os.environ["WORLD_SIZE"])
        check_backend(backend, w, device)
        dev = rank_device(device, int(os.environ["LOCAL_RANK"]))
        if dev.type == "cuda":
            import torch
            torch.cuda.set_device(dev)
        if not dist.is_initialized():
            dist.init_process_group(backend, init_method="env://",
                                    timeout=COLLECTIVE_TIMEOUT)
        return [fn(dev, *args)]
    check_backend(backend, world, device)
    if device == "cuda":
        rank_device(device, 0)
        from repro_torch.kernels import build
        build.build_all()
    tmp = tempfile.mkdtemp(prefix="ranks_")
    init = "file://" + os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, device, init,
                               _matmul_flags(), tmp, fn, tuple(args)))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        t0 = time.monotonic()
        while any(p.is_alive() for p in procs):
            bad = [(r, p.exitcode) for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0][0]} of {world} exited with "
                                   f"code {bad[0][1]}")
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"{world} ranks did not end within "
                                   f"{timeout} s")
            time.sleep(0.05)
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"rank {bad[0][0]} of {world} exited with "
                               f"code {bad[0][1]}")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.pid is None:           # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
