"""The port's collectives over `torch.distributed` process groups: all-reduce,
all-gather, reduce-scatter, broadcast and point-to-point send / receive,
and the autograd Function that all-gathers a weight shard in the forward
and reduce-scatters its gradient in the backward; and the forward
collectives of tensor parallelism over a mesh's `model` group
(`model_axis`, `tp_sum`, `tp_gather_last`).

A group's backend is the one its process group was made with (the caller
chose it: `launch.mesh.spawn_ranks`, `torchrun`).

- `nccl` groups take CUDA tensors as they are, on the card: all-gather
  and reduce-scatter are NCCL's own (`all_gather_into_tensor`,
  `reduce_scatter_tensor`), and every collective is queued on the current
  stream and returns at once.
- `gloo` computes on host memory. Where a CUDA tensor meets a `gloo`
  group, this module copies it into pinned host memory, runs the
  collective there and copies the result back to the tensor's device, and
  adds the bytes it moved each way to `staged_bytes`. That is not a
  fallback: the computation stays on the card, and only the bytes of the
  collective cross the host, as they must when ranks share one card (NCCL
  refuses two ranks on one device). On gloo, all-gather and
  reduce-scatter are all-reduces, which gloo ran about twice as fast as
  its all-gather on one host (a CPU sandbox, two ranks): a gather sums the
  bytes of a buffer that is zero outside each rank's own block (a sum of
  bytes with zeros, so exact to the bit), and a reduce-scatter keeps this
  rank's chunk of the sum.

Ranks of a group are numbered as `launch.mesh.Mesh` makes them: a group
along one mesh axis lists its global ranks in the order of that axis's
coordinate, so group rank = coordinate.

Tensor parallelism (Megatron-style, for serving and training): inside
`model_axis(group)` the model's layers find their weights cut over
`group` (column-parallel q / k / v / wi, row-parallel wo, a vocab-sharded
table) and combine them with `tp_sum` (f32 partial products summed,
rounded once by the caller), `tp_gather_last` (vocab-sharded logits
gathered along the last dim) and `tp_enter` (a replicated activation
entering a column-parallel product). Each is an autograd Function whose
backward is the collective's transpose, so a loss computed alike on every
rank of the group gives every rank the gradient of its own shards:

- `tp_sum`: all-reduce forward, identity backward (the sum's gradient
  reaches each partial unchanged; Megatron's g);
- `tp_enter`: identity forward, all-reduce of the gradient backward (each
  rank's column products give only its share of the input's gradient;
  Megatron's f);
- `tp_gather_last`: all-gather forward, backward this rank's slice of the
  gathered gradient.

The forward of each is the plain collective, bit for bit. A gradient
leaving the model code is then equal on every rank of the group for a
replicated leaf (norms) and this rank's own for a sharded one: nothing
sums the weights' gradients over the model axis.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
import torch.distributed as dist

# bytes copied between the card and the host for gloo collectives (both
# directions), and host seconds spent in gloo collectives (staging
# included), since the process started or the caller reset them. nccl
# collectives are queued on the stream, so neither counts them.
staged_bytes = 0
seconds = 0.0
# staged_bytes split by call kind: the collective's name, or the label its
# caller gave ("tp_partial_sum", "tp_vocab_gather", "tp_embed", "tp_mass",
# "tp_enter_grad", and for MoE blocks "tp_router", "tp_moe_sum",
# "tp_gate_grad")
staged_by_kind = collections.Counter()
_kind = None

# the model group tensor parallelism runs over (model_axis), None outside
_model_group = None


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


@contextlib.contextmanager
def _clock(device: torch.device, group, kind: str):
    """Adds a gloo collective's host time to `seconds` and names the kind
    its staged bytes count under. For a CUDA tensor the card is
    synchronised first, so the time is the collective's and not that of
    the kernels queued before it (its staging copy would wait for them
    anyway). An nccl collective is neither synchronised nor timed: it runs
    on the stream, beside the compute."""
    global seconds, _kind
    if not _gloo(group):
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    prev, _kind = _kind, kind
    try:
        yield
    finally:
        _kind = prev
        seconds += time.perf_counter() - t0


def _add_staged(n: int):
    global staged_bytes
    staged_bytes += n
    staged_by_kind[_kind] += n


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and _gloo(group)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    _add_staged(t.numel() * t.element_size())
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t.detach())


def _to_device(h: torch.Tensor, device) -> torch.Tensor:
    _add_staged(h.numel() * h.element_size())
    return h.to(device)


def _buffer(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of `t` for an in-place collective: in pinned host memory
    where gloo meets a CUDA tensor, else beside `t`."""
    return _to_host(t) if _staged(t, group) else t.detach().clone()


def _back(buf: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return _to_device(buf, t.device) if buf.device != t.device else buf


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group, op: str = "sum",
               kind: str = "all_reduce") -> torch.Tensor:
    """A new tensor: the sum (or "max") of `t` over the group."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    with _clock(t.device, group, kind):
        buf = _buffer(t, group)
        dist.all_reduce(buf, op=red, group=group)
        return _back(buf, t)


def all_gather(t: torch.Tensor, group, dim: int = 0,
               kind: str = "all_gather") -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order
    (each rank's `t` of the same shape), on `t`'s device; contiguous, as
    `sharding.Gatherer` assumes when it re-gathers a saved weight."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dim = dim % t.dim()
    with _clock(t.device, group, kind):
        if not _gloo(group):
            x = t.detach().movedim(dim, 0).contiguous()
            out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                              dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, x, group=group)
            return out.movedim(0, dim).contiguous()
        staged = t.is_cuda
        shape = list(t.shape)
        k = shape[dim]
        shape[dim] = k * n
        full = torch.zeros(shape, dtype=t.dtype, pin_memory=staged)
        full.narrow(dim, r * k, k).copy_(t.detach())
        if staged:
            _add_staged(t.numel() * t.element_size())
        dist.all_reduce(full.view(torch.uint8), group=group)
        return _back(full, t)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along `dim` of the sum of `t` over the group, on
    `t`'s device."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    with _clock(t.device, group, "reduce_scatter"):
        if not _gloo(group):
            x = t.detach().movedim(dim, 0).contiguous()
            out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                              dtype=t.dtype, device=t.device)
            dist.reduce_scatter_tensor(out, x, group=group)
            return out.movedim(0, dim).contiguous()
        buf = _buffer(t, group)
        dist.all_reduce(buf, group=group)
        return _back(buf, t).chunk(n, dim)[r].contiguous()


def broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """A new tensor: `t` of the rank whose GLOBAL rank is `src`, on every
    rank of the group (each passes a tensor of the same shape and dtype)."""
    with _clock(t.device, group, "broadcast"):
        buf = _buffer(t, group)
        dist.broadcast(buf, src=src, group=group)
        return _back(buf, t)


class Pending:
    """An isend in flight; keeps its (staged) buffer alive until `wait`."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self):
        self.work.wait()
        self.buf = None


def isend(t: torch.Tensor, dst: int, group, tag: int = 0) -> Pending:
    """Start sending `t` to GLOBAL rank `dst`; wait() the result before
    the step ends. (nccl ignores the tag: sends to one peer arrive in the
    order they were made, as the pipeline's are received.)"""
    with _clock(t.device, group, "send"):
        buf = _to_host(t) if _staged(t, group) else t.detach().contiguous()
        return Pending(dist.isend(buf, dst=dst, group=group, tag=tag), buf)


def recv(shape, dtype, device, src: int, group, tag: int = 0
         ) -> torch.Tensor:
    """Receive a tensor of `shape` and `dtype` from GLOBAL rank `src`, onto
    `device`."""
    dev = torch.device(device)
    with _clock(dev, group, "recv"):
        if dev.type != "cuda" or not _gloo(group):
            buf = torch.empty(shape, dtype=dtype, device=dev)
            dist.recv(buf, src=src, group=group, tag=tag)
            return buf
        h = torch.empty(shape, dtype=dtype, pin_memory=True)
        dist.recv(h, src=src, group=group, tag=tag)
        return _to_device(h, dev)


class AllGather(torch.autograd.Function):
    """forward: the group's shards concatenated along `dim`; backward: the
    gradient reduce-scattered (summed over the group) back to the shard."""

    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(shard, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.group, ctx.dim), None, None


# ---------------------------------------------------------------------------
# Tensor parallelism over the model group
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def model_axis(group):
    """Run the enclosed model code tensor-parallel over `group` (a mesh's
    "model" group); None, or a group of one rank, runs it whole. A
    training step runs its forward and backward inside it (a recomputed
    forward reads it again)."""
    global _model_group
    prev = _model_group
    _model_group = (group if group is not None
                    and dist.get_world_size(group) > 1 else None)
    try:
        yield
    finally:
        _model_group = prev


def model_group():
    """The group `model_axis` set; raises outside it (a weight cut over a
    model axis met with no group to combine its pieces over)."""
    if _model_group is None:
        raise RuntimeError("a tensor-parallel weight shard outside "
                           "comm.model_axis(group)")
    return _model_group


def model_size() -> int:
    """Ranks of the model axis in force (1 outside `model_axis`)."""
    return 1 if _model_group is None else dist.get_world_size(_model_group)


def model_rank() -> int:
    """This rank's coordinate on the model axis (0 outside `model_axis`)."""
    return 0 if _model_group is None else dist.get_rank(_model_group)


class _TPSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, kind):
        return all_reduce(t, group, kind=kind)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _TPEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, kind):
        ctx.group, ctx.kind = group, kind
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group, kind=ctx.kind), None, None


class _TPGatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, kind):
        ctx.rank, ctx.width = dist.get_rank(group), t.shape[-1]
        return all_gather(t, group, dim=t.dim() - 1, kind=kind)

    @staticmethod
    def backward(ctx, grad):
        w = ctx.width
        return (grad[..., ctx.rank * w:(ctx.rank + 1) * w].contiguous(),
                None, None)


def tp_sum(t: torch.Tensor, kind: str = "tp_partial_sum") -> torch.Tensor:
    """The sum of `t` over the model group, in `t`'s dtype (f32 partial
    products: the caller rounds the sum once). Backward: the gradient
    unchanged."""
    return _TPSum.apply(t, model_group(), kind)


def tp_enter(t: torch.Tensor, kind: str = "tp_enter_grad") -> torch.Tensor:
    """`t` (replicated over the model group) as the input of this rank's
    column-parallel products: unchanged forward; backward, the gradient
    summed over the group (its staged bytes counted under `kind`). Outside
    a model axis, `t` itself."""
    if _model_group is None:
        return t
    return _TPEnter.apply(t, _model_group, kind)


def tp_gather_last(t: torch.Tensor,
                   kind: str = "tp_vocab_gather") -> torch.Tensor:
    """The model group's shards of `t` concatenated along its last dim, in
    coordinate order (vocab-sharded logits, an EP rank's router columns),
    its staged bytes counted under `kind`. Backward: this rank's slice of
    the gradient (the gathered tensor is used alike on every rank, so its
    gradient is already the whole one there: no sum)."""
    return _TPGatherLast.apply(t, model_group(), kind)
