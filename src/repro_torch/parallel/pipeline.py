"""Pipeline parallelism over a mesh axis, after the reference package's
parallel/pipeline.py.

Each rank runs its own stage (a contiguous slice of the unit stack,
`split_stages`); boundary activations pass to the next stage, and their
gradients back, by send / receive on the axis's process group. A stage
keeps only its inputs (the boundary carries) between a microbatch's
forward and its backward: the backward runs the stage body again with
autograd recording, then backpropagates through it (the reference wraps
the stage in jax.checkpoint(nothing_saveable) to the same end). So each
stage body runs twice per microbatch, and a stage holds at most as many
carries as it has microbatches in flight.

`pipeline_1f1b` runs the training schedule: warm-up forwards, then one
forward and one backward in turn, then the cool-down backwards. Stage s
has at most min(microbatches, stages - s) microbatches in flight: the
in-flight transient core.predictor models for pipe > 1. The last stage
turns each microbatch's output into its loss and starts that
microbatch's backward at once, so the loss is the caller's callback and
not a function of returned outputs, as it is for the reference's
differentiable `pipeline_apply`. The reference runs fill and drain; the
1F1B order computes the same loss and gradients.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel import comm
from repro_torch.tree import tree_map


def split_stages(stacked_params, n_stages: int):
    """Reshape unit-stacked params [R, ...] -> [n_stages, R/n_stages, ...]
    so each pipeline stage owns a contiguous depth range."""
    if n_stages < 1:
        raise ValueError(f"split_stages: n_stages must be >= 1, got "
                         f"{n_stages}")

    def resh(a):
        r = a.shape[0]
        if r % n_stages:
            raise ValueError(
                f"split_stages: stacked depth {r} does not divide into "
                f"{n_stages} pipeline stages")
        return a.reshape((n_stages, r // n_stages) + tuple(a.shape[1:]))

    return tree_map(resh, stacked_params)


def one_f_one_b(n_micro: int, n_stages: int, stage: int):
    """Stage `stage`'s order of ("F", i) / ("B", i) steps under 1F1B."""
    warm = min(n_stages - stage - 1, n_micro)
    ops = [("F", i) for i in range(warm)]
    for i in range(warm, n_micro):
        ops += [("F", i), ("B", i - warm)]
    ops += [("B", i) for i in range(n_micro - warm, n_micro)]
    return ops


class _Stage:
    """This rank's stage: forward steps (no autograd; the input kept) and
    backward steps (the body run again under autograd, then backward)."""

    def __init__(self, stage_fn, params, mesh, axis, carry, first, last):
        self.fn, self.params = stage_fn, params
        self.group = mesh.groups[axis]
        self.s, self.n = mesh.coords[axis], mesh.shape[axis]
        self.prev = mesh.rank_at(**{axis: self.s - 1}) if self.s else None
        self.next = (mesh.rank_at(**{axis: self.s + 1})
                     if self.s < self.n - 1 else None)
        self.shape, self.dtype, self.device = carry
        self.first, self.last = first, last
        self.saved, self.pending = {}, []

    def forward(self, i: int):
        if self.prev is None:
            x = self.first(i, False)
        else:
            x = comm.recv(self.shape, self.dtype, self.device, self.prev,
                          self.group, tag=2 * i)
        with torch.no_grad():
            y = self.fn(self.params, x.to(self.dtype)).to(self.dtype)
        self.saved[i] = None if self.prev is None else x
        if self.next is not None:
            self.pending.append(comm.isend(y, self.next, self.group,
                                           tag=2 * i))

    def backward(self, i: int):
        x = self.saved.pop(i)
        with torch.enable_grad():
            if self.prev is None:
                x = self.first(i, True)
            else:
                x = x.detach().requires_grad_(True)
            y = self.fn(self.params, x.to(self.dtype)).to(self.dtype)
            if self.next is None:
                outs, grads = self.last(i, y)
            else:
                outs = [y]
                grads = [comm.recv(self.shape, self.dtype, self.device,
                                   self.next, self.group, tag=2 * i + 1)]
            torch.autograd.backward(outs, grads)
        if self.prev is not None:
            self.pending.append(comm.isend(x.grad, self.prev, self.group,
                                           tag=2 * i + 1))

    def wait(self):
        for p in self.pending:
            p.wait()
        self.pending = []


def pipeline_1f1b(stage_fn: Callable, stage_params, n_micro: int, *, mesh,
                  axis: str = "pipe", carry, first: Callable,
                  last: Callable):
    """Run this rank's stage of a 1F1B pipeline over `n_micro`
    microbatches. Gradients accumulate (autograd .grad) into the leaves
    that stage_fn, first and last reach.

    stage_fn(stage_params, x) -> y, x and y of the carry's shape.
    carry: (shape, dtype, device) of a boundary activation; its dtype is
        the stage output's (the first stage's input is cast to it, as the
        reference casts it).
    first(i, grad) -> the first stage's input of microbatch i, made under
        autograd when `grad` (its backward runs at microbatch i's B step).
    last(i, y) -> (tensors, grad_tensors) for torch.autograd.backward, on
        the last stage from its output y (recorded by autograd): e.g.
        ([loss_i], None)."""
    st = _Stage(stage_fn, stage_params, mesh, axis, carry, first, last)
    for kind, i in one_f_one_b(n_micro, st.n, st.s):
        if kind == "F":
            st.forward(i)
        else:
            st.backward(i)
    st.wait()
