"""Train-step configuration and loss assembly, after the reference package's
runtime/train_step.py.

The remat / microbatches / optimizer knobs are the WSMC planner's
configuration surface: they trade transient memory against step time. HOW
the microbatches execute (single shot or scan accumulation) is the
schedule's business: `runtime.schedule.make_train_step` is the factory; the
`make_train_step` here is the facade that resolves the schedule from tcfg.

Gradients: `value_and_grad(loss_fn)` hands the model a copy of the params
tree whose leaves are fresh autograd leaves sharing storage with the
params, so the params themselves never require a gradient and the
optimizer can update them in place. A stacked unit leaf [repeats, ...]
becomes the list of its per-repeat slices (the model indexes leaf[r]; a
list indexes the same), so each layer's gradient arrives as its own tensor:
the gradient of a slice of the stacked leaf would be a zero-filled tensor of
the whole leaf per layer. The per-layer gradients are stacked back into the
params' layout at the end.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import optimizers as opt
from repro_torch.tree import tree_map

REMAT_POLICIES = ("none", "dots", "full")

# the matrix products "dots" keeps (jax's dots_with_no_batch_dims_saveable:
# the projections' outputs); everything else in a unit body is recomputed
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrapper(policy: str) -> Callable:
    """f -> f under activation checkpointing: "none" keeps every
    activation; "full" keeps only the unit body's inputs and recomputes it
    in the backward (torch.utils.checkpoint, non-reentrant); "dots" keeps
    the outputs of the matrix products and recomputes the rest (selective
    checkpointing). Under "dots" and "full" the flash-attention forward is
    recomputed, so its kernel launches twice per unit and step."""
    if policy == "none":
        return lambda f: f
    if policy == "full":
        return lambda f: functools.partial(checkpoint, f, use_reentrant=False)
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda f: functools.partial(checkpoint, f, use_reentrant=False,
                                           context_fn=ctx)
    raise ValueError(policy)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    remat: str = "none"
    microbatches: int = 1
    optimizer: opt.OptimizerConfig = opt.OptimizerConfig()
    settings: M.ModelSettings = M.ModelSettings()
    max_grad_norm: float = 1.0
    lb_coef: float = 0.01
    z_coef: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False    # int8 round-trip on accumulated grads


def make_loss_fn(cfg: ModelConfig, tcfg: TrainStepConfig, gatherer=None):
    """loss_fn(params, batch) -> (total loss, {"loss", "lb_loss", "z_loss"}),
    differentiable with respect to the leaves of `params` that require a
    gradient. batch: {"tokens", "targets"} int tensors [b, s] on the params'
    device and, for the modality-stub archs, "prefix_embeds" [b, p, d]; the
    logits of the first cfg.n_prefix_embeds positions are dropped. The
    total adds lb_coef x lb_loss + z_coef x z_loss (the MoE aux losses).

    With a `gatherer` (parallel.sharding.Gatherer) `params` holds this
    rank's shards: the non-unit leaves are gathered as the forward starts,
    each unit repeat's as it runs."""
    wrapper = remat_wrapper(tcfg.remat)
    if gatherer is not None:
        wrapper = gatherer.unit_wrapper(
            None if tcfg.remat == "none" else wrapper)

    def loss_fn(params, batch):
        with (gatherer.saving() if gatherer is not None
              else contextlib.nullcontext()) as gather:
            if gatherer is not None:
                params = gatherer.outer(params, gather)
            logits, _, aux = M.apply(params, cfg, batch["tokens"],
                                     prefix_embeds=batch.get("prefix_embeds"),
                                     settings=tcfg.settings,
                                     unit_wrapper=wrapper)
        if cfg.n_prefix_embeds:
            logits = logits[:, cfg.n_prefix_embeds:]
        loss = cross_entropy(logits, batch["targets"])
        total = (loss + tcfg.lb_coef * aux["lb_loss"]
                 + tcfg.z_coef * aux["z_loss"])
        return total, {"loss": loss.detach(),
                       "lb_loss": aux["lb_loss"].detach(),
                       "z_loss": aux["z_loss"].detach()}

    return loss_fn


def _trainable(params):
    """(tree for the model, its autograd leaves in order): every leaf a
    detached alias of the params' storage that requires a gradient; each
    stacked unit leaf a list of its per-repeat slices."""
    leaves = []

    def one(t):
        a = t.detach().requires_grad_(True)
        leaves.append(a)
        return a

    def stacked(t):
        return [one(s) for s in t.detach().unbind(0)]

    tree = {}
    for k, v in params.items():
        f = stacked if k == "units" else one
        tree[k] = tree_map(f, v)
    return tree, leaves


def grads_like(params, leaves, gl):
    """The gradients `gl` of the autograd leaves `leaves` (from
    _trainable(params)) in the params' layout and dtypes; None gives
    zeros."""
    gl, n = list(gl), iter(range(len(leaves)))

    def take(_):
        i = next(n)
        g, gl[i] = gl[i], None       # let each go once it is placed
        return torch.zeros_like(leaves[i]) if g is None else g

    def take_stacked(t):
        return torch.stack([take(s) for s in t.unbind(0)])

    return {k: tree_map(take_stacked if k == "units" else take, v)
            for k, v in params.items()}


def value_and_grad(loss_fn):
    """fn(params, batch) -> ((total, metrics), grads): grads in the params'
    layout and dtypes (new tensors; a leaf the loss does not reach gets
    zeros)."""

    def fn(params, batch):
        tree, leaves = _trainable(params)
        with torch.enable_grad():
            total, metrics = loss_fn(tree, batch)
            gl = torch.autograd.grad(total, leaves, allow_unused=True)
        return (total.detach(), metrics), grads_like(params, leaves, gl)

    return fn


def make_train_step(cfg: ModelConfig, tcfg: TrainStepConfig, *,
                    schedule: str = "auto"):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics), updating params and opt_state in place. Facade over
    `runtime.schedule.make_train_step` (lazy import: the two modules stay a
    one-way dependency)."""
    from repro_torch.runtime import schedule as SCH
    return SCH.make_train_step(cfg, tcfg, schedule=schedule)
