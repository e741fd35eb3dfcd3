"""Schedule-aware train-step factory: HOW a step executes its microbatches,
after the reference package's runtime/schedule.py.

  single        — one forward/backward over the whole batch.
  scan          — microbatch accumulation (the plan's transient-shrinking
                  knob): a Python loop over the microbatches with an f32
                  gradient accumulator, divided by their number.
  pipeline_1f1b — the pipe-axis runtime: needs the parallel layer, which is
                  not ported yet (ROADMAP A8); asking for it raises.

`make_train_step(cfg, tcfg, schedule="auto")` dispatches; the
`runtime.train_step.make_train_step(cfg, tcfg)` facade delegates here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import TRAIN, ModelConfig
from repro_torch.optim import optimizers as opt
from repro_torch.optim.compress import compress_roundtrip
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.schedule_kinds import (  # noqa: F401 — re-exported vocabulary
    SCHEDULE_PIPELINE, SCHEDULE_SCAN, SCHEDULE_SINGLE, SCHEDULES,
    pipeline_problems, schedule_kind)
from repro_torch.runtime.train_step import (TrainStepConfig, make_loss_fn,
                                            value_and_grad)
from repro_torch.tree import tree_leaves, tree_map

PIPELINE_SLICE = ("the 1F1B pipeline schedule needs the parallel layer "
                  "(meshes, stages, collectives): ROADMAP A8")


def pipe_size_of(mesh) -> int:
    """Pipeline-stage count of a {axis: size} dict (1 = none)."""
    if mesh is None:
        return 1
    return int(dict(mesh).get("pipe", 1))


def validate_pipeline(cfg: ModelConfig, tcfg: TrainStepConfig, mesh) -> int:
    raise NotImplementedError(PIPELINE_SLICE)


def make_pipeline_loss_fn(cfg: ModelConfig, tcfg: TrainStepConfig, mesh,
                          axis: str = "pipe"):
    raise NotImplementedError(PIPELINE_SLICE)


def fallback_schedule(cfg: ModelConfig, tcfg: TrainStepConfig, mesh,
                      global_batch: Optional[int] = None) -> str:
    """Best-effort schedule for a measurement probe: the pipeline kind when
    (cfg, tcfg, mesh) is executable, else scan/single on the same mesh."""
    kind = schedule_kind(TRAIN, tcfg.microbatches, pipe_size_of(mesh))
    if kind == SCHEDULE_PIPELINE:
        if pipeline_problems(cfg, tcfg.microbatches, dict(mesh),
                             global_batch):
            return (SCHEDULE_SCAN if tcfg.microbatches > 1
                    else SCHEDULE_SINGLE)
    return kind


# ---------------------------------------------------------------------------
# Gradient schedules
# ---------------------------------------------------------------------------

def _single_shot(grad_fn):
    def compute(params, batch):
        (_, metrics), grads = grad_fn(params, batch)
        return grads, metrics
    return compute


def _scan_accum(grad_fn, n_micro: int):
    def compute(params, batch):
        b = batch["tokens"].shape[0]
        if b % n_micro:
            raise ValueError(f"global batch {b} not divisible by "
                             f"microbatches={n_micro}")
        mb = b // n_micro
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        macc = None
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            (_, met), g = grad_fn(params, micro)
            with torch.no_grad():
                tree_map(lambda a, g_: a.add_(g_.to(torch.float32)), gacc, g)
            del g
            macc = met if macc is None else {k: macc[k] + met[k]
                                             for k in macc}
        with torch.no_grad():
            tree_map(lambda a: a.div_(n_micro), gacc)
        return gacc, {k: v / n_micro for k, v in macc.items()}
    return compute


# ---------------------------------------------------------------------------
# The factory
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tcfg: TrainStepConfig, *,
                    mesh=None, schedule: str = "auto"):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics): params and opt_state are updated IN PLACE and
    returned; metrics maps "loss", "lb_loss", "z_loss", "grad_norm" and
    "lr" to 0-d f32 tensors.

    schedule: "auto" resolves from tcfg.microbatches (and a mesh's pipe
    axis); or one of SCHEDULES explicitly. The chosen kind is exposed as
    `train_step.schedule`. The scan schedule's gradients are the f32
    accumulator (as the reference's), so the update reads f32 gradients
    there and the parameters' dtype under the single schedule."""
    if schedule == "auto":
        schedule = schedule_kind(TRAIN, tcfg.microbatches, pipe_size_of(mesh))
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; known: {SCHEDULES}")
    if schedule == SCHEDULE_PIPELINE:
        raise NotImplementedError(PIPELINE_SLICE)
    grad_fn = value_and_grad(make_loss_fn(cfg, tcfg))
    if schedule == SCHEDULE_SCAN:
        if tcfg.microbatches <= 1:
            raise ValueError("scan schedule needs microbatches > 1")
        compute_grads = _scan_accum(grad_fn, tcfg.microbatches)
    else:
        compute_grads = _single_shot(grad_fn)

    def train_step(params, opt_state, batch, step):
        grads, metrics = compute_grads(params, batch)
        if tcfg.compress_grads:
            dev = tree_leaves(params)[0].device
            gen = torch.Generator(device=dev).manual_seed(
                (17 << 32) + int(step))
            grads = compress_roundtrip(grads, gen)
        grads, gnorm = opt.clip_by_global_norm(grads, tcfg.max_grad_norm)
        lr = warmup_cosine(int(step), tcfg.optimizer.lr, tcfg.warmup_steps,
                           tcfg.total_steps)
        params, opt_state = opt.apply_updates(tcfg.optimizer, params, grads,
                                              opt_state, lr)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt_state, metrics

    train_step.schedule = schedule
    return train_step
