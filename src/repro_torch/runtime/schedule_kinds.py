"""Schedule vocabulary — jax-free on purpose.

`search.execplan` promotes plans to schedules at planning time (possibly
with zero compiles and no jax import at all); `runtime.schedule` executes
them. Both speak this module's language, so the planning layer never has
to import the jax-heavy runtime stack.
"""
from __future__ import annotations

from typing import List, Mapping, Optional

from repro_torch.configs.base import MLP_MOE, TRAIN, ModelConfig

SCHEDULE_SINGLE = "single"
SCHEDULE_SCAN = "scan"
SCHEDULE_PIPELINE = "pipeline_1f1b"
SCHEDULES = (SCHEDULE_SINGLE, SCHEDULE_SCAN, SCHEDULE_PIPELINE)


def schedule_kind(kind: str, microbatches: int, pipe: int = 1) -> str:
    """The execution schedule implied by a (shape kind, plan, mesh) triple.
    Serving steps are always single-shot; training dispatches on the pipe
    axis first, then on microbatch depth."""
    if kind != TRAIN:
        return SCHEDULE_SINGLE
    if pipe > 1:
        return SCHEDULE_PIPELINE
    if microbatches > 1:
        return SCHEDULE_SCAN
    return SCHEDULE_SINGLE


def pipeline_problems(cfg: Optional[ModelConfig], microbatches: int,
                      mesh_shape: Mapping[str, int],
                      global_batch: Optional[int] = None) -> List[str]:
    """Why (cfg, microbatches, mesh) cannot run the 1F1B schedule on a
    pipe>1 mesh; empty = executable. THE single source of truth mirrored
    by runtime.schedule.validate_pipeline (raises), launch.compile's
    fallback_schedule, the search space's PIPE_EXECUTABLE constraint
    (filters candidates) and the predictor's pipeline_would_execute (the
    memory model follows the compile fallback). A MoE TAIL is fine — tail
    blocks run outside the stages with their aux losses collected; only
    MoE inside the repeated unit is blocked. With `global_batch` the
    batch/dp divisibility the pipeline x_spec sharding needs is checked
    too (callers without a workload shape skip it)."""
    pipe = int(mesh_shape.get("pipe", 1))
    problems = []
    if int(mesh_shape.get("model", 1)) > 1:
        problems.append("model axis > 1 (no TP inside pipeline stages yet)")
    if cfg is None or not cfg.unit:
        problems.append("config has no repeated unit to split into stages")
    else:
        if cfg.repeats % max(pipe, 1):
            problems.append(f"unit repeats {cfg.repeats} not divisible by "
                            f"pipe={pipe}")
        if any(blk.mlp == MLP_MOE for blk in cfg.unit):
            problems.append("MoE units unsupported (aux losses cannot "
                            "cross stage boundaries yet)")
    if cfg is not None and cfg.n_prefix_embeds:
        problems.append("prefix-embed archs unsupported under the pipeline "
                        "schedule")
    if microbatches < pipe:
        problems.append(f"microbatches={microbatches} < pipe={pipe}: "
                        "the pipeline never fills")
    if global_batch is not None:
        micro = max(microbatches, 1)
        dp = (int(mesh_shape.get("pod", 1))
              * int(mesh_shape.get("data", 1)))
        if global_batch % micro:
            problems.append(f"global batch {global_batch} not divisible "
                            f"by microbatches={micro}")
        elif (global_batch // micro) % max(dp, 1):
            problems.append(
                f"per-microbatch batch {global_batch // micro} not "
                f"divisible by the data axes (dp={dp}): the pipeline "
                "x_spec shards the microbatch batch dim")
    return problems


def pipeline_executable(cfg: Optional[ModelConfig], microbatches: int,
                        mesh_shape: Mapping[str, int],
                        global_batch: Optional[int] = None) -> bool:
    """True iff a pipe>1 mesh would actually run the 1F1B schedule."""
    if int(mesh_shape.get("pipe", 1)) <= 1:
        return False
    return not pipeline_problems(cfg, microbatches, mesh_shape,
                                 global_batch)
