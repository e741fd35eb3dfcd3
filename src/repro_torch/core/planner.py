"""Capacity planner — the online phase's decision step: turn a capacity
prediction into the workload's memory configuration (paper §III-E).

Since the unified plan-search refactor this module is a thin façade over
`repro_torch.search`: the knob lattice is `search.space.paper_space` and the
policies are `search.strategies` —
  default_plan — the static conservative configuration every workload gets
                 without WSMC: full remat, deep microbatching, factored
                 optimizer, full-HBM capacity request. Always fits; slowest.
                 (The analogue of Spark's static 2 GB executor default.)
  wsmc_plan    — strategies.fastest_first: walk the lattice fastest-first,
                 pick the first plan whose *predicted* capacity fits.
  oracle_plan  — strategies.exhaustive_verified: the paper's manually-found
                 "proper configuration", each candidate verified by a
                 measurement backend (cuda = a real step on the card).
Decision parity with the pre-refactor inline loops is pinned by
tests/test_search.py.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from repro_torch import hw as HW
from repro_torch.configs.base import TRAIN, ModelConfig, ShapeConfig
from repro_torch.core.classifier import Classification
from repro_torch.core.predictor import CapacityPrediction, MemoryPlan
from repro_torch.search import space as SP
from repro_torch.search import strategies as ST

REMATS = SP.REMATS
OPTIMIZERS = SP.OPTIMIZERS


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    plan: MemoryPlan
    prediction: CapacityPrediction
    policy: str
    considered: int


def _kv_default(cfg: ModelConfig, model_size: int = 16) -> str:
    return SP.kv_auto(cfg, model_size)


def candidate_plans(cfg: ModelConfig, shape: ShapeConfig,
                    model_size: int = 16) -> List[MemoryPlan]:
    """The knob lattice, ordered fastest-first by step_time_penalty."""
    space = SP.paper_space(cfg, shape, model_size=model_size)
    return [c.plan for c in space.candidates(cfg, shape)]


def default_plan(cfg: ModelConfig, shape: ShapeConfig,
                 model_size: int = 16) -> MemoryPlan:
    kv = _kv_default(cfg, model_size)
    if shape.kind != TRAIN:
        return MemoryPlan(remat="none", microbatches=1,
                          optimizer="adamw_f32", kv_shard=kv)
    micros = [m for m in (32, 16, 8, 4, 2, 1) if shape.global_batch % m == 0]
    return MemoryPlan(remat="full", microbatches=micros[0],
                      optimizer="adafactor", kv_shard=kv)


def wsmc_plan(cfg: ModelConfig, shape: ShapeConfig, cls: Classification,
              mesh_shape: dict, mode: str = "paper",
              hw: HW.HardwareSpec = HW.TPU_V5E,
              factors: Optional[dict] = None) -> PlanDecision:
    """Paper §III-E: predict per candidate, take the fastest that fits.
    `factors` is the offline-calibrated Table III (profiler.calibrated_factors)."""
    space = SP.paper_space(cfg, shape, mesh_shape)
    res = ST.fastest_first(space, cfg, shape, cls, mode=mode, hw=hw,
                           factors=factors)
    return PlanDecision(plan=res.plan, prediction=res.prediction,
                        policy=res.policy, considered=res.considered)


def oracle_plan(cfg: ModelConfig, shape: ShapeConfig,
                measure: Optional[Callable[[MemoryPlan], float]] = None,
                hw: HW.HardwareSpec = HW.TPU_V5E,
                max_candidates: Optional[int] = None,
                measurer=None) -> Tuple[MemoryPlan, float, int]:
    """The 'proper configuration': measure-verify candidates fastest-first
    until one's measured peak fits. `measure(plan)` returns peak bytes/device.
    Alternatively pass a `core.measure.MemoryMeasurer` — under the card
    backend each call is a real step on the device (expensive; exactly the
    cost WSMC avoids), under the simulator the whole search is free.
    Returns (plan, measured_peak, n_measurements)."""
    if measure is None and measurer is None:
        raise TypeError("oracle_plan needs `measure` or `measurer`")
    space = SP.paper_space(cfg, shape)
    res = ST.exhaustive_verified(space, cfg, shape, measurer=measurer,
                                 measure=measure, hw=hw,
                                 max_candidates=max_candidates)
    return res.plan, res.peak_bytes, res.measured


def plan_deployment(cfg: ModelConfig, shape: ShapeConfig,
                    cls: Optional[Classification], *, n_devices: int,
                    strategy: str = "fastest", measurer=None,
                    factors: Optional[dict] = None,
                    hw: HW.HardwareSpec = HW.TPU_V5E):
    """Beyond the paper: plan the MESH too, and promote the decision to a
    runnable `search.execplan.ExecutionPlan` (plan + mesh + EP + runtime
    schedule, with a `build(devices)` that constructs the real mesh). This
    is the `--mesh auto` decision step the serve CLI takes."""
    from repro_torch.search import execplan as XP
    return XP.plan_execution(cfg, shape, cls, n_devices=n_devices,
                             strategy=strategy, measurer=measurer,
                             factors=factors, hw=hw)
