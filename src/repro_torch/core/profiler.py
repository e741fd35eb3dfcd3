"""Online workload profiling (paper §III-E) and the offline knowledge base.

Online phase: an ad-hoc workload (arch × shape × kind) is measured on a
*ladder of small shapes* (the paper's 50-250 MB inputs), its per-device
transient/input bytes classified, and the classification handed to the
planner. Measurement goes through a pluggable `core.measure.MemoryMeasurer`:
the card backend (`CudaMeasurer`: one step on the CUDA device, its bytes read
from the caching allocator) or the analytical simulator (closed form, no
device).

Offline phase: the same over the benchmark suite (the 10 assigned archs),
persisted as JSON — the paper's Table III knowledge base.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs.base import DECODE, ModelConfig, ShapeConfig
from repro_torch.core import expansion as E
from repro_torch.core.classifier import Classification, classify_profiles
from repro_torch.core.measure import (BASELINE_PLAN, CudaMeasurer,
                                      MemoryMeasurer)
from repro_torch.core.predictor import MemoryPlan
from repro_torch.models import model as M
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.parallel import sharding as S
from repro_torch.runtime.train_step import TrainStepConfig


def ladder_shapes(shape: ShapeConfig, n_points: int = 3,
                  base_seq: int = 512,
                  min_seq: int = 0) -> List[ShapeConfig]:
    """Ascending small-shape ladder of the same kind (paper's input set DS).
    `min_seq` floors the ladder (prefix-embed archs need seq > n_prefix)."""
    while base_seq <= min_seq:
        base_seq *= 2
    out = []
    for i in range(n_points):
        s = min(base_seq * (2 ** i), shape.seq_len)
        if shape.kind == DECODE:
            out.append(dataclasses.replace(shape, name=f"{shape.name}@{s}",
                                           seq_len=max(s, 1024)))
        else:
            out.append(dataclasses.replace(shape, name=f"{shape.name}@{s}",
                                           seq_len=s))
    # dedupe (tiny target shapes collapse the ladder)
    seen, uniq = set(), []
    for sh in out:
        if sh.seq_len not in seen:
            uniq.append(sh)
            seen.add(sh.seq_len)
    return uniq


def _tcfg_for(plan: MemoryPlan, settings: Optional[M.ModelSettings] = None
              ) -> TrainStepConfig:
    return TrainStepConfig(
        remat=plan.remat,
        microbatches=plan.microbatches,
        optimizer=OptimizerConfig(kind=plan.optimizer),
        settings=settings or M.ModelSettings(),
    )


def strategy_for(cfg: ModelConfig, plan: MemoryPlan, mesh) -> S.Strategy:
    """`mesh`: an {axis: size} dict or None (no mesh)."""
    base = S.default_strategy(cfg, mesh)
    return dataclasses.replace(base, kv_shard=plan.kv_shard)


def _measurer_or_default(mesh, measurer: Optional[MemoryMeasurer]
                         ) -> MemoryMeasurer:
    """Default: no explicit measurer means the card backend on the given
    mesh (one device; None = {"data": 1}), as the reference package's
    entry points default to its compile backend."""
    return measurer if measurer is not None else CudaMeasurer(mesh)


def profile_point(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  plan: MemoryPlan = BASELINE_PLAN,
                  settings: Optional[M.ModelSettings] = None,
                  measurer: Optional[MemoryMeasurer] = None
                  ) -> E.MemoryProfile:
    """One measurement -> one MemoryProfile (per-device numbers)."""
    return _measurer_or_default(mesh, measurer).measure(cfg, shape, plan,
                                                        settings)


def profile_ladder(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   plan: MemoryPlan = BASELINE_PLAN,
                   n_points: int = 3, base_seq: int = 512,
                   settings: Optional[M.ModelSettings] = None,
                   measurer: Optional[MemoryMeasurer] = None
                   ) -> List[E.MemoryProfile]:
    m = _measurer_or_default(mesh, measurer)
    min_seq = cfg.n_prefix_embeds if shape.kind != "decode" else 0
    return [m.measure(cfg, sh, plan, settings)
            for sh in ladder_shapes(shape, n_points, base_seq, min_seq)]


def classify_workload(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      plan: MemoryPlan = BASELINE_PLAN,
                      n_points: int = 3, base_seq: int = 512,
                      settings: Optional[M.ModelSettings] = None,
                      measurer: Optional[MemoryMeasurer] = None
                      ) -> Classification:
    return classify_profiles(
        profile_ladder(cfg, shape, mesh, plan, n_points, base_seq, settings,
                       measurer))


# ---------------------------------------------------------------------------
# Offline knowledge base (paper Table III)
# ---------------------------------------------------------------------------

def calibrated_factors(kb: dict) -> Dict[str, float]:
    """Platform-calibrated Table III: per category, the conservative envelope
    (max observed per-stage α across the benchmark suite, +10%) — the same
    empirical procedure the paper used to derive {4,3,2,1} on SparkBench.
    Falls back to the paper's values for unseen categories."""
    from repro_torch.core.classifier import FACTOR_SHUF
    out = {c.value: f for c, f in FACTOR_SHUF.items()}
    seen: Dict[str, float] = {}
    for entry in kb.values():
        cat = entry["category"]
        seen[cat] = max(seen.get(cat, 0.0), float(entry["alpha"]))
    for cat, amax in seen.items():
        out[cat] = max(out[cat], amax * 1.10)
    return out


def build_knowledge_base(entries: Dict[str, Classification]) -> dict:
    return {
        name: {
            "category": cls.category.value,
            "alpha": cls.alpha,
            "inc": cls.inc,
            "slope": cls.slope,
            "intercept": cls.intercept,
            "factor": cls.factor,
        }
        for name, cls in entries.items()
    }


def save_knowledge_base(path: str, kb: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(kb, f, indent=2, sort_keys=True)


def load_knowledge_base(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
