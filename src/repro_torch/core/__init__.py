"""WSMC — the paper's contribution: workload-specific memory capacity
configuration via expansion-ratio profiling, classification, closed-form
capacity prediction, and knob planning (Liang, Chang, Su 2017).
"""
from repro_torch.core.classifier import (  # noqa: F401
    Category, Classification, FACTOR_SHUF, classify, classify_profiles,
)
from repro_torch.core.expansion import (  # noqa: F401
    MemoryProfile, expansion_ratio, increasing_rate, mean_expansion_ratio,
)
from repro_torch.core.measure import (  # noqa: F401
    BASELINE_PLAN, CudaMeasurer, MemoryMeasurer, ProfileCache,
    SimulatedMeasurer, measurer_for,
)
from repro_torch.core.predictor import (  # noqa: F401
    CapacityPrediction, MemoryPlan, min_devices, predict,
)

# planner sits on top of repro_torch.search, which itself imports
# repro_torch.core.predictor/measure — importing it lazily here keeps
# `import repro_torch.search` (and this package) cycle-free.
_PLANNER_EXPORTS = ("PlanDecision", "candidate_plans", "default_plan",
                    "oracle_plan", "wsmc_plan")


def __getattr__(name):
    if name in _PLANNER_EXPORTS:
        from repro_torch.core import planner
        return getattr(planner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
