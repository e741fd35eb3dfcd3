"""Unified plan-search subsystem: a declarative config space (knobs,
constraints, ordering) + pluggable strategies (fastest-first prediction,
exhaustive verification, staged simulate→measure screening, greedy
hillclimbing). The planner, hillclimb, serve, dryrun and the benchmarks all
search through this one API."""
from repro_torch.search.space import (  # noqa: F401
    AUTO, Candidate, ConfigSpace, Constraint, Knob, candidate_overrides,
    hillclimb_space, kv_auto, mesh_space, paper_space, serving_space,
)
from repro_torch.search.strategies import (  # noqa: F401
    CLI_STRATEGIES, CandidateScorer, SearchResult, exhaustive_verified,
    fastest_first, get_strategy, greedy_coordinate, plan_budget, plan_for,
    staged,
)
from repro_torch.search.execplan import (  # noqa: F401
    ExecutionPlan, ServingPlan, auto_mesh_space, auto_plan, for_mesh,
    from_search_result, host_execution, plan_execution, plan_serving,
)
