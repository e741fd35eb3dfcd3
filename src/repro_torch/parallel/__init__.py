"""Parallel layer of the port: the logical-axis rules table and the planning
half of the sharding strategies (what the WSMC planner and profiler read).
The execution half (spec trees, meshes, collectives) waits for the parallel
layer (ROADMAP queue A item 5)."""
from repro_torch.parallel.axes import DEFAULT_RULES  # noqa: F401
from repro_torch.parallel.sharding import Strategy, default_strategy  # noqa: F401
