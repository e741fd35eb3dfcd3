"""Parallel layer of the port: the logical-axis rules and sharding
strategies (what the WSMC planner and profiler read), and their execution
over torch.distributed: spec trees and local shards (`sharding`), the
collectives (`comm`, imported where used: it needs torch) and the 1F1B
pipeline (`pipeline`). Meshes are `launch.mesh.Mesh`. The reference's
`shard_map` has no counterpart: each rank runs its own program."""
from repro_torch.parallel.axes import (  # noqa: F401
    DEFAULT_RULES, Spec, logical_to_spec,
)
from repro_torch.parallel.sharding import Strategy, default_strategy  # noqa: F401
