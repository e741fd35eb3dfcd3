"""Memory-governed serving: WSMC capacity prediction drives continuous
batching over a slotted KV pool.

`trace`, `engine` and `faults` import neither torch nor a device (the
scheduler is a deterministic state machine and the chaos harness injects
into it); the torch-backed executor lives in
`repro_torch.serving.executor` and is imported lazily so planning/metrics
code never touches device state.
"""
from repro_torch.serving.engine import (  # noqa: F401
    AUDIT_MODES, AllocationFault, BlockAllocator, Cancellation, Completion,
    DoubleFree, Engine, EngineFault, EngineSnapshot, LadderConfig,
    LedgerCorruption, NegativeRefcount, POLICIES, PoolExhausted,
    RESERVATIONS, RUNG_NAMES, ScriptedExecutor, ServeReport,
    TransientExecutorError,
)
from repro_torch.serving.faults import (  # noqa: F401
    ChaosAllocator, ChaosExecutor, FaultPlan, leak_check,
    survivor_mismatches,
)
from repro_torch.serving.trace import (  # noqa: F401
    LengthStats, OnlineLengthStats, Request, describe_trace, length_stats,
    synthetic_trace, trace_context,
)


def __getattr__(name):
    if name == "PagedTorchExecutor":
        from repro_torch.serving import executor
        return getattr(executor, name)
    raise AttributeError(name)
