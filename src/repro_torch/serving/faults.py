"""Deterministic chaos injection for the paged serving engine.

WSMC exists because memory predictions are fallible; this module makes
the engine PROVE it survives its own model being wrong. A seeded
`FaultPlan` names every fault up front — transient executor-call
failures, transient allocation refusals, mid-run HBM budget shrinks (the
misprediction / co-located-tenant case, translated to live block-pool
retirement), request cancellations, and stuck-lane stalls — and two thin
wrappers (`ChaosExecutor`, `ChaosAllocator`) inject the transient ones
from their own seeded streams, always BEFORE the wrapped call mutates
anything, so the engine's rollback/retry paths replay the exact same
call.

Everything is derived from `FaultPlan.seed`: the same plan against the
same trace produces the same fault interleaving, the same survivor set,
and the same token streams — which is what lets the chaos test suite pin
survivors token-identical to a fault-free replay.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.engine import (AllocationFault, BlockAllocator,
                                  ServeReport, TransientExecutorError)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One seeded chaos schedule. `exec_rate`/`alloc_rate` are per-call
    transient-fault probabilities drawn by the wrappers; `shrinks`,
    `cancels` and `stalls` are tick-indexed events the ENGINE applies
    (shrink = (tick, fraction of the current pool to retire), cancel =
    (tick, rid), stall = (tick, lane, duration ticks))."""
    seed: int
    exec_rate: float = 0.0
    alloc_rate: float = 0.0
    shrinks: Tuple[Tuple[int, float], ...] = ()
    cancels: Tuple[Tuple[int, int], ...] = ()
    stalls: Tuple[Tuple[int, int, int], ...] = ()

    @classmethod
    def generate(cls, seed: int, *, ticks: int = 512, n_requests: int = 0,
                 n_lanes: int = 0, exec_rate: float = 0.02,
                 alloc_rate: float = 0.02, n_shrinks: int = 1,
                 shrink_frac: float = 0.25, n_cancels: int = 0,
                 n_stalls: int = 0, stall_len: int = 4) -> "FaultPlan":
        """Draw a full plan from one seed. Shrinks land mid-run (the
        middle half of the tick horizon) so there is live state to
        squeeze; cancels pick rids < `n_requests`, stalls pick lanes <
        `n_lanes` — both need their bound passed to be generated."""
        if ticks < 4:
            raise ValueError(f"generate needs ticks >= 4, got {ticks}")
        if not (0.0 <= exec_rate < 1.0 and 0.0 <= alloc_rate < 1.0):
            raise ValueError("fault rates must be in [0, 1)")
        if not (0.0 <= shrink_frac < 1.0):
            raise ValueError(f"shrink_frac must be in [0, 1), got "
                             f"{shrink_frac}")
        rng = random.Random(seed)
        lo, hi = ticks // 4, 3 * ticks // 4
        shrinks = tuple(sorted((rng.randrange(lo, hi), shrink_frac)
                               for _ in range(n_shrinks)))
        cancels = ()
        if n_cancels and n_requests:
            rids = rng.sample(range(n_requests),
                              min(n_cancels, n_requests))
            cancels = tuple(sorted((rng.randrange(1, ticks), rid)
                                   for rid in rids))
        stalls = ()
        if n_stalls and n_lanes:
            stalls = tuple(sorted((rng.randrange(1, ticks),
                                   rng.randrange(n_lanes),
                                   max(1, stall_len))
                                  for _ in range(n_stalls)))
        return cls(seed=seed, exec_rate=exec_rate, alloc_rate=alloc_rate,
                   shrinks=shrinks, cancels=cancels, stalls=stalls)

    def describe(self) -> str:
        return (f"FaultPlan(seed={self.seed} exec_rate={self.exec_rate} "
                f"alloc_rate={self.alloc_rate} shrinks={len(self.shrinks)}"
                f" cancels={len(self.cancels)} stalls={len(self.stalls)})")


class ChaosExecutor:
    """Wraps any executor and raises `TransientExecutorError` from its
    own seeded stream BEFORE forwarding `prefill_batch` /
    `prefill_chunks` / `decode` — the wrapped executor never sees the
    faulted call, so the engine's retry replays it exactly. Everything
    else (fresh_blocks, decode_width, block_masses, has_recurrent, …)
    delegates untouched."""

    def __init__(self, inner, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self.faults_injected = 0
        self._rng = random.Random((plan.seed << 1) ^ 0x5DEECE66D)

    def _maybe_fault(self, what: str) -> None:
        if self._rng.random() < self.plan.exec_rate:
            self.faults_injected += 1
            raise TransientExecutorError(
                f"chaos: injected transient {what} failure "
                f"#{self.faults_injected}")

    def prefill_batch(self, slots, prompts, tables=None):
        self._maybe_fault("prefill_batch")
        return self.inner.prefill_batch(slots, prompts, tables=tables)

    def prefill_chunks(self, lanes, chunks, starts, tables=None,
                       final=None):
        self._maybe_fault("prefill_chunks")
        return self.inner.prefill_chunks(lanes, chunks, starts,
                                         tables=tables, final=final)

    def decode(self, tokens, positions, tables=None, lanes=None):
        self._maybe_fault("decode")
        if tables is not None:
            return self.inner.decode(tokens, positions, tables=tables,
                                     lanes=lanes)
        return self.inner.decode(tokens, positions, lanes=lanes)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class ChaosAllocator(BlockAllocator):
    """A `BlockAllocator` whose `alloc` transiently refuses from its own
    seeded stream (raising `AllocationFault` before any ledger mutation).
    The engine treats a refusal as a one-tick deferral / admission
    rollback — NOT a capacity signal — so the ledger invariants hold
    through every injection."""

    def __init__(self, n_blocks: int, block_size: int,
                 reservation: str = "worst", *,
                 plan: Optional[FaultPlan] = None):
        super().__init__(n_blocks, block_size, reservation)
        self.plan = plan
        self.faults_injected = 0
        seed = plan.seed if plan is not None else 0
        self._rng = random.Random((seed << 2) ^ 0xB5297A4D)

    def alloc(self, rid: int) -> int:
        if (self.plan is not None
                and self._rng.random() < self.plan.alloc_rate):
            self.faults_injected += 1
            raise AllocationFault(
                f"chaos: allocator refused request {rid} "
                f"(injection #{self.faults_injected})")
        return super().alloc(rid)


def leak_check(alloc: BlockAllocator) -> List[str]:
    """Post-run leak assertions for a drained engine: every non-retired
    block back on the free list, no reservations or owned ledgers left,
    no referenced prefixes, plus the full ledger audit. Returns problem
    strings (empty = clean)."""
    problems = list(alloc.audit())
    if alloc._reserved or alloc._owned:
        problems.append(f"leaked reservations: "
                        f"{sorted(alloc._reserved)} / owned "
                        f"{sorted(alloc._owned)}")
    referenced = [k for k, p in alloc._prefix.items() if p["refs"] > 0]
    if referenced:
        problems.append(f"leaked prefix references: {referenced}")
    live = alloc.free_blocks + sum(len(p["blocks"])
                                   for p in alloc._prefix.values())
    if live != alloc.n_blocks:
        problems.append(f"drained pool not whole: free({alloc.free_blocks})"
                        f" + cached prefix != pool({alloc.n_blocks})")
    return problems


def survivor_mismatches(faulty: ServeReport,
                        clean: ServeReport) -> List[str]:
    """Compare a chaos run against its fault-free replay: every request
    the chaos run COMPLETED must carry the exact token stream the clean
    run produced (faults may delay or cancel work, never corrupt it).
    Returns mismatch strings (empty = token-identical survivors)."""
    clean_by = {c.rid: c.tokens for c in clean.completions}
    out = []
    for c in faulty.completions:
        want = clean_by.get(c.rid)
        if want is None:
            out.append(f"rid {c.rid} completed under chaos but not in "
                       "the clean run")
        elif c.tokens != want:
            out.append(f"rid {c.rid} tokens diverged under chaos: "
                       f"{c.tokens[:8]}... != {want[:8]}...")
    return out


def merge_reports(parts: Sequence[ServeReport]) -> Dict:
    """Small helper for the benchmark: goodput-relevant aggregates over
    a set of reports (e.g. the fault-free vs degraded cells)."""
    return {
        "completed": sum(len(p.completions) for p in parts),
        "cancelled": sum(len(p.cancellations) for p in parts),
        "tokens": sum(p.generated_tokens for p in parts),
        "ticks": sum(p.ticks for p in parts),
    }
