"""The serving engine: WSMC-governed continuous batching over a slotted
KV pool.

The scheduler is deliberately jax-free: it speaks to the model through an
executor protocol (``prefill_batch(slots, prompts, tables=None) ->
first_tokens``, ``decode(tokens, positions, tables=None, lanes=None) ->
next_tokens``, ``fresh_blocks(ids)``, plus the optional
``decode_width(n_active)`` width probe and ``prefill_chunks(lanes,
chunks, starts, tables, final)`` for chunked prefill) so the admission /
claim-free /
accounting core is a deterministic state machine the hermetic test tier
can drive with a scripted executor, while the real
`serving.executor.JaxExecutor` / `PagedJaxExecutor` run jitted batched
prefill and batched heterogeneous-position decode over the ring-slot or
paged block pool.

Memory governance (the paper's loop run backwards): the engine never holds
more concurrent sequences than its slot count, and the slot count is
derived from `predictor.serving_capacity` — the capacity model's
prediction of how many sequences fit the per-device HBM budget
(`search.execplan.plan_serving`). Oversubscribed requests wait in the
queue; admission is the memory model acting as the runtime's admission
controller rather than an offline advisor.

Overload governance rides on the `BlockAllocator` reservation ledger:

  reservation="worst"    — admission reserves every block the request can
                           ever write (`blocks_for`), so lazy per-tick
                           allocation can never fail and nothing is ever
                           preempted. Deadlock-free by construction; the
                           expected-vs-worst-case headroom goes unadmitted.
  reservation="expected" — optimistic admission: reserve `E[blocks] +
                           k·sigma` from the trace's length distribution
                           (`trace.length_stats` — the paper's
                           workload-specific prediction applied online)
                           and let decode overdraft. When the free list
                           runs dry the engine EVICTS the victim chosen by
                           SLO class then lowest progress, frees its
                           non-shared blocks, and requeues it for chunked
                           re-prefill from its already-emitted tokens —
                           greedy decode is deterministic, so the replayed
                           request emits the same stream it would have.

Refcounted prefix sharing (`prefix_share=True`): requests carrying a
common system prompt (`Request.prefix_id`) map their leading
`prefix_len // block_size` table entries to shared physical blocks — one
prefill per unique prefix; the boundary partial block is private per
request (copy-on-write by recompute: the suffix chunk rewrites it into
an owned block). Decode can never write a shared block: a sharer's write
positions satisfy `pos >= prefix_len >= shared_blocks * block_size`.

Two admission policies share every other line of the loop:

  continuous — claim any free slot the moment a queued request can take it
               (per-slot backfill; this is continuous batching).
  static     — the fixed-batch baseline: admit a full batch only when the
               pool is completely idle, then run it to completion. Mixed
               generation lengths leave stragglers pinning idle slots,
               which is exactly the occupancy gap the benchmark reports.
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.serving.trace import LengthStats, Request

POLICIES = ("continuous", "static")
RESERVATIONS = ("worst", "expected")
AUDIT_MODES = ("off", "strict", "count")


class PoolExhausted(RuntimeError):
    """The free list is empty and no unreferenced cached prefix remains to
    reclaim. Reachable under reservation="expected" (worst-case
    reservations guarantee a free block for every legal alloc) or after a
    mid-run `shrink` retired blocks out from under worst-case
    reservations — the engine answers by evicting a victim and retrying."""


class DoubleFree(RuntimeError):
    """A block (or a request's whole holding) was returned to the free
    list twice — the ledger corruption `BlockAllocator.free`/`free_block`
    refuse to commit silently."""


class NegativeRefcount(RuntimeError):
    """A prefix release would drive its refcount negative (released more
    times than acquired)."""


class AllocationFault(RuntimeError):
    """A TRANSIENT allocation failure injected by the chaos harness
    (`serving.faults.ChaosAllocator`): the allocator refused a block it
    may well have. Unlike `PoolExhausted` this is not a capacity signal —
    the engine defers the lane (or rolls back the admission) and retries
    next tick instead of evicting."""


class TransientExecutorError(RuntimeError):
    """One executor call failed transiently (chaos-injected or a real
    device hiccup). Raised BEFORE the executor mutates any state, so the
    engine's bounded retry-with-backoff replays the exact same call."""


class EngineFault(RuntimeError):
    """The engine gave up: more consecutive transient executor faults
    than `max_exec_retries` allows."""


class LedgerCorruption(RuntimeError):
    """The every-tick ledger auditor found a broken invariant (audit
    mode "strict" — production mode "count" degrades this to a
    counter in `ServeReport.audit_failures`)."""


class BlockAllocator:
    """jax-free free-list allocator over the paged KV block pool.

    Physical ids run 1..n_blocks (id 0 is the executor's scratch block for
    inactive decode lanes — never handed out). Admission reserves a
    request's OWN footprint up front and physical blocks are allocated
    lazily as decode crosses block boundaries. Under the default
    `reservation="worst"` the reservation is `blocks_for` (every block the
    request can ever write), so `alloc` inside a reservation can never
    fail and the engine can never deadlock mid-decode; `free` returns a
    completed request's blocks to the pool for immediate reuse. Under
    `reservation="expected"` the engine reserves its safety-margined
    expected footprint instead and `alloc` may overdraft past it — when
    the free list is empty and no cached prefix is reclaimable, `alloc`
    raises `PoolExhausted` and the engine evicts.

    Shared prefixes are refcounted side ledgers: `create_prefix` carves
    blocks out of the free list, `acquire_prefix`/`release_prefix` track
    the requests reading through them, and a prefix at refcount 0 stays
    CACHED (a later request re-acquires it without re-prefilling) but is
    reclaimable under pressure. `committed` counts reservations plus
    referenced prefix blocks — cached-but-unreferenced prefixes are free
    capacity as far as admission is concerned.
    """

    def __init__(self, n_blocks: int, block_size: int,
                 reservation: str = "worst"):
        if n_blocks < 1:
            raise ValueError(f"BlockAllocator needs n_blocks >= 1, got "
                             f"{n_blocks} (serving_block_capacity said "
                             "nothing fits — raise the budget)")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if reservation not in RESERVATIONS:
            raise ValueError(f"unknown reservation mode {reservation!r}; "
                             f"known: {RESERVATIONS}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.reservation = reservation
        self._free: Deque[int] = collections.deque(range(1, n_blocks + 1))
        self._owned: Dict[int, List[int]] = {}     # rid -> physical ids
        self._reserved: Dict[int, int] = {}        # rid -> reservation
        # prefix key -> {"blocks": [...], "refs": int}; insertion order is
        # the (deterministic) reclaim order
        self._prefix: Dict[object, Dict] = {}
        # mid-run budget shrink (`shrink`): permanently retired block ids,
        # plus the retirement debt collected as live blocks are freed
        self._retired_ids: set = set()
        self._shrink_debt = 0
        self.peak_in_use = 0
        self.peak_committed = 0

    def blocks_for(self, req: Request) -> int:
        """Worst-case blocks `req` can ever hold: its written positions are
        0..prompt+max_new-2 (the last generated token is never cached)."""
        written = len(req.prompt) + req.max_new - 1
        return max(-(-written // self.block_size), 1)

    @property
    def committed(self) -> int:
        """Blocks promised or held: per-request max(reservation, owned)
        (expected-mode overdrafts count at their real size) plus every
        REFERENCED prefix block."""
        own = sum(max(n, len(self._owned[rid]))
                  for rid, n in self._reserved.items())
        pfx = sum(len(p["blocks"]) for p in self._prefix.values()
                  if p["refs"] > 0)
        return own + pfx

    def can_admit(self, n: int) -> bool:
        return self.committed + n <= self.n_blocks

    def reserve(self, rid: int, n: int) -> None:
        if not self.can_admit(n):
            raise RuntimeError(f"reserve({rid}) over-commits the pool")
        if rid in self._reserved:
            raise RuntimeError(f"request {rid} already holds a reservation")
        self._reserved[rid] = n
        self._owned[rid] = []
        self.peak_committed = max(self.peak_committed, self.committed)

    def alloc(self, rid: int) -> int:
        if rid not in self._owned:
            raise RuntimeError(f"request {rid} holds no reservation")
        if (self.reservation == "worst"
                and len(self._owned[rid]) >= self._reserved[rid]):
            raise RuntimeError(f"request {rid} exceeded its reservation")
        while not self._free:       # a reclaim can be swallowed whole by
            if not self._reclaim():  # shrink debt, so keep reclaiming
                raise PoolExhausted(f"no free block for request {rid}: "
                                    f"{self.in_use}/{self.n_blocks} in use, "
                                    "no cached prefix to reclaim")
        bid = self._free.popleft()
        self._owned[rid].append(bid)
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        self.peak_committed = max(self.peak_committed, self.committed)
        return bid

    def _absorb(self, ids: Sequence[int]) -> List[int]:
        """Route freed blocks to outstanding shrink debt first (they
        retire instead of recirculating); return the survivors."""
        out: List[int] = []
        for bid in ids:
            if self._shrink_debt > 0:
                self._shrink_debt -= 1
                self._retired_ids.add(bid)
                self.n_blocks -= 1
            else:
                out.append(bid)
        return out

    def free(self, rid: int) -> List[int]:
        if rid not in self._owned:
            raise DoubleFree(f"request {rid} owns no blocks "
                             "(double free, or never reserved)")
        ids = self._owned.pop(rid)
        del self._reserved[rid]
        self._free.extend(self._absorb(ids))  # FIFO reuse: deterministic
        return ids

    def free_block(self, rid: int, bid: int) -> None:
        """Return ONE of `rid`'s own blocks to the free list mid-flight
        (the retention policy dropping a cold block). The reservation
        stays — only the physical block is recycled. Shared prefix blocks
        are never in a request's owned list, so retention can't free one
        through here; freeing a block twice (or one the request never
        owned) raises `DoubleFree` instead of corrupting the free list."""
        owned = self._owned.get(rid)
        if owned is None:
            raise DoubleFree(f"request {rid} owns no blocks (double free)")
        if bid not in owned:
            raise DoubleFree(f"request {rid} does not own block {bid} "
                             "(double free, or a shared prefix block)")
        owned.remove(bid)
        self._free.extend(self._absorb([bid]))

    def shrink(self, n: int) -> int:
        """Permanently retire up to `n` blocks — the mid-run HBM budget
        shrink (a co-located tenant claiming memory, or the capacity
        model having over-promised). Free blocks retire immediately (from
        the cold end of the free list); the remainder becomes retirement
        DEBT collected as live blocks are freed, so in-flight lanes are
        never yanked — pressure surfaces through `committed > n_blocks`
        and the engine's degradation ladder works it off. At least one
        block always survives. Returns the count retired immediately."""
        if n < 0:
            raise ValueError(f"shrink needs n >= 0, got {n}")
        n = min(n, self.n_blocks - 1)
        take = min(n, len(self._free))
        for _ in range(take):
            bid = self._free.pop()      # FIFO alloc side is popleft
            self._retired_ids.add(bid)
        self.n_blocks -= take
        self._shrink_debt += n - take
        return take

    @property
    def retired_blocks(self) -> int:
        """Blocks permanently lost to `shrink` so far (debt not yet
        collected is not counted — those blocks are still live)."""
        return len(self._retired_ids)

    @property
    def shrink_debt(self) -> int:
        return self._shrink_debt

    def audit(self) -> List[str]:
        """The ledger auditor: every invariant that, when broken, turns
        into silent KV corruption later. Returns problem strings (empty =
        clean). O(pool) — cheap enough for the engine's every-tick
        `audit="strict"` test mode.

          * free + owned + live-prefix blocks partition the pool exactly
          * no physical id appears in two ledgers (or twice in one)
          * retired blocks never re-enter circulation
          * prefix refcounts are never negative
          * reservations and owned ledgers exist in pairs, and in worst
            mode every owned holding is covered by its reservation
        """
        problems: List[str] = []
        free = list(self._free)
        owned = [b for ids in self._owned.values() for b in ids]
        pfx = [b for p in self._prefix.values() for b in p["blocks"]]
        every = free + owned + pfx
        if len(set(every)) != len(every):
            problems.append("a physical block appears twice across the "
                            "free/owned/prefix ledgers")
        if len(every) != self.n_blocks:
            problems.append(f"ledger partition broken: free({len(free)}) "
                            f"+ owned({len(owned)}) + prefix({len(pfx)}) "
                            f"!= pool({self.n_blocks})")
        back = self._retired_ids.intersection(every)
        if back:
            problems.append(f"retired blocks back in circulation: "
                            f"{sorted(back)}")
        for key, p in self._prefix.items():
            if p["refs"] < 0:
                problems.append(f"prefix {key!r} refcount {p['refs']} < 0")
        for rid in self._owned:
            if rid not in self._reserved:
                problems.append(f"request {rid} owns blocks without a "
                                "reservation")
        for rid, n in self._reserved.items():
            if rid not in self._owned:
                problems.append(f"request {rid} reserved without an owned "
                                "ledger")
            elif (self.reservation == "worst"
                    and len(self._owned[rid]) > n):
                problems.append(f"request {rid} owns "
                                f"{len(self._owned[rid])} blocks past its "
                                f"worst-case reservation {n}")
        return problems

    # -- shared prefixes ----------------------------------------------------

    def create_prefix(self, key, n: int) -> Optional[List[int]]:
        """Carve `n` blocks for a shared prefix (refcount 0 until
        acquired). Returns None — without mutating anything — if the pool
        can't physically supply them even after reclaiming cached
        prefixes."""
        if n < 1:
            raise ValueError(f"create_prefix needs n >= 1, got {n}")
        if key in self._prefix:
            raise RuntimeError(f"prefix {key!r} already cached")
        while len(self._free) < n:
            if not self._reclaim():
                return None
        blocks = [self._free.popleft() for _ in range(n)]
        self._prefix[key] = {"blocks": blocks, "refs": 0}
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return list(blocks)

    def acquire_prefix(self, key) -> List[int]:
        p = self._prefix[key]
        p["refs"] += 1
        self.peak_committed = max(self.peak_committed, self.committed)
        return list(p["blocks"])

    def release_prefix(self, key, missing_ok: bool = False) -> None:
        """Drop one reference on a cached prefix. `missing_ok=True` makes
        the release idempotent — a prefix already reclaimed under
        pressure, or already fully released (the eviction-requeue /
        cancellation race), is a no-op instead of a corruption. Without
        it an unbalanced release raises `NegativeRefcount`."""
        p = self._prefix.get(key)
        if p is None or p["refs"] <= 0:
            if missing_ok:
                return
            raise NegativeRefcount(
                f"prefix {key!r} refcount would go negative")
        p["refs"] -= 1

    def prefix_refs(self, key) -> int:
        """Refcount of a cached prefix; -1 if not cached (never created,
        or reclaimed under pressure)."""
        p = self._prefix.get(key)
        return -1 if p is None else p["refs"]

    def _reclaim(self) -> bool:
        """Drop the oldest refcount-0 cached prefix back to the free list
        (shrink debt may swallow some or all of its blocks)."""
        for key, p in self._prefix.items():
            if p["refs"] == 0:
                self._free.extend(self._absorb(p["blocks"]))
                del self._prefix[key]
                return True
        return False

    @property
    def in_use(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def available_blocks(self) -> int:
        """Physically obtainable blocks: the free list plus every cached
        prefix an `alloc` could reclaim."""
        return len(self._free) + sum(len(p["blocks"])
                                     for p in self._prefix.values()
                                     if p["refs"] == 0)


@dataclasses.dataclass
class _Active:
    """One claimed slot: the request plus its decode cursor."""
    req: Request
    admitted: int                # engine tick of FIRST admission
    pos: int                     # next decode position (== tokens emitted + prompt)
    remaining: int               # decode steps still owed
    tokens: List[int]            # ALL generated so far (first from prefill)
    table: List[int] = dataclasses.field(default_factory=list)  # paged: phys block ids
    pending: Tuple[int, ...] = ()  # prompt tail not yet prefilled (chunked)
    prior: Tuple[int, ...] = ()  # tokens emitted before an eviction (the
                                 # re-prefill appends them to the prompt)
    prefix_key: Optional[object] = None   # shared prefix this lane reads
    first_token: int = -1        # tick the FIRST token was emitted (-1: none)
    shared: int = 0              # leading table entries that are SHARED
                                 # prefix blocks (never retention-dropped)


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    tokens: Tuple[int, ...] = ()
    arrival: int = 0
    admitted: int = 0
    finished: int = 0
    first_token: int = 0

    @property
    def latency(self) -> int:
        """Ticks from arrival to last token (queueing + decode)."""
        return self.finished - self.arrival

    @property
    def queue_delay(self) -> int:
        return self.admitted - self.arrival

    @property
    def ttft(self) -> int:
        """Time to first token in ticks (the tail metric eviction and
        chunked prefill move)."""
        return self.first_token - self.arrival


@dataclasses.dataclass(frozen=True)
class Cancellation:
    """A request the engine gave up on, with its resources cleanly
    returned (blocks freed, prefix refs released) and the cause
    surfaced. Reasons: "deadline" (per-request deadline expired), "shed"
    (the backpressure rung rejected the arrival), "chaos" (fault-plan
    injected cancel), "capacity" (after a budget shrink the request can
    never fit the pool again)."""
    rid: int
    tick: int
    reason: str
    arrival: int = 0
    tokens: Tuple[int, ...] = ()     # emitted before the cut (never sent)


# Degradation-ladder rungs, mildest first. Rung k being engaged means
# rungs 1..k are all active.
RUNG_TIGHTEN_PREFILL = 1
RUNG_KV_BEND = 2
RUNG_EVICT = 3
RUNG_SHED = 4
RUNG_NAMES = {0: "normal", 1: "tighten_prefill", 2: "kv_bend",
              3: "evict", 4: "shed"}


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """The graceful-degradation ladder: what the engine trades away, in
    order, when the capacity model turns out wrong (sustained pool
    pressure — a budget shrink, optimistic admission overshooting, a
    burst past the plan). Pressure = `committed >= high * pool` held for
    `patience` consecutive ticks escalates one rung; the same patience
    without pressure de-escalates. Rungs:

      1 tighten_prefill — halve the prefill token budget (floored at one
        chunk / `prefill_floor`): TTFT degrades, decode goodput survives.
      2 kv_bend — engage block retention at `bend_retain` blocks per
        lane, but ONLY if `bend_agreement` (the plan's prior for that
        bend) clears `min_agreement`: quality is traded inside the same
        gate the planner enforces, never blindly.
      3 evict — proactively evict (SLO order) while commitments overhang
        the shrunken pool.
      4 shed — reject new arrivals with an explicit `Cancellation`
        (reason "shed"): backpressure instead of silent queue growth.
    """
    patience: int = 3
    high: float = 0.95
    prefill_floor: int = 0
    bend_retain: int = 0
    bend_agreement: float = 1.0
    min_agreement: float = 0.0
    max_rung: int = RUNG_SHED


@dataclasses.dataclass
class EngineSnapshot:
    """Drain-and-serialize engine state between two ticks — the
    preemption / re-mesh hook (ROADMAP item 5). In-flight lanes are
    serialized as resume records (request + emitted tokens): restore
    re-enters them through the same chunked re-prefill path eviction
    uses, so NO physical pool contents cross the snapshot — the
    suffix-consistent executor regenerates the KV token-identically on
    any fresh allocator/executor (even a different lane count). JSON
    round-trips via `to_json`/`from_json`."""
    tick: int
    requests: List[Dict]             # serialized unfinished Requests
    pending: List[int]               # rids not yet arrived, in order
    queue: List[int]                 # rids queued, in order
    lanes: List[Optional[Dict]]      # per-slot resume record or None
    resume: Dict[int, Dict]          # evicted-and-requeued resume records
    completions: List[Dict]
    cancellations: List[Dict]
    counters: Dict[str, int]
    evictions: int = 0
    ladder: Optional[Dict] = None    # rung/hot/cool/events/rung_ticks
    stats: Optional[Dict] = None     # OnlineLengthStats state
    config: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "EngineSnapshot":
        d = json.loads(s)
        d["resume"] = {int(k): v for k, v in d.get("resume", {}).items()}
        if d.get("ladder") and d["ladder"].get("rung_ticks"):
            d["ladder"]["rung_ticks"] = {
                int(k): v for k, v in d["ladder"]["rung_ticks"].items()}
        return cls(**d)


# counters mirrored between _RunState and EngineSnapshot/ServeReport
_COUNTER_FIELDS = (
    "decode_ticks", "useful", "idle", "admit_only", "lane_tokens",
    "chunk_calls", "block_drops", "peak_queue", "max_concurrent",
    "prefills", "prefill_calls", "prefill_tokens", "shed", "exec_faults",
    "backoff_ticks", "alloc_faults", "shrunk", "audits", "audit_failures")


@dataclasses.dataclass
class _RunState:
    """All mutable state of one trace replay — the unit snapshot/restore
    serializes and `_step` advances one tick at a time."""
    pending: Deque[Request]
    queue: Deque[Request]
    slots: List[Optional[_Active]]
    completions: List[Completion]
    cancellations: List[Cancellation]
    tick: int = 0
    decode_ticks: int = 0
    useful: int = 0
    idle: int = 0
    admit_only: int = 0
    lane_tokens: int = 0
    chunk_calls: int = 0
    block_drops: int = 0
    peak_queue: int = 0
    max_concurrent: int = 0
    prefills: int = 0
    prefill_calls: int = 0
    prefill_tokens: int = 0
    # fault handling
    exec_wait: int = 0               # backoff ticks left before retrying
    exec_fails: int = 0              # CONSECUTIVE transient exec faults
    exec_faults: int = 0             # total transient exec faults absorbed
    backoff_ticks: int = 0           # ticks spent waiting out backoff
    alloc_faults: int = 0            # transient allocation faults absorbed
    shed: int = 0                    # arrivals rejected by rung 4
    shrunk: int = 0                  # blocks retired by budget shrinks
    audits: int = 0
    audit_failures: int = 0
    stalled: Dict[int, int] = dataclasses.field(default_factory=dict)
    # degradation ladder
    rung: int = 0
    max_rung: int = 0
    hot: int = 0                     # consecutive pressured ticks
    cool: int = 0                    # consecutive unpressured ticks
    ladder_events: List[Dict] = dataclasses.field(default_factory=list)
    rung_ticks: Dict[int, int] = dataclasses.field(default_factory=dict)


def _percentile(vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not vals:
        return 0.0
    s = sorted(vals)
    rank = max(1, min(len(s), -(-int(q * len(s)) // 100)))
    return float(s[rank - 1])


@dataclasses.dataclass
class ServeReport:
    """Deterministic step-counted serving metrics for one trace replay."""
    policy: str
    n_slots: int
    completions: List[Completion]
    ticks: int                   # total engine ticks elapsed
    decode_ticks: int            # ticks that executed a batched decode step
    useful_slot_tokens: int      # sum over decode ticks of active slots
    idle_ticks: int              # ticks with no admission, prefill chunk,
                                 # or decode (pure waiting)
    peak_queue: int
    max_concurrent: int
    prefills: int
    prefill_calls: int = 0       # batched prefill invocations (<= prefills)
    n_blocks: int = 0            # paged pool size (0 = ring slots)
    peak_blocks: int = 0         # peak physical blocks in use (paged)
    admit_ticks: int = 0         # ticks that only admitted / chunked /
                                 # evicted (no decode) — the invariant is
                                 # ticks == decode + admit + idle
    decode_lane_tokens: int = 0  # sum over decode ticks of the width the
                                 # executor actually computed at (== n_slots
                                 # x decode_ticks without lane compaction)
    chunk_calls: int = 0         # batched chunk-prefill invocations
    evictions: int = 0           # evict-and-requeue events (expected mode)
    block_drops: int = 0         # cold blocks freed by the retention policy
    prefill_tokens: int = 0      # prompt tokens prefilled (whole-prompt +
                                 # chunked), so prefill work is visible in
                                 # occupancy accounting instead of folded
                                 # into admit ticks
    # fault tolerance (all zero / empty on a fault-free run)
    cancellations: List[Cancellation] = dataclasses.field(
        default_factory=list)    # deadline / shed / chaos / capacity
    shed: int = 0                # arrivals rejected by the backpressure rung
    exec_faults: int = 0         # transient executor faults absorbed
    backoff_ticks: int = 0       # ticks spent waiting out retry backoff
    alloc_faults: int = 0        # transient allocation faults absorbed
    shrunk_blocks: int = 0       # blocks retired by mid-run budget shrinks
    audits: int = 0              # ledger audits run
    audit_failures: int = 0      # audits that found a broken invariant
    degradation: Dict = dataclasses.field(default_factory=dict)
                                 # ladder engagement: max/final rung,
                                 # per-rung tick counts, cause-tagged events
    observed_lengths: Dict = dataclasses.field(default_factory=dict)
                                 # OnlineLengthStats.summary() — the live
                                 # sigma_k feedback loop (ROADMAP item 2)

    @property
    def generated_tokens(self) -> int:
        return sum(len(c.tokens) for c in self.completions)

    def occupancy(self) -> float:
        """Useful-token fraction of decode-step slots: of all the slot
        positions the batched decode steps computed, how many produced a
        token a request actually wanted. Lane compaction shrinks the
        denominator to the widths actually run."""
        denom = self.decode_lane_tokens or self.decode_ticks * self.n_slots
        return self.useful_slot_tokens / denom if denom else 0.0

    def throughput(self) -> float:
        """Generated tokens per engine tick."""
        return self.generated_tokens / self.ticks if self.ticks else 0.0

    def prefill_throughput(self) -> float:
        """Prompt tokens prefilled per engine tick."""
        return self.prefill_tokens / self.ticks if self.ticks else 0.0

    def mean_latency(self) -> float:
        if not self.completions:
            return 0.0
        return sum(c.latency for c in self.completions) / len(self.completions)

    def latency_percentiles(self, qs: Sequence[int] = (50, 95, 99)) -> Dict[str, float]:
        """Empty dict when nothing completed (an overload trace can evict
        every request before its first token) — callers probe `.get`."""
        if not self.completions:
            return {}
        lat = [c.latency for c in self.completions]
        return {f"p{q}": _percentile(lat, q) for q in qs}

    def ttft_percentiles(self, qs: Sequence[int] = (50, 95, 99)) -> Dict[str, float]:
        """Empty dict when nothing completed, like latency_percentiles."""
        if not self.completions:
            return {}
        t = [c.ttft for c in self.completions]
        return {f"p{q}": _percentile(t, q) for q in qs}

    def mean_ttft(self) -> float:
        if not self.completions:
            return 0.0
        return sum(c.ttft for c in self.completions) / len(self.completions)

    def block_occupancy(self) -> float:
        """Paged pools: peak fraction of physical blocks in use."""
        return self.peak_blocks / self.n_blocks if self.n_blocks else 0.0

    def describe(self) -> str:
        paged = (f" blocks={self.peak_blocks}/{self.n_blocks}"
                 if self.n_blocks else "")
        if self.decode_ticks and self.decode_lane_tokens:
            paged += (f" mean_width="
                      f"{self.decode_lane_tokens / self.decode_ticks:.1f}")
        if self.chunk_calls:
            paged += f" chunk_calls={self.chunk_calls}"
        if self.evictions:
            paged += f" evictions={self.evictions}"
        if self.block_drops:
            paged += f" block_drops={self.block_drops}"
        if self.prefill_tokens:
            paged += (f" prefill_tokens={self.prefill_tokens} "
                      f"({self.prefill_throughput():.2f} tok/tick)")
        if self.cancellations:
            by = {}
            for c in self.cancellations:
                by[c.reason] = by.get(c.reason, 0) + 1
            paged += " cancelled=" + ",".join(
                f"{k}:{v}" for k, v in sorted(by.items()))
        if self.exec_faults or self.alloc_faults:
            paged += (f" faults(exec={self.exec_faults},"
                      f"alloc={self.alloc_faults})"
                      f" backoff={self.backoff_ticks}")
        if self.shrunk_blocks:
            paged += f" shrunk={self.shrunk_blocks}"
        if self.degradation.get("max_rung"):
            paged += (f" rung_max={self.degradation.get('max_rung_name')}"
                      f"({self.degradation.get('max_rung')})")
        if self.audit_failures:
            paged += f" AUDIT_FAILURES={self.audit_failures}"
        elif self.audits:
            paged += f" audits={self.audits}:clean"
        lp = self.latency_percentiles()
        tp = self.ttft_percentiles()
        tails = (f"lat_p50/p95/p99={lp['p50']:.0f}/{lp['p95']:.0f}/"
                 f"{lp['p99']:.0f} ttft_p95={tp['p95']:.0f} "
                 if lp else "lat_p50/p95/p99=-/-/- ttft_p95=- ")
        return (f"[{self.policy}] slots={self.n_slots} "
                f"completed={len(self.completions)} "
                f"tokens={self.generated_tokens} ticks={self.ticks} "
                f"occupancy={self.occupancy():.3f} "
                f"throughput={self.throughput():.2f} tok/tick "
                f"mean_latency={self.mean_latency():.1f} ticks "
                f"{tails}"
                f"peak_queue={self.peak_queue} "
                f"max_concurrent={self.max_concurrent}"
                f"{paged}")


class ScriptedExecutor:
    """Deterministic jax-free executor: closed-form token functions stand in
    for the model so the scheduler core (admission, claim/free, metrics,
    eviction, prefix sharing) can be pinned by the hermetic test tier and
    compared across policies without a single compile.

    The token functions are SUFFIX-CONSISTENT, mirroring the property the
    real executor gets from its KV cache: `prefill(prompt)` equals
    `decode(prompt[-1], len(prompt) - 1)`, so prefilling `prompt +
    emitted` reproduces exactly the token the interrupted decode would
    have produced next — which is what makes evict-and-requeue and
    prefix-suffix prefill token-identical by construction. `buckets`
    emulates the paged executor's lane compaction: decode_width returns
    the smallest covering bucket and every decode tick's width is
    recorded in `tick_widths`."""

    def __init__(self, vocab_size: int = 97,
                 buckets: Optional[Sequence[int]] = None):
        self.vocab_size = vocab_size
        self.buckets = tuple(sorted(buckets)) if buckets else None
        self.prefills = 0
        self.prefill_batches = 0
        self.decodes = 0
        self.chunk_calls = 0
        self.chunk_tokens = 0
        self.tick_widths: List[int] = []
        # lane -> (start of accumulation, tokens accumulated so far)
        self._partial: Dict[int, Tuple[int, List[int]]] = {}
        # lane -> per-logical-block mass from the last decode (scripted
        # stand-in for attention mass: later blocks are hotter, so the
        # retention policy deterministically drops oldest-first)
        self._last_mass: Dict[int, List[float]] = {}

    def _token_at(self, last: int, pos: int) -> int:
        """The token emitted after consuming token `last` at position
        `pos` — shared by prefill and decode (suffix consistency)."""
        return (17 * last + 7 * pos + 13) % self.vocab_size

    def prefill(self, slot: int, prompt: Sequence[int]) -> int:
        self.prefills += 1
        return self._token_at(prompt[-1], len(prompt) - 1)

    def prefill_batch(self, slots: Sequence[int],
                      prompts: Sequence[Sequence[int]],
                      tables: Optional[Sequence[Sequence[int]]] = None
                      ) -> List[int]:
        self.prefill_batches += 1
        return [self.prefill(s, p) for s, p in zip(slots, prompts)]

    def prefill_chunks(self, lanes: Sequence[int],
                       chunks: Sequence[Sequence[int]],
                       starts: Sequence[int],
                       tables: Optional[Sequence[Sequence[int]]] = None,
                       final: Optional[Sequence[bool]] = None) -> List[int]:
        """Accumulate chunks per lane; on a lane's final chunk emit exactly
        what a whole-prompt prefill reaching the same last (token,
        position) would — so chunked, prefix-suffix and re-prefill
        scheduling are all token-identical by construction, like the real
        executor. A start that doesn't continue the lane's accumulation
        resets it (the engine evicted and re-admitted that lane)."""
        self.chunk_calls += 1
        out: List[int] = []
        for j, lane in enumerate(lanes):
            state = self._partial.get(lane)
            if state is None or state[0] + len(state[1]) != starts[j]:
                state = (starts[j], [])
                self._partial[lane] = state
            state[1].extend(chunks[j])
            self.chunk_tokens += len(chunks[j])
            if final is not None and final[j]:
                start, acc = self._partial.pop(lane)
                self.prefills += 1
                out.append(self._token_at(acc[-1], start + len(acc) - 1))
            else:
                out.append(0)
        return out

    def fresh_blocks(self, ids: Sequence[int]) -> None:
        pass                                 # no physical pool to invalidate

    def decode_width(self, n_active: int) -> Optional[int]:
        """None = no compaction (the engine charges full pool width)."""
        if self.buckets is None:
            return None
        for b in self.buckets:
            if b >= n_active:
                return b
        return self.buckets[-1]

    def decode(self, tokens: Sequence[int], positions: Sequence[int],
               tables: Optional[Sequence[Sequence[int]]] = None,
               lanes: Optional[Sequence[int]] = None) -> List[int]:
        self.decodes += 1
        n_active = len(lanes) if lanes is not None else len(tokens)
        width = self.decode_width(n_active)
        self.tick_widths.append(width if width is not None else len(tokens))
        if tables is not None:
            act = lanes if lanes is not None else range(len(tokens))
            self._last_mass = {
                int(i): [float(j + 1) for j in range(len(tables[i]))]
                for i in act}
        return [self._token_at(t, p) for t, p in zip(tokens, positions)]

    def block_masses(self) -> Dict[int, List[float]]:
        return self._last_mass


class Engine:
    """Continuous-batching serving engine over a slotted or paged KV pool.

    `n_slots` is the admission bound — by construction the engine never
    runs more concurrent sequences than slots, so sizing it from
    `ServingPlan.slots()` makes `predictor.serving_capacity` the admission
    controller. With a `BlockAllocator` the slots become decode LANES and
    admission additionally requires the request's block reservation to fit
    the pool (`serving_block_capacity` run as the admission controller):
    short requests reserve few blocks, so many more of them fit the same
    HBM budget than worst-case ring slots would admit. One `run()` call
    replays one trace to completion.

    With an `reservation="expected"` allocator, pass the trace's
    `length_stats` as `stats`: admission reserves
    `ceil((E[written | prompt bucket] + sigma_k·sigma) / block_size)`
    own blocks instead of the worst case, and pool misses are handled by
    SLO-then-progress eviction (see module docstring). `prefix_share=True`
    (needs `chunk_prefill` — suffixes ride the chunked path) maps common
    system-prompt blocks to shared refcounted physical blocks.
    """

    def __init__(self, executor, n_slots: int, policy: str = "continuous",
                 allocator: Optional[BlockAllocator] = None,
                 chunk_prefill: int = 0, prefill_budget: int = 0,
                 prefix_share: bool = False,
                 stats: Optional[LengthStats] = None,
                 sigma_k: float = 1.0, kv_retain: int = 0,
                 deadline: int = 0, faults=None,
                 ladder: Optional[LadderConfig] = None,
                 audit: str = "off", max_exec_retries: int = 6):
        if n_slots < 1:
            raise ValueError(f"Engine needs n_slots >= 1, got {n_slots} "
                             "(serving_capacity said nothing fits — lower "
                             "the context or raise the budget)")
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
        if chunk_prefill < 0:
            raise ValueError(f"chunk_prefill must be >= 0, got "
                             f"{chunk_prefill}")
        if (chunk_prefill and allocator is not None
                and chunk_prefill % allocator.block_size):
            raise ValueError(f"chunk_prefill={chunk_prefill} must be a "
                             f"multiple of the kv block size "
                             f"{allocator.block_size}")
        if prefill_budget < 0:
            raise ValueError(f"prefill_budget must be >= 0, got "
                             f"{prefill_budget}")
        if prefill_budget and not chunk_prefill:
            raise ValueError("prefill_budget needs chunk_prefill > 0 (the "
                             "token budget schedules prompt CHUNKS; "
                             "whole-prompt prefill is all-or-nothing)")
        if prefix_share and allocator is None:
            raise ValueError("prefix_share needs a BlockAllocator (shared "
                             "prefixes live in the paged block pool)")
        if prefix_share and not chunk_prefill:
            raise ValueError("prefix_share needs chunk_prefill > 0 (a "
                             "sharer's suffix prefill rides the chunked "
                             "path)")
        if prefix_share and getattr(executor, "has_recurrent", False):
            raise ValueError("prefix_share is attention-only: shared "
                             "prefix blocks carry KV, not the recurrent "
                             "scan state at the prefix boundary, so a "
                             "sharer cannot resume mid-prompt")
        if sigma_k < 0:
            raise ValueError(f"sigma_k must be >= 0, got {sigma_k}")
        if kv_retain < 0:
            raise ValueError(f"kv_retain must be >= 0, got {kv_retain}")
        if kv_retain and allocator is None:
            raise ValueError("kv_retain needs a BlockAllocator (retention "
                             "drops paged blocks back to the free list)")
        if deadline < 0:
            raise ValueError(f"deadline must be >= 0 ticks, got {deadline}")
        if audit not in AUDIT_MODES:
            raise ValueError(f"unknown audit mode {audit!r}; known: "
                             f"{AUDIT_MODES}")
        if audit != "off" and allocator is None:
            raise ValueError("audit needs a BlockAllocator (the auditor "
                             "checks the block ledger)")
        if max_exec_retries < 1:
            raise ValueError(f"max_exec_retries must be >= 1, got "
                             f"{max_exec_retries}")
        if ladder is not None and allocator is None:
            raise ValueError("the degradation ladder reads pool pressure "
                             "off a BlockAllocator (committed vs n_blocks)")
        if (faults is not None and allocator is None
                and getattr(faults, "shrinks", ())):
            raise ValueError("fault-plan budget shrinks need a "
                             "BlockAllocator (they retire pool blocks)")
        self.executor = executor
        self.n_slots = int(n_slots)
        self.policy = policy
        self.allocator = allocator
        # prompts longer than this prefill `chunk_prefill` positions per
        # tick (0 = whole-prompt prefill at admission)
        self.chunk_prefill = int(chunk_prefill)
        # cap on prompt tokens prefilled per tick across ALL mid-prefill
        # lanes (0 = advance every lane one chunk per tick). The budget is
        # fair-shared over SLO classes — see _advance_chunks — and one
        # chunk always lands per tick so TTFT can never stall outright.
        self.prefill_budget = int(prefill_budget)
        self.prefix_share = bool(prefix_share)
        self.stats = stats
        self.sigma_k = float(sigma_k)
        # keep only the kv_retain most-attended own blocks per lane (plus
        # the tail block being written); 0 = keep everything
        self.kv_retain = int(kv_retain)
        # fault tolerance: per-request deadline in ticks from arrival
        # (0 = none), a duck-typed FaultPlan (serving.faults) whose
        # shrinks/cancels/stalls the engine applies at their ticks, the
        # degradation ladder, the ledger audit mode, and the consecutive
        # transient-executor-fault budget before EngineFault
        self.deadline = int(deadline)
        self.faults = faults
        self.ladder = ladder
        self.audit_mode = audit
        self.max_exec_retries = int(max_exec_retries)
        # per-run state (reset by run()): rid -> resume record after an
        # eviction; prefix key -> {"ready": bool, "writer": rid|None}
        self._resume: Dict[int, Dict] = {}
        self._prefix_state: Dict[object, Dict] = {}
        self._evictions = 0
        self._st: Optional[_RunState] = None

    # -- admission sizing ---------------------------------------------------

    def _own_reservation(self, req: Request, n_shared: int, eff_len: int,
                         chunked: bool, resumed: bool) -> int:
        """Blocks to reserve for a request's OWN (non-shared) footprint.
        Worst mode: everything it can ever write beyond the shared prefix.
        Expected mode: the safety-margined expected footprint, floored at
        what admission allocates immediately (whole-prompt prefill) and
        capped at the worst case. Re-admitted requests reserve worst-case
        — their length is no longer a prediction, and a full reservation
        keeps them from thrashing back out."""
        alloc = self.allocator
        worst_own = max(alloc.blocks_for(req) - n_shared, 0)
        if (alloc.reservation != "expected" or self.stats is None
                or resumed):
            return worst_own
        exp = self.stats.expected_written(len(req.prompt), self.sigma_k)
        exp_own = -(-int(exp) // alloc.block_size) - n_shared
        if self.kv_retain:
            # retention bounds steady-state own blocks at retain+1; the
            # floor below still covers the whole-prompt prefill burst
            # (drops begin only after the first decode tick)
            exp_own = min(exp_own, self.kv_retain + 1)
        now_own = 0 if chunked else (-(-eff_len // alloc.block_size)
                                     - n_shared)
        return max(now_own, min(worst_own, max(exp_own, 0)))

    # -- scheduling core ---------------------------------------------------

    def _admit(self, queue: Deque[Request], slots: List[Optional[_Active]],
               tick: int) -> Tuple[int, int, int]:
        """Claim free slots for queued requests under the active policy.
        Admissions landing in the same tick and prompt bucket share ONE
        padded prefill call (engine-level batched prefill). Returns
        (admissions, prefill calls, prompt tokens prefilled)."""
        if self.policy == "static" and any(s is not None for s in slots):
            return 0, 0, 0                # fixed batch: wait for the pool
        alloc = self.allocator
        # physical blocks this tick's admissions may immediately consume —
        # pre-checked so the admission path can never hit PoolExhausted
        # (only decode/chunk overdrafts evict)
        avail = alloc.available_blocks if alloc is not None else 0
        picked: List[Tuple] = []   # (slot, req, eff_prompt, meta, seed, key)
        for i in range(self.n_slots):
            # a mid-run shrink can leave a queued request that no longer
            # fits the pool at ANY occupancy — cancel it (reason
            # "capacity") instead of deadlocking the FIFO head
            while (queue and alloc is not None and self._st is not None
                    and alloc.blocks_for(queue[0]) > alloc.n_blocks):
                bad = queue.popleft()
                self._cancel_queued(self._st, bad, "capacity")
            if not queue:
                break
            if slots[i] is not None:
                continue
            req = queue[0]
            meta = self._resume.get(req.rid)
            prior = tuple(meta["tokens"]) if meta else ()
            eff = req.prompt + prior
            # shared-prefix plumbing: the first request naming a prefix
            # becomes its WRITER (prefills it into freshly carved blocks);
            # later ones only attach once the prefix KV is real
            key = None
            n_cached = 0          # blocks the prefix cache entry holds
            n_shared = 0          # prefix blocks seeded into THIS table
            writer = False
            if (self.prefix_share and alloc is not None
                    and req.prefix_id is not None
                    and req.prefix_len >= alloc.block_size):
                key = req.prefix_id
                n_cached = req.prefix_len // alloc.block_size
                state = self._prefix_state.get(key)
                if state is not None and alloc.prefix_refs(key) < 0:
                    # reclaimed under pressure while unreferenced
                    del self._prefix_state[key]
                    state = None
                if (state is not None and not state["ready"]
                        and state["writer"] is not None):
                    break         # writer mid-prefill: hold FIFO until real
                writer = state is None or not state["ready"]
                # a sharer never maps a block it would have to write: its
                # private suffix starts in block (eff_len-1)//B at the latest
                n_shared = (n_cached if writer
                            else min(n_cached,
                                     (len(eff) - 1) // alloc.block_size))
                if n_shared < 1 and not writer:
                    key = None    # degenerate: nothing shareable
            chunked = bool(self.chunk_prefill) and (
                len(eff) > self.chunk_prefill
                or (key is not None and not writer))
            seed: List[int] = []
            if alloc is not None:
                own = self._own_reservation(req, n_shared, len(eff),
                                            chunked, bool(meta))
                pfx_cost = (n_cached if key is not None
                            and alloc.prefix_refs(key) <= 0 else 0)
                if not alloc.can_admit(own + pfx_cost):
                    break                 # FIFO: no overtaking the head
                now = 0 if chunked else (-(-len(eff) // alloc.block_size)
                                         - n_shared)
                if key is not None and alloc.prefix_refs(key) < 0:
                    now += n_cached       # prefix blocks carved this tick
                if now > avail:
                    break                 # physically can't land this tick
                if key is not None and alloc.prefix_refs(key) < 0:
                    blocks = alloc.create_prefix(key, n_cached)
                    if blocks is None:
                        break
                    self._prefix_state[key] = {"ready": False,
                                               "writer": req.rid}
                    # stale data in carved blocks must not leak through the
                    # position mask while the writer is still mid-chunk
                    self.executor.fresh_blocks(blocks)
                pfx_blocks: List[int] = []
                if key is not None:
                    pfx_blocks = alloc.acquire_prefix(key)
                    if writer:
                        self._prefix_state[key]["writer"] = req.rid
                        self._prefix_state[key]["ready"] = False
                    seed = pfx_blocks[:n_shared]
                alloc.reserve(req.rid, own)
                avail -= now
            queue.popleft()
            if meta is not None:
                del self._resume[req.rid]
            picked.append((i, req, eff, meta, seed, key, writer, chunked))
        if not picked:
            return 0, 0, 0
        by_len: Dict[int, List[Tuple]] = {}
        for item in picked:
            i, req, eff, meta, seed, key, writer, chunked = item
            if chunked:
                # chunked admission: the lane is claimed now but its prompt
                # (or private suffix, for a prefix sharer) is appended
                # chunk-by-chunk by _advance_chunks (no decode cursor yet).
                # A prefix WRITER prefills from position 0 — it is the one
                # writing the shared prefix KV — so only a SHARER skips the
                # seeded blocks.
                skip = (0 if writer else
                        len(seed) * (self.allocator.block_size
                                     if self.allocator else 0))
                prior = tuple(meta["tokens"]) if meta else ()
                slots[i] = _Active(
                    req=req, admitted=(meta["admitted"] if meta else tick),
                    pos=0, remaining=req.max_new - len(prior), tokens=[],
                    table=list(seed), pending=eff[skip:], prior=prior,
                    prefix_key=key, shared=len(seed),
                    first_token=(meta["first_token"] if meta else -1))
                continue
            by_len.setdefault(len(eff), []).append(item)
        if not by_len:
            return len(picked), 0, 0
        alloc = self.allocator
        calls = tokens = 0
        failed: List[Request] = []     # rolled-back picks, requeued at head
        for plen in sorted(by_len):
            group = by_len[plen]
            tables = None
            if alloc is not None:
                kept, tables = [], []
                for item in group:
                    i, req, eff, meta, seed, key, writer, _ = item
                    nb0 = max(-(-plen // alloc.block_size), 1)
                    tbl = list(seed)
                    try:
                        while len(tbl) < nb0:
                            tbl.append(alloc.alloc(req.rid))
                    except AllocationFault:
                        # transient refusal: unwind THIS pick exactly and
                        # retry it from the queue head next tick
                        if self._st is not None:
                            self._st.alloc_faults += 1
                        self._unadmit(req, meta, key, writer)
                        failed.append(req)
                        continue
                    kept.append(item)
                    tables.append(tbl)
                group = kept
                if not group:
                    continue
            lanes = [item[0] for item in group]
            prompts = [item[2] for item in group]
            try:
                firsts = self.executor.prefill_batch(lanes, prompts,
                                                     tables=tables)
            except TransientExecutorError:
                # raised before the executor mutated anything: unwind the
                # whole group, arm backoff, replay the identical calls later
                for i, req, eff, meta, seed, key, writer, _ in group:
                    self._unadmit(req, meta, key, writer)
                    failed.append(req)
                if self._st is not None:
                    self._exec_fault(self._st)
                continue
            if self._st is not None:
                self._st.exec_fails = 0
            calls += 1
            tokens += plen * len(group)
            for gi, (i, req, eff, meta, seed, key, writer, _) \
                    in enumerate(group):
                prior = tuple(meta["tokens"]) if meta else ()
                ft = (meta["first_token"] if meta
                      and meta["first_token"] >= 0 else tick)
                slots[i] = _Active(
                    req=req, admitted=(meta["admitted"] if meta else tick),
                    pos=plen, remaining=req.max_new - len(prior) - 1,
                    tokens=list(prior) + [int(firsts[gi])],
                    table=(tables[gi] if tables is not None else []),
                    prior=prior, prefix_key=key, shared=len(seed),
                    first_token=ft)
                if key is not None and writer:
                    # whole-prompt prefill wrote the prefix blocks in full
                    self._prefix_state[key]["ready"] = True
        for req in reversed(failed):
            queue.appendleft(req)
        return len(picked) - len(failed), calls, tokens

    # -- fault handling -----------------------------------------------------

    def _unadmit(self, req: Request, meta: Optional[Dict], key,
                 writer: bool) -> None:
        """Unwind one `_admit` pick (transient fault mid-admission): drop
        the reservation and any blocks it already took, release the prefix
        reference, restore the resume record — exactly as if the pick
        never happened. The caller requeues the request at the head."""
        alloc = self.allocator
        if alloc is not None:
            alloc.free(req.rid)
            if key is not None:
                alloc.release_prefix(key, missing_ok=True)
                stp = self._prefix_state.get(key)
                if (writer and stp is not None
                        and stp["writer"] == req.rid and not stp["ready"]):
                    stp["writer"] = None
        if meta is not None:
            self._resume[req.rid] = meta

    def _exec_fault(self, st: _RunState) -> None:
        """One executor call failed transiently. Arm exponential backoff —
        the engine skips ALL executor work for 2^(k-1) ticks (capped at
        32) after the k-th consecutive fault — and give up with
        `EngineFault` past `max_exec_retries` consecutive failures. Any
        success resets the streak."""
        st.exec_faults += 1
        st.exec_fails += 1
        if st.exec_fails > self.max_exec_retries:
            raise EngineFault(
                f"{st.exec_fails} consecutive transient executor faults "
                f"(max_exec_retries={self.max_exec_retries})")
        st.exec_wait = min(2 ** (st.exec_fails - 1), 32)

    def _cancel_queued(self, st: _RunState, req: Request,
                       reason: str) -> None:
        """Cancel a request that holds no lane (queued, shed at arrival,
        or evicted-and-requeued — its resume record is dropped too)."""
        meta = self._resume.pop(req.rid, None)
        toks = tuple(meta["tokens"]) if meta else ()
        st.cancellations.append(Cancellation(
            rid=req.rid, tick=st.tick, reason=reason,
            arrival=req.arrival, tokens=toks))

    def _cancel_lane(self, st: _RunState, i: int, reason: str) -> None:
        """Cancel the request on lane `i` cleanly: blocks freed, prefix
        reference released (idempotently — the prefix may already be
        reclaimed), writer handoff if it was mid-prefix-prefill."""
        a = st.slots[i]
        alloc = self.allocator
        if alloc is not None:
            alloc.free(a.req.rid)
            if a.prefix_key is not None:
                alloc.release_prefix(a.prefix_key, missing_ok=True)
                stp = self._prefix_state.get(a.prefix_key)
                if (stp is not None and stp["writer"] == a.req.rid
                        and not stp["ready"]):
                    stp["writer"] = None
        emitted = tuple(a.tokens) if a.tokens else tuple(a.prior)
        st.cancellations.append(Cancellation(
            rid=a.req.rid, tick=st.tick, reason=reason,
            arrival=a.req.arrival, tokens=emitted))
        st.slots[i] = None

    def _cancel_rid(self, st: _RunState, rid: int, reason: str) -> bool:
        """Cancel a request wherever it currently lives (lane, queue, or
        not-yet-arrived). False if already finished/cancelled/unknown."""
        for i in range(self.n_slots):
            a = st.slots[i]
            if a is not None and a.req.rid == rid:
                self._cancel_lane(st, i, reason)
                return True
        for q in (st.queue, st.pending):
            for req in q:
                if req.rid == rid:
                    q.remove(req)
                    self._cancel_queued(st, req, reason)
                    return True
        return False

    def _sweep_deadlines(self, st: _RunState) -> None:
        """Cancel every request whose per-request deadline (ticks since
        arrival) has expired, wherever it lives."""
        for i in range(self.n_slots):
            a = st.slots[i]
            if a is not None and st.tick - a.req.arrival >= self.deadline:
                self._cancel_lane(st, i, "deadline")
        expired = [r for r in st.queue
                   if st.tick - r.arrival >= self.deadline]
        for r in expired:
            st.queue.remove(r)
            self._cancel_queued(st, r, "deadline")

    # -- degradation ladder -------------------------------------------------

    def _ladder_update(self, st: _RunState) -> None:
        """Escalate/de-escalate the rung on sustained pool pressure
        (committed >= high * pool for `patience` ticks either way)."""
        lad = self.ladder
        alloc = self.allocator
        if lad is None or alloc is None:
            return
        pressured = alloc.committed >= lad.high * alloc.n_blocks
        if pressured:
            st.hot += 1
            st.cool = 0
            if st.hot >= lad.patience and st.rung < lad.max_rung:
                st.hot = 0
                st.rung += 1
                st.max_rung = max(st.max_rung, st.rung)
                st.ladder_events.append({
                    "tick": st.tick, "rung": st.rung,
                    "name": RUNG_NAMES[st.rung], "cause": "pressure",
                    "committed": alloc.committed, "pool": alloc.n_blocks})
        else:
            st.cool += 1
            st.hot = 0
            if st.cool >= lad.patience and st.rung > 0:
                st.cool = 0
                st.rung -= 1
                st.ladder_events.append({
                    "tick": st.tick, "rung": st.rung,
                    "name": RUNG_NAMES[st.rung], "cause": "recovered",
                    "committed": alloc.committed, "pool": alloc.n_blocks})
        if st.rung:
            st.rung_ticks[st.rung] = st.rung_ticks.get(st.rung, 0) + 1

    def _eff_retain(self, st: Optional[_RunState]) -> int:
        """The retention cap in force: the configured `kv_retain`, or the
        ladder's `bend_retain` once rung 2 is engaged AND its agreement
        prior clears the `min_agreement` gate (quality is only ever traded
        inside the gate the planner enforces)."""
        if self.kv_retain:
            return self.kv_retain
        lad = self.ladder
        if (lad is not None and st is not None
                and st.rung >= RUNG_KV_BEND and lad.bend_retain > 0
                and lad.bend_agreement >= lad.min_agreement):
            return lad.bend_retain
        return 0

    def _eff_budget(self, st: Optional[_RunState]) -> int:
        """The prefill token budget in force: halved (floored at one chunk
        / `prefill_floor`) once rung 1 is engaged. An unbudgeted engine
        under rung 1 gets 4 chunks halved to 2 — TTFT degrades before
        decode goodput does."""
        lad = self.ladder
        if (lad is None or st is None or st.rung < RUNG_TIGHTEN_PREFILL
                or not self.chunk_prefill):
            return self.prefill_budget
        base = self.prefill_budget or 4 * self.chunk_prefill
        floor = max(self.chunk_prefill, lad.prefill_floor)
        return max(floor, base // 2)

    def _audit(self, st: _RunState) -> None:
        """The every-tick ledger audit: "strict" fails fast (tests),
        "count" degrades to a `ServeReport.audit_failures` counter
        (production), "off" skips entirely."""
        if self.audit_mode == "off" or self.allocator is None:
            return
        st.audits += 1
        problems = self.allocator.audit()
        if problems:
            st.audit_failures += 1
            if self.audit_mode == "strict":
                raise LedgerCorruption(
                    f"tick {st.tick}: " + "; ".join(problems))

    def _retain(self, a: _Active, mass: Optional[Sequence[float]],
                retain: int) -> int:
        """Enforce the retention cap on one lane: keep the `retain`
        most-attended OWN blocks plus the tail block being written, free
        the rest back to the allocator (their table entries go -1 =
        unassigned, so decode masks them — H2O-style block dropping).
        Shared prefix blocks (leading `a.shared` entries) are untouchable:
        the allocator doesn't own-list them and other lanes read through
        them. Ranking: lowest attention mass first, ties oldest-first
        (lowest logical index) — with no mass signal everything ties, so
        the policy degenerates to drop-oldest."""
        alloc = self.allocator
        tail = max(a.pos - 1, 0) // alloc.block_size
        live = [j for j in range(len(a.table))
                if a.table[j] >= 0 and j >= a.shared and j != tail]
        if len(live) <= retain:
            return 0

        def key(j):
            m = (float(mass[j]) if mass is not None and j < len(mass)
                 else 0.0)
            return (m, j)

        drop = sorted(live, key=key)[:len(live) - retain]
        for j in drop:
            alloc.free_block(a.req.rid, a.table[j])
            a.table[j] = -1
        return len(drop)

    def _pick_victim(self, slots: List[Optional[_Active]]) -> int:
        """The lane to evict under pool pressure: loosest SLO class first
        (highest `Request.slo`), then least progress (fewest tokens
        emitted — the cheapest re-prefill), then most recently admitted,
        then highest rid. Deterministic."""
        occ = [i for i in range(self.n_slots) if slots[i] is not None]
        if not occ:
            raise RuntimeError("pool exhausted with no lane to evict "
                               "(allocator invariant broken)")

        def key(i):
            a = slots[i]
            progress = len(a.tokens) if a.tokens else len(a.prior)
            return (-a.req.slo, progress, -a.admitted, -a.req.rid)
        return min(occ, key=key)

    def _evict(self, slots: List[Optional[_Active]], i: int,
               queue: Deque[Request]) -> None:
        """Free lane `i`'s own blocks (shared prefix blocks only lose a
        reference), remember its emitted tokens, and requeue it at the
        queue head for chunked re-prefill of prompt + emitted — greedy
        decode is deterministic, so the replay emits the same stream."""
        a = slots[i]
        alloc = self.allocator
        alloc.free(a.req.rid)
        if a.prefix_key is not None:
            alloc.release_prefix(a.prefix_key)
            st = self._prefix_state.get(a.prefix_key)
            if (st is not None and st["writer"] == a.req.rid
                    and not st["ready"]):
                st["writer"] = None      # next matching request re-writes
        emitted = list(a.tokens) if a.tokens else list(a.prior)
        self._resume[a.req.rid] = {"tokens": emitted, "admitted": a.admitted,
                                   "first_token": a.first_token}
        queue.appendleft(a.req)
        slots[i] = None
        self._evictions += 1

    def _alloc_through(self, slots: List[Optional[_Active]], i: int,
                       last_block: int, queue: Deque[Request],
                       fresh: List[int]) -> int:
        """Grow lane `i`'s table until it covers logical block
        `last_block`, evicting on pool exhaustion. Returns 1 on success,
        0 if lane `i` evicted ITSELF (the caller must drop it this tick),
        -1 if a transient `AllocationFault` DEFERRED the lane to the next
        tick (its table is left short; nothing was lost — compare against
        these constants, not truthiness)."""
        a = slots[i]
        alloc = self.allocator
        while last_block >= len(a.table):
            try:
                bid = alloc.alloc(a.req.rid)
            except AllocationFault:
                if self._st is not None:
                    self._st.alloc_faults += 1
                return -1
            except PoolExhausted:
                v = self._pick_victim(slots)
                self._evict(slots, v, queue)
                if v == i:
                    return 0
                continue
            a.table.append(bid)
            fresh.append(bid)
        return 1

    def _schedule_chunks(self, slots: List[Optional[_Active]],
                         lanes: List[int], budget: int) -> List[int]:
        """Pick which mid-prefill lanes advance this tick under the token
        budget (the configured `prefill_budget`, or the ladder-tightened
        one). No budget: all of them. With one: interleave chunks
        round-robin over SLO classes (tightest class leads each round,
        FIFO by admission within a class) and grant whole chunks in that
        order until the budget is spent — the first grant is unconditional
        so a budget below the chunk size still makes progress."""
        if not budget:
            return lanes
        by_class: Dict[int, List[int]] = {}
        for i in lanes:
            by_class.setdefault(slots[i].req.slo, []).append(i)
        classes = sorted(by_class)
        rr = {c: collections.deque(
                 sorted(by_class[c],
                        key=lambda i: (slots[i].admitted, slots[i].req.rid)))
              for c in classes}
        order: List[int] = []
        while any(rr[c] for c in classes):
            for c in classes:
                if rr[c]:
                    order.append(rr[c].popleft())
        picked: List[int] = []
        spent = 0
        for i in order:
            cost = min(len(slots[i].pending), self.chunk_prefill)
            if picked and spent + cost > budget:
                break
            picked.append(i)
            spent += cost
        return sorted(picked)

    def _advance_chunks(self, slots: List[Optional[_Active]],
                        queue: Deque[Request]) -> Tuple[int, int]:
        """Advance mid-prefill lanes by one prompt chunk each in ONE
        batched call (blocks allocated lazily per chunk, freshly re-linked
        ones invalidated first) — every pending lane, or the
        `prefill_budget`-token fair share picked by _schedule_chunks. A
        lane whose final chunk lands gets its first token and decode
        cursor. Returns (chunk calls made (0/1), chunk tokens issued)."""
        stalled = self._st.stalled if self._st is not None else {}
        lanes = [i for i in range(self.n_slots)
                 if slots[i] is not None and slots[i].pending
                 and stalled.get(i, 0) <= 0]
        if not lanes:
            return 0, 0
        lanes = self._schedule_chunks(slots, lanes,
                                      self._eff_budget(self._st))
        alloc = self.allocator
        chunks, starts, tables, final, live = [], [], [], [], []
        fresh: List[int] = []
        for i in lanes:
            a = slots[i]
            if a is None or not a.pending:
                continue                 # evicted by an earlier lane's
                                         # pool pressure this same tick
            eff_len = len(a.req.prompt) + len(a.prior)
            start = eff_len - len(a.pending)
            c = a.pending[:self.chunk_prefill]
            if alloc is not None:
                last = start + len(c) - 1
                if self._alloc_through(slots, i, last // alloc.block_size,
                                       queue, fresh) != 1:
                    continue             # evicted itself (0) or deferred
                                         # by a transient fault (-1):
                                         # chunk not issued this tick
            a.pending = a.pending[self.chunk_prefill:]
            live.append(i)
            chunks.append(c)
            starts.append(start)
            tables.append(list(a.table))
            final.append(not a.pending)
        if not live:
            return 0, 0
        if fresh:
            self.executor.fresh_blocks(fresh)
        try:
            firsts = self.executor.prefill_chunks(
                live, chunks, starts,
                tables=(tables if alloc is not None else None), final=final)
        except TransientExecutorError:
            # raised before the executor consumed the chunks: push them
            # back onto their lanes and arm backoff — the identical call
            # replays after the wait (blocks already grown stay grown)
            for j, i in enumerate(live):
                a = slots[i]
                a.pending = tuple(chunks[j]) + tuple(a.pending)
            if self._st is not None:
                self._exec_fault(self._st)
            return 0, 0
        if self._st is not None:
            self._st.exec_fails = 0
        for j, i in enumerate(live):
            a = slots[i]
            if final[j]:
                a.tokens = list(a.prior) + [int(firsts[j])]
                a.pos = len(a.req.prompt) + len(a.prior)
                a.remaining = a.req.max_new - len(a.prior) - 1
                if a.prefix_key is not None:
                    st = self._prefix_state.get(a.prefix_key)
                    if st is not None and st["writer"] == a.req.rid:
                        st["ready"] = True   # prefix KV fully written
        return 1, sum(len(c) for c in chunks)

    def run(self, trace: Sequence[Request], max_ticks: int = 1_000_000,
            stop_tick: Optional[int] = None) -> ServeReport:
        """Replay `trace` to completion. `stop_tick` suspends the run at
        that tick instead (the partial report is returned and the state
        stays live for `snapshot()`)."""
        for r in trace:                      # fail fast, not at max_ticks
            if r.max_new < 1 or not r.prompt:
                raise ValueError(f"request {r.rid}: needs a non-empty "
                                 f"prompt and max_new >= 1 (got "
                                 f"prompt_len={len(r.prompt)}, "
                                 f"max_new={r.max_new})")
            if (self.allocator is not None
                    and self.allocator.blocks_for(r) > self.allocator.n_blocks):
                raise ValueError(
                    f"request {r.rid} needs {self.allocator.blocks_for(r)} "
                    f"KV blocks but the pool holds "
                    f"{self.allocator.n_blocks} — it could never be "
                    "admitted (raise the budget or shrink the context)")
        st = self._start(trace)
        return self._loop(st, max_ticks, stop_tick)

    def _start(self, trace: Sequence[Request]) -> _RunState:
        pending: Deque[Request] = collections.deque(
            sorted(trace, key=lambda r: (r.arrival, r.rid)))
        st = _RunState(pending=pending, queue=collections.deque(),
                       slots=[None] * self.n_slots, completions=[],
                       cancellations=[])
        self._resume = {}
        self._prefix_state = {}
        self._evictions = 0
        self._st = st
        return st

    def _loop(self, st: _RunState, max_ticks: int,
              stop_tick: Optional[int]) -> ServeReport:
        while st.pending or st.queue or any(s is not None
                                            for s in st.slots):
            if stop_tick is not None and st.tick >= stop_tick:
                break
            if st.tick >= max_ticks:
                raise RuntimeError(f"engine exceeded max_ticks={max_ticks}")
            self._step(st)
        return self._report(st)

    def _finish(self, st: _RunState, i: int, when: int) -> None:
        a = st.slots[i]
        ft = a.first_token if a.first_token >= 0 else when
        st.completions.append(Completion(
            rid=a.req.rid, tokens=tuple(a.tokens),
            arrival=a.req.arrival, admitted=a.admitted, finished=when,
            first_token=ft))
        alloc = self.allocator
        if alloc is not None:
            alloc.free(a.req.rid)
            if a.prefix_key is not None:
                alloc.release_prefix(a.prefix_key)
        st.slots[i] = None
        if self.stats is not None and hasattr(self.stats, "observe"):
            # observed completion lengths feed the optimistic-admission
            # stats online — the next reservation's E[blocks] + k·sigma
            # tracks the live workload, not just the profiled trace
            self.stats.observe(len(a.req.prompt),
                               len(a.req.prompt) + a.req.max_new - 1)

    def _step(self, st: _RunState) -> None:
        """One engine tick: fault-plan events → deadline sweep → arrivals
        (shed under rung 4) → ladder update → proactive eviction →
        admission / prefill chunks / batched decode (all executor work
        skipped while retry backoff is armed) → retention → audit."""
        alloc = self.allocator
        ev0 = self._evictions
        canc0 = len(st.cancellations)
        af0 = st.alloc_faults
        event = False
        fp = self.faults
        if fp is not None:
            for t, frac in (getattr(fp, "shrinks", ()) or ()):
                if t == st.tick and alloc is not None:
                    n = min(int(frac * alloc.n_blocks), alloc.n_blocks - 1)
                    if n > 0:
                        alloc.shrink(n)
                        st.shrunk += n
                        event = True
            for t, rid in (getattr(fp, "cancels", ()) or ()):
                if t == st.tick and self._cancel_rid(st, rid, "chaos"):
                    event = True
            for t, lane, dur in (getattr(fp, "stalls", ()) or ()):
                if t == st.tick and 0 <= lane < self.n_slots and dur > 0:
                    st.stalled[lane] = max(st.stalled.get(lane, 0), dur)
                    event = True
        if self.deadline:
            self._sweep_deadlines(st)
        while st.pending and st.pending[0].arrival <= st.tick:
            req = st.pending.popleft()
            if st.rung >= RUNG_SHED:
                st.shed += 1
                self._cancel_queued(st, req, "shed")
            else:
                st.queue.append(req)
        self._ladder_update(st)
        if (self.ladder is not None and st.rung >= RUNG_EVICT
                and alloc is not None
                and alloc.committed > alloc.n_blocks):
            # rung 3: commitments overhang the (shrunken) pool — evict one
            # victim per tick proactively instead of waiting for the free
            # list to run dry mid-decode
            occ = sum(s is not None for s in st.slots)
            if occ >= 2:         # never thrash the only lane in and out
                self._evict(st.slots, self._pick_victim(st.slots),
                            st.queue)
        admitted = chunked = 0
        decoded = False
        waiting = st.exec_wait > 0
        if waiting:
            st.exec_wait -= 1
            st.backoff_ticks += 1
            st.peak_queue = max(st.peak_queue, len(st.queue))
        else:
            admitted, calls, ptoks = self._admit(st.queue, st.slots,
                                                 st.tick)
            st.prefills += admitted
            st.prefill_calls += calls
            st.prefill_tokens += ptoks
            if self.chunk_prefill and not st.exec_wait:
                chunked, ctoks = self._advance_chunks(st.slots, st.queue)
                st.chunk_calls += chunked
                st.prefill_tokens += ctoks
            st.peak_queue = max(st.peak_queue, len(st.queue))
            st.max_concurrent = max(st.max_concurrent,
                                    sum(s is not None for s in st.slots))
            # single-token requests complete at admission (prefill emitted
            # their only token)
            for i in range(self.n_slots):
                if (st.slots[i] is not None and not st.slots[i].pending
                        and st.slots[i].remaining == 0):
                    self._finish(st, i, st.tick)
            # mid-prefill lanes hold a slot but have no decode cursor yet;
            # stalled lanes sit out the tick (their streams just pause)
            active = [i for i in range(self.n_slots)
                      if st.slots[i] is not None
                      and not st.slots[i].pending
                      and st.stalled.get(i, 0) <= 0]
            if st.exec_wait:     # a fault mid-tick armed backoff
                active = []
            if alloc is not None and active:
                # allocate-on-decode-tick: a lane crossing into a new
                # logical block gets a physical block from the free list
                # (its reservation guarantees one in worst mode; expected
                # mode overdrafts and EVICTS on a dry pool) — freshly
                # re-linked blocks are invalidated first so a previous
                # owner's positions can't leak through the mask
                fresh: List[int] = []
                kept: List[int] = []
                for i in active:
                    a = st.slots[i]
                    if a is None or st.slots[i] is not a:
                        continue         # evicted earlier this tick
                    if self._alloc_through(st.slots, i,
                                           a.pos // alloc.block_size,
                                           st.queue, fresh) == 1:
                        kept.append(i)
                if fresh:
                    self.executor.fresh_blocks(fresh)
                active = [i for i in kept if st.slots[i] is not None]
            if active:
                tokens = [st.slots[i].tokens[-1]
                          if st.slots[i] is not None and st.slots[i].tokens
                          else 0 for i in range(self.n_slots)]
                positions = [st.slots[i].pos if st.slots[i] is not None
                             else 0 for i in range(self.n_slots)]
                nxt = None
                try:
                    if alloc is not None:
                        tables = [st.slots[i].table
                                  if st.slots[i] is not None else []
                                  for i in range(self.n_slots)]
                        nxt = self.executor.decode(tokens, positions,
                                                   tables=tables,
                                                   lanes=active)
                    else:
                        nxt = self.executor.decode(tokens, positions,
                                                   lanes=active)
                except TransientExecutorError:
                    self._exec_fault(st)  # nothing mutated: replay later
                if nxt is not None:
                    st.exec_fails = 0
                    decoded = True
                    st.decode_ticks += 1
                    st.useful += len(active)
                    width_fn = getattr(self.executor, "decode_width",
                                       None)
                    width = width_fn(len(active)) if width_fn else None
                    st.lane_tokens += (width if width is not None
                                       else self.n_slots)
                    for i in active:
                        a = st.slots[i]
                        if a.first_token < 0:
                            a.first_token = st.tick
                        a.tokens.append(int(nxt[i]))
                        a.pos += 1
                        a.remaining -= 1
                        if a.remaining == 0:
                            self._finish(st, i, st.tick)
                    retain = self._eff_retain(st)
                    if alloc is not None and retain:
                        mass_fn = getattr(self.executor, "block_masses",
                                          None)
                        masses = mass_fn() if mass_fn is not None else {}
                        for i in active:
                            if st.slots[i] is not None:
                                st.block_drops += self._retain(
                                    st.slots[i], masses.get(i), retain)
        if decoded:
            pass
        elif (waiting or event or admitted or chunked
                or self._evictions > ev0 or len(st.cancellations) > canc0
                or st.alloc_faults > af0 or st.exec_wait > 0
                or st.stalled):
            # admissions / chunks / evictions / cancellations / fault
            # events / backoff waits did real work this tick even though
            # no decode ran — the taxonomy invariant is
            # ticks == decode + admit + idle
            st.admit_only += 1
        else:
            st.idle += 1         # pure waiting on arrivals
        for i in list(st.stalled):
            st.stalled[i] -= 1
            if st.stalled[i] <= 0:
                del st.stalled[i]
        # first tokens emitted by prefill this tick
        for i in range(self.n_slots):
            a = st.slots[i]
            if a is not None and a.tokens and a.first_token < 0:
                a.first_token = st.tick
        self._audit(st)
        st.tick += 1

    def _report(self, st: _RunState) -> ServeReport:
        alloc = self.allocator
        st.completions.sort(key=lambda c: c.rid)
        degradation: Dict = {}
        if self.ladder is not None:
            degradation = {
                "max_rung": st.max_rung,
                "max_rung_name": RUNG_NAMES.get(st.max_rung, "?"),
                "final_rung": st.rung,
                "rung_ticks": {RUNG_NAMES[k]: v
                               for k, v in sorted(st.rung_ticks.items())},
                "events": list(st.ladder_events)}
        observed: Dict = {}
        if self.stats is not None and hasattr(self.stats, "summary"):
            observed = self.stats.summary()
        return ServeReport(
            policy=self.policy, n_slots=self.n_slots,
            completions=list(st.completions), ticks=st.tick,
            decode_ticks=st.decode_ticks, useful_slot_tokens=st.useful,
            idle_ticks=st.idle, peak_queue=st.peak_queue,
            max_concurrent=st.max_concurrent, prefills=st.prefills,
            prefill_calls=st.prefill_calls,
            n_blocks=(alloc.n_blocks if alloc else 0),
            peak_blocks=(alloc.peak_in_use if alloc else 0),
            admit_ticks=st.admit_only, decode_lane_tokens=st.lane_tokens,
            chunk_calls=st.chunk_calls, evictions=self._evictions,
            block_drops=st.block_drops, prefill_tokens=st.prefill_tokens,
            cancellations=sorted(st.cancellations, key=lambda c: c.rid),
            shed=st.shed, exec_faults=st.exec_faults,
            backoff_ticks=st.backoff_ticks, alloc_faults=st.alloc_faults,
            shrunk_blocks=st.shrunk, audits=st.audits,
            audit_failures=st.audit_failures, degradation=degradation,
            observed_lengths=observed)

    # -- snapshot / restore -------------------------------------------------

    def snapshot(self) -> EngineSnapshot:
        """Serialize a suspended run (`run(..., stop_tick=...)`) so a
        FRESH engine — new allocator, new executor, even a different lane
        count — can `resume` it token-identically. In-flight lanes become
        resume records (request + emitted tokens) that re-enter through
        the eviction re-prefill path: the physical pool is
        re-materialized on restore, never serialized."""
        st = self._st
        if st is None:
            raise RuntimeError("no run to snapshot — suspend one first "
                               "with run(trace, stop_tick=...)")
        reqs: Dict[int, Request] = {}
        for r in list(st.pending) + list(st.queue):
            reqs[r.rid] = r
        lanes: List[Optional[Dict]] = []
        for a in st.slots:
            if a is None:
                lanes.append(None)
                continue
            reqs[a.req.rid] = a.req
            emitted = list(a.tokens) if a.tokens else list(a.prior)
            lanes.append({"rid": a.req.rid, "tokens": emitted,
                          "admitted": a.admitted,
                          "first_token": a.first_token})
        resume = {int(rid): {"tokens": list(m["tokens"]),
                             "admitted": m["admitted"],
                             "first_token": m["first_token"]}
                  for rid, m in self._resume.items()}
        ladder = None
        if self.ladder is not None:
            ladder = {"rung": st.rung, "max_rung": st.max_rung,
                      "hot": st.hot, "cool": st.cool,
                      "events": list(st.ladder_events),
                      "rung_ticks": dict(st.rung_ticks)}
        stats_state = None
        if self.stats is not None and hasattr(self.stats, "state_dict"):
            stats_state = self.stats.state_dict()
        return EngineSnapshot(
            tick=st.tick,
            requests=[dataclasses.asdict(reqs[k]) for k in sorted(reqs)],
            pending=[r.rid for r in st.pending],
            queue=[r.rid for r in st.queue],
            lanes=lanes,
            resume=resume,
            completions=[dataclasses.asdict(c) for c in st.completions],
            cancellations=[dataclasses.asdict(c)
                           for c in st.cancellations],
            counters={f: getattr(st, f) for f in _COUNTER_FIELDS},
            evictions=self._evictions,
            ladder=ladder,
            stats=stats_state,
            config={"n_slots": self.n_slots, "policy": self.policy,
                    "chunk_prefill": self.chunk_prefill})

    def resume(self, snap: EngineSnapshot, max_ticks: int = 1_000_000,
               stop_tick: Optional[int] = None) -> ServeReport:
        """Restore a snapshot onto THIS engine (built with a FRESH
        allocator/executor) and run it to completion (or `stop_tick`).
        Snapshot lanes re-enter via re-prefill of prompt + emitted
        tokens, in slot order, ahead of the snapshot queue —
        suffix-consistent executors make the continuation token-identical
        to the uninterrupted run. Requests that no longer fit a smaller
        restore pool are cancelled (reason "capacity"), not deadlocked."""
        alloc = self.allocator
        if alloc is not None and (alloc.in_use or alloc._reserved):
            raise ValueError("resume needs a FRESH allocator: the "
                             "snapshot re-materializes every lane's "
                             "blocks via re-prefill")
        by_rid = {d["rid"]: Request(**{**d, "prompt": tuple(d["prompt"])})
                  for d in snap.requests}
        st = _RunState(
            pending=collections.deque(by_rid[r] for r in snap.pending),
            queue=collections.deque(),
            slots=[None] * self.n_slots,
            completions=[Completion(**{**d, "tokens": tuple(d["tokens"])})
                         for d in snap.completions],
            cancellations=[Cancellation(
                **{**d, "tokens": tuple(d["tokens"])})
                for d in snap.cancellations])
        st.tick = int(snap.tick)
        for f in _COUNTER_FIELDS:
            setattr(st, f, snap.counters.get(f, 0))
        self._resume = {int(rid): {"tokens": list(m["tokens"]),
                                   "admitted": m["admitted"],
                                   "first_token": m["first_token"]}
                        for rid, m in snap.resume.items()}
        self._prefix_state = {}
        self._evictions = int(snap.evictions)
        for rec in snap.lanes:
            if rec is None:
                continue
            self._resume[rec["rid"]] = {
                "tokens": list(rec["tokens"]),
                "admitted": rec["admitted"],
                "first_token": rec["first_token"]}
            st.queue.append(by_rid[rec["rid"]])
        for rid in snap.queue:
            st.queue.append(by_rid[rid])
        if snap.ladder and self.ladder is not None:
            st.rung = snap.ladder.get("rung", 0)
            st.max_rung = snap.ladder.get("max_rung", st.rung)
            st.hot = snap.ladder.get("hot", 0)
            st.cool = snap.ladder.get("cool", 0)
            st.ladder_events = list(snap.ladder.get("events", []))
            st.rung_ticks = {
                int(k): v for k, v in
                (snap.ladder.get("rung_ticks") or {}).items()}
        if (snap.stats and self.stats is not None
                and hasattr(self.stats, "load_state")):
            self.stats.load_state(snap.stats)
        self._st = st
        return self._loop(st, max_ticks, stop_tick)
