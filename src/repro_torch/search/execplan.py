"""Execution plans: the bridge from a SearchResult to something you RUN.

The paper's point (§III-E) is that the *predicted* memory requirement drives
the *actual* deployment configuration — Crispy (Will et al., 2022) showed
memory models only pay off when they emit runnable allocations. Before this
module the search subsystem could plan a pipe-axis mesh no driver could
execute; an `ExecutionPlan` closes that loop:

  plan       — the WSMC memory plan (remat x microbatches x optimizer x kv)
  mesh_axes  — the planned mesh as {axis: size}, a search OUTPUT
  ep         — the resolved expert-parallel mode (strategy-level knob)
  schedule   — the runtime schedule kind (single | scan | pipeline_1f1b)

`build(world)` turns it into the (mesh, sharding.Strategy) pair a trainer
runs: on one device there is no mesh (None); a mesh of more devices is a
`launch.mesh.Mesh` over the live process group. `plan_execution` is the
one-call `--mesh auto` entry: search a runnable mesh_space, promote the
winner.

`plan_serving` and `auto_plan` keep the reference package's default
`hw=HW.TPU_V5E`, so that a call without `hw` plans exactly what the
reference plans; the port's serve and train CLIs pass `hw=HW.H100`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch import hw as HW
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import measure as MM
from repro_torch.core.classifier import Classification
from repro_torch.core.predictor import MemoryPlan
from repro_torch.runtime.schedule_kinds import (SCHEDULE_PIPELINE, SCHEDULE_SCAN,  # noqa: F401 — re-exported schedule vocabulary
                                          SCHEDULE_SINGLE, SCHEDULES,
                                          schedule_kind)
from repro_torch.search import space as SP
from repro_torch.search import strategies as ST
from repro_torch.search.strategies import SearchResult


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A runnable deployment configuration: memory plan + planned mesh +
    sharding mode + runtime schedule. The thing `--mesh auto` executes."""
    plan: MemoryPlan = MemoryPlan()
    mesh_axes: Tuple[Tuple[str, int], ...] = (("data", 1),)
    ep: bool = False
    schedule: str = SCHEDULE_SINGLE
    policy: str = ""                 # which search policy emitted it

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return dict(self.mesh_axes)

    @property
    def n_devices(self) -> int:
        n = 1
        for _, size in self.mesh_axes:
            n *= int(size)
        return n

    @property
    def pipe(self) -> int:
        return int(self.mesh_shape.get("pipe", 1))

    def describe(self) -> str:
        p = self.plan
        mesh = "x".join(f"{a}:{n}" for a, n in self.mesh_axes)
        return (f"mesh={mesh} schedule={self.schedule} remat={p.remat} "
                f"micro={p.microbatches} opt={p.optimizer} kv={p.kv_shard} "
                f"ep={self.ep}"
                + (f" policy={self.policy}" if self.policy else ""))

    def strategy(self):
        """The matching sharding.Strategy (imported lazily)."""
        from repro_torch.parallel import sharding as S
        return S.Strategy(kv_shard=self.plan.kv_shard, ep=self.ep,
                          pipeline=self.pipe > 1)

    def build(self, world: Optional[int] = None):
        """The planned mesh over the first n_devices ranks of the world
        (default: the live process group's size) and the matching
        sharding Strategy: (None, strategy) on one device, which runs
        unsharded. Raises ValueError when the plan needs more ranks than
        the world has (launch.mesh, imported here: search/* loads without
        torch)."""
        if self.n_devices == 1:
            return None, self.strategy()
        from repro_torch.launch.mesh import build_mesh
        return build_mesh(self.mesh_shape, world), self.strategy()


def from_search_result(cfg: ModelConfig, shape: ShapeConfig,
                       res: SearchResult,
                       mesh_shape: Optional[Mapping[str, int]] = None
                       ) -> ExecutionPlan:
    """Promote a SearchResult to an ExecutionPlan. `mesh_shape` is the
    fallback for results from fixed-mesh spaces whose candidates carry no
    mesh of their own."""
    ms = dict(res.mesh_shape or mesh_shape or {"data": 1})
    ep = ST.resolved_ep(cfg, res.candidate, ms)
    sched = schedule_kind(shape.kind, res.plan.microbatches,
                          int(ms.get("pipe", 1)))
    return ExecutionPlan(plan=res.plan,
                         mesh_axes=tuple(sorted(ms.items())),
                         ep=ep, schedule=sched, policy=res.policy)


def for_mesh(cfg: ModelConfig, shape: ShapeConfig, plan: MemoryPlan,
             mesh_shape: Mapping[str, int],
             policy: str = "") -> ExecutionPlan:
    """Promote a plan onto a FIXED mesh (forced CLI spec, legacy host
    mesh): EP by the default divisibility rule, schedule from the plan +
    pipe axis. The single promotion path the drivers share."""
    ms = dict(mesh_shape)
    ep = ST.resolved_ep(cfg, SP.Candidate(plan=plan), ms)
    sched = schedule_kind(shape.kind, plan.microbatches,
                          int(ms.get("pipe", 1)))
    return ExecutionPlan(plan=plan, mesh_axes=tuple(sorted(ms.items())),
                         ep=ep, schedule=sched, policy=policy)


def host_execution(cfg: ModelConfig, shape: ShapeConfig, plan: MemoryPlan,
                   n_devices: int, model_parallel: int = 1,
                   policy: str = "host") -> ExecutionPlan:
    """The legacy (data, model) host mesh as an ExecutionPlan (what
    `host_mesh_for` used to build): best-effort model axis over the
    surviving device count."""
    model = max(1, model_parallel)
    while n_devices % model:
        model -= 1
    return for_mesh(cfg, shape, plan,
                    {"data": n_devices // model, "model": model},
                    policy=policy)


def _axis_values(n_devices: int, cap: Optional[int] = None) -> Tuple[int, ...]:
    """1, 2, 4, ... up to n_devices (plus n_devices itself for non-powers)."""
    limit = min(n_devices, cap) if cap else n_devices
    vals = []
    v = 1
    while v <= limit:
        vals.append(v)
        v *= 2
    if limit not in vals:
        vals.append(limit)
    return tuple(vals)


def auto_mesh_space(cfg: ModelConfig, shape: ShapeConfig,
                    n_devices: int) -> SP.ConfigSpace:
    """The `--mesh auto` search space: every mesh axis searchable within the
    host's device budget, pipe candidates restricted to what the 1F1B
    runtime executes (executable=True)."""
    return SP.mesh_space(cfg, shape, max_devices=n_devices,
                         data=_axis_values(n_devices),
                         model=_axis_values(n_devices),
                         pipe=_axis_values(n_devices, cap=4),
                         executable=True)


def auto_plan(cfg: ModelConfig, shape: ShapeConfig, *, n_devices: int,
              strategy: str = "fastest", base_seq: int = 64,
              n_points: int = 2, factors: Optional[dict] = None,
              cache: Optional[MM.ProfileCache] = None,
              measurer: Optional[MM.MemoryMeasurer] = None,
              hw: HW.HardwareSpec = HW.TPU_V5E):
    """The `--mesh auto` preamble shared by the train and serve drivers:
    classify the workload and plan a runnable execution. Returns
    (Classification, ExecutionPlan).

    `measurer` is the measurement backend for BOTH the classification
    ladder and the measured strategies — the drivers thread their
    `--backend` choice through here, so `--mesh auto --backend cuda`
    classifies and verifies with steps on the card instead of silently
    falling back to the simulator. Default (None) stays the device-free
    simulator over the host's data axis. `hw` is the device the plan is
    made for (the reference's default, a TPU v5e; the port's CLIs pass
    HW.H100)."""
    from repro_torch.core import profiler as PF
    if measurer is None:
        measurer = MM.SimulatedMeasurer({"data": n_devices}, cache=cache)
    cls = PF.classify_workload(cfg, shape, None, n_points=n_points,
                               base_seq=base_seq, measurer=measurer)
    eplan = plan_execution(cfg, shape, cls, n_devices=n_devices,
                           strategy=strategy, measurer=measurer, cache=cache,
                           factors=factors, hw=hw)
    return cls, eplan


# ---------------------------------------------------------------------------
# Serving: plan for maximum admitted concurrency under an HBM budget
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """A deployment configuration for the serving engine: the runnable
    ExecutionPlan plus the WSMC-predicted admission bound. `capacity` is
    the GLOBAL number of concurrent sequences the memory model says fit
    the per-device budget — the engine sizes its KV pool from it and
    queues everything beyond. Under paged KV (`kv_block > 0`) the budget
    governs a BLOCK pool instead of whole-sequence slots: `blocks` is the
    global block count `predictor.serving_block_capacity` admits at
    `capacity` decode lanes, and capacity itself is the EXPECTED
    concurrency under the trace's length distribution (short requests stop
    paying max-context bytes)."""
    execution: ExecutionPlan
    capacity: int
    hbm_budget: float
    considered: int = 0              # serving candidates scored
    kv_block: int = 0                # positions per KV block (0 = ring slots)
    blocks: int = 0                  # global paged-pool block budget
    admission: str = "optimistic"    # reservation discipline the capacity
                                     # inversion assumed (worst | optimistic)
    agreement: float = 1.0           # PRIOR token-agreement estimate of the
                                     # picked bend (1.0 = exact; measured
                                     # agreement comes from serving.quality)
    prefill_budget: int = 0          # prompt tokens per tick the inversion
                                     # charged the prefill transient for
                                     # (0 = prefill not modeled)
    prefill_kernel: str = "dense"    # prefill cost model the inversion
                                     # assumed: dense SDPA score matrix vs
                                     # tiled flash kernel (O(chunk·d))

    def slots(self, cap: Optional[int] = None) -> int:
        """Engine slot-pool size (ring) / decode-lane count (paged): the
        predicted capacity, optionally capped (CLI --max-slots, trace
        size)."""
        return self.capacity if cap is None else min(self.capacity, int(cap))

    def pool_blocks(self, lanes: int, context: int) -> int:
        """Physical block-pool size for an engine running `lanes` decode
        lanes over ring extent `context`: the planned block budget, capped
        at what the lanes can ever hold (a --max-slots-capped engine
        shouldn't allocate the full planned pool)."""
        if not self.kv_block:
            return 0
        per_seq = -(-int(context) // self.kv_block)
        return max(min(self.blocks, int(lanes) * per_seq), 1)

    def describe(self) -> str:
        paged = (f" kv_block={self.kv_block} blocks={self.blocks}"
                 if self.kv_block else "")
        if self.admission != "optimistic":
            paged += f" admission={self.admission}"
        if self.prefill_budget:
            paged += (f" prefill_budget={self.prefill_budget}"
                      f" prefill_kernel={self.prefill_kernel}")
        p = self.execution.plan
        if p.kv_quant != "none":
            paged += f" kv_quant={p.kv_quant}"
        if p.kv_retain:
            paged += f" kv_retain={p.kv_retain}"
        if self.agreement < 1.0:
            paged += f" agreement>={self.agreement:.3f}"
        return (f"{self.execution.describe()} capacity={self.capacity}"
                f"{paged} (budget={self.hbm_budget / 2**30:.1f} GiB, "
                f"considered={self.considered})")


DEFAULT_KV_BLOCKS = (8, 16, 32, 64, 128)

# Prior token-agreement estimates for the capacity-bending knobs: what the
# search GATE assumes before anything is measured. int8 per-row absmax is
# near-lossless on KV (error <= scale/2 per element); int4 and block
# dropping are real bends. The benchmark's quality harness
# (serving.quality.token_agreement) replaces these priors with measurement.
QUANT_AGREEMENT = {"none": 1.0, "int8": 0.995, "int4": 0.97}
RETAIN_AGREEMENT = 0.95


def predicted_agreement(plan: MemoryPlan, max_seq_blocks: int) -> float:
    """Prior token-agreement of a bent candidate vs exact greedy decode.
    Retention only costs quality when it would actually drop blocks —
    a reach cap wider than the longest sequence never fires."""
    a = QUANT_AGREEMENT[plan.kv_quant]
    if plan.kv_retain and plan.kv_retain + 1 < max_seq_blocks:
        a *= RETAIN_AGREEMENT
    return a


def ladder_priors(plan: "ServingPlan", max_seq_blocks: int,
                  min_agreement: float = 0.0) -> dict:
    """The degradation ladder's quality gate, priced by the SAME priors
    the serving search enforces: the agreement a `bend_retain` of
    `max_seq_blocks // 2` blocks would cost ON TOP of the plan's already-
    gated bend, and whether that clears `min_agreement`. The engine's
    rung-2 kv_bend only engages inside this gate (`LadderConfig(
    bend_retain=..., bend_agreement=..., min_agreement=...)`), so
    pressure never trades quality the planner wouldn't have."""
    base = plan.agreement
    retain = max(max_seq_blocks // 2, 1)
    bend = base * (RETAIN_AGREEMENT
                   if retain + 1 < max_seq_blocks else 1.0)
    return {"bend_retain": retain,
            "bend_agreement": bend,
            "min_agreement": float(min_agreement),
            "bend_allowed": bend >= float(min_agreement)}


def _expected_blocks(seq_lens: Sequence[int], block: int) -> float:
    """Mean paged-block demand per sequence under the trace's length
    distribution: `seq_lens` holds each request's written positions
    (prompt + generated - 1)."""
    lens = [max(int(s), 1) for s in seq_lens] or [1]
    return sum(-(-s // block) for s in lens) / len(lens)


def _bucket_cover(n: int, cap: int) -> int:
    """Smallest power-of-two >= n, capped at `cap` (the executor's lane
    bucket the compacting engine would actually run at)."""
    w = 1
    while w < min(n, cap):
        w *= 2
    return min(w, cap)


def _paged_concurrency(cfg, shape, cand, cls, budget, mode, hw, factors,
                       seq_lens, max_lanes: int = 1 << 14,
                       compact: bool = False, admission: str = "optimistic",
                       sigma_k: float = 0.0, prefill_tokens: int = 0,
                       prefill_kernel: str = "dense", chunk: int = 0):
    """Expected admitted concurrency for one paged serving candidate: the
    largest per-device lane count whose block pool still covers the
    EXPECTED per-sequence demand (blocks(lanes) >= lanes * E[blocks/seq]).
    blocks() falls as lanes rise (lane-fixed state eats the budget) while
    demand rises, so the balance point is an exact monotone search.
    With `compact`, the decode transient is charged at the bucketed
    EXPECTED active width (lanes scaled by the trace's mean/max length
    ratio — the same expected-case admission stance as avg_context)
    instead of the full lane width.

    `admission="worst"` sizes for a `reservation="worst"` engine: every
    lane is charged `max_seq_blocks` (no lane can be refused its full
    reservation) and the transient is charged at full context and width —
    deadlock-free by construction, the pre-PR-7 stance. The default
    "optimistic" covers expected demand plus `sigma_k` pooled standard
    deviations (per-sequence block std scaled by sqrt(lanes) — independent
    lengths concentrate), trusting the engine's eviction path on a miss.
    sigma_k=0 is the bare-expected sizing every pre-existing call pinned.

    `prefill_tokens` > 0 also charges each tick's prefill transient (a
    chunked engine under that token budget, spread over ceil(tokens /
    chunk) lanes) at the `prefill_kernel` cost model — the decode-or-
    prefill max governs the headroom (predictor.prefill_transient_bytes).
    Returns (global_concurrency, global_blocks)."""
    from repro_torch.core import predictor as PR
    _, dp, _ = PR.mesh_factors(cand.mesh_shape)
    pwidth = (-(-int(prefill_tokens) // int(chunk))
              if prefill_tokens and chunk else 1)
    block = cand.plan.kv_block_size
    lens = [max(int(s), 1) for s in seq_lens] or [1]
    avg_context = -(-sum(lens) // len(lens))
    # the pool must also hold the LONGEST request outright, or the engine
    # could never admit it (expected demand alone would undersize the pool
    # on a short-heavy trace with a long tail). Retention does NOT lower
    # this floor: whole-prompt prefill lands every prompt block before the
    # first drop.
    max_seq_blocks = max(-(-s // block) for s in lens)
    e_frac = (sum(lens) / len(lens)) / max(lens)     # mean/max in (0, 1]
    nb = [-(-s // block) for s in lens]
    worst = admission == "worst"
    retain = cand.plan.kv_retain
    if retain and not worst:
        # block retention caps each lane's steady-state live blocks at
        # retain+1 (the engine drops the coldest past that). Worst-mode
        # engines still reserve the uncapped footprint (deadlock-free by
        # construction), so the cap only bends optimistic sizing.
        nb = [min(b, retain + 1) for b in nb]
    e_blocks = sum(nb) / len(nb)
    std_blocks = (sum((b - e_blocks) ** 2 for b in nb) / len(nb)) ** 0.5
    _blocks_memo: dict = {}

    def blocks_at(lanes: int) -> int:
        if lanes not in _blocks_memo:
            width = (_bucket_cover(max(1, int(-(-(lanes * e_frac) // 1))),
                                   lanes) if compact and not worst else None)
            _blocks_memo[lanes] = PR.serving_block_capacity(
                cfg, shape, cand.plan, cls, cand.mesh_shape, lanes=lanes,
                mode=mode, hw=hw, hbm_budget=budget, factors=factors,
                avg_context=avg_context, decode_width=width,
                admission=admission, prefill_tokens=int(prefill_tokens),
                prefill_kernel=prefill_kernel,
                prefill_width=pwidth) // dp
        return _blocks_memo[lanes]

    def feasible(lanes: int) -> bool:
        if worst:
            return blocks_at(lanes) >= lanes * max_seq_blocks
        demand = lanes * e_blocks + sigma_k * std_blocks * lanes ** 0.5
        return blocks_at(lanes) >= max(demand, max_seq_blocks)

    if not feasible(1):
        return 0, 0
    lo, hi = 1, 2
    while hi < max_lanes and feasible(hi):
        lo, hi = hi, hi * 2
    if hi >= max_lanes and feasible(max_lanes):
        lo = max_lanes
    else:
        while hi - lo > 1:          # invariant: feasible(lo), not feasible(hi)
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if feasible(mid) else (lo, mid)
    return lo * dp, blocks_at(lo) * dp


def plan_serving(cfg: ModelConfig, shape: ShapeConfig, *, n_devices: int,
                 hbm_budget: Optional[float] = None,
                 cls: Optional[Classification] = None,
                 measurer: Optional[MM.MemoryMeasurer] = None,
                 cache: Optional[MM.ProfileCache] = None,
                 base_seq: int = 64, n_points: int = 2, mode: str = "paper",
                 factors: Optional[dict] = None,
                 hw: HW.HardwareSpec = HW.TPU_V5E,
                 space: Optional[SP.ConfigSpace] = None,
                 kv: str = "ring",
                 kv_blocks: Sequence[int] = DEFAULT_KV_BLOCKS,
                 seq_lens: Optional[Sequence[int]] = None,
                 compact: bool = False, admission: str = "optimistic",
                 sigma_k: float = 0.0,
                 kv_quants: Sequence[str] = ("none",),
                 kv_retains: Sequence[int] = (0,),
                 min_agreement: float = 0.0,
                 prefill_budget: int = 0,
                 prefill_budgets: Sequence[int] = (),
                 prefill_kernel: str = "dense", chunk: int = 0):
    """The serving-engine planning entry: walk the serving lattice
    (kv_shard x kv_block_size x data x model, pipe pinned —
    space.serving_space) and pick the candidate that maximizes admitted
    concurrency under the per-device HBM budget, tie-broken fastest-first.
    This is the paper's configuration loop run in reverse: instead of
    sizing memory to a fixed workload, it sizes the admissible workload to
    a fixed memory budget.

    `kv="ring"` scores candidates by `predictor.serving_capacity`
    (worst-case whole-sequence slots). `kv="paged"` makes `kv_block_size`
    a searched knob and maximizes EXPECTED admitted concurrency under the
    trace's length distribution (`seq_lens`: written positions per
    request; defaults to worst-case `shape.context`), via
    `predictor.serving_block_capacity` — admit by actual footprint, not
    worst case. `compact` (paged only) charges the decode transient at the
    compacting engine's bucketed expected width instead of the full lane
    width. `admission` picks the reservation discipline the inversion
    assumes — "optimistic" (default; expected demand + `sigma_k` pooled
    sigmas, pairing with an eviction-capable engine) or "worst" (every
    lane charged the longest request, the deadlock-free sizing); a
    candidate's own `admission` extra (when `serving_space` searches it)
    overrides the call-level value per candidate.

    `kv_quants` / `kv_retains` (paged only) widen the lattice with the
    capacity-bending knobs; `min_agreement` is the quality floor on the
    bend — candidates whose `predicted_agreement` prior falls below it are
    dropped before scoring, so the planner walks the quality/capacity
    frontier instead of always taking the cheapest bytes. Exact candidates
    (kv_quant="none", kv_retain=0) always pass the gate.

    `prefill_budget` > 0 (paged only; needs `chunk`, the engine's
    chunk_prefill) makes the prefill transient a scored term: each tick
    is charged max(decode, prefill-at-budget) headroom under the
    `prefill_kernel` cost model ("dense" SDPA vs "tiled" flash-prefill).
    `prefill_budgets` makes the budget a searched knob (candidate extras
    override the call-level value, like `admission`). Returns
    (Classification, ServingPlan)."""
    from repro_torch.core import predictor as PR   # lazy, like profiler below
    from repro_torch.core import profiler as PF
    if kv not in ("ring", "paged"):
        raise ValueError(f"plan_serving: unknown kv mode {kv!r}")
    if admission not in ("optimistic", "worst"):
        raise ValueError(f"plan_serving: unknown admission {admission!r}")
    if prefill_kernel not in PR.PREFILL_KERNELS:
        raise ValueError(f"plan_serving: unknown prefill_kernel "
                         f"{prefill_kernel!r}; known: {PR.PREFILL_KERNELS}")
    if (prefill_budget or prefill_budgets) and not chunk:
        raise ValueError("plan_serving: prefill_budget needs chunk > 0 "
                         "(the budget schedules chunk_prefill-sized "
                         "pieces; whole-prompt prefill is all-or-nothing)")
    if measurer is None:
        measurer = MM.SimulatedMeasurer({"data": n_devices}, cache=cache)
    if cls is None:
        cls = PF.classify_workload(cfg, shape, None, n_points=n_points,
                                   base_seq=base_seq, measurer=measurer)
    budget = hw.hbm_bytes if hbm_budget is None else float(hbm_budget)
    if space is None:
        space = SP.serving_space(
            cfg, shape, max_devices=n_devices,
            data=_axis_values(n_devices), model=_axis_values(n_devices),
            kv_blocks=tuple(kv_blocks) if kv == "paged" else (0,),
            kv_quants=tuple(kv_quants) if kv == "paged" else ("none",),
            kv_retains=tuple(kv_retains) if kv == "paged" else (0,),
            prefill_budgets=(tuple(prefill_budgets)
                             if kv == "paged" else ()))
    if kv == "paged" and seq_lens is None:
        seq_lens = (shape.context,)
    cands = space.candidates(cfg, shape)
    if kv == "paged":
        cands = [c for c in cands if c.plan.kv_block_size > 0]
    if not cands:
        raise ValueError(f"{space.name}: no valid serving candidates")
    if min_agreement > 0 and kv == "paged":
        lens = [max(int(s), 1) for s in seq_lens]
        kept = []
        for c in cands:
            msb = max(-(-s // c.plan.kv_block_size) for s in lens)
            if predicted_agreement(c.plan, msb) >= min_agreement:
                kept.append(c)
        cands = kept
        if not cands:
            raise ValueError(f"{space.name}: no serving candidate meets "
                             f"min_agreement={min_agreement}")
    best, best_cap, best_blocks = None, -1, 0
    best_adm, best_pb = admission, int(prefill_budget)
    for cand in cands:                       # fastest-first => ties keep speed
        adm = cand.extra("admission", admission)
        pb = int(cand.extra("prefill_budget", prefill_budget) or 0)
        if kv == "paged":
            cap, blocks = _paged_concurrency(cfg, shape, cand, cls, budget,
                                             mode, hw, factors, seq_lens,
                                             compact=compact, admission=adm,
                                             sigma_k=sigma_k,
                                             prefill_tokens=pb,
                                             prefill_kernel=prefill_kernel,
                                             chunk=chunk)
        else:
            cap = PR.serving_capacity(cfg, shape, cand.plan, cls,
                                      cand.mesh_shape, mode=mode, hw=hw,
                                      hbm_budget=budget, factors=factors)
            blocks = 0
        if cap > best_cap:
            best, best_cap, best_blocks = cand, cap, blocks
            best_adm, best_pb = adm, pb
    eplan = for_mesh(cfg, shape, best.plan, best.mesh_shape,
                     policy="max_concurrency")
    agree = 1.0
    if kv == "paged":
        lens = [max(int(s), 1) for s in seq_lens]
        msb = max(-(-s // best.plan.kv_block_size) for s in lens)
        agree = predicted_agreement(best.plan, msb)
    return cls, ServingPlan(execution=eplan, capacity=best_cap,
                            hbm_budget=budget, considered=len(cands),
                            kv_block=best.plan.kv_block_size,
                            blocks=best_blocks, admission=best_adm,
                            agreement=agree,
                            prefill_budget=best_pb if kv == "paged" else 0,
                            prefill_kernel=prefill_kernel)


def plan_execution(cfg: ModelConfig, shape: ShapeConfig,
                   cls: Optional[Classification], *, n_devices: int,
                   strategy: str = "fastest",
                   measurer: Optional[MM.MemoryMeasurer] = None,
                   cache: Optional[MM.ProfileCache] = None,
                   factors: Optional[dict] = None,
                   hw: HW.HardwareSpec = HW.TPU_V5E, k: int = 5
                   ) -> ExecutionPlan:
    """`--mesh auto` in one call: search the runnable mesh_space with the
    named strategy and promote the winner to an ExecutionPlan. The measured
    strategies default to the device-free simulator, so planning runs
    nothing on the card."""
    space = auto_mesh_space(cfg, shape, n_devices)
    if measurer is None and strategy not in ("fastest", "fastest_first",
                                             "wsmc"):
        measurer = MM.SimulatedMeasurer({"data": n_devices}, cache=cache)
    res = ST.plan_for(cfg, shape, cls, {"data": n_devices},
                      strategy=strategy, measurer=measurer, cache=cache,
                      k=k, hw=hw, factors=factors, space=space)
    return from_search_result(cfg, shape, res)
