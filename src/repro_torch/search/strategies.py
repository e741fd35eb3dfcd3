"""Pluggable search strategies over a ConfigSpace.

Every WSMC consumer (planner, hillclimb, serve, dry-run, benchmarks) walks
the same candidate lattice through one of these:

  fastest_first       — the paper's §III-E walk: predict per candidate
                        (closed form, Eqs. 6-11), take the fastest that
                        fits. Zero measurements.
  exhaustive_verified — the 'proper configuration' oracle: measure-verify
                        candidates fastest-first until one's measured peak
                        fits. O(lattice) backend calls.
  staged              — screen the WHOLE lattice with the device-free
                        simulator, keep the top-k fitting candidates,
                        verify only those with the expensive backend —
                        oracle-quality search in O(k) measurements.
  greedy_coordinate   — hillclimbing absorbed from launch/hillclimb.py:
                        from a start point, move one knob at a time and
                        keep strict improvements of a caller-chosen score.

The measurement cost split (cheap screening predictor in front of expensive
validation) is the search framing of Crispy (arXiv:2206.13852) and Will et
al. (arXiv:2306.03672) applied to the paper's planner.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch import hw as HW
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import measure as MM
from repro_torch.core import predictor as PR
from repro_torch.core.classifier import Classification
from repro_torch.search import space as SP
from repro_torch.search.space import Candidate, ConfigSpace


@dataclasses.dataclass(frozen=True)
class SearchResult:
    candidate: Candidate
    policy: str
    considered: int                  # candidates examined (cheap screen)
    measured: int = 0                # expensive verify-backend invocations
    prediction: Optional[PR.CapacityPrediction] = None
    peak_bytes: Optional[float] = None     # verified peak, when measured

    @property
    def plan(self) -> PR.MemoryPlan:
        return self.candidate.plan

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return self.candidate.mesh_shape

    def describe_outcome(self) -> str:
        """One-line cost summary for driver logs: predicted capacity,
        verified peak, or just the candidates examined."""
        if self.prediction is not None:
            return (f"capacity="
                    f"{self.prediction.capacity_bytes / 2**20:.0f} MiB")
        if self.peak_bytes is not None:
            return (f"verified_peak={self.peak_bytes / 2**20:.0f} MiB "
                    f"measured={self.measured}")
        return f"considered={self.considered}"


def plan_budget(hw: HW.HardwareSpec = HW.TPU_V5E) -> float:
    """Peak bytes/device a plan may measure at and still be configurable
    within HBM after the Eq. 11 headroom + runtime reserve."""
    return hw.hbm_bytes / HW.CAPACITY_HEADROOM - hw.reserved_bytes


def feasibility_score(scorer: "CandidateScorer", cfg: ModelConfig,
                      shape: ShapeConfig,
                      hw: HW.HardwareSpec = HW.TPU_V5E) -> Callable:
    """Score for greedy_coordinate: fitting candidates compete on speed
    (then peak); non-fitting ones descend on peak first, so the climb can
    escape an infeasible start one knob at a time."""
    budget = plan_budget(hw)

    def score(cand: Candidate):
        peak = scorer.peak(cfg, shape, cand)
        if peak <= budget:
            return (0, cand.step_time_penalty(), peak)
        return (1, peak, cand.step_time_penalty())

    return score


# ---------------------------------------------------------------------------
# Candidate scoring
# ---------------------------------------------------------------------------

def resolved_ep(cfg: Optional[ModelConfig], cand: Candidate,
                mesh_shape: Optional[Mapping[str, int]] = None) -> bool:
    """The EP mode this candidate will actually run with. ep=None means
    "keep the default_strategy choice" (sharding.default_strategy: EP when
    the expert count tiles the model axis), so scoring must resolve it the
    same way the launch drivers will."""
    ep = cand.extra("ep")
    if ep is not None:
        return bool(ep)
    if cfg is None or not cfg.is_moe:
        return False
    model = int((cand.mesh_shape or dict(mesh_shape or {})).get("model", 1))
    return model > 0 and cfg.n_experts % model == 0


def measure_key(cand: Candidate, cfg: Optional[ModelConfig] = None,
                mesh_shape: Optional[Mapping[str, int]] = None) -> Tuple:
    """What a measurement backend can actually distinguish about a
    candidate: the plan, the mesh, and the (resolved) EP mode. All other
    extras (moe_group, q_block, …) ride through the launch drivers, not the
    measurer — candidates differing only in those measure identically."""
    return (cand.plan, cand.mesh, resolved_ep(cfg, cand, mesh_shape))


class CandidateScorer:
    """Adapts a MemoryMeasurer (or a legacy `measure(plan)` callable) to
    score Candidates that may each carry their own mesh / extras.

    The simulate backend is cloned per distinct (mesh, ep) — microseconds
    each; the card backend (`CudaMeasurer`) is cloned per distinct mesh
    shape, which is only sensible for the handful of verify calls `staged`
    makes, and only for meshes of one device. Card verification scores the
    plan knobs only (extras like moe_group ride through the launch drivers,
    not the measurer).

    Results are memoized per (workload, measure_key): re-scoring the same
    measurer-visible configuration (greedy revisits, extras-only twins) is
    free and does not count as a backend call."""

    def __init__(self, measurer: Optional[MM.MemoryMeasurer] = None,
                 measure: Optional[Callable[[PR.MemoryPlan], float]] = None):
        if measurer is None and measure is None:
            raise TypeError("CandidateScorer needs `measurer` or `measure`")
        self.measurer = measurer
        self.measure_fn = measure
        self.calls = 0
        self._clones: Dict[Tuple, MM.MemoryMeasurer] = {}
        self._memo: Dict[Tuple, float] = {}

    def peak(self, cfg: ModelConfig, shape: ShapeConfig,
             cand: Candidate) -> float:
        base_mesh = None if self.measurer is None else self.measurer.mesh_shape
        ep = resolved_ep(cfg, cand, base_mesh)
        if self.measurer is not None and self.measurer.backend != "simulate":
            ep = False       # the card backend scores plan + mesh only
        key = (cfg.name, cfg.n_layers, cfg.d_model, shape.kind,
               shape.seq_len, shape.global_batch, cand.plan, cand.mesh, ep)
        if key in self._memo:
            return self._memo[key]
        self.calls += 1
        if self.measure_fn is not None:
            peak = self.measure_fn(cand.plan)
        else:
            peak = self._measurer_for(cand, ep).measure_peak(cfg, shape,
                                                             cand.plan)
        self._memo[key] = peak
        return peak

    def _measurer_for(self, cand: Candidate, ep: bool) -> MM.MemoryMeasurer:
        base = self.measurer
        want = cand.mesh_shape or base.mesh_shape
        if want == base.mesh_shape and not ep:
            return base
        key = (tuple(sorted(want.items())), ep)
        if key not in self._clones:
            if base.backend == "simulate":
                self._clones[key] = MM.SimulatedMeasurer(
                    want, cache=base.cache, ep=ep)
            else:
                self._clones[key] = MM.CudaMeasurer(
                    want, cache=base.cache, device=base.device)
        return self._clones[key]


def _as_scorer(measurer=None, measure=None) -> CandidateScorer:
    if isinstance(measurer, CandidateScorer):
        return measurer
    return CandidateScorer(measurer=measurer, measure=measure)


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------

def _dp_filtered(shape: ShapeConfig,
                 cands: List[Candidate]) -> List[Candidate]:
    """The §III-E walk's divisibility screen, with the planner's historical
    fallback: if nothing divides, keep the slowest/safest candidate."""
    kept = [c for c in cands if SP.DP_DIVIDES_BATCH.check(None, shape, c)]
    return kept or cands[-1:]


def _measure_distinct(cands: List[Candidate],
                      cfg: Optional[ModelConfig] = None,
                      mesh_shape: Optional[Mapping[str, int]] = None
                      ) -> List[Candidate]:
    """Drop candidates a measurement backend cannot tell apart (same plan,
    mesh, resolved EP — only ordering-neutral extras differ), keeping
    first-seen fastest-first order. Without this, spaces with many extras
    (hillclimb) would spend their verify budget k times on the same
    configuration."""
    seen = set()
    out = []
    for c in cands:
        key = measure_key(c, cfg, mesh_shape)
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def fastest_first(space: ConfigSpace, cfg: ModelConfig, shape: ShapeConfig,
                  cls: Classification, *, mode: str = "paper",
                  hw: HW.HardwareSpec = HW.TPU_V5E,
                  factors: Optional[dict] = None) -> SearchResult:
    """Paper §III-E: predict per candidate, take the fastest that fits.
    `factors` is the offline-calibrated Table III
    (profiler.calibrated_factors). Zero measurement-backend calls."""
    if cls is None:
        raise ValueError("fastest_first needs a workload Classification")
    cands = space.candidates(cfg, shape)
    if not cands:
        raise ValueError(f"{space.name}: no valid candidates")
    cands = _dp_filtered(shape, cands)
    for i, cand in enumerate(cands):
        pred = PR.predict(cfg, shape, cand.plan, cls, cand.mesh_shape, mode,
                          hw, factors)
        if pred.fits:
            return SearchResult(cand, "wsmc", i + 1, prediction=pred)
    # nothing fits: return the safest with its (over-budget) prediction
    cand = cands[-1]
    pred = PR.predict(cfg, shape, cand.plan, cls, cand.mesh_shape, mode, hw,
                      factors)
    return SearchResult(cand, "wsmc_overflow", len(cands), prediction=pred)


def exhaustive_verified(space: ConfigSpace, cfg: ModelConfig,
                        shape: ShapeConfig, *,
                        measurer: Optional[MM.MemoryMeasurer] = None,
                        measure: Optional[Callable] = None,
                        hw: HW.HardwareSpec = HW.TPU_V5E,
                        max_candidates: Optional[int] = None) -> SearchResult:
    """The 'proper configuration' oracle: measure-verify candidates
    fastest-first until one's measured peak fits. Under the card backend
    each call is a real step on the device (exactly the cost WSMC avoids);
    under the simulator the whole search is free."""
    scorer = _as_scorer(measurer, measure)
    base_mesh = None if scorer.measurer is None else scorer.measurer.mesh_shape
    cands = _measure_distinct(space.candidates(cfg, shape), cfg, base_mesh)
    if not cands:
        raise ValueError(f"{space.name}: no valid candidates")
    if max_candidates:
        cands = cands[:max_candidates]
    budget = plan_budget(hw)
    best: Optional[Tuple[Candidate, float]] = None
    for i, cand in enumerate(cands):
        peak = scorer.peak(cfg, shape, cand)
        if peak <= budget:
            return SearchResult(cand, "oracle", i + 1, measured=scorer.calls,
                                peak_bytes=peak)
        if best is None or peak < best[1]:
            best = (cand, peak)
    return SearchResult(best[0], "oracle_overflow", len(cands),
                        measured=scorer.calls, peak_bytes=best[1])


def staged(space: ConfigSpace, cfg: ModelConfig, shape: ShapeConfig, *,
           screener, verifier, k: int = 5,
           hw: HW.HardwareSpec = HW.TPU_V5E) -> SearchResult:
    """Screen the full lattice with the cheap backend (simulator: no
    device), keep the top-k fastest candidates the screen says fit, and
    verify only those with the expensive backend — turning oracle-quality
    search from O(lattice) measurements into O(k)."""
    screen = _as_scorer(screener)
    verify = _as_scorer(verifier)
    all_cands = space.candidates(cfg, shape)
    if not all_cands:
        raise ValueError(f"{space.name}: no valid candidates")
    base_mesh = None if screen.measurer is None else screen.measurer.mesh_shape
    cands = _measure_distinct(all_cands, cfg, base_mesh)
    budget = plan_budget(hw)
    scored = [(screen.peak(cfg, shape, c), c) for c in cands]
    fitting = [c for peak, c in scored if peak <= budget]
    if fitting:
        shortlist = fitting[:k]
    else:        # screen says nothing fits: verify the k least-bad points
        shortlist = [c for _, c in
                     sorted(scored, key=lambda pc: pc[0])[:k]]
    best: Optional[Tuple[Candidate, float]] = None
    for cand in shortlist:
        peak = verify.peak(cfg, shape, cand)
        if peak <= budget:
            return SearchResult(cand, "staged", len(all_cands),
                                measured=verify.calls, peak_bytes=peak)
        if best is None or peak < best[1]:
            best = (cand, peak)
    return SearchResult(best[0], "staged_overflow", len(all_cands),
                        measured=verify.calls, peak_bytes=best[1])


def greedy_coordinate(space: ConfigSpace, cfg: ModelConfig,
                      shape: ShapeConfig, *,
                      score: Callable[[Candidate], object],
                      start: Optional[Candidate] = None,
                      max_rounds: int = 3,
                      scorer: Optional[CandidateScorer] = None
                      ) -> SearchResult:
    """Hillclimbing over the knob axes: from `start` (the space's baseline
    point by default), try every alternative value of every knob, keep a
    move iff it strictly improves `score` (any comparable; lower is better),
    and repeat until a full round makes no move. Pass the `scorer` backing
    `score` so the result reports how many backend measurements the climb
    actually spent."""
    cur = start if start is not None else space.point(cfg)
    best_s = score(cur)
    considered = 1
    for _ in range(max_rounds):
        moved = False
        for knob in space.knobs:
            current_v = space.value_of(cur, knob.name)
            for v in knob.values:
                if v == current_v:
                    continue
                cand = space.point(cfg, base=cur, **{knob.name: v})
                if not space.is_valid(cfg, shape, cand):
                    continue
                s = score(cand)
                considered += 1
                if s < best_s:
                    cur, best_s, current_v, moved = cand, s, v, True
        if not moved:
            break
    return SearchResult(cur, "greedy", considered,
                        measured=scorer.calls if scorer else 0)


# ---------------------------------------------------------------------------
# Registry + one-call façade
# ---------------------------------------------------------------------------

STRATEGIES = {
    "fastest_first": fastest_first,
    "exhaustive_verified": exhaustive_verified,
    "staged": staged,
    "greedy_coordinate": greedy_coordinate,
}

_ALIASES = {
    "fastest": "fastest_first", "wsmc": "fastest_first",
    "exhaustive": "exhaustive_verified", "oracle": "exhaustive_verified",
    "greedy": "greedy_coordinate",
}

# The short names every --strategy CLI flag offers.
CLI_STRATEGIES = ("fastest", "staged", "exhaustive", "greedy")


def get_strategy(name: str):
    canonical = _ALIASES.get(name, name)
    if canonical not in STRATEGIES:
        raise KeyError(f"unknown search strategy {name!r}; "
                       f"known: {sorted(STRATEGIES) + sorted(_ALIASES)}")
    return STRATEGIES[canonical]


def plan_for(cfg: ModelConfig, shape: ShapeConfig,
             cls: Optional[Classification],
             mesh_shape: Mapping[str, int], *, strategy: str = "fastest",
             measurer: Optional[MM.MemoryMeasurer] = None,
             cache: Optional[MM.ProfileCache] = None, k: int = 5,
             mode: str = "paper", hw: HW.HardwareSpec = HW.TPU_V5E,
             factors: Optional[dict] = None,
             space: Optional[ConfigSpace] = None) -> SearchResult:
    """One-call façade for the entry points (serve / dryrun / benchmarks):
    build the paper space over the given fixed mesh (or walk a caller-built
    `space`, e.g. a mesh_space for `--mesh auto`) and run the named
    strategy. `measurer` is the verify backend for the measured strategies
    (defaults to the free simulator); `staged` always screens with the
    simulator regardless."""
    fn = get_strategy(strategy)
    if space is None:
        space = SP.paper_space(cfg, shape, mesh_shape)
    if fn is fastest_first:
        return fastest_first(space, cfg, shape, cls, mode=mode, hw=hw,
                             factors=factors)
    if measurer is None:
        measurer = MM.SimulatedMeasurer(dict(mesh_shape), cache=cache)
    if fn is exhaustive_verified:
        return exhaustive_verified(space, cfg, shape, measurer=measurer,
                                   hw=hw)
    if fn is staged:
        screener = MM.SimulatedMeasurer(dict(mesh_shape),
                                        cache=measurer.cache or cache)
        return staged(space, cfg, shape, screener=screener,
                      verifier=measurer, k=k, hw=hw)
    # greedy: fitting candidates compete on speed, unfitting descend on peak
    scorer = _as_scorer(measurer)
    return greedy_coordinate(space, cfg, shape, scorer=scorer,
                             score=feasibility_score(scorer, cfg, shape, hw))
