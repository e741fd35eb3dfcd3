"""Declarative configuration space for plan search (paper §III-E,
generalized).

The paper's core loop — enumerate candidate memory configurations, predict
each one's capacity, pick the fastest that fits — used to be re-implemented
by every caller (planner lattice, hillclimb VARIANTS, dry-run sweeps). This
module makes the *space* a first-class object the strategies
(`repro_torch.search.strategies`) walk:

  Knob        — one searchable dimension: plan knobs (remat, microbatches,
                optimizer, kv_shard), mesh axes (data / model / pipe / pod)
                and beyond-paper levers (embed_onehot, q_block, ep, …).
  Candidate   — one lattice point: a MemoryPlan + a mesh shape + extras.
  Constraint  — a named validity predicate (batch divisibility, kv-head
                divisibility, pipeline legality, mesh-size budget).
  ConfigSpace — knobs × constraints with a fastest-first ordering; supports
                subspacing (pin knobs) and single-point construction.

Builders: `paper_space` (the §III-E lattice over a fixed mesh — exactly the
old `planner.candidate_plans`), `mesh_space` (mesh axes become searchable,
so the mesh is a planned *output*), `hillclimb_space` (the perf-variant
lattice of the reference package's launch/hillclimb.py).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

from repro_torch.configs.base import TRAIN, ModelConfig, ShapeConfig
from repro_torch.core.predictor import MemoryPlan

REMATS = ("none", "dots", "full")
OPTIMIZERS = ("adamw_f32", "adamw_bf16", "adafactor")
MICROBATCHES = (1, 2, 4, 8, 16, 32, 64)

# kv_shard value resolved per candidate from the model-axis size.
AUTO = "auto"

# Which override bucket each beyond-paper knob feeds when a launch driver
# materializes a candidate: ModelSettings, AttnSettings, or the sharding
# Strategy (see launch/hillclimb.run_variant).
EXTRA_GROUPS = {
    "embed_onehot": "settings",
    "moe_group": "settings",
    "q_block": "attn",
    "kv_block": "attn",
    "repeat_kv": "attn",
    "gather_weights": "attn",
    "ep": "strategy",
    "fsdp": "strategy",
    "admission": "serving",
    "prefill_budget": "serving",
}


def kv_auto(cfg: ModelConfig, model_size: int) -> str:
    """KV-head sharding only when heads divide the model axis; otherwise the
    ring cache shards its sequence dim (padding/replication would multiply
    the decode-resident cache — see musicgen kv=24 in EXPERIMENTS §Perf)."""
    return "heads" if model_size and cfg.n_kv_heads % model_size == 0 else "seq"


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of a ConfigSpace: the full configuration the planner may
    emit — knob plan, mesh shape (possibly searched), extra levers."""
    plan: MemoryPlan = MemoryPlan()
    mesh: Tuple[Tuple[str, int], ...] = ()      # sorted (axis, size) pairs
    extras: Tuple[Tuple[str, object], ...] = ()  # sorted (knob, value) pairs

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return dict(self.mesh)

    def extra(self, name: str, default=None):
        return dict(self.extras).get(name, default)

    def step_time_penalty(self) -> float:
        """Fastest-first ordering key. The plan's roofline-validated penalty,
        a pipeline bubble term when the pipe axis is in play, a light
        TP-collective term so mesh search prefers the smallest model axis
        that fits, and — on spaces where the mesh is searchable — a
        compute-parallel speedup (1/dp, 1/pipe: more devices over the batch
        or the depth means less work per device), so mesh search fills the
        host before shrinking. On fixed-mesh spaces every candidate shares
        the mesh term, so plan ordering is unchanged. Extras are
        ordering-neutral (ties keep lattice order)."""
        pen = self.plan.step_time_penalty()
        ms = self.mesh_shape
        pipe = int(ms.get("pipe", 1))
        if pipe > 1:
            micro = max(self.plan.microbatches, 1)
            pen *= (micro + pipe - 1) / micro
        model = int(ms.get("model", 1))
        if model > 1:
            pen *= 1.0 + 0.02 * math.log2(model)
        dp = int(ms.get("pod", 1)) * int(ms.get("data", 1))
        pen /= dp * pipe
        return pen

    def describe(self) -> str:
        p = self.plan
        parts = [f"remat={p.remat}", f"micro={p.microbatches}",
                 f"opt={p.optimizer}", f"kv={p.kv_shard}"]
        if self.mesh:
            parts.append("mesh=" + "x".join(f"{a}:{n}" for a, n in self.mesh))
        parts += [f"{k}={v}" for k, v in self.extras]
        return " ".join(parts)


def candidate_overrides(cand: Candidate) -> Dict[str, Dict[str, object]]:
    """Split a candidate's extras into the launch override buckets
    (ModelSettings / AttnSettings / sharding Strategy kwargs). Strategy
    booleans valued None mean "keep the default_strategy choice" (e.g. the
    EP auto-rule) and are dropped."""
    out: Dict[str, Dict[str, object]] = {"settings": {}, "attn": {},
                                         "strategy": {}, "serving": {}}
    for name, value in cand.extras:
        bucket = EXTRA_GROUPS[name]
        if bucket == "strategy" and value is None:
            continue
        out[bucket][name] = value
    return out


# ---------------------------------------------------------------------------
# Knobs and constraints
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Knob:
    """One searchable dimension. The first value is the baseline (what
    `ConfigSpace.point()` assumes for unassigned knobs)."""
    name: str
    values: Tuple
    group: str = "plan"          # plan | mesh | extra


@dataclasses.dataclass(frozen=True)
class Constraint:
    name: str
    check: Callable[[ModelConfig, ShapeConfig, Candidate], bool]


def _check_micro(cfg, shape, cand) -> bool:
    return shape.global_batch % max(cand.plan.microbatches, 1) == 0

MICRO_DIVIDES_BATCH = Constraint("microbatches divide global batch",
                                 _check_micro)


def _check_dp(cfg, shape, cand) -> bool:
    ms = cand.mesh_shape
    dp = int(ms.get("pod", 1)) * int(ms.get("data", 1))
    per = shape.global_batch // max(cand.plan.microbatches, 1)
    if shape.kind == TRAIN:
        # strict: a per-micro batch below dp replicates compute/memory
        return per % dp == 0
    # serving: bs=1 long-context cells replicate the batch axis benignly
    return per % dp == 0 or per < dp

DP_DIVIDES_BATCH = Constraint("per-micro batch divides dp", _check_dp)


def _check_kv(cfg, shape, cand) -> bool:
    if cand.plan.kv_shard != "heads":
        return True
    model = int(cand.mesh_shape.get("model", 1))
    return model <= 1 or cfg.n_kv_heads % model == 0

KV_HEADS_DIVISIBLE = Constraint("kv heads divide model axis", _check_kv)


def _check_pipe(cfg, shape, cand) -> bool:
    pipe = int(cand.mesh_shape.get("pipe", 1))
    if pipe <= 1:
        return True
    if shape.kind != TRAIN:           # serving runtime has no pipe schedule
        return False
    # stages split the stacked unit REPEATS (tail blocks run outside the
    # pipeline) — the same quantity runtime.schedule.validate_pipeline tests
    if cfg.repeats <= 0 or cfg.repeats % pipe:
        return False
    return cand.plan.microbatches >= pipe    # else the pipeline never fills

PIPE_LEGAL = Constraint("pipe divides unit repeats and microbatches fill it",
                        _check_pipe)


def _check_pipe_executable(cfg, shape, cand) -> bool:
    """What the 1F1B runtime can actually execute today — the SAME
    predicate validate_pipeline raises on (runtime.schedule_kinds, torch-free
    so the device-free planning path stays light), so a planned candidate
    IS a runnable one."""
    if int(cand.mesh_shape.get("pipe", 1)) <= 1:
        return True
    from repro_torch.runtime.schedule_kinds import pipeline_executable
    return pipeline_executable(cfg, cand.plan.microbatches, cand.mesh_shape,
                               None if shape is None else shape.global_batch)

PIPE_EXECUTABLE = Constraint("pipe schedule executable by the 1F1B runtime",
                             _check_pipe_executable)


def _check_kv_block(cfg, shape, cand) -> bool:
    b = cand.plan.kv_block_size
    return b == 0 or 0 < b <= shape.context

KV_BLOCK_LEGAL = Constraint("kv block size within the context", _check_kv_block)


def _check_kv_quant(cfg, shape, cand) -> bool:
    """Quantized KV lives in the paged block pool (per-row scales ride the
    block leaves), and int4 packs nibble pairs over the head dim."""
    q = cand.plan.kv_quant
    if q == "none":
        return True
    if cand.plan.kv_block_size <= 0:
        return False
    return q != "int4" or cfg.resolved_head_dim % 2 == 0

KV_QUANT_LEGAL = Constraint("kv quantization needs a paged pool "
                            "(int4: even head_dim)", _check_kv_quant)


def _check_kv_retain(cfg, shape, cand) -> bool:
    """Block-granular retention evicts paged blocks — meaningless on ring
    slots; a reach cap must also leave at least one block of context."""
    r = cand.plan.kv_retain
    return r == 0 or cand.plan.kv_block_size > 0

KV_RETAIN_LEGAL = Constraint("kv retention needs a paged pool",
                             _check_kv_retain)


def mesh_budget(max_devices: int) -> Constraint:
    def check(cfg, shape, cand) -> bool:
        n = 1
        for _, size in cand.mesh:
            n *= int(size)
        return n <= max_devices
    return Constraint(f"mesh size <= {max_devices}", check)


# ---------------------------------------------------------------------------
# The space
# ---------------------------------------------------------------------------

class ConfigSpace:
    """A declarative knob lattice + validity constraints + ordering."""

    def __init__(self, name: str, knobs: Sequence[Knob],
                 constraints: Sequence[Constraint] = ()):
        self.name = name
        self.knobs = tuple(knobs)
        self.constraints = tuple(constraints)
        self._by_name = {}
        for k in self.knobs:
            if k.name in self._by_name:
                raise ValueError(f"{name}: duplicate knob {k.name!r}")
            self._by_name[k.name] = k

    def __len__(self) -> int:
        n = 1
        for k in self.knobs:
            n *= len(k.values)
        return n

    def knob(self, name: str) -> Knob:
        if name not in self._by_name:
            raise KeyError(f"{self.name}: unknown knob {name!r}; "
                           f"have {sorted(self._by_name)}")
        return self._by_name[name]

    def subspace(self, name: Optional[str] = None, **pins) -> "ConfigSpace":
        """Pin knobs to a single value (or a subset of values)."""
        knobs = []
        for k in self.knobs:
            if k.name in pins:
                v = pins.pop(k.name)
                vals = tuple(v) if isinstance(v, (tuple, list)) else (v,)
                for val in vals:
                    if val not in k.values:
                        raise ValueError(
                            f"{self.name}.{k.name}: {val!r} not in {k.values}")
                knobs.append(dataclasses.replace(k, values=vals))
            else:
                knobs.append(k)
        if pins:
            raise KeyError(f"{self.name}: unknown knobs {sorted(pins)}")
        return ConfigSpace(name or f"{self.name}/sub", knobs, self.constraints)

    # -- candidate construction -------------------------------------------

    def _build(self, cfg: Optional[ModelConfig],
               assignment: Mapping[str, object]) -> Candidate:
        plan_kwargs: Dict[str, object] = {}
        mesh: List[Tuple[str, int]] = []
        extras: List[Tuple[str, object]] = []
        for k in self.knobs:
            v = assignment[k.name]
            if k.group == "plan":
                plan_kwargs[k.name] = v
            elif k.group == "mesh":
                mesh.append((k.name, int(v)))
            else:
                extras.append((k.name, v))
        if plan_kwargs.get("kv_shard") == AUTO:
            if cfg is None:
                raise ValueError(f"{self.name}: kv_shard='auto' needs a "
                                 "ModelConfig to resolve against")
            model = dict(mesh).get("model", 1)
            plan_kwargs["kv_shard"] = kv_auto(cfg, model)
        plan = dataclasses.replace(MemoryPlan(), **plan_kwargs)
        return Candidate(plan=plan, mesh=tuple(sorted(mesh)),
                         extras=tuple(sorted(extras, key=lambda kv: kv[0])))

    def value_of(self, cand: Candidate, name: str):
        k = self.knob(name)
        if k.group == "plan":
            return getattr(cand.plan, name)
        if k.group == "mesh":
            return cand.mesh_shape.get(name, k.values[0])
        return cand.extra(name, k.values[0])

    def point(self, cfg: Optional[ModelConfig] = None,
              base: Optional[Candidate] = None, **assign) -> Candidate:
        """One candidate from a (partial) knob assignment. Unassigned knobs
        take their value from `base` (e.g. a CLI-provided plan) or the
        knob's first (baseline) value. Explicit assignments are validated
        against the knob's declared values."""
        unknown = set(assign) - set(self._by_name)
        if unknown:
            raise KeyError(f"{self.name}: unknown knobs {sorted(unknown)}")
        full = {}
        for k in self.knobs:
            if k.name in assign:
                v = assign[k.name]
                if v not in k.values:
                    raise ValueError(
                        f"{self.name}.{k.name}: {v!r} not in {k.values}")
            elif base is not None:
                v = self.value_of(base, k.name)
            else:
                v = k.values[0]
            full[k.name] = v
        return self._build(cfg, full)

    # -- enumeration -------------------------------------------------------

    def points(self, cfg: Optional[ModelConfig] = None) -> Iterator[Candidate]:
        """Raw lattice in declared knob order (pre-constraint)."""
        names = [k.name for k in self.knobs]
        for combo in itertools.product(*(k.values for k in self.knobs)):
            yield self._build(cfg, dict(zip(names, combo)))

    def violations(self, cfg: ModelConfig, shape: ShapeConfig,
                   cand: Candidate) -> List[str]:
        return [c.name for c in self.constraints
                if not c.check(cfg, shape, cand)]

    def is_valid(self, cfg: ModelConfig, shape: ShapeConfig,
                 cand: Candidate) -> bool:
        return all(c.check(cfg, shape, cand) for c in self.constraints)

    def candidates(self, cfg: ModelConfig,
                   shape: ShapeConfig) -> List[Candidate]:
        """Valid lattice points, fastest-first (stable: ties keep the
        declared enumeration order — the paper's walk)."""
        valid = [c for c in self.points(cfg) if self.is_valid(cfg, shape, c)]
        return sorted(valid, key=lambda c: c.step_time_penalty())


# ---------------------------------------------------------------------------
# Space builders
# ---------------------------------------------------------------------------

def _mesh_knobs(mesh_shape: Mapping[str, int]) -> List[Knob]:
    return [Knob(axis, (int(n),), group="mesh")
            for axis, n in sorted(mesh_shape.items())]


def paper_space(cfg: ModelConfig, shape: ShapeConfig,
                mesh_shape: Optional[Mapping[str, int]] = None,
                model_size: Optional[int] = None) -> ConfigSpace:
    """The paper's §III-E lattice over a FIXED mesh: remat × microbatches ×
    optimizer with kv sharding resolved from the model-axis size. This is
    exactly the old `planner.candidate_plans` lattice (decision parity is
    pinned by tests/test_search.py)."""
    ms = dict(mesh_shape or {})
    if model_size is None:
        model_size = int(ms.get("model", 16))
    kv = kv_auto(cfg, model_size)
    if shape.kind != TRAIN:
        knobs = [Knob("remat", ("none",)), Knob("microbatches", (1,)),
                 Knob("optimizer", ("adamw_f32",)), Knob("kv_shard", (kv,))]
    else:
        knobs = [Knob("remat", REMATS), Knob("microbatches", MICROBATCHES),
                 Knob("optimizer", OPTIMIZERS), Knob("kv_shard", (kv,))]
    knobs += _mesh_knobs(ms)
    return ConfigSpace(f"paper[{cfg.name}|{shape.name}]", knobs,
                       (MICRO_DIVIDES_BATCH,))


def mesh_space(cfg: ModelConfig, shape: ShapeConfig, *,
               max_devices: int = 256,
               data: Sequence[int] = (1, 2, 4, 8, 16, 32),
               model: Sequence[int] = (1, 2, 4, 8, 16),
               pipe: Sequence[int] = (1, 2, 4),
               executable: bool = False) -> ConfigSpace:
    """Beyond-paper: the mesh axes are searchable dimensions, so the planner
    emits the mesh instead of taking it as a CLI input. kv_shard resolves
    per candidate ('auto') against the candidate's own model-axis size.
    `executable=True` additionally restricts pipe candidates to what the
    1F1B runtime schedule can run today (the `--mesh auto` drivers set it:
    the plan must be the thing you run)."""
    if shape.kind != TRAIN:
        plan_knobs = [Knob("remat", ("none",)), Knob("microbatches", (1,)),
                      Knob("optimizer", ("adamw_f32",)),
                      Knob("kv_shard", (AUTO,))]
        pipe = (1,)
    else:
        plan_knobs = [Knob("remat", REMATS),
                      Knob("microbatches", MICROBATCHES),
                      Knob("optimizer", OPTIMIZERS), Knob("kv_shard", (AUTO,))]
    mesh_knobs = [Knob("data", tuple(data), group="mesh"),
                  Knob("model", tuple(model), group="mesh"),
                  Knob("pipe", tuple(pipe), group="mesh")]
    constraints = [MICRO_DIVIDES_BATCH, DP_DIVIDES_BATCH, KV_HEADS_DIVISIBLE,
                   PIPE_LEGAL, mesh_budget(max_devices)]
    if executable:
        constraints.append(PIPE_EXECUTABLE)
    return ConfigSpace(
        f"mesh[{cfg.name}|{shape.name}]", plan_knobs + mesh_knobs,
        tuple(constraints))


def serving_space(cfg: ModelConfig, shape: ShapeConfig, *,
                  max_devices: int = 256,
                  data: Sequence[int] = (1, 2, 4, 8, 16, 32),
                  model: Sequence[int] = (1, 2, 4, 8, 16),
                  kv_blocks: Sequence[int] = (0,),
                  admission: Sequence[str] = (),
                  kv_quants: Sequence[str] = ("none",),
                  kv_retains: Sequence[int] = (0,),
                  prefill_budgets: Sequence[int] = (),
                  kv_shards: Sequence[str] = ("heads", "seq")
                  ) -> ConfigSpace:
    """The serving-engine planning lattice: mesh axes searchable (pipe
    pinned to 1 — the serving runtime is single-shot) and kv_shard a REAL
    knob rather than auto-resolved, because the admission controller cares:
    `heads` replicates the ring cache when kv heads don't divide the model
    axis, while `seq` shards its length — different per-sequence bytes,
    hence different admitted concurrency. `kv_block_size` is the paged-KV
    allocation granule (0 = whole-sequence ring slots): smaller blocks
    track short sequences' true footprint more tightly but pay more
    block-table indirection. `admission` is the engine reservation
    discipline the capacity inversion assumes ("optimistic" expected-case
    vs "worst" deadlock-free-by-construction) — ABSENT by default so
    `plan_serving(admission=...)` governs; pass a non-empty tuple to make
    it a searched knob (candidate extras then override the argument).
    `kv_quant` / `kv_retain` are the capacity-bending knobs (int8/int4
    block storage, top-k block retention) — legal only over a paged pool,
    and `plan_serving(min_agreement=...)` gates how aggressive a bend the
    planner may pick. `prefill_budgets` (absent by default, like
    `admission`) makes the engine's prefill token budget a searched knob:
    a tighter budget shrinks the prefill-tick transient the capacity
    inversion must hold headroom for, admitting more blocks at tight HBM
    budgets at the cost of slower prompt ramp-in. `plan_serving` scores
    each candidate by `predictor.serving_capacity` (ring) or expected
    admitted concurrency over the block pool (paged) instead of step
    time. `kv_shards` narrows the kv layouts searched (the port's engine
    runs "heads" on a model axis above 1)."""
    knobs = [Knob("remat", ("none",)), Knob("microbatches", (1,)),
             Knob("optimizer", ("adamw_f32",)),
             Knob("kv_shard", tuple(kv_shards)),
             Knob("kv_block_size", tuple(kv_blocks)),
             Knob("kv_quant", tuple(kv_quants)),
             Knob("kv_retain", tuple(int(r) for r in kv_retains)),
             *([Knob("admission", tuple(admission), group="extra")]
               if admission else []),
             *([Knob("prefill_budget",
                     tuple(int(p) for p in prefill_budgets), group="extra")]
               if prefill_budgets else []),
             Knob("data", tuple(data), group="mesh"),
             Knob("model", tuple(model), group="mesh"),
             Knob("pipe", (1,), group="mesh")]
    return ConfigSpace(f"serving[{cfg.name}|{shape.name}]", knobs,
                       (KV_HEADS_DIVISIBLE, KV_BLOCK_LEGAL, KV_QUANT_LEGAL,
                        KV_RETAIN_LEGAL, mesh_budget(max_devices)))


def hillclimb_space(
        mesh_shape: Optional[Mapping[str, int]] = None) -> ConfigSpace:
    """The perf-hillclimbing lattice: the WSMC plan knobs plus the
    beyond-paper levers the old launch/hillclimb.py VARIANTS dict hand-rolled
    (one-hot embedding, EP, DP-replicated weights, attention block sizes,
    MoE routing group). The first value of each knob is the baseline;
    `repro_torch.search.strategies.greedy_coordinate` walks one knob at a time.
    `mesh_shape` pins the (fixed) mesh the candidates are scored against."""
    knobs = [
        Knob("remat", REMATS),
        Knob("microbatches", MICROBATCHES),
        Knob("optimizer", OPTIMIZERS),
        Knob("kv_shard", ("heads", "seq")),
        Knob("embed_onehot", (True, False), group="extra"),
        Knob("moe_group", (2048, 512, 1024), group="extra"),
        Knob("q_block", (512, 256, 1024), group="extra"),
        Knob("kv_block", (1024, 256), group="extra"),
        Knob("repeat_kv", (None, True, False), group="extra"),
        Knob("gather_weights", (False, True), group="extra"),
        Knob("ep", (None, True, False), group="extra"),
        Knob("fsdp", (True, False), group="extra"),
    ]
    knobs += _mesh_knobs(mesh_shape or {})
    return ConfigSpace("hillclimb", knobs, (MICRO_DIVIDES_BATCH,))
