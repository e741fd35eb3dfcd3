"""Pluggable memory-measurement backends (the paper's two cost regimes).

The paper's pitch is that WSMC predicts a workload's memory requirement
*without* exhaustively running candidate configurations; the expensive
alternative it replaces is run-and-measure per candidate. This module
makes that split explicit as a `MemoryMeasurer` interface with two
interchangeable backends:

  CudaMeasurer       — the ground truth on the card: run one step of the
                       shape's kind on the CUDA device and read the caching
                       allocator's bytes (memory_allocated before the step,
                       max_memory_allocated over it). One step per point
                       (seconds each, the first building the kernels). It
                       takes the place of the reference package's
                       CompileMeasurer, which reads XLA's memory analysis
                       of a compiled step; a PyTorch step has nothing to
                       compile ahead of time.
  SimulatedMeasurer  — closed-form analytical estimation from
                       ModelConfig × ShapeConfig × MemoryPlan × mesh:
                       params / optimizer-state / grad-accum residents and
                       decode caches via predictor.resident_bytes, plus a
                       per-stage activation-transient model under each
                       remat / microbatch setting. Zero compiles,
                       microseconds per point — this is what lets the
                       profile → classify → predict → plan pipeline run
                       over hundreds of workload × mesh × plan cells
                       (and lets the fast test tier be hermetic).

Both backends produce the same `expansion.MemoryProfile` record, so every
consumer (profiler ladder, classifier, planner, dry-run, benchmarks) is
backend-agnostic. An on-disk `ProfileCache` keyed by
(arch, shape, plan, mesh, backend) makes repeated ladder points free.
"""
from __future__ import annotations

import abc
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, Optional

from repro_torch.configs.base import (DECODE, MLP_DENSE, MLP_MOE, PREFILL,
                                      TRAIN, ModelConfig, ShapeConfig)
from repro_torch.core import expansion as E
from repro_torch.core import predictor as PR
from repro_torch.core.predictor import MemoryPlan

# The baseline profiling plan: the slope is measured here and the planner
# scales it analytically for other knob settings (predictor.transient_bytes).
BASELINE_PLAN = MemoryPlan(remat="none", microbatches=1,
                           optimizer="adamw_f32")

# bf16 metric/loss scalars + softmax statistics kept in f32.
BYTES_F32 = 4

MeshLike = Dict[str, int]   # a plain {axis: size} dict


def mesh_shape_of(mesh: MeshLike) -> Dict[str, int]:
    """A copy of an {axis: size} mesh description (measurement plans on
    mesh sizes; the measurer itself runs on one card)."""
    if not isinstance(mesh, dict):
        raise TypeError(f"mesh must be an {{axis: size}} dict, got "
                        f"{type(mesh).__name__}")
    return dict(mesh)


def n_devices_of(mesh_shape: Dict[str, int]) -> int:
    n = 1
    for v in mesh_shape.values():
        n *= int(v)
    return n


def dp_size_of(mesh_shape: Dict[str, int]) -> int:
    dp = 1
    for ax in ("pod", "data"):
        dp *= int(mesh_shape.get(ax, 1))
    return dp


# ---------------------------------------------------------------------------
# On-disk profile cache
# ---------------------------------------------------------------------------

def profile_key(backend: str, cfg: ModelConfig, shape: ShapeConfig,
                plan: MemoryPlan, mesh_shape: Dict[str, int],
                settings_tag: str = "default") -> str:
    """Stable cache key over everything that determines a profile."""
    mesh_tag = ",".join(f"{k}={v}" for k, v in sorted(mesh_shape.items()))
    plan_tag = (f"{plan.remat}|m{plan.microbatches}|{plan.optimizer}"
                f"|kv={plan.kv_shard}")
    arch_tag = f"{cfg.name}@{cfg.n_layers}x{cfg.d_model}"
    shape_tag = f"{shape.kind}|s{shape.seq_len}|b{shape.global_batch}"
    return "::".join((backend, arch_tag, shape_tag, plan_tag, mesh_tag,
                      settings_tag))


class ProfileCache:
    """Write-through JSON cache of MemoryProfiles.

    One file; entries keyed by profile_key(). Safe to share between the
    profiler ladder, the dry-run, and benchmarks — a ladder point measured
    once is free everywhere after.
    """

    VERSION = 1

    def __init__(self, path: str):
        self.path = path
        self.hits = 0
        self.misses = 0
        self._data: Dict[str, dict] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    payload = json.load(f)
                if payload.get("version") == self.VERSION:
                    self._data = payload.get("profiles", {})
            except (OSError, ValueError):
                self._data = {}

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str) -> Optional[E.MemoryProfile]:
        entry = self._data.get(key)
        if entry is not None:
            try:
                prof = E.MemoryProfile(**entry)
            except TypeError:       # schema drifted under the same version
                self._data.pop(key, None)
            else:
                self.hits += 1
                return prof
        self.misses += 1
        return None

    def put(self, key: str, profile: E.MemoryProfile) -> None:
        self._data[key] = dataclasses.asdict(profile)
        self._flush()

    def _flush(self) -> None:
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": self.VERSION, "profiles": self._data},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise


# ---------------------------------------------------------------------------
# The measurer interface
# ---------------------------------------------------------------------------

class MemoryMeasurer(abc.ABC):
    """One measurement backend bound to one mesh.

    measure() is the single entry point every WSMC consumer goes through;
    the cache wraps it transparently.
    """

    backend: str = "?"
    # Extra cache-key discriminator for measurer-level knobs the plan/settings
    # don't carry (e.g. the simulator's EP mode).
    key_suffix: str = ""

    def __init__(self, mesh: MeshLike, cache: Optional[ProfileCache] = None):
        self.mesh = mesh
        self.mesh_shape = mesh_shape_of(mesh)
        self.cache = cache

    def measure(self, cfg: ModelConfig, shape: ShapeConfig,
                plan: MemoryPlan = BASELINE_PLAN,
                settings=None) -> E.MemoryProfile:
        tag = "default" if settings is None else repr(settings)
        key = profile_key(self.backend, cfg, shape, plan, self.mesh_shape,
                          tag + self.key_suffix)
        if self.cache is not None:
            hit = self.cache.get(key)
            if hit is not None:
                return hit
        prof = self._measure(cfg, shape, plan, settings)
        if self.cache is not None:
            self.cache.put(key, prof)
        return prof

    @abc.abstractmethod
    def _measure(self, cfg: ModelConfig, shape: ShapeConfig,
                 plan: MemoryPlan, settings) -> E.MemoryProfile:
        ...

    def measure_peak(self, cfg: ModelConfig, shape: ShapeConfig,
                     plan: MemoryPlan, settings=None) -> float:
        """Static peak bytes/device — the oracle planner's verification
        quantity (argument + transient + output)."""
        return self.measure(cfg, shape, plan, settings).peak_bytes

    def peak_fn(self, cfg: ModelConfig, shape: ShapeConfig,
                settings=None) -> Callable[[MemoryPlan], float]:
        """Adapter for planner.oracle_plan's `measure(plan)` callable."""
        return lambda plan: self.measure_peak(cfg, shape, plan, settings)


class CudaMeasurer(MemoryMeasurer):
    """Ground-truth backend on the card: one step per point (expensive).

    Runs one step of the shape's kind on the CUDA device — a train step
    under the plan's remat, microbatches and optimizer; a prefill step; a
    decode step over a ring cache of the shape's context — with params,
    optimizer state, cache and inputs placed on the card first. It reads
    `torch.cuda.memory_allocated()` before the step and
    `max_memory_allocated()` over it (after `reset_peak_memory_stats()`),
    and the bytes still allocated after it (the step's outputs):

      argument  = the bytes of the placed tensors,
      output    = allocated after - allocated before,
      transient = peak - allocated before - output.

    One set of random params per config is kept across the points of a
    ladder (`release()` frees it); a train step updates it in place.
    Measures on one card, or over a {model: M} mesh inside a process group
    of exactly M ranks (`group`: the mesh's model group): each rank runs
    its shard's prefill, decode or train step (its params cut by
    `sharding.init_local_params` under the default strategy, a MoE arch's
    experts under EP where they tile the axis, else TP inside the
    experts; its cache at n_kv_heads / M heads, its
    optimizer state over its shards, the step inside `comm.model_axis`:
    a train step is tensor-parallel forward and backward), and every
    reading is reduced with max
    over the ranks before anything classifies it, so every rank reaches
    the same class and plan. The serving knobs of a paged plan
    (kv_block_size > 0) are not measured — the predictor plans them.
    Raises on anything but a CUDA device: there is no fallback to the
    simulator. `steps` and `step_seconds` count the steps run and their
    wall time (placing inputs included), for a CLI's planning report.
    """

    backend = "cuda"
    steps, step_seconds = 0, 0.0
    group = None                    # the model group of a model axis
    # (shape, plan, this rank's readings, the readings reduced over the
    # ranks) of every step measured: argument, transient, output, peak
    records = ()

    def __init__(self, mesh: Optional[MeshLike] = None,
                 cache: Optional[ProfileCache] = None, device="cuda",
                 group=None):
        import torch
        mesh = {"data": 1} if mesh is None else mesh
        shape = mesh_shape_of(mesh)
        model = int(shape.get("model", 1))
        if n_devices_of(shape) != model:
            raise NotImplementedError(
                f"CudaMeasurer measures on one card or over a model axis, "
                f"not a mesh of {n_devices_of(shape)} devices {shape} "
                "(measuring over a data axis is not ported: ROADMAP queue "
                "A item 5)")
        if model > 1:
            import torch.distributed as dist
            if group is None or dist.get_world_size(group) != model:
                raise NotImplementedError(
                    f"CudaMeasurer over {shape} needs the mesh's model "
                    f"group of {model} ranks (a mesh without one is not "
                    "measured: ROADMAP queue A item 5)")
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"CudaMeasurer measures on a CUDA device, not "
                             f"{dev}; SimulatedMeasurer estimates without "
                             "one")
        if not torch.cuda.is_available():
            raise RuntimeError("CudaMeasurer: torch.cuda.is_available() is "
                               "False")
        super().__init__(mesh, cache)
        self.device = dev
        self.group = group if model > 1 else None
        self._params = None         # (cfg, params) kept across a ladder

    def _mesh(self):
        """This rank's {data: 1, model: M} launch.mesh.Mesh over `group`."""
        import torch.distributed as dist
        from repro_torch.launch import mesh as LM
        m = int(self.mesh_shape.get("model", 1))
        return LM.Mesh(axis_names=("data", "model"),
                       shape={"data": 1, "model": m},
                       coords={"data": 0, "model": dist.get_rank(self.group)},
                       groups={"model": self.group})

    def params_for(self, cfg: ModelConfig):
        """The random params of `cfg` on the card (this rank's shards over
        a model axis), made once per config."""
        if self._params is None or self._params[0] != cfg:
            import torch
            from repro_torch.models import model as M
            self.release()
            gen = torch.Generator(device=self.device).manual_seed(0)
            if self.group is None:
                params = M.init_params(gen, cfg, device=self.device)
            else:
                from repro_torch.parallel import sharding as S
                from repro_torch.runtime import schedule as SCH
                mesh = self._mesh()
                SCH.check_serving_mesh(cfg, mesh.shape)
                specs = S.param_specs(cfg, M.init_params(None, cfg,
                                                         device="meta"),
                                      S.default_strategy(cfg, mesh), mesh)
                params = S.init_local_params(gen, cfg, self.device, specs,
                                             mesh)
                self._specs = specs
            self._params = (cfg, params)
        return self._params[1]

    def release(self) -> None:
        """Free the kept params (and the allocator's cached blocks)."""
        import torch
        self._params = None
        torch.cuda.empty_cache()

    def _measure(self, cfg, shape, plan, settings) -> E.MemoryProfile:
        t0 = time.time()
        mine = [float(v) for v in self._readings(cfg, shape, plan,
                                                  settings)]
        readings = mine
        if self.group is not None:
            import torch
            from repro_torch.parallel import comm
            readings = [float(v) for v in comm.all_reduce(
                torch.tensor(mine, dtype=torch.float64,
                             device=self.device), self.group,
                op="max", kind="measure")]
        self.records = [*self.records, (shape, plan, mine, readings)]
        argument, transient, output, peak = readings
        self.steps += 1
        self.step_seconds += time.time() - t0
        n = n_devices_of(self.mesh_shape)
        return E.profile_from_measured(
            cfg, shape, argument, transient, output, peak, n,
            dp_size_of(self.mesh_shape))

    def _readings(self, cfg, shape, plan, settings):
        """(argument, transient, output, peak) bytes of one step on this
        rank's card."""
        # Lazy: keep core.measure importable without the model / runtime
        # stack (the simulator path never needs it).
        import torch
        from repro_torch.core import profiler as PF
        from repro_torch.models import model as M
        from repro_torch.optim import optimizers as OPT
        from repro_torch.parallel import comm
        from repro_torch.runtime import schedule as SCH
        from repro_torch.runtime import serve_step as SS
        from repro_torch.tree import tree_leaves
        if plan.kv_block_size > 0:
            raise NotImplementedError(
                "CudaMeasurer runs ring-cache decode; paged plans "
                "(kv_block_size > 0) are sized by the predictor")
        dev = self.device
        model = int(self.mesh_shape.get("model", 1))
        params = self.params_for(cfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        b, s = shape.global_batch, shape.seq_len

        def tokens(rows, cols):
            return torch.randint(0, cfg.vocab_size, (rows, cols),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)

        # the reference's input layout (configs.base.input_specs): a
        # modality-stub arch takes prefix embeddings [b, n_prefix, d] in
        # bf16 before seq - n_prefix text tokens
        n_pre = cfg.n_prefix_embeds
        prefix = ({"prefix_embeds": torch.randn(
            (b, n_pre, cfg.d_model), generator=gen, device=dev).to(
                torch.bfloat16)} if n_pre and shape.kind != DECODE else {})
        if shape.kind == TRAIN:
            tcfg = PF._tcfg_for(plan, settings)
            placed = {"opt": OPT.init_state(tcfg.optimizer, params),
                      "batch": {"tokens": tokens(b, s - n_pre),
                                "targets": tokens(b, s - n_pre), **prefix}}
            train = (SCH.make_train_step(cfg, tcfg) if self.group is None
                     else SCH.make_train_step(cfg, tcfg, mesh=self._mesh(),
                                              spec_tree=self._specs))

            def step():
                return train(params, placed["opt"], placed["batch"], 0)
        elif shape.kind == PREFILL:
            placed = {"tokens": tokens(b, s - n_pre), **prefix}
            prefill = SS.make_prefill_step(cfg, settings)

            def step():
                return prefill(params, placed["tokens"], context=s,
                               prefix_embeds=placed.get("prefix_embeds"))
        elif shape.kind == DECODE:
            placed = {"cache": M.init_cache(cfg, b, shape.context,
                                            device=dev,
                                            model_parallel=model),
                      "tokens": tokens(b, 1),
                      "positions": torch.full((b,), shape.context - 1,
                                              dtype=torch.int32, device=dev)}
            decode = SS.make_decode_step(cfg, settings)

            def step():
                return decode(params, placed["tokens"], placed["positions"],
                              placed["cache"], context=shape.context)
        else:
            raise ValueError(f"unknown shape kind {shape.kind!r}")
        argument = sum(t.numel() * t.element_size()
                       for t in tree_leaves([params, placed])
                       if isinstance(t, torch.Tensor))
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with comm.model_axis(self.group):
            out = step()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        output = max(torch.cuda.memory_allocated(dev) - before, 0)
        del out, placed
        transient = max(peak - before - output, 0)
        return argument, transient, output, argument + peak - before


class SimulatedMeasurer(MemoryMeasurer):
    """Analytical backend: closed-form MemoryProfile, zero compiles.

    Residents come from predictor.resident_bytes (params, optimizer state,
    grad accumulator, token inputs, decode KV/recurrent caches — Eq. 7);
    transients from the per-stage activation model below (Eq. 4's numerator),
    scaled by the plan's remat/microbatch knobs exactly as the capacity
    predictor assumes. Takes a plain {axis: size} dict — no device
    required.

    Mesh axes understood: data/pod (DP), model (TP), and pipe (pipeline
    stages: weights and caches split across stages, 1F1B in-flight
    microbatches keep activations live). `ep=True` models expert-parallel
    MoE sharding (all-to-all dispatch/combine buffers instead of
    intra-expert TP) — a Strategy-level knob the plan doesn't carry, so it
    lives on the measurer and discriminates the cache key.
    """

    backend = "simulate"

    def __init__(self, mesh: MeshLike, cache: Optional[ProfileCache] = None,
                 ep: bool = False):
        super().__init__(mesh, cache)
        self.ep = bool(ep)
        if self.ep:
            self.key_suffix = "|ep"

    def _measure(self, cfg, shape, plan, settings) -> E.MemoryProfile:
        ms = self.mesh_shape
        resident = PR.resident_bytes(cfg, shape, plan, ms)
        transient = simulated_transient_bytes(cfg, shape, plan, ms,
                                              ep=self.ep)
        output = simulated_output_bytes(cfg, shape, ms)
        n_dev = n_devices_of(ms)
        return E.MemoryProfile(
            arch=cfg.name,
            shape_name=shape.name,
            kind=shape.kind,
            n_devices=n_dev,
            seq_len=shape.seq_len,
            global_batch=shape.global_batch,
            n_stages=cfg.n_layers,
            input_bytes=E.embedded_input_bytes(cfg, shape, n_dev,
                                               dp_size_of(ms)),
            argument_bytes=resident,
            transient_bytes=transient,
            output_bytes=output,
            reported_peak=resident + transient + output,
        )


def measurer_for(backend: str, mesh: MeshLike,
                 cache: Optional[ProfileCache] = None) -> MemoryMeasurer:
    """Factory: 'cuda' measures on the card (a mesh of one device);
    'simulate' takes any {axis: size} dict."""
    if backend == "cuda":
        return CudaMeasurer(mesh, cache=cache)
    if backend == "simulate":
        return SimulatedMeasurer(mesh, cache=cache)
    raise ValueError(f"unknown measurement backend: {backend!r}")


# ---------------------------------------------------------------------------
# The analytical transient model
# ---------------------------------------------------------------------------

def _tokens_per_device(cfg: ModelConfig, shape: ShapeConfig,
                       mesh_shape: Dict[str, int]) -> float:
    dp = dp_size_of(mesh_shape)
    batch_per = max(shape.global_batch // dp, 1)
    return float(batch_per * (1 if shape.kind == DECODE else shape.seq_len))


def block_transient_bytes(cfg: ModelConfig, blk, toks: float,
                          shape: ShapeConfig,
                          mesh_shape: Dict[str, int],
                          ep: bool = False) -> float:
    """Live activation bytes one block materializes for `toks` tokens on one
    device (bf16 unless noted). This is the simulator's per-stage unit: the
    same quantity expansion.MemoryProfile.stage_transient_bytes estimates
    from a compile."""
    _, _, model = PR.mesh_factors(mesh_shape)
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    A = E.BYTES_ACT
    # Fusion/collective scratch floor (size-independent; dominates only at
    # smoke scale) + residual stream in + post-mixer out.
    total = SCRATCH_PER_BLOCK + 2.0 * toks * d * A
    if blk.is_attn:
        q = cfg.n_heads * hd / model
        kv = cfg.n_kv_heads * hd / model
        total += toks * (q + 2 * kv + q) * A           # q, k, v, attn-out
        # Score/probability rows (softmax stats in f32): each query attends
        # kv_len keys. This is the superlinear term that makes full-attention
        # training Expanding.Rapid (Table II) while windowed/chunked and
        # recurrent mixers stay linear.
        if shape.kind == DECODE:
            kv_len = blk.cache_len(shape.context)
        else:
            kv_len = blk.cache_len(shape.seq_len)
        total += toks * kv_len * (cfg.n_heads / model) * A
    elif blk.mixer == "mlstm":
        inner = int(cfg.mlstm_proj_factor * d)
        # up/z projections + conv + gate pre-activations + down input
        total += toks * (2 * inner + inner) / max(model, 1) * A
        total += toks * 2 * cfg.n_heads * BYTES_F32     # i/f gate scalars
        if shape.kind != DECODE:
            # chunkwise-parallel scan: per-chunk decay/gate matrices
            # (chunk × chunk per head, f32) — toks/chunk chunks of them.
            total += toks * MLSTM_CHUNK * cfg.n_heads * BYTES_F32
    elif blk.mixer == "slstm":
        total += toks * (4 * d + 2 * cfg.slstm_ff_dim / max(model, 1)) * A
    elif blk.mixer == "rglru":
        w = cfg.lru_width or d
        total += toks * (3 * w) / max(model, 1) * A     # x, gate, conv
    if blk.mlp == MLP_DENSE and cfg.d_ff:
        mult = 2 if cfg.activation in ("swiglu", "geglu") else 1
        total += toks * (mult + 1) * cfg.d_ff / model * A
    elif blk.mlp == MLP_MOE:
        mult = 2 if cfg.activation in ("swiglu", "geglu") else 1
        routed = toks * cfg.top_k * cfg.capacity_factor
        # Per-device expert activations are the same bytes either way:
        # intra-expert TP shards d_ff over `model`; EP keeps d_ff whole but
        # each device serves only routed/model tokens (capacity-balanced).
        total += routed * (mult + 1) * cfg.d_ff / model * A
        total += toks * cfg.n_experts * BYTES_F32       # router logits
        if ep:
            # EP adds the all-to-all dispatch + combine buffers: the routed
            # token slices at model width, in and out.
            total += 2 * (routed / max(model, 1)) * d * A
    return total


def head_transient_bytes(cfg: ModelConfig, toks: float,
                         mesh_shape: Dict[str, int], kind: str) -> float:
    """LM-head logits + softmax statistics (once per step, not per stage).
    Training keeps the f32 loss row alongside the bf16 logits."""
    _, _, model = PR.mesh_factors(mesh_shape)
    logits = toks * cfg.padded_vocab_size / model
    per = E.BYTES_ACT + (BYTES_F32 if kind == TRAIN else 0)
    return logits * per


# How many stages' activations are simultaneously live. Training keeps every
# layer's residuals for BPTT (remat then scales them down); inference frees
# layer-by-layer, so only ~2 stages (current + in-flight next) are resident.
INFERENCE_LIVE_STAGES = 2.0
# The backward pass holds activation *gradients* mirroring the forward
# residuals (plus f32 accumulation scratch) — empirically ~1x the live
# forward set on top of it (validated against memory_analysis() in the
# parity tests).
TRAIN_BWD_SCALE = 2.0
# mLSTM chunkwise-parallel scan chunk length (ModelSettings.mlstm_chunk
# default; the simulator has no per-call settings dependence).
MLSTM_CHUNK = 128
# Per-block XLA fusion/collective scratch floor.
SCRATCH_PER_BLOCK = 48 * 1024


def simulated_transient_bytes(cfg: ModelConfig, shape: ShapeConfig,
                              plan: MemoryPlan,
                              mesh_shape: Dict[str, int],
                              ep: bool = False) -> float:
    """Per-device XLA-temp estimate for (cfg, shape) under `plan`."""
    toks_full = _tokens_per_device(cfg, shape, mesh_shape)
    toks = toks_full
    if shape.kind == TRAIN:
        toks /= max(plan.microbatches, 1)
    per_block = [block_transient_bytes(cfg, b, toks, shape, mesh_shape, ep)
                 for b in cfg.blocks()]
    toks_head = toks
    if shape.kind == TRAIN:
        pipe = int(mesh_shape.get("pipe", 1))
        if PR.pipeline_would_execute(cfg, plan, mesh_shape,
                                     shape.global_batch):
            # the executed 1F1B schedule (runtime.schedule) remats each
            # stage body per tick, so what stays live is ONE stage's
            # recompute set (1/pipe of the UNIT stack) plus the scan-saved
            # boundary carries (one inter-stage activation per tick) —
            # validated against the compiled pipeline step on fake devices.
            # Tail blocks, norm, head and the loss run OUTSIDE the stages
            # on the FULL batch (runtime.schedule.make_pipeline_loss_fn),
            # so they keep full-batch token scaling.
            micro = max(plan.microbatches, 1)
            n_unit = len(cfg.unit) * cfg.repeats
            unit_live = (sum(per_block[:n_unit])
                         * PR.REMAT_SCALE[plan.remat] * TRAIN_BWD_SCALE
                         / pipe)
            tail_live = sum(
                block_transient_bytes(cfg, b, toks_full, shape, mesh_shape,
                                      ep)
                for b in cfg.tail) * TRAIN_BWD_SCALE
            live = (unit_live + tail_live
                    + (micro + pipe - 1) * toks * cfg.d_model * E.BYTES_ACT)
            toks_head = toks_full
        else:
            # flat scan/single schedule (also the compile fallback for
            # probe plans a pipe mesh cannot pipeline)
            live = (sum(per_block) * PR.REMAT_SCALE[plan.remat]
                    * TRAIN_BWD_SCALE)
        # plus the remat-recompute scratch of the block currently in bwd
        live += max(per_block, default=0.0)
    else:
        live = max(per_block, default=0.0) * INFERENCE_LIVE_STAGES
        if shape.kind == DECODE:
            # ring-cache update: XLA materializes the updated cache before
            # the donation alias kicks in — a transient copy of the cache.
            live += PR.cache_bytes_per_device(cfg, shape, plan, mesh_shape)
    return live + head_transient_bytes(cfg, toks_head, mesh_shape,
                                       shape.kind)


def simulated_output_bytes(cfg: ModelConfig, shape: ShapeConfig,
                           mesh_shape: Dict[str, int]) -> float:
    """Non-aliased step outputs. Train donates params/opt-state (aliased)
    and returns scalars; prefill returns logits + a freshly built cache;
    decode donates its cache and returns one token row of logits."""
    _, dp, model = PR.mesh_factors(mesh_shape)
    batch_per = max(shape.global_batch // dp, 1)
    if shape.kind == TRAIN:
        return 64.0 * BYTES_F32                        # metric scalars
    logits_rows = batch_per * (1 if shape.kind == DECODE else shape.seq_len)
    out = logits_rows * cfg.padded_vocab_size / model * E.BYTES_ACT
    if shape.kind != DECODE:
        # prefill emits the filled cache as a fresh output
        decode_like = dataclasses.replace(shape, kind=DECODE)
        out += PR.cache_bytes_per_device(cfg, decode_like, BASELINE_PLAN,
                                         mesh_shape)
    return out
