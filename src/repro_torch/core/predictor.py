"""Capacity prediction model — paper Eqs. 6-11 mapped to the TPU memory
model (DESIGN.md §2). Every term is "retrievable" (closed-form from config
and sharding) except the transient slope, which the online profiler fits
from the small-shape ladder — exactly the paper's split between config
parameters and the profiled Data Expansion Ratio.

Two transient modes:
  paper  — Eq. 6 verbatim: pred_temp = factor_shuf(category) × Data_input
  fitted — beyond-paper: slope·Data_input + intercept from the ladder fit,
           with the category factor replaced by a 15% safety margin.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch import hw as HW
from repro_torch.configs.base import (DECODE, PREFILL, TRAIN, ModelConfig,
                                ShapeConfig, block_param_count, param_count)
from repro_torch.core.classifier import Classification
from repro_torch.core.expansion import BYTES_ACT, embedded_input_bytes

BYTES_PARAM = 2       # bf16 params
BYTES_GRAD_ACC = 4    # f32 gradient accumulator
BYTES_TOKEN = 4       # int32 ids

# Empirical remat transient scalers (validated in benchmarks/fig2): fraction
# of the no-remat transient that survives under each policy.
REMAT_SCALE = {"none": 1.0, "dots": 0.55, "full": 0.30}
FITTED_SAFETY = 1.15

# Paged-KV storage codecs: bytes per K/V element under each kv_quant mode.
# The dtype is EXPLICIT here (not inferred from the model dtype) so the
# predictor, the allocator's byte ledger, and the pool layout in
# runtime/serve_step.init_paged_pool can never silently disagree. int4
# packs two elements per byte (head_dim is even on every config).
KV_QUANTS = ("none", "int8", "int4")
KV_ELEM_BYTES = {"none": float(BYTES_ACT), "int8": 1.0, "int4": 0.5}
KV_SCALE_BYTES = 4    # f32 absmax scale per (position, kv head), K and V each


def kv_elem_bytes(kv_quant: str) -> float:
    """Bytes per stored K/V element for a kv_quant mode (excl. scales)."""
    if kv_quant not in KV_ELEM_BYTES:
        raise ValueError(f"unknown kv_quant {kv_quant!r}; known: {KV_QUANTS}")
    return KV_ELEM_BYTES[kv_quant]


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """The configuration surface the planner searches (the analogue of
    spark.executor.memory + parallelism knobs)."""
    remat: str = "none"              # none | dots | full
    microbatches: int = 1
    optimizer: str = "adamw_f32"     # adamw_f32 | adamw_bf16 | adafactor
    kv_shard: str = "heads"          # heads | seq
    # Paged-KV serving: positions per KV block (0 = whole-sequence ring
    # slots). Only full-context attention layers page; the block size is the
    # allocation granule the serving engine's BlockAllocator hands out.
    kv_block_size: int = 0
    # Paged-pool storage codec: "none" (bf16), "int8" or "int4" — per-token
    # per-head absmax scales stored alongside the pool. A quantized block is
    # a CHEAPER block, multiplying serving_block_capacity directly.
    kv_quant: str = "none"
    # Block-granular retention: keep at most this many attended KV blocks
    # per sequence (0 = keep all). The engine evicts the coldest blocks back
    # to the allocator free list, so a sequence's steady-state footprint is
    # bounded by kv_retain + 1 blocks (retained + the growing tail block).
    kv_retain: int = 0

    def __post_init__(self):
        if self.kv_quant not in KV_QUANTS:
            raise ValueError(f"MemoryPlan.kv_quant {self.kv_quant!r} not in "
                             f"{KV_QUANTS}")
        if self.kv_retain < 0:
            raise ValueError("MemoryPlan.kv_retain must be >= 0, got "
                             f"{self.kv_retain}")

    @property
    def opt_state_bytes(self) -> float:
        return {"adamw_f32": 8.0, "adamw_bf16": 4.0,
                "adafactor": 0.05}[self.optimizer]

    def step_time_penalty(self) -> float:
        """Relative step-time cost (roofline-validated ordering): remat
        recomputes ~the forward pass; microbatching adds per-step overhead;
        adafactor adds reduction work."""
        remat_pen = {"none": 1.0, "dots": 1.18, "full": 1.33}[self.remat]
        micro_pen = 1.0 + 0.015 * max(self.microbatches.bit_length() - 1, 0)
        opt_pen = {"adamw_f32": 1.0, "adamw_bf16": 1.0,
                   "adafactor": 1.03}[self.optimizer]
        return remat_pen * micro_pen * opt_pen


@dataclasses.dataclass(frozen=True)
class CapacityPrediction:
    resident_bytes: float
    transient_bytes: float
    capacity_bytes: float            # Eq. 11
    fits: bool
    hbm_bytes: float

    @property
    def utilization(self) -> float:
        return self.capacity_bytes / self.hbm_bytes


def mesh_factors(mesh_shape: dict) -> Tuple[int, int, int]:
    """(weight_shards, dp_size, model_size) from a mesh {axis: size} dict.
    A "pipe" axis splits the layer stack across pipeline stages, so each
    device holds 1/pipe of the weights — it multiplies the shard count."""
    data = mesh_shape.get("data", 1)
    model = mesh_shape.get("model", 1)
    pod = mesh_shape.get("pod", 1)
    pipe = mesh_shape.get("pipe", 1)
    return data * model * pipe, pod * data, model


def _attn_ring_bytes(cfg: ModelConfig, plan: MemoryPlan, L: int,
                     model: int, kv_quant: str = "none") -> float:
    """One sequence's ring-cache bytes for an attention layer of ring
    length L, per device under the plan's kv sharding. `kv_quant` names the
    storage codec EXPLICITLY (only the paged pool quantizes; lane rings and
    ring-slot engines stay bf16), so element size is never inferred from
    the model dtype."""
    hd = cfg.resolved_head_dim
    if plan.kv_shard == "seq":
        L = -(-L // model)
        kvh = cfg.n_kv_heads
    else:
        kvh = -(-cfg.n_kv_heads // model)      # padded uneven sharding
    eb = kv_elem_bytes(kv_quant)
    # f32 absmax scale per (position, kv head) for K and V each
    scales = 0.0 if kv_quant == "none" else 2 * kvh * KV_SCALE_BYTES
    return 2 * L * kvh * hd * eb + L * scales + L * 4     # K/V + pos buffer


def _seq_cache_terms(cfg: ModelConfig, shape: ShapeConfig, plan: MemoryPlan,
                     mesh_shape: dict) -> Tuple[float, float]:
    """(paged_bytes, lane_bytes) for ONE decoding sequence, per device.

    `paged_bytes` is the full-context attention state the paged KV pool can
    allocate block-by-block (layers whose ring spans the whole context);
    `lane_bytes` is everything a sequence pins for its whole lifetime
    regardless of progress: recurrent states and short windowed/chunked
    rings (cheap, fixed-size — paging them would buy nothing).
    """
    _, _, model = mesh_factors(mesh_shape)
    paged = lane = 0.0
    for blk in cfg.blocks():
        if blk.is_attn:
            L = blk.cache_len(shape.context)
            full = L == shape.context
            # full-context layers live in the (possibly quantized) paged
            # pool when the plan pages; short windowed rings stay bf16
            quant = plan.kv_quant if (full and plan.kv_block_size) else "none"
            bytes_ = _attn_ring_bytes(cfg, plan, L, model, kv_quant=quant)
            if full:
                paged += bytes_
            else:
                lane += bytes_
        elif blk.mixer == "mlstm":
            inner = int(cfg.mlstm_proj_factor * cfg.d_model)
            dh = inner // cfg.n_heads
            lane += cfg.n_heads * (dh * dh + dh + 1) * 4
            lane += (cfg.mlstm_conv_width - 1) * inner * BYTES_ACT
        elif blk.mixer == "slstm":
            lane += 4 * cfg.d_model * 4
        elif blk.mixer == "rglru":
            w = cfg.lru_width or cfg.d_model
            lane += w * 4
            lane += (cfg.conv_width - 1) * w * BYTES_ACT
    # pipeline stages each hold the caches of their own 1/pipe of the layers
    pipe = max(int(mesh_shape.get("pipe", 1)), 1)
    return paged / pipe, lane / pipe


def cache_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                           plan: MemoryPlan, mesh_shape: dict) -> float:
    """Decode-resident state: ring KV caches + recurrent states (Eq. 7's
    'data kept in Storage Memory' for the serving stages)."""
    if shape.kind != DECODE:
        return 0.0
    _, dp, _ = mesh_factors(mesh_shape)
    batch_per = max(shape.global_batch // dp, 1)
    paged, lane = _seq_cache_terms(cfg, shape, plan, mesh_shape)
    return batch_per * (paged + lane)


def kv_block_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                              plan: MemoryPlan, mesh_shape: dict) -> float:
    """Bytes of ONE paged KV block per device: `kv_block_size` positions of
    K/V (+ the pos stripe) across every full-context attention layer, under
    the plan's kv sharding. The block-size term of the paper's requirement
    model made first-class: a sequence's paged footprint is
    ceil(written_positions / kv_block_size) of these, instead of a
    whole-context ring."""
    if plan.kv_block_size < 1:
        raise ValueError("kv_block_bytes_per_device needs "
                         f"plan.kv_block_size >= 1, got {plan.kv_block_size}")
    _, _, model = mesh_factors(mesh_shape)
    pipe = max(int(mesh_shape.get("pipe", 1)), 1)
    total = 0.0
    for blk in cfg.blocks():
        if blk.is_attn and blk.cache_len(shape.context) == shape.context:
            total += _attn_ring_bytes(cfg, plan, plan.kv_block_size, model,
                                      kv_quant=plan.kv_quant)
    return total / pipe


def lane_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                          plan: MemoryPlan, mesh_shape: dict) -> float:
    """Per-active-sequence fixed bytes under paged KV: the non-paged cache
    state one decode lane pins (recurrent states, short windowed rings)."""
    _, lane = _seq_cache_terms(cfg, shape, plan, mesh_shape)
    return lane


def sharded_param_count(cfg: ModelConfig, mesh_shape: dict) -> float:
    """Per-device parameter count under the mesh. The pipe axis splits only
    the stacked unit layers (what the 1F1B runtime's split_stages owns);
    embedding, head, final norm and tail blocks are replicated across
    stages — validated against the executed pipeline's compile-measured
    residents."""
    shards, _, _ = mesh_factors(mesh_shape)      # data * model * pipe
    n = param_count(cfg)
    pipe = max(int(mesh_shape.get("pipe", 1)), 1)
    if pipe == 1:
        return n / shards
    unit_n = sum(block_param_count(cfg, b) for b in cfg.unit) * cfg.repeats
    return unit_n / shards + (n - unit_n) / (shards // pipe)


def pipeline_would_execute(cfg: ModelConfig, plan: MemoryPlan,
                           mesh_shape: dict,
                           global_batch: Optional[int] = None) -> bool:
    """Whether a pipe>1 mesh actually runs the 1F1B schedule for this
    (cfg, plan, batch). Shares runtime.schedule_kinds.pipeline_executable
    with validate_pipeline and launch.compile's fallback: non-executable
    probes (micro < pipe, MoE units, indivisible repeats, prefix embeds,
    TP in play, batch/dp indivisible) fall back to scan/single on the same
    mesh, and the memory model must follow. schedule_kinds is jax-free, so
    this import keeps the compile-free planning path light."""
    from repro_torch.runtime.schedule_kinds import pipeline_executable
    return pipeline_executable(cfg, plan.microbatches, mesh_shape,
                               global_batch)


def resident_bytes(cfg: ModelConfig, shape: ShapeConfig, plan: MemoryPlan,
                   mesh_shape: dict) -> float:
    """Eq. 7 analogue: everything that must sit in HBM before the first
    'stage' runs — params, optimizer state, grad accumulator, inputs, caches."""
    _, dp, _ = mesh_factors(mesh_shape)
    n_per = sharded_param_count(cfg, mesh_shape)
    total = n_per * BYTES_PARAM
    if shape.kind == TRAIN:
        total += n_per * plan.opt_state_bytes
        if (plan.microbatches > 1
                and not pipeline_would_execute(cfg, plan, mesh_shape,
                                               shape.global_batch)):
            # the scan schedule carries an f32 gradient accumulator; the
            # 1F1B pipeline schedule accumulates inside the pipelined
            # backward instead, so no extra resident
            total += n_per * BYTES_GRAD_ACC
    batch_per = max(shape.global_batch // dp, 1)
    toks = batch_per * (1 if shape.kind == DECODE else shape.seq_len)
    total += toks * BYTES_TOKEN * (2 if shape.kind == TRAIN else 1)
    if cfg.n_prefix_embeds and shape.kind != DECODE:
        total += batch_per * cfg.n_prefix_embeds * cfg.d_model * BYTES_ACT
    total += cache_bytes_per_device(cfg, shape, plan, mesh_shape)
    return total


def transient_bytes(cfg: ModelConfig, shape: ShapeConfig, plan: MemoryPlan,
                    cls: Classification, mesh_shape: dict,
                    mode: str = "paper",
                    factors: Optional[dict] = None) -> float:
    """Eq. 6: the shuffle-data prediction, per device, for the plan's
    microbatch slice. The profiled α/slope is per *stage* (expansion.py);
    live stages multiply back in — remat controls how many residual sets
    survive, microbatching shrinks the per-stage slice. The classification
    comes from the baseline plan; knobs apply analytically."""
    _, dp, _ = mesh_factors(mesh_shape)
    data_input = embedded_input_bytes(cfg, shape, 0, dp)
    per_micro = data_input / max(plan.microbatches, 1)
    n_stages = cfg.n_layers
    pipe = int(mesh_shape.get("pipe", 1))
    if pipe > 1:
        # each pipeline stage holds 1/pipe of the layers, with up to `pipe`
        # microbatches in flight (1F1B) keeping their activations live
        n_stages = -(-cfg.n_layers // pipe) * min(max(plan.microbatches, 1),
                                                  pipe)
    if mode == "paper":
        # Eq. 6 per stage. The factor table is the paper's Table III —
        # *calibrated on this platform* by the offline phase when available
        # (the paper likewise derived {4,3,2,1} empirically on SparkBench).
        factor = cls.factor
        if factors:
            factor = factors.get(cls.category.value,
                                 factors.get(cls.category, factor))
        pred = factor * per_micro * n_stages
    elif mode == "fitted":
        pred = (cls.slope * per_micro + cls.intercept) * FITTED_SAFETY
    else:
        raise ValueError(mode)
    if shape.kind == TRAIN:
        pred *= REMAT_SCALE[plan.remat]
    return pred


PREFILL_KERNELS = ("dense", "tiled")


def prefill_transient_bytes(cfg: ModelConfig, shape: ShapeConfig,
                            plan: MemoryPlan, cls: Classification,
                            mesh_shape: dict, *, prefill_tokens: int,
                            reach: int, width: int = 1,
                            kernel: str = "dense", mode: str = "paper",
                            factors: Optional[dict] = None) -> float:
    """Transient of one chunked-prefill tick appending `prefill_tokens`
    prompt positions (summed over the `width` mid-prefill lanes the token
    budget admits) that attend up to `reach` earlier positions.

    Both kernels pay Eq. 6 on the chunk itself (a prefill-shaped input of
    `prefill_tokens` positions). The DENSE jnp path additionally
    materializes, per full-context attention layer step, the f32 score
    matrix (q_heads × tokens × reach) plus a dequantized fp gather of each
    lane's attended ring (reach × kv_heads × head_dim) — O(tokens × reach)
    HBM the tiled flash kernel never allocates: it streams K/V block tiles
    through VMEM with an online softmax, so its only extra state is
    O(tokens × head_dim) accumulators, already inside the Eq. 6 term.
    Layers run sequentially (lax.scan body), so one layer's score matrix
    is live at the peak, not n_layers of them.
    """
    if kernel not in PREFILL_KERNELS:
        raise ValueError(f"unknown prefill kernel {kernel!r}; known: "
                         f"{PREFILL_KERNELS}")
    _, dp, model = mesh_factors(mesh_shape)
    sh_p = dataclasses.replace(shape, kind=PREFILL, global_batch=dp,
                               seq_len=max(int(prefill_tokens), 1))
    base = transient_bytes(cfg, sh_p, plan, cls, mesh_shape, mode, factors)
    if kernel == "tiled":
        return base
    qh = -(-cfg.n_heads // model)
    kvh = -(-cfg.n_kv_heads // model)
    hd = cfg.resolved_head_dim
    scores = qh * prefill_tokens * reach * 4.0
    gathered = max(int(width), 1) * reach * kvh * hd * 4.0
    return base + scores + gathered


def predict(cfg: ModelConfig, shape: ShapeConfig, plan: MemoryPlan,
            cls: Classification, mesh_shape: dict, mode: str = "paper",
            hw: HW.HardwareSpec = HW.TPU_V5E,
            factors: Optional[dict] = None) -> CapacityPrediction:
    res = resident_bytes(cfg, shape, plan, mesh_shape)
    tra = transient_bytes(cfg, shape, plan, cls, mesh_shape, mode, factors)
    cap = HW.capacity_from_requirement(res, tra, hw)     # Eq. 11
    return CapacityPrediction(resident_bytes=res, transient_bytes=tra,
                              capacity_bytes=cap, fits=cap <= hw.hbm_bytes,
                              hbm_bytes=hw.hbm_bytes)


def serving_capacity(cfg: ModelConfig, shape: ShapeConfig, plan: MemoryPlan,
                     cls: Classification, mesh_shape: dict,
                     mode: str = "paper", hw: HW.HardwareSpec = HW.TPU_V5E,
                     hbm_budget: Optional[float] = None,
                     factors: Optional[dict] = None,
                     max_per_device: int = 1 << 16) -> int:
    """Eq. 11 run backwards: the serving-side inverse of `predict`.

    The forward model answers "how much memory does a workload of batch B
    need?"; online serving asks the inverse — "given this HBM budget, how
    many concurrent sequences can be admitted?". Because every batch-scaled
    term (KV/recurrent caches via cache_bytes_per_device, token inputs,
    decode transients) is monotone in the per-device batch, the inverse is
    an exact search over whole per-device sequence slots: the largest
    `per` whose predicted capacity (resident + transient, Eq. 11 headroom
    included) still fits `hbm_budget`. Returns the GLOBAL concurrent
    sequence count (per-device slots x dp); 0 if even one sequence per
    device does not fit.
    """
    budget = hw.hbm_bytes if hbm_budget is None else float(hbm_budget)
    _, dp, _ = mesh_factors(mesh_shape)

    def fits(per: int) -> bool:
        sh = dataclasses.replace(shape, kind=DECODE, global_batch=per * dp)
        pred = predict(cfg, sh, plan, cls, mesh_shape, mode, hw, factors)
        return pred.capacity_bytes <= budget

    if not fits(1):
        return 0
    lo, hi = 1, 2
    while hi < max_per_device and fits(hi):
        lo, hi = hi, hi * 2
    if hi >= max_per_device:
        if fits(max_per_device):             # saturated: report the cap
            return max_per_device * dp
        hi = max_per_device
    while hi - lo > 1:                       # invariant: fits(lo), not fits(hi)
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo * dp


def serving_block_capacity(cfg: ModelConfig, shape: ShapeConfig,
                           plan: MemoryPlan, cls: Classification,
                           mesh_shape: dict, *, lanes: int = 1,
                           mode: str = "paper",
                           hw: HW.HardwareSpec = HW.TPU_V5E,
                           hbm_budget: Optional[float] = None,
                           factors: Optional[dict] = None,
                           avg_context: Optional[int] = None,
                           decode_width: Optional[int] = None,
                           admission: str = "optimistic",
                           prefill_tokens: int = 0,
                           prefill_kernel: str = "dense",
                           prefill_width: int = 1,
                           max_per_device: int = 1 << 22) -> int:
    """Eq. 11 run backwards over KV BLOCKS instead of whole-sequence slots.

    `serving_capacity` answers "how many worst-case sequences fit?" — every
    admitted sequence is charged a full-context ring. Under paged KV the
    question splits: `lanes` decode lanes pin their fixed per-sequence state
    (recurrent caches, short windowed rings, token buffers, decode
    transients at batch = lanes), and the remaining budget holds KV blocks
    of `plan.kv_block_size` positions each. Because the block term is
    monotone, the inverse is an exact doubling + bisection search over
    whole per-device blocks. Returns the GLOBAL block count (per-device
    blocks x dp); 0 if the lanes alone do not fit.

    `avg_context` is the expected attended context per lane (the trace's
    mean written length): paged decode reads the cache THROUGH block
    tables, so a lane's transient working set is the blocks it actually
    allocated, not the pool-wide max context the ring engine's padded
    decode streams. Defaults to worst-case `shape.context`.

    `decode_width` models lane compaction: a compacting engine runs its
    decode step at the bucketed width covering the ACTIVE lanes, so the
    step transient scales with that width, not the pool width — lane-fixed
    resident state stays charged at `lanes` above. Defaults to `lanes`
    (full-width decode).

    `admission` names the engine reservation discipline the inversion
    assumes. "optimistic" (default, matches every pre-existing call site)
    honors the workload-specific `avg_context` / `decode_width` discounts
    — the expected-occupancy inversion that pairs with
    `BlockAllocator(reservation="expected")` and eviction-on-miss.
    "worst" charges the transient at full context and pool width
    regardless, the deadlock-free-by-construction sizing for
    `reservation="worst"` engines where a prediction miss has no eviction
    path to fall back on.

    `prefill_tokens` > 0 makes the prefill transient a first-class term:
    a chunked engine's ticks alternate decode steps with prefill chunks
    of up to that many prompt tokens (the engine's token budget, spread
    over `prefill_width` lanes), and the charged transient is the MAX of
    the two — whichever tick shape peaks governs the headroom Eq. 11
    must hold back. `prefill_kernel` picks the prefill cost model:
    "dense" charges the O(tokens × context) score matrix the jnp SDPA
    fallback materializes; "tiled" the fused flash-prefill kernel's
    O(tokens × d) working set (see prefill_transient_bytes) — at tight
    budgets the tiled term frees headroom that converts into more
    admitted blocks/lanes.
    """
    if plan.kv_block_size < 1:
        raise ValueError("serving_block_capacity needs a paged plan "
                         f"(kv_block_size >= 1, got {plan.kv_block_size})")
    if lanes < 1:
        raise ValueError(f"serving_block_capacity needs lanes >= 1 "
                         f"(got {lanes})")
    if admission not in ("optimistic", "worst"):
        raise ValueError(f"unknown admission mode {admission!r}; known: "
                         "('optimistic', 'worst')")
    if admission == "worst":
        avg_context = None
        decode_width = None
    budget = hw.hbm_bytes if hbm_budget is None else float(hbm_budget)
    _, dp, _ = mesh_factors(mesh_shape)
    sh = dataclasses.replace(shape, kind=DECODE, global_batch=lanes * dp)
    # resident minus the ring-cache term the block pool replaces
    base = (resident_bytes(cfg, sh, plan, mesh_shape)
            - cache_bytes_per_device(cfg, sh, plan, mesh_shape))
    base += lanes * lane_bytes_per_device(cfg, sh, plan, mesh_shape)
    sh_t = sh
    b = plan.kv_block_size
    reach = shape.context
    if avg_context is not None:
        # block-align the expected reach; never beyond the worst case
        reach = min(-(-max(int(avg_context), 1) // b) * b, shape.context)
    if plan.kv_retain > 0:
        # block-granular retention bounds the attended context
        # DETERMINISTICALLY (the engine never holds more than kv_retain
        # live blocks plus the growing tail), so the cap applies even
        # under worst-case admission
        reach = min(reach, (plan.kv_retain + 1) * b)
    if reach != shape.context:
        sh_t = dataclasses.replace(sh_t, seq_len=reach)
    if decode_width is not None:
        w = min(max(int(decode_width), 1), lanes)
        sh_t = dataclasses.replace(sh_t, global_batch=w * dp)
    tra = transient_bytes(cfg, sh_t, plan, cls, mesh_shape, mode, factors)
    if prefill_tokens > 0:
        tra = max(tra, prefill_transient_bytes(
            cfg, shape, plan, cls, mesh_shape,
            prefill_tokens=int(prefill_tokens), reach=reach,
            width=prefill_width, kernel=prefill_kernel,
            mode=mode, factors=factors))
    per_block = kv_block_bytes_per_device(cfg, sh, plan, mesh_shape)

    def fits(nb: int) -> bool:
        cap = HW.capacity_from_requirement(base + nb * per_block, tra, hw)
        return cap <= budget

    if per_block <= 0.0:                     # no full-context attn layers
        return (max_per_device * dp) if fits(0) else 0
    if not fits(1):
        return 0
    lo, hi = 1, 2
    while hi < max_per_device and fits(hi):
        lo, hi = hi, hi * 2
    if hi >= max_per_device:
        if fits(max_per_device):             # saturated: report the cap
            return max_per_device * dp
        hi = max_per_device
    while hi - lo > 1:                       # invariant: fits(lo), not fits(hi)
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo * dp


def min_devices(cfg: ModelConfig, shape: ShapeConfig, plan: MemoryPlan,
                cls: Classification, mode: str = "paper",
                hw: HW.HardwareSpec = HW.TPU_V5E,
                model_parallel: int = 16) -> int:
    """Eq. 9 analogue (Num_ex): the smallest device count whose per-device
    capacity fits — the elastic-scaling entry point."""
    for dp in (1, 2, 4, 8, 16, 32, 64, 128):
        mesh_shape = {"data": dp, "model": model_parallel}
        if predict(cfg, shape, plan, cls, mesh_shape, mode, hw).fits:
            return dp * model_parallel
    return -1
