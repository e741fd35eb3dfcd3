"""Config system: model architecture descriptions and workload shapes.

A model is described as a *pattern* of heterogeneous blocks (attention /
mLSTM / sLSTM / RG-LRU, dense-MLP / MoE) repeated over depth, mirroring how
the assigned architectures interleave block kinds (e.g. gemma3's 5 local : 1
global, recurrentgemma's (rec, rec, attn) unit). The repeated *unit* is the
lax.scan step; a `tail` covers non-divisible depths.

Configs are pure data (no torch import), so importing a config never touches
device state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block descriptors
# ---------------------------------------------------------------------------

# Mixer kinds (sequence-mixing half of a block).
ATTN = "attn"          # softmax attention (GQA); window=None => global
MLSTM = "mlstm"        # xLSTM matrix-LSTM (outer-product state)
SLSTM = "slstm"        # xLSTM scalar-LSTM
RGLRU = "rglru"        # RecurrentGemma real-gated linear recurrent unit

# MLP kinds (channel-mixing half). NONE for xLSTM blocks (mixer includes it).
MLP_NONE = "none"
MLP_DENSE = "dense"
MLP_MOE = "moe"


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer block: a sequence mixer + a channel mixer."""
    mixer: str = ATTN
    mlp: str = MLP_DENSE
    # Attention locality: None => global; int => sliding window radius.
    window: Optional[int] = None
    # Chunked ("block-local") attention à la Llama-4 iRoPE: tokens attend only
    # within their chunk of size `chunk`. Mutually exclusive with window.
    chunk: Optional[int] = None
    # Use rotary embeddings for this block (global NoPE layers in llama4 skip).
    rope: bool = True

    @property
    def is_attn(self) -> bool:
        return self.mixer == ATTN

    @property
    def is_recurrent(self) -> bool:
        return self.mixer in (MLSTM, SLSTM, RGLRU)

    def cache_len(self, seq_len: int) -> int:
        """KV cache length this block needs at `seq_len` context (decode)."""
        if not self.is_attn:
            return 0  # recurrent state instead
        if self.window is not None:
            return min(self.window, seq_len)
        if self.chunk is not None:
            return min(self.chunk, seq_len)
        return seq_len


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # Depth pattern: `unit` repeated `repeats` times then `tail` blocks.
    unit: Tuple[BlockSpec, ...] = ()
    tail: Tuple[BlockSpec, ...] = ()
    head_dim: Optional[int] = None   # default d_model // n_heads
    activation: str = "swiglu"       # swiglu | geglu | gelu | squared_relu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # xLSTM
    mlstm_proj_factor: float = 2.0
    mlstm_qk_blocksize: int = 4      # block-diagonal q/k projection block size
    mlstm_conv_width: int = 4
    slstm_ff_factor: float = 4.0 / 3.0
    # RG-LRU
    lru_width: Optional[int] = None
    conv_width: int = 4
    # Embedding / misc
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    logits_softcap: Optional[float] = None
    # Modality frontend stubs (DESIGN.md §4): number of prepended embedding
    # positions provided pre-computed by input_specs() (vlm patches / audio
    # frames). 0 for text-only.
    n_prefix_embeds: int = 0
    param_dtype: str = "bfloat16"

    def __post_init__(self):
        n_pattern = len(self.unit) * self.repeats + len(self.tail)
        if self.unit and n_pattern != self.n_layers:
            raise ValueError(
                f"{self.name}: pattern covers {n_pattern} layers != n_layers={self.n_layers}")

    @property
    def repeats(self) -> int:
        if not self.unit:
            return 0
        return (self.n_layers - len(self.tail)) // len(self.unit)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded to a multiple of 16 so the embedding/head shard
        evenly on the model axis (Megatron-style padding; e.g. InternVL2's
        92553 -> 92560). Logits over pad columns are ordinary (never-target)
        classes."""
        return -(-self.vocab_size // 16) * 16

    @property
    def slstm_ff_dim(self) -> int:
        """sLSTM GLU width rounded to a multiple of 16 (shardable)."""
        return -(-int(self.slstm_ff_factor * self.d_model) // 16) * 16

    @property
    def q_group(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def blocks(self) -> Tuple[BlockSpec, ...]:
        """The full depth-ordered block list."""
        return tuple(self.unit) * self.repeats + tuple(self.tail)

    def has_subquadratic_context(self) -> bool:
        """True if no block needs a full-length quadratic attention prefill.

        Decode over a long cache is linear per step even for global layers, but
        the assignment spec mandates skipping long_500k for *pure* full
        attention archs: those where every attention block is global.
        """
        attn_blocks = [b for b in self.blocks() if b.is_attn]
        if not attn_blocks:
            return True
        return any(b.window is not None or b.chunk is not None for b in attn_blocks)

    # -- reduced config for CPU smoke tests -------------------------------
    def reduced(self) -> "ModelConfig":
        """Same family/pattern, tiny dims: one unit repeat, small widths."""
        tail = self.tail[: min(len(self.tail), 2)]
        n_layers = len(self.unit) + len(tail)
        scale = lambda v, lo, hi: max(lo, min(hi, v))
        d_model = 64
        n_heads = scale(min(self.n_heads, 4), 2, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        small_unit = tuple(
            dataclasses.replace(b,
                                window=None if b.window is None else 8,
                                chunk=None if b.chunk is None else 8)
            for b in self.unit)
        small_tail = tuple(
            dataclasses.replace(b,
                                window=None if b.window is None else 8,
                                chunk=None if b.chunk is None else 8)
            for b in tail)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=512,
            unit=small_unit,
            tail=small_tail,
            n_experts=0 if self.n_experts == 0 else 4,
            top_k=0 if self.top_k == 0 else min(self.top_k, 2),
            lru_width=None if self.lru_width is None else 64,
            n_prefix_embeds=0 if self.n_prefix_embeds == 0 else 4,
        )


def depth_variant(cfg: ModelConfig, n_units: int) -> "ModelConfig":
    """cfg with the unit pattern repeated `n_units` times — the depth-1/2
    probes the roofline extrapolates from."""
    return dataclasses.replace(
        cfg, n_layers=n_units * len(cfg.unit) + len(cfg.tail))


# ---------------------------------------------------------------------------
# Workload shapes (assigned): every arch × each of these = one dry-run cell
# ---------------------------------------------------------------------------

TRAIN = "train"
PREFILL = "prefill"
DECODE = "decode"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        # Tokens processed per step: decode steps emit one token per sequence.
        return self.global_batch * (1 if self.kind == DECODE else self.seq_len)

    @property
    def context(self) -> int:
        """Context length (cache extent for decode, seq for train/prefill)."""
        return self.seq_len


SHAPES = {
    "train_4k": ShapeConfig("train_4k", TRAIN, 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", PREFILL, 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", DECODE, 32_768, 128),
    "long_500k": ShapeConfig("long_500k", DECODE, 524_288, 1),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason). long_500k skips pure full-attention archs."""
    if shape.name == "long_500k" and not cfg.has_subquadratic_context():
        return False, ("skip: pure full-attention arch — long_500k requires "
                       "sub-quadratic attention (DESIGN.md §4)")
    return True, ""


# ---------------------------------------------------------------------------
# Input specs ((shape, dtype-name) tuples; no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Abstract input description for the step function of (cfg, shape).

    Returns a dict of plain `(shape, dtype-name)` tuples (the counterpart of
    the reference package's ShapeDtypeStructs: nothing is allocated).
    Modality frontends are stubs: for vlm/audio archs the spec includes
    precomputed prefix embeddings. Caches for decode are built by the
    runtime (they mirror params layout).
    """
    b = shape.global_batch
    # Modality-stub archs: the prefix embeddings occupy the first
    # n_prefix_embeds positions of the context; text tokens fill the rest.
    text_len = shape.seq_len - (cfg.n_prefix_embeds if shape.kind != DECODE else 0)
    if shape.kind == TRAIN:
        specs = {
            "tokens": ((b, text_len), "int32"),
            "targets": ((b, text_len), "int32"),
        }
    elif shape.kind == PREFILL:
        specs = {"tokens": ((b, text_len), "int32")}
    else:  # DECODE: one new token against a cache of shape.seq_len
        specs = {
            "tokens": ((b, 1), "int32"),
            "positions": ((b,), "int32"),
        }
    if cfg.n_prefix_embeds and shape.kind != DECODE:
        specs["prefix_embeds"] = (
            (b, cfg.n_prefix_embeds, cfg.d_model), "bfloat16")
    return specs


# ---------------------------------------------------------------------------
# Analytic parameter count (closed-form; cross-checked by eval_shape in tests)
# ---------------------------------------------------------------------------

def block_param_count(cfg: ModelConfig, blk: BlockSpec) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    n = 0
    if blk.mixer == ATTN:
        q = cfg.n_heads * hd
        kv = cfg.n_kv_heads * hd
        n += d * q + 2 * d * kv + q * d          # q, k, v, o
        n += d                                    # pre-norm
    elif blk.mixer == MLSTM:
        inner = int(cfg.mlstm_proj_factor * d)
        n += d * 2 * inner                        # up (x and z-gate branches)
        n += cfg.mlstm_conv_width * inner         # causal depthwise conv
        n += 2 * inner * cfg.mlstm_qk_blocksize   # block-diagonal q, k
        n += 2 * (inner * cfg.n_heads + cfg.n_heads)   # i, f gate projections
        n += inner * d                            # down
        n += d + inner                            # pre-norm + head groupnorm
    elif blk.mixer == SLSTM:
        hd_ = d // cfg.n_heads
        n += 4 * d * d                            # input gates (z, i, f, o)
        n += cfg.n_heads * hd_ * 4 * hd_          # block-diag recurrent gates
        n += 4 * d                                # biases
        ff = cfg.slstm_ff_dim
        n += d * 2 * ff + ff * d                  # GLU ff
        n += 2 * d                                # norms
    elif blk.mixer == RGLRU:
        w = cfg.lru_width or d
        n += d * 2 * w                            # x/gate in-projections
        n += cfg.conv_width * w                   # depthwise conv
        n += 2 * w                                # recurrence + input gates (diag)
        n += w * d                                # out projection
        n += d
    if blk.mlp == MLP_DENSE:
        mult = 2 if cfg.activation in ("swiglu", "geglu") else 1
        n += d * mult * cfg.d_ff + cfg.d_ff * d
        n += d
    elif blk.mlp == MLP_MOE:
        mult = 2 if cfg.activation in ("swiglu", "geglu") else 1
        n += cfg.n_experts * (d * mult * cfg.d_ff + cfg.d_ff * d)
        n += d * cfg.n_experts                    # router
        n += d
    return n


def param_count(cfg: ModelConfig) -> int:
    n = cfg.padded_vocab_size * cfg.d_model       # embedding
    for blk in cfg.blocks():
        n += block_param_count(cfg, blk)
    n += cfg.d_model                              # final norm
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.padded_vocab_size  # lm head
    return n


def active_param_count(cfg: ModelConfig) -> int:
    """Per-token active params (MoE: only top_k experts count)."""
    if not cfg.is_moe:
        return param_count(cfg)
    n = param_count(cfg)
    mult = 2 if cfg.activation in ("swiglu", "geglu") else 1
    per_expert = cfg.d_model * mult * cfg.d_ff + cfg.d_ff * cfg.d_model
    n_moe_blocks = sum(1 for b in cfg.blocks() if b.mlp == MLP_MOE)
    n -= n_moe_blocks * (cfg.n_experts - cfg.top_k) * per_expert
    return n


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N_active·D (+ attention context term).

    The input-embedding table does no matmul work (gather), so it is
    excluded; tied embeddings keep the table once (it is the head matmul).
    """
    n_active = active_param_count(cfg)
    if not cfg.tie_embeddings:
        n_active -= cfg.padded_vocab_size * cfg.d_model  # lookup-only table
    mult = 3.0 if shape.kind == TRAIN else 1.0           # fwd + 2x bwd
    flops = 2.0 * n_active * shape.tokens * mult
    # Attention score/value FLOPs (not in 2N·D): 4·kv_per_q·H·hd per token.
    hd = cfg.resolved_head_dim
    s = shape.seq_len
    for blk in cfg.blocks():
        if not blk.is_attn:
            continue
        if shape.kind == DECODE:
            kv_per_q = blk.cache_len(shape.context)
        else:
            w = blk.window if blk.window is not None else blk.chunk
            if w is None or w >= s:
                kv_per_q = (s + 1) / 2.0                 # plain causal
            elif blk.chunk is not None:
                kv_per_q = (w + 1) / 2.0                 # causal per chunk
            else:                                        # sliding window
                kv_per_q = (w * (w + 1) / 2.0 + (s - w) * w) / s
        flops += (4.0 * kv_per_q * cfg.n_heads * hd) * shape.tokens * mult
    return flops
