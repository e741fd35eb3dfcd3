"""Core layers: norms, dense projections, rotary embeddings, activations,
embedding / LM head. Plain functions over tensors and dicts of tensors.

Compute convention (the reference package's): params in cfg.param_dtype
(bf16), projection matmuls in the working dtype, norms / softmax / logits in
f32. Random initialisers take an explicit `torch.Generator` and `device`.

Tensor parallelism (serving and training over a mesh's "model" axis):
inside `parallel.comm.model_axis` a row-parallel projection's weight and
the embedding table are this rank's shards of the axis in force (the
mesh's checks make the rows split over it; a weight whose rows disagree
with the axis raises), and each combines the pieces over that axis's
group. A row-parallel projection (`out_proj`) sums f32 partial products and rounds
once to the activation dtype, as one rank's matmul rounds its f32
accumulator once; a vocab-sharded table embeds by a masked row gather and
a sum, and its LM head takes its input through `comm.tp_enter` and
gathers the f32 logits along the vocab. The collectives carry their own
gradients (`parallel.comm`), so the cross entropy of the gathered logits
trains every rank's shards.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel import comm

INIT_STD = 0.02

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name) -> torch.dtype:
    """A torch dtype from a config's dtype name (or a dtype, unchanged)."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


def _dtype(cfg) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def _normal(gen, shape, dtype, device) -> torch.Tensor:
    """N(0, INIT_STD) drawn in f32 from `gen`, stored in `dtype`. A leaf of
    three or more axes (a stacking axis, an expert axis) is filled slice by
    slice along its leading axis, so that the f32 draw of a full-width
    stacked leaf never exists whole. On the meta device (shapes only)
    nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if len(shape) >= 3:
        out = torch.empty(shape, dtype=dtype, device=device)
        for r in range(shape[0]):
            out[r] = _normal(gen, shape[1:], dtype, device)
        return out
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * INIT_STD).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device,
               repeats: int = 0) -> torch.Tensor:
    """[in_dim, out_dim] projection weights ([repeats, in_dim, out_dim] when
    `repeats` > 0: the stacked-over-repeats layout of the unit pattern)."""
    shape = (in_dim, out_dim) if not repeats else (repeats, in_dim, out_dim)
    return _normal(gen, shape, torch_dtype(dtype), device)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Projection matmul over the last axis of x, output in x.dtype."""
    return torch.matmul(x, w)


def _check_shard(w: torch.Tensor, rows: int, what: str) -> None:
    """Raises unless `w` holds its share of the whole weight's `rows` rows
    over the model axis in force (all of them outside one)."""
    m = comm.model_size()
    if w.shape[0] * m != rows:
        raise ValueError(f"{what}: {w.shape[0]} rows on a model axis of {m}, "
                         f"the whole weight has {rows}")


def out_proj(x: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
    """x @ w, where the full weight has `rows` rows. Inside a model axis w
    is this rank's rows of a row-parallel projection (x holds the matching
    columns): its f32 partial product is summed over the axis and rounded
    once to x's dtype (two bf16 partials summed would round twice)."""
    _check_shard(w, rows, "row-parallel projection")
    if comm.model_size() == 1:
        return matmul(x, w)
    part = torch.matmul(x.float(), w.float())
    return comm.tp_sum(part).to(x.dtype)


def einsum_f32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Einsum with f32 accumulation and f32 output (inputs upcast)."""
    return torch.einsum(spec, a.float(), b.float())


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device, repeats: int = 0) -> torch.Tensor:
    shape = (d,) if not repeats else (repeats, d)
    return torch.zeros(shape, dtype=torch_dtype(dtype), device=device)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMS norm (weight is 1 + scale), computed in f32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def groupnorm_heads(scale: torch.Tensor, x: torch.Tensor, n_heads: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS groupnorm over the trailing dim reshaped to heads."""
    b, s, inner = x.shape
    xf = x.float().reshape(b, s, n_heads, inner // n_heads)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).reshape(b, s, inner)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def squared_relu(x):
    r = F.relu(x)
    return r * r


def _gelu(x):
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu": _gelu,
    "silu": F.silu,
    "squared_relu": squared_relu,
}


def glu_combine(activation: str, gate: torch.Tensor,
                up: torch.Tensor) -> torch.Tensor:
    if activation == "swiglu":
        return F.silu(gate.float()).to(up.dtype) * up
    if activation == "geglu":
        return _gelu(gate.float()).to(up.dtype) * up
    raise ValueError(activation)


def is_glu(activation: str) -> bool:
    return activation in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [b, s, h, hd]; positions: [b, s] int32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    freqs = torch.as_tensor(freqs.astype(np.float32), device=x.device)
    angles = positions.float()[..., None] * freqs            # [b, s, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Causal depthwise conv (recurrent blocks) — supports streaming decode
# ---------------------------------------------------------------------------

def conv1d_init(width: int, channels: int, dtype, device,
                repeats: int = 0) -> torch.Tensor:
    shape = (width, channels) if not repeats else (repeats, width, channels)
    return torch.full(shape, 1.0 / width, dtype=torch_dtype(dtype),
                      device=device)


def causal_conv1d(w: torch.Tensor, x: torch.Tensor, state=None,
                  valid_len=None):
    """Depthwise causal conv. x: [b, s, c]; state: [b, width-1, c] history.

    The taps are elementwise products summed in x's dtype, one rounding per
    operation as in the reference package (no F.conv1d: cuDNN would run it
    in TF32 on the card).

    `valid_len` [b] marks rows whose trailing positions are padding
    (serving chunked prefill): the carried history then ends at the last
    VALID input. valid_len == s reproduces the default carry; valid_len ==
    0 passes `state` through unchanged.

    Returns (y [b, s, c], new_state [b, width-1, c])."""
    width = w.shape[0]
    s = x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for i in range(width):  # width is tiny (4): unrolled taps
        y = y + w[i].to(x.dtype) * xp[:, i:i + s]
    if width <= 1:
        new_state = state
    elif valid_len is None:
        new_state = xp[:, s:]
    else:
        # window of width-1 inputs ending at the last valid position: xp
        # rows are [state (width-1) | x (s)], so it starts at valid_len
        idx = valid_len.long()[:, None] + torch.arange(
            width - 1, device=x.device)
        new_state = torch.gather(xp, 1,
                                 idx[..., None].expand(-1, -1, xp.shape[2]))
    return y, new_state


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_init(gen, cfg, device):
    return {"table": _normal(gen, (cfg.padded_vocab_size, cfg.d_model),
                             _dtype(cfg), device)}


def embed_lookup(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding as a row gather (the reference package's one-hot
    matmul form computes exactly the same rows; it exists there for the
    sake of a sharded table). Inside a model axis the table is this
    rank's rows of the padded vocab: it gathers the tokens it holds, zeros
    elsewhere, and sums over the axis (one row and zeros: exact)."""
    table = params["table"]
    rows = table.shape[0]
    if comm.model_size() == 1:
        x = table[tokens.long()]
    else:
        _check_shard(table, cfg.padded_vocab_size, "embedding table")
        idx = tokens.long() - comm.model_rank() * rows
        hit = (idx >= 0) & (idx < rows)
        x = torch.where(hit[..., None], table[idx.clamp(0, rows - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
        x = comm.tp_sum(x, kind="tp_embed")
    # gemma-style scale, applied in the table's dtype
    return x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


# vocab rows upcast at a time by lm_head: bounds the f32 copy of the table
_HEAD_SLICE = 16384


def lm_head(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: [b, s, d] -> logits [b, s, V] in f32 (f32 accumulation AND f32
    output, so near-ties in the argmax are not decided by a bf16 rounding
    of the logits). The table is upcast a slice of vocab rows at a time.
    Inside a model axis the table is vocab-sharded: this rank computes (and
    soft-caps) its columns, then gathers the axis's along the vocab, in
    coordinate order, so the argmax of the gathered logits keeps one
    rank's first-index rule on ties. There x enters through
    `comm.tp_enter`: its gradient is the sum of the ranks' columns'."""
    table = params["table"]
    xf = comm.tp_enter(x).float()
    V = table.shape[0]
    if V <= _HEAD_SLICE:
        logits = torch.matmul(xf, table.float().t())
    else:
        logits = torch.cat(
            [torch.matmul(xf, table[i:i + _HEAD_SLICE].float().t())
             for i in range(0, V, _HEAD_SLICE)], dim=-1)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    if comm.model_size() > 1:
        _check_shard(table, cfg.padded_vocab_size, "LM head")
        logits = comm.tp_gather_last(logits)
    return logits


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token NLL. logits [b, s, V] f32, targets [b, s] int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
