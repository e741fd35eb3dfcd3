"""Core layers: norms, dense projections, rotary embeddings, activations,
embedding / LM head. Plain functions over tensors and dicts of tensors.

Compute convention (the reference package's): params in cfg.param_dtype
(bf16), projection matmuls in the working dtype, norms / softmax / logits in
f32. Random initialisers take an explicit `torch.Generator` and `device`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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
    """N(0, INIT_STD) drawn in f32 from `gen`, stored in `dtype`. A leading
    stacking axis (len(shape) == 3) is filled slice by slice so that the f32
    draw of a full-width stacked leaf never exists whole."""
    if len(shape) == 3:
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
# Embedding / head
# ---------------------------------------------------------------------------

def embed_init(gen, cfg, device):
    return {"table": _normal(gen, (cfg.padded_vocab_size, cfg.d_model),
                             _dtype(cfg), device)}


def embed_lookup(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding as a row gather (the reference package's one-hot
    matmul form computes exactly the same rows; it exists there for the
    sake of a sharded table)."""
    table = params["table"]
    x = table[tokens.long()]
    # gemma-style scale, applied in the table's dtype
    return x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


# vocab rows upcast at a time by lm_head: bounds the f32 copy of the table
_HEAD_SLICE = 16384


def lm_head(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: [b, s, d] -> logits [b, s, V] in f32 (f32 accumulation AND f32
    output, so near-ties in the argmax are not decided by a bf16 rounding
    of the logits). The table is upcast a slice of vocab rows at a time."""
    table = params["table"]
    xf = x.float()
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
    return logits
