"""Recurrent sequence mixers: xLSTM's mLSTM and sLSTM blocks, and Griffin's
RG-LRU block (recurrentgemma-9b).

- mLSTM uses the chunkwise-parallel form (kernels/ops.mlstm_scan: the
  hand-written CUDA scan on the card, or its plain version): dense products
  within chunks, a compact f32 state across them.
- sLSTM has a genuinely nonlinear recurrence (h feeds the gates) and runs as
  a Python loop over time steps, as the reference package's lax.scan does
  (no TPU kernel there, so none here).
- RG-LRU's gated diagonal recurrence is linear in h: a log-step associative
  scan in plain torch (the reference package has no kernel for it either).

The mixers are functional like the reference package's: they return the
residual increment and a NEW state dict (None without a state), and never
write the state passed in; models.model.block_apply copies the new state
into the cache in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers

Shapes = Dict[str, Tuple[tuple, torch.dtype]]


def _zeros(shapes: Shapes, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(sh, dtype=dt, device=device)
            for k, (sh, dt) in shapes.items()}


def _stacked(shape, repeats: int) -> tuple:
    return tuple(shape) if not repeats else (repeats,) + tuple(shape)


# ===========================================================================
# mLSTM block (xLSTM)
# ===========================================================================

def mlstm_init(gen, cfg: ModelConfig, device, repeats: int = 0):
    """The reference package's leaves and dtypes: projections in
    cfg.param_dtype, the gate projections and biases in f32."""
    d = cfg.d_model
    inner = int(cfg.mlstm_proj_factor * d)
    bs = cfg.mlstm_qk_blocksize
    nb = inner // bs
    dt = layers.torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    H = cfg.n_heads
    return {
        "norm": layers.rmsnorm_init(d, dt, device, repeats),
        "w_up": layers.dense_init(gen, d, 2 * inner, dt, device, repeats),
        "conv": layers.conv1d_init(cfg.mlstm_conv_width, inner, dt, device,
                                   repeats),
        "wq": layers._normal(gen, _stacked((nb, bs, bs), repeats), dt,
                             device),
        "wk": layers._normal(gen, _stacked((nb, bs, bs), repeats), dt,
                             device),
        "w_i": layers.dense_init(gen, inner, H, f32, device, repeats),
        "b_i": torch.zeros(_stacked((H,), repeats), dtype=f32,
                           device=device),
        "w_f": layers.dense_init(gen, inner, H, f32, device, repeats),
        "b_f": torch.full(_stacked((H,), repeats), 3.0, dtype=f32,
                          device=device),                # open forget gates
        "gnorm": layers.rmsnorm_init(inner, dt, device, repeats),
        "w_down": layers.dense_init(gen, inner, d, dt, device, repeats),
    }


def _blockdiag(x, w):
    """x [..., nb*bs] @ block-diagonal w [nb, bs, bs]."""
    nb, bs, _ = w.shape
    xs = x.reshape(tuple(x.shape[:-1]) + (nb, bs))
    y = torch.einsum("...nb,nbc->...nc", xs, w.to(x.dtype))
    return y.reshape(x.shape)


def mlstm_state_shapes(cfg: ModelConfig, batch: int) -> Shapes:
    """A lane's mLSTM state: C, n, m in f32 (16.8 MB of C per lane and
    layer at xlstm-1.3b's 4 heads x 1024), the conv tail in bf16."""
    inner = int(cfg.mlstm_proj_factor * cfg.d_model)
    h = cfg.n_heads
    hd = inner // h
    return {"C": ((batch, h, hd, hd), torch.float32),
            "n": ((batch, h, hd), torch.float32),
            "m": ((batch, h, 1), torch.float32),
            "conv": ((batch, cfg.mlstm_conv_width - 1, inner),
                     torch.bfloat16)}


def mlstm_state_init(cfg: ModelConfig, batch: int, device):
    return _zeros(mlstm_state_shapes(cfg, batch), device)


def _promoted(params, x, weight: str):
    """jnp's type promotion at a block's entry: x and the block's projection
    weight `weight` meet in their common type, so an f32 x over bf16
    weights computes in f32 (the reference's x @ w promotes), with every
    floating leaf of lower precision raised to it. The model paths pass x
    in the weights' dtype: nothing changes and nothing is copied."""
    dt = torch.promote_types(x.dtype, params[weight].dtype)
    if dt == x.dtype == params[weight].dtype:
        return params, x
    up = {k: v.to(dt) if (v.is_floating_point() and v.dtype != dt and
                          torch.promote_types(v.dtype, dt) == dt) else v
          for k, v in params.items()}
    return up, x.to(dt)


def mlstm_apply(params, cfg: ModelConfig, x, state=None, decode: bool = False,
                backend: str = "kernel", chunk: int = 128, positions=None):
    """x [b, s, d] -> (y, new_state or None).

    `positions` [b, s] with a state (serving prefill) marks -1 entries as
    trailing padding — padded steps are made state-transparent (forget gate
    pinned open, input gate shut, conv carry ends at the last valid input)
    — and rows whose chunk starts at position 0 restart the scan from a
    fresh state (m = -1e30) instead of the lane's previous occupant's.
    `backend` "kernel" scans through the CUDA kernel on the card, "naive"
    through its plain version.
    """
    params, x = _promoted(params, x, "w_up")
    b, s, d = x.shape
    inner = int(cfg.mlstm_proj_factor * d)
    H = cfg.n_heads
    hd = inner // H
    f32 = torch.float32
    chunked = state is not None and positions is not None and not decode
    if chunked:
        valid = positions >= 0                          # [b, s]
        fresh = positions[:, 0] == 0                    # [b]

    hin = layers.rmsnorm(params["norm"], x, cfg.norm_eps)
    up = layers.matmul(hin, params["w_up"])
    x_m, z = torch.chunk(up, 2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    if chunked:
        conv_state = torch.where(fresh[:, None, None],
                                 torch.zeros_like(conv_state), conv_state)
        xc, new_conv = layers.causal_conv1d(params["conv"], x_m, conv_state,
                                            valid_len=valid.sum(dim=1))
    else:
        xc, new_conv = layers.causal_conv1d(params["conv"], x_m, conv_state)
    xc = F.silu(xc.float()).to(x.dtype)

    q = _blockdiag(xc, params["wq"]).reshape(b, s, H, hd)
    k = _blockdiag(xc, params["wk"]).reshape(b, s, H, hd)
    v = x_m.reshape(b, s, H, hd)
    i_gate = torch.einsum("bsi,ih->bsh", xc.to(f32), params["w_i"]) \
        + params["b_i"]
    f_gate = torch.einsum("bsi,ih->bsh", xc.to(f32), params["w_f"]) \
        + params["b_f"]
    if chunked:
        # padded steps: log_sigmoid(1e4) == 0.0 exactly in f32 (the state
        # decays by exp(0) = 1) and the -1e30 input gate contributes
        # exp(-1e30 - m) == 0 — the scan passes the state straight through
        v3 = valid[..., None]
        i_gate = torch.where(v3, i_gate, kops.NEG_INF)
        f_gate = torch.where(v3, f_gate, 1e4)

    if decode:
        if state is None or s != 1:
            raise ValueError("mLSTM decode takes one position and a state")
        out, (C, n, m) = kops.mlstm_decode_step(
            q[:, 0], k[:, 0], v[:, 0], i_gate[:, 0], f_gate[:, 0],
            (state["C"], state["n"], state["m"]))
        out = out[:, None]
        new_state = {"C": C, "n": n, "m": m, "conv": new_conv}
    elif state is not None:
        C0, n0, m0 = state["C"], state["n"], state["m"]
        if chunked:
            fr = fresh.reshape(b, 1, 1)
            C0 = torch.where(fr[..., None], torch.zeros_like(C0), C0)
            n0 = torch.where(fr, torch.zeros_like(n0), n0)
            # a fresh scan's stabiliser starts at -inf, not 0 — anything
            # else shifts the denominator clamp exp(-m_t) on chunk 1
            m0 = torch.where(fr, kops.NEG_INF, m0)
        out, (C, n, m) = kops.mlstm_scan(q, k, v, i_gate, f_gate,
                                         chunk=chunk, backend=backend,
                                         initial=(C0, n0, m0))
        new_state = {"C": C, "n": n, "m": m, "conv": new_conv}
    else:
        out, _ = kops.mlstm_scan(q, k, v, i_gate, f_gate, chunk=chunk,
                                 backend=backend)
        new_state = None

    out = out.reshape(b, s, inner)
    out = layers.groupnorm_heads(params["gnorm"], out, H, cfg.norm_eps)
    out = out * F.silu(z.float()).to(out.dtype)
    return layers.matmul(out, params["w_down"]), new_state


# ===========================================================================
# sLSTM block (xLSTM) — sequential scan, block-diagonal recurrence per head
# ===========================================================================

def slstm_init(gen, cfg: ModelConfig, device, repeats: int = 0):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    ff = cfg.slstm_ff_dim
    dt = layers.torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    b = torch.cat([torch.zeros((2 * d,), dtype=f32, device=device),
                   torch.full((d,), 3.0, dtype=f32, device=device),
                   torch.zeros((d,), dtype=f32, device=device)])
    if repeats:
        b = b[None].repeat(repeats, 1)
    return {
        "norm": layers.rmsnorm_init(d, dt, device, repeats),
        "w": layers.dense_init(gen, d, 4 * d, dt, device, repeats),  # z,i,f,o
        "r": layers._normal(gen, _stacked((h, hd, 4 * hd), repeats), f32,
                            device),
        "b": b,
        "norm2": layers.rmsnorm_init(d, dt, device, repeats),
        "w_ff": layers.dense_init(gen, d, 2 * ff, dt, device, repeats),
        "w_ff_out": layers.dense_init(gen, ff, d, dt, device, repeats),
    }


def slstm_state_shapes(cfg: ModelConfig, batch: int) -> Shapes:
    d = cfg.d_model
    return {k: ((batch, d), torch.float32) for k in ("c", "n", "h", "m")}


def slstm_state_init(cfg: ModelConfig, batch: int, device):
    return _zeros(slstm_state_shapes(cfg, batch), device)


def _slstm_step(params, cfg, xw_t, state):
    """xw_t [b, 4d] (input projection); state dict of [b, d] f32."""
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    c, n, hid, m = state["c"], state["n"], state["h"], state["m"]
    b = hid.shape[0]
    rec = torch.einsum("bhx,hxy->bhy", hid.reshape(b, h, hd),
                       params["r"]).reshape(b, 4 * d)
    pre = xw_t.float() + rec + params["b"]
    zt, it, ft, ot = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(it - m_new)
    c = fp * c + ip * z
    n = fp * n + ip
    h_new = o * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h_new, "m": m_new}


def slstm_apply(params, cfg: ModelConfig, x, state=None, decode: bool = False,
                positions=None):
    """x [b, s, d] -> (y, new_state or None). With a state and `positions`
    (serving prefill), rows starting at position 0 restart from a zero
    state and -1 positions (trailing padding) leave the carried state
    untouched (a per-step select)."""
    params, x = _promoted(params, x, "w")
    b, s, d = x.shape
    hin = layers.rmsnorm(params["norm"], x, cfg.norm_eps)
    xw = layers.matmul(hin, params["w"])                      # [b, s, 4d]
    st = state if state is not None else slstm_state_init(cfg, b, x.device)
    core = {k: st[k] for k in ("c", "n", "h", "m")}
    chunked = state is not None and positions is not None and not decode
    if chunked:
        fresh = (positions[:, 0] == 0)[:, None]
        core = {k: torch.where(fresh, torch.zeros_like(v_), v_)
                for k, v_ in core.items()}
        valid = positions >= 0
    if decode:
        if s != 1:
            raise ValueError("sLSTM decode takes one position")
        core = _slstm_step(params, cfg, xw[:, 0], core)
        hs = core["h"][:, None]
        new_state = core
    else:
        outs = []
        for t in range(s):
            nxt = _slstm_step(params, cfg, xw[:, t], core)
            if chunked:
                v_t = valid[:, t:t + 1]
                nxt = {k: torch.where(v_t, nxt[k], core[k]) for k in nxt}
            core = nxt
            outs.append(nxt["h"])
        hs = torch.stack(outs, dim=1)
        new_state = core if state is not None else None
    y = x + hs.to(x.dtype)                                     # residual core
    # post-up GLU feed-forward (xLSTM sLSTM block, ff factor 4/3)
    hff = layers.rmsnorm(params["norm2"], y, cfg.norm_eps)
    up = layers.matmul(hff, params["w_ff"])
    gate, val = torch.chunk(up, 2, dim=-1)
    ff = layers.glu_combine("swiglu", gate, val)
    out = layers.matmul(ff, params["w_ff_out"])
    return out + hs.to(x.dtype), new_state


# ===========================================================================
# RG-LRU block (Griffin / RecurrentGemma)
# ===========================================================================

def rglru_init(gen, cfg: ModelConfig, device, repeats: int = 0):
    """The reference package's leaves and dtypes: projections and the conv
    in cfg.param_dtype; the diagonal gates and a_param in f32. a_param is
    drawn as the reference draws it, log(expm1(-log(u) / 8)) with u uniform
    in [0.25, 0.75], so that a = exp(-8 softplus(a_param) r) = u^r."""
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = layers.torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    u = torch.rand(_stacked((w,), repeats), generator=gen, dtype=f32,
                   device=device) * 0.5 + 0.25
    return {
        "norm": layers.rmsnorm_init(d, dt, device, repeats),
        "w_x": layers.dense_init(gen, d, w, dt, device, repeats),
        "w_y": layers.dense_init(gen, d, w, dt, device, repeats),
        "conv": layers.conv1d_init(cfg.conv_width, w, dt, device, repeats),
        "gate_r": torch.zeros(_stacked((w,), repeats), dtype=f32,
                              device=device),
        "gate_i": torch.zeros(_stacked((w,), repeats), dtype=f32,
                              device=device),
        "a_param": torch.log(torch.expm1(-torch.log(u) / 8.0)),
        "w_out": layers.dense_init(gen, w, d, dt, device, repeats),
    }


def rglru_state_shapes(cfg: ModelConfig, batch: int) -> Shapes:
    """A lane's RG-LRU state: h in f32, the conv tail in bf16."""
    w = cfg.lru_width or cfg.d_model
    return {"h": ((batch, w), torch.float32),
            "conv": ((batch, cfg.conv_width - 1, w), torch.bfloat16)}


def rglru_state_init(cfg: ModelConfig, batch: int, device):
    return _zeros(rglru_state_shapes(cfg, batch), device)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, as a
    log-step (Hillis-Steele) associative scan: ceil(log2 s) passes of
    elementwise products over the whole sequence, no loop over steps. The
    operator combines an earlier step (a1, b1) with a later (a2, b2) into
    (a1 a2, a2 b1 + b2); after the pass at distance d, element t holds the
    composition of steps max(0, t - 2d + 1)..t."""
    s = a.shape[1]
    d = 1
    while d < s:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return b


def rglru_apply(params, cfg: ModelConfig, x, state=None, decode: bool = False,
                positions=None):
    """Griffin recurrent block: gelu branch x RG-LRU branch -> out proj.
    x [b, s, d] -> (y, new state or None).

    `positions` [b, s] with a state (serving chunked prefill): -1 padding
    steps become identity elements of the scan (a = 1, B = 0) and rows
    starting at position 0 restart from h = 0 and an empty conv history.
    The diagonal recurrence runs as a log-step associative scan in f32
    (linear_scan), as the reference's jax.lax.associative_scan. An f32 x
    over bf16 weights computes in f32, as jnp promotes."""
    params, x = _promoted(params, x, "w_x")
    b, s, d = x.shape
    wdt = params["w_x"].shape[1]
    f32 = torch.float32
    chunked = state is not None and positions is not None and not decode
    if chunked:
        valid = positions >= 0                                # [b, s]
        fresh = positions[:, 0] == 0                          # [b]
    hin = layers.rmsnorm(params["norm"], x, cfg.norm_eps)
    branch_y = layers._gelu(layers.matmul(hin, params["w_y"]).float()).to(
        x.dtype)
    bx = layers.matmul(hin, params["w_x"])
    conv_state = state["conv"] if state is not None else None
    if chunked:
        conv_state = torch.where(fresh[:, None, None],
                                 torch.zeros_like(conv_state), conv_state)
        xc, new_conv = layers.causal_conv1d(params["conv"], bx, conv_state,
                                            valid_len=valid.sum(dim=1))
    else:
        xc, new_conv = layers.causal_conv1d(params["conv"], bx, conv_state)

    xf = xc.to(f32)
    r_pre = params["gate_r"] * xf
    i_pre = params["gate_i"] * xf
    log_a = (-8.0 * F.softplus(params["a_param"].to(f32))
             * torch.sigmoid(r_pre))                          # [b, s, w] < 0
    if chunked:
        log_a = torch.where(valid[..., None], log_a, torch.zeros_like(log_a))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = beta * torch.sigmoid(i_pre) * xf                  # B term
    if chunked:
        gated = torch.where(valid[..., None], gated, torch.zeros_like(gated))

    h0 = state["h"] if state is not None else torch.zeros((b, wdt),
                                                          dtype=f32,
                                                          device=x.device)
    if chunked:
        h0 = torch.where(fresh[:, None], torch.zeros_like(h0), h0)
    if decode:
        assert s == 1
        h = a[:, 0] * h0 + gated[:, 0]
        hs = h[:, None]
        new_state = {"h": h, "conv": new_conv}
    else:
        # fold h0 into the first step, then the associative scan
        g0 = torch.cat([gated[:, :1] + a[:, :1] * h0[:, None], gated[:, 1:]],
                       dim=1)
        hs = linear_scan(a, g0)
        new_state = ({"h": hs[:, -1], "conv": new_conv}
                     if state is not None else None)
    out = hs.to(x.dtype) * branch_y
    return layers.matmul(out, params["w_out"]), new_state
