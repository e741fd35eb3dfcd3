"""Mixture-of-Experts channel mixer: top-k router + capacity-factor dispatch,
after the reference package's models/moe.py.

Dispatch and combine are dense one-hot products (GShard / Switch style), as
in the reference: the dispatch tensor [b, s, E, C] is the MoE's "shuffle
data" in WSMC terms. Its transient footprint grows with the capacity
factor, and it is what pushes MoE archs into the Expanding categories; the
planner controls it with microbatching.

Expert weights are 3-D [E, d, mult * f] and [E, f, d] (stacked over repeats
in a unit: [repeats, E, ...]). Routing keeps the reference's semantics
exactly: router logits and softmax in f32, top-k with ties broken toward
the lower expert index (jax.lax.top_k's rule; all-zero padding rows route
on exact ties), renormalised gates, choice priority with per-expert counts
shared across choices; a decode step (s == 1, b > 1) routes the whole batch
as one group, inert lanes included, so their rows take expert capacity as
well (recorded as fault F13).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

def moe_init(gen, cfg: ModelConfig, device, repeats: int = 0):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    mult = 2 if layers.is_glu(cfg.activation) else 1
    dt = layers.torch_dtype(cfg.param_dtype)
    lead = (repeats,) if repeats else ()
    return {
        "norm": layers.rmsnorm_init(d, dt, device, repeats),
        "router": layers.dense_init(gen, d, E, torch.float32, device,
                                    repeats),
        "wi": layers._normal(gen, lead + (E, d, mult * f), dt, device),
        "wo": layers._normal(gen, lead + (E, f, d), dt, device),
    }


def moe_apply(params, cfg: ModelConfig, x, group_size: int = 2048):
    """x [b, s, d] -> (y [b, s, d], aux {"lb_loss", "z_loss"}).

    Tokens are routed in fixed-size groups along the sequence (GShard):
    capacity, and the dispatch transient, stay O(group_size), not O(seq).
    A decode step (s == 1) groups across the batch instead."""
    b0, s0, d = x.shape
    if s0 == 1 and b0 > 1:                       # decode: batch is the group
        y, aux = _moe_grouped(params, cfg, x.reshape(1, b0, d))
        return y.reshape(b0, s0, d), aux
    g = min(group_size, s0)
    pad = (-s0) % g
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    n_g = (s0 + pad) // g
    y, aux = _moe_grouped(params, cfg, xp.reshape(b0 * n_g, g, d))
    return y.reshape(b0, s0 + pad, d)[:, :s0], aux


def top_k_lower_index(probs, k: int):
    """(values, indices) of the k largest entries along the last axis,
    ties broken toward the lower index (jax.lax.top_k's rule)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, cfg: ModelConfig, h):
    """The router of one set of groups, h [b, s, d] (normed): (dispatch
    [b, s, E, C] in h's dtype, combine [b, s, E, C] f32, gate_idx [b, s, k],
    router logits [b, s, E] f32, probs [b, s, E] f32)."""
    b, s, _ = h.shape
    E, k = cfg.n_experts, cfg.top_k
    C = max(1, int(-(-s * k * cfg.capacity_factor // E)))
    logits = torch.matmul(h.float(), params["router"].float())   # [b, s, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_lower_index(probs, k)             # [b, s, k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)            # renormalize

    # Capacity assignment with choice priority (Switch): earlier choices
    # claim slots first; cumulative per-expert counts shared across choices.
    dispatch = torch.zeros((b, s, E, C), dtype=h.dtype, device=h.device)
    combine = torch.zeros((b, s, E, C), dtype=torch.float32, device=h.device)
    counts = torch.zeros((b, E), dtype=torch.int32, device=h.device)
    for choice in range(k):
        e_onehot = F.one_hot(gate_idx[..., choice].long(), E).to(
            torch.int32)                                           # [b, s, E]
        pos = counts[:, None, :] + torch.cumsum(e_onehot, dim=1,
                                                dtype=torch.int32) - e_onehot
        keep = (pos < C) & (e_onehot > 0)
        pos_oh = F.one_hot(torch.where(keep, pos, C).long(), C + 1).to(
            h.dtype)[..., :C]                                      # [b, s, E, C]
        sel = pos_oh * keep[..., None].to(h.dtype)
        dispatch = dispatch + sel
        combine = combine + sel.float() * gate_vals[..., choice][..., None,
                                                                  None]
        counts = counts + e_onehot.sum(dim=1, dtype=torch.int32)
    return dispatch, combine, gate_idx, logits, probs


def _moe_grouped(params, cfg: ModelConfig, x):
    """x [rows, group, d], one independent routing group per row: (y,
    aux)."""
    E = cfg.n_experts
    h = layers.rmsnorm(params["norm"], x, cfg.norm_eps)
    dispatch, combine, gate_idx, logits, probs = route(params, cfg, h)

    xe = torch.einsum("bsec,bsd->becd", dispatch, h)            # [b, E, C, d]
    up = layers.einsum_f32("becd,edf->becf", xe, params["wi"]).to(h.dtype)
    if layers.is_glu(cfg.activation):
        gate, val = torch.chunk(up, 2, dim=-1)
        act = layers.glu_combine(cfg.activation, gate, val)
    else:
        act = layers.ACTIVATIONS[cfg.activation](up)
    ye = layers.einsum_f32("becf,efd->becd", act, params["wo"]).to(h.dtype)
    y = torch.einsum("bsec,becd->bsd", combine.to(h.dtype), ye)

    # Aux losses: Switch load-balance + router z-loss, in f32.
    frac_tokens = torch.mean(F.one_hot(gate_idx[..., 0].long(), E).float(),
                             dim=(0, 1))
    mean_probs = torch.mean(probs, dim=(0, 1))
    lb_loss = E * torch.sum(frac_tokens * mean_probs)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return y, {"lb_loss": lb_loss, "z_loss": z_loss}
