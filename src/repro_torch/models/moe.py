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

On a model axis (serving inside `parallel.comm.model_axis`) the layer
finds its layout from its local shapes, as `layers._check_shard` does:
under expert parallelism (EP) `wi`'s expert dim holds this rank's E / M
whole experts (and the router its E / M columns); under tensor
parallelism inside the experts `wi`'s last dim holds this rank's
[gate_r | val_r] columns of every expert and `wo` the matching rows.
Routing is replicated: every rank routes the whole group from the whole
router (an EP rank gathers the router's columns first), so the dispatch
masks, the capacity C (from the global expert count) and the aux losses
are the same bits on every rank as on one device for the same input.
Each rank then runs its experts' products (EP) or its columns of every
expert (TP), combines them into an f32 partial y, and `comm.tp_sum`
sums the partials over the axis before the one rounding to the
activation dtype, as `layers.out_proj` does. The normed input enters the
expert products through `comm.tp_enter`.

Training runs the same forward on a model axis, and three collectives
carry its gradients. An EP rank gathers the router's columns through
`comm.tp_gather_last`, whose backward is this rank's columns of the
whole router's gradient (every rank computes that whole gradient alike,
so a sum would count it M times). The gates enter `combine` through
`comm.tp_enter` (kind "tp_gate_grad"): each rank's partial y gives only
its experts' (EP) or its columns' (TP) share of the gates' gradient, so
the gradient is summed over the axis there, on the [b, s, k] gates,
before it reaches the softmax, the router and the normed input. The aux
losses read the probabilities and logits directly and are the same on
every rank, so their gradient is not summed. The normed input's gradient
is then the router path's (the same on every rank) plus the experts'
(summed by the `comm.tp_enter` on the expert path).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.parallel import comm

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


def router_logits(params, cfg: ModelConfig, h):
    """The f32 router logits [b, s, E] of h (normed), from the whole
    router: on a model axis whose ranks each hold E / M of its columns
    (EP), the columns are gathered first, so every rank computes the same
    bits as one device."""
    w = params["router"]
    m = comm.model_size()
    if m > 1 and w.shape[-1] != cfg.n_experts:
        if w.shape[-1] * m != cfg.n_experts:
            raise ValueError(f"router: {w.shape[-1]} expert columns on a "
                             f"model axis of {m}, the whole router has "
                             f"{cfg.n_experts}")
        w = comm.tp_gather_last(w.contiguous(), kind="tp_router")
    return torch.matmul(h.float(), w.float())


def _gates(params, cfg: ModelConfig, gates):
    """The gates [b, s, k] as they enter `combine`: on a model axis whose
    ranks each combine a part of y (EP or TP), through `comm.tp_enter`, so
    their gradient is summed over the axis; else as they are."""
    if comm.model_size() == 1 or _layout(params, cfg) == "whole":
        return gates
    return comm.tp_enter(gates, kind="tp_gate_grad")


def route(params, cfg: ModelConfig, h):
    """The router of one set of groups, h [b, s, d] (normed): (dispatch
    [b, s, E, C] in h's dtype, combine [b, s, E, C] f32, gate_idx [b, s, k],
    router logits [b, s, E] f32, probs [b, s, E] f32)."""
    b, s, _ = h.shape
    E, k = cfg.n_experts, cfg.top_k
    C = max(1, int(-(-s * k * cfg.capacity_factor // E)))
    logits = router_logits(params, cfg, h)                        # [b, s, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_lower_index(probs, k)             # [b, s, k]
    gate_vals = _gates(params, cfg, gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9))           # renormalize

    dispatch = torch.zeros((b, s, E, C), dtype=h.dtype, device=h.device)
    combine = torch.zeros((b, s, E, C), dtype=torch.float32, device=h.device)
    for choice, (pos, keep) in enumerate(capacity_slots(gate_idx, E, C)):
        pos_oh = F.one_hot(torch.where(keep, pos, C).long(), C + 1).to(
            h.dtype)[..., :C]                                      # [b, s, E, C]
        sel = pos_oh * keep[..., None].to(h.dtype)
        dispatch = dispatch + sel
        combine = combine + sel.float() * gate_vals[..., choice][..., None,
                                                                  None]
    return dispatch, combine, gate_idx, logits, probs


def capacity_slots(gate_idx, E: int, C: int):
    """Capacity assignment with choice priority (Switch): earlier choices
    claim slots first, the per-expert counts shared across choices. For
    each of the k choices of gate_idx [b, s, k] (one group a row), (pos,
    keep) [b, s, E]: each token's place in each expert's order over the
    group, and whether the choice's expert is there with its place under
    the capacity C."""
    counts = torch.zeros((gate_idx.shape[0], E), dtype=torch.int32,
                         device=gate_idx.device)
    out = []
    for choice in range(gate_idx.shape[-1]):
        e_onehot = F.one_hot(gate_idx[..., choice].long(), E).to(
            torch.int32)                                           # [b, s, E]
        pos = counts[:, None, :] + torch.cumsum(e_onehot, dim=1,
                                                dtype=torch.int32) - e_onehot
        out.append((pos, (pos < C) & (e_onehot > 0)))
        counts = counts + e_onehot.sum(dim=1, dtype=torch.int32)
    return out


def _layout(params, cfg: ModelConfig) -> str:
    """How this rank holds the experts, read from the local shapes of `wi`
    [E_local, d, mult * f_local]: "whole" (one device, or a model axis
    that replicates them), "ep" (E / M whole experts) or "tp" (the
    [gate_r | val_r] columns of every expert)."""
    m = comm.model_size()
    mult = 2 if layers.is_glu(cfg.activation) else 1
    E, width = cfg.n_experts, mult * cfg.d_ff
    e_loc, w_loc = params["wi"].shape[-3], params["wi"].shape[-1]
    if (e_loc, w_loc) == (E, width):
        return "whole"
    if m > 1 and (e_loc * m, w_loc) == (E, width):
        return "ep"
    if m > 1 and (e_loc, w_loc * m) == (E, width):
        return "tp"
    raise ValueError(f"MoE wi: {e_loc} experts x {w_loc} columns on a model "
                     f"axis of {m}, the whole leaf has {E} x {width}")


def _moe_grouped(params, cfg: ModelConfig, x):
    """x [rows, group, d], one independent routing group per row: (y,
    aux)."""
    E = cfg.n_experts
    h = layers.rmsnorm(params["norm"], x, cfg.norm_eps)
    dispatch, combine, gate_idx, logits, probs = route(params, cfg, h)
    layout = _layout(params, cfg)
    if layout == "ep":              # this rank's E / M experts
        n = params["wi"].shape[-3]
        mine = slice(comm.model_rank() * n, (comm.model_rank() + 1) * n)
        dispatch, combine = dispatch[:, :, mine], combine[:, :, mine]
    he = comm.tp_enter(h) if layout != "whole" else h

    xe = torch.einsum("bsec,bsd->becd", dispatch, he)           # [b, E, C, d]
    up = layers.einsum_f32("becd,edf->becf", xe, params["wi"]).to(h.dtype)
    if layers.is_glu(cfg.activation):
        gate, val = torch.chunk(up, 2, dim=-1)
        act = layers.glu_combine(cfg.activation, gate, val)
    else:
        act = layers.ACTIVATIONS[cfg.activation](up)
    ye = layers.einsum_f32("becf,efd->becd", act, params["wo"])
    if layout == "whole":
        y = torch.einsum("bsec,becd->bsd", combine.to(h.dtype),
                         ye.to(h.dtype))
    else:
        # EP: this rank's experts' outputs, rounded as one device rounds
        # them; TP: every expert's partial product over this rank's
        # columns, in f32. Either way an f32 partial y, summed over the
        # axis and rounded once.
        if layout == "ep":
            ye = ye.to(h.dtype).float()
        part = torch.einsum("bsec,becd->bsd", combine.to(h.dtype).float(),
                            ye)
        y = comm.tp_sum(part, kind="tp_moe_sum").to(h.dtype)

    # Aux losses: Switch load-balance + router z-loss, in f32, from the
    # whole logits (the same on every rank of a model axis).
    frac_tokens = torch.mean(F.one_hot(gate_idx[..., 0].long(), E).float(),
                             dim=(0, 1))
    mean_probs = torch.mean(probs, dim=(0, 1))
    lb_loss = E * torch.sum(frac_tokens * mean_probs)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return y, {"lb_loss": lb_loss, "z_loss": z_loss}


# ---------------------------------------------------------------------------
# Routes taken from another run
# ---------------------------------------------------------------------------

def kept_choices(dispatch, gate_idx):
    """[b, s, k] bool: each token's choices that found a capacity slot."""
    return dispatch.sum(-1).gather(-1, gate_idx) > 0


def forced_route(params, cfg: ModelConfig, h, experts, kept):
    """route's outputs for h [b, s, d] with each token's experts and kept
    choices [b, s, k] given: the gates come from this path's own router,
    renormalised over the given experts as `route` does, and every kept
    choice has a slot of its own (capacity decides nothing)."""
    b, s, _ = h.shape
    E, k = cfg.n_experts, experts.shape[-1]
    logits = router_logits(params, cfg, h)
    probs = torch.softmax(logits, dim=-1)
    gates = probs.gather(-1, experts)
    gates = _gates(params, cfg, gates / torch.clamp(
        gates.sum(dim=-1, keepdim=True), min=1e-9))
    sel = F.one_hot(experts, E) * kept[..., None]
    flat = sel.reshape(b, s * k, E)                       # [b, s*k, E]
    slot = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, E)
    C = max(1, int(flat.sum(dim=1).max()))
    dispatch = torch.zeros((b, s, E, C), dtype=h.dtype, device=h.device)
    combine = torch.zeros((b, s, E, C), dtype=torch.float32, device=h.device)
    for j in range(k):
        oh = (F.one_hot(slot[:, :, j].clamp(max=C - 1), C)
              * sel[:, :, j, :, None]).to(h.dtype)        # [b, s, E, C]
        dispatch = dispatch + oh
        combine = combine + oh.float() * gates[..., j, None, None]
    return dispatch, combine, experts, logits, probs


@contextlib.contextmanager
def routing(hook):
    """`route` replaced by hook(route, params, cfg, h) for the duration
    (the MoE layers call it through this module)."""
    global route
    orig = route
    route = lambda params, cfg, h: hook(orig, params, cfg, h)  # noqa: E731
    try:
        yield
    finally:
        route = orig


# the routing site in force: (name, value) pairs, outermost first (a train
# step's ("step", i), a scan microbatch's ("micro", j), a layer's
# ("layer", (repeat, position)) or ("layer", ("tail", i)))
_site = ()


@contextlib.contextmanager
def site(**part):
    """Name the enclosed routing calls' site: `part` (one name=value)
    appended to the site in force for the duration."""
    global _site
    prev = _site
    _site = prev + tuple(part.items())
    try:
        yield
    finally:
        _site = prev


class RouteTape:
    """A routing hook (`routing`) that keeps the experts and kept choices
    [b, s, k] of every `route` call of a run, on the CPU (`calls`).

    By default `calls` is a list in call order. With `keyed` (a training
    run) it is a dict keyed by each call's site (`site`: step,
    microbatch, layer), and a call at a site already kept (a remat
    recompute of the layer in the backward) keeps nothing new; `keys`
    lists every call's site in call order.

    With `forced` (another run's `calls`: a list for a run of the same
    schedule, the same groups in the same order; a dict for a keyed run)
    each call takes the entry of its place or site through
    `forced_route`, so a recompute takes what its forward took; its own
    routes are still kept, so the two tapes show where this run's router
    would part from the other's."""

    def __init__(self, forced=None, keyed=False):
        self.keyed = keyed or isinstance(forced, dict)
        self.calls = {} if self.keyed else []
        self.keys = []
        self.forced = forced

    def __call__(self, route_fn, params, cfg, h):
        out = route_fn(params, cfg, h)
        mine = (out[2].cpu(), kept_choices(out[0], out[2]).cpu())
        if self.keyed:
            key = _site
            self.calls.setdefault(key, mine)
        else:
            key = len(self.calls)
            self.calls.append(mine)
        self.keys.append(key)
        if self.forced is None:
            return out
        try:
            ex, kp = self.forced[key]
        except (IndexError, KeyError):
            raise ValueError(f"MoE route call {key}: not in the forced tape "
                             f"of {len(self.forced)} calls") from None
        if tuple(ex.shape) != tuple(out[2].shape):
            raise ValueError(f"MoE route call {key} routes "
                             f"{tuple(out[2].shape)}, the forced tape "
                             f"{tuple(ex.shape)}: another schedule")
        return forced_route(params, cfg, h, ex.to(h.device),
                            kp.to(h.device))
