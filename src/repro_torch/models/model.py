"""Model assembly: embedding -> pattern units -> tail -> norm -> head.

The depth pattern (configs.base: unit x repeats + tail) keeps the reference
package's parameter layout: parameters and caches are *stacked over repeats*
per unit position (leading axis = repeat). Where the reference scans over
that axis, this package runs a Python loop over the layers and hands each
layer a view `leaf[r]` of the stacked tensors; caches are updated in place
through those views.

Every block of the reference is ported: attention, xLSTM's mLSTM and
sLSTM and Griffin's RG-LRU mixers, each with a dense or a MoE channel mixer
(models/moe.py); the sequence forward without a cache (differentiable: the
training path, with an optional remat wrapper around each unit repeat),
with prefix embeddings before the tokens for the modality-stub archs; the
prefill that builds ring caches and recurrent states (`build_cache`) or
writes a paged pool (and its per-lane rings and states), and decode and
chunk-append forwards against a cache.

Serving and training run tensor-parallel over a mesh's "model" axis
inside `parallel.comm.model_axis`: attention and the dense MLP are
column-parallel in (q / k / v, wi; their normed input through
`comm.tp_enter`) and row-parallel out (wo, summed in f32), the embedding
and LM head vocab-sharded, the norms replicated; caches hold this rank's
kv heads (`init_cache(..., model_parallel=)`). The collectives carry
their gradients, so the sequence forward trains there too.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import (ATTN, MLP_DENSE, MLP_MOE, MLP_NONE,
                                      MLSTM, RGLRU, SLSTM, BlockSpec,
                                      ModelConfig)
from repro_torch.kernels.ops import MLSTM_BACKENDS
from repro_torch.models import attention, layers, moe, recurrent
from repro_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class ModelSettings:
    attn: attention.AttnSettings = attention.AttnSettings()
    # prefill (not decode) fills a cache: with no cache given `apply`
    # returns the ring caches the prompt fills; with a paged pool given it
    # writes the prompt's K/V into the pool through the block tables
    build_cache: bool = False
    # the mLSTM scan: "kernel" (the CUDA kernel on the card) or "naive" (its
    # plain version, on either device), and its chunk length
    mlstm_backend: str = "kernel"
    mlstm_chunk: int = 128
    # MoE routing group size (tokens along the sequence; a decode step
    # routes its whole batch as one group)
    moe_group: int = 2048

    def __post_init__(self):
        if self.mlstm_backend not in MLSTM_BACKENDS:
            raise ValueError(f"ModelSettings.mlstm_backend "
                             f"{self.mlstm_backend!r} not in {MLSTM_BACKENDS}")


def require_device(device) -> torch.device:
    """Resolve an entry point's `device=` argument; asking for CUDA without
    a CUDA device raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ModelConfig, device, repeats: int = 0):
    d, f = cfg.d_model, cfg.d_ff
    mult = 2 if layers.is_glu(cfg.activation) else 1
    dt = layers.torch_dtype(cfg.param_dtype)
    return {
        "norm": layers.rmsnorm_init(d, dt, device, repeats),
        "wi": layers.dense_init(gen, d, mult * f, dt, device, repeats),
        "wo": layers.dense_init(gen, f, d, dt, device, repeats),
    }


def mlp_apply(params, cfg: ModelConfig, x):
    """The dense MLP. Tensor-parallel: `wi` holds this rank's columns (a
    GLU's [gate_r | val_r], parallel.sharding), `wo` the matching rows,
    summed over the model axis in f32 (layers.out_proj); the normed input
    enters through comm.tp_enter, so training sums its gradient over the
    axis."""
    h = comm.tp_enter(layers.rmsnorm(params["norm"], x, cfg.norm_eps))
    up = layers.matmul(h, params["wi"])
    if layers.is_glu(cfg.activation):
        gate, val = torch.chunk(up, 2, dim=-1)
        act = layers.glu_combine(cfg.activation, gate, val)
    else:
        act = layers.ACTIVATIONS[cfg.activation](up)
    return layers.out_proj(act, params["wo"], cfg.d_ff)


# ---------------------------------------------------------------------------
# Block = mixer + channel mixer
# ---------------------------------------------------------------------------

def _check_block(blk: BlockSpec):
    if blk.mixer not in (ATTN, MLSTM, SLSTM, RGLRU):
        raise ValueError(blk.mixer)
    if blk.mlp not in (MLP_DENSE, MLP_MOE, MLP_NONE):
        raise ValueError(blk.mlp)


_MIXER_INIT = {ATTN: attention.attn_init, MLSTM: recurrent.mlstm_init,
               SLSTM: recurrent.slstm_init, RGLRU: recurrent.rglru_init}


def block_init(gen, cfg: ModelConfig, blk: BlockSpec, device,
               repeats: int = 0):
    _check_block(blk)
    p: Dict[str, Any] = {"mixer": _MIXER_INIT[blk.mixer](gen, cfg, device,
                                                        repeats)}
    if blk.mlp == MLP_DENSE:
        p["mlp"] = mlp_init(gen, cfg, device, repeats)
    elif blk.mlp == MLP_MOE:
        p["mlp"] = moe.moe_init(gen, cfg, device, repeats)
    return p


def state_shapes(cfg: ModelConfig, blk: BlockSpec, batch: int):
    """{leaf: (shape, dtype)} of a recurrent block's per-lane state."""
    _check_block(blk)
    if blk.mixer == MLSTM:
        return recurrent.mlstm_state_shapes(cfg, batch)
    if blk.mixer == SLSTM:
        return recurrent.slstm_state_shapes(cfg, batch)
    if blk.mixer == RGLRU:
        return recurrent.rglru_state_shapes(cfg, batch)
    raise ValueError(f"{blk.mixer} keeps no recurrent state")


def block_cache_init(cfg: ModelConfig, blk: BlockSpec, batch: int,
                     context: int, dtype=torch.bfloat16, device="cuda",
                     model_parallel: int = 1):
    """An empty ring cache (attention; this rank's n_kv_heads /
    model_parallel heads) or a zero state (recurrent)."""
    _check_block(blk)
    if blk.mixer == ATTN:
        return attention.cache_init(cfg, blk, batch, context, dtype=dtype,
                                    device=device,
                                    model_parallel=model_parallel)
    return recurrent._zeros(state_shapes(cfg, blk, batch), device)


def _recurrent_apply(params, cfg: ModelConfig, blk: BlockSpec, x, positions,
                     cache, decode: bool, building: bool,
                     settings: "ModelSettings"):
    """An mLSTM / sLSTM / RG-LRU mixer: (delta, state). Prefill starts from a zero
    state. A cache passed in receives the new state IN PLACE and is
    returned; at decode only rows with position >= 0 take it (full-width
    ticks carry INERT rows — empty lanes, lanes mid-chunk-prefill — whose
    pad-token step must not advance the lane's state): a masked copy,
    nothing is written first and restored after."""
    state = (block_cache_init(cfg, blk, x.shape[0], 0, device=x.device)
             if building else cache)
    if blk.mixer == MLSTM:
        delta, new = recurrent.mlstm_apply(
            params, cfg, x, state=state, decode=decode,
            backend=settings.mlstm_backend, chunk=settings.mlstm_chunk,
            positions=positions)
    elif blk.mixer == SLSTM:
        delta, new = recurrent.slstm_apply(params, cfg, x, state=state,
                                           decode=decode, positions=positions)
    else:
        delta, new = recurrent.rglru_apply(params, cfg, x, state=state,
                                           decode=decode, positions=positions)
    if cache is None or new is None:
        return delta, new
    live = (positions[:, 0] >= 0) if decode else None
    for k, t in new.items():
        if live is not None:
            t = torch.where(live.reshape((-1,) + (1,) * (t.dim() - 1)), t,
                            cache[k])
        cache[k].copy_(t)
    return delta, cache


def block_apply(params, cfg: ModelConfig, blk: BlockSpec, x, positions,
                cache=None, decode: bool = False, context: int = 0,
                settings: ModelSettings = ModelSettings(),
                block_tables=None):
    """Returns (x', cache, aux). A cache passed in is updated in place; with
    settings.build_cache and no cache, the ring the prompt fills (attention)
    or the state it leaves (recurrent). A MoE block's aux is the MoE's
    {"lb_loss", "z_loss"} alone: as in the reference, it replaces the
    attention's (so a MoE arch reports no attention mass)."""
    _check_block(blk)
    building = settings.build_cache and not decode
    aux: Dict[str, Any] = {}
    if blk.mixer == ATTN:
        cache_arg = "build" if building and cache is None else cache
        delta, new_cache, aux = attention.attn_apply(
            params["mixer"], cfg, blk, x, positions, cache=cache_arg,
            decode=decode, context=context, settings=settings.attn,
            block_tables=block_tables, whole_prompt=building)
    else:
        delta, new_cache = _recurrent_apply(params["mixer"], cfg, blk, x,
                                            positions, cache, decode,
                                            building, settings)
    x = x + delta
    if blk.mlp == MLP_DENSE:
        x = x + mlp_apply(params["mlp"], cfg, x)
    elif blk.mlp == MLP_MOE:
        delta, aux = moe.moe_apply(params["mlp"], cfg, x,
                                   group_size=settings.moe_group)
        x = x + delta
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Random parameters in the reference package's tree layout: `units[i]`
    holds unit position i's leaves stacked over repeats ([repeats, ...]),
    `tail[i]` unstacked leaves. `gen` is the explicit random source (it must
    live on `device`); the draws are this package's own, not the reference
    package's for the same seed. Raises if `device` is CUDA and there is no
    CUDA device."""
    device = require_device(device)
    params: Dict[str, Any] = {"embed": layers.embed_init(gen, cfg, device)}
    params["units"] = [block_init(gen, cfg, blk, device,
                                  repeats=max(cfg.repeats, 1))
                       for blk in cfg.unit]
    params["tail"] = [block_init(gen, cfg, blk, device) for blk in cfg.tail]
    params["final_norm"] = layers.rmsnorm_init(cfg.d_model, cfg.param_dtype,
                                               device)
    if not cfg.tie_embeddings:
        params["head"] = layers.embed_init(gen, cfg, device)
    return params


def init_cache(cfg: ModelConfig, batch: int, context: int,
               dtype=torch.bfloat16, device="cuda", model_parallel: int = 1):
    """Cache tree mirroring the params layout (stacked over repeats): every
    ring empty (pos -1), every recurrent state zero; rings at this rank's
    n_kv_heads / model_parallel heads. Raises if `device` is CUDA and there
    is no CUDA device."""
    device = require_device(device)

    def one(blk):
        return block_cache_init(cfg, blk, batch, context, dtype, device,
                                model_parallel)

    def stacked(blk):
        return {k: torch.stack([v] * cfg.repeats)
                for k, v in one(blk).items()}

    return {"units": [stacked(blk) for blk in cfg.unit],
            "tail": [one(blk) for blk in cfg.tail]}


def _tree_index(tree, r: int):
    """View r of every stacked leaf of a (nested dict) tree."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, r) for k, v in tree.items()}
    return tree[r]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _merge_aux(acc: Dict[str, Any], aux: Dict[str, Any]):
    for k, v in aux.items():
        acc[k] = acc[k] + v if k in acc else v


def apply(params, cfg: ModelConfig, tokens, *, positions=None,
          prefix_embeds=None, cache=None, decode: bool = False,
          settings: ModelSettings = ModelSettings(), context: int = 0,
          logits_last_only: bool = False, block_tables=None,
          head_rows=None, unit_wrapper: Optional[Callable] = None):
    """Forward pass.

    tokens [b, s] (s=1 for decode); positions [b] for decode, [b, s]
    absolute positions for a mid-prompt chunk (-1 marks padding; else the
    implied arange); prefix_embeds [b, p, d] for the modality-stub archs,
    placed before the token embeddings (not at decode; not together with
    explicit positions); block_tables [b, max_blocks] maps each sequence's
    logical KV blocks to physical blocks of a paged pool cache (-1 =
    unassigned).
    Returns (logits f32, cache, aux). A cache passed in has its tensors
    updated IN PLACE and the same tree is returned (the reference package
    returns a new tree). With settings.build_cache (prefill) and no cache,
    the returned cache is the ring tree the prompt fills; with a paged pool
    it is that pool, the prompt's K/V written layer by layer. Without
    either, the cache returned is None. `aux` holds "lb_loss" and "z_loss"
    (f32 sums over the MoE layers; zeros without one) and, on paged decode
    with settings.attn.track_mass, "attn_mass" (zeros for a MoE arch, as
    the reference's; under tensor parallelism over this rank's heads only:
    the caller reduces it over the model axis).

    Grad mode follows the caller's, so a loss over the cache-free sequence
    path's logits can be differentiated (the training path). The serving
    entry points (runtime.serve_step, serving.executor, serving.quality)
    call this under torch.no_grad(): their in-place writes into caches and
    pools must not be recorded.

    `unit_wrapper` (runtime.train_step.remat_wrapper) wraps each repeat of
    the unit pattern on the cache-free path: unit_body(x, unit_params) ->
    (x, aux), unit_params one tree per unit position, the leaves `leaf[r]`
    of the stacked tree (a stacked leaf may also be a list of per-repeat
    tensors).

    `head_rows` [b] (sequence path only) sends just position head_rows[i]
    of row i through the final norm and the LM head: logits [b, 1, V]. Both
    are per-position functions, so the values equal those rows of the full
    logits; a chunk of 256 positions then costs one head product, not 256.
    """
    b = tokens.shape[0]
    x = layers.embed_lookup(params["embed"], cfg, tokens)
    if prefix_embeds is not None and not decode:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    s = x.shape[1]
    if decode:
        assert positions is not None
        pos = positions[:, None]                      # [b, 1]
    elif positions is not None:
        assert prefix_embeds is None
        pos = positions
    else:
        pos = torch.arange(s, dtype=torch.int32,
                           device=x.device)[None].expand(b, s)
    ctx = context or s

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_acc: Dict[str, Any] = {"lb_loss": zero, "z_loss": zero}
    if decode and block_tables is not None and settings.attn.track_mass:
        aux_acc["attn_mass"] = torch.zeros(
            (b, block_tables.shape[1]), dtype=torch.float32, device=x.device)
    have_cache = cache is not None
    building = settings.build_cache and not decode and not have_cache
    if building:
        cache = init_cache(cfg, b, ctx, dtype=x.dtype, device=x.device,
                           model_parallel=comm.model_size())

    def run_block(p, blk, x, c):
        x, nc, aux = block_apply(p, cfg, blk, x, pos,
                                 cache=None if building else c,
                                 decode=decode, context=ctx,
                                 settings=settings,
                                 block_tables=block_tables)
        if building:                 # the ring this layer's prompt filled
            for k, v in nc.items():
                c[k].copy_(v)
        _merge_aux(aux_acc, aux)
        return x

    with_cache = have_cache or building
    if with_cache:
        for r in range(cfg.repeats):
            for i, blk in enumerate(cfg.unit):
                c = _tree_index(cache["units"][i], r)
                x = run_block(_tree_index(params["units"][i], r), blk, x, c)
        for i, blk in enumerate(cfg.tail):
            x = run_block(params["tail"][i], blk, x, cache["tail"][i])
    else:
        x, aux = unit_stack_forward(params["units"], cfg, x, pos,
                                    settings=settings, context=ctx,
                                    unit_wrapper=unit_wrapper)
        _merge_aux(aux_acc, aux)
        x = _tail_forward(params, cfg, x, pos, aux_acc, settings=settings,
                          context=ctx, decode=decode,
                          block_tables=block_tables)

    if head_rows is not None and not decode:
        x = torch.gather(
            x, 1, head_rows.long()[:, None, None].expand(b, 1, x.shape[-1]))
    elif logits_last_only and not decode:
        x = x[:, -1:]
    return _head(params, cfg, x), cache, aux_acc


# ---------------------------------------------------------------------------
# Staged forward pieces (the pipeline runtime): embed | unit stack | tail + head
# ---------------------------------------------------------------------------

def _zero_aux(device) -> Dict[str, Any]:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": zero, "z_loss": zero}


def unit_stack_forward(units, cfg: ModelConfig, x, pos, *,
                       settings: ModelSettings = ModelSettings(),
                       context: int = 0,
                       unit_wrapper: Optional[Callable] = None):
    """Forward through the stacked unit pattern, or a slice of it (a 1F1B
    pipeline stage's body), on the cache-free path. `units` has the layout
    of params["units"] (one tree per unit position), each leaf stacked on
    a leading repeats axis or the list of its per-repeat tensors; as many
    repeats run as the leaves hold. `unit_wrapper` wraps each repeat's
    unit_body(x, unit_params) -> (x, aux) (remat, a gather of sharded
    weights). Returns (x, aux sums)."""
    ctx = context or x.shape[1]
    aux_acc = _zero_aux(x.device)
    if not cfg.unit or not cfg.repeats:
        return x, aux_acc

    def unit_body(r, x, unit_params):
        aux: Dict[str, Any] = {}
        for i, blk in enumerate(cfg.unit):
            # the layer names its MoE routing site (moe.RouteTape's key),
            # inside the body, so a remat recompute names it again
            with moe.site(layer=(r, i)):
                x, _, a = block_apply(unit_params[i], cfg, blk, x, pos,
                                      context=ctx, settings=settings)
            _merge_aux(aux, a)
        return x, aux

    first = units[0]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    for r in range(len(first)):
        body = functools.partial(unit_body, r)
        if unit_wrapper:
            body = unit_wrapper(body)
        x, aux = body(x, [_tree_index(t, r) for t in units])
        _merge_aux(aux_acc, aux)
    return x, aux_acc


def _tail_forward(params, cfg: ModelConfig, x, pos, aux_acc, *,
                  settings: ModelSettings, context: int, decode: bool = False,
                  block_tables=None):
    """The tail blocks without a cache; their aux merged into aux_acc."""
    for i, blk in enumerate(cfg.tail):
        with moe.site(layer=("tail", i)):
            x, _, aux = block_apply(params["tail"][i], cfg, blk, x, pos,
                                    decode=decode, context=context,
                                    settings=settings,
                                    block_tables=block_tables)
        _merge_aux(aux_acc, aux)
    return x


def _head(params, cfg: ModelConfig, x):
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return layers.lm_head(head, cfg, x)


def tail_head_forward(params, cfg: ModelConfig, x, pos, *,
                      settings: ModelSettings = ModelSettings(),
                      context: int = 0):
    """The remainder after the unit stack: tail blocks -> final norm -> LM
    head (the last pipeline stage's). Returns (logits f32, aux sums)."""
    ctx = context or x.shape[1]
    aux_acc = _zero_aux(x.device)
    x = _tail_forward(params, cfg, x, pos, aux_acc, settings=settings,
                      context=ctx)
    return _head(params, cfg, x), aux_acc

