"""Model assembly: embedding -> pattern units -> tail -> norm -> head.

The depth pattern (configs.base: unit x repeats + tail) keeps the reference
package's parameter layout: parameters and caches are *stacked over repeats*
per unit position (leading axis = repeat). Where the reference scans over
that axis, this package runs a Python loop over the layers and hands each
layer a view `leaf[r]` of the stacked tensors; caches are updated in place
through those views.

Ported: attention mixers with a dense MLP, decode and chunk-append forward
against a cache. Recurrent mixers, MoE and the cache-free sequence forward
raise NotImplementedError naming what lifts them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import (ATTN, MLP_DENSE, MLP_MOE, MLP_NONE,
                                      BlockSpec, ModelConfig)
from repro_torch.models import attention, layers


@dataclasses.dataclass(frozen=True)
class ModelSettings:
    attn: attention.AttnSettings = attention.AttnSettings()


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
    h = layers.rmsnorm(params["norm"], x, cfg.norm_eps)
    up = layers.matmul(h, params["wi"])
    if layers.is_glu(cfg.activation):
        gate, val = torch.chunk(up, 2, dim=-1)
        act = layers.glu_combine(cfg.activation, gate, val)
    else:
        act = layers.ACTIVATIONS[cfg.activation](up)
    return layers.matmul(act, params["wo"])


# ---------------------------------------------------------------------------
# Block = mixer + channel mixer
# ---------------------------------------------------------------------------

def _check_block(blk: BlockSpec):
    if blk.mixer != ATTN:
        raise NotImplementedError(
            f"mixer {blk.mixer!r}: needs the recurrent-mixer slice "
            "(mlstm_scan_fwd, sLSTM, RG-LRU)")
    if blk.mlp == MLP_MOE:
        raise NotImplementedError("MoE MLP: needs the MoE slice")
    if blk.mlp not in (MLP_DENSE, MLP_NONE):
        raise ValueError(blk.mlp)


def block_init(gen, cfg: ModelConfig, blk: BlockSpec, device,
               repeats: int = 0):
    _check_block(blk)
    p: Dict[str, Any] = {"mixer": attention.attn_init(gen, cfg, device,
                                                      repeats)}
    if blk.mlp == MLP_DENSE:
        p["mlp"] = mlp_init(gen, cfg, device, repeats)
    return p


def block_apply(params, cfg: ModelConfig, blk: BlockSpec, x, positions,
                cache=None, decode: bool = False, context: int = 0,
                settings: ModelSettings = ModelSettings(),
                block_tables=None):
    """Returns (x', cache, aux). The cache is updated in place."""
    _check_block(blk)
    delta, new_cache, aux = attention.attn_apply(
        params["mixer"], cfg, blk, x, positions, cache=cache,
        decode=decode, context=context, settings=settings.attn,
        block_tables=block_tables)
    x = x + delta
    if blk.mlp == MLP_DENSE:
        x = x + mlp_apply(params["mlp"], cfg, x)
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


def _tree_index(tree, r: int):
    """View r of every stacked leaf of a (nested dict) tree."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, r) for k, v in tree.items()}
    return tree[r]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def apply(params, cfg: ModelConfig, tokens, *, positions=None,
          cache=None, decode: bool = False,
          settings: ModelSettings = ModelSettings(), context: int = 0,
          logits_last_only: bool = False, block_tables=None,
          head_rows=None):
    """Forward pass against a cache.

    tokens [b, s] (s=1 for decode); positions [b] for decode, [b, s]
    absolute positions for a mid-prompt chunk (-1 marks padding);
    block_tables [b, max_blocks] maps each sequence's logical KV blocks to
    physical blocks of a paged pool cache (-1 = unassigned).
    Returns (logits f32, cache, aux). The cache's tensors are updated IN
    PLACE and the same tree is returned (the reference package returns a new
    tree). Without a cache this needs the whole-prompt prefill slice.

    `head_rows` [b] (sequence path only) sends just position head_rows[i]
    of row i through the final norm and the LM head: logits [b, 1, V]. Both
    are per-position functions, so the values equal those rows of the full
    logits; a chunk of 256 positions then costs one head product, not 256.
    """
    b = tokens.shape[0]
    x = layers.embed_lookup(params["embed"], cfg, tokens)
    s = x.shape[1]
    if decode:
        assert positions is not None
        pos = positions[:, None]                      # [b, 1]
    elif positions is not None:
        pos = positions
    else:
        pos = torch.arange(s, dtype=torch.int32,
                           device=x.device)[None].expand(b, s)
    ctx = context or s

    aux_acc: Dict[str, Any] = {}
    have_cache = cache is not None

    def run_block(p, blk, x, c):
        x, _, aux = block_apply(p, cfg, blk, x, pos, cache=c, decode=decode,
                                context=ctx, settings=settings,
                                block_tables=block_tables)
        for k, v in aux.items():
            aux_acc[k] = aux_acc[k] + v if k in aux_acc else v
        return x

    for r in range(cfg.repeats):
        for i, blk in enumerate(cfg.unit):
            c = _tree_index(cache["units"][i], r) if have_cache else None
            x = run_block(_tree_index(params["units"][i], r), blk, x, c)
    for i, blk in enumerate(cfg.tail):
        c = cache["tail"][i] if have_cache else None
        x = run_block(params["tail"][i], blk, x, c)

    if head_rows is not None and not decode:
        x = torch.gather(
            x, 1, head_rows.long()[:, None, None].expand(b, 1, x.shape[-1]))
    elif logits_last_only and not decode:
        x = x[:, -1:]
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = layers.lm_head(head, cfg, x)
    return logits, cache, aux_acc
