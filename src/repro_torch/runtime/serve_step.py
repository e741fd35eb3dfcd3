"""Serving steps over the paged KV pool: one batched decode tick through the
block tables, its lane-compacted form, chunked prefill against the live
pool, and the pool operations the serving engine uses.

Paged-pool notes (see serving.engine for the admission/eviction policy):

- Block tables are the ONLY routing state. A physical block written once
  can be mapped by many tables at once — refcounted prefix sharing needs no
  extra step: sharers seed the leading entries of their table with the
  shared prefix's physical ids and prefill only their suffix.
- Decode ticks run at full lane width; rows whose lane is empty or still
  mid-chunk-prefill are INERT (position -1, empty table) and their writes
  land in scratch block 0 (see attention._paged_write), so a decode tick can
  never clobber KV a concurrent chunked prefill wrote.
- Eviction frees physical blocks but writes nothing: reset_pool_blocks
  invalidates re-linked blocks (pos -1) before a NEW owner's table routes a
  read through them.

There is no jit here: the steps run eagerly, and every pool operation
updates the pool's tensors IN PLACE and returns the same tree (the reference
package returns new arrays from donated buffers). Not ported yet: the
whole-prompt prefill steps and greedy_generate (flash_attention_fwd slice),
the ring slot pool (ring/slot slice).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def is_paged_block(blk, context: int) -> bool:
    """Which layers page: attention whose ring spans the full context (the
    dominant KV cost). Short windowed/chunked rings stay per-lane."""
    return blk.is_attn and blk.cache_len(context) == context


def init_paged_pool(cfg: ModelConfig, n_lanes: int, n_blocks: int,
                    block: int, context: int, kv_quant: str = "none",
                    device="cuda"):
    """The paged serving pool: every paged layer gets block-pool leaves
    (shared across lanes), stacked over repeats like the params.
    `context` must be a multiple of `block` (the executor rounds up).

    kv_quant != "none" stores kb/vb quantized (int8, or int4 packed two
    nibbles per uint8 byte halving the last dim) with per-(position, kv
    head) f32 absmax scales in sibling "ks"/"vs" leaves. The pool is
    self-describing: read/write paths pick the codec off the leaf dtypes.

    Position leaves start at -1 (invalid), payloads at zero. The pool is
    made on `device` (default CUDA; raises without a CUDA device).
    Layers that do not page (windowed / chunked rings, recurrent state) need
    the ring/slot and recurrent slices and raise NotImplementedError."""
    if context % block:
        raise ValueError(f"paged pool context {context} must be a multiple "
                         f"of the kv block size {block}")
    if kv_quant not in ("none", "int8", "int4"):
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    hd = cfg.resolved_head_dim
    K = cfg.n_kv_heads
    if kv_quant == "int4" and hd % 2:
        raise ValueError(f"int4 KV packs nibble pairs; head_dim {hd} "
                         "must be even")
    device = M.require_device(device)

    def paged_leaf():
        if kv_quant == "none":
            return {
                "kb": ((n_blocks, block, K, hd), torch.bfloat16),
                "vb": ((n_blocks, block, K, hd), torch.bfloat16),
                "pos": ((n_blocks, block), torch.int32),
            }
        qdt = torch.int8 if kv_quant == "int8" else torch.uint8
        qhd = hd if kv_quant == "int8" else hd // 2
        return {
            "kb": ((n_blocks, block, K, qhd), qdt),
            "vb": ((n_blocks, block, K, qhd), qdt),
            "ks": ((n_blocks, block, K), torch.float32),
            "vs": ((n_blocks, block, K), torch.float32),
            "pos": ((n_blocks, block), torch.int32),
        }

    def one_cache(blk):
        if is_paged_block(blk, context):
            return paged_leaf()
        raise NotImplementedError(
            f"per-lane cache for block {blk}: needs the ring/slot slice "
            "(windowed layers) or the recurrent-mixer slice")

    def materialize(spec, lead=()):
        shape, dt = spec
        shape = tuple(lead) + tuple(shape)
        if dt == torch.int32:       # position buffers start invalid
            return torch.full(shape, -1, dtype=dt, device=device)
        return torch.zeros(shape, dtype=dt, device=device)

    pool = {"units": [{k: materialize(s, (cfg.repeats,))
                       for k, s in one_cache(blk).items()}
                      for blk in cfg.unit],
            "tail": [{k: materialize(s) for k, s in one_cache(blk).items()}
                     for blk in cfg.tail]}
    return pool


def make_paged_decode_step(cfg: ModelConfig,
                           settings: Optional[M.ModelSettings] = None):
    """One batched decode tick through the block tables at lane width."""
    settings = settings or M.ModelSettings()

    def decode_paged(params, tokens, positions, tables, pool, context: int):
        logits, new_pool, aux = M.apply(params, cfg, tokens,
                                        positions=positions, cache=pool,
                                        decode=True, settings=settings,
                                        context=context, block_tables=tables)
        # mass [b, max_blocks] (layer-summed per-block attention mass) when
        # settings.attn.track_mass, else None — the retention policy's feed
        return logits[:, -1], new_pool, aux.get("attn_mass")

    return decode_paged


def _is_paged_leaf(P) -> bool:
    return isinstance(P, dict) and "kb" in P


def _lane_leaves_unsupported():
    return NotImplementedError(
        "per-lane pool leaves (windowed rings, recurrent state): need the "
        "ring/slot and recurrent-mixer slices")


def gather_pool_lanes(pool, lane_ids):
    """Sub-pool view of a paged pool at lanes `lane_ids` [w]: paged
    block-pool leaves pass through whole (block tables route them, so they
    need no lane axis) — the SAME tensors, so a step that writes the
    sub-pool writes the pool. Per-lane leaves are not ported yet, so today
    this gathers nothing and `lane_ids` goes unused: it keeps the place
    where the ring/slot slice will select per-lane rows."""
    for P in list(pool["units"]) + list(pool["tail"]):
        if not _is_paged_leaf(P):
            raise _lane_leaves_unsupported()
    return {"units": list(pool["units"]), "tail": list(pool["tail"])}


def scatter_pool_lanes(pool, sub, lane_ids):
    """Write a width-w sub-pool (gather_pool_lanes layout) back into the
    full pool. Paged leaves were updated in place through shared tensors,
    so they are returned as they are: today this scatters nothing. Lane ids >= n_lanes mark padding rows;
    with no per-lane leaf ported there is nothing of theirs to filter out
    here (index_put_ has no drop mode: when per-lane leaves arrive, rows
    with such ids must be removed before the scatter)."""
    for P in list(pool["units"]) + list(pool["tail"]):
        if not _is_paged_leaf(P):
            raise _lane_leaves_unsupported()
    return {"units": list(sub["units"]), "tail": list(sub["tail"])}


def make_compact_decode_step(cfg: ModelConfig,
                             settings: Optional[M.ModelSettings] = None):
    """Paged decode at a COMPACTED width w <= n_lanes: run one batched
    decode at width w through the active lanes' (trimmed) block tables. A
    tick with 3 active lanes stops paying for the padded remainder of the
    pool. Padding rows carry position -1 and an empty table: inert."""
    settings = settings or M.ModelSettings()

    def decode_compact(params, tokens, positions, tables, lane_ids, pool,
                       context: int):
        sub = gather_pool_lanes(pool, lane_ids)
        logits, new_sub, aux = M.apply(params, cfg, tokens,
                                       positions=positions, cache=sub,
                                       decode=True, settings=settings,
                                       context=context, block_tables=tables)
        return (logits[:, -1], scatter_pool_lanes(pool, new_sub, lane_ids),
                aux.get("attn_mass"))

    return decode_compact


def make_chunk_prefill_step(cfg: ModelConfig,
                            settings: Optional[M.ModelSettings] = None):
    """Chunked prefill: run tokens [w, C] at absolute positions [w, C]
    (-1 = padding) against the LIVE pool — paged attention layers append the
    chunk through `tables` to what earlier chunks wrote and attend over
    history + chunk, which is exactly that slice of a whole-prompt prefill.
    Returns each row's last-valid-position logits (meaningful for rows
    whose chunk completes the prompt) and the pool, updated in place.

    Only each row's last valid position goes through the final norm and the
    LM head: the values are those the reference package selects after
    computing every position's logits."""
    settings = settings or M.ModelSettings()

    def prefill_chunk(params, tokens, positions, tables, lane_ids, pool,
                      context: int):
        sub = gather_pool_lanes(pool, lane_ids)
        lens = torch.sum(positions >= 0, dim=1)
        idx = torch.clamp(lens - 1, min=0)
        logits, new_sub, _ = M.apply(params, cfg, tokens,
                                     positions=positions, cache=sub,
                                     decode=False, settings=settings,
                                     context=context, block_tables=tables,
                                     head_rows=idx)
        return logits[:, 0], scatter_pool_lanes(pool, new_sub, lane_ids)

    return prefill_chunk


def pool_block_size(pool, default: int = 0) -> int:
    """The kv block size a paged pool was built with (from any paged leaf).
    `default` covers pools with nothing to page."""
    for P in list(pool["units"]) + list(pool["tail"]):
        if isinstance(P, dict) and "kb" in P:
            return int(P["pos"].shape[-1])
    return default


def reset_pool_blocks(pool, ids):
    """Invalidate physical blocks `ids` [W] (pos = -1), IN PLACE, before a
    freed block is re-linked into a new sequence's table mid-decode —
    without it the block's stale positions from its previous owner would
    pass the decode mask. Padding entries may point at scratch block 0
    (reset is harmless there)."""
    ids = ids.long()
    for P in pool["units"]:
        if _is_paged_leaf(P):
            P["pos"][:, ids] = -1
    for P in pool["tail"]:
        if _is_paged_leaf(P):
            P["pos"][ids] = -1
    return pool


def clear_pool(pool):
    """Re-initialize a live pool wholesale, IN PLACE: every int32 validity
    buffer back to -1, every payload leaf to zeros — `init_paged_pool`'s
    freshly-materialized state without rebuilding the tree. This is the
    executor-REUSE hook for engine snapshot/restore."""
    for P in list(pool["units"]) + list(pool["tail"]):
        for leaf in P.values():
            if leaf.dtype == torch.int32:
                leaf.fill_(-1)
            else:
                leaf.zero_()
    return pool
