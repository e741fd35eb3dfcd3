"""Serving steps: prefill (builds the ring KV caches, returns last-token
logits), decode (one token per sequence against the cache), greedy
generation on top of them; and over the paged KV pool: whole-prompt prefill
into the pool, one batched decode tick through the block tables, its
lane-compacted form, chunked prefill against the live pool, and the pool
operations the serving engine uses.

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

Every step runs under torch.no_grad(): serving builds no autograd graph,
whatever the caller's grad mode (the in-place cache writes could not be
recorded). There is no jit here: the steps run eagerly, and every pool
operation
updates the pool's tensors IN PLACE and returns the same tree (the reference
package returns new arrays from donated buffers). Whole-prompt prefill
writes each layer's K/V into the pool as that layer runs, so the rings of
all layers never exist at once (the reference builds them all, then
scatters them: write_paged_prefill, kept here for a ring tree in hand).

Recurrent blocks (mLSTM, sLSTM, RG-LRU) and attention layers that do not
page (windowed rings) keep their state in per-lane pool leaves ([repeats,]
n_lanes, ...): a step at width w gathers the rows of its lanes into a
sub-pool (a copy), runs on it, and scatters the rows back, dropping padding
rows (lane id >= n_lanes) on the device. At xlstm-1.3b's full width the
state is 0.70 GB per lane (42 mLSTM layers x 16.8 MB of C), at gemma3-12b's
(context 4096) the 40 local rings are 0.34 GB per lane, so each direction
copies that much per lane and step.

The slot pool (`init_slot_pool`) is the ring/slot engine's: one cache tree
whose batch axis is the slot, every attention layer a per-lane ring; a
prefill overwrites whole slots (`write_cache_slot(s)`), decode runs at the
pool's width.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig,
                      settings: Optional[M.ModelSettings] = None):
    """Prefill tokens [b, p] from position 0, after `prefix_embeds` [b, n,
    d] where given (the modality-stub archs: the prompt then spans n + p
    positions): (last-token logits [b, V], the ring cache tree the prompt
    fills)."""
    settings = settings or M.ModelSettings()
    psettings = dataclasses.replace(settings, build_cache=True)

    @torch.no_grad()
    def prefill_step(params, tokens, context: int, prefix_embeds=None):
        logits, cache, _ = M.apply(params, cfg, tokens,
                                   prefix_embeds=prefix_embeds,
                                   settings=psettings, context=context,
                                   logits_last_only=True)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig,
                     settings: Optional[M.ModelSettings] = None):
    """One token per sequence (tokens [b, 1] at positions [b]) against a
    ring cache tree, updated in place: (logits [b, V], cache)."""
    settings = settings or M.ModelSettings()

    @torch.no_grad()
    def decode_step(params, tokens, positions, cache, context: int):
        logits, cache, _ = M.apply(params, cfg, tokens, positions=positions,
                                   cache=cache, decode=True,
                                   settings=settings, context=context)
        return logits[:, -1], cache

    return decode_step


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, prompt_tokens, n_steps: int,
                    context: int, settings: Optional[M.ModelSettings] = None):
    """Greedy decoding, prompt_tokens [b, p] -> [b, n_steps] int32: prefill
    into ring caches, then ring decode. The engine's per-request reference
    path. The step after the last emitted token is not run (its token would
    be dropped)."""
    b, p = prompt_tokens.shape
    prefill = make_prefill_step(cfg, settings)
    decode = make_decode_step(cfg, settings)
    last_logits, cache = prefill(params, prompt_tokens, context=context)
    out = []
    tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
    for t in range(n_steps):
        out.append(tok)
        if t + 1 == n_steps:
            break
        pos = torch.full((b,), p + t, dtype=torch.int32,
                         device=prompt_tokens.device)
        logits, cache = decode(params, tok[:, None], pos, cache,
                               context=context)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Slot pool: a batch of independent ring caches the engine claims and frees
# ---------------------------------------------------------------------------

def init_slot_pool(cfg: ModelConfig, n_slots: int, context: int,
                   device="cuda", model_parallel: int = 1):
    """The engine's KV / recurrent slot pool: one cache tree whose batch
    axis is the slot index; fresh slots hold pos -1 everywhere (every ring
    entry masked) and zero recurrent states; each ring at this rank's
    n_kv_heads / model_parallel heads. Made on `device` (default CUDA;
    raises without a CUDA device)."""
    return M.init_cache(cfg, n_slots, context, device=device,
                        model_parallel=model_parallel)


def write_cache_slots(cfg: ModelConfig, pool, one, slots):
    """Batched write_cache_slot: rows of a width-W prefill cache tree `one`
    into pool slots `slots` [W], IN PLACE. Rows whose slot id is >= the
    pool width are padding and are dropped on the device (no host sync),
    which lets a batched prefill pad every admission group to the pool
    width. Unit leaves have the slot on axis 1, tail leaves on axis 0."""
    for P, o in zip(pool["units"], one["units"]):
        _put_lanes(P, o, slots, 1)
    for P, o in zip(pool["tail"], one["tail"]):
        _put_lanes(P, o, slots, 0)
    return pool


def write_cache_slot(cfg: ModelConfig, pool, one, slot: int):
    """Overwrite slot `slot` of the pool with a single-sequence cache tree
    (batch 1), IN PLACE. Prefill rings always span the full cache_len
    (attention._cache_from_prefill pads short prompts), so this is a
    whole-slot overwrite: whatever a freed slot accumulated while riding
    along in batched decode is wiped on claim."""
    slot = int(slot)
    for P, o in zip(pool["units"], one["units"]):
        for k, t in P.items():
            t.narrow(1, slot, 1).copy_(o[k])
    for P, o in zip(pool["tail"], one["tail"]):
        for k, t in P.items():
            t.narrow(0, slot, 1).copy_(o[k])
    return pool


def make_slot_prefill_step(cfg: ModelConfig,
                           settings: Optional[M.ModelSettings] = None):
    """Prefill ONE sequence (tokens [1, p]) from position 0 into slot
    `slot` of the pool: (last-token logits [1, V], the pool, updated in
    place)."""
    settings = settings or M.ModelSettings()
    psettings = dataclasses.replace(settings, build_cache=True)

    @torch.no_grad()
    def prefill_into_slot(params, tokens, slot, pool, context: int):
        logits, one, _ = M.apply(params, cfg, tokens, settings=psettings,
                                 context=context, logits_last_only=True)
        return logits[:, -1], write_cache_slot(cfg, pool, one, slot)

    return prefill_into_slot


def make_batch_prefill_step(cfg: ModelConfig,
                            settings: Optional[M.ModelSettings] = None):
    """Batched prefill: tokens [W, p] from position 0 (padding rows carry
    dummy prompts), each row written into pool slot `slots[w]` (ids >= the
    pool width are dropped): (last-token logits [W, V], the pool, updated
    in place)."""
    settings = settings or M.ModelSettings()
    psettings = dataclasses.replace(settings, build_cache=True)

    @torch.no_grad()
    def prefill_into_slots(params, tokens, slots, pool, context: int):
        logits, one, _ = M.apply(params, cfg, tokens, settings=psettings,
                                 context=context, logits_last_only=True)
        return logits[:, -1], write_cache_slots(cfg, pool, one, slots)

    return prefill_into_slots


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------

def is_paged_block(blk, context: int) -> bool:
    """Which layers page: attention whose ring spans the full context (the
    dominant KV cost). Short windowed/chunked rings stay per-lane."""
    return blk.is_attn and blk.cache_len(context) == context


def init_paged_pool(cfg: ModelConfig, n_lanes: int, n_blocks: int,
                    block: int, context: int, kv_quant: str = "none",
                    device="cuda", model_parallel: int = 1):
    """The paged serving pool: every paged layer gets block-pool leaves
    (shared across lanes), stacked over repeats like the params.
    `context` must be a multiple of `block` (the executor rounds up).

    kv_quant != "none" stores kb/vb quantized (int8, or int4 packed two
    nibbles per uint8 byte halving the last dim) with per-(position, kv
    head) f32 absmax scales in sibling "ks"/"vs" leaves. The pool is
    self-describing: read/write paths pick the codec off the leaf dtypes.

    Recurrent blocks get per-lane leaves ([repeats,] n_lanes, ...: the
    block's zero state, models.model.state_shapes), so a pool of an
    all-recurrent model pages nothing; attention layers that do not page
    (windowed / chunked rings shorter than the context) get per-lane rings
    of cache_len(context) slots. Position leaves start at -1 (invalid),
    payloads and states at zero. The pool is made on `device` (default
    CUDA; raises without a CUDA device).

    Under tensor parallelism (`model_parallel` ranks on the model axis)
    this rank's pool holds its n_kv_heads / model_parallel kv heads: kb /
    vb (and the ks / vs scales) split over kv heads, every block on every
    rank, and "pos" whole on each. That is the layout the predictor
    charges a device (`predictor._attn_ring_bytes`: ceil(kv heads / model)
    heads, one pos stripe), not the reference's `cache_specs`, whose
    paged leaves ("kb", "vb") fall to its batch-sharded fallback.
    Quantization moves nothing: its absmax scale is per (position, kv
    head)."""
    if context % block:
        raise ValueError(f"paged pool context {context} must be a multiple "
                         f"of the kv block size {block}")
    if kv_quant not in ("none", "int8", "int4"):
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    hd = cfg.resolved_head_dim
    if cfg.n_kv_heads % model_parallel:
        raise ValueError(f"{cfg.n_kv_heads} kv heads do not split over "
                         f"{model_parallel} model ranks")
    K = cfg.n_kv_heads // model_parallel
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
        if blk.is_attn:
            return A.cache_shapes(cfg, blk, n_lanes, context,
                                  model_parallel=model_parallel)
        return M.state_shapes(cfg, blk, n_lanes)

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


def write_paged_prefill(cfg: ModelConfig, pool, one, lanes, tables,
                        block: int):
    """Write a width-W prefill cache tree `one` (make_prefill_step's, every
    ring in identity layout: prefill positions start at 0 and the ring
    spans the full context, so slot i holds position i) into the paged pool,
    IN PLACE: paged layers through `tables` [W, mB]
    (attention.write_prompt_kv per layer), per-lane leaves at rows `lanes`
    [W] (ids >= n_lanes are padding and dropped). `block` must be the
    pool's block size (any, for a pool with nothing paged)."""
    if block != pool_block_size(pool, block):
        raise ValueError(f"block {block} != the pool's "
                         f"{pool_block_size(pool)}")
    for P, o in zip(pool["units"], one["units"]):
        if not _is_paged_leaf(P):
            _put_lanes(P, o, lanes, 1)
            continue
        for r in range(cfg.repeats):
            A.write_prompt_kv({n: t[r] for n, t in P.items()}, tables,
                              o["k"][r], o["v"][r], o["pos"][r])
    for P, o in zip(pool["tail"], one["tail"]):
        if not _is_paged_leaf(P):
            _put_lanes(P, o, lanes, 0)
            continue
        A.write_prompt_kv(P, tables, o["k"], o["v"], o["pos"])
    return pool


def make_paged_prefill_step(cfg: ModelConfig,
                            settings: Optional[M.ModelSettings] = None):
    """Batched whole-prompt prefill into the paged pool: tokens [W, p] from
    position 0, lanes [W], tables [W, mB]. Each layer attends the prompts
    over themselves (the flash-attention kernel on the card) and writes
    their K/V into the pool through the tables as it runs; recurrent blocks
    scan the prompts from a zero state into the gathered rows of `lanes`,
    which are scattered back (padding lanes >= n_lanes dropped). Returns
    (last-token logits [W, V], the pool, updated in place)."""
    settings = settings or M.ModelSettings()
    psettings = dataclasses.replace(settings, build_cache=True)

    @torch.no_grad()
    def prefill_paged(params, tokens, lanes, tables, pool, context: int):
        sub = gather_pool_lanes(pool, lanes)
        logits, new_sub, _ = M.apply(params, cfg, tokens, cache=sub,
                                     settings=psettings, context=context,
                                     logits_last_only=True,
                                     block_tables=tables)
        return logits[:, -1], scatter_pool_lanes(pool, new_sub, lanes)

    return prefill_paged


def make_paged_decode_step(cfg: ModelConfig,
                           settings: Optional[M.ModelSettings] = None):
    """One batched decode tick through the block tables at lane width."""
    settings = settings or M.ModelSettings()

    @torch.no_grad()
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


def _put_lanes(P, o, lane_ids, axis: int):
    """Rows of the per-lane leaves `o` into the pool leaves `P` at
    `lane_ids` along `axis`, IN PLACE. Rows whose id is outside [0,
    n_lanes) are padding; index_copy_ has no drop mode, so they are dropped
    on the device, with no host sync: each is sent to the first kept row's
    lane with that row's values (one value written twice), and where no
    row is kept lane 0 gets its own value back."""
    t0 = next(iter(P.values()))
    n = t0.shape[axis]
    ids = lane_ids.to(device=t0.device).long()
    keep = (ids >= 0) & (ids < n)
    first = torch.argmax(keep.to(torch.int32))     # 0 when nothing is kept
    anyk = keep.any()
    rows = torch.where(keep, torch.arange(ids.shape[0], device=ids.device),
                       first)
    tgt = torch.where(keep, ids, torch.where(anyk, ids[first],
                                             torch.zeros_like(first)))
    for k, t in P.items():
        old0 = t.narrow(axis, 0, 1).clone()
        t.index_copy_(axis, tgt, o[k].index_select(
            axis, rows.to(o[k].device)).to(device=t.device, dtype=t.dtype))
        lane0 = t.narrow(axis, 0, 1)
        lane0.copy_(torch.where(anyk, lane0, old0))


def gather_pool_lanes(pool, lane_ids):
    """Sub-pool of a paged pool at lanes `lane_ids` [w]: paged block-pool
    leaves pass through whole — the SAME tensors (block tables route them,
    so they need no lane axis), so a step that writes the sub-pool writes
    the pool; per-lane leaves (recurrent states, windowed rings) are
    gathered down to width w, a COPY, to be written back with
    scatter_pool_lanes. Padding ids >=
    n_lanes clamp to a real lane on the read — harmless, because the
    scatter drops their rows."""
    def take(P, axis):
        if _is_paged_leaf(P):
            return P
        n = next(iter(P.values())).shape[axis]
        idx = torch.clamp(lane_ids.long(), 0, n - 1)
        return {k: t.index_select(axis, idx.to(t.device))
                for k, t in P.items()}

    return {"units": [take(P, 1) for P in pool["units"]],
            "tail": [take(P, 0) for P in pool["tail"]]}


def scatter_pool_lanes(pool, sub, lane_ids):
    """Write a width-w sub-pool (gather_pool_lanes layout) back into the
    full pool, IN PLACE: per-lane rows land at `lane_ids`, rows with ids
    >= n_lanes (padding) removed first; paged leaves were updated in place
    through the shared tensors and are left as they are. Returns the
    pool."""
    for P, o in zip(pool["units"], sub["units"]):
        if not _is_paged_leaf(P):
            _put_lanes(P, o, lane_ids, 1)
    for P, o in zip(pool["tail"], sub["tail"]):
        if not _is_paged_leaf(P):
            _put_lanes(P, o, lane_ids, 0)
    return pool


def make_compact_decode_step(cfg: ModelConfig,
                             settings: Optional[M.ModelSettings] = None):
    """Paged decode at a COMPACTED width w <= n_lanes: run one batched
    decode at width w through the active lanes' (trimmed) block tables. A
    tick with 3 active lanes stops paying for the padded remainder of the
    pool. Padding rows carry position -1 and an empty table: inert (their
    recurrent rows keep their state, and the scatter drops them). The
    lanes' per-lane rows are gathered, stepped and written back."""
    settings = settings or M.ModelSettings()

    @torch.no_grad()
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
    history + chunk, which is exactly that slice of a whole-prompt prefill;
    recurrent blocks continue each lane's carried state (rows starting at
    position 0 restart from a fresh one) and are written back. Returns each
    row's last-valid-position logits (meaningful for rows whose chunk
    completes the prompt) and the pool, updated in place.

    Only each row's last valid position goes through the final norm and the
    LM head: the values are those the reference package selects after
    computing every position's logits."""
    settings = settings or M.ModelSettings()

    @torch.no_grad()
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
    `default` covers pools with nothing to page (all-recurrent models)."""
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
