"""GQA attention: the sequence path (whole-prompt prefill), the per-lane
ring cache it builds, and a paged KV pool for serving, after the reference
package's attention module.

Backends:
  kernel — kernels.ops (hand-written CUDA kernels for a CUDA tensor, their
           plain PyTorch versions for a CPU tensor). The default.
  naive  — the plain path on either device: dense masked softmax over the
           whole sequence, or over the ring / gathered virtual ring.

Paths:
  sequence  — whole-prompt prefill: flash attention of the prompt over
              itself; it can build a ring cache (`cache="build"`) or write
              its K/V into a paged pool through the block tables.
  decode    — one token per lane against a paged pool (block tables) or a
              per-lane ring cache.
  chunk     — a prompt chunk appended to a paged pool or a per-lane ring
              and attended over history + chunk.

Per-lane rings (windowed layers, the slot pool, greedy generation): ring
decode goes through the ring decode kernel (backend "kernel") or the dense
softmax; a chunk appended to a ring attends over concat(ring, chunk) in
plain torch, as the reference does. Ring writes drop inert and padding rows
on the device (`ring_write`): no host sync.

Caches are updated IN PLACE: where the reference package returns new arrays,
`ring_write`, `write_prompt_kv`, `_paged_write`, `_paged_write_chunk`, the
whole-prompt write of a pool's ring and the kernels store into the cache's
own tensors and hand the same dict back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import layers
from repro_torch.parallel import comm

NEG_INF = -1e30

BACKENDS = ("kernel", "naive")


@dataclasses.dataclass(frozen=True)
class AttnSettings:
    backend: str = "kernel"      # kernel | naive
    # Paged decode: emit per-logical-block attention mass ([b, max_blocks],
    # softmax weight summed within each block, averaged over heads) in the
    # attn aux dict — the signal the serving engine's block-granular
    # retention policy (MemoryPlan.kv_retain) ranks blocks by.
    track_mass: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"AttnSettings.backend {self.backend!r} not in "
                             f"{BACKENDS}")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, device, repeats: int = 0):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = layers.torch_dtype(cfg.param_dtype)
    return {
        "norm": layers.rmsnorm_init(d, dt, device, repeats),
        "wq": layers.dense_init(gen, d, cfg.n_heads * hd, dt, device, repeats),
        "wk": layers.dense_init(gen, d, cfg.n_kv_heads * hd, dt, device,
                                repeats),
        "wv": layers.dense_init(gen, d, cfg.n_kv_heads * hd, dt, device,
                                repeats),
        "wo": layers.dense_init(gen, cfg.n_heads * hd, d, dt, device, repeats),
    }


# ---------------------------------------------------------------------------
# Masks and the dense (plain) attention
# ---------------------------------------------------------------------------

def _mask(qpos, kpos, blk: BlockSpec):
    """qpos [..., sq], kpos [..., skv] -> bool [..., sq, skv]."""
    q = qpos[..., :, None].to(torch.int32)
    k = kpos[..., None, :].to(torch.int32)
    m = (k <= q) & (k >= 0)
    if blk.window is not None:
        m &= k > q - blk.window
    if blk.chunk is not None:
        m &= torch.div(k, blk.chunk, rounding_mode="floor") == \
            torch.div(q, blk.chunk, rounding_mode="floor")
    return m


def _sdpa(q, k, v, mask):
    """q [b,sq,K,G,hd], k/v [b,skv,K,hd], mask [b,sq,skv] -> [b,sq,K,G,hd]."""
    hd = q.shape[-1]
    scale = 1.0 / np.sqrt(hd)
    s = layers.einsum_f32("bqkgh,bskh->bkgqs", q, k) * scale
    s = torch.where(mask[:, None, None, :, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = layers.einsum_f32("bkgqs,bskh->bqkgh", p, v)
    return o.to(q.dtype)


def _naive(q, k, v, qpos, kpos, blk: BlockSpec):
    return _sdpa(q, k, v, _mask(qpos, kpos, blk))


def _seq_attention(q, k, v, qpos, kpos, blk: BlockSpec,
                   settings: AttnSettings):
    """q [b,s,K,G,hd], k/v [b,s,K,hd], qpos/kpos [b,s] -> [b,s,K,G,hd]:
    the flash-attention kernel (backend "kernel") or dense softmax. When
    autograd records (grad mode on and q, k or v requiring a gradient) the
    kernel goes through flash_attention_trainable, whose backward is the
    flash-backward kernel; otherwise through the forward-only call. The
    dense path is plain autograd."""
    if settings.backend == "kernel":
        from repro_torch.kernels import ops as kops
        records = torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)
        fn = kops.flash_attention_trainable if records else kops.flash_attention
        return fn(q, k, v, qpos, kpos, window=blk.window, chunk=blk.chunk)
    return _naive(q, k, v, qpos, kpos, blk)


# ---------------------------------------------------------------------------
# Ring-buffer KV cache
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, blk: BlockSpec, batch: int,
                 context: int, dtype=torch.bfloat16, model_parallel: int = 1):
    """{leaf: (shape, dtype)} of a per-lane ring of cache_len(context)
    slots, at this rank's n_kv_heads / model_parallel heads."""
    L = blk.cache_len(context)
    shape = (batch, L, cfg.n_kv_heads // model_parallel,
             cfg.resolved_head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype),
            "pos": ((batch, L), torch.int32)}


def cache_init(cfg: ModelConfig, blk: BlockSpec, batch: int, context: int,
               dtype=torch.bfloat16, device="cuda", model_parallel: int = 1):
    """An empty per-lane ring of cache_len(context) slots (pos -1)."""
    return {k: (torch.full(sh, -1, dtype=dt, device=device)
                if dt == torch.int32 else
                torch.zeros(sh, dtype=dt, device=device))
            for k, (sh, dt) in cache_shapes(cfg, blk, batch, context, dtype,
                                            model_parallel).items()}


def _cache_from_prefill(k, v, positions, blk: BlockSpec, context: int):
    """Build a ring cache holding the last cache_len positions of a prefill.

    Always emits the FULL cache_len(context) ring: a prompt shorter than the
    ring pads the empty slots with pos=-1 (masked). Without the padding a
    short-prompt prefill would hand decode a ring of length prompt_len whose
    slot = pos % prompt_len mapping evicts live context early (a global
    layer's ring must only wrap at cache_len)."""
    L = blk.cache_len(context)
    k_t, v_t, p_t = k[:, -L:], v[:, -L:], positions[:, -L:]
    pad = L - k_t.shape[1]
    if pad > 0:
        # prefill positions start at 0, so occupied slots are already at
        # pos % L = 0..p-1; empty tail slots stay invalid
        k_t = F.pad(k_t, (0, 0, 0, 0, 0, pad))
        v_t = F.pad(v_t, (0, 0, 0, 0, 0, pad))
        p_t = F.pad(p_t, (0, pad), value=-1)
    # Ring layout: slot = pos % L. For contiguous positions that's a roll
    # by the first position (uniform across batch: packed sequences), taken
    # as a gather with the index made on the device: no host sync (and a
    # step on the meta device, roofline.count, needs none).
    src = torch.remainder(
        torch.arange(L, device=p_t.device) - p_t[0, :1].long(), L)
    return {"k": k_t[:, src], "v": v_t[:, src], "pos": p_t[:, src]}


def ring_write(cache, positions, k, v):
    """Write rows k/v [b, C, K, hd] at positions [b, C] (-1 = padding) into
    the per-lane ring IN PLACE at slot = pos % L, keeping only the
    positions inside each row's final window (pos > row's last - L: a chunk
    longer than the ring would otherwise wrap onto itself). Padding and
    dropped entries are redirected on the device, with no host sync: in a
    row with a kept entry they rewrite the row's last entry's slot with that
    entry's own values; in a row with none they rewrite slot 0 with what it
    holds. Every slot written twice gets one value, so the order of
    index_put_'s writes does not matter."""
    b, C = positions.shape
    L = cache["pos"].shape[1]
    pos = positions.long()
    valid = pos >= 0
    masked = torch.where(valid, pos, torch.full_like(pos, -1))
    row_end, last = masked.max(dim=1, keepdim=True)              # [b, 1]
    keep = valid & (pos > row_end - L)
    has = row_end >= 0
    bidx = torch.arange(b, device=pos.device)[:, None].expand(b, C)
    slot = torch.where(keep, torch.remainder(pos, L),
                       torch.where(has, torch.remainder(row_end, L),
                                   torch.zeros_like(pos)))
    for name, x in (("k", k), ("v", v)):
        t = cache[name]
        x = x.to(t.dtype)
        fill = torch.where(
            has[:, :, None, None],
            torch.gather(x, 1, last[:, :, None, None].expand(
                -1, -1, *x.shape[2:])),
            t[:, :1])                                       # [b, 1, K, hd]
        t.index_put_((bidx, slot), torch.where(keep[:, :, None, None], x,
                                               fill))
    old0 = cache["pos"][:, :1].long()
    cache["pos"].index_put_((bidx, slot), torch.where(
        keep, pos, torch.where(has, row_end, old0)).to(cache["pos"].dtype))
    return cache


_PLAIN = AttnSettings(backend="naive")


def _ring_decode(q, cache, blk: BlockSpec, pos1, k1, v1,
                 settings: AttnSettings = _PLAIN):
    """One decode step against a per-lane ring cache: write k1/v1 [b,K,hd]
    at slot pos1 % L IN PLACE (inert rows, pos1 < 0, drop their write on
    the device: ring_write), then attend over the ring (_decode_attend)."""
    ring_write(cache, pos1[:, None], k1[:, None], v1[:, None])
    return _decode_attend(q, cache, blk, pos1, settings=settings)


def _decode_attend(q, cache, blk: BlockSpec, positions,
                   return_probs: bool = False,
                   settings: AttnSettings = _PLAIN):
    """q [b,1,K,G,hd], cache k/v [b,L,K,hd]; positions [b]. Backend
    "kernel" goes through kernels.ops.decode_attention (the ring decode
    kernel on the card: an inert lane gives zeros); "naive" is the dense
    masked softmax (an inert lane gives the mean of its ring), which also
    returns the probabilities when asked."""
    if settings.backend == "kernel":
        if return_probs:
            raise ValueError("the ring decode kernel returns no "
                             "probabilities: use backend 'naive'")
        from repro_torch.kernels import ops as kops
        o = kops.decode_attention(q[:, 0], cache["k"], cache["v"],
                                  cache["pos"], positions.to(torch.int32),
                                  window=blk.window, chunk=blk.chunk)
        return o[:, None]
    hd = q.shape[-1]
    scale = 1.0 / np.sqrt(hd)
    s = layers.einsum_f32("bqkgh,bskh->bkgqs", q, cache["k"]) * scale
    msk = _mask(positions[:, None], cache["pos"], blk)       # [b, 1, L]
    s = torch.where(msk[:, None, None, :, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = layers.einsum_f32("bkgqs,bskh->bqkgh", p, cache["v"])
    if return_probs:
        return o.to(q.dtype), p
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# Paged KV pool (serving decode)
# ---------------------------------------------------------------------------
#
# A paged layer cache is {"kb": [n_blocks, block, K, hd], "vb": ...,
# "pos": [n_blocks, block]} — storage is a POOL of fixed-size position
# blocks shared by every sequence, and each sequence's logical layout is a
# block table [max_blocks] mapping logical block j (positions j*block ..
# (j+1)*block - 1) to a physical block id (-1 = not yet allocated).
# Physical block 0 is the SCRATCH block: inactive decode lanes (table all
# -1) write it harmlessly and nothing ever reads it as valid (its positions
# stay -1).
#
# QUANTIZED pools (MemoryPlan.kv_quant) additionally carry per-token
# per-head f32 absmax scales {"ks": [n_blocks, block, K], "vs": ...}; the
# pool is SELF-DESCRIBING — kb dtype int8 => "int8", uint8 => "int4"
# (two nibbles per byte, offset +8) — so every read/write path picks the
# codec from the cache itself. Scales are per-token rows, so appending a
# token to a block never rescales entries already written.

KV_QUANT_MAX = {"int8": 127.0, "int4": 7.0}


def paged_quant_kind(cache) -> str:
    """Storage codec of a paged layer cache, read off its own leaves."""
    if "ks" not in cache:
        return "none"
    return "int8" if cache["kb"].dtype == torch.int8 else "int4"


def quantize_kv(x, kind: str):
    """Encode K/V rows for pool storage: x [..., hd] fp ->
    (q [..., hd] int8 | [..., hd//2] uint8, scale [...] f32). Per-row
    (token, head) absmax scales: |dequant - x| <= scale / 2 per element.
    The scale is absmax / qmax and the code round(x / max(scale, 1e-30)),
    both by true division and round-half-to-even: the CUDA write kernel
    takes the same form, so codes are exact between the two. (qmax is made
    a tensor on purpose: PyTorch divides a CUDA tensor by a Python scalar
    as a multiplication by the reciprocal, which moves scales by 1 ULP.)"""
    if kind == "none":
        return x, None
    qmax = KV_QUANT_MAX[kind]
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / torch.full(
        (), qmax, dtype=torch.float32, device=xf.device)
    q = torch.round(xf / torch.clamp(scale, min=1e-30)[..., None])
    q = torch.clamp(q, -qmax, qmax)
    if kind == "int8":
        return q.to(torch.int8), scale
    nib = (q + 8.0).to(torch.uint8)              # 1..15 (0 unused)
    lo, hi = nib[..., 0::2], nib[..., 1::2]
    return (lo | (hi << 4)).to(torch.uint8), scale


def dequantize_kv(q, scale, kind: str, dtype=torch.bfloat16):
    """Decode pool-stored K/V rows back to fp (inverse of quantize_kv)."""
    if kind == "none":
        return q
    if kind == "int8":
        return (q.float() * scale[..., None]).to(dtype)
    lo = (q & 0xF).to(torch.int32) - 8
    hi = (q >> 4).to(torch.int32) - 8
    full = torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1],
                                                 q.shape[-1] * 2)
    return (full.float() * scale[..., None]).to(dtype)


def is_paged_cache(cache) -> bool:
    return isinstance(cache, dict) and "kb" in cache


def _paged_write(cache, block_tables, k1, v1, pos1):
    """Write one token per lane (k1/v1 [b,K,hd], pos1 [b]) into the pool IN
    PLACE at (table[pos // block], pos % block). Lanes with no block mapped
    (table entry -1) and INERT lanes (pos1 < 0 — a padding row the engine
    carries at full decode width while the lane is empty or mid-chunk-
    prefill) land in the scratch block with pos -1, so they can never
    clobber live KV. Several such rows may hit the same scratch slot; which
    payload wins is unspecified and irrelevant, the position stored is -1
    for all of them."""
    n_blocks, bsz = cache["pos"].shape
    m_blocks = block_tables.shape[1]
    live = pos1 >= 0
    safe_pos = torch.where(live, pos1, torch.zeros_like(pos1)).long()
    lb = torch.clamp(safe_pos // bsz, max=m_blocks - 1)
    off = safe_pos % bsz
    phys = torch.gather(block_tables.long(), 1, lb[:, None])[:, 0]
    phys = torch.where(live & (phys >= 0), phys, torch.zeros_like(phys))
    kind = paged_quant_kind(cache)
    kq, ks = quantize_kv(k1, kind)
    vq, vs = quantize_kv(v1, kind)
    cache["kb"].index_put_((phys, off), kq.to(cache["kb"].dtype))
    cache["vb"].index_put_((phys, off), vq.to(cache["vb"].dtype))
    cache["pos"].index_put_(
        (phys, off), torch.where(live, pos1, torch.full_like(pos1, -1)
                                 ).to(cache["pos"].dtype))
    if kind != "none":
        cache["ks"].index_put_((phys, off), ks)
        cache["vs"].index_put_((phys, off), vs)
    return cache


def _paged_gather(cache, block_tables, dequant_dtype=torch.bfloat16):
    """Gather each lane's blocks into a contiguous virtual ring
    ([b, max_blocks*block, ...]): unassigned table entries read the scratch
    block with their positions masked to -1, so downstream masking treats
    them as empty slots. Rows of a quantised pool are dequantised to
    `dequant_dtype` (bf16, as the reference package's gather path does)."""
    b, m_blocks = block_tables.shape
    bsz = cache["pos"].shape[1]
    tbl = block_tables.long()
    safe = torch.where(tbl >= 0, tbl, torch.zeros_like(tbl))
    pos = torch.where(tbl[..., None] >= 0, cache["pos"][safe],
                      torch.full_like(cache["pos"][safe], -1))
    kind = paged_quant_kind(cache)
    k, v = cache["kb"][safe], cache["vb"][safe]  # [b, mB, bs, K, hd']
    if kind != "none":
        k = dequantize_kv(k, cache["ks"][safe], kind, dequant_dtype)
        v = dequantize_kv(v, cache["vs"][safe], kind, dequant_dtype)
    return {
        "k": k.reshape(b, m_blocks * bsz, *k.shape[3:]),
        "v": v.reshape(b, m_blocks * bsz, *v.shape[3:]),
        "pos": pos.reshape(b, m_blocks * bsz),
    }


def _paged_write_chunk(cache, block_tables, k, v, positions):
    """Write a prompt chunk per lane (k/v [b, C, K, hd], positions [b, C],
    -1 = padding) into the pool IN PLACE through the block tables. Padding
    entries and entries whose logical block is unmapped land in the scratch
    block with pos -1, so nothing real can be clobbered and nothing stale
    can pass the mask."""
    n_blocks, bsz = cache["pos"].shape
    m_blocks = block_tables.shape[1]
    valid = positions >= 0
    safe_pos = torch.where(valid, positions,
                           torch.zeros_like(positions)).long()
    lb = torch.clamp(safe_pos // bsz, 0, m_blocks - 1)       # [b, C]
    phys = torch.gather(block_tables.long(), 1, lb)
    phys = torch.where(valid & (phys >= 0), phys, torch.zeros_like(phys))
    off = safe_pos % bsz
    kind = paged_quant_kind(cache)
    kq, ks = quantize_kv(k, kind)
    vq, vs = quantize_kv(v, kind)
    cache["kb"].index_put_((phys, off), kq.to(cache["kb"].dtype))
    cache["vb"].index_put_((phys, off), vq.to(cache["vb"].dtype))
    cache["pos"].index_put_(
        (phys, off), torch.where(valid, positions,
                                 torch.full_like(positions, -1)
                                 ).to(cache["pos"].dtype))
    if kind != "none":
        cache["ks"].index_put_((phys, off), ks)
        cache["vs"].index_put_((phys, off), vs)
    return cache


def write_prompt_kv(cache, block_tables, k, v, positions):
    """Whole-prompt prefill of one paged layer, IN PLACE: row i's K/V (k/v
    [b, s, K, hd] at positions [b, s], -1 = padding) land at (table[pos //
    block], pos % block), quantised for an int8/int4 pool, and every slot
    of a MAPPED block past the row's last position is emptied (pos -1, the
    payload and scale of a zero row), so a reused block never shows its
    previous owner's positions. On mapped blocks the pool then equals what
    the reference's write_paged_prefill leaves, which scatters each row's
    whole context ring; positions whose logical block is unmapped write
    nothing (the reference sends them to scratch block 0)."""
    bs = cache["pos"].shape[1]
    m_blocks = block_tables.shape[1]
    kind = paged_quant_kind(cache)
    tbl = block_tables.long()
    pos = positions.long()
    # tails first: no tail slot holds a position this write stores
    last = torch.where(pos >= 0, pos, torch.full_like(pos, -1)).amax(dim=1)
    logical = torch.arange(m_blocks * bs, device=pos.device).view(m_blocks,
                                                                  bs)
    tail = (tbl[:, :, None] >= 0) & (logical[None] > last[:, None, None])
    t_blk = tbl[:, :, None].expand(-1, -1, bs)[tail]
    t_off = logical.remainder(bs)[None].expand(tbl.shape[0], -1, -1)[tail]
    zero = torch.zeros((t_blk.shape[0],) + tuple(k.shape[2:]),
                       dtype=k.dtype, device=k.device)
    zq, zs = quantize_kv(zero, kind)
    cache["pos"].index_put_((t_blk, t_off), torch.full_like(t_blk, -1).to(
        cache["pos"].dtype))
    for pk, sk in (("kb", "ks"), ("vb", "vs")):
        cache[pk].index_put_((t_blk, t_off), zq.to(cache[pk].dtype))
        if kind != "none":
            cache[sk].index_put_((t_blk, t_off), zs)
    # the prompt's own rows
    lb = torch.div(pos, bs, rounding_mode="floor")
    phys = torch.gather(tbl, 1, torch.clamp(lb, 0, m_blocks - 1))
    keep = (pos >= 0) & (lb < m_blocks) & (phys >= 0)
    phys, off = phys[keep], torch.remainder(pos, bs)[keep]
    kq, ks = quantize_kv(k[keep], kind)
    vq, vs = quantize_kv(v[keep], kind)
    cache["kb"].index_put_((phys, off), kq.to(cache["kb"].dtype))
    cache["vb"].index_put_((phys, off), vq.to(cache["vb"].dtype))
    cache["pos"].index_put_((phys, off), positions[keep].to(
        cache["pos"].dtype))
    if kind != "none":
        cache["ks"].index_put_((phys, off), ks)
        cache["vs"].index_put_((phys, off), vs)
    return cache


def _scales(cache):
    if paged_quant_kind(cache) == "none":
        return None, None
    return cache["ks"], cache["vs"]


def _chunk_append(q, k, v, cache, blk: BlockSpec, positions, block_tables,
                  settings: AttnSettings = AttnSettings()):
    """Chunked prefill: append a prompt chunk to an EXISTING cache and
    attend over history + chunk — exactly the chunk's slice of a full
    prefill, so interleaving chunks with decode ticks changes scheduling but
    never tokens. Paged layers: backend "kernel" goes through kernels.ops
    (write kernel + tiled flash-attend kernel on the card: no [chunk,
    context] score matrix and no fp copy of a quantised pool reaches device
    memory); "naive" scatters through the block table and attends over the
    gathered virtual ring. Per-lane rings: _ring_chunk_append on either
    backend. Either way the cache's tensors are updated in place."""
    if not is_paged_cache(cache):
        return _ring_chunk_append(q, k, v, cache, blk, positions), cache
    assert block_tables is not None, \
        "paged cache needs block_tables for chunked prefill"
    ks, vs = _scales(cache)
    if settings.backend == "kernel":
        from repro_torch.kernels import ops as kops
        o = kops.paged_prefill_attention(
            q, k, v, cache["kb"], cache["vb"], cache["pos"], block_tables,
            positions, window=blk.window, chunk=blk.chunk,
            k_scales=ks, v_scales=vs)
        return o, cache
    from repro_torch.kernels import paged_prefill
    o = paged_prefill.paged_prefill_attention_plain(
        q, k, v, cache["kb"], cache["vb"], cache["pos"], block_tables,
        positions, window=blk.window, chunk=blk.chunk,
        k_scales=ks, v_scales=vs)
    return o, cache


def _ring_chunk_append(q, k, v, cache, blk: BlockSpec, positions):
    """A prompt chunk appended to per-lane rings: attend over concat(ring,
    chunk) (plain dense softmax, as the reference's; its [C, L + C] score
    tile is small next to the chunk's projections), then write back only
    the positions inside each row's final window, padding dropped
    (ring_write), IN PLACE."""
    valid = positions >= 0
    kcat = torch.cat([cache["k"], k.to(cache["k"].dtype)], dim=1)
    vcat = torch.cat([cache["v"], v.to(cache["v"].dtype)], dim=1)
    pcat = torch.cat([cache["pos"], torch.where(
        valid, positions, torch.full_like(positions, -1)).to(
            cache["pos"].dtype)], dim=1)
    o = _sdpa(q, kcat, vcat, _mask(positions, pcat, blk))
    ring_write(cache, positions, k, v)
    return o


def _paged_decode(q, cache, blk: BlockSpec, pos1, k1, v1, block_tables,
                  settings: AttnSettings):
    """One decode step against the paged pool: scatter the new K/V entry
    (in place), then attend through the block table — via kernels.ops (the
    CUDA paged-decode kernel on the card; quantised pools are dequantised
    after the load, inside the kernel) or the plain gather path. Returns
    (o, cache, mass or None): `mass` [b, max_blocks] is each logical block's
    softmax share, emitted when settings.track_mass."""
    cache = _paged_write(cache, block_tables, k1, v1, pos1)
    ks, vs = _scales(cache)
    if settings.backend == "kernel":
        from repro_torch.kernels import ops as kops
        fn = kops.paged_decode_attention
    else:
        from repro_torch.kernels import paged_decode
        fn = paged_decode.paged_decode_attention_plain
    out = fn(q[:, 0], cache["kb"], cache["vb"], cache["pos"], block_tables,
             pos1, window=blk.window, chunk=blk.chunk, k_scales=ks,
             v_scales=vs, return_mass=settings.track_mass)
    if settings.track_mass:
        o, mass = out
        return o[:, None], cache, mass
    return out[:, None], cache, None


# ---------------------------------------------------------------------------
# Block entry point
# ---------------------------------------------------------------------------

def attn_apply(params, cfg: ModelConfig, blk: BlockSpec, x, positions,
               cache=None, decode: bool = False, context: int = 0,
               settings: AttnSettings = AttnSettings(), block_tables=None,
               whole_prompt: bool = False):
    """x [b, s, d]; positions [b, s] (s=1 for decode). `block_tables`
    [b, max_blocks] routes the layer through its paged pool cache.

    `cache`: None (no cache), "build" (sequence path: return the ring this
    prompt fills, `_cache_from_prefill`), or a layer cache — a per-lane ring
    {"k", "v", "pos"} or a paged pool {"kb", "vb", "pos"[, "ks", "vs"]}.
    On the sequence path a paged cache means "append this chunk to what
    earlier chunks wrote", unless `whole_prompt`: then the sequence is a
    whole prompt, attends over itself, and its K/V are written into the
    pool through the block tables (`write_prompt_kv`).

    Returns (y [b, s, d], cache, aux dict). A cache passed in is updated in
    place and returned. `aux` carries "attn_mass" [b, max_blocks] on paged
    decode when settings.track_mass; empty otherwise.

    Head counts come from the weights: under tensor parallelism `wq` / `wk`
    / `wv` hold this rank's columns — K / model kv heads, each with its
    full group of G query heads, since the flattened q and kv dims are
    K-major — and the cache this rank's kv heads; `wo` holds the matching
    rows, and its partial product is summed over the model axis in f32
    (`layers.out_proj`); the normed input enters through `comm.tp_enter`
    (its gradient summed over the axis). head_dim stays the config's.
    """
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    K = params["wk"].shape[-1] // hd
    G = params["wq"].shape[-1] // hd // K
    h = comm.tp_enter(layers.rmsnorm(params["norm"], x, cfg.norm_eps))
    q = layers.matmul(h, params["wq"]).reshape(b, s, K, G, hd)
    k = layers.matmul(h, params["wk"]).reshape(b, s, K, hd)
    v = layers.matmul(h, params["wv"]).reshape(b, s, K, hd)
    if blk.rope:
        q = layers.apply_rope(q.reshape(b, s, K * G, hd), positions,
                              cfg.rope_theta).reshape(b, s, K, G, hd)
        k = layers.apply_rope(k, positions, cfg.rope_theta)

    aux = {}
    new_cache = cache
    if decode:
        assert cache is not None and s == 1
        pos1 = positions.reshape(b)              # accept [b] or [b, 1]
        if is_paged_cache(cache):
            assert block_tables is not None, \
                "paged cache needs block_tables at decode"
            o, new_cache, mass = _paged_decode(q, cache, blk, pos1, k[:, 0],
                                               v[:, 0], block_tables,
                                               settings)
            if mass is not None:
                aux["attn_mass"] = mass
        else:
            o = _ring_decode(q, cache, blk, pos1, k[:, 0], v[:, 0],
                             settings)
    elif isinstance(cache, dict) and not whole_prompt:
        # chunked prefill: a cache on the sequence path means "append this
        # chunk to what the earlier chunks already wrote"
        o, new_cache = _chunk_append(q, k, v, cache, blk, positions,
                                     block_tables, settings)
    else:
        o = _seq_attention(q, k, v, positions, positions, blk, settings)
        if cache == "build":
            new_cache = _cache_from_prefill(k, v, positions, blk, context)
        elif cache is not None and not is_paged_cache(cache):
            # a per-lane ring of the pool (a windowed layer): the ring this
            # prompt fills replaces the lane's, in place
            ring = _cache_from_prefill(k, v, positions, blk, context)
            for name, t in cache.items():
                t.copy_(ring[name])
        elif cache is not None:
            assert block_tables is not None, \
                "paged cache needs block_tables for whole-prompt prefill"
            write_prompt_kv(cache, block_tables, k, v, positions)

    o = o.reshape(b, s, K * G * hd)
    y = layers.out_proj(o, params["wo"], cfg.n_heads * hd)
    return y, new_cache, aux
