"""GQA attention over a paged KV pool: the serving subset of the reference
package's attention module.

Ported: paged decode (one token per lane through block tables) and chunked
prefill appended to the live pool. Backends:
  kernel — kernels.ops (hand-written CUDA kernels for a CUDA tensor, their
           plain PyTorch versions for a CPU tensor). The default.
  naive  — the plain path on either device: scatter through the block table,
           gather the virtual ring, dense masked softmax.

Not ported yet (each raises NotImplementedError naming what lifts it): the
sequence backends (whole-prompt prefill, training forward) and the per-lane
ring cache.

Pools are updated IN PLACE: where the reference package returns new arrays,
`_paged_write`, `_paged_write_chunk` and the kernels store into the cache's
own tensors and hand the same dict back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import layers

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


def _decode_attend(q, cache, blk: BlockSpec, positions,
                   return_probs: bool = False):
    """q [b,1,K,G,hd], cache k/v [b,L,K,hd]; positions [b]."""
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


def _scales(cache):
    if paged_quant_kind(cache) == "none":
        return None, None
    return cache["ks"], cache["vs"]


def _chunk_append(q, k, v, cache, blk: BlockSpec, positions, block_tables,
                  settings: AttnSettings = AttnSettings()):
    """Chunked prefill: append a prompt chunk to an EXISTING paged cache and
    attend over history + chunk — exactly the chunk's slice of a full
    prefill, so interleaving chunks with decode ticks changes scheduling but
    never tokens. backend "kernel" goes through kernels.ops (write kernel +
    tiled flash-attend kernel on the card: no [chunk, context] score matrix
    and no fp copy of a quantised pool reaches device memory); "naive"
    scatters through the block table and attends over the gathered virtual
    ring. Either way the cache's tensors are updated in place."""
    if not is_paged_cache(cache):
        raise NotImplementedError(
            "chunk append into a per-lane ring cache: needs the ring/slot "
            "slice (decode_attention_fwd, windowed layers)")
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
               settings: AttnSettings = AttnSettings(), block_tables=None):
    """x [b, s, d]; positions [b, s] (s=1 for decode). `block_tables`
    [b, max_blocks] routes the layer through its paged pool cache.

    Returns (y [b, s, d], cache, aux dict). The cache returned is the one
    passed in, updated in place. `aux` carries "attn_mass" [b, max_blocks]
    on paged decode when settings.track_mass; empty otherwise.
    """
    b, s, d = x.shape
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.q_group
    h = layers.rmsnorm(params["norm"], x, cfg.norm_eps)
    q = layers.matmul(h, params["wq"]).reshape(b, s, K, G, hd)
    k = layers.matmul(h, params["wk"]).reshape(b, s, K, hd)
    v = layers.matmul(h, params["wv"]).reshape(b, s, K, hd)
    if blk.rope:
        q = layers.apply_rope(q.reshape(b, s, K * G, hd), positions,
                              cfg.rope_theta).reshape(b, s, K, G, hd)
        k = layers.apply_rope(k, positions, cfg.rope_theta)

    aux = {}
    if decode:
        assert cache is not None and s == 1
        pos1 = positions.reshape(b)              # accept [b] or [b, 1]
        if not is_paged_cache(cache):
            raise NotImplementedError(
                "decode against a per-lane ring cache: needs the ring/slot "
                "slice (decode_attention_fwd, windowed layers)")
        assert block_tables is not None, \
            "paged cache needs block_tables at decode"
        o, new_cache, mass = _paged_decode(q, cache, blk, pos1, k[:, 0],
                                           v[:, 0], block_tables, settings)
        if mass is not None:
            aux["attn_mass"] = mass
    elif cache is not None:
        # chunked prefill: a cache on the sequence path means "append this
        # chunk to what the earlier chunks already wrote"
        o, new_cache = _chunk_append(q, k, v, cache, blk, positions,
                                     block_tables, settings)
    else:
        raise NotImplementedError(
            "sequence attention without a cache (whole-prompt prefill, "
            "training forward): needs the flash_attention_fwd slice")

    o = o.reshape(b, s, cfg.n_heads * hd)
    y = layers.matmul(o, params["wo"])
    return y, new_cache, aux
