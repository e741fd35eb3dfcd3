"""The partition of the streaming paged decode kernel (csrc/paged_decode.cu
over csrc/decode_stream.cuh, paged_stream_kernel), transcribed in PyTorch
and held on the CPU against the reference package's
paged_decode_attention_fwd (the Pallas kernel in interpret mode), output
and per-block mass:

- the context split over thread blocks in tiles of 64 logical rows
  rounded down to whole pool blocks (one block where a block is larger),
  so that a split and a page of 1024 positions (rounded down to whole
  blocks) never cut a pool block: as many splits as keep the whole grid
  resident at once (the card's SMs times the blocks an SM keeps of the
  instantiation, which the card reports: 132 x 3 here, as an H100 at bf16
  with four query rows), at least two tiles a split, at most 32;
- within a block, lane groups of the power of two of lanes at or above
  hd / EPL, where a lane's 16 bytes hold EPL = 8 bf16 (two loads: f32),
  16 int8 or 32 int4 elements; without the mass, group j walks positions
  j, j + groups, ... of each page, U at a time (4; 2 where a lane's query
  rows hold 64 values or more, or f32 with four query rows); with the
  mass, group j walks whole pool blocks j, j + groups, ... of the page, U
  positions at a time, keeping the block's own (max, sumexp);
- codes decoded per lane: the score (q / sqrt(hd)) . code times K's row
  scale, V's row scale folded into the weight (l sums the weight itself);
- the groups combined in group order, the splits merged in a fixed order.

Unassigned table entries, inert lanes (exact zeros, mass zero), trimmed
tables, pool blocks of 4, 6, 16, 64 and 128, int4 at hd 16, window and
chunk masks. Tolerances: f32 within 2e-5, bf16 queries within one bf16
unit (2^-7 of the value) plus 1e-3 (phase 2's bound), the mass within
1e-5."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels.paged_decode import merge_block_mass

from _torch_parity import JDT, paged_case, pool_jax, to_np

NEG_INF = -1e30
ATOL_F32, ATOL_MASS = 2e-5, 1e-5
RTOL_BF16, ATOL_BF16 = 2.0 ** -7, 1e-3
PAGE, WARPS, MAX_SPLITS, TILE = 1024, 4, 32, 64
SLOTS = 132 * 3              # blocks resident at once (the card decides)
EPL = {"none": 8, "int8": 16, "int4": 32}


def tile_rows(bs):
    return (TILE // bs) * bs if bs <= TILE else bs


def splits(b, K, bs, mb, n_gg=1, slots=SLOTS):
    """paged_decode_splits: how many blocks share one (lane, kv head x
    query-row group)."""
    TR = tile_rows(bs)
    tiles = -(-(mb * bs) // TR)
    want = max(1, min(slots // (b * K * n_gg), MAX_SPLITS, (tiles + 1) // 2))
    per = -(-tiles // want)
    return -(-tiles // per), TR, tiles


def lane_layout(G, hd, quant, f32):
    """(lanes a row, groups a block, steps U) of the kernel's launch."""
    epl = EPL[quant]
    lpr = 1 << max(0, math.ceil(math.log2(-(-hd // epl))))
    gg = 1 if G == 1 else 2 if G == 2 else (2 if quant != "none" else 4)
    U = 2 if gg * epl >= 64 or (f32 and gg == 4) else 4
    return lpr, WARPS * (32 // lpr), U


def gathered(case, tables, quant):
    """Each lane's logical rows through its table, as the kernel decodes
    them: values (bf16 / f32 rows, or codes) [b, R, K, hd], the row scales
    [b, R, K] (1 for fp pools) and positions [b, R] (-1: unassigned entry
    or unwritten slot)."""
    b, mb = tables.shape
    bs = case["pos"].shape[1]
    ent = torch.from_numpy(tables.astype(np.int64))
    live = (ent >= 0)[:, :, None].expand(b, mb, bs).reshape(b, -1)
    phys = (ent.clamp(min=0)[:, :, None] * bs + torch.arange(bs)).reshape(
        b, -1)

    def rows(name):
        a = torch.from_numpy(np.array(case[name]))
        flat = a.reshape(-1, *a.shape[2:])[phys]
        if quant == "int4":
            flat = torch.stack([flat & 0xF, flat >> 4], -1).reshape(
                *flat.shape[:-1], -1).float() - 8.0
        return flat.float()

    def scales(name):
        if quant == "none":
            return torch.ones(b, mb * bs, case["kb"].shape[2])
        a = torch.from_numpy(np.array(case[name]))
        return a.reshape(-1, a.shape[2])[phys]

    pos = torch.from_numpy(np.array(case["pos"])).reshape(-1)[phys]
    pos = torch.where(live, pos, torch.full_like(pos, -1))
    return rows("kb"), scales("ks"), rows("vb"), scales("vs"), pos


def visible(cpos, qpos, window, chunk):
    m = (cpos >= 0) & (qpos >= 0) & (cpos <= qpos)
    if window:
        m &= cpos > qpos - window
    if chunk:
        m &= torch.div(cpos, chunk, rounding_mode="floor") == \
            torch.div(qpos, chunk, rounding_mode="floor")
    return m


def stream(q, case, tables, positions, quant, *, window=None, chunk=None,
           mass=False, nsplit=None):
    """The kernel's partition and order of the online softmax, in f32:
    q [b, K, G, hd] (the query's values) -> out [b, K, G, hd] (and, with
    `mass`, the per-block (max, sumexp) [b, mB, K, G] each)."""
    b, K, G, hd = q.shape
    mb = tables.shape[1]
    bs = case["pos"].shape[1]
    kv, ks, vv, vs, cpos = gathered(case, tables, quant)
    R = mb * bs
    ns, TR, tiles = splits(b, K, bs, mb)
    ns = nsplit or ns
    span = -(-tiles // ns) * TR
    lpr, ngrp, U = lane_layout(G, hd, quant, q.dtype == torch.float32)
    page = (PAGE // bs) * bs
    s = torch.einsum("bkgh,brkh->bkgr", q.float() * float(1 / np.sqrt(hd)),
                     kv) * ks.permute(0, 2, 1)[:, :, None, :]    # [b,K,G,R]
    vis = visible(cpos, torch.from_numpy(positions.astype(np.int64))[:, None],
                  window, chunk)                                 # [b, R]
    vsc = vs.permute(0, 2, 1)                                    # [b, K, R]
    bm = torch.full((b, mb, K, G), NEG_INF)
    bl = torch.zeros((b, mb, K, G))

    def step(st, idx, blk):
        """Positions idx (up to U) into group state st = [m, l, acc], and
        into the block's (max, sumexp) blk."""
        vsel = vis[:, idx][:, None, None, :]                      # [b,1,1,u]
        sc = s[..., idx]
        if blk is not None:
            bmx = torch.maximum(blk[0], torch.where(
                vsel, sc, torch.full_like(sc, NEG_INF)).amax(-1))
            e = torch.where(vsel, torch.exp(sc - bmx[..., None]),
                            torch.zeros_like(sc)).sum(-1)
            blk[1] = blk[1] * torch.exp(blk[0] - bmx) + e
            blk[0] = bmx
        m, l, acc = st
        mx = torch.maximum(m, torch.where(
            vsel, sc, torch.full_like(sc, NEG_INF)).amax(-1))
        corr = torch.exp(m - mx)
        p = torch.where(vsel, torch.exp(sc - mx[..., None]),
                        torch.zeros_like(sc))
        pv = p * vsc[:, :, None, idx]
        st[0] = mx
        st[1] = l * corr + p.sum(-1)
        st[2] = acc * corr[..., None] + torch.einsum("bkgu,bukh->bkgh", pv,
                                                     vv[:, idx])

    parts = []
    for sp in range(ns):
        t0 = min(sp * span, R)
        t1 = min(t0 + span, R)
        grp = [[torch.full((b, K, G), NEG_INF), torch.zeros((b, K, G)),
                torch.zeros((b, K, G, hd))] for _ in range(ngrp)]
        for p0 in range(t0, t1, page):
            pn = min(page, t1 - p0)
            for j in range(ngrp):
                if not mass:
                    walk = list(range(p0 + j, p0 + pn, ngrp))
                    for n0 in range(0, len(walk), U):
                        step(grp[j], walk[n0:n0 + U], None)
                    continue
                for blk_i in range(j, pn // bs, ngrp):
                    blk = [torch.full((b, K, G), NEG_INF),
                           torch.zeros((b, K, G))]
                    r0 = p0 + blk_i * bs
                    for off in range(0, bs, U):
                        step(grp[j], list(range(r0 + off,
                                                r0 + min(off + U, bs))), blk)
                    bm[:, r0 // bs], bl[:, r0 // bs] = blk
        m = torch.stack([g[0] for g in grp])
        M = m.amax(0)
        w = torch.exp(m - M)
        parts.append((M, sum(g[2] * w[j][..., None]
                             for j, g in enumerate(grp)),
                      sum(g[1] * w[j] for j, g in enumerate(grp))))
    if ns == 1:
        _, num, den = parts[0]
    else:
        M = torch.stack([pt[0] for pt in parts]).amax(0)
        w = [torch.exp(pt[0] - M) for pt in parts]
        num = sum(pt[1] * wi[..., None] for pt, wi in zip(parts, w))
        den = sum(pt[2] * wi for pt, wi in zip(parts, w))
    out = (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)
    return (out, bm, bl) if mass else out


# name: (K, G, hd, bs, lens, dtype, quant, window, chunk, holes (lane,
# block), inert lanes, table width or None, mass)
CASES = {
    "bs16 mistral heads bf16 hole inert": (
        2, 4, 128, 16, [200, 37, 1], "bfloat16", "none", None, None,
        ((0, 3),), (2,), None, True),
    "bs4 hd16 G2 f32": (2, 2, 16, 4, [13, 7, 16], "float32", "none", None,
                        None, (), (), None, True),
    "bs6 hd64 G4 int8 hole": (2, 4, 64, 6, [100, 61, 7], "bfloat16", "int8",
                              None, None, ((0, 5),), (), None, True),
    "bs64 hd128 G2 int4": (2, 2, 128, 64, [300, 64, 65], "bfloat16", "int4",
                           None, None, (), (), None, True),
    "bs128 hd128 G1 bf16 window": (2, 1, 128, 128, [400, 129], "bfloat16",
                                   "none", 150, None, (), (), None, True),
    "bs16 hd16 G4 int4 window inert": (2, 4, 16, 16, [200, 33, 1],
                                       "bfloat16", "int4", 50, None, (),
                                       (2,), None, True),
    "bs16 hd64 G12 int8 chunk": (1, 12, 64, 16, [150, 40], "bfloat16",
                                 "int8", None, 64, (), (), None, False),
    "bs16 hd80 G4 int4 (40-byte rows)": (2, 4, 80, 16, [90, 17], "bfloat16",
                                         "int4", None, None, (), (), None,
                                         False),
    "trimmed table bs16 f32": (2, 4, 32, 16, [40, 33], "float32", "none",
                               None, None, (), (), 3, False),
}


def _inputs(name, seed=23):
    K, G, hd, bs, lens, dtype, quant, window, chunk, holes, inert, width, \
        mass = CASES[name]
    b = len(lens)
    need = max(-(-n // bs) for n in lens)
    mb = width or need + 2
    n_blocks = sum(-(-n // bs) for n in lens) + 3
    case = paged_case(seed, b=b, K=K, G=G, hd=hd, bs=bs, lens=lens,
                      m_blocks=max(mb, need), n_blocks=n_blocks, dtype=dtype,
                      quant=quant)
    tables = np.ascontiguousarray(case["tables"][:, :mb])
    for i, j in holes:
        tables[i, j] = -1
    positions = np.asarray(lens, np.int32) - 1
    for i in inert:
        positions[i] = -1
        tables[i] = -1
    q = np.random.default_rng(seed + 1).standard_normal(
        (b, K, G, hd)).astype(np.float32)
    if dtype == "bfloat16":
        q = torch.from_numpy(q).bfloat16().float().numpy()
    return case, tables, positions, q


def _reference(case, tables, positions, q, dtype, window, chunk, mass):
    """The reference's kernel (interpret mode): out, and its merged mass."""
    pj = pool_jax(case, dtype)
    out = jops.paged_decode_attention(
        jnp.asarray(q, JDT[dtype]), pj["kb"], pj["vb"], pj["pos"],
        jnp.asarray(tables), jnp.asarray(positions), window=window,
        chunk=chunk, backend="interpret", k_scales=pj.get("ks"),
        v_scales=pj.get("vs"), return_mass=mass)
    return (to_np(out[0]), to_np(out[1])) if mass else (to_np(out), None)


def _check(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL_BF16, rtol=RTOL_BF16)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_partition_matches_reference(name):
    K, G, hd, bs, lens, dtype, quant, window, chunk, _, inert, _, mass = \
        CASES[name]
    case, tables, positions, q = _inputs(name)
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    got = stream(torch.from_numpy(q).to(td), case, tables, positions, quant,
                 window=window, chunk=chunk, mass=mass)
    want, want_mass = _reference(case, tables, positions, q, dtype, window,
                                 chunk, mass)
    if mass:
        got, bm, bl = got
        np.testing.assert_allclose(merge_block_mass(bm, bl).numpy(),
                                   want_mass, atol=ATOL_MASS, rtol=0)
    _check(got.float().numpy(), want, dtype)
    for i in inert:
        assert (got[i] == 0).all(), i
        if mass:
            assert (bm[i] == NEG_INF).all() and (bl[i] == 0).all()


def test_one_split_over_pages_walks_whole_blocks():
    """One split over a context longer than a page (1024 positions, 1020
    at pool blocks of 6): pages and the mass walk hold whole pool blocks,
    and the result is the reference's."""
    case = paged_case(29, b=1, K=2, G=4, hd=64, bs=6, lens=[2500],
                      m_blocks=420, n_blocks=424, dtype="bfloat16",
                      quant="int8")
    tables = case["tables"]
    positions = np.asarray([2499], np.int32)
    q = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 2, 4, 64)).astype(np.float32)).bfloat16()
    out, bm, bl = stream(q, case, tables, positions, "int8", mass=True,
                         nsplit=1)
    want, want_mass = _reference(case, tables, positions, q.float().numpy(),
                                 "bfloat16", None, None, True)
    _check(out.float().numpy(), want, "bfloat16")
    np.testing.assert_allclose(merge_block_mass(bm, bl).numpy(), want_mass,
                               atol=ATOL_MASS, rtol=0)


def test_splits_fill_one_wave_in_whole_pool_blocks():
    """The split rule on the serving shapes: mistral-nemo-12b's timed decode
    (8 lanes x 8 kv heads, 130 blocks of 16: 6 splits of six tiles, 384
    blocks for 396 slots; 4 at two blocks an SM), two lanes (17 splits of
    two tiles: the two-tile floor), one lane and one kv head (the cap), more
    (lane, kv head) pairs than slots (one split), every block size a whole
    number of times in a tile."""
    assert splits(8, 8, 16, 130)[0] == 6
    assert splits(8, 8, 16, 130, slots=264)[0] == 4
    assert splits(2, 8, 16, 130)[0] == 17
    assert splits(1, 1, 16, 4096)[0] == MAX_SPLITS
    assert splits(64, 8, 16, 130)[0] == 1
    for bs in (1, 4, 6, 16, 64, 128, 1000):
        assert tile_rows(bs) % bs == 0
        assert ((PAGE // bs) * bs) % bs == 0
