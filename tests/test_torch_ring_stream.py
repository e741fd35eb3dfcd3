"""The partition of the streaming ring decode kernel (csrc/ring_decode.cu
over csrc/decode_stream.cuh), transcribed in PyTorch and held on the CPU
against the reference package's oracle ref.decode_attention_ref (f32,
bf16) and, for two cases, its decode_attention_fwd (the Pallas kernel in
interpret mode):

- the ring split over thread blocks by ring_decode_splits' rule (tiles of
  min(64, kv_block, L) positions, at least two a split, about 1056 blocks
  in all, at most 32 splits, none left empty);
- within a block, lane groups of the power of two of lanes at or above
  hd / 8 (four warps of 32 // lpr groups); group j walks positions
  j, j + groups, ... of each page of 1024, U at a time (4; 2 on an f32
  ring with four query rows), each group with its own online softmax over
  up to 4 query rows;
- the groups combined in group order, the splits merged in a fixed order.

Rings wrapped at heterogeneous positions (slot = pos % L), inert lanes
(position < 0) and empty rings give exact zeros (the reference kernel's;
its oracle gives the ring's mean there, F9), window and chunk masks, G 1 to
16, head widths 16 to 256. Tolerances: f32 within 2e-5 (sums of up to a few
hundred terms in other orders), bf16 within one bf16 unit (2^-7 of the
value) plus 1e-3, as tests/test_torch_decode_attention.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.decode_attention import decode_attention_fwd as jfwd

from _torch_parity import JDT, TDT, to_np

NEG_INF = -1e30
ATOL_F32 = 2e-5
RTOL_BF16, ATOL_BF16 = 2.0 ** -7, 1e-3
PAGE, WARPS, TARGET_BLOCKS, MAX_SPLITS = 1024, 4, 1056, 32


def splits(b, K, L, kv_block):
    """ring_decode_splits: how many blocks share one (lane, kv head)."""
    TR = max(1, min(64, kv_block if kv_block > 0 else 64, L))
    tiles = -(-L // TR)
    want = max(1, min(-(-TARGET_BLOCKS // (b * K)), MAX_SPLITS,
                      (tiles + 1) // 2))
    per = -(-tiles // want)
    return -(-tiles // per), TR, tiles


def visible(cpos, qpos, window, chunk):
    m = (cpos >= 0) & (qpos >= 0) & (cpos <= qpos)
    if window:
        m &= cpos > qpos - window
    if chunk:
        m &= torch.div(cpos, chunk, rounding_mode="floor") == \
            torch.div(qpos, chunk, rounding_mode="floor")
    return m


def stream(q, k, v, cpos, positions, *, window=None, chunk=None,
           kv_block=512, nsplit=None):
    """The kernel's partition and order of the online softmax, in f32."""
    b, K, G, hd = q.shape
    L = k.shape[1]
    ns, TR, tiles = splits(b, K, L, kv_block)
    ns = nsplit or ns
    span = -(-tiles // ns) * TR
    lpr = 1 << max(0, math.ceil(math.log2(-(-hd // 8))))
    ngrp = WARPS * (32 // lpr)
    GG = 1 if G == 1 else 2 if G == 2 else 4
    U = 2 if k.dtype == torch.float32 and GG == 4 else 4
    s = torch.einsum("bkgh,blkh->bkgl", q.float() * float(1 / np.sqrt(hd)),
                     k.float())                                # [b,K,G,L]
    vis = visible(cpos, positions[:, None], window, chunk)     # [b, L]
    vf = v.float()
    parts = []
    for sp in range(ns):
        t0 = min(sp * span, L)
        t1 = min(t0 + span, L)
        m = torch.full((ngrp, b, K, G), NEG_INF)
        l = torch.zeros((ngrp, b, K, G))
        acc = torch.zeros((ngrp, b, K, G, hd))
        for p0 in range(t0, t1, PAGE):
            pn = min(PAGE, t1 - p0)
            for j in range(ngrp):
                walk = list(range(p0 + j, p0 + pn, ngrp))
                for n0 in range(0, len(walk), U):
                    idx = torch.tensor(walk[n0:n0 + U])
                    vs = vis[:, idx][:, None, None, :]           # [b,1,1,u]
                    sc = s[..., idx]
                    mx = torch.maximum(m[j], torch.where(
                        vs, sc, torch.full_like(sc, NEG_INF)).amax(-1))
                    corr = torch.exp(m[j] - mx)
                    p = torch.where(vs, torch.exp(sc - mx[..., None]),
                                    torch.zeros_like(sc))
                    l[j] = l[j] * corr + p.sum(-1)
                    acc[j] = acc[j] * corr[..., None] + torch.einsum(
                        "bkgu,bukh->bkgh", p, vf[:, idx])
                    m[j] = mx
        M = m.amax(0).clamp(min=NEG_INF)
        w = torch.exp(m - M)
        parts.append((M, (acc * w[..., None]).sum(0), (l * w).sum(0)))
    if ns == 1:
        _, num, den = parts[0]
    else:
        M = torch.stack([p[0] for p in parts]).amax(0)
        w = [torch.exp(p[0] - M) for p in parts]
        num = sum(p[1] * wi[..., None] for p, wi in zip(parts, w))
        den = sum(p[2] * wi for p, wi in zip(parts, w))
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)


def ring_case(seed, *, b, L, K, G, hd, ends, dtype="float32", empty=(),
              inert=()):
    """Lane i holds positions max(0, ends[i] - L + 1)..ends[i] at slot
    pos % L and is queried at ends[i]; `empty` lanes hold nothing, `inert`
    ones are queried at -1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((b, L, K, hd)).astype(np.float32)
    v = rng.standard_normal((b, L, K, hd)).astype(np.float32)
    cpos = np.full((b, L), -1, np.int32)
    for i, e in enumerate(ends):
        if i not in empty:
            for p in range(max(0, e - L + 1), e + 1):
                cpos[i, p % L] = p
    positions = np.asarray(ends, np.int32)
    for i in inert:
        positions[i] = -1
    if dtype == "bfloat16":
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (q, k, v))
    return q, k, v, cpos, positions


# name: (b, L, K, G, hd, ends, window, chunk, empty, inert, kv_block); the
# split counts follow: 5, 1, 2, 1, 1, 1, 2
CASES = {
    "wrapped G2 hd256 five splits": (3, 150, 2, 2, 256, [400, 149, 20],
                                     None, None, (), (), 16),
    "window G1 hd64 (4 rows a warp)": (3, 70, 2, 1, 64, [200, 69, 5], 30,
                                       None, (), (), 512),
    "chunk G16 hd64 (4 row groups)": (2, 90, 1, 16, 64, [300, 89], None, 40,
                                      (), (), 32),
    "G12 hd80 (partial lane and row groups)": (2, 60, 1, 12, 80, [100, 59],
                                               None, None, (), (), 512),
    "G3 hd16 inert and empty lanes": (4, 40, 2, 3, 16, [90, 39, 10, 50],
                                      None, None, (2,), (1,), 512),
    "single slot": (2, 1, 2, 1, 32, [0, 5], None, None, (), (), 512),
    "G4 hd128 window wrapped split": (2, 130, 1, 4, 128, [1000, 129], 100,
                                      None, (), (), 64),
}


def _reference(q, k, v, cpos, positions, dtype, window, chunk,
               kernel=True):
    """(the reference kernel interpreted, or None; its oracle)."""
    jd = JDT[dtype]
    args = (jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
            jnp.asarray(cpos), jnp.asarray(positions))
    kern = None
    if kernel:
        kern = to_np(jfwd(*args, window=window, chunk=chunk,
                          kv_block=k.shape[1], interpret=True))
    return kern, to_np(kref.decode_attention_ref(*args, window=window,
                                                  chunk=chunk))


def _check(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL_BF16,
                                   rtol=RTOL_BF16)


@pytest.fixture(scope="module")
def oracles():
    """Per case: bf16-exact inputs (so that one oracle run in f32 serves
    the f32 and the bf16 transcription) and the oracle's output."""
    out = {}
    for name, c in CASES.items():
        b, L, K, G, hd, ends, window, chunk, empty, inert, _ = c
        arrs = ring_case(11, b=b, L=L, K=K, G=G, hd=hd, ends=ends,
                         dtype="bfloat16", empty=empty, inert=inert)
        out[name] = arrs, _reference(*arrs, "float32", window, chunk,
                                     kernel=False)[1]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_partition_matches_reference(name, dtype, oracles):
    """Against the reference's oracle on every live lane; lanes that see
    nothing give exact zeros (the oracle gives the ring's mean there)."""
    b, L, K, G, hd, ends, window, chunk, empty, inert, kv_block = CASES[name]
    (q, k, v, cpos, positions), oracle = oracles[name]
    td = TDT[dtype]
    got = stream(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                 torch.from_numpy(cpos), torch.from_numpy(positions),
                 window=window, chunk=chunk, kv_block=kv_block)
    got = got.float().numpy()
    dead = set(empty) | set(inert)
    live = [i for i in range(b) if i not in dead]
    _check(got[live], oracle[live], dtype)
    for i in dead:
        assert (got[i] == 0).all(), i


@pytest.mark.parametrize("name", ["wrapped G2 hd256 five splits",
                                  "G3 hd16 inert and empty lanes"])
def test_stream_partition_matches_reference_kernel(name):
    """Against the reference's kernel itself (interpret mode), dead lanes
    included: several splits; inert and empty lanes."""
    b, L, K, G, hd, ends, window, chunk, empty, inert, kv_block = CASES[name]
    arrs = ring_case(11, b=b, L=L, K=K, G=G, hd=hd, ends=ends, empty=empty,
                     inert=inert)
    got = stream(*(torch.from_numpy(a) for a in arrs), window=window,
                 chunk=chunk, kv_block=kv_block)
    kern, _ = _reference(*arrs, "float32", window, chunk)
    _check(got.numpy(), kern, "float32")


def test_one_split_over_pages():
    """One block over a ring longer than a page of staged positions (1024):
    the groups' walk restarts at each page."""
    q, k, v, cpos, positions = ring_case(12, b=1, L=1100, K=1, G=2, hd=16,
                                         ends=[2500])
    got = stream(*(torch.from_numpy(a) for a in (q, k, v, cpos, positions)),
                 window=1050, nsplit=1)
    _, oracle = _reference(q, k, v, cpos, positions, "float32", 1050, None,
                           kernel=False)
    _check(got.numpy(), oracle, "float32")


def test_split_rule_reaches_every_count_up_to_the_cap():
    """The rule chip_smoke.py's phase 2 walks: one lane, one kv head, tiles
    of kv_block 16 and rings of 32 n - n % 16 positions take n splits, for
    every n up to the cap; the serving rings' counts."""
    for n in range(1, MAX_SPLITS + 1):
        assert splits(1, 1, 32 * n - n % 16, 16)[0] == n
    assert splits(1, 1, 1 << 20, 16)[0] == MAX_SPLITS
    assert splits(8, 8, 4096, 512)[0] == 16      # gemma3-12b's global ring
    assert splits(8, 8, 1024, 512)[0] == 8       # its local ring
    assert splits(8, 1, 2048, 512)[0] == 16      # recurrentgemma-9b's
