"""The rounding of the paged prefill kernel's tensor-core body (bf16
queries over a bf16, int8 or int4 pool; csrc/paged_prefill.cu), modelled
on the CPU against the reference package's paged_prefill_attention_fwd
(the Pallas kernel in interpret mode, as tests/test_kernels.py runs it):

- q in bf16 times the pool's bf16 rows, or its codes (int8 -127..127, int4
  -8..7, exact in bf16), with f32 sums;
- K's row scale applied to the f32 product column, then 1/sqrt(hd);
- the weight p times V's row scale in f32, split into bf16 hi + lo halves
  before the second product (as the kernel feeds it to mma.sync), over
  V's bf16 rows or codes; the output rounded once to bf16.

The model attends over the reference's own post-write pool, so the two
differ by the attend's arithmetic alone. The bound is phase 2's: out
within 1e-3 + 2^-7 of its value. Rounded once to bf16, p * vscale exceeds
it (the last test): so the kernel splits it. Cases: mistral-nemo-12b's
heads (K 8, G 4, hd 128) and gemma3-12b's (K 8, G 2, hd 256) at reduced
length, histories ending inside a tile, pool blocks of 6 and 64, a table
entry of the history unassigned, a window."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from _torch_parity import paged_case, pool_jax, to_np

TOL_BF16, RTOL_BF16 = 1e-3, 2.0 ** -7
NEG_INF = -1e30


def _bf(x):
    return x.to(torch.bfloat16).float()


def _operand(x, split):
    """x as the kernel feeds it to a bf16 product: hi + lo, or hi alone."""
    hi = _bf(x)
    return hi + _bf(x - hi) if split else hi


def _rows(pool, scales, tables, bs, quant):
    """Every logical row of every lane through its table: the values the
    kernel's tiles hold (bf16 rows, or codes) [b, R, K, hd] and the row
    scales [b, R, K] (1 for bf16). Unassigned entries give zeros."""
    kb = torch.from_numpy(np.array(pool))
    b, mb = tables.shape
    ent = torch.from_numpy(tables.astype(np.int64))
    phys = ent.clamp(min=0)[:, :, None] * bs + torch.arange(bs)   # [b,mb,bs]
    flat = kb.reshape(-1, *kb.shape[2:])[phys.reshape(b, -1)]
    if quant == "int4":
        nib = torch.stack([flat & 0xF, flat >> 4], -1).reshape(
            *flat.shape[:-1], -1)
        vals = nib.float() - 8.0
    else:
        vals = flat.float()                      # bf16 values or int8 codes
    if scales is None:
        sc = torch.ones(vals.shape[:-1])
    else:
        sc = torch.from_numpy(np.array(scales)).reshape(-1, vals.shape[2])[
            phys.reshape(b, -1)]
    live = (ent >= 0)[:, :, None].expand(b, mb, bs).reshape(b, -1)
    vals = torch.where(live[..., None, None], vals, torch.zeros_like(vals))
    return vals, torch.where(live[..., None], sc, torch.zeros_like(sc)), live


def model_attend(q, pool, tables, positions, bs, quant, window=None,
                 split=True):
    """The kernel's attend over the post-write pool `pool` (numpy leaves
    kb, vb, pos, and ks, vs for codes): q [b, C, K, G, hd] (bf16 values in
    f32) -> out [b, C, K, G, hd] (bf16 values)."""
    b, C, K, G, hd = q.shape
    kv, ksc, live = _rows(pool["kb"], pool.get("ks"), tables, bs, quant)
    vv, vsc, _ = _rows(pool["vb"], pool.get("vs"), tables, bs, quant)
    ent = torch.from_numpy(tables.astype(np.int64))
    phys = ent.clamp(min=0)[:, :, None] * bs + torch.arange(bs)
    cpos = torch.from_numpy(np.array(pool["pos"])).reshape(-1)[
        phys.reshape(b, -1)]
    cpos = torch.where(live, cpos, torch.full_like(cpos, -1))     # [b, R]
    qp = torch.from_numpy(positions.astype(np.int64))             # [b, C]
    mask = (cpos[:, None, :] >= 0) & (qp[:, :, None] >= 0) & \
        (cpos[:, None, :] <= qp[:, :, None])                      # [b, C, R]
    if window is not None:
        mask &= cpos[:, None, :] > qp[:, :, None] - window
    scale = float(1.0 / np.sqrt(hd))
    s = torch.einsum("bckgh,brkh->bkgcr", q, kv)                  # f32 sums
    s = s * ksc.permute(0, 2, 1)[:, :, None, None, :] * scale
    m4 = mask[:, None, None]                                      # [b,1,1,C,R]
    s = torch.where(m4, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(m4, torch.exp(s - m), torch.zeros_like(s))
    l = torch.clamp(p.sum(-1), min=1e-30)
    pv = p * vsc.permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bkgcr,brkh->bckgh", _operand(pv, split), vv)
    return _bf(o / l.permute(0, 3, 1, 2)[..., None])


# name: (K, G, hd, bs, hist, clens, C, quant, window, holes (lane, block))
CASES = {
    "mistral heads bf16": (8, 4, 128, 16, [45, 13], [16, 9], 16, "none",
                           None, ()),
    "mistral heads int8": (8, 4, 128, 16, [45, 13], [16, 9], 16, "int8",
                           None, ()),
    "mistral heads int4": (8, 4, 128, 16, [45, 13], [16, 9], 16, "int4",
                           None, ()),
    "gemma3 global heads bf16": (8, 2, 256, 16, [37, 0], [16, 16], 16,
                                 "none", None, ()),
    "gemma3 global heads int8 window": (8, 2, 256, 16, [37, 0], [16, 16],
                                        16, "int8", 20, ()),
    "gemma3 global heads int4": (8, 2, 256, 16, [37, 0], [16, 16], 16,
                                 "int4", None, ()),
    "bs6 int8 hole": (2, 4, 128, 6, [31, 4], [12, 12], 12, "int8", None,
                      ((0, 2),)),
    "bs6 bf16": (2, 4, 128, 6, [31, 4], [12, 12], 12, "none", None, ()),
    "bs64 int4": (2, 4, 128, 64, [70, 0], [16, 16], 16, "int4", None, ()),
    "bs64 bf16 hole": (2, 4, 128, 64, [140, 0], [16, 16], 16, "none", None,
                       ((0, 0),)),
}


def _case(name, seed=19):
    """The reference's pool after its own write of the chunk, its output,
    and the inputs: (q [bf16 values], pool leaves (numpy), tables,
    positions, out_ref)."""
    K, G, hd, bs, hist, clens, C, quant, window, holes = CASES[name]
    b = len(hist)
    total = [h + c for h, c in zip(hist, clens)]
    mb = max(-(-t // bs) for t in total) + 1
    n_blocks = sum(-(-t // bs) for t in total) + 3
    case = paged_case(seed, b=b, K=K, G=G, hd=hd, bs=bs, lens=hist,
                      m_blocks=mb, n_blocks=n_blocks, dtype="bfloat16",
                      quant=quant)
    # map the blocks the chunk fills, then drop the history's holes
    used = set(case["tables"][case["tables"] >= 0].tolist())
    free = [i for i in range(1, n_blocks) if i not in used]
    tables = case["tables"].copy()
    for i in range(b):
        for j in range(-(-total[i] // bs)):
            if tables[i, j] < 0:
                tables[i, j] = free.pop()
    for i, j in holes:
        assert (j + 1) * bs <= hist[i]
        tables[i, j] = -1
    rng = np.random.default_rng(seed + 1)
    q = rng.standard_normal((b, C, K, G, hd)).astype(np.float32)
    kn = rng.standard_normal((b, C, K, hd)).astype(np.float32)
    vn = rng.standard_normal((b, C, K, hd)).astype(np.float32)
    positions = np.full((b, C), -1, np.int32)
    for i in range(b):
        positions[i, :clens[i]] = hist[i] + np.arange(clens[i])
    pj = pool_jax(case, "bfloat16")
    bf = jnp.bfloat16
    out = jops.paged_prefill_attention(
        jnp.asarray(q, bf), jnp.asarray(kn, bf), jnp.asarray(vn, bf),
        pj["kb"], pj["vb"], pj["pos"], jnp.asarray(tables),
        jnp.asarray(positions), window=window, backend="interpret",
        k_scales=pj.get("ks"), v_scales=pj.get("vs"))
    pool = {"pos": to_np(out[1]), "kb": to_np(out[2]), "vb": to_np(out[3])}
    if quant != "none":
        pool["ks"], pool["vs"] = to_np(out[4]), to_np(out[5])
    qt = _bf(torch.from_numpy(q))
    return qt, pool, tables, positions, to_np(out[0])


def _over(got, want):
    """How far out exceeds phase 2's bf16 bound (<= 0: within)."""
    return float((np.abs(got - want) - (TOL_BF16 + RTOL_BF16 * np.abs(want))
                  ).max())


@pytest.fixture(scope="module")
def refs():
    return {}


def _ref(refs, name):
    if name not in refs:
        refs[name] = _case(name)
    return refs[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_core_rounding_within_phase2_bound(name, refs):
    K, G, hd, bs, hist, clens, C, quant, window, _ = CASES[name]
    q, pool, tables, positions, want = _ref(refs, name)
    got = model_attend(q, pool, tables, positions, bs, quant, window)
    assert got.shape == (len(hist), C, K, G, hd)
    assert _over(got.numpy(), want) <= 0.0
    # padding rows of a short chunk give exact zeros on both sides
    for i, c in enumerate(clens):
        assert (got[i, c:] == 0).all() and (want[i, c:] == 0).all()


def test_codes_are_exact_in_bf16():
    """Why the kernel converts codes to bf16 without a loss: every int8
    and int4 code is a bf16 value."""
    codes = torch.arange(-127, 128, dtype=torch.float32)
    assert torch.equal(_bf(codes), codes)
    nib = torch.arange(-8, 8, dtype=torch.float32)
    assert torch.equal(_bf(nib), nib)


def test_single_bf16_weight_times_vscale_would_exceed_the_bound(refs):
    """Why the kernel splits p * vscale: rounded once to bf16 (2^-9 of each
    weight) it moves outputs of short causal rows past 1e-3 + 2^-7 of their
    value on an int8 pool, where the hi + lo split stays inside."""
    name = "gemma3 global heads int8 window"
    _, _, _, bs, _, _, _, quant, window, _ = CASES[name]
    q, pool, tables, positions, want = _ref(refs, name)
    once = model_attend(q, pool, tables, positions, bs, quant, window,
                        split=False)
    assert _over(once.numpy(), want) > 0.0
    split = model_attend(q, pool, tables, positions, bs, quant, window)
    assert _over(split.numpy(), want) <= 0.0
