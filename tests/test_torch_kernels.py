"""The plain PyTorch versions of the port's two paged attention kernels
against the reference package's Pallas kernels run in interpret mode on the
CPU, on the same seeded numpy inputs. (The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.)

Tolerances: f32 pools 2e-5 (two f32 summation orders); bf16 outputs 3e-2
(one bf16 rounding of values of order one, plus the plain path's bf16
dequantisation of a quantised pool where the kernel keeps f32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode, paged_prefill

from _torch_parity import (JDT, TDT, paged_case, pool_jax, pool_tensors,
                           t_np, to_np, ulp_diff_f32)

K, G, HD, BS = 2, 2, 16, 4


def _decode_both(case, q, positions, tables, dtype, window=None,
                 return_mass=False):
    pj = pool_jax(case, dtype)
    out_j = jops.paged_decode_attention(
        jnp.asarray(q, JDT[dtype]), pj["kb"], pj["vb"], pj["pos"],
        jnp.asarray(tables), jnp.asarray(positions), window=window,
        backend="interpret", k_scales=pj.get("ks"), v_scales=pj.get("vs"),
        return_mass=return_mass)
    pt = pool_tensors(case, dtype)
    out_t = tops.paged_decode_attention(
        torch.from_numpy(q).to(TDT[dtype]), pt["kb"], pt["vb"], pt["pos"],
        torch.from_numpy(tables), torch.from_numpy(positions), window=window,
        k_scales=pt.get("ks"), v_scales=pt.get("vs"),
        return_mass=return_mass)
    return out_j, out_t


DECODE_CASES = [
    # name, dtype, quant, window, atol
    ("f32", "float32", "none", None, 2e-5),
    ("bf16", "bfloat16", "none", None, 3e-2),
    ("int8", "bfloat16", "int8", None, 3e-2),
    ("int4", "bfloat16", "int4", None, 3e-2),
    ("f32-window", "float32", "none", 5, 2e-5),
]


@pytest.mark.parametrize("name,dtype,quant,window,atol", DECODE_CASES,
                         ids=[c[0] for c in DECODE_CASES])
def test_paged_decode_plain_matches_pallas(name, dtype, quant, window, atol):
    lens = [13, 7, 16]
    case = paged_case(3, b=3, K=K, G=G, hd=HD, bs=BS, lens=lens, m_blocks=5,
                      n_blocks=14, dtype=dtype, quant=quant)
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, K, G, HD)).astype(np.float32)
    positions = np.asarray(lens, np.int32) - 1
    out_j, out_t = _decode_both(case, q, positions, case["tables"], dtype,
                                window=window)
    assert out_t.dtype == TDT[dtype] and tuple(out_t.shape) == (3, K, G, HD)
    np.testing.assert_allclose(t_np(out_t), to_np(out_j), atol=atol, rtol=0)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_paged_decode_plain_f32_dequant_matches_pallas_to_one_rounding(quant):
    """Asked to dequantise rows to f32 (what both kernels do), the plain
    version differs from the Pallas kernel only by the output's rounding to
    bf16: 1e-3 + 2^-7 |value|, the tolerance the CUDA kernel is held to on
    the card."""
    lens = [13, 7, 16]
    case = paged_case(3, b=3, K=K, G=G, hd=HD, bs=BS, lens=lens, m_blocks=5,
                      n_blocks=14, dtype="bfloat16", quant=quant)
    q = np.random.default_rng(7).standard_normal((3, K, G, HD)).astype(
        np.float32)
    positions = np.asarray(lens, np.int32) - 1
    out_j, _ = _decode_both(case, q, positions, case["tables"], "bfloat16")
    pt = pool_tensors(case, "bfloat16")
    out_t = paged_decode.paged_decode_attention_plain(
        torch.from_numpy(q).to(torch.bfloat16), pt["kb"], pt["vb"], pt["pos"],
        torch.from_numpy(case["tables"]), torch.from_numpy(positions),
        k_scales=pt["ks"], v_scales=pt["vs"], dequant_dtype=torch.float32)
    np.testing.assert_allclose(t_np(out_t), to_np(out_j), atol=1e-3,
                               rtol=2.0 ** -7)


def test_paged_decode_trimmed_tables_equal_full():
    lens = [6, 3]
    case = paged_case(5, b=2, K=K, G=G, hd=HD, bs=BS, lens=lens, m_blocks=8,
                      n_blocks=12)
    q = np.random.default_rng(1).standard_normal((2, K, G, HD)).astype(
        np.float32)
    positions = np.asarray(lens, np.int32) - 1
    full_j, full_t = _decode_both(case, q, positions, case["tables"],
                                  "float32")
    trim = np.ascontiguousarray(case["tables"][:, :2])
    trim_j, trim_t = _decode_both(case, q, positions, trim, "float32")
    np.testing.assert_allclose(t_np(trim_t), t_np(full_t), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t_np(trim_t), to_np(trim_j), atol=2e-5, rtol=0)


def test_paged_decode_mass_unassigned_entry_and_inert_lane():
    """return_mass, a table whose middle entry is unassigned (its block was
    dropped by the retention policy), and an inert lane (position -1, empty
    table): output finite and zero for the inert lane, masses equal."""
    lens = [12, 9, 1]
    case = paged_case(9, b=3, K=K, G=G, hd=HD, bs=BS, lens=lens, m_blocks=4,
                      n_blocks=12)
    tables = case["tables"].copy()
    tables[0, 1] = -1                    # unassigned middle entry
    tables[2, :] = -1                    # inert lane
    positions = np.asarray([11, 8, -1], np.int32)
    q = np.random.default_rng(2).standard_normal((3, K, G, HD)).astype(
        np.float32)
    (o_j, m_j), (o_t, m_t) = _decode_both(case, q, positions, tables,
                                          "float32", return_mass=True)
    assert torch.isfinite(o_t).all() and torch.isfinite(m_t).all()
    np.testing.assert_allclose(t_np(o_t), to_np(o_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(t_np(m_t), to_np(m_j), atol=1e-5, rtol=0)
    assert float(o_t[2].abs().max()) == 0.0
    assert float(m_t[2].abs().max()) == 0.0
    assert float(m_t[0, 1]) == 0.0
    np.testing.assert_allclose(t_np(m_t[:2]).sum(-1), 1.0, atol=1e-5)


def test_merge_block_mass_matches_reference_merge():
    rng = np.random.default_rng(0)
    bm = rng.standard_normal((2, 3, K, G)).astype(np.float32)
    bl = rng.uniform(0.1, 2.0, (2, 3, K, G)).astype(np.float32)
    bm[0, 1], bl[0, 1] = -1e30, 0.0
    M = bm.max(axis=1, keepdims=True)
    w = bl * np.exp(bm - M)
    ref = (w / np.maximum(w.sum(axis=1, keepdims=True), 1e-30)).mean((2, 3))
    got = paged_decode.merge_block_mass(torch.from_numpy(bm),
                                        torch.from_numpy(bl))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Kernel 2: chunked prefill through the pool
# ---------------------------------------------------------------------------

def _prefill_both(case, q, k_new, v_new, positions, dtype):
    pj = pool_jax(case, dtype)
    jd = JDT[dtype]
    out_j = jops.paged_prefill_attention(
        jnp.asarray(q, jd), jnp.asarray(k_new, jd), jnp.asarray(v_new, jd),
        pj["kb"], pj["vb"], pj["pos"], jnp.asarray(case["tables"]),
        jnp.asarray(positions), backend="interpret",
        k_scales=pj.get("ks"), v_scales=pj.get("vs"))
    new_j = {"pos": out_j[1], "kb": out_j[2], "vb": out_j[3]}
    if "ks" in pj:
        new_j["ks"], new_j["vs"] = out_j[4], out_j[5]
    pt = pool_tensors(case, dtype)
    td = TDT[dtype]
    o_t = tops.paged_prefill_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(k_new).to(td),
        torch.from_numpy(v_new).to(td), pt["kb"], pt["vb"], pt["pos"],
        torch.from_numpy(case["tables"]), torch.from_numpy(positions),
        k_scales=pt.get("ks"), v_scales=pt.get("vs"))
    return out_j[0], new_j, o_t, pt


def _prefill_reference_dense(case, q, k_new, v_new, positions, dtype):
    """The reference package's own dense chunk-append path (scatter, gather,
    dense softmax) on the same inputs: the path whose division form
    (scale = absmax / qmax, x / scale) the port's quantiser shares."""
    from repro.configs.base import BlockSpec
    from repro.models import attention as JA
    jd = JDT[dtype]
    return JA._chunk_append(
        jnp.asarray(q, jd), jnp.asarray(k_new, jd), jnp.asarray(v_new, jd),
        pool_jax(case, dtype), BlockSpec(), jnp.asarray(positions),
        jnp.asarray(case["tables"]), JA.AttnSettings(backend="naive"))


PREFILL_CASES = [
    # name, dtype, quant, history per lane, chunk lens (of C = 8), atol
    ("f32-fresh", "float32", "none", [0, 0], [8, 8], 2e-5),
    ("f32-half-full-odd", "float32", "none", [6, 9], [8, 5], 2e-5),
    ("bf16-half-full-odd", "bfloat16", "none", [6, 9], [8, 5], 3e-2),
    ("int8-half-full-odd", "bfloat16", "int8", [6, 9], [8, 5], 3e-2),
    # int4: the reference package's own kernel-vs-dense tolerance (atol and
    # rtol 8e-2); its
    # interpreted kernel forms the scale 1 ULP apart from its dense path,
    # which can move a code that sits on a rounding tie by one step
    ("int4-half-full-odd", "bfloat16", "int4", [6, 9], [8, 5], 8e-2),
]


@pytest.mark.parametrize("name,dtype,quant,hist,clens,atol", PREFILL_CASES,
                         ids=[c[0] for c in PREFILL_CASES])
def test_paged_prefill_plain_matches_pallas(name, dtype, quant, hist, clens,
                                            atol):
    b, C = 2, 8
    case = paged_case(11, b=b, K=K, G=G, hd=HD, bs=BS, lens=hist, m_blocks=6,
                      n_blocks=16, dtype=dtype, quant=quant)
    # map the blocks the chunk will fill (the engine allocates them first)
    used = set(case["tables"][case["tables"] >= 0].tolist())
    free = [i for i in range(1, 16) if i not in used]
    tables = case["tables"].copy()
    for i in range(b):
        need = -(-(hist[i] + clens[i]) // BS)
        for j in range(need):
            if tables[i, j] < 0:
                tables[i, j] = free.pop()
    case = dict(case, tables=tables)
    rng = np.random.default_rng(13)
    q = rng.standard_normal((b, C, K, G, HD)).astype(np.float32)
    k_new = rng.standard_normal((b, C, K, HD)).astype(np.float32)
    v_new = rng.standard_normal((b, C, K, HD)).astype(np.float32)
    positions = np.full((b, C), -1, np.int32)
    for i in range(b):
        positions[i, :clens[i]] = hist[i] + np.arange(clens[i])
    o_j, new_j, o_t, new_t = _prefill_both(case, q, k_new, v_new, positions,
                                           dtype)
    np.testing.assert_allclose(t_np(o_t), to_np(o_j), atol=atol,
                               rtol=atol if quant == "int4" else 0)
    # padding rows give exactly 0 on both sides
    assert float(o_t[1, clens[1]:].abs().sum()) == 0.0
    # against the reference's dense path: same division form, so the pool
    # outside scratch block 0 is EXACT (codes, payload, positions) and the
    # scales agree to 1 ULP; valid output rows agree to one output rounding
    o_d, new_d = _prefill_reference_dense(case, q, k_new, v_new, positions,
                                          dtype)
    valid = positions >= 0
    np.testing.assert_allclose(t_np(o_t)[valid], to_np(o_d)[valid],
                               atol=2e-5 if dtype == "float32" else 8e-3,
                               rtol=0)
    for n in ("kb", "vb", "pos"):
        np.testing.assert_array_equal(t_np(new_t[n])[1:],
                                      to_np(new_d[n])[1:], err_msg=n)
    # against the interpreted kernel: positions exact, codes exact except
    # where its 1-ULP-apart scale moved a tie by one step, scales <= 1 ULP
    np.testing.assert_array_equal(t_np(new_t["pos"])[1:],
                                  to_np(new_j["pos"])[1:])
    if quant == "none":
        for n in ("kb", "vb"):
            np.testing.assert_array_equal(t_np(new_t[n])[1:],
                                          to_np(new_j[n])[1:], err_msg=n)
    else:
        for n in ("kb", "vb"):
            a, c = t_np(new_t[n])[1:], to_np(new_j[n])[1:]
            if quant == "int4":             # compare nibbles, not bytes
                a = np.stack([a & 0xF, a >> 4], -1).astype(np.int32)
                c = np.stack([c & 0xF, c >> 4], -1).astype(np.int32)
            d = np.abs(a.astype(np.int32) - c.astype(np.int32))
            assert d.max() <= 1 and (d != 0).mean() < 0.01, (n, d.max())
        for n in ("ks", "vs"):
            assert ulp_diff_f32(t_np(new_t[n])[1:],
                                to_np(new_d[n])[1:]).max() <= 1, n
            assert ulp_diff_f32(t_np(new_t[n])[1:],
                                to_np(new_j[n])[1:]).max() <= 1, n


def test_paged_prefill_plain_writes_nothing_for_padding_or_unmapped():
    b, C = 1, 8
    case = paged_case(17, b=b, K=K, G=G, hd=HD, bs=BS, lens=[4], m_blocks=3,
                      n_blocks=6)
    # chunk rows 4..9 valid but only logical block 1 is mapped: rows at
    # positions 8, 9 (logical block 2) and the two padding rows write nothing
    tables = case["tables"].copy()
    tables[0, 1] = 5
    before = pool_tensors(case)
    pt = pool_tensors(case)
    rng = np.random.default_rng(1)
    positions = np.asarray([[4, 5, 6, 7, 8, 9, -1, -1]], np.int32)
    paged_prefill.paged_prefill_attention_plain(
        torch.from_numpy(rng.standard_normal((b, C, K, G, HD)).astype(
            np.float32)),
        torch.from_numpy(rng.standard_normal((b, C, K, HD)).astype(
            np.float32)),
        torch.from_numpy(rng.standard_normal((b, C, K, HD)).astype(
            np.float32)),
        pt["kb"], pt["vb"], pt["pos"], torch.from_numpy(tables),
        torch.from_numpy(positions))
    changed = (pt["pos"] != before["pos"]).any(dim=1).nonzero()[:, 0].tolist()
    assert changed == [5]
    assert pt["pos"][5].tolist() == [4, 5, 6, 7]
    assert torch.equal(pt["kb"][0], before["kb"][0])        # scratch intact
