"""The port's models/attention.py against the reference package's: the KV
codec bit for bit, and attn_apply for a decode step and a chunk append with
converted weights and pools."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.models import attention as TA

from _torch_parity import (model_pair, paged_case, pool_jax, pool_tensors,
                           t_np, to_np, ulp_diff_f32)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_bit_equal(kind, dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                              # an all-zero row: scale 0
    x[0, 1, 0, :4] = [0.5, 1.5, 2.5, -0.5]        # ties, once scaled
    xj = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.float32 if dtype == "float32"
                                else torch.bfloat16)
    qj, sj = JA.quantize_kv(xj, kind)
    qt, st = TA.quantize_kv(xt, kind)
    assert qt.dtype == (torch.int8 if kind == "int8" else torch.uint8)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert ulp_diff_f32(st.numpy(), np.asarray(sj)).max() <= 1
    dj = JA.dequantize_kv(qj, sj, kind)
    dt = TA.dequantize_kv(qt, torch.from_numpy(np.array(sj)), kind)
    np.testing.assert_array_equal(t_np(dt), to_np(dj))
    assert TA.quantize_kv(xt, "none")[1] is None


def test_mask_matches_reference():
    from repro.configs.base import BlockSpec as JB
    from repro_torch.configs.base import BlockSpec as TB
    qpos = np.asarray([[0, 3, 9, -1]], np.int32)
    kpos = np.asarray([[0, 1, 2, 3, 8, 9, 10, -1]], np.int32)
    for kw in ({}, {"window": 3}, {"chunk": 4}):
        ref = JA._mask(jnp.asarray(qpos), jnp.asarray(kpos), JB(**kw))
        got = TA._mask(torch.from_numpy(qpos), torch.from_numpy(kpos),
                       TB(**kw))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _attn_inputs(cj, seed, b, s):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cj.d_model)).astype(np.float32)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("backend", ["kernel", "naive"])
def test_attn_apply_decode_and_chunk_append(quant, backend):
    """One chunk append (two lanes, one with padding) then one decode step
    through attn_apply on both sides; outputs to bf16 tolerance, pools
    outside scratch block 0 equal. The reference runs its Pallas kernels in
    interpret mode for backend "kernel" and its dense path for "naive"."""
    cj, pj, ct, pt = model_pair()
    blk_j, blk_t = cj.unit[0], ct.unit[0]
    K, hd, bs = cj.n_kv_heads, cj.resolved_head_dim, 4
    pmj = jax.tree.map(lambda a: a[0], pj["units"][0]["mixer"])
    pmt = {k: v[0] for k, v in pt["units"][0]["mixer"].items()}
    hist = [5, 0]
    case = paged_case(21, b=2, K=K, G=cj.q_group, hd=hd, bs=bs, lens=hist,
                      m_blocks=4, n_blocks=10, dtype="bfloat16", quant=quant,
                      shuffle=False)    # lane 0 holds blocks 1, 2
    tables = case["tables"].copy()
    tables[0, 2:4] = [7, 3]             # room for positions 8..15
    tables[1, :2] = [5, 6]
    cache_j = pool_jax(case, "bfloat16")
    cache_t = pool_tensors(case, "bfloat16")
    jset = JA.AttnSettings(backend="pallas" if backend == "kernel"
                           else "naive")
    tset = TA.AttnSettings(backend=backend)

    # ---- chunk append: lane 0 appends 8 tokens at 5.., lane 1 5 tokens at 0
    C = 8
    pos = np.full((2, C), -1, np.int32)
    pos[0] = 5 + np.arange(C)
    pos[1, :5] = np.arange(5)
    x = _attn_inputs(cj, 3, 2, C)
    yj, cache_j, _ = JA.attn_apply(
        pmj, cj, blk_j, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
        cache=cache_j, decode=False, settings=jset,
        block_tables=jnp.asarray(tables))
    yt, cache_t2, _ = TA.attn_apply(
        pmt, ct, blk_t, torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(pos), cache=cache_t, decode=False, settings=tset,
        block_tables=torch.from_numpy(tables))
    assert cache_t2 is cache_t                    # updated in place
    valid = pos >= 0
    np.testing.assert_allclose(t_np(yt)[valid], to_np(yj)[valid], atol=1e-2,
                               rtol=0)

    def pools_match():
        # outside scratch block 0: positions, payload / codes exact (the
        # projections feeding the pool agree bit for bit at this size).
        # One exception: the reference's INTERPRETED kernel forms a scale
        # 1 ULP apart from its own dense path, which can move a code that
        # sits on a rounding tie by one step.
        np.testing.assert_array_equal(t_np(cache_t["pos"])[1:],
                                      to_np(cache_j["pos"])[1:])
        for n in ("kb", "vb"):
            a, c = t_np(cache_t[n])[1:], to_np(cache_j[n])[1:]
            if quant == "none" or backend == "naive":
                np.testing.assert_array_equal(a.astype(np.float32),
                                              c.astype(np.float32), n)
                continue
            if quant == "int4":             # compare nibbles, not bytes
                a = np.stack([a & 0xF, a >> 4], -1)
                c = np.stack([c & 0xF, c >> 4], -1)
            d = np.abs(a.astype(np.int32) - c.astype(np.int32))
            assert d.max() <= 1 and (d != 0).mean() < 0.01, (n, d.max())
        for n in ("ks", "vs"):
            if n in cache_t:
                assert ulp_diff_f32(t_np(cache_t[n])[1:],
                                    to_np(cache_j[n])[1:]).max() <= 1, n

    pools_match()

    # ---- decode: both lanes emit one token at their next position
    pos1 = np.asarray([13, 5], np.int32)
    x1 = _attn_inputs(cj, 4, 2, 1)
    yj1, cache_j, auxj = JA.attn_apply(
        pmj, cj, blk_j, jnp.asarray(x1, jnp.bfloat16),
        jnp.asarray(pos1)[:, None], cache=cache_j, decode=True,
        settings=jset, block_tables=jnp.asarray(tables))
    yt1, _, auxt = TA.attn_apply(
        pmt, ct, blk_t, torch.from_numpy(x1).to(torch.bfloat16),
        torch.from_numpy(pos1)[:, None], cache=cache_t, decode=True,
        settings=tset, block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(t_np(yt1), to_np(yj1), atol=1e-2, rtol=0)
    pools_match()
    assert auxt == {} and "attn_mass" not in auxj


def test_attn_apply_track_mass_and_unported_paths_raise():
    cj, pj, ct, pt = model_pair()
    pmt = {k: v[0] for k, v in pt["units"][0]["mixer"].items()}
    pmj = jax.tree.map(lambda a: a[0], pj["units"][0]["mixer"])
    case = paged_case(2, b=2, K=cj.n_kv_heads, G=cj.q_group,
                      hd=cj.resolved_head_dim, bs=4, lens=[6, 3], m_blocks=3,
                      n_blocks=8, dtype="bfloat16")
    x1 = _attn_inputs(cj, 8, 2, 1)
    pos1 = np.asarray([6, 3], np.int32)
    _, _, auxj = JA.attn_apply(
        pmj, cj, cj.unit[0], jnp.asarray(x1, jnp.bfloat16),
        jnp.asarray(pos1)[:, None], cache=pool_jax(case, "bfloat16"),
        decode=True,
        settings=JA.AttnSettings(backend="pallas", track_mass=True),
        block_tables=jnp.asarray(case["tables"]))
    for backend in ("kernel", "naive"):
        _, _, auxt = TA.attn_apply(
            pmt, ct, ct.unit[0], torch.from_numpy(x1).to(torch.bfloat16),
            torch.from_numpy(pos1)[:, None],
            cache=pool_tensors(case, "bfloat16"), decode=True,
            settings=TA.AttnSettings(backend=backend, track_mass=True),
            block_tables=torch.from_numpy(case["tables"]))
        np.testing.assert_allclose(auxt["attn_mass"].numpy(),
                                   np.asarray(auxj["attn_mass"]), atol=5e-3,
                                   rtol=0)
    xt = torch.from_numpy(_attn_inputs(cj, 1, 1, 4)).to(torch.bfloat16)
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(NotImplementedError, match="flash_attention_fwd"):
        TA.attn_apply(pmt, ct, ct.unit[0], xt, pos)
    ring = {"k": torch.zeros(1, 8, 2, 16), "v": torch.zeros(1, 8, 2, 16),
            "pos": torch.full((1, 8), -1, dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="ring"):
        TA.attn_apply(pmt, ct, ct.unit[0], xt[:, :1], pos[:, :1], cache=ring,
                      decode=True)
    with pytest.raises(NotImplementedError, match="ring"):
        TA.attn_apply(pmt, ct, ct.unit[0], xt, pos, cache=ring)
    with pytest.raises(ValueError):
        TA.AttnSettings(backend="pallas")
