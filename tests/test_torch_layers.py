"""Each function of the port's models/layers.py against the reference
package's, on the same seeded numpy inputs. f32: atol 1e-6 (same arithmetic,
another library's rounding of transcendental functions); bf16: atol 1e-2
(one bf16 rounding at values of order one)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

from _torch_parity import JDT, TDT, t_np, to_np

RNG = np.random.default_rng(0)
CASES = [("float32", 1e-6), ("bfloat16", 1e-2)]


def _pair(a, dtype):
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


@pytest.mark.parametrize("dtype,atol", CASES)
def test_rmsnorm(dtype, atol):
    x = RNG.standard_normal((2, 5, 64)).astype(np.float32)
    sc = (RNG.standard_normal(64) * 0.1).astype(np.float32)
    xj, xt = _pair(x, dtype)
    sj, st = _pair(sc, dtype)
    np.testing.assert_allclose(t_np(TL.rmsnorm(st, xt, 1e-6)),
                               to_np(JL.rmsnorm(sj, xj, 1e-6)),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_matmul(dtype, atol):
    # f32: two summation orders over 64 terms of order one
    x = RNG.standard_normal((2, 3, 64)).astype(np.float32)
    w = (RNG.standard_normal((64, 32)) * 0.1).astype(np.float32)
    xj, xt = _pair(x, dtype)
    wj, wt = _pair(w, dtype)
    out = TL.matmul(xt, wt)
    assert out.dtype == TDT[dtype]
    np.testing.assert_allclose(t_np(out), to_np(JL.matmul(xj, wj)),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_einsum_f32(dtype):
    a = RNG.standard_normal((2, 3, 2, 2, 16)).astype(np.float32)
    b = RNG.standard_normal((2, 7, 2, 16)).astype(np.float32)
    aj, at = _pair(a, dtype)
    bj, bt = _pair(b, dtype)
    out = TL.einsum_f32("bqkgh,bskh->bkgqs", at, bt)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), to_np(JL.einsum_f32("bqkgh,bskh->bkgqs", aj, bj)),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(dtype, atol, theta):
    # f32: sin/cos of angles up to ~4000 rad differ by a few 1e-6 between
    # the two libraries; bf16: one rounding at values up to ~4
    x = RNG.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4000, -1], [7, 8, 9, 10, 11, 12]],
                     np.int32)
    xj, xt = _pair(x, dtype)
    np.testing.assert_allclose(
        t_np(TL.apply_rope(xt, torch.from_numpy(pos), theta)),
        to_np(JL.apply_rope(xj, jnp.asarray(pos), theta)), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", CASES)
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_glu_combine(dtype, atol, act):
    g = RNG.standard_normal((2, 3, 32)).astype(np.float32)
    u = RNG.standard_normal((2, 3, 32)).astype(np.float32)
    gj, gt = _pair(g, dtype)
    uj, ut = _pair(u, dtype)
    np.testing.assert_allclose(t_np(TL.glu_combine(act, gt, ut)),
                               to_np(JL.glu_combine(act, gj, uj)),
                               atol=atol * 3, rtol=0)


@pytest.mark.parametrize("name", ["gelu", "silu", "squared_relu"])
def test_activations(name):
    x = RNG.standard_normal((4, 33)).astype(np.float32)
    np.testing.assert_allclose(
        TL.ACTIVATIONS[name](torch.from_numpy(x)).numpy(),
        to_np(JL.ACTIVATIONS[name](jnp.asarray(x))), atol=1e-6, rtol=0)
    assert TL.is_glu("swiglu") and not TL.is_glu(name)


@pytest.mark.parametrize("dtype,atol", CASES)
def test_embed_lookup_is_the_reference_onehot_matmul(dtype, atol):
    cfg = types.SimpleNamespace(d_model=64, logits_softcap=None)
    table = (RNG.standard_normal((48, 64)) * 0.02).astype(np.float32)
    toks = RNG.integers(0, 48, (2, 5)).astype(np.int32)
    tj, tt = _pair(table, dtype)
    out = TL.embed_lookup({"table": tt}, cfg, torch.from_numpy(toks))
    for onehot in (True, False):
        ref = JL.embed_lookup({"table": tj}, cfg, jnp.asarray(toks),
                              onehot=onehot)
        np.testing.assert_allclose(t_np(out), to_np(ref), atol=atol * 1e-2,
                                   rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-4)])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_lm_head_f32_logits(dtype, atol, softcap, monkeypatch):
    # bf16 inputs are exact in f32 on both sides; what differs is the order
    # of a 64-term f32 sum
    cfg = types.SimpleNamespace(d_model=64, logits_softcap=softcap)
    table = (RNG.standard_normal((48, 64))).astype(np.float32)
    x = RNG.standard_normal((2, 3, 64)).astype(np.float32)
    tj, tt = _pair(table, dtype)
    xj, xt = _pair(x, dtype)
    ref = to_np(JL.lm_head({"table": tj}, cfg, xj))
    out = TL.lm_head({"table": tt}, cfg, xt)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=1e-6)
    # the sliced form (large vocabularies) gives the same logits
    monkeypatch.setattr(TL, "_HEAD_SLICE", 16)
    np.testing.assert_allclose(TL.lm_head({"table": tt}, cfg, xt).numpy(),
                               out.numpy(), atol=1e-6, rtol=0)


def test_inits_take_a_generator_and_keep_the_layout():
    gen = torch.Generator(device="cpu").manual_seed(3)
    w = TL.dense_init(gen, 64, 32, "bfloat16", "cpu")
    ws = TL.dense_init(gen, 64, 32, "bfloat16", "cpu", repeats=3)
    assert w.shape == (64, 32) and ws.shape == (3, 64, 32)
    assert w.dtype == torch.bfloat16
    assert abs(float(ws.float().std()) - TL.INIT_STD) < 2e-3
    gen2 = torch.Generator(device="cpu").manual_seed(3)
    assert torch.equal(TL.dense_init(gen2, 64, 32, "bfloat16", "cpu"), w)
    cfg = types.SimpleNamespace(padded_vocab_size=48, d_model=64,
                                param_dtype="bfloat16")
    assert TL.embed_init(gen, cfg, "cpu")["table"].shape == (48, 64)
    assert float(TL.rmsnorm_init(64, "bfloat16", "cpu").abs().sum()) == 0.0
