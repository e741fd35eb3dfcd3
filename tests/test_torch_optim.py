"""The port's optimizers, clipping, LR schedule and gradient compression:
the reference optimizer tests (tests/test_optim.py) replayed on the port,
each update held against the reference's on the same numpy inputs, and
the properties of stochastic int8 compression (unbiased over many draws,
within one quantization step, zero stays zero)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as JO
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro_torch.optim import optimizers as opt
from repro_torch.optim.compress import (compress_roundtrip, dequantize_int8,
                                        quantize_int8)
from repro_torch.optim.schedule import warmup_cosine

from _torch_parity import t_np, to_np


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def test_adamw_first_step_matches_reference():
    ocfg = opt.OptimizerConfig(kind="adamw_f32", lr=0.1, b1=0.9, b2=0.99,
                               eps=1e-8, weight_decay=0.0)
    params = {"w": _t([1.0, -2.0, 3.0])}
    grads = {"w": _t([0.5, 0.5, -1.0])}
    state = opt.init_state(ocfg, params)
    new_p, _ = opt.apply_updates(ocfg, params, grads, state, 0.1)
    expected = np.asarray([1.0, -2.0, 3.0]) - 0.1 * np.sign([0.5, 0.5, -1.0])
    np.testing.assert_allclose(new_p["w"].numpy(), expected, atol=1e-5)
    assert new_p is params and int(state["count"]) == 1


def test_adamw_weight_decay_shrinks():
    ocfg = opt.OptimizerConfig(kind="adamw_f32", lr=0.1, weight_decay=0.5)
    params = {"w": _t([10.0])}
    state = opt.init_state(ocfg, params)
    opt.apply_updates(ocfg, params, {"w": _t([0.0])}, state, 0.1)
    assert float(params["w"][0]) < 10.0


def test_adamw_bf16_state_dtype():
    ocfg = opt.OptimizerConfig(kind="adamw_bf16")
    state = opt.init_state(ocfg, {"w": torch.zeros(4, 4, dtype=torch.bfloat16)})
    assert state["m"]["w"].dtype == torch.bfloat16
    assert state["count"].dtype == torch.int32 and state["count"].dim() == 0


def test_adafactor_factored_shapes():
    ocfg = opt.OptimizerConfig(kind="adafactor")
    params = {"w": torch.zeros(6, 8), "b": torch.zeros(8),
              "t": torch.zeros(2, 6, 8)}
    f = opt.init_state(ocfg, params)["f"]
    assert tuple(f["w"]["vr"].shape) == (6,)
    assert tuple(f["w"]["vc"].shape) == (8,)
    assert tuple(f["t"]["vr"].shape) == (2, 6)
    assert tuple(f["t"]["vc"].shape) == (2, 8)
    assert tuple(f["b"]["v"].shape) == (8,)


def test_adafactor_state_much_smaller():
    ocfg = opt.OptimizerConfig(kind="adafactor")
    state = opt.init_state(ocfg, {"w": torch.zeros(512, 512)})
    elems = sum(x.numel() for x in jax.tree.leaves(
        state, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert elems < 0.01 * 512 * 512


def test_adafactor_descends_quadratic():
    ocfg = opt.OptimizerConfig(kind="adafactor", lr=0.1, weight_decay=0.0)
    params = {"w": torch.full((4, 4), 5.0)}
    state = opt.init_state(ocfg, params)
    l0 = float((params["w"] ** 2).sum())
    for _ in range(20):
        grads = {"w": 2.0 * params["w"]}
        opt.apply_updates(ocfg, params, grads, state, 0.1)
    assert float((params["w"] ** 2).sum()) < l0 * 0.5


def test_clip_by_global_norm():
    tree = {"a": _t([3.0]), "b": _t([4.0])}
    clipped, norm = opt.clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    same, _ = opt.clip_by_global_norm({"a": _t([3.0]), "b": _t([4.0])},
                                      100.0)
    np.testing.assert_allclose(same["a"].numpy(), [3.0])


def test_warmup_cosine_shape_and_reference_values():
    lrs = [float(warmup_cosine(s, 1e-3, 10, 100)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9
    assert lrs[10] == pytest.approx(1e-3, rel=0.1)
    assert lrs[-1] < lrs[20]
    assert lrs[-1] >= 1e-4 - 1e-9
    ref = [float(jax_warmup_cosine(jnp.asarray(s), 1e-3, 10, 100))
           for s in range(100)]
    np.testing.assert_allclose(lrs, ref, rtol=1e-6)


def _tree(rng):
    """A parameter-like tree: a stacked [2, 6, 8] leaf, a 2-d leaf, a
    stacked [2, 8] norm (factored over both axes by adafactor), a 1-d leaf
    and a bf16 leaf."""
    return {"units": [{"w": rng.standard_normal((2, 6, 8)),
                       "n": rng.standard_normal((2, 8))}],
            "head": rng.standard_normal((5, 7)),
            "b": rng.standard_normal((7,)),
            "h": rng.standard_normal((3, 4))}


BF16_LEAVES = ("h",)


def _to_torch(tree):
    def conv(path, a):
        dt = torch.bfloat16 if path[-1].key in BF16_LEAVES else torch.float32
        return torch.tensor(np.asarray(a, np.float32)).to(dt)
    return jax.tree_util.tree_map_with_path(conv, tree)


def _to_jax(tree):
    def conv(path, a):
        dt = jnp.bfloat16 if path[-1].key in BF16_LEAVES else jnp.float32
        return jnp.asarray(np.asarray(a, np.float32), dt)
    return jax.tree_util.tree_map_with_path(conv, tree)


@pytest.mark.parametrize("kind", opt.KINDS)
def test_updates_match_reference(kind):
    """Three clipped updates on a mixed tree (stacked, 2-d, 1-d and bf16
    leaves) against the reference's apply_updates and clip_by_global_norm.
    f32 leaves to 1e-6 of their values; bf16 leaves within one bf16 unit
    (each side rounds its f32 result once)."""
    rng = np.random.default_rng(2)
    p_np = _tree(rng)
    grads_np = [_tree(rng) for _ in range(3)]
    ocfg_t = opt.OptimizerConfig(kind=kind, lr=1e-2)
    ocfg_j = JO.OptimizerConfig(kind=kind, lr=1e-2)
    pt, pj = _to_torch(p_np), _to_jax(p_np)
    st, sj = opt.init_state(ocfg_t, pt), JO.init_state(ocfg_j, pj)
    for i, g in enumerate(grads_np):
        lr = 1e-2 * (i + 1)
        gt, nt = opt.clip_by_global_norm(_to_torch(g), 1.0)
        gj, nj = JO.clip_by_global_norm(_to_jax(g), 1.0)
        assert float(nt) == pytest.approx(float(nj), rel=1e-6)
        opt.apply_updates(ocfg_t, pt, gt, st, lr)
        pj, sj = JO.apply_updates(ocfg_j, pj, gj, sj, lr)
    flat_t = jax.tree_util.tree_leaves_with_path(
        pt, is_leaf=lambda x: isinstance(x, torch.Tensor))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(pj))
    for path, a in flat_t:
        w = to_np(flat_j[path])
        if a.dtype == torch.bfloat16:
            np.testing.assert_allclose(t_np(a), w, rtol=2 ** -7, atol=1e-6)
        else:
            np.testing.assert_allclose(t_np(a), w, rtol=1e-6, atol=1e-7)
    assert int(st["count"]) == int(sj["count"]) == 3


def test_compression_unbiased_over_many_draws():
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal(256).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    n = 2000
    acc = torch.zeros_like(x)
    for _ in range(n):
        q, s = quantize_int8(x, gen)
        acc += dequantize_int8(q, s)
    _, s = quantize_int8(x, gen)
    # each draw is within one step s of x with variance <= s^2 / 4: the
    # mean of n draws stays within 5 standard errors
    assert float((acc / n - x).abs().max()) < 5 * float(s) / (2 * n ** 0.5)


def test_compression_within_one_step_and_zero_stays_zero():
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((8, 16)).astype(np.float32))
    x[0] = 0.0
    gen = torch.Generator().manual_seed(1)
    q, s = quantize_int8(x, gen)
    assert q.dtype == torch.int8
    y = dequantize_int8(q, s)
    assert float((y - x).abs().max()) <= float(s) * (1 + 1e-6)
    assert float(y[0].abs().max()) == 0.0
    zq, zs = quantize_int8(torch.zeros(5), gen)
    assert int(zq.abs().max()) == 0 and float(zs) > 0.0
    tree = {"a": x.to(torch.bfloat16), "b": [torch.zeros(3)]}
    out = compress_roundtrip(tree, gen)
    assert out["a"].dtype == torch.bfloat16
    assert float(out["b"][0].abs().max()) == 0.0
