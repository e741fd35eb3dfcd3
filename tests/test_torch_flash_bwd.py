"""The port's flash-attention backward (kernels/flash_attention_bwd.py and
ops.flash_attention_trainable) against the reference package's: gradients
through the port's autograd Function (the kernels' plain versions on the
CPU) against the reference's `ops.flash_attention_trainable(...,
interpret=True)` (its dQ and dK/dV kernels in interpret mode) and against
jax.vjp through its oracle `ref.flash_attention_ref`, f32 and bf16; window,
chunk and causal masks, G = 1, 2, 4, head_dim 16 and 80, rows padded with
position -1; torch.autograd.gradcheck of the Function in f64; rows that see
nothing get zero gradients; the wrapper's CPU rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import flash_attention_bwd as FB, ops as tops

from _torch_parity import JDT, TDT, t_np, to_np

# (b, s, K, G, hd, window, chunk, lens): s a multiple of the reference
# kernel's 32-position tiles; `lens` pads rows with position -1
CASES = [
    (1, 64, 2, 2, 16, None, None, None),
    (2, 64, 1, 4, 16, 24, None, [64, 40]),
    (1, 64, 2, 1, 80, None, 32, None),
    (2, 64, 2, 4, 80, 20, None, [64, 37]),
    (2, 64, 2, 4, 80, None, None, None),
]
# f32: the reference kernel test's own tolerance (tests/test_kernels.py:
# sums in another order). bf16: each side rounds its f32 results once to
# bf16 and both take D from the output rounded to bf16; against the oracle,
# which differentiates the f32 softmax, D differs by the output's rounding:
# 4e-2 of the largest |gradient|.
TOL = {"float32": 2e-4, "bfloat16": 4e-2}


def _case(seed, b, s, K, G, hd, lens):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, K, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, K, hd)).astype(np.float32)
    do = rng.standard_normal((b, s, K, G, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    for i, n in enumerate(lens or []):
        pos[i, n:] = -1
        # a padded row's loss is masked: no gradient arrives there (the
        # oracle's softmax over an all-masked row is uniform, not zero)
        do[i, n:] = 0.0
    return q, k, v, do, pos


def _torch_grads(q, k, v, do, pos, window, chunk, dtype):
    leaves = [torch.from_numpy(a).to(TDT[dtype]).requires_grad_(True)
              for a in (q, k, v)]
    p = torch.from_numpy(pos)
    out = tops.flash_attention_trainable(*leaves, p, p, window=window,
                                         chunk=chunk)
    assert out.dtype == TDT[dtype]
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(do).to(TDT[dtype]))
    for g, a in zip(grads, leaves):
        assert g.dtype == a.dtype and g.shape == a.shape
    return [t_np(g) for g in grads]


def _jax_grads(fn, q, k, v, do, dtype):
    args = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    _, vjp = jax.vjp(fn, *args)
    return [to_np(g) for g in vjp(jnp.asarray(do, JDT[dtype]))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,K,G,hd,window,chunk,lens", CASES)
def test_flash_backward_matches_reference(dtype, b, s, K, G, hd, window,
                                          chunk, lens):
    q, k, v, do, pos = _case(7, b, s, K, G, hd, lens)
    got = _torch_grads(q, k, v, do, pos, window, chunk, dtype)
    jpos = jnp.asarray(pos)
    kern = _jax_grads(lambda q_, k_, v_: jops.flash_attention_trainable(
        q_, k_, v_, jpos, jpos, window=window, chunk=chunk, q_block=32,
        kv_block=32, interpret=True), q, k, v, do, dtype)
    oracle = _jax_grads(lambda q_, k_, v_: jref.flash_attention_ref(
        q_, k_, v_, jpos, jpos, window=window, chunk=chunk), q, k, v, do,
        dtype)
    tol = TOL[dtype]
    for want_set in (kern, oracle):
        for name, g, w in zip(("dq", "dk", "dv"), got, want_set):
            top = float(np.abs(w).max())
            if dtype == "float32":
                np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(g, w, atol=tol * top, rtol=2 ** -7,
                                           err_msg=name)


@pytest.mark.parametrize("window,chunk", [(None, None), (3, None),
                                          (None, 4)])
def test_flash_function_gradcheck_f64(window, chunk):
    """The autograd Function's backward (the plain backward on the CPU) is
    the derivative of its forward: finite differences in f64, with a padded
    row and GQA (G = 2)."""
    b, s, K, G, hd = 2, 7, 1, 2, 4
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh)).requires_grad_(True)
               for sh in ((b, s, K, G, hd), (b, s, K, hd), (b, s, K, hd)))
    pos = torch.arange(s, dtype=torch.int32)[None].repeat(b, 1)
    pos[1, 5:] = -1

    def fn(q_, k_, v_):
        return tops.flash_attention_trainable(q_, k_, v_, pos, pos,
                                              window=window, chunk=chunk)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-5)


def test_rows_that_see_nothing_get_zero_gradients():
    """Queries whose keys are all padding (lse -1e30 from the forward):
    finite, zero dq, and nothing flows from them into dk / dv."""
    b, s, K, G, hd = 1, 16, 1, 2, 16
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((b, s, K * G, hd))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, K, hd))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, K, hd))
                         .astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((b, s, K * G, hd))
                          .astype(np.float32))
    qpos = torch.arange(s, dtype=torch.int32)[None]
    kpos = qpos.clone()
    kpos[0, :6] = -1                  # queries 0..5 see nothing (causal)
    out, lse = tops.flash_attention_fwd(q, k, v, qpos, kpos,
                                        return_lse=True)
    assert float(lse[0, :6].max()) < -1e29
    before = FB.launches
    dq, dk, dv = FB.flash_attention_bwd(q, k, v, out, lse, do, qpos, kpos)
    assert FB.launches == before      # the CPU takes the plain version
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    assert float(dq[0, :6].abs().max()) == 0.0
    assert float(dk[0, :6].abs().max()) == 0.0      # padded keys
    # the blind rows' dO changes nothing
    do2 = do.clone()
    do2[0, :6] = 100.0
    g2 = FB.flash_attention_bwd(q, k, v, out, lse, do2, qpos, kpos)
    for a, c in zip((dq, dk, dv), g2):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
