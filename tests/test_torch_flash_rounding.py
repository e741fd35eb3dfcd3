"""The rounding of the flash kernels' tensor-core bodies (bf16 inputs),
modelled on the CPU against the reference package's flash forward and
backward kernels (interpret mode): q, k, v in bf16; every product in f32
with 1/sqrt(hd) applied to the f32 product; P (and in the backward dS)
split into bf16 hi + lo halves before the second product, as the kernels
feed them to mma.sync (csrc/mma_tile.cuh, mt_split). The bounds are those
phase 2 of chip_smoke.py holds the card's kernels to: out within 1e-3 +
2^-7 of its value, lse within 1e-4, dq / dk / dv within 2^-7 of their
value + 1e-3 of the tensor's largest |value|. Rounded once to bf16, P
exceeds the output's bound and P with dS the gradients' (the last two
tests): so the kernels split them. Danube's heads (K 8, G 4, hd 80) and
gemma3-12b's (K 8, G 2, hd 256) at reduced length."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro.kernels.flash_attention_bwd import flash_attention_bwd as jax_bwd

from _torch_parity import t_np, to_np

TOL_BF16, RTOL_BF16, TOL_LSE, ATOL_BWD_BF16 = 1e-3, 2.0 ** -7, 1e-4, 1e-3
NEG_INF = -1e30
# (s, K, G, hd, window): danube's heads causal and windowed, gemma3's local
CASES = [(128, 8, 4, 80, None), (128, 8, 4, 80, 48), (128, 8, 2, 256, 64)]


def _bf(x):
    return x.to(torch.bfloat16).float()


def _operand(x, split):
    """x as the kernels feed it to a bf16 product: hi + lo, or hi alone."""
    hi = _bf(x)
    return hi + _bf(x - hi) if split else hi


def _mask(s, window):
    i = torch.arange(s)
    m = i[None] <= i[:, None]
    if window is not None:
        m &= i[None] > i[:, None] - window
    return m                                          # [query, key]


def model_fwd(q, k, v, window, split=True):
    """q [s, K, G, hd], k/v [s, K, hd] (bf16 values in f32) -> out (bf16
    values), lse."""
    s, K, G, hd = q.shape
    sc = torch.einsum("qkgh,skh->kgqs", q, k) * float(1.0 / np.sqrt(hd))
    mask = _mask(s, window)
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), torch.zeros_like(sc))
    l = torch.clamp(p.sum(-1), min=1e-30)
    o = torch.einsum("kgqs,skh->qkgh", _operand(p, split), v)
    out = _bf(o / l.permute(2, 0, 1)[..., None])
    lse = (m[..., 0] + torch.log(l)).permute(2, 0, 1)        # [s, K, G]
    return out, lse


def model_bwd(q, k, v, out, lse, do, window, split=True):
    """dq [s, K, G, hd], dk, dv [s, K, hd] (bf16 values): p recomputed from
    lse, D = rowsum(dO * O), P and dS split into hi + lo (or rounded once
    to bf16)."""
    s, K, G, hd = q.shape
    scale = float(1.0 / np.sqrt(hd))
    sc = torch.einsum("qkgh,skh->kgqs", q, k) * scale
    mask = _mask(s, window)
    rows = lse.permute(1, 2, 0)[..., None]
    p = torch.where(mask, torch.exp(sc - rows), torch.zeros_like(sc))
    dvec = (do * out).sum(-1).permute(1, 2, 0)[..., None]
    dv = torch.einsum("kgqs,qkgh->skh", _operand(p, split), do)
    ds = p * (torch.einsum("qkgh,skh->kgqs", do, v) - dvec)
    dsu = _operand(ds, split)
    dq = torch.einsum("kgqs,skh->qkgh", dsu, k) * scale
    dk = torch.einsum("kgqs,qkgh->skh", dsu, q) * scale
    return _bf(dq), _bf(dk), _bf(dv)


def _inputs(seed, s, K, G, hd):
    rng = np.random.default_rng(seed)
    return [_bf(torch.from_numpy(rng.standard_normal(sh).astype(np.float32)))
            for sh in ((s, K, G, hd), (s, K, hd), (s, K, hd), (s, K, G, hd))]


def _reference(q, k, v, do, window):
    """The reference's forward and backward kernels (interpret mode,
    64-position tiles) on the same inputs: out (bf16 values) and lse from
    the bf16 forward, then dq, dk, dv from the backward run on the same
    bf16 values held in f32 (its arithmetic is f32 either way; in bf16 it
    would round each query head's dk / dv before the sum over the kv
    head's G heads that the kernels take in f32), each rounded once to
    bf16 as the kernels round theirs."""
    s, K, G, hd = q.shape
    f32 = jnp.float32
    qj = jnp.asarray(t_np(q).reshape(1, s, K * G, hd))
    kj, vj = (jnp.asarray(t_np(x)[None]) for x in (k, v))
    pos = jnp.asarray(np.arange(s, dtype=np.int32)[None])
    tiles = dict(window=window, q_block=64, kv_block=64, interpret=True)
    bf = jnp.bfloat16
    out, lse = jax_fwd(qj.astype(bf), kj.astype(bf), vj.astype(bf), pos,
                       pos, return_lse=True, **tiles)
    dq, dk, dv = jax_bwd(qj, jnp.repeat(kj, G, axis=2),
                         jnp.repeat(vj, G, axis=2), out.astype(f32), lse,
                         jnp.asarray(t_np(do).reshape(1, s, K * G, hd)),
                         pos, pos, **tiles)

    def rounded(g, shape, fold):
        g = np.array(g).reshape(shape)
        g = torch.from_numpy(g.sum(2) if fold else g)
        return t_np(_bf(g))

    return (to_np(out).reshape(s, K, G, hd), to_np(lse).reshape(s, K, G),
            (rounded(dq, (s, K, G, hd), False),
             rounded(dk, (s, K, G, hd), True),
             rounded(dv, (s, K, G, hd), True)))


def _over_out(got, want):
    """How far out exceeds phase 2's bf16 bound (<= 0: within)."""
    return float((np.abs(got - want) - (TOL_BF16 + RTOL_BF16 * np.abs(want))
                  ).max())


@pytest.mark.parametrize("s,K,G,hd,window", CASES)
def test_forward_rounding_within_phase2_bounds(s, K, G, hd, window):
    q, k, v, _ = _inputs(s + hd, s, K, G, hd)
    out, lse = model_fwd(q, k, v, window)
    want, lse_want, _ = _reference(q, k, v, torch.zeros_like(q), window)
    assert _over_out(t_np(out), want) <= 0.0
    np.testing.assert_allclose(t_np(lse), lse_want, atol=TOL_LSE, rtol=0)


def _over_grads(got, grads):
    """How far each of dq, dk, dv exceeds phase 2's backward bound."""
    return [float((np.abs(t_np(g) - w) - (RTOL_BF16 * np.abs(w) +
                                          ATOL_BWD_BF16 * np.abs(w).max())
                   ).max()) for g, w in zip(got, grads)]


def _backward(case, split=True):
    """The model's backward from the reference's own out and lse (as phase
    2 feeds both sides the forward kernel's), and the reference's dQ and
    dK/dV kernels' gradients."""
    s, K, G, hd, window = case
    q, k, v, do = _inputs(s + hd + 1, s, K, G, hd)
    out, lse, grads = _reference(q, k, v, do, window)
    got = model_bwd(q, k, v, torch.from_numpy(out.copy()),
                    torch.from_numpy(lse.copy()), do, window, split)
    return got, grads


@pytest.mark.parametrize("case", CASES)
def test_backward_rounding_within_phase2_bounds(case):
    got, grads = _backward(case)
    assert max(_over_grads(got, grads)) <= 0.0


def test_single_bf16_p_would_exceed_the_bound():
    """Why the kernels split P: rounded once to bf16 (2^-9 of each weight)
    it moves outputs of short causal rows, whose few weights do not
    average the error out, past 1e-3 + 2^-7 of their value on danube's
    heads."""
    s, K, G, hd, window = CASES[0]
    q, k, v, _ = _inputs(s + hd, s, K, G, hd)
    want = _reference(q, k, v, torch.zeros_like(q), window)[0]
    assert _over_out(t_np(model_fwd(q, k, v, window, split=False)[0]),
                     want) > 0.0
    assert _over_out(t_np(model_fwd(q, k, v, window)[0]), want) <= 0.0


def test_single_bf16_ds_would_exceed_the_bound():
    """The same for the backward: P and dS rounded once to bf16 move dq or
    dk past 2^-7 of their value + 1e-3 of the largest |value| on one of
    the cases, where the split stays inside on all (above)."""
    assert max(max(_over_grads(*_backward(c, split=False)))
               for c in CASES) > 0.0
