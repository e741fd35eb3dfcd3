"""The port's chunked mLSTM scan (kernels/mlstm_scan.py, kernels/ops.py)
against the reference package's: the plain version and the ops entry point
(which takes the plain version for CPU tensors) against the reference's
Pallas kernel in interpret mode and its sequential oracle, over the
reference kernel test's sweep; the `initial` carry; the single-token decode
step; and the chunk contract both packages keep (reference fault F6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro_torch.kernels import mlstm_scan as MS
from repro_torch.kernels import ops

# the reference kernel test's tolerance (tests/test_kernels.py): f32 on both
# sides, sums taken in other orders
TOL = 1e-4
SWEEP = [(128, 2, 16, 16, 32), (64, 1, 8, 24, 64), (96, 4, 32, 32, 32)]


def _inputs(seed, b, s, h, dk, dv):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, dk)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, s, h, dk)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    ig = rng.standard_normal((b, s, h)).astype(np.float32)
    fg = (rng.standard_normal((b, s, h)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def _port(arrs, chunk, backend, initial=None):
    t = [torch.from_numpy(a) for a in arrs]
    init = None if initial is None else tuple(
        torch.from_numpy(np.asarray(x)) for x in initial)
    out, st = ops.mlstm_scan(*t, chunk=chunk, backend=backend, initial=init)
    return [out.numpy()] + [x.numpy() for x in st]


def _ref(arrs, chunk, backend, initial=None):
    j = [jnp.asarray(a) for a in arrs]
    init = None if initial is None else tuple(jnp.asarray(x) for x in initial)
    out, st = JOPS.mlstm_scan(*j, chunk=chunk, backend=backend, initial=init)
    return [np.asarray(out)] + [np.asarray(x) for x in st]


def _close(got, want, names=("out", "C", "n", "m")):
    for g, w, n in zip(got, want, names):
        assert g.shape == w.shape, n
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=n)


@pytest.mark.parametrize("ref_backend", ["interpret", "ref"])
@pytest.mark.parametrize("backend", ["naive", "kernel"])
@pytest.mark.parametrize("s,h,dk,dv,chunk", SWEEP)
def test_mlstm_scan_matches_reference(s, h, dk, dv, chunk, backend,
                                      ref_backend):
    """out, C, n and m of a fresh scan; the reference's oracle starts from
    m = -inf, its kernel from -1e30: both give the same state."""
    arrs = _inputs(s + dk, 2, s, h, dk, dv)
    got = _port(arrs, chunk, backend)
    _close(got, _ref(arrs, chunk, ref_backend))
    assert MS.launches == 0                  # CPU tensors: no kernel launch


@pytest.mark.parametrize("s,h,dk,dv,chunk", SWEEP)
def test_mlstm_scan_initial_carry(s, h, dk, dv, chunk):
    """A scan continued from the carried state of its first half equals the
    whole scan and the reference's interpreted kernel fed the same state."""
    arrs = _inputs(7 * s, 2, s, h, dk, dv)
    half = s // 2 - (s // 2) % min(chunk, s // 2)    # both parts chunkable
    first = _port([a[:, :half] for a in arrs], chunk, "naive")
    second = _port([a[:, half:] for a in arrs], chunk, "naive",
                   initial=first[1:])
    whole = _port(arrs, chunk, "naive")
    np.testing.assert_allclose(np.concatenate([first[0], second[0]], 1),
                               whole[0], atol=TOL, rtol=TOL)
    _close(second[1:], whole[1:], ("C", "n", "m"))
    want = _ref([a[:, half:] for a in arrs], chunk, "interpret",
                initial=first[1:])
    _close(second, want)


def test_mlstm_scan_bf16_inputs_keep_dtype():
    """bf16 q/k/v (the serving path's): out in bf16, the state in f32, and
    the values those of the f32 scan of the same (bf16-exact) inputs."""
    arrs = list(_inputs(3, 2, 64, 2, 16, 16))
    arrs[:3] = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                for a in arrs[:3]]
    t = [torch.from_numpy(a) for a in arrs]
    t[:3] = [x.to(torch.bfloat16) for x in t[:3]]
    out, (C, n, m) = ops.mlstm_scan(*t, chunk=32, backend="naive")
    assert out.dtype == torch.bfloat16 and C.dtype == torch.float32
    want = _ref(arrs, 32, "interpret")
    np.testing.assert_allclose(out.float().numpy(), want[0], atol=2e-2,
                               rtol=2.0 ** -7)
    _close([C.numpy(), n.numpy(), m.numpy()], want[1:], ("C", "n", "m"))


def test_mlstm_decode_step_matches_reference():
    """Steps of the single-token update from a zero state (m = 0, as the
    per-lane pool starts) against the reference's."""
    b, h, dk, dv, S = 2, 2, 8, 8, 12
    q, k, v, ig, fg = _inputs(5, b, S, h, dk, dv)
    st_t = (torch.zeros(b, h, dk, dv), torch.zeros(b, h, dk),
            torch.zeros(b, h, 1))
    st_j = tuple(jnp.asarray(x.numpy()) for x in st_t)
    for t in range(S):
        args = [a[:, t] for a in (q, k, v, ig, fg)]
        ot, st_t = ops.mlstm_decode_step(
            *(torch.from_numpy(a) for a in args), st_t)
        oj, st_j = JOPS.mlstm_decode_step(
            *(jnp.asarray(a) for a in args), st_j)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=TOL,
                                   rtol=TOL)
        _close([x.numpy() for x in st_t], [np.asarray(x) for x in st_j],
               ("C", "n", "m"))


def test_mlstm_scan_padding_and_fresh_state():
    """Trailing padded steps (i = -1e30, f = 1e4) pass the state through
    unchanged; a row of padding only from a fresh state (m = -1e30) outputs
    0 (its denominator is exp(1e30) = inf)."""
    q, k, v, ig, fg = _inputs(9, 2, 16, 1, 8, 8)
    ig[0, 10:], fg[0, 10:] = MS.NEG_INF, 1e4
    ig[1], fg[1] = MS.NEG_INF, 1e4
    got = _port((q, k, v, ig, fg), 8, "naive")
    short = _port(tuple(a[:1, :10] for a in (q, k, v, ig, fg)), 10, "naive")
    _close([g[:1] for g in got[1:]], short[1:], ("C", "n", "m"))
    assert np.all(got[0][1] == 0.0) and got[3][1, 0, 0] == MS.NEG_INF
    _close(got, _ref((q, k, v, ig, fg), 8, "interpret"))


def test_chunk_contract_both_packages_refuse_p200():
    """Reference fault F6: a scan of 200 positions at chunk 128 (min(chunk,
    s) does not divide s) is refused by the reference's scan on every path
    (an assertion), and by the port's scan itself (mlstm_scan_fwd and its
    plain version, ValueError). The port's op (ops.mlstm_scan, which the
    model calls) serves it: the tail is padded to the chunk with
    state-transparent steps, and out and the state equal the reference's
    chunked path for the same input (128 positions, then 72 from the
    carried state)."""
    arrs = _inputs(1, 1, 200, 1, 8, 8)
    for backend in ("blocked", "interpret"):
        with pytest.raises(AssertionError):
            _ref(arrs, 128, backend)
    t = [torch.from_numpy(a).movedim(2, 1).reshape((1, 200) + a.shape[3:])
         for a in arrs]
    for fn in (MS.mlstm_scan_plain, MS.mlstm_scan_fwd):
        with pytest.raises(ValueError, match="divide"):
            fn(*t, chunk=128)
    assert MS.chunk_of(128, 200 - 72) == 128 and MS.chunk_of(128, 72) == 72
    head = _ref(tuple(a[:, :128] for a in arrs), 128, "interpret")
    tail = _ref(tuple(a[:, 128:] for a in arrs), 128, "interpret",
                initial=head[1:])
    want = [np.concatenate([head[0], tail[0]], axis=1)] + tail[1:]
    for backend in ("naive", "kernel"):
        got = _port(arrs, 128, backend)
        assert got[0].shape == (1, 200, 1, 8)
        _close(got, want)
    with pytest.raises(ValueError):
        ops.mlstm_scan(*(torch.from_numpy(a) for a in arrs), chunk=128,
                       backend="pallas")
