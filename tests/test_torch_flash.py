"""The port's flash attention (kernels/flash_attention.py) against the
reference package's: the plain PyTorch version against the reference's
kernel in interpret mode (`ops.flash_attention(backend="interpret")`) and
against its oracle `ref.flash_attention_ref` over the reference kernel
tests' sweep, f32 and bf16; lse against `flash_attention_fwd(return_lse=
True)`; lengths that are no multiple of a tile, positions that are not the
indices, rows padded with position -1; the wrapper's CPU rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro_torch.kernels import build, flash_attention as FA, ops as tops

from _torch_parity import JDT, TDT, t_np, to_np

# (s, K, G, hd, window, chunk, q_block, kv_block): the reference's sweep
# (tests/test_kernels.py), the tiles being the reference kernel's
SWEEP = [
    (128, 2, 2, 32, None, None, 64, 64),
    (128, 1, 4, 16, 48, None, 32, 32),
    (256, 2, 1, 64, None, 64, 64, 64),
    (64, 4, 1, 8, 16, None, 64, 64),     # single q block
]
# the reference sweep's own tolerances: f32 sums in another order; in bf16
# the two f32 results may round to neighbouring bf16 values
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, b, sq, sk, K, G, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, K, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, K, hd)).astype(np.float32)
    return q, k, v


def _both(arrs, dtype):
    jx = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    th = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return jx, th


def _pos(b, s, start=0):
    return np.broadcast_to(start + np.arange(s, dtype=np.int32)[None],
                           (b, s)).copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,K,G,hd,window,chunk,qb,kb", SWEEP)
def test_flash_plain_matches_reference_sweep(dtype, s, K, G, hd, window,
                                             chunk, qb, kb):
    b = 2
    (qj, kj, vj), (qt, kt, vt) = _both(_inputs(3, b, s, s, K, G, hd), dtype)
    pos = _pos(b, s)
    got = tops.flash_attention(qt, kt, vt, torch.from_numpy(pos),
                               torch.from_numpy(pos), window=window,
                               chunk=chunk)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (b, s, K, G, hd)
    kern = jops.flash_attention(qj, kj, vj, jnp.asarray(pos),
                                jnp.asarray(pos), window=window, chunk=chunk,
                                backend="interpret", q_block=qb, kv_block=kb)
    oracle = jref.flash_attention_ref(qj, kj, vj, jnp.asarray(pos),
                                      jnp.asarray(pos), window=window,
                                      chunk=chunk)
    for want in (kern, oracle):
        np.testing.assert_allclose(t_np(got), to_np(want), atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("window,chunk", [(None, None), (24, None),
                                          (None, 32)])
def test_flash_lse_matches_reference_kernel(window, chunk):
    """out and lse of the port's flash_attention_fwd (plain on the CPU)
    against the reference kernel's with return_lse, f32; lse to 1e-4 as
    the reference's own lse test."""
    b, s, K, G, hd = 2, 64, 1, 2, 16
    (qj, kj, vj), (qt, kt, vt) = _both(_inputs(5, b, s, s, K, G, hd),
                                       "float32")
    pos = _pos(b, s)
    out_j, lse_j = jax_fwd(qj.reshape(b, s, K * G, hd), kj, vj,
                           jnp.asarray(pos), jnp.asarray(pos), window=window,
                           chunk=chunk, q_block=32, kv_block=32,
                           interpret=True, return_lse=True)
    out_t, lse_t = FA.flash_attention_fwd(
        qt.reshape(b, s, K * G, hd), kt, vt, torch.from_numpy(pos),
        torch.from_numpy(pos), window=window, chunk=chunk, return_lse=True)
    assert lse_t.dtype == torch.float32 and tuple(lse_t.shape) == (b, s,
                                                                   K * G)
    np.testing.assert_allclose(t_np(out_t), to_np(out_j), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(t_np(lse_t), to_np(lse_j), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_odd_lengths_offsets_and_padding(dtype):
    """s = 37 (no tile divides it), queries at positions 100.. over keys at
    90.. (positions are not indices), row 1 shorter (padding -1 at the end
    of both), a window: equal to the oracle on every row that sees a key;
    a row that sees nothing gives 0 and lse -1e30."""
    b, sq, sk, K, G, hd = 2, 37, 45, 2, 3, 16
    (qj, kj, vj), (qt, kt, vt) = _both(_inputs(7, b, sq, sk, K, G, hd),
                                       dtype)
    qpos, kpos = _pos(b, sq, 100), _pos(b, sk, 90)
    qpos[1, 30:] = -1
    kpos[1, 20:] = -1
    kpos[0, 3] = -1                              # a hole in the keys
    for window in (None, 9):
        got, lse = FA.flash_attention_fwd(
            qt.reshape(b, sq, K * G, hd), kt, vt, torch.from_numpy(qpos),
            torch.from_numpy(kpos), window=window, return_lse=True)
        want = jref.flash_attention_ref(qj, kj, vj, jnp.asarray(qpos),
                                        jnp.asarray(kpos), window=window)
        q_, k_ = qpos[:, :, None], kpos[:, None, :]
        vis = (k_ <= q_) & (k_ >= 0) & (q_ >= 0)
        if window is not None:
            vis &= k_ > q_ - window
        sees = vis.any(-1)
        assert sees.sum() > 40 and (~sees).sum() >= 7
        got5 = t_np(got).reshape(b, sq, K, G, hd)
        np.testing.assert_allclose(got5[sees], to_np(want)[sees],
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert not np.abs(got5[~sees]).any()
        assert (t_np(lse)[~sees] <= -1e29).all()
        assert np.isfinite(t_np(lse)).all()


def test_flash_wrapper_takes_the_plain_version_only_on_the_cpu():
    assert FA.SOURCE in build.SOURCES
    b, s, K, G, hd = 1, 8, 2, 2, 8
    _, (qt, kt, vt) = _both(_inputs(9, b, s, s, K, G, hd), "float32")
    pos = torch.from_numpy(_pos(b, s))
    before = FA.launches
    out = FA.flash_attention_fwd(qt.reshape(b, s, K * G, hd), kt, vt, pos,
                                 pos)
    plain = FA.flash_attention_plain(qt.reshape(b, s, K * G, hd), kt, vt,
                                     pos, pos)
    assert torch.equal(out, plain) and FA.launches == before
    # the model's sequence path on the kernel backend reaches it too
    from repro_torch.configs.base import BlockSpec
    from repro_torch.models import attention as A
    seq = A._seq_attention(qt, kt, vt, pos, pos, BlockSpec(),
                           A.AttnSettings(backend="kernel"))
    assert torch.equal(seq, out.reshape(b, s, K, G, hd))


def test_tensor_core_bodies_take_head_dims_in_16_byte_rows():
    """bf16 launches run the tensor-core bodies, which copy rows in 16-byte
    pieces: a bf16 head_dim that is no multiple of 8 (or above 256) is
    refused before any launch; f32 takes any head_dim; the shared-memory
    header is part of the build's digest."""
    from repro_torch.kernels import flash_attention_bwd as FB
    assert "mma_tile.cuh" in build.HEADERS
    for hd in (8, 80, 128, 256):
        FA.check_head_dim(torch.bfloat16, hd)
    for hd in (4, 84, 264):
        with pytest.raises(ValueError, match="multiple of 8"):
            FA.check_head_dim(torch.bfloat16, hd)
        FA.check_head_dim(torch.float32, hd)
    assert FB.check_head_dim is FA.check_head_dim
    assert set(FA.BODIES.values()) == {"tensor-core bf16", "cuda-core f32"}
