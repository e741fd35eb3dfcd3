"""The ring decode kernel's plain version against the reference package's
decode_attention_fwd (its Pallas kernel in interpret mode) and its oracle
ref.decode_attention_ref, on the CPU: f32 within 2e-5, bf16 within one
bf16 unit; no mask, window, chunk; G = 1, 2, 16 with head_dim 256 among
them; rings wrapped at heterogeneous positions (slot = pos % L, so slot 0
may hold a lane's newest position); inert lanes and empty rings give exact
zeros (the interpreted kernel's), where the oracle gives the mean of the
ring. The wrapper on a CPU tensor takes the plain version and counts no
launch, and the model's ring decode under backend "kernel" equals the
dense softmax on every live lane."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.decode_attention import decode_attention_fwd as jfwd
from repro_torch.configs.base import BlockSpec
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as TA

from _torch_parity import JDT, TDT, t_np, to_np

# f32: two f32 summation orders over up to 64 positions; bf16: each side
# rounds its f32 result to bf16 once, so one bf16 unit (2^-7 of the value)
# where the two straddle a rounding boundary
ATOL_F32 = 2e-5
RTOL_BF16 = 2.0 ** -7
ATOL_BF16 = 1e-3


def ring_case(seed, *, b, L, K, G, hd, ends, dtype="float32",
              empty=(), inert=()):
    """Per-lane rings as numpy: lane i holds positions max(0, ends[i] - L +
    1)..ends[i] at slot pos % L (ends[i] >= L wraps the ring: its slot 0
    is not its oldest position) and is queried at position ends[i]; lanes
    in `empty` hold nothing, lanes in `inert` are queried at -1. Empty
    slots hold random payload at position -1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((b, L, K, hd)).astype(np.float32)
    v = rng.standard_normal((b, L, K, hd)).astype(np.float32)
    cpos = np.full((b, L), -1, np.int32)
    for i, e in enumerate(ends):
        if i in empty:
            continue
        for p in range(max(0, e - L + 1), e + 1):
            cpos[i, p % L] = p
    positions = np.asarray(ends, np.int32)
    for i in inert:
        positions[i] = -1
    if dtype == "bfloat16":
        q, k, v = (np.asarray(torch.from_numpy(a).bfloat16().float())
                   for a in (q, k, v))
    return q, k, v, cpos, positions


CASES = {
    # name: (b, L, K, G, hd, ends, window, chunk, empty, inert)
    "plain G2 hd256": (3, 16, 2, 2, 256, [40, 7, 15], None, None, (), ()),
    "window G1": (3, 32, 2, 1, 32, [70, 9, 31], 12, None, (), ()),
    "chunk G16": (2, 24, 1, 16, 64, [50, 23], None, 8, (), ()),
    "window G16 hd256 mqa": (2, 16, 1, 16, 256, [33, 16], 8, None, (), ()),
    "inert and empty G2": (4, 16, 2, 2, 32, [21, 5, 3, 16], None, None,
                           (2,), (1,)),
}


def _jax(q, k, v, cpos, positions, dtype, window, chunk):
    jd = JDT[dtype]
    args = (jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
            jnp.asarray(cpos), jnp.asarray(positions))
    L = k.shape[1]
    kern = jfwd(*args, window=window, chunk=chunk, kv_block=L,
                interpret=True)
    oracle = kref.decode_attention_ref(*args, window=window, chunk=chunk)
    return to_np(kern), to_np(oracle)


def _check(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL_BF16,
                                   rtol=RTOL_BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_reference_kernel_and_oracle(name, dtype):
    b, L, K, G, hd, ends, window, chunk, empty, inert = CASES[name]
    q, k, v, cpos, positions = ring_case(7, b=b, L=L, K=K, G=G, hd=hd,
                                         ends=ends, dtype=dtype, empty=empty,
                                         inert=inert)
    td = TDT[dtype]
    got = DA.decode_attention_plain(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.from_numpy(cpos),
        torch.from_numpy(positions), window=window, chunk=chunk)
    assert got.dtype == td and tuple(got.shape) == q.shape
    got = t_np(got)
    kern, oracle = _jax(q, k, v, cpos, positions, dtype, window, chunk)
    _check(got, kern, dtype)
    dead = set(empty) | set(inert)
    live = [i for i in range(b) if i not in dead]
    _check(got[live], oracle[live], dtype)
    for i in dead:
        # exact zeros, as the reference kernel gives (its oracle gives the
        # mean of the ring's values instead)
        assert (got[i] == 0).all() and (kern[i] == 0).all(), i
        assert np.abs(oracle[i]).max() > 0, i


def test_wrapped_ring_equals_unwrapped_history():
    """A ring that has wrapped (slot 0 holds the newest position) gives what
    the same window of history gives laid out in position order."""
    b, L, K, G, hd = 1, 8, 2, 2, 16
    q, k, v, cpos, positions = ring_case(3, b=b, L=L, K=K, G=G, hd=hd,
                                         ends=[16])
    assert cpos[0, 0] == 16 and cpos[0, 1] == 9       # wrapped
    order = np.argsort(cpos[0])
    args = [torch.from_numpy(a) for a in (q, k, v, cpos, positions)]
    got = DA.decode_attention_plain(*args, window=8)
    flat = DA.decode_attention_plain(
        args[0], args[1][:, order], args[2][:, order], args[3][:, order],
        args[4], window=8)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), atol=1e-6)


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    q, k, v, cpos, positions = ring_case(4, b=2, L=12, K=2, G=2, hd=16,
                                         ends=[20, 3])
    args = [torch.from_numpy(a) for a in (q, k, v, cpos, positions)]
    before = DA.launches
    got = kops.decode_attention(*args, window=6)
    fwd = DA.decode_attention_fwd(*args, window=6, kv_block=4)
    want = DA.decode_attention_plain(*args, window=6)
    assert torch.equal(got, want) and torch.equal(fwd, want)
    assert DA.launches == before == 0


def test_model_ring_decode_kernel_backend_equals_dense_softmax():
    """attention._decode_attend under backend "kernel" (the wrapper, which
    on the CPU takes the plain version) against the dense softmax of
    backend "naive", on every live lane; an inert lane gives zeros through
    the kernel path."""
    q, k, v, cpos, positions = ring_case(5, b=3, L=16, K=2, G=4, hd=32,
                                         ends=[30, 6, 11], inert=(2,))
    cache = {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
             "pos": torch.from_numpy(cpos)}
    qt = torch.from_numpy(q)[:, None]
    blk = BlockSpec(window=10)
    pos = torch.from_numpy(positions)
    o_k = TA._decode_attend(qt, cache, blk, pos,
                            settings=TA.AttnSettings(backend="kernel"))
    o_n = TA._decode_attend(qt, cache, blk, pos,
                            settings=TA.AttnSettings(backend="naive"))
    np.testing.assert_allclose(o_k[:2].numpy(), o_n[:2].numpy(),
                               atol=ATOL_F32)
    assert (o_k[2] == 0).all()
    with pytest.raises(ValueError, match="probabilities"):
        TA._decode_attend(qt, cache, blk, pos, return_probs=True,
                          settings=TA.AttnSettings(backend="kernel"))
