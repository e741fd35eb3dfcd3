"""Ring/slot serving and the per-lane rings of windowed layers, the port
against the reference package on the CPU at reduced size: the ring write at
decode (inert rows dropped on the device, their ring untouched) and the
ring branch of chunk append (a chunk longer than the ring, padding rows);
the slot pool (init_slot_pool, write_cache_slot(s), the slot and batch
prefill steps: pools and logits equal); TorchExecutor's engine
token-identical to JaxExecutor's and to the port's greedy_generate on the
reference's engine architectures; the paged engine with per-lane rings on
gemma3-12b and recurrentgemma-9b token-identical to PagedJaxExecutor's and
to greedy_generate; and ring wraparound at heterogeneous positions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as JS
from repro.models import ModelSettings as JMS
from repro.models import attention as JA
from repro.models.attention import AttnSettings as JAS
from repro.runtime import serve_step as JSS
from repro.serving.executor import JaxExecutor, PagedJaxExecutor
from repro_torch import serving as TS
from repro_torch.convert import pool_from_jax, to_numpy
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import attention as TA
from repro_torch.runtime import serve_step as SS
from repro_torch.serving.executor import PagedTorchExecutor, TorchExecutor

from _torch_parity import model_pair, t_np, to_np, tree_np

JNAIVE = JMS(attn=JAS(backend="naive"))
# the reference's engine architectures (tests/test_serve.py): attention
# only, recurrent + windowed attention, local + global attention
ENGINE_ARCHS = ["h2o-danube-1.8b", "recurrentgemma-9b", "gemma3-12b"]
# bf16 activations through one attention block: a few bf16 units of values
# of order 1 (the two packages round at other places)
ATOL_BLOCK = 3e-2


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(2, vocab, (b, s)).astype(
        np.int32)


def _streams(rep):
    return [(c.rid, tuple(c.tokens), c.arrival, c.admitted, c.finished,
             c.first_token) for c in rep.completions]


def _greedy_equal(pt, ct, trace, rep, context):
    for c in rep.completions:
        req = trace[c.rid]
        ref = SS.greedy_generate(
            pt, ct, torch.tensor([req.prompt], dtype=torch.int32),
            n_steps=req.max_new, context=context)
        assert list(c.tokens) == ref[0].tolist(), c.rid


# ---------------------------------------------------------------------------
# The ring writes and the ring chunk append of one attention block
# ---------------------------------------------------------------------------

def _local_block():
    """gemma3-12b's first (window-8 local) attention block at reduced size
    on both sides."""
    cj, pj, ct, pt = model_pair("gemma3-12b")
    assert ct.unit[0].window == 8
    return (cj, jax.tree.map(lambda a: a[0], pj["units"][0]["mixer"]), ct,
            {k: v[0] for k, v in pt["units"][0]["mixer"].items()})


def _ring(ct, ends, seed, L=8):
    """Rings as numpy: lane i holds positions ..ends[i]-1 at slot pos % L
    (ends[i] = 0: empty), random bf16-exact payload everywhere."""
    rng = np.random.default_rng(seed)
    b = len(ends)
    K, hd = ct.n_kv_heads, ct.resolved_head_dim
    k = rng.standard_normal((b, L, K, hd)).astype(np.float32)
    v = rng.standard_normal((b, L, K, hd)).astype(np.float32)
    k, v = (np.asarray(torch.from_numpy(a).bfloat16().float()) for a in (k, v))
    pos = np.full((b, L), -1, np.int32)
    for i, e in enumerate(ends):
        for p in range(max(0, e - L), e):
            pos[i, p % L] = p
    return {"k": k, "v": v, "pos": pos}


def _both(ring):
    rj = {n: jnp.asarray(a, jnp.int32 if n == "pos" else jnp.bfloat16)
          for n, a in ring.items()}
    return rj, pool_from_jax(ring, "cpu")


def _x(ct, b, s, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, ct.d_model)).astype(np.float32)
    return np.asarray(torch.from_numpy(x).bfloat16().float())


@pytest.mark.parametrize("backend", ["kernel", "naive"])
def test_ring_decode_drops_inert_rows_like_the_reference(backend):
    """One decode step on rings of 8 (lane 0 wrapped, lane 1 inert with a
    full ring, lane 2 fresh): the written rings equal the reference's
    (positions exact, K/V to a bf16 rounding), the inert lane's ring is
    untouched bit for bit, and the live lanes' outputs agree."""
    cj, pj, ct, pt = _local_block()
    ring = _ring(ct, [13, 8, 0], 3)
    rj, rt = _both(ring)
    before = {n: t.clone() for n, t in rt.items()}
    x = _x(ct, 3, 1, 4)
    pos = np.asarray([[13], [-1], [0]], np.int32)
    yj, nj, _ = JA.attn_apply(pj, cj, cj.unit[0], jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(pos), cache=rj, decode=True,
                              settings=JAS(backend="naive"))
    yt, nt, _ = TA.attn_apply(pt, ct, ct.unit[0],
                              torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(pos), cache=rt, decode=True,
                              settings=TA.AttnSettings(backend=backend))
    assert nt is rt
    np.testing.assert_array_equal(rt["pos"].numpy(), to_np(nj["pos"]))
    for n in ("k", "v"):
        np.testing.assert_allclose(t_np(rt[n]), to_np(nj[n]),
                                   atol=ATOL_BLOCK, rtol=2.0 ** -6)
        assert torch.equal(rt[n][1], before[n][1])
    assert torch.equal(rt["pos"][1], before["pos"][1])
    assert rt["pos"][0, 13 % 8] == 13 and rt["pos"][2, 0] == 0
    np.testing.assert_allclose(t_np(yt)[[0, 2]], to_np(yj)[[0, 2]],
                               atol=ATOL_BLOCK, rtol=2.0 ** -6)


def test_ring_chunk_append_matches_the_reference():
    """A 12-token chunk appended to rings of 8: lane 0 fresh with a chunk
    longer than its ring (only its last 8 positions survive), lane 1 with 20
    positions of history and 5 tokens then padding, lane 2 all padding
    (its ring untouched). Outputs of the valid rows and the rings against
    the reference's ring branch."""
    cj, pj, ct, pt = _local_block()
    ring = _ring(ct, [0, 20, 6], 5)
    rj, rt = _both(ring)
    before = {n: t.clone() for n, t in rt.items()}
    C = 12
    x = _x(ct, 3, C, 6)
    pos = np.full((3, C), -1, np.int32)
    pos[0] = np.arange(C)
    pos[1, :5] = 20 + np.arange(5)
    for backend in ("kernel", "naive"):
        r = {n: t.clone() for n, t in before.items()}
        yt, nt, _ = TA.attn_apply(pt, ct, ct.unit[0],
                                  torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(pos), cache=r,
                                  settings=TA.AttnSettings(backend=backend))
        if backend == "kernel":
            rt, y_kernel = r, yt
        else:
            assert torch.equal(yt, y_kernel)
            for n in r:
                assert torch.equal(r[n], rt[n]), n
    yj, nj, _ = JA.attn_apply(pj, cj, cj.unit[0], jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(pos), cache=rj,
                              settings=JAS(backend="naive"))
    np.testing.assert_array_equal(rt["pos"].numpy(), to_np(nj["pos"]))
    assert sorted(rt["pos"][0].tolist()) == list(range(4, 12))
    for n in ("k", "v"):
        np.testing.assert_allclose(t_np(rt[n]), to_np(nj[n]),
                                   atol=ATOL_BLOCK, rtol=2.0 ** -6)
        assert torch.equal(rt[n][2], before[n][2])
    assert torch.equal(rt["pos"][2], before["pos"][2])
    got, want = t_np(y_kernel), to_np(yj)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL_BLOCK,
                               rtol=2.0 ** -6)
    np.testing.assert_allclose(got[1, :5], want[1, :5], atol=ATOL_BLOCK,
                               rtol=2.0 ** -6)


def test_ring_write_redirects_dropped_rows_to_one_value():
    """ring_write at the element level (f32, exact): kept entries land at
    pos % L, a row's dropped entries (padding, positions before its final
    window) change nothing, and a row of padding only changes nothing."""
    L, K, hd = 4, 1, 2
    cache = {"k": torch.arange(3 * L * K * hd, dtype=torch.float32).reshape(
        3, L, K, hd), "pos": torch.full((3, L), -1, dtype=torch.int32)}
    cache["v"] = -cache["k"]
    cache["pos"][1] = torch.tensor([8, 9, 6, 7], dtype=torch.int32)
    before = {n: t.clone() for n, t in cache.items()}
    pos = torch.tensor([[0, 1, 2, 3, 4, 5, -1],
                        [10, -1, -1, -1, -1, -1, -1],
                        [-1] * 7], dtype=torch.int32)
    k = 1000 + torch.arange(3 * 7 * K * hd, dtype=torch.float32).reshape(
        3, 7, K, hd)
    TA.ring_write(cache, pos, k, -k)
    assert cache["pos"][0].tolist() == [4, 5, 2, 3]
    for j, p in enumerate([4, 5, 2, 3]):
        assert torch.equal(cache["k"][0, j], k[0, p])
        assert torch.equal(cache["v"][0, j], -k[0, p])
    assert cache["pos"][1].tolist() == [8, 9, 10, 7]
    assert torch.equal(cache["k"][1, 2], k[1, 0])
    for j in (0, 1, 3):
        assert torch.equal(cache["k"][1, j], before["k"][1, j])
    for n in cache:
        assert torch.equal(cache[n][2], before[n][2]), n


# ---------------------------------------------------------------------------
# The slot pool
# ---------------------------------------------------------------------------

def _pools_close(pt, pj_np, exact_first=True):
    """Slot pools leaf by leaf: integer leaves exact; payload and states to
    a few bf16 units (later layers' inputs went through attention computed
    in another order), the first unit's payload exact where it comes from
    the embedding alone."""
    got = to_numpy(pt)
    for part in ("units", "tail"):
        for a, c in zip(got[part], pj_np[part]):
            assert sorted(a) == sorted(c)
            for n in a:
                assert a[n].shape == c[n].shape, n
                if a[n].dtype.kind == "i":
                    np.testing.assert_array_equal(a[n], c[n], n)
                else:
                    np.testing.assert_allclose(a[n], c[n], atol=3e-2,
                                               rtol=1e-2, err_msg=n)


@pytest.mark.parametrize("arch", ["gemma3-12b", "recurrentgemma-9b"])
def test_slot_pool_and_prefill_steps_match_reference(arch):
    """init_slot_pool equals the reference's (shapes, dtypes, pos -1, zero
    states); a slot prefill of a 6-token prompt into slot 1 and a batch
    prefill of two 10-token prompts into slots 2 and 0 padded to the pool
    width (a padding row with slot id 3, dropped) leave logits and pools
    equal to the reference's; slot 1 survives the batch write untouched."""
    cj, pj, ct, pt = model_pair(arch)
    context = 16
    pool_j = JSS.init_slot_pool(cj, 3, context)
    pool_t = SS.init_slot_pool(ct, 3, context, device="cpu")
    conv = pool_from_jax(tree_np(pool_j), "cpu")
    for P, Q in zip(pool_t["units"] + pool_t["tail"],
                    conv["units"] + conv["tail"]):
        assert sorted(P) == sorted(Q)
        for n in P:
            assert P[n].dtype == Q[n].dtype and torch.equal(P[n], Q[n]), n
    one = _tokens(3, 1, 6, cj.vocab_size)
    lj, pool_j = JSS.make_slot_prefill_step(cj, JNAIVE)(
        pj, jnp.asarray(one), 1, pool_j, context=context)
    lt, same = SS.make_slot_prefill_step(ct)(
        pt, torch.from_numpy(one), 1, pool_t, context=context)
    assert same is pool_t
    np.testing.assert_allclose(lt.numpy(), to_np(lj), atol=5e-2, rtol=0)
    slot1 = [{n: t[:, 1].clone() for n, t in P.items()}
             for P in pool_t["units"]]
    toks = np.concatenate([_tokens(4, 2, 10, cj.vocab_size),
                           np.full((1, 10), 2, np.int32)])
    slots = np.asarray([2, 0, 3], np.int32)
    lj, pool_j = JSS.make_batch_prefill_step(cj, JNAIVE)(
        pj, jnp.asarray(toks), jnp.asarray(slots), pool_j, context=context)
    lt, _ = SS.make_batch_prefill_step(ct)(
        pt, torch.from_numpy(toks), torch.from_numpy(slots), pool_t,
        context=context)
    np.testing.assert_allclose(lt[:2].numpy(), to_np(lj)[:2], atol=5e-2,
                               rtol=0)
    _pools_close(pool_t, tree_np(pool_j))
    for P, S1 in zip(pool_t["units"], slot1):
        for n in P:
            assert torch.equal(P[n][:, 1], S1[n]), n


def test_write_cache_slots_equal_reference_exactly():
    """Tree-level slot writes of a ring tree made by the reference's
    prefill: write_cache_slot and write_cache_slots (padding ids dropped,
    among them one equal to the pool width and one far past it) leave
    exactly the reference's pool; a batch of padding only changes
    nothing."""
    cj, pj, ct, _ = model_pair("gemma3-12b")
    _, ring_j = JSS.make_prefill_step(cj, JNAIVE)(
        pj, jnp.asarray(_tokens(5, 4, 7, cj.vocab_size)), context=12)
    ring_t = pool_from_jax(tree_np(ring_j), "cpu")
    slots = np.asarray([3, 1, 4, 9], np.int32)
    pool_j = JSS.write_cache_slots(cj, JSS.init_slot_pool(cj, 4, 12), ring_j,
                                   jnp.asarray(slots))
    pool_t = SS.write_cache_slots(ct, SS.init_slot_pool(ct, 4, 12,
                                                        device="cpu"),
                                  ring_t, torch.from_numpy(slots))
    one_j = jax.tree.map(lambda a: a[:, 2:3] if a.ndim > 1 else a, ring_j)
    one_t = {"units": [{n: t[:, 2:3] for n, t in P.items()}
                       for P in ring_t["units"]], "tail": []}
    pool_j = JSS.write_cache_slot(cj, pool_j, one_j, 0)
    SS.write_cache_slot(ct, pool_t, one_t, 0)
    got, want = to_numpy(pool_t), tree_np(pool_j)
    for a, c in zip(got["units"], want["units"]):
        for n in a:
            np.testing.assert_array_equal(a[n], c[n], n)
    before = to_numpy(pool_t)
    SS.write_cache_slots(ct, pool_t, ring_t,
                         torch.tensor([4, 5, 6, 7], dtype=torch.int32))
    for a, c in zip(to_numpy(pool_t)["units"], before["units"]):
        for n in a:
            np.testing.assert_array_equal(a[n], c[n], n)


# ---------------------------------------------------------------------------
# The slot engine
# ---------------------------------------------------------------------------

def _engine_trace(S, vocab, **kw):
    args = dict(prompt_lens=(4, 6), gen_lens=(3, 6), mean_interarrival=1.0)
    args.update(kw)
    return S.synthetic_trace(5, vocab_size=vocab, seed=2, **args)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_slot_engine_matches_reference_and_greedy_generate(arch):
    """Twin of the reference's engine pin: TorchExecutor's engine emits the
    reference JaxExecutor engine's streams (tokens, arrival, admission,
    finish, first token) and the port's own greedy_generate's tokens, with
    slots shared and reused; the ring decode of every tick takes the ring
    decode wrapper (the plain version on the CPU: no launch counted)."""
    cj, pj, ct, pt = model_pair(arch)
    trace_j = _engine_trace(JS, cj.vocab_size)
    trace_t = _engine_trace(TS, ct.vocab_size)
    context = JS.trace_context(trace_j)
    rep_j = JS.Engine(JaxExecutor(pj, cj, n_slots=2, context=context,
                                  settings=JNAIVE), 2).run(trace_j)
    ex = TorchExecutor(pt, ct, n_slots=2, context=context, device="cpu")
    rep_t = TS.Engine(ex, 2).run(trace_t)
    assert len(rep_t.completions) == len(trace_t)
    assert rep_t.max_concurrent == 2
    assert _streams(rep_t) == _streams(rep_j)
    assert ex.decode_width(1) == 2 and ex.decodes == rep_t.decode_ticks
    assert ex.compile_counts() == {"prefill": None, "decode": None}
    assert DA.launches == 0
    _greedy_equal(pt, ct, trace_t, rep_t, context)


def test_slot_engine_static_policy_same_tokens():
    """Twin of the reference's test: the scheduling policy changes when
    requests run, never what they emit."""
    _, _, ct, pt = model_pair("h2o-danube-1.8b")
    trace = TS.synthetic_trace(4, vocab_size=ct.vocab_size, seed=3,
                               prompt_lens=(4,), gen_lens=(2, 5),
                               mean_interarrival=0)
    context = TS.trace_context(trace)
    reps = []
    for policy in ("continuous", "static"):
        ex = TorchExecutor(pt, ct, n_slots=2, context=context, device="cpu")
        reps.append(TS.Engine(ex, 2, policy=policy).run(trace))
    assert ([c.tokens for c in reps[0].completions]
            == [c.tokens for c in reps[1].completions])
    assert reps[0].occupancy() >= reps[1].occupancy()


def test_ring_engine_equals_paged_engine():
    """Twin of the reference's test_paged_engine_pallas_kernel_backend: the
    slot engine (ring decode) and the paged engine (block-table decode)
    emit the same tokens on mistral-nemo-12b."""
    _, _, ct, pt = model_pair()
    trace = TS.synthetic_trace(3, vocab_size=ct.vocab_size, seed=4,
                               prompt_lens=(4, 8), gen_lens=(3, 5),
                               mean_interarrival=0)
    context = -(-TS.trace_context(trace) // 4) * 4
    ring = TS.Engine(TorchExecutor(pt, ct, n_slots=2, context=context,
                                   device="cpu"), 2).run(trace)
    paged = TS.Engine(PagedTorchExecutor(pt, ct, n_lanes=2, n_blocks=10,
                                         kv_block=4, context=context,
                                         device="cpu"), 2,
                      allocator=TS.BlockAllocator(10, 4)).run(trace)
    assert ([c.tokens for c in ring.completions]
            == [c.tokens for c in paged.completions])


def test_torch_executor_needs_cuda_by_default():
    _, _, ct, pt = model_pair()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TorchExecutor(pt, ct, n_slots=2, context=8)


# ---------------------------------------------------------------------------
# The paged engine with per-lane rings
# ---------------------------------------------------------------------------

def test_paged_pool_ring_leaves_and_lane_copies():
    """gemma3-12b's paged pool: the 5 local layers get per-lane rings of
    cache_len(context) = 8 beside the paged global layer, equal to the
    reference's init_paged_pool (shapes, dtypes, pos -1); gather copies a
    lane's rings, scatter writes them back with padding ids (>= n_lanes)
    dropped."""
    cj, _, ct, _ = model_pair("gemma3-12b")
    pj = JSS.init_paged_pool(cj, 3, 6, 4, 16)
    pt = SS.init_paged_pool(ct, 3, 6, 4, 16, device="cpu")
    conv = pool_from_jax(tree_np(pj), "cpu")
    kinds = []
    for P, Q in zip(pt["units"], conv["units"]):
        assert sorted(P) == sorted(Q)
        kinds.append("kb" in P)
        for n in P:
            assert P[n].shape == Q[n].shape and P[n].dtype == Q[n].dtype, n
            assert torch.equal(P[n], Q[n]), n
    assert kinds == [False] * 5 + [True]
    assert pt["units"][0]["k"].shape == (1, 3, 8, ct.n_kv_heads,
                                         ct.resolved_head_dim)
    for n, t in pt["units"][0].items():
        t.copy_(torch.randn(t.shape).to(t.dtype) if n != "pos"
                else torch.randint(0, 9, t.shape, dtype=t.dtype))
    before = to_numpy(pt)
    ids = torch.tensor([2, 3, 0], dtype=torch.int32)       # 3 is padding
    sub = SS.gather_pool_lanes(pt, ids)
    assert sub["units"][5] is pt["units"][5]              # paged: shared
    assert torch.equal(sub["units"][0]["k"][:, 0], pt["units"][0]["k"][:, 2])
    for n, t in sub["units"][0].items():
        t.copy_(torch.zeros_like(t) if n != "pos" else torch.full_like(t, 5))
    SS.scatter_pool_lanes(pt, sub, ids)
    after = to_numpy(pt)["units"][0]
    for n in after:
        np.testing.assert_array_equal(after[n][:, 1], before["units"][0][n][
            :, 1], n)
        assert (after[n][:, [0, 2]] == (5 if n == "pos" else 0)).all(), n


@pytest.mark.parametrize("arch", ["gemma3-12b"])
def test_paged_engine_with_rings_matches_reference_and_greedy(arch):
    """Twin of the reference's paged-engine pin on gemma3-12b (kv_block 4,
    every request spanning several blocks, whole-prompt prefill and
    full-width decode): the port's PagedTorchExecutor, whose local layers
    keep per-lane rings, emits the reference PagedJaxExecutor engine's
    streams and its own greedy_generate's tokens, with one decode shape."""
    cj, pj, ct, pt = model_pair(arch)
    trace_j = _engine_trace(JS, cj.vocab_size)
    trace_t = _engine_trace(TS, ct.vocab_size)
    context = JS.trace_context(trace_j)
    kw = dict(n_lanes=2, n_blocks=12, kv_block=4, context=context)
    ex_j = PagedJaxExecutor(pj, cj, settings=JNAIVE, **kw)
    rep_j = JS.Engine(ex_j, 2, allocator=JS.BlockAllocator(12, 4)).run(
        trace_j)
    ex_t = PagedTorchExecutor(pt, ct, device="cpu", **kw)
    rep_t = TS.Engine(ex_t, 2, allocator=TS.BlockAllocator(12, 4),
                      audit="strict").run(trace_t)
    assert rep_t.max_concurrent == 2 and 0 < rep_t.peak_blocks <= 12
    assert _streams(rep_t) == _streams(rep_j)
    assert ex_t.compile_counts()["decode"] == 1
    _greedy_equal(pt, ct, trace_t, rep_t, ex_t.context)


@pytest.mark.parametrize("arch", ["gemma3-12b", "recurrentgemma-9b"])
def test_compacted_chunked_engine_with_rings_matches_reference(arch):
    """Twin of the reference's pins for lane compaction + chunked prefill
    (gemma3-12b) and for chunked prefill over recurrent mixers
    (recurrentgemma-9b): prompts of 10 tokens go through the ring branch of
    chunk append in chunks of 4 (the window-8 rings wrap), decode ticks are
    compacted; streams and report counters equal the reference engine's,
    tokens equal the port's greedy_generate's."""
    cj, pj, ct, pt = model_pair(arch)
    trace_j = _engine_trace(JS, cj.vocab_size, prompt_lens=(4, 10))
    trace_t = _engine_trace(TS, ct.vocab_size, prompt_lens=(4, 10))
    context = JS.trace_context(trace_j)
    kw = dict(n_lanes=2, n_blocks=16, kv_block=4, context=context,
              compact=True, chunk=4)
    ex_j = PagedJaxExecutor(pj, cj, settings=JNAIVE, **kw)
    rep_j = JS.Engine(ex_j, 2, allocator=JS.BlockAllocator(16, 4),
                      chunk_prefill=4, audit="strict").run(trace_j)
    ex_t = PagedTorchExecutor(pt, ct, device="cpu", **kw)
    rep_t = TS.Engine(ex_t, 2, allocator=TS.BlockAllocator(16, 4),
                      chunk_prefill=4, audit="strict").run(trace_t)
    assert rep_t.chunk_calls > 0
    assert _streams(rep_t) == _streams(rep_j)
    dj = dataclasses.asdict(rep_j)
    dt = dataclasses.asdict(rep_t)
    for k in ("completions", "cancellations"):
        dj.pop(k), dt.pop(k)
    assert dt == dj
    assert rep_t.decode_lane_tokens < rep_t.decode_ticks * 2
    _greedy_equal(pt, ct, trace_t, rep_t, ex_t.context)


def test_ring_wraparound_heterogeneous_positions():
    """Twin of the reference's test: batched decode past cache_len with
    per-sequence positions in one slot pool matches each sequence decoded
    alone (logits within 2e-2, argmax equal): gemma3-12b's window-8 rings
    wrap several times while the global layer's does not, and each pool
    row sits at a different position."""
    _, _, ct, pt = model_pair("gemma3-12b")
    prompts = [5, 9, 12]
    n_steps = 10
    context = max(prompts) + n_steps
    prefill, decode = SS.make_prefill_step(ct), SS.make_decode_step(ct)
    singles, caches = [], []
    for p in prompts:
        toks = torch.from_numpy(_tokens(p, 1, p, ct.vocab_size))
        logits, cache = prefill(pt, toks, context=context)
        caches.append(cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        steps = []
        for t in range(n_steps):
            pos = torch.full((1,), p + t, dtype=torch.int32)
            logits, cache = decode(pt, tok[:, None], pos, cache,
                                   context=context)
            steps.append((int(tok[0]), logits[0].clone()))
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        singles.append(steps)
    pool = SS.init_slot_pool(ct, len(prompts), context, device="cpu")
    for i, p in enumerate(prompts):
        toks = torch.from_numpy(_tokens(p, 1, p, ct.vocab_size))
        _, one = prefill(pt, toks, context=context)
        SS.write_cache_slot(ct, pool, one, i)
    for t in range(n_steps):
        toks = torch.tensor([[singles[i][t][0]] for i in range(3)],
                            dtype=torch.int32)
        pos = torch.tensor([p + t for p in prompts], dtype=torch.int32)
        logits, pool = decode(pt, toks, pos, pool, context=context)
        for i in range(3):
            ref = singles[i][t][1]
            assert float((logits[i] - ref).abs().max()) < 2e-2, (i, t)
            assert int(logits[i].argmax()) == int(ref.argmax()), (i, t)
