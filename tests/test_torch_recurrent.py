"""The port's xLSTM path against the reference package's, on the CPU at
reduced size: the causal conv and the head groupnorm; the mLSTM and sLSTM
blocks in their three modes (sequence, one decode step, a serving chunk
with padded and fresh rows); xlstm-1.3b's logits, its decode against its
sequence forward, and the paged engine (chunked and whole-prompt prefill)
token-identical to the reference engine and to the port's greedy_generate;
the per-lane pool leaves (inert decode rows keep their state, the scatter
drops padding lanes, the hand-over keeps each leaf's dtype); and the
refusals the reference makes too (prefix sharing, reference fault F6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as JS
from repro.models import ModelSettings as JMS, apply as japply
from repro.models import layers as JL, recurrent as JR
from repro.models.attention import AttnSettings as JAS
from repro.runtime import serve_step as JSS
from repro.serving.executor import PagedJaxExecutor
from repro_torch import serving as TS
from repro_torch.convert import pool_from_jax
from repro_torch.kernels import mlstm_scan as MS
from repro_torch.models import ModelSettings, apply, layers as TL
from repro_torch.models import recurrent as TR
from repro_torch.runtime import serve_step as SS
from repro_torch.serving.executor import PagedTorchExecutor

from _torch_parity import model_pair, t_np, to_np, tree_np

ARCH = "xlstm-1.3b"
JNAIVE = JMS(attn=JAS(backend="naive"))
# bf16 activations through one block: the two packages round the bf16
# matrix products and elementwise steps at other places, a few bf16 units
# of values of order 1
ATOL_BLOCK = 3e-2
# f32 state leaves computed from those bf16 activations
ATOL_STATE = 1e-2


def _bf16(a):
    return np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())


def _block_pair(kind):
    """(cfg_jax, params_jax, cfg_torch, params_torch) of the first mLSTM
    (unit position 0) or the sLSTM block (position 7) of a reduced
    xlstm-1.3b, the port's converted from the reference's."""
    cj, pj, ct, pt = model_pair(ARCH)
    i = 0 if kind == "mlstm" else 7
    assert ct.unit[i].mixer == kind
    return (cj, jax.tree.map(lambda a: a[0], pj["units"][i]["mixer"]), ct,
            {k: v[0] for k, v in pt["units"][i]["mixer"].items()})


def _state(kind, cfg, b, seed):
    """A carried state of random values: as numpy, per leaf."""
    rng = np.random.default_rng(seed)
    shapes = (TR.mlstm_state_shapes if kind == "mlstm"
              else TR.slstm_state_shapes)(cfg, b)
    out = {}
    for k, (sh, dt) in shapes.items():
        a = rng.standard_normal(sh).astype(np.float32)
        if k in ("n",):
            a = np.abs(a)
        out[k] = _bf16(a) if dt == torch.bfloat16 else a
    return out


def _t_state(st):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k == "conv"
                                       else torch.float32)
            for k, v in st.items()}


def _j_state(st):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "conv" else jnp.float32)
            for k, v in st.items()}


@pytest.mark.parametrize("valid", ["0", "mid", "s"])
def test_causal_conv1d_matches_reference(valid):
    """y, and the carried history ending at the last valid input (exact:
    it is a gather of the inputs); valid_len 0 passes the state through."""
    rng = np.random.default_rng(3)
    b, s, c, w = 2, 6, 8, 4
    x, st = _bf16(rng.standard_normal((b, s, c))), _bf16(
        rng.standard_normal((b, w - 1, c)))
    wt = _bf16(rng.standard_normal((w, c)) * 0.5)
    vl = {"0": [0, 0], "mid": [3, 5], "s": [s, s]}[valid]
    yj, nj = JL.causal_conv1d(jnp.asarray(wt, jnp.bfloat16),
                              jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(st, jnp.bfloat16),
                              valid_len=jnp.asarray(vl, jnp.int32))
    yt, nt = TL.causal_conv1d(torch.from_numpy(wt).bfloat16(),
                              torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(st).bfloat16(),
                              valid_len=torch.tensor(vl))
    assert yt.dtype == nt.dtype == torch.bfloat16
    np.testing.assert_allclose(t_np(yt), to_np(yj), atol=2e-2,
                               rtol=2.0 ** -7)
    np.testing.assert_array_equal(t_np(nt), to_np(nj))
    if valid == "0":
        np.testing.assert_array_equal(t_np(nt), st)
    if valid == "s":          # the default carry
        _, nd = TL.causal_conv1d(torch.from_numpy(wt).bfloat16(),
                                 torch.from_numpy(x).bfloat16(),
                                 torch.from_numpy(st).bfloat16())
        assert torch.equal(nd, nt)


def test_groupnorm_heads_matches_reference():
    rng = np.random.default_rng(4)
    x = _bf16(rng.standard_normal((2, 5, 32)) * 3.0)
    sc = _bf16(rng.standard_normal((32,)) * 0.1)
    got = TL.groupnorm_heads(torch.from_numpy(sc).bfloat16(),
                             torch.from_numpy(x).bfloat16(), 4)
    want = JL.groupnorm_heads(jnp.asarray(sc, jnp.bfloat16),
                              jnp.asarray(x, jnp.bfloat16), 4)
    # f32 on both sides, one rounding to bf16 each
    np.testing.assert_allclose(t_np(got), to_np(want), atol=1e-2,
                               rtol=2.0 ** -7)


def _run_block(kind, mode, seed):
    cj, pj, ct, pt = _block_pair(kind)
    b = 3
    s = 1 if mode == "decode" else 8
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((b, s, ct.d_model)))
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    st = None if mode == "sequence" else _state(kind, ct, b, seed + 1)
    kw_j, kw_t = {}, {}
    if mode == "chunked":
        # row 0 a fresh prompt with 3 padded steps, row 1 mid-prompt, row
        # 2 all padding (a padding row of a chunk call)
        pos = np.full((b, s), -1, np.int32)
        pos[0, :5] = np.arange(5)
        pos[1] = 10 + np.arange(s)
        kw_j["positions"] = jnp.asarray(pos)
        kw_t["positions"] = torch.from_numpy(pos)
    if kind == "mlstm":
        kw_j.update(backend="blocked", chunk=4)
        kw_t.update(backend="naive", chunk=4)
        fj, ft = JR.mlstm_apply, TR.mlstm_apply
    else:
        fj, ft = JR.slstm_apply, TR.slstm_apply
    yj, nj = fj(pj, cj, xj, state=None if st is None else _j_state(st),
                decode=mode == "decode", **kw_j)
    t_st = None if st is None else _t_state(st)
    yt, nt = ft(pt, ct, xt, state=t_st, decode=mode == "decode", **kw_t)
    if t_st is not None:                 # functional: the input untouched
        for k, v in _t_state(st).items():
            assert torch.equal(t_st[k], v), k
    return st, yj, nj, yt, nt


@pytest.mark.parametrize("mode", ["sequence", "decode", "chunked"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_matches_reference(kind, mode):
    """The block's output and new state against the reference's, bf16
    activations; the chunk mode's padding steps leave a row's state where
    its last valid step put it, and a fresh row's previous state is
    ignored."""
    st, yj, nj, yt, nt = _run_block(kind, mode, 11)
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(t_np(yt), to_np(yj), atol=ATOL_BLOCK,
                               rtol=2.0 ** -6)
    if mode == "sequence":
        assert nt is None and nj is None
        return
    assert sorted(nt) == sorted(nj)
    for k in nt:
        assert nt[k].dtype == (torch.bfloat16 if k == "conv"
                               else torch.float32), k
        np.testing.assert_allclose(t_np(nt[k]), to_np(nj[k]),
                                   atol=ATOL_STATE, rtol=1e-2, err_msg=k)
    if mode == "chunked":
        # row 2 is padding only and not fresh: its state passes through
        for k in nt:
            np.testing.assert_allclose(t_np(nt[k])[2], st[k][2], atol=1e-6,
                                       rtol=1e-6, err_msg=k)


def _stream(fn, params, cfg, x, state):
    """x one step at a time through a block's decode form."""
    outs = []
    for t in range(x.shape[1]):
        o, state = fn(params, cfg, x[:, t:t + 1], state=state, decode=True)
        outs.append(o)
    return outs, state


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_f32_input_matches_reference(kind):
    """Twins of the reference's decode-against-sequence tests
    (tests/test_recurrent.py, mLSTM and sLSTM), which feed an f32 x over
    bf16 weights: jnp promotes, and the port promotes at the block's entry
    (fault F10). The sequence form and a one-step-at-a-time decode from
    the zero state, each against the reference's and against each other,
    at the reference test's 2e-2; outputs and the new state in f32 on both
    sides."""
    cj, pj, ct, pt = _block_pair(kind)
    s = 12 if kind == "mlstm" else 10
    x = np.random.default_rng(8).standard_normal(
        (2, s, ct.d_model)).astype(np.float32)
    fj, ft = ((JR.mlstm_apply, TR.mlstm_apply) if kind == "mlstm"
              else (JR.slstm_apply, TR.slstm_apply))
    kw_j, kw_t = (({"backend": "blocked", "chunk": 4},
                   {"backend": "naive", "chunk": 4}) if kind == "mlstm"
                  else ({}, {}))
    yj, _ = fj(pj, cj, jnp.asarray(x), **kw_j)
    yt, _ = ft(pt, ct, torch.from_numpy(x), **kw_t)
    assert yt.dtype == torch.float32 and yj.dtype == jnp.float32
    np.testing.assert_allclose(t_np(yt), to_np(yj), atol=2e-2, rtol=2e-2)
    init_j = JR.mlstm_state_init if kind == "mlstm" else JR.slstm_state_init
    init_t = TR.mlstm_state_init if kind == "mlstm" else TR.slstm_state_init
    dj, sj = _stream(fj, pj, cj, jnp.asarray(x), init_j(cj, 2))
    dt, st = _stream(ft, pt, ct, torch.from_numpy(x), init_t(ct, 2, "cpu"))
    dec_t = torch.cat(dt, 1)
    np.testing.assert_allclose(t_np(dec_t), to_np(jnp.concatenate(dj, 1)),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(t_np(dec_t), t_np(yt), atol=2e-2, rtol=2e-2)
    assert sorted(st) == sorted(sj)
    for k in st:
        assert st[k].dtype == torch.float32, k
        np.testing.assert_allclose(t_np(st[k]), to_np(sj[k]), atol=2e-2,
                                   rtol=2e-2, err_msg=k)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(2, vocab, (b, s)).astype(
        np.int32)


def test_xlstm_logits_match_reference():
    """The cache-free sequence forward (7 mLSTM + 1 sLSTM blocks): logits
    within the bf16 model's tolerance, and the plain scan ("naive") equal
    to the kernel entry point (which takes the plain version on the CPU)."""
    cj, pj, ct, pt = model_pair(ARCH)
    toks = _tokens(2, 2, 12, ct.vocab_size)
    lj, _, _ = japply(pj, cj, jnp.asarray(toks), settings=JNAIVE)
    lt, cache, _ = apply(pt, ct, torch.from_numpy(toks))
    assert cache is None
    np.testing.assert_allclose(lt.numpy(), to_np(lj), atol=5e-2, rtol=0)
    ln, _, _ = apply(pt, ct, torch.from_numpy(toks),
                     settings=ModelSettings(mlstm_backend="naive"))
    assert torch.equal(ln, lt) and MS.launches == 0


def test_xlstm_decode_matches_full_forward():
    """Prefill 16 tokens into the recurrent states, decode 8 more: each
    step's logits equal the full forward's at that position (the reference
    test's bf16 tolerance, 0.06)."""
    _, _, ct, pt = model_pair(ARCH)
    S, S0, b = 24, 16, 2
    tokens = torch.from_numpy(_tokens(1, b, S, ct.vocab_size))
    full, _, _ = apply(pt, ct, tokens)
    prefill, decode = SS.make_prefill_step(ct), SS.make_decode_step(ct)
    _, cache = prefill(pt, tokens[:, :S0], context=S)
    assert cache["units"][0]["C"].shape == (1, b, 4, 32, 32)
    errs = []
    for t in range(S0, S):
        pos = torch.full((b,), t, dtype=torch.int32)
        lg, cache = decode(pt, tokens[:, t:t + 1], pos, cache, context=S)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 0.06, errs


def test_inert_decode_rows_keep_their_state():
    """A full-width decode tick whose row 1 is inert (position -1): that
    row's state is unchanged bit for bit in every layer, row 0's moves."""
    _, _, ct, pt = model_pair(ARCH)
    pool = SS.init_paged_pool(ct, 2, 4, 4, 16, device="cpu")
    toks = torch.from_numpy(_tokens(3, 2, 6, ct.vocab_size))
    tables = torch.full((2, 4), -1, dtype=torch.int32)
    SS.make_paged_prefill_step(ct)(pt, toks, torch.tensor([0, 1]), tables,
                                   pool, context=16)
    before = [{k: v.clone() for k, v in P.items()} for P in pool["units"]]
    SS.make_paged_decode_step(ct)(pt, toks[:, :1], torch.tensor([6, -1]),
                                  tables, pool, context=16)
    for P, B in zip(pool["units"], before):
        for k in P:
            assert torch.equal(P[k][:, 1], B[k][:, 1]), k
        assert not torch.equal(P["c" if "c" in P else "C"][:, 0],
                               B["c" if "c" in B else "C"][:, 0])


def test_pool_leaves_and_lane_scatter():
    """init_paged_pool's per-lane leaves equal the reference's (shapes,
    dtypes, zeros; nothing paged); the hand-over keeps each leaf's dtype;
    gather copies lanes (padding ids clamp), scatter writes real lanes
    back and drops padding ids (>= n_lanes), which index_copy_ would
    otherwise reject or wrap."""
    cj, _, ct, _ = model_pair(ARCH)
    pj = JSS.init_paged_pool(cj, 3, 5, 4, 16)
    pt = SS.init_paged_pool(ct, 3, 5, 4, 16, device="cpu")
    assert SS.pool_block_size(pt, default=7) == 7
    conv = pool_from_jax(tree_np(pj), "cpu")
    for P, Q, J in zip(pt["units"], conv["units"], pj["units"]):
        assert sorted(P) == sorted(J)
        for k, a in J.items():
            assert str(P[k].dtype).replace("torch.", "") == str(a.dtype), k
            assert Q[k].dtype == P[k].dtype and tuple(P[k].shape) == a.shape
            np.testing.assert_array_equal(t_np(P[k]), to_np(a))
    leaf = pt["units"][0]["C"]
    leaf.copy_(torch.arange(3.0).reshape(1, 3, 1, 1, 1).expand_as(leaf))
    ids = torch.tensor([2, 3, 0], dtype=torch.int32)      # 3: padding
    sub = SS.gather_pool_lanes(pt, ids)
    got = sub["units"][0]["C"]
    assert got.data_ptr() != leaf.data_ptr()              # a copy
    assert got[0, :, 0, 0, 0].tolist() == [2.0, 2.0, 0.0]
    got += 10.0
    out = SS.scatter_pool_lanes(pt, sub, ids)
    assert out is pt
    assert leaf[0, :, 0, 0, 0].tolist() == [10.0, 1.0, 12.0]


def test_prefix_share_refused_for_recurrent_models():
    """Shared prefix blocks hold attention K/V only, not the recurrent state
    at the prefix boundary: both engines refuse prefix sharing."""
    cj, pj, ct, pt = model_pair(ARCH)
    kw = dict(n_lanes=2, n_blocks=8, kv_block=4, context=16, chunk=4)
    ex_t = PagedTorchExecutor(pt, ct, device="cpu", **kw)
    ex_j = PagedJaxExecutor(pj, cj, **kw)
    assert ex_t.has_recurrent and ex_j.has_recurrent
    with pytest.raises(ValueError, match="attention-only"):
        TS.Engine(ex_t, 2, allocator=TS.BlockAllocator(8, 4),
                  chunk_prefill=4, prefix_share=True)
    with pytest.raises(ValueError, match="attention-only"):
        JS.Engine(ex_j, 2, allocator=JS.BlockAllocator(8, 4),
                  chunk_prefill=4, prefix_share=True)


def test_params_keep_reference_dtypes():
    """The mLSTM gate projections and biases and the sLSTM recurrence and
    bias stay f32 after the hand-over (cast to bf16 they would change the
    gates); projections take the config's bf16. A tree that does not fit
    the config is refused."""
    from repro_torch.convert import params_from_jax
    cj, pj, ct, pt = model_pair(ARCH)
    m, s = pt["units"][0]["mixer"], pt["units"][7]["mixer"]
    for k in ("w_i", "b_i", "w_f", "b_f"):
        assert m[k].dtype == torch.float32, k
    assert s["r"].dtype == s["b"].dtype == torch.float32
    assert m["w_up"].dtype == m["wq"].dtype == s["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(m["w_i"].numpy(),
                                  np.asarray(pj["units"][0]["mixer"]["w_i"]))
    _, _, c2, _ = model_pair("mistral-nemo-12b")
    with pytest.raises(ValueError):
        params_from_jax(tree_np(pj), c2, device="cpu")


def test_whole_prompt_of_200_refused_by_both_packages():
    """Reference fault F6: a whole-prompt prefill of 200 tokens at
    mlstm_chunk 128 (128 < p <= the engine's chunk, p % 128 != 0) is
    refused by the reference (an assertion in the blocked scan). The port
    serves it (the scan's tail padded with state-transparent steps): its
    last-token logits and every layer's state equal the reference's
    chunked path for the same prompt (128 tokens, then 72 from the carried
    state), within the bf16 model's tolerance."""
    cj, pj, ct, pt = model_pair(ARCH)
    toks = _tokens(5, 1, 200, ct.vocab_size)
    with pytest.raises(AssertionError):
        JSS.make_prefill_step(cj, JNAIVE)(pj, jnp.asarray(toks), context=256)
    lt, cache = SS.make_prefill_step(ct)(pt, torch.from_numpy(toks),
                                         context=256)
    ps = dataclasses.replace(JNAIVE, build_cache=True)
    _, c1, _ = japply(pj, cj, jnp.asarray(toks[:, :128]), settings=ps,
                      context=256)
    pos = jnp.asarray(np.arange(128, 200, dtype=np.int32)[None])
    lj, cj2, _ = japply(pj, cj, jnp.asarray(toks[:, 128:]), positions=pos,
                        cache=c1, settings=ps, context=256)
    np.testing.assert_allclose(t_np(lt), to_np(lj[:, -1]), atol=5e-2,
                               rtol=0)
    for i, (leaf_t, leaf_j) in enumerate(zip(cache["units"],
                                             cj2["units"])):
        assert sorted(leaf_t) == sorted(leaf_j)
        for k in leaf_t:
            np.testing.assert_allclose(t_np(leaf_t[k]), to_np(leaf_j[k]),
                                       atol=ATOL_BLOCK, rtol=2e-2,
                                       err_msg=f"unit {i} {k}")


# ---------------------------------------------------------------------------
# The engine (the twin of the reference's
# tests/test_serve.py::test_recurrent_chunked_engine_matches_greedy_generate)
# ---------------------------------------------------------------------------

def _trace(S, vocab):
    return S.synthetic_trace(4, vocab_size=vocab, seed=2, prompt_lens=(5, 10),
                             gen_lens=(3, 6), mean_interarrival=1.0)


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_chunked_engine_equals_reference_and_greedy(compact):
    """2 lanes, chunk = kv_block = 4: prompts of 5 and 10 tokens all ride
    the chunked path, lanes are reused, so mid-prompt state and the
    fresh-lane reset are exercised. The port's streams equal the reference
    engine's and the port's own greedy_generate's."""
    cj, pj, ct, pt = model_pair(ARCH)
    trace_j, trace_t = _trace(JS, cj.vocab_size), _trace(TS, ct.vocab_size)
    context = JS.trace_context(trace_j)
    kv_block, n_blocks = 4, 16
    ex_j = PagedJaxExecutor(pj, cj, n_lanes=2, n_blocks=n_blocks,
                            kv_block=kv_block, context=context,
                            settings=JNAIVE, chunk=kv_block)
    rep_j = JS.Engine(ex_j, 2, allocator=JS.BlockAllocator(n_blocks,
                                                           kv_block),
                      chunk_prefill=kv_block).run(trace_j)
    ex_t = PagedTorchExecutor(pt, ct, n_lanes=2, n_blocks=n_blocks,
                              kv_block=kv_block, context=context,
                              chunk=kv_block, compact=compact, device="cpu")
    rep_t = TS.Engine(ex_t, 2, allocator=TS.BlockAllocator(n_blocks,
                                                           kv_block),
                      chunk_prefill=kv_block, audit="strict").run(trace_t)
    assert len(rep_t.completions) == len(trace_t)
    assert rep_t.chunk_calls > 0 and rep_t.audit_failures == 0
    assert [(c.rid, list(c.tokens)) for c in rep_t.completions] \
        == [(c.rid, list(c.tokens)) for c in rep_j.completions]
    for c in rep_t.completions:
        req = trace_t[c.rid]
        ref = SS.greedy_generate(pt, ct,
                                 torch.tensor([req.prompt], dtype=torch.int32),
                                 n_steps=req.max_new, context=ex_t.context)
        assert list(c.tokens) == ref[0].tolist(), c.rid


def test_whole_prompt_engine_equals_greedy():
    """Prompts up to the engine's chunk (8) take whole-prompt prefill from a
    zero state into their lanes' rows, the 11-token one the chunked path;
    compacted decode gathers and scatters the lanes' state. Every stream
    equals the port's greedy_generate's and the reference engine's. The
    two packages' logits differ by about 3e-4 here, so the trace seed is
    one whose greedy steps all have top-2 gaps above 4e-3 (seed 6 has a
    gap of 6e-5, where the two go different ways: trap T2)."""
    cj, pj, ct, pt = model_pair(ARCH)

    def trace(S, vocab):
        return S.synthetic_trace(5, vocab_size=vocab, seed=11,
                                 prompt_lens=(3, 8, 11), gen_lens=(3, 5),
                                 mean_interarrival=1.0)
    trace_j, trace_t = trace(JS, cj.vocab_size), trace(TS, ct.vocab_size)
    context = -(-JS.trace_context(trace_j) // 4) * 4
    kw = dict(n_lanes=3, n_blocks=24, kv_block=4, context=context,
              compact=True, chunk=8)
    ex_j = PagedJaxExecutor(pj, cj, settings=JNAIVE, **kw)
    rep_j = JS.Engine(ex_j, 3, allocator=JS.BlockAllocator(24, 4),
                      chunk_prefill=8).run(trace_j)
    ex_t = PagedTorchExecutor(pt, ct, device="cpu", **kw)
    rep_t = TS.Engine(ex_t, 3, allocator=TS.BlockAllocator(24, 4),
                      chunk_prefill=8, audit="strict").run(trace_t)
    assert rep_t.prefill_calls > 0 and ex_t.chunk_calls > 0
    assert [(c.rid, list(c.tokens)) for c in rep_t.completions] \
        == [(c.rid, list(c.tokens)) for c in rep_j.completions]
    for c in rep_t.completions:
        req = trace_t[c.rid]
        ref = SS.greedy_generate(pt, ct,
                                 torch.tensor([req.prompt], dtype=torch.int32),
                                 n_steps=req.max_new, context=ex_t.context)
        assert list(c.tokens) == ref[0].tolist(), c.rid
