"""The port's RG-LRU (Griffin's recurrent block, recurrentgemma-9b) against
the reference package's, on the CPU at reduced size: the log-step scan
against the sequential oracle ref.rglru_ref; the block in its three modes
(sequence, one decode step, a serving chunk with padded and fresh rows);
the twins of the reference's own RG-LRU tests (associative scan against the
sequential recurrence, decode streaming against the sequence, stability
over a long sequence); the leaves' dtypes through the hand-over; and
recurrentgemma-9b's logits and its decode against its sequence forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as kref
from repro.models import ModelSettings as JMS, apply as japply
from repro.models import recurrent as JR
from repro.models.attention import AttnSettings as JAS
from repro_torch.models import apply
from repro_torch.models import recurrent as TR
from repro_torch.runtime import serve_step as SS

from _torch_parity import model_pair, t_np, to_np

ARCH = "recurrentgemma-9b"
JNAIVE = JMS(attn=JAS(backend="naive"))
# bf16 activations through one block: the two packages round the bf16
# matrix products and elementwise steps at other places, a few bf16 units
# of values of order 1
ATOL_BLOCK = 3e-2
# the f32 state h, computed from those bf16 activations
ATOL_STATE = 1e-2


def _bf16(a):
    return np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())


def _block_pair():
    """The first RG-LRU block (unit position 0) of a reduced
    recurrentgemma-9b on both sides, the port's converted from the
    reference's."""
    cj, pj, ct, pt = model_pair(ARCH)
    assert ct.unit[0].mixer == "rglru"
    return (cj, jax.tree.map(lambda a: a[0], pj["units"][0]["mixer"]), ct,
            {k: v[0] for k, v in pt["units"][0]["mixer"].items()})


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, (sh, dt) in TR.rglru_state_shapes(cfg, b).items():
        a = rng.standard_normal(sh).astype(np.float32)
        out[k] = _bf16(a) if dt == torch.bfloat16 else a
    return out


def _scan_inputs(seed, b=2, s=64, w=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, w), (b, s, w), (b, s, w), (w,))]


@pytest.mark.parametrize("s", [1, 5, 64, 100])
def test_linear_scan_matches_the_sequential_oracle(s):
    """The port's gates and log-step scan against ref.rglru_ref (a
    sequential lax.scan), f32, lengths that are and are not powers of two
    (1e-5, the reference test's tolerance)."""
    x, rg, ig, a_param = _scan_inputs(1, s=s)
    want, h_last = kref.rglru_ref(*(jnp.asarray(a) for a in
                                    (x, rg, ig, a_param)))
    xt, rt, it, at = (torch.from_numpy(a) for a in (x, rg, ig, a_param))
    log_a = -8.0 * F.softplus(at) * torch.sigmoid(rt)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    got = TR.linear_scan(a, beta * torch.sigmoid(it) * xt)
    np.testing.assert_allclose(got.numpy(), to_np(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got[:, -1].numpy(), to_np(h_last),
                               atol=1e-5, rtol=1e-5)


def test_rglru_associative_scan_matches_sequential():
    """Twin of the reference's test: the associative-scan formulation
    against the sequential recurrence, here the port's log-step scan
    against a Python loop over steps."""
    x, rg, ig, a_param = (torch.from_numpy(a) for a in _scan_inputs(2))
    log_a = -8.0 * F.softplus(a_param) * torch.sigmoid(rg)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = beta * torch.sigmoid(ig) * x
    hs = TR.linear_scan(a, gated)
    h = torch.zeros_like(x[:, 0])
    for t in range(x.shape[1]):
        h = a[:, t] * h + gated[:, t]
        np.testing.assert_allclose(hs[:, t].numpy(), h.numpy(), atol=1e-5,
                                   rtol=1e-5)


def _run_block(mode, seed):
    cj, pj, ct, pt = _block_pair()
    b = 3
    s = 1 if mode == "decode" else 8
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((b, s, ct.d_model)))
    st = None if mode == "sequence" else _state(ct, b, seed + 1)
    kw_j, kw_t = {}, {}
    if mode == "chunked":
        # row 0 a fresh prompt with 3 padded steps, row 1 mid-prompt, row
        # 2 all padding (a padding row of a chunk call)
        pos = np.full((b, s), -1, np.int32)
        pos[0, :5] = np.arange(5)
        pos[1] = 10 + np.arange(s)
        kw_j["positions"] = jnp.asarray(pos)
        kw_t["positions"] = torch.from_numpy(pos)
    sj = None if st is None else {
        k: jnp.asarray(v, jnp.bfloat16 if k == "conv" else jnp.float32)
        for k, v in st.items()}
    st_t = None if st is None else {
        k: torch.from_numpy(v).to(torch.bfloat16 if k == "conv"
                                  else torch.float32)
        for k, v in st.items()}
    yj, nj = JR.rglru_apply(pj, cj, jnp.asarray(x, jnp.bfloat16), state=sj,
                            decode=mode == "decode", **kw_j)
    yt, nt = TR.rglru_apply(pt, ct, torch.from_numpy(x).bfloat16(),
                            state=st_t, decode=mode == "decode", **kw_t)
    return st, yj, nj, yt, nt


@pytest.mark.parametrize("mode", ["sequence", "decode", "chunked"])
def test_block_matches_reference(mode):
    """The block's output and new state (h f32, conv tail bf16) against the
    reference's; a chunk's padding steps are identity steps (row 2, all
    padding and not fresh, passes its state through) and a fresh row's
    previous state is ignored."""
    st, yj, nj, yt, nt = _run_block(mode, 21)
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(t_np(yt), to_np(yj), atol=ATOL_BLOCK,
                               rtol=2.0 ** -6)
    if mode == "sequence":
        assert nt is None and nj is None
        return
    assert sorted(nt) == sorted(nj) == ["conv", "h"]
    assert nt["h"].dtype == torch.float32
    assert nt["conv"].dtype == torch.bfloat16
    for k in nt:
        np.testing.assert_allclose(t_np(nt[k]), to_np(nj[k]),
                                   atol=ATOL_STATE, rtol=1e-2, err_msg=k)
    if mode == "chunked":
        for k in nt:
            np.testing.assert_allclose(t_np(nt[k])[2], st[k][2], atol=1e-6,
                                       rtol=1e-6, err_msg=k)


def test_rglru_block_decode_matches_sequence():
    """Twin of the reference's test: one step at a time from a zero state
    equals the sequence form (2e-2, its tolerance; bf16 input, the model's
    activation dtype, where the reference test promotes an f32 input)."""
    _, _, ct, pt = _block_pair()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 12, ct.d_model)).astype(np.float32)).bfloat16()
    seq, none = TR.rglru_apply(pt, ct, x)
    assert none is None
    state = TR.rglru_state_init(ct, 2, "cpu")
    outs = []
    for t in range(x.shape[1]):
        o, state = TR.rglru_apply(pt, ct, x[:, t:t + 1], state=state,
                                  decode=True)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).float().numpy(),
                               seq.float().numpy(), atol=2e-2, rtol=2e-2)


def test_rglru_stability_long_sequence():
    """Twin of the reference's test: |a| < 1 by construction, so the state
    stays finite over 512 steps of large inputs."""
    _, _, ct, pt = _block_pair()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 512, ct.d_model)).astype(np.float32) * 10.0).bfloat16()
    out, _ = TR.rglru_apply(pt, ct, x)
    assert torch.isfinite(out.float()).all()


def test_rglru_block_f32_input_matches_reference():
    """Twin of the reference's decode-against-sequence test
    (tests/test_recurrent.py) as it runs there: an f32 x over bf16
    weights, which jnp promotes and the port promotes at the block's entry
    (fault F10; the twin above feeds bf16). The sequence form and a
    one-step-at-a-time decode from the zero state, each against the
    reference's and against each other at the reference test's 2e-2; the
    outputs and the new state (h and the conv tail) in f32 on both
    sides."""
    cj, pj, ct, pt = _block_pair()
    x = np.random.default_rng(5).standard_normal(
        (2, 12, ct.d_model)).astype(np.float32)
    yj, _ = JR.rglru_apply(pj, cj, jnp.asarray(x))
    yt, none = TR.rglru_apply(pt, ct, torch.from_numpy(x))
    assert none is None
    assert yt.dtype == torch.float32 and yj.dtype == jnp.float32
    np.testing.assert_allclose(t_np(yt), to_np(yj), atol=2e-2, rtol=2e-2)
    sj, st = JR.rglru_state_init(cj, 2), TR.rglru_state_init(ct, 2, "cpu")
    outs_j, outs_t = [], []
    for t in range(x.shape[1]):
        o, sj = JR.rglru_apply(pj, cj, jnp.asarray(x[:, t:t + 1]), state=sj,
                               decode=True)
        outs_j.append(o)
        o, st = TR.rglru_apply(pt, ct, torch.from_numpy(x[:, t:t + 1]),
                               state=st, decode=True)
        outs_t.append(o)
    dec = torch.cat(outs_t, 1)
    np.testing.assert_allclose(t_np(dec), to_np(jnp.concatenate(outs_j, 1)),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(t_np(dec), t_np(yt), atol=2e-2, rtol=2e-2)
    for k in st:
        assert st[k].dtype == torch.float32 and sj[k].dtype == jnp.float32
        np.testing.assert_allclose(t_np(st[k]), to_np(sj[k]), atol=2e-2,
                                   rtol=2e-2, err_msg=k)


def test_rglru_stability_long_sequence_f32():
    """Twin of the reference's stability test as it runs there: 512 steps
    of an f32 x of scale 10 over bf16 weights stay finite, in f32, and
    equal to the reference's at its 2e-2."""
    cj, pj, ct, pt = _block_pair()
    x = np.random.default_rng(6).standard_normal(
        (1, 512, ct.d_model)).astype(np.float32) * 10.0
    out, _ = TR.rglru_apply(pt, ct, torch.from_numpy(x))
    want, _ = JR.rglru_apply(pj, cj, jnp.asarray(x))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    np.testing.assert_allclose(t_np(out), to_np(want), atol=2e-2, rtol=2e-2)


def test_params_keep_reference_dtypes():
    """The hand-over gives each RG-LRU leaf the reference's dtype (gate_r,
    gate_i and a_param f32, the rest bf16) and its values; the port's own
    init draws the same dtypes and the reference's a_param law: at r = 1,
    a = exp(-8 softplus(a_param)) = u with u uniform in [0.25, 0.75] (the
    reference's comment says [0.9, 0.999]; ROADMAP C, F8)."""
    cj, pj, ct, pt = model_pair(ARCH)
    mj, mt = pj["units"][0]["mixer"], pt["units"][0]["mixer"]
    assert sorted(mt) == sorted(mj)
    for k in mt:
        want = torch.float32 if k in ("gate_r", "gate_i", "a_param") \
            else torch.bfloat16
        assert mt[k].dtype == want, k
        np.testing.assert_array_equal(t_np(mt[k]), to_np(mj[k]), err_msg=k)
    gen = torch.Generator().manual_seed(0)
    own = TR.rglru_init(gen, ct, "cpu", repeats=2)
    assert own["a_param"].shape == (2, ct.lru_width)
    a = torch.exp(-8.0 * F.softplus(own["a_param"]))
    assert float(a.min()) >= 0.25 - 1e-6 and float(a.max()) <= 0.75 + 1e-6
    assert {k: v.dtype for k, v in own.items()} == \
        {k: v.dtype for k, v in mt.items()}


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(2, vocab, (b, s)).astype(
        np.int32)


def test_recurrentgemma_logits_match_reference():
    """The cache-free forward (4 RG-LRU blocks and 2 window-8 attention
    blocks at reduced size, 20 positions so the window bites): logits
    within the bf16 model's tolerance."""
    cj, pj, ct, pt = model_pair(ARCH)
    toks = _tokens(2, 2, 20, ct.vocab_size)
    lj, _, _ = japply(pj, cj, jnp.asarray(toks), settings=JNAIVE)
    lt, cache, _ = apply(pt, ct, torch.from_numpy(toks))
    assert cache is None
    np.testing.assert_allclose(lt.numpy(), to_np(lj), atol=5e-2, rtol=0)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "gemma3-12b"])
def test_decode_matches_full_forward(arch):
    """Prefill 16 tokens into the ring caches and recurrent states, decode
    8 more through the ring decode of backend "kernel" (the plain version
    on the CPU): each step's logits equal the full forward's at that
    position (the reference test's bf16 tolerance, 0.06). The window-8
    rings wrap during prefill and again during decode."""
    _, _, ct, pt = model_pair(arch)
    S, S0, b = 24, 16, 2
    tokens = torch.from_numpy(_tokens(1, b, S, ct.vocab_size))
    full, _, _ = apply(pt, ct, tokens)
    prefill, decode = SS.make_prefill_step(ct), SS.make_decode_step(ct)
    _, cache = prefill(pt, tokens[:, :S0], context=S)
    rings = [P for P in cache["units"] if "pos" in P]
    assert rings and all(P["pos"].shape[-1] == 8 for P in rings
                         if arch == ARCH)
    errs = []
    for t in range(S0, S):
        pos = torch.full((b,), t, dtype=torch.int32)
        lg, cache = decode(pt, tokens[:, t:t + 1], pos, cache, context=S)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 0.06, errs
