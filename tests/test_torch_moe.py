"""The port's models/moe.py against the reference package's: twins of the
reference's routing-invariant tests (tests/test_moe.py) run on the port;
`moe_apply`'s output and both aux losses from the same numpy weights and
inputs in f32 and bf16 over the sequence-group, decode-batch-group,
padding and top-1 paths; the dispatch masks, equal exactly; gradients of a
reduced mixtral's training loss; the paged engine and greedy_generate on a
reduced mixtral, token-identical to the JAX engine; and fault F13 (a decode
step routes its inert lanes too, so they take expert capacity) pinned in
both packages."""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as JS
from repro.configs import get_config as jax_get_config
from repro.configs.base import depth_variant as jax_depth
from repro.models import ModelSettings as JMS, init_params as jax_init_params
from repro.models import moe as JMOE
from repro.models.attention import AttnSettings as JAS
from repro.runtime import serve_step as JSS
from repro.runtime import train_step as JT
from repro.serving.executor import PagedJaxExecutor
from repro_torch import serving as TS
from repro_torch.configs import get_config
from repro_torch.configs.base import depth_variant
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.models import init_params
from repro_torch.models import layers as TL
from repro_torch.models import moe as MOE
from repro_torch.runtime import serve_step as SS
from repro_torch.runtime import train_step as TT
from repro_torch.serving.executor import PagedTorchExecutor

from _torch_parity import model_pair, t_np, to_np, tree_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOL_F32 = 1e-5
TOL_BF16 = 5e-2     # _check_logits' tolerance (tests/test_torch_model.py)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(arch="mixtral-8x7b", dtype="bfloat16", **kw):
    cj = dataclasses.replace(jax_get_config(arch).reduced(),
                             param_dtype=dtype, **kw)
    ct = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype,
                             **kw)
    return cj, ct


def _pair(arch="mixtral-8x7b", dtype="bfloat16", seed=5, **kw):
    """(cfg_jax, moe params jax, cfg_torch, moe params torch): one MoE
    layer's weights drawn by the reference, handed over as numpy."""
    cj, ct = _cfgs(arch, dtype, **kw)
    pj = JMOE.moe_init(jax.random.PRNGKey(seed), cj)
    pt = {k: torch.from_numpy(np.array(to_np(v))).to(
        torch.float32 if k == "router" else TDT[dtype])
        for k, v in pj.items()}
    return cj, pj, ct, pt


def _x(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":            # values exact in bf16 on both sides
        x = np.array(to_np(jnp.asarray(x, jnp.bfloat16)))
    return x


def _both(pj, cj, pt, ct, x, dtype, **kw):
    yj, auxj = JMOE.moe_apply(pj, cj, jnp.asarray(x, JDT[dtype]), **kw)
    yt, auxt = MOE.moe_apply(pt, ct, torch.from_numpy(x).to(TDT[dtype]), **kw)
    return (to_np(yj), {k: float(v) for k, v in auxj.items()},
            t_np(yt), {k: float(v) for k, v in auxt.items()})


# ---------------------------------------------------------------------------
# Twins of tests/test_moe.py, on the port
# ---------------------------------------------------------------------------

def _setup(arch="mixtral-8x7b"):
    _, _, ct, pt = _pair(arch, "bfloat16")
    return ct, pt


def _rand(shape, seed=5):
    return torch.from_numpy(_x(seed, shape, "float32"))


def test_moe_forward_finite_and_shape():
    cfg, params = _setup()
    x = _rand((2, 16, cfg.d_model))
    y, aux = MOE.moe_apply(params, cfg, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux["lb_loss"]) >= 1.0 - 1e-3   # E * sum(f*p) >= 1 always


def test_dispatch_capacity_respected():
    """No expert takes more than C tokens of a group, each kept choice
    fills exactly one slot, and a token's slots sum to its kept choices."""
    cfg, params = _setup()
    x = _rand((1, 32, cfg.d_model))
    s, E, k = 32, cfg.n_experts, cfg.top_k
    C = max(1, int(-(-s * k * cfg.capacity_factor // E)))
    h = TL.rmsnorm(params["norm"], x, cfg.norm_eps)
    dispatch, combine, idx, _, _ = MOE.route(params, cfg, h)
    assert dispatch.shape == (1, s, E, C)
    per_slot = dispatch.float().sum(dim=1)                # [1, E, C]
    assert float(per_slot.max()) <= 1.0
    filled = dispatch.float().sum(dim=(2, 3))             # [1, s]
    chosen = dispatch.float().sum(dim=-1).gather(-1, idx)  # [1, s, k]
    assert bool(((chosen == 0) | (chosen == 1)).all())
    assert torch.equal(filled, chosen.sum(dim=-1))
    assert float(filled.max()) <= k
    assert C >= 1


def test_grouped_equals_single_group_when_no_drops():
    """Group size must not change results when capacity is ample (no token
    drops): per-group capacity C = g·k·cf/E covers every assignment at
    cf = E/k."""
    cfg, params = _setup()
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    x = _rand((1, 32, cfg.d_model))
    y1, _ = MOE.moe_apply(params, cfg, x, group_size=32)
    y2, _ = MOE.moe_apply(params, cfg, x, group_size=8)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-4, rtol=1e-4)


def test_decode_batch_grouping():
    cfg, params = _setup()
    x = _rand((8, 1, cfg.d_model))
    y, _ = MOE.moe_apply(params, cfg, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())


def test_top1_arch():
    cfg, params = _setup("llama4-scout-17b-a16e")
    x = _rand((2, 16, cfg.d_model))
    y, aux = MOE.moe_apply(params, cfg, x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def test_padding_path():
    cfg, params = _setup()
    x = _rand((1, 19, cfg.d_model))           # odd seq
    y, _ = MOE.moe_apply(params, cfg, x, group_size=8)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def test_combine_weights_normalized():
    """Kept tokens' outputs are convex combinations: doubling every
    expert's output doubles y (combine is linear in them)."""
    cfg, params = _setup()
    cfg = dataclasses.replace(cfg, param_dtype="float32")
    params = {k: v.float() for k, v in params.items()}
    x = _rand((1, 16, cfg.d_model))
    y1, _ = MOE.moe_apply(params, cfg, x)
    p2 = dict(params)
    p2["wo"] = params["wo"] * 2.0
    y2, _ = MOE.moe_apply(p2, cfg, x)
    np.testing.assert_allclose(y2.numpy(), 2 * y1.numpy(), atol=1e-4,
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

# (arch, x shape, group_size): the sequence group (one group a row), several
# groups a row, the decode batch group, the padding path, top-1
PATHS = {
    "seq_group": ("mixtral-8x7b", (2, 16), 2048),
    "seq_groups": ("mixtral-8x7b", (2, 32), 8),
    "decode_batch": ("mixtral-8x7b", (8, 1), 2048),
    "padding": ("mixtral-8x7b", (1, 19), 8),
    "top1": ("llama4-scout-17b-a16e", (2, 16), 2048),
    "top1_decode": ("llama4-scout-17b-a16e", (6, 1), 2048),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_moe_apply_matches_reference(path, dtype):
    arch, (b, s), g = PATHS[path]
    cj, pj, ct, pt = _pair(arch, dtype)
    x = _x(7, (b, s, cj.d_model), dtype)
    yj, auxj, yt, auxt = _both(pj, cj, pt, ct, x, dtype, group_size=g)
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(yt, yj, atol=tol, rtol=0)
    for k in ("lb_loss", "z_loss"):
        assert auxt[k] == pytest.approx(auxj[k], rel=1e-5, abs=1e-6), k
    if dtype == "bfloat16":
        # bf16 outputs agree far inside the tolerance where routing is the
        # same: most elements are equal
        assert np.mean(yt == yj) > 0.9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_dispatch_masks_equal_reference(path, dtype, monkeypatch):
    """The reference's dispatch tensor (caught where it is handed to the
    sharding annotation) equals the port's `route` output exactly; the
    padding path's zero rows route on exact probability ties, which both
    break toward the lower expert index."""
    arch, (b, s), g = PATHS[path]
    cj, pj, ct, pt = _pair(arch, dtype)
    seen = []
    orig = JMOE.shard

    def catch(a, *axes):
        if axes == ("batch", "seq", "experts", None):
            seen.append(to_np(a))
        return orig(a, *axes)

    monkeypatch.setattr(JMOE, "shard", catch)
    x = _x(9, (b, s, cj.d_model), dtype)
    JMOE.moe_apply(pj, cj, jnp.asarray(x, JDT[dtype]), group_size=g)
    assert len(seen) == 1
    # the port's groups, as moe_apply forms them
    xt = torch.from_numpy(x).to(TDT[dtype])
    if s == 1:
        xt = xt.reshape(1, b, -1)
    else:
        gg = min(g, s)
        pad = (-s) % gg
        xt = torch.nn.functional.pad(xt, (0, 0, 0, pad)).reshape(
            -1, gg, cj.d_model)
    h = TL.rmsnorm(pt["norm"], xt, ct.norm_eps)
    dispatch = MOE.route(pt, ct, h)[0]
    np.testing.assert_array_equal(t_np(dispatch), seen[0])
    assert seen[0].sum() > 0


def _chip_smoke(monkeypatch):
    """chip_smoke.py as a module (it refuses to import without a GPU)."""
    monkeypatch.syspath_prepend(ROOT)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("path", ["seq_groups", "decode_batch", "top1"])
def test_forced_routes_reproduce_the_layer(path, monkeypatch):
    """chip_smoke.py's forced routing (the replay and the plain run of
    phase 13 take another run's MoE routes): a layer made to take its own
    experts and kept choices gives its own output, capacity drops
    included; given another input's routes it runs those experts."""
    cs = _chip_smoke(monkeypatch)
    arch, (b, s), g = PATHS[path]
    _, _, ct, pt = _pair(arch, "float32")
    x = torch.from_numpy(_x(11, (b, s, ct.d_model), "float32"))
    seen = []

    def record(route, params, cfg, h):
        out = route(params, cfg, h)
        seen.append((h, out[2], cs.kept_choices(out[0], out[2])))
        return out
    with cs.routing(record):
        y, aux = MOE.moe_apply(pt, ct, x, group_size=g)
    (h, idx, kept), = seen
    if ct.top_k > 1:
        assert not bool(kept.all())          # capacity dropped choices
    calls = iter([(idx, kept), ((idx + 1) % ct.n_experts, kept)])

    def force(route, params, cfg, h):
        return cs.forced_route(params, cfg, h, *next(calls))
    with cs.routing(force):
        y2, aux2 = MOE.moe_apply(pt, ct, x, group_size=g)
        y3, _ = MOE.moe_apply(pt, ct, x, group_size=g)
    assert MOE.route is not force
    np.testing.assert_allclose(t_np(y2), t_np(y), atol=1e-6, rtol=0)
    assert float(aux2["lb_loss"]) == pytest.approx(float(aux["lb_loss"]))
    d3 = cs.forced_route(pt, ct, h, (idx + 1) % ct.n_experts, kept)[0]
    assert torch.equal(d3.float().sum(dim=-1).gather(
        -1, (idx + 1) % ct.n_experts) > 0, kept)
    assert not np.allclose(t_np(y3), t_np(y))


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4]])
    _, idx = MOE.top_k_lower_index(probs, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == [[0, 1], [1, 3]] == np.asarray(jidx).tolist()


ARCH = "mixtral-8x7b"
B, S = 2, 16


@functools.lru_cache(maxsize=1)
def _loss_setup():
    cj = jax_depth(dataclasses.replace(jax_get_config(ARCH).reduced(),
                                       param_dtype="float32"), 2)
    ct = depth_variant(dataclasses.replace(get_config(ARCH).reduced(),
                                           param_dtype="float32"), 2)
    pj = jax_init_params(jax.random.PRNGKey(3), cj)
    rng = np.random.default_rng(13)
    batch = {"tokens": rng.integers(2, cj.vocab_size, (B, S)).astype(
                 np.int32),
             "targets": rng.integers(2, cj.vocab_size, (B, S)).astype(
                 np.int32)}
    fn = jax.value_and_grad(JT.make_loss_fn(cj, JT.TrainStepConfig()),
                            has_aux=True)
    (total, aux), g = fn(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    return cj, ct, pj, batch, float(total), {k: float(v)
                                             for k, v in aux.items()}, g


@pytest.mark.parametrize("remat", ["none", "full"])
def test_mixtral_loss_and_grads_match_reference(remat):
    """A reduced mixtral at 2 layers, f32: the loss, both aux losses and
    every gradient leaf (the router's and the experts' included) against
    jax.value_and_grad through the reference's loss."""
    cj, ct, pj, batch, total_j, aux_j, gj = _loss_setup()
    pt = params_from_jax(tree_np(pj), ct, "cpu")
    assert pt["units"][0]["mlp"]["wi"].shape == (2, 4, 64, 256)
    grad_fn = TT.value_and_grad(TT.make_loss_fn(
        ct, TT.TrainStepConfig(remat=remat)))
    (total_t, met), gt = grad_fn(pt, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert float(total_t) == pytest.approx(total_j, rel=1e-6)
    for k in ("loss", "lb_loss", "z_loss"):
        assert float(met[k]) == pytest.approx(aux_j[k], rel=1e-5), k
    assert aux_j["lb_loss"] > 0 and aux_j["z_loss"] > 0
    ng, wj = jax.tree.leaves(to_numpy(gt)), jax.tree.leaves(tree_np(gj))
    scale = max(float(np.abs(x).max()) for x in wj)
    assert len(ng) == len(wj)
    for a, w in zip(ng, wj):
        np.testing.assert_allclose(a, w, atol=2e-5 * scale, rtol=1e-4)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e"])
def test_params_from_jax_carries_moe_leaves(arch):
    """Both packages' params at reduced size (2 unit repeats), leaf by
    leaf: the reference's values carried over exactly, in the dtypes and
    shapes of the port's own init_params (the router in f32, the experts
    stacked over repeats [repeats, E, ...] in the param dtype)."""
    cj = jax_depth(jax_get_config(arch).reduced(), 2)
    ct = depth_variant(get_config(arch).reduced(), 2)
    pj = jax_init_params(jax.random.PRNGKey(7), cj)
    pt = params_from_jax(tree_np(pj), ct, "cpu")
    own = init_params(torch.Generator().manual_seed(0), ct, device="cpu")
    lj, lt = jax.tree.leaves(tree_np(pj)), jax.tree.leaves(to_numpy(pt))
    assert len(lj) == len(lt) == len(jax.tree.leaves(to_numpy(own)))
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(b, a)
    for pu, ou in zip(pt["units"], own["units"]):
        for k in ("norm", "router", "wi", "wo"):
            got, want = pu["mlp"][k], ou["mlp"][k]
            assert (got.shape, got.dtype) == (want.shape, want.dtype), k
        assert pu["mlp"]["router"].dtype == torch.float32
        assert pu["mlp"]["wi"].shape == (2, ct.n_experts, ct.d_model,
                                         2 * ct.d_ff)


# ---------------------------------------------------------------------------
# Serving: the paged engine and greedy_generate on a reduced mixtral
# ---------------------------------------------------------------------------

JNAIVE = JMS(attn=JAS(backend="naive"))
JPALLAS = JMS(attn=JAS(backend="pallas"))    # interpret mode off the TPU
KV_BLOCK, N_BLOCKS, LANES, CHUNK = 4, 24, 3, 8


def _trace(S_, vocab):
    return S_.synthetic_trace(6, vocab_size=vocab, seed=6,
                              prompt_lens=(3, 5, 8, 11), gen_lens=(3, 5),
                              mean_interarrival=0.0)


def test_greedy_generate_equals_reference():
    """bf16 params at 2 layers (trap T2): prefill grouped along the prompt,
    then decode steps that route the batch of 2 as one group."""
    cj, pj, ct, pt = model_pair(ARCH, depth=2)
    prompt = np.random.default_rng(6).integers(
        2, cj.vocab_size, (2, 9)).astype(np.int32)
    want = JSS.greedy_generate(pj, cj, jnp.asarray(prompt), n_steps=10,
                               context=24, settings=JNAIVE)
    got = SS.greedy_generate(pt, ct, torch.from_numpy(prompt), n_steps=10,
                             context=24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_engine_equals_reference():
    """The compacted chunked paged engine on a reduced mixtral: every
    stream and the report counters equal the JAX engine's (the MoE routes
    each decode tick's bucketed lane batch and each chunk's rows, padding
    rows included, on both sides)."""
    cj, pj, ct, pt = model_pair(ARCH)
    trace_j, trace_t = _trace(JS, cj.vocab_size), _trace(TS, ct.vocab_size)
    context = -(-JS.trace_context(trace_j) // KV_BLOCK) * KV_BLOCK
    ex_j = PagedJaxExecutor(pj, cj, n_lanes=LANES, n_blocks=N_BLOCKS,
                            kv_block=KV_BLOCK, context=context,
                            settings=JPALLAS, compact=True, chunk=CHUNK)
    rep_j = JS.Engine(ex_j, LANES,
                      allocator=JS.BlockAllocator(N_BLOCKS, KV_BLOCK),
                      chunk_prefill=CHUNK, audit="strict").run(trace_j)
    ex_t = PagedTorchExecutor(pt, ct, n_lanes=LANES, n_blocks=N_BLOCKS,
                              kv_block=KV_BLOCK, context=context,
                              compact=True, chunk=CHUNK, device="cpu")
    rep_t = TS.Engine(ex_t, LANES,
                      allocator=TS.BlockAllocator(N_BLOCKS, KV_BLOCK),
                      chunk_prefill=CHUNK, audit="strict").run(trace_t)
    assert len(rep_t.completions) == len(trace_t)
    assert ex_t.chunk_calls > 0 and ex_t.decodes > 0
    assert [(c.rid, tuple(c.tokens)) for c in rep_t.completions] == \
        [(c.rid, tuple(c.tokens)) for c in rep_j.completions]
    assert (rep_t.ticks, rep_t.prefill_calls, rep_t.prefill_tokens) == \
        (rep_j.ticks, rep_j.prefill_calls, rep_j.prefill_tokens)


# ---------------------------------------------------------------------------
# F13: a decode step routes the whole lane batch, inert lanes included
# ---------------------------------------------------------------------------

def test_f13_inert_lanes_take_expert_capacity():
    """At decode the routing group is the step's lane batch (8 lanes: C =
    ceil(8 x 2 x 1.25 / 8) = 3 slots an expert at mixtral's numbers). A
    live token in the last lane keeps both of its experts when the seven
    inert rows are zeros (they all route to experts 0 and 1, on exact
    ties); when the inert rows hold copies of the live token they claim its
    experts' slots first and its output drops to zero. Both packages do
    the same, value for value."""
    cj, pj, ct, pt = _pair("mixtral-8x7b", "float32",
                           n_experts=8, top_k=2)
    live = _x(21, (1, 1, cj.d_model), "float32")
    h = TL.rmsnorm(pt["norm"], torch.from_numpy(live), ct.norm_eps)
    _, idx = MOE.top_k_lower_index(
        torch.softmax(h[0, 0].float() @ pt["router"], -1), 2)
    assert not set(idx.tolist()) & {0, 1}      # the zero rows' experts
    idle = np.concatenate([np.zeros((7, 1, cj.d_model), np.float32), live])
    copies = np.repeat(live, 8, axis=0)
    outs = {}
    for name, x in (("idle", idle), ("copies", copies)):
        yj, _, yt, _ = _both(pj, cj, pt, ct, x, "float32")
        np.testing.assert_allclose(yt, yj, atol=TOL_F32, rtol=0)
        outs[name] = yt[7, 0]
    alone_j, _, alone_t, _ = _both(pj, cj, pt, ct, live, "float32")
    np.testing.assert_allclose(outs["idle"], alone_t[0, 0], atol=TOL_F32)
    np.testing.assert_allclose(alone_t, alone_j, atol=TOL_F32, rtol=0)
    assert np.abs(outs["idle"]).max() > 1e-3
    np.testing.assert_array_equal(outs["copies"], 0.0)
