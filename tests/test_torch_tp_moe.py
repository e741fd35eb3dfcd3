"""Serving MoE blocks on a `model` axis — expert parallelism (EP: each
rank holds E / M whole experts) and tensor parallelism inside the experts
(TP: each rank holds its [gate_r | val_r] columns of every expert) —
against the reference package on one device. One world of gloo ranks over
the CPU for each mesh size ({data: 1, model: 2} and {data: 1, model: 4},
spawned by launch.mesh.spawn_ranks; rank functions in
tests/_torch_tp_moe_ranks.py) runs every rank-side check.

Reduced mixtral-8x7b (top-2) and llama4-scout-17b-a16e (top-1), 4
experts each at that size, weights drawn by the reference and carried
across by params_from_jax, inputs made with numpy from a seed: the MoE
block on model:2 EP, model:4 EP and model:2 TP against the reference's
moe_apply (a decode step with inert lanes among the paths); the dispatch
masks of every rank equal to each other and to the reference's; the paged
engine (EP and TP) and the slot engine on model:2 against the reference's
engines, token for token in bf16, every rank routing the same; one device
made to take the ranks' routes emitting their tokens; the spec trees under
both layouts and plan_serving on {data: 1, model: 2} against the
reference's; the serve CLI on two ranks emitting one rank's tokens."""
import dataclasses
import enum
import functools
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import hw as JHW
from repro import serving as JS
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import depth_variant as jax_depth
from repro.launch.compile import abstract_params
from repro.models import ModelSettings as JMS
from repro.models import init_params as jax_init_params
from repro.models import moe as JMOE
from repro.models.attention import AttnSettings as JAS
from repro.parallel import sharding as JSH
from repro.search import execplan as JXP
from repro.search import space as JSP
from repro.serving.executor import JaxExecutor, PagedJaxExecutor
from repro_torch import hw as THW
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.base import depth_variant
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh as LM
from repro_torch.models import init_params
from repro_torch.models import moe as MOE
from repro_torch.parallel import sharding as S
from repro_torch.parallel.axes import GluSpec
from repro_torch.runtime import schedule as SCH
from repro_torch.search import execplan as TXP
from repro_torch.search import space as TSP
from repro_torch.tree import tree_leaves, tree_paths

from _torch_parity import to_np, tree_np
import _torch_tp_moe_ranks as R

JNAIVE = JMS(attn=JAS(backend="naive"))
ROOT = os.path.join(os.path.dirname(__file__), "..")
DTYPES = ("float32", "bfloat16")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# f32 weights: the f32 sums in other orders (the ranks' partial y summed
# over the axis); bf16 weights: the reference parity tests' tolerance for
# bf16 outputs (tests/test_torch_moe.py)
ATOL = {"float32": 2e-5, "bfloat16": 5e-2}
# path: (x shape [b, s], group size, rows copied from another row): groups
# along the sequence, a sequence padded to whole groups, and a decode step,
# which routes its lane batch as one group; its rows 4-7 are inert lanes
# holding one row's copy, which claim its experts' capacity (fault F13)
PATHS = {"seq_groups": ((2, 32), 8, ()),
         "padding": ((1, 19), 8, ()),
         "decode_inert": ((8, 1), 2048, ((4, 3), (5, 3), (6, 3), (7, 3)))}
# (model ranks, EP): the layouts checked
LAYOUTS = ((2, True), (4, True), (2, False))


def _jax_model(arch, dtype="bfloat16", depth=None, seed=5):
    cj = dataclasses.replace(jax_get_config(arch).reduced(),
                             param_dtype=dtype)
    if depth is not None:
        cj = jax_depth(cj, depth)
    return cj, jax_init_params(jax.random.PRNGKey(seed), cj)


@functools.lru_cache(maxsize=None)
def _cases():
    """{(arch, dtype): (cfg jax, params jax, numpy params, {path: (x,
    group)})}."""
    out = {}
    for i, arch in enumerate(R.ARCHS):
        for dtype in DTYPES:
            cj, pj = _jax_model(arch, dtype)
            inputs = {p: (R.rng_inputs(10 + i, (b, s, cj.d_model), cp), g)
                      for p, ((b, s), g, cp) in PATHS.items()}
            out[arch, dtype] = (cj, pj, tree_np(pj), inputs)
    return out


@functools.lru_cache(maxsize=None)
def _engine_model():
    return _jax_model("mixtral-8x7b", depth=R.ENGINE_DEPTH, seed=1)


@functools.lru_cache(maxsize=None)
def _world(m):
    """Every rank's results on {data: 1, model: m}: the MoE blocks under
    the layouts of LAYOUTS on m ranks, and on model:2 the engines."""
    cases = {k: (v[2], v[3]) for k, v in _cases().items()}
    layouts = tuple(ep for mm, ep in LAYOUTS if mm == m)
    tree = tree_np(_engine_model()[1]) if m == 2 else None
    return R.spawn(R.moe_all, m, m, cases, layouts, tree)


@functools.lru_cache(maxsize=None)
def _reference_block(arch, dtype, path):
    """The reference's moe_apply on the first MoE layer, jitted: (y, aux,
    the dispatch mask it hands to its sharding annotation)."""
    cj, pj, _, inputs = _cases()[arch, dtype]
    layer = {k: v[0] for k, v in pj["units"][0]["mlp"].items()}
    x, g = inputs[path]
    seen = []
    orig = JMOE.shard

    def catch(a, *axes):
        if axes == ("batch", "seq", "experts", None):
            jax.debug.callback(lambda v: seen.append(np.asarray(v)), a)
        return orig(a, *axes)
    JMOE.shard = catch
    try:
        y, aux = jax.jit(functools.partial(JMOE.moe_apply, cfg=cj,
                                           group_size=g))(
            layer, x=jnp.asarray(x, JDT[dtype]))
        jax.block_until_ready(y)
    finally:
        JMOE.shard = orig
    return (np.asarray(to_np(y), np.float32),
            {k: float(v) for k, v in aux.items()}, seen[0])


# ---------------------------------------------------------------------------
# The MoE block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("m,ep", LAYOUTS, ids=["model2-ep", "model4-ep",
                                               "model2-tp"])
def test_moe_block_matches_reference(m, ep, arch, dtype):
    """Each path's output on every rank (the same bits on all of them:
    the partial y summed over the axis) within ATOL of the reference's
    moe_apply on one device, both aux losses equal to its; each rank's wi
    shard the layout's: E / m whole experts under EP, every expert's
    2 d_ff / m columns under TP."""
    cfg = R.cfg_of(arch, dtype)
    E, F2 = cfg.n_experts, 2 * cfg.d_ff
    for path in PATHS:
        want_y, want_aux, _ = _reference_block(arch, dtype, path)
        got = [r["blocks"][arch, dtype, ep, path] for r in _world(m)]
        for y, aux, _, wi in got:
            assert wi == ((E // m, cfg.d_model, F2) if ep
                          else (E, cfg.d_model, F2 // m)), path
            np.testing.assert_array_equal(y, got[0][0])
            np.testing.assert_allclose(y, want_y, atol=ATOL[dtype], rtol=0,
                                       err_msg=path)
            for k in ("lb_loss", "z_loss"):
                assert aux[k] == pytest.approx(want_aux[k], rel=1e-5,
                                               abs=1e-6), (path, k)
        assert np.abs(want_y).max() > 1e-3


@pytest.mark.parametrize("m,ep", LAYOUTS, ids=["model2-ep", "model4-ep",
                                               "model2-tp"])
def test_dispatch_masks_equal_on_every_rank_and_reference(m, ep):
    """Routing is replicated: every rank's dispatch mask [b, s, E, C] (the
    global expert count's capacity C, the whole router's logits) equals
    every other rank's and the reference's exactly, on every path, both
    archs, both dtypes."""
    for arch in R.ARCHS:
        for dtype in DTYPES:
            for path in PATHS:
                want = _reference_block(arch, dtype, path)[2]
                for r in _world(m):
                    got = r["blocks"][arch, dtype, ep, path][2]
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=(arch, path))
                assert want.sum() > 0


def test_decode_step_inert_lanes_take_capacity_on_every_rank():
    """A decode step's inert lanes (rows 4-7, copies of row 3) route with
    the live rows as one group on every rank, as on one device: they claim
    slots of row 3's experts, and row 3's output is the reference's."""
    for m, ep in LAYOUTS:
        for arch in R.ARCHS:
            want_y, _, want_d = _reference_block(arch, "float32",
                                                 "decode_inert")
            assert want_d[0, 4:].sum() > 0      # one group: [1, 8, E, C]
            for r in _world(m):
                y, _, d, _ = r["blocks"][arch, "float32", ep, "decode_inert"]
                np.testing.assert_array_equal(d, want_d)
                np.testing.assert_allclose(y[3], want_y[3],
                                           atol=ATOL["float32"], rtol=0)


# ---------------------------------------------------------------------------
# Engines on model:2
# ---------------------------------------------------------------------------

def _jax_engine(kind):
    cj, pj = _engine_model()
    trace = JS.synthetic_trace(6, vocab_size=cj.vocab_size, **R.TRACE_KW)
    if kind == "paged":
        ex = PagedJaxExecutor(pj, cj, n_lanes=R.LANES, n_blocks=R.N_BLOCKS,
                              kv_block=R.KV_BLOCK,
                              context=-(-JS.trace_context(trace)
                                        // R.KV_BLOCK) * R.KV_BLOCK,
                              settings=JNAIVE, compact=True, chunk=R.CHUNK)
        eng = JS.Engine(ex, R.LANES,
                        allocator=JS.BlockAllocator(R.N_BLOCKS, R.KV_BLOCK),
                        chunk_prefill=R.CHUNK, audit="strict")
    else:
        eng = JS.Engine(JaxExecutor(pj, cj, n_slots=2,
                                    context=JS.trace_context(trace),
                                    settings=JNAIVE), 2)
    return R.streams(eng.run(trace))


@pytest.mark.parametrize("kind,ep", R.RUNS,
                         ids=["paged-ep", "paged-tp", "slot-ep"])
def test_engine_on_model2_matches_reference(kind, ep):
    """Reduced mixtral in bf16 (trap T2) through the compacted chunked
    paged engine (EP and TP inside the experts) and the slot engine on
    model:2: every rank emits the reference engine's streams on one
    device, routes every call the same as the other rank, and holds the
    layout's shard of wi."""
    want = _jax_engine(kind)
    cfg = R.cfg_of("mixtral-8x7b", depth=R.ENGINE_DEPTH)
    runs = [r["engines"][kind, ep] for r in _world(2)]
    for run in runs:
        assert run["streams"] == want
        assert run["wi"][-3:] == ((cfg.n_experts // 2, cfg.d_model,
                                   2 * cfg.d_ff) if ep else
                                  (cfg.n_experts, cfg.d_model, cfg.d_ff))
        assert len(run["routes"]) == len(runs[0]["routes"]) > 0
        for (e, k), (e0, k0) in zip(run["routes"], runs[0]["routes"]):
            np.testing.assert_array_equal(e, e0)
            np.testing.assert_array_equal(k, k0)
    assert len(want) == 6


def test_ranks_keep_the_global_capacity_rules_choices():
    """Every routing call of every run on model:2 keeps exactly the choices
    that the capacity C of the global expert count keeps of its experts
    (models.moe.capacity_slots; decode ticks route their lane batch, inert
    lanes included, chunks their pad rows): C from a rank's own E / 2
    experts would keep more."""
    cfg = R.cfg_of("mixtral-8x7b", depth=R.ENGINE_DEPTH)
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    dropped = 0
    for kind, ep in R.RUNS:
        for e, kept in _world(2)[0]["engines"][kind, ep]["routes"]:
            e, kept = torch.from_numpy(e), torch.from_numpy(kept)
            s = e.shape[1]
            C = max(1, int(-(-s * k * cf // E)))
            want = torch.stack([keep.any(-1) for _, keep in
                                MOE.capacity_slots(e, E, C)], -1)
            assert torch.equal(want, kept)
            local = torch.stack([keep.any(-1) for _, keep in
                                 MOE.capacity_slots(e, E, 2 * C)], -1)
            dropped += int((local != kept).sum())
    assert dropped > 0          # the trace drops choices: the rule shows


def test_one_device_forced_to_the_ranks_routes_emits_their_tokens():
    """One device, its MoE layers made to take the ranks' routes call by
    call (models.moe.RouteTape, as the serve CLI's --replay-routes does),
    emits the ranks' streams; its own router, kept on the tape beside
    them, chooses as the ranks did."""
    cfg = R.cfg_of("mixtral-8x7b", depth=R.ENGINE_DEPTH)
    params = params_from_jax(tree_np(_engine_model()[1]), cfg, "cpu")
    for kind, ep in R.RUNS:
        ranks = _world(2)[0]["engines"][kind, ep]
        st, own = R.run_engine(params, cfg, kind, forced=ranks["routes"])
        assert st == ranks["streams"]
        assert len(own) == len(ranks["routes"])
        for (e, k), (e0, k0) in zip(own, ranks["routes"]):
            np.testing.assert_array_equal(e, e0)
            np.testing.assert_array_equal(k, k0)


# ---------------------------------------------------------------------------
# Shards, specs and plans
# ---------------------------------------------------------------------------

def _reassemble(shards_by_rank, specs):
    """The full leaves from every rank's shards: concatenated along the
    dimension the spec puts on "model"; a GLU wi's gate halves first, then
    its val halves (tests/test_torch_tp_serve.py's)."""
    out = []
    per_rank = [tree_leaves(t) for t in shards_by_rank]
    for i, spec in enumerate(tree_leaves(specs)):
        parts = [leaves[i] for leaves in per_rank]
        dims = [d for d, e in enumerate(spec) if "model" in S.entry_axes(e)]
        if not dims:
            out.append(parts[0])
            continue
        d, = dims
        if isinstance(spec, GluSpec) and d == len(spec) - 1:
            halves = [p.chunk(2, dim=d) for p in parts]
            out.append(torch.cat([h[0] for h in halves]
                                 + [h[1] for h in halves], dim=d))
        else:
            out.append(torch.cat(parts, dim=d))
    return out


def _port_flat(spec_tree):
    return sorted(("//".join(str(k) for k in path), tuple(spec))
                  for path, spec in tree_paths(spec_tree))


def _ref_flat(spec_tree):
    """[(path, spec)] sorted by path, as _port_flat
    (tests/test_torch_sharding.py's)."""
    out = []
    for path, spec in jax.tree_util.tree_flatten_with_path(
            spec_tree, is_leaf=lambda x: isinstance(x, P))[0]:
        key = "//".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out.append((key, tuple(spec)))
    return sorted(out)


def _norm(x):
    """Dataclasses, enums and containers as plain tuples
    (tests/test_torch_plan_serving.py's)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _norm(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    return x

@pytest.mark.parametrize("m,ep", LAYOUTS, ids=["model2-ep", "model4-ep",
                                               "model2-tp"])
def test_init_local_params_draws_the_experts_as_one_device(m, ep):
    """init_local_params under each layout (a stacked expert leaf [repeats,
    E, d, 2 d_ff] drawn slice by slice, only this rank's slices kept):
    every rank's shards reassemble init_params' tree from the same seed,
    and params_from_jax's shards the reference's tree."""
    cfg = R.cfg_of("mixtral-8x7b", depth=2)
    whole = init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    meshes = [LM.Mesh(axis_names=("data", "model"),
                      shape={"data": 1, "model": m},
                      coords={"data": 0, "model": r}, rank=r)
              for r in range(m)]
    specs = R.specs_of(cfg, meshes[0], ep)
    shards = [S.init_local_params(torch.Generator().manual_seed(5), cfg,
                                  "cpu", R.specs_of(cfg, mesh, ep), mesh)
              for mesh in meshes]
    wi = shards[0]["units"][0]["mlp"]["wi"]
    assert wi.shape == ((2, cfg.n_experts // m, cfg.d_model, 2 * cfg.d_ff)
                        if ep else
                        (2, cfg.n_experts, cfg.d_model, 2 * cfg.d_ff // m))
    for a, b in zip(_reassemble(shards, specs), tree_leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    cj, pj = _jax_model("mixtral-8x7b", depth=2)
    carried = [params_from_jax(tree_np(pj), cfg, "cpu", mesh=mesh,
                               spec_tree=R.specs_of(cfg, mesh, ep))
               for mesh in meshes]
    for a, b in zip(_reassemble(carried, specs),
                    tree_leaves(params_from_jax(tree_np(pj), cfg, "cpu"))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_spec_trees_under_both_layouts_match_reference(arch):
    """param_specs under Strategy(ep=True) and Strategy(ep=False) on
    {data: 1, model: 2} and {data: 1, model: 4}, leaf for leaf, against
    the reference's; under EP the router and the experts' leading dim are
    on "model", under TP the experts' d_ff."""
    cj, ct = jax_get_config(arch), get_config(arch)
    pj, pt = abstract_params(cj), init_params(None, ct, device="meta")
    for m in (2, 4):
        mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                     shape={"data": 1, "model": m})
        for ep in (True, False):
            st = S.param_specs(ct, pt, S.Strategy(ep=ep), mesh)
            sj = JSH.param_specs(cj, pj, JSH.Strategy(ep=ep), mesh)
            assert _port_flat(st) == _ref_flat(sj)
            mlp = dict(tree_paths(st["units"][0]["mlp"]))
            assert mlp[("router",)][-1] == ("model" if ep else None)
            assert mlp[("wi",)][1] == ("model" if ep else None)
            assert mlp[("wi",)][-1] == (None if ep else "model")
    assert S.default_strategy(ct, {"data": 1, "model": 2}).ep


def test_plan_serving_on_model2_equals_reference():
    """mixtral-8x7b on {data: 1, model: 2} as the serve CLI plans phase
    16(f)'s trace (pinned mesh, blocks of 16, compact, chunk 256, 30 GiB a
    device, the H100): the port's plan — class, block size, pool, the EP
    the planner resolved — equals the reference's, and serving and
    training both accept the mesh."""
    lens = [64 + 32, 256 + 24, 520 + 16, 1024 + 32, 64 + 16, 256 + 32]

    def plan(cfg, Shape, XP, SP, hw, **pin):
        shape = Shape("serve_trace", "decode", 1056, 8)
        space = SP.serving_space(cfg, shape, max_devices=2, data=(1,),
                                 model=(2,), kv_blocks=(16,),
                                 kv_quants=("none",), kv_retains=(0,), **pin)
        cls, splan = XP.plan_serving(
            cfg, shape, n_devices=2, hbm_budget=30 * 2**30, space=space,
            hw=hw, kv="paged", kv_blocks=(16,), seq_lens=lens, compact=True,
            kv_quants=("none",), kv_retains=(0,), chunk=256)
        # the candidates each side searched (the reference's space holds
        # the sequence-sharded cache too) aside, every cell
        return (_norm(cls), _norm(dataclasses.replace(splan, considered=0)),
                splan.slots(cap=8),
                splan.pool_blocks(splan.slots(cap=8), 1056)), splan
    jh100 = JHW.HardwareSpec(**dataclasses.asdict(THW.H100))
    want, _ = plan(jax_depth(jax_get_config("mixtral-8x7b"), 8), JShape, JXP,
                JSP, jh100)
    cfg = depth_variant(get_config("mixtral-8x7b"), 8)
    # the port's CLI pins the cache over kv heads on a model axis
    got, splan = plan(cfg, TShape, TXP, TSP, THW.H100,
                      kv_shards=("heads",))
    assert got == want
    assert splan.execution.ep and splan.execution.plan.kv_shard == "heads"
    assert splan.execution.mesh_shape == {"data": 1, "model": 2, "pipe": 1}
    assert splan.kv_block == 16 and splan.capacity > 0
    assert SCH.serving_mesh_problems(cfg, {"data": 1, "model": 2}) == []
    SCH.check_training_mesh(cfg, {"data": 1, "model": 2})


# ---------------------------------------------------------------------------
# The serve CLI on model:2
# ---------------------------------------------------------------------------

CLI = ["--arch", "mixtral-8x7b", "--reduced", "--device", "cpu", "--kv",
       "paged", "--compact", "--chunk-prefill", "8", "--kv-block", "4",
       "--requests", "6", "--prompt-lens", "4,8,20", "--gen-lens", "2,4,9"]


def _cli(*extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *CLI, *extra], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=R.TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _digest(out):
    return re.search(r"^tokens digest (\w+)$", out, re.M).group(1)


def test_serve_cli_on_two_ranks_emits_one_ranks_tokens(tmp_path):
    """`--model-parallel 2` on reduced mixtral: two gloo ranks under the
    plan's EP, each holding the spec tree's shard and the predictor's pool
    bytes, emit one rank's tokens, schedule and plan; rank 0's route tape
    (--routes-out) is one rank's; one rank replaying the ranks' tokens and
    routes (--replay, --replay-routes) emits them again."""
    one = _cli("--routes-out", str(tmp_path / "one.pt"))
    two = _cli("--model-parallel", "2", "--tokens-out",
               str(tmp_path / "two.json"), "--routes-out",
               str(tmp_path / "two.pt"))
    assert _digest(two) == _digest(one)
    rows = re.findall(r"^rank (\d) \{.*\}: param elements ([0-9,]+) \(spec "
                      r"tree ([0-9,]+);.*; pool (\d+) B \(predicted (\d+) "
                      r"B\);.*; schedule digest (\w+); tokens digest (\w+)$",
                      two, re.M)
    assert [r[0] for r in rows] == ["0", "1"]
    for _, el, spec, pool, pred, sched, dig in rows:
        assert el == spec and pool == pred and dig == _digest(one)
        assert sched == re.search(r"^schedule digest (\w+)$", one,
                                  re.M).group(1)
    plans = re.findall(r"^rank \d plan: (.*)$", two, re.M)
    assert plans[0] == plans[1] and "ep=True" in plans[0]
    tape_one = torch.load(tmp_path / "one.pt")
    tape_two = torch.load(tmp_path / "two.pt")
    assert len(tape_two) == len(tape_one) > 0
    for (e, k), (e1, k1) in zip(tape_two, tape_one):
        assert torch.equal(e, e1) and torch.equal(k, k1)
    replay = _cli("--replay", str(tmp_path / "two.json"), "--replay-routes",
                  str(tmp_path / "two.pt"))
    assert _digest(replay) == _digest(two)
