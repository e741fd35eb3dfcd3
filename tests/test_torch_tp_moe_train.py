"""Training MoE blocks on a `model` axis — expert parallelism (EP: each
rank holds E / M whole experts and E / M of the router's columns) and
tensor parallelism inside the experts (TP: each rank holds its
[gate_r | val_r] columns of every expert) — against the reference
package's one-device step: gloo ranks over the CPU ({model: 2} and
{data: 2, model: 2}, spawned by launch.mesh.spawn_ranks; rank functions
in tests/_torch_tp_moe_train_ranks.py).

Reduced mixtral-8x7b (top-2) and llama4-scout-17b-a16e (top-1), 4
experts each, f32 weights drawn with numpy from a seed (at the scale of
the reference's own init) and carried across by params_from_jax:
make_train_step's single and scan schedules under adamw_f32 and
Adafactor, remat none and full, against the reference's jitted step; one
loss's gradients on every rank against the reference's (an EP rank's
router gradient its columns of the reference's, a TP rank's the whole),
the aux losses, the routers' gradient norm and the dispatch masks of
every routing call equal to the reference's; the leaves the model axis
holds whole bit-identical across its ranks; the router gather's and the
gates' ops against the plain collectives; a forced-route replay under
remat "full" taking the tape entries of the run without remat; the train
CLI on `--mesh model:2` against the one-device CLI, its routes replayed
by one device; checkpoints of the EP layout restoring onto one device,
data:2, the TP layout and the reference bit for bit; the training check
accepting both archs on model:2 and data:2,model:2; the spec trees and
the predictor's per-device figures against the reference's."""
import dataclasses
import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import depth_variant as jax_depth
from repro.core import predictor as JPR
from repro.launch.compile import abstract_params
from repro.models import init_params as jax_init_params
from repro.models import moe as JMOE
from repro.optim import optimizers as JO
from repro.parallel import sharding as JSH
from repro.runtime import train_step as JT
from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.convert import to_numpy
from repro_torch.core import predictor as TPR
from repro_torch.launch import mesh as LM
from repro_torch.models import init_params
from repro_torch.optim import optimizers as TO
from repro_torch.parallel import sharding as S
from repro_torch.runtime import schedule as SCH
from repro_torch.tree import tree_leaves, tree_paths

from _torch_parity import to_np, tree_np
import _torch_tp_moe_train_ranks as R

B, SEQ = 4, 32
LR = 1e-3
# the tolerances of tests/test_torch_tp_train.py: parameters after two
# steps, the metrics, and one loss's gradients (f32 sums in other orders:
# the ranks' partial y, the gates' and the entry op's sums)
TOL_PARAM = 2e-5
TOL_METRIC = 1e-5
TOL_GRAD = 1e-5
# the seed of the numpy weights and batches: no routing near-ties (every
# dispatch mask equals the reference's, exactly)
SEED = 11
ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"model:2": {"model": 2}, "data:2,model:2": {"data": 2, "model": 2}}
MIX, SCOUT = "mixtral-8x7b", "llama4-scout-17b-a16e"

# (mesh, arch, ep, schedule, optimizer, remat): on model:2 each arch runs
# under EP and TP, each layout once with each optimizer, schedule and
# remat policy; on data:2,model:2 each arch under EP (4 experts tile the
# axis: the default strategy's layout)
CASES = [("model:2", MIX, True, "single", "adamw_f32", "none"),
         ("model:2", MIX, False, "scan", "adafactor", "full"),
         ("model:2", SCOUT, True, "scan", "adafactor", "full"),
         ("model:2", SCOUT, False, "single", "adamw_f32", "none"),
         ("data:2,model:2", MIX, True, "single", "adafactor", "full"),
         ("data:2,model:2", SCOUT, True, "single", "adafactor", "none")]
GRADS = [(arch, ep) for arch in R.DEPTH for ep in (True, False)]


def _ids(cases):
    return ["-".join(str(x).replace("True", "ep").replace("False", "tp")
                     for x in c) for c in cases]


@functools.lru_cache(maxsize=None)
def _setup(arch, f32=True):
    """(reference cfg, reference params, numpy batches): each weight of
    the reference's init drawn again with numpy at its own scale (norms,
    which the init sets to one, kept)."""
    cj = jax_depth(jax_get_config(arch).reduced(), R.DEPTH[arch])
    if f32:
        cj = dataclasses.replace(cj, param_dtype="float32")
    rng = np.random.default_rng(SEED)

    def draw(a):
        x = to_np(a)
        sd = float(x.std())
        if sd == 0.0:
            return a
        return jnp.asarray(rng.standard_normal(x.shape) * sd, a.dtype)

    pj = jax.tree.map(draw, jax_init_params(jax.random.PRNGKey(0), cj))
    batches = [{k: rng.integers(2, cj.vocab_size, (B, SEQ)).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(2)]
    return cj, pj, batches


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _reference_run(arch, kind, micro):
    cj, pj, batches = _setup(arch)
    tcfg = JT.TrainStepConfig(
        microbatches=micro, optimizer=JO.OptimizerConfig(kind=kind, lr=LR),
        warmup_steps=2, total_steps=10)
    step = jax.jit(JT.make_train_step(cj, tcfg))
    p, st = pj, JO.init_state(tcfg.optimizer, pj)
    metrics = []
    for i, b in enumerate(batches):
        p, st, m = step(p, st, _jbatch(b), jnp.asarray(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return tree_np(p), metrics


@functools.lru_cache(maxsize=None)
def _reference_grads(arch):
    """The reference's loss on the first batch: total, metrics, gradients
    (numpy) and the dispatch mask of every MoE layer, in layer order."""
    cj, pj, batches = _setup(arch)
    seen = []
    orig = JMOE.shard

    def catch(a, *axes):
        if axes == ("batch", "seq", "experts", None):
            jax.debug.callback(lambda v: seen.append(np.asarray(v)), a,
                               ordered=True)
        return orig(a, *axes)
    JMOE.shard = catch
    try:
        fn = jax.jit(jax.value_and_grad(
            JT.make_loss_fn(cj, JT.TrainStepConfig()), has_aux=True))
        (total, aux), g = fn(pj, _jbatch(batches[0]))
        jax.block_until_ready(g)
        jax.effects_barrier()
    finally:
        JMOE.shard = orig
    return (float(total), {k: float(v) for k, v in aux.items()},
            tree_np(g), seen)


def _setups():
    return {arch: (tree_np(_setup(arch)[1]), _setup(arch)[2])
            for arch in R.DEPTH}


def _cases(mesh):
    return tuple(c[1:] for c in CASES if c[0] == mesh)


@pytest.fixture(scope="module")
def model2(tmp_path_factory, cli):
    """One world of model:2 ranks (the CLI runs started before it): the
    train cases, the gradient cases, the ops, the remat replay and the
    checkpoints (R.model2_world)."""
    d = str(tmp_path_factory.mktemp("tp_moe_ckpt") / "m2")
    _, ck_params, ck_batches = _setup(R.CK_ARCH, f32=False)
    ranks = R.spawn(R.model2_world, 2, _cases("model:2"), tuple(GRADS),
                    _setups(), LR, tree_np(ck_params), ck_batches, d)
    return {"ranks": ranks, "ckpt": d, "params": tree_np(ck_params)}


@pytest.fixture(scope="module")
def data2model2():
    return R.spawn(R.train_world, 4, MESHES["data:2,model:2"],
                   _cases("data:2,model:2"), _setups(), LR)


def _train_results(request, mesh):
    if mesh == "model:2":
        return [r["train"] for r in request.getfixturevalue("model2")
                ["ranks"]]
    return request.getfixturevalue("data2model2")


def _mesh_of(shape, coords):
    return LM.Mesh(axis_names=tuple(shape), shape=dict(shape),
                   coords=dict(coords))


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_moe_train_steps_on_a_model_axis_match_reference(case, request):
    """Two steps from the same params: loss, grad_norm, lr and both aux
    losses, and every parameter after the steps (gathered: experts and
    router columns back in order, a GLU `wi` in [gate | val]), against the
    reference's jitted one-device steps; each rank's wi its layout's
    shard. A data rank computes the load-balance loss over its own rows
    of each microbatch (a product of two means over them), as one device
    does over a microbatch of those rows: so the reference runs at the
    microbatches times the data axis, whose microbatches are the data
    ranks' rows in order (runtime.schedule.data_rows)."""
    mesh, arch, ep, sched, kind, remat = case
    cfg = R.cfg_of(arch)
    E, F2 = cfg.n_experts, 2 * cfg.d_ff
    dp = MESHES[mesh].get("data", 1)
    want_p, want_m = _reference_run(arch, kind,
                                    (2 if sched == "scan" else 1) * dp)
    d = cfg.d_model // dp                                # FSDP over data
    for res in _train_results(request, mesh):
        out = res[case[1:]]
        assert out["schedule"] == sched
        assert out["wi"] == ((R.DEPTH[arch], E // 2, d, F2) if ep
                             else (R.DEPTH[arch], E, d, F2 // 2))
        for got, want in zip(out["metrics"], want_m):
            for k in ("loss", "grad_norm", "lr", "lb_loss", "z_loss"):
                assert got[k] == pytest.approx(want[k], rel=TOL_METRIC), k
        if out["params"] is None:
            continue
        got_l, want_l = (jax.tree.leaves(out["params"]),
                         jax.tree.leaves(want_p))
        assert len(got_l) == len(want_l) > 0
        for g, w in zip(got_l, want_l):
            np.testing.assert_allclose(g, w, atol=TOL_PARAM)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_replicated_leaves_bit_identical_across_model_ranks(mesh,
                                                                request):
    """After two steps, every leaf the model axis does not split (the
    norms; under TP the router too) is the same bits on every rank of a
    model group: its gradient arrives equal there (the gates' gradient
    summed before the router, the aux losses' not)."""
    ranks = _train_results(request, mesh)
    for case in _cases(mesh):
        by_data = {}
        for r in ranks:
            res = r[case]
            by_data.setdefault(res["coords"].get("data", 0), []).append(
                res["whole"])
        for group in by_data.values():
            assert len(group) == 2 and len(group[0]) > 0
            for a, b in zip(*group):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# One loss's gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,ep", GRADS, ids=_ids(GRADS))
def test_moe_gradients_on_a_model_axis_match_reference(arch, ep, model2):
    """One loss on the first batch: the total and both aux losses on every
    rank equal to the reference's; each rank's gradient of every leaf it
    holds against its slice of the reference's gradient (an EP rank's
    router its E / 2 columns, a TP rank's the whole router); the routers'
    gradient norm (runtime.schedule.router_grad_norm) the reference's."""
    cfg = R.cfg_of(arch)
    total, metrics, want, _ = _reference_grads(arch)
    want_router = np.sqrt(sum(
        float((w.astype(np.float64) ** 2).sum())
        for (path, w) in tree_paths(want) if path[-1] == "router"))
    for r in model2["ranks"]:
        res = r["grads"][arch, ep]
        assert res["total"] == pytest.approx(total, rel=TOL_METRIC)
        for k in ("loss", "lb_loss", "z_loss"):
            assert res["metrics"][k] == pytest.approx(metrics[k],
                                                      rel=TOL_METRIC), k
        assert res["router_norm"] == pytest.approx(want_router,
                                                   rel=TOL_METRIC)
        mesh = _mesh_of({"model": 2}, res["coords"])
        specs = R.specs_of(cfg, mesh, ep)
        mine = dict(tree_paths(R.rank_slices(want, specs, mesh)))
        n_router = 0
        assert len(mine) == len(tree_leaves(res["grads"]))
        for path, g in tree_paths(res["grads"]):
            w = mine[path]
            assert g.shape == w.shape, path
            scale = max(float(np.abs(w).max()), 1.0)
            assert float(np.abs(g - w).max()) <= TOL_GRAD * scale, path
            if path[-1] == "router":
                n_router += 1
                assert g.shape[-1] == (cfg.n_experts // 2 if ep
                                       else cfg.n_experts), path
                assert float(np.abs(w).max()) > 0.0, path
        assert n_router == len(cfg.unit)


@pytest.mark.parametrize("arch", list(R.DEPTH))
def test_moe_dispatch_masks_on_every_rank_equal_reference(arch, model2):
    """The dispatch mask of every routing call of the loss, on every rank
    under both layouts, equal to the reference's, exactly: routing is
    replicated (an EP rank gathers the router's columns first)."""
    want = _reference_grads(arch)[3]
    assert len(want) == R.DEPTH[arch] * len(R.cfg_of(arch).unit)
    for r in model2["ranks"]:
        for ep in (True, False):
            got = r["grads"][arch, ep]["dispatch"]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w.astype(np.float32))


def test_moe_ops_forward_plain_collectives_backward_transposed(model2):
    for r in model2["ranks"]:
        assert r["ops"] == {"router_gather": True,
                            "router_grad_slice": True,
                            "gate_forward": True, "gate_grad_sum": True}


def test_forced_routes_under_remat_take_the_forward_entries(model2):
    """Under remat "full" every layer routes twice a microbatch (its
    forward, its recompute in the backward), each time under the same
    (step, microbatch, layer) key, so the forced run takes the same tape
    entries as the run without remat, and its own routes and metrics are
    that run's."""
    for r in model2["ranks"]:
        res = r["remat"]
        plain, remat = res["keys_plain"], res["keys_remat"]
        assert len(plain) == 2 * 2 * R.DEPTH["mixtral-8x7b"]
        assert len(set(plain)) == len(plain)
        assert len(remat) == 2 * len(plain)
        assert sorted(set(remat), key=repr) == sorted(plain, key=repr)
        assert res["same_routes"]
        for a, b in zip(res["metrics_plain"], res["metrics_remat"]):
            for k in ("loss", "grad_norm", "router_grad_norm"):
                assert b[k] == pytest.approx(a[k], rel=TOL_METRIC), k


# ---------------------------------------------------------------------------
# The train CLI
# ---------------------------------------------------------------------------

CLI = ("--arch mixtral-8x7b --reduced --depth 2 --seq 32 --batch 4 "
       "--steps 3 --log-every 1 --remat none --microbatches 1 "
       "--optimizer adafactor --device cpu")


def _start_cli(*extra):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI.split(),
         *extra], env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish_cli(name, p):
    o, e = p.communicate(timeout=R.TIMEOUT)
    assert p.returncode == 0, (name, e[-3000:])
    return o


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The one-device CLI and `--mesh model:2` (writing its routes),
    started side by side before the worlds of ranks; the test waits for
    them and then has one device replay the ranks' routes."""
    tmp = str(tmp_path_factory.mktemp("moe_cli"))
    procs = {"one": _start_cli(),
             "model:2": _start_cli("--mesh", "model:2", "--routes-out",
                                   os.path.join(tmp, "ranks.pt"))}
    yield tmp, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _final(out):
    return float(re.search(r"final loss ([0-9.]+)", out).group(1))


def test_cli_trains_mixtral_on_model2_as_one_device(cli):
    """The CLI's final loss on model:2 (EP: ep=True in its plan) within
    2e-2 of the one-device CLI's (bf16 weights); one rank line a rank with
    equal model-whole fingerprints and routes digests, the state apart;
    the step lines carry the routers' gradient norm; one device replaying
    the ranks' routes takes every (step, layer) entry of their tape."""
    tmp, procs = cli
    out = {k: _finish_cli(k, p) for k, p in procs.items()}
    ranks_routes, one_routes = (os.path.join(tmp, f) for f in
                                ("ranks.pt", "one.pt"))
    out["replay"] = _finish_cli("replay", _start_cli(
        "--replay-routes", ranks_routes, "--routes-out", one_routes))
    m2 = out["model:2"]
    for name in ("model:2", "replay"):
        assert _final(out[name]) == pytest.approx(_final(out["one"]),
                                                  rel=2e-2), name
    assert "ep=True" in m2 and m2.count("final loss") == 1
    assert len(re.findall(r"^step +\d+ loss=.* router_gnorm=[0-9.e+-]+$",
                          m2, re.M)) == 3
    rows = re.findall(r"^rank (\d+): param elements [0-9,]+;.*state "
                      r"fingerprint (\w+); model-whole fingerprint (\w+); "
                      r"routes digest (\w+)$", m2, re.M)
    assert [int(r[0]) for r in rows] == [0, 1]
    assert rows[0][2:] == rows[1][2:] and rows[0][1] != rows[1][1]
    ranks, one = torch.load(ranks_routes), torch.load(one_routes)
    assert len(ranks) == 3 * 2 and sorted(ranks, key=repr) == sorted(
        one, key=repr)
    assert {k[0] for k in ranks} == {("step", i) for i in range(3)}


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _target(cfg):
    p = init_params(torch.Generator().manual_seed(9), cfg, "cpu")
    return {"params": p, "opt": TO.init_state(R.CK_OPT, p)}


def _specs(cfg, mesh, ep):
    specs = R.specs_of(cfg, mesh, ep)
    return {"params": specs, "opt": TO.state_specs(R.CK_OPT, specs)}


def _assert_equal_trees(got, want):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l) > 0
    for g, w in zip(got_l, want_l):
        np.testing.assert_array_equal(g, w)


def test_moe_checkpoint_restores_across_expert_layouts(model2):
    """model:2 under EP saved after two Adafactor steps (bf16), written
    whole: its one-device restore, cut as each rank's EP shards, equals
    what each rank held, bit for bit; the data:2 ranks' restore and the
    restore onto model:2 under TP inside the experts (wi every expert's
    [gate_r | val_r] columns) equal their slices of it; the reference
    restores the same params."""
    cfg = R.cfg_of(R.CK_ARCH, f32=False)
    full, manifest = CK.restore(model2["ckpt"], _target(cfg), device="cpu")
    assert manifest["extra"] == {"step": 2}
    full = to_numpy(full)
    for r in model2["ranks"]:
        ck = r["ckpt"]
        m = _mesh_of({"model": 2}, ck["coords_m"])
        d = _mesh_of({"data": 2}, ck["coords_d"])
        for mesh, ep, got in ((m, True, ck["saved"]), (d, True,
                                                       ck["on_data"]),
                              (m, False, ck["on_tp"])):
            _assert_equal_trees(got, R.rank_slices(full, _specs(cfg, mesh,
                                                                ep), mesh))
        assert ck["wi_tp"] == (R.DEPTH[R.CK_ARCH], cfg.n_experts,
                               cfg.d_model, cfg.d_ff)
    _, pj, _ = _setup(R.CK_ARCH, f32=False)
    back, _ = JCK.restore(model2["ckpt"], {
        "params": pj, "opt": JO.init_state(JO.OptimizerConfig(
            kind="adafactor"), pj)})
    _assert_equal_trees(tree_np(back["params"]), full["params"])


# ---------------------------------------------------------------------------
# The training check, the spec trees, the predictor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(R.DEPTH))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_training_check_accepts_moe_on_a_model_axis(mesh, arch):
    """Both archs at full size pass the training check on model:2 and
    data:2,model:2 (no reason names the MoE blocks); recurrent blocks and
    a sequence-sharded cache are still refused, naming queue A item 5."""
    shape = MESHES[mesh]
    SCH.check_training_mesh(get_config(arch), shape)
    assert SCH.model_axis_problems(get_config(arch), 2) == []
    for other, kv, phrase in (("xlstm-1.3b", "heads", "recurrent blocks"),
                              (arch, "seq", "kv_shard='seq'")):
        with pytest.raises(NotImplementedError,
                           match=f"{re.escape(phrase)}.*queue A item 5"):
            SCH.check_training_mesh(get_config(other), shape, kv)


def _spec_tuple(s):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in s)


@pytest.mark.parametrize("ep", [True, False], ids=["ep", "tp"])
@pytest.mark.parametrize("arch", list(R.DEPTH))
def test_moe_spec_trees_match_reference_on_data2model2(arch, ep):
    """The port's spec tree under Strategy(ep) on {data: 2, model: 2} (the
    stacked 4-D expert leaves [repeats, E, d, 2f] among them: EP the
    experts over model, d over data; TP the last dim over model) equals
    the reference's PartitionSpecs leaf by leaf; each rank's shards tile
    the whole leaf."""
    cfg = get_config(arch)
    shape = MESHES["data:2,model:2"]
    mesh = _mesh_of(shape, {"data": 0, "model": 0})
    got = S.param_specs(cfg, init_params(None, cfg, device="meta"),
                        S.Strategy(ep=ep), mesh)
    cj = jax_get_config(arch)
    want = JSH.param_specs(cj, abstract_params(cj), JSH.Strategy(ep=ep),
                           mesh)
    got_l = sorted(("//".join(str(k) for k in path), _spec_tuple(spec))
                   for path, spec in tree_paths(got))
    want_l = sorted(
        ("//".join(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path), _spec_tuple(tuple(spec)))
        for path, spec in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0])
    assert len(got_l) > 0 and got_l == want_l
    wi = got["units"][0]["mlp"]["wi"]
    assert tuple(wi) == (((None, "model", "data", None)) if ep
                         else (None, None, "data", "model"))


@pytest.mark.parametrize("arch", list(R.DEPTH))
def test_moe_per_device_figures_equal_reference(arch):
    """sharded_param_count and the resident / transient bytes of a train
    step, per device on model:2 and data:2,model:2 (the mesh, not the
    expert layout, sizes them), equal the reference's arithmetic."""
    cfg, cj = get_config(arch), jax_get_config(arch)
    for shape in MESHES.values():
        assert TPR.sharded_param_count(cfg, shape) == \
            JPR.sharded_param_count(cj, shape)
        for opt in ("adamw_f32", "adafactor"):
            plan_t = TPR.MemoryPlan(optimizer=opt)
            plan_j = JPR.MemoryPlan(optimizer=opt)
            st = TShape("t", "train", 2048, 2)
            sj = JShape("t", "train", 2048, 2)
            assert TPR.resident_bytes(cfg, st, plan_t, shape) == \
                JPR.resident_bytes(cj, sj, plan_j, shape)
