"""Training tensor-parallel over a `model` axis, against the reference
package's one-device step: gloo ranks over the CPU ({model: 2} and
{data: 2, model: 2}, spawned by launch.mesh.spawn_ranks; rank functions in
tests/_torch_tp_train_ranks.py). make_train_step's single and scan
schedules under adamw_f32 and Adafactor, remat none and full, for
h2o-danube-1.8b, mistral-nemo-12b and gemma3-12b (a tied table and a
soft-capped head) against the reference's jitted step; the leaves the
model axis holds whole bit-identical across its ranks; each tensor-
parallel autograd op's block against one rank's gradients, and its
forward against the plain collective; the train CLI on `--mesh model:2`,
`--mesh data:2,model:2` and `--model-parallel 2` against the one-device
CLI; checkpoints of a model:2 layout (a GLU `wi` cut half by half)
restoring onto one device, data:2 and the reference, and a data:2
checkpoint onto model:2, bit for bit; and the refusals that stay."""
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
from repro.configs.base import depth_variant as jax_depth
from repro.models import init_params as jax_init_params
from repro.optim import optimizers as JO
from repro.runtime import schedule as JSCH
from repro.runtime import train_step as JT
from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config
from repro_torch.convert import to_numpy
from repro_torch.launch import mesh as LM
from repro_torch.launch import train as LT
from repro_torch.models import init_params
from repro_torch.optim import optimizers as TO
from repro_torch.runtime import schedule as SCH
from repro_torch.runtime.train_step import TrainStepConfig

from _torch_parity import tree_np
import _torch_tp_train_ranks as R

B, SEQ = 4, 32
# the tolerances of tests/test_torch_mesh_train.py's train steps
LR = 1e-3
TOL_PARAM = 2e-5
TOL_METRIC = 1e-5
# a block's gradients on model:2 against one rank's: f32 sums in another
# order (the row-parallel partial products, the entry op's sum)
TOL_GRAD = 1e-5
ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"model:2": {"model": 2}, "data:2,model:2": {"data": 2, "model": 2}}

# (mesh, arch, schedule, optimizer, remat): on each mesh every arch runs
# both schedules, both optimizers and both remat policies
CASES = [(mesh, arch, sched, kind, remat)
         for mesh, flip in (("model:2", 0), ("data:2,model:2", 1))
         for arch in R.DEPTH
         for sched, kind, remat in (
             (("single", "adamw_f32", "none"), ("scan", "adafactor", "full"))
             if (arch != "mistral-nemo-12b") != bool(flip) else
             (("single", "adafactor", "full"), ("scan", "adamw_f32", "none")))]


@functools.lru_cache(maxsize=None)
def _setup(arch, f32=True):
    cj = jax_depth(jax_get_config(arch).reduced(), R.DEPTH[arch])
    if f32:
        cj = dataclasses.replace(cj, param_dtype="float32")
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    rng = np.random.default_rng(11)
    batches = [{k: rng.integers(2, cj.vocab_size, (B, SEQ)).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(2)]
    return cj, pj, batches


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
        p, st, m = step(p, st, {k: jnp.asarray(v) for k, v in b.items()},
                        jnp.asarray(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return tree_np(p), metrics


def _setups():
    return {arch: (tree_np(_setup(arch)[1]), _setup(arch)[2])
            for arch in R.DEPTH}


def _cases(mesh):
    return tuple(c[1:] for c in CASES if c[0] == mesh)


@pytest.fixture(scope="module")
def model2(tmp_path_factory):
    """One world of model:2 ranks: the model:2 train cases, the blocks,
    the op forwards and the checkpoints (R.model2_world)."""
    d = tmp_path_factory.mktemp("tp_ckpt")
    _, ck_params, ck_batches = _setup(R.CK_ARCH, f32=False)
    ranks = R.spawn(R.model2_world, 2, _cases("model:2"), _setups(), LR,
                    tree_np(ck_params), ck_batches, str(d / "m2"),
                    str(d / "d2"))
    return {"ranks": ranks, "ckpt_m": str(d / "m2"), "ckpt_d": str(d / "d2"),
            "params": tree_np(ck_params)}


@pytest.fixture(scope="module")
def data2model2():
    return R.spawn(R.train_world, 4, MESHES["data:2,model:2"],
                   _cases("data:2,model:2"), _setups(), LR)


def _train_results(request, mesh):
    if mesh == "model:2":
        return [r["train"] for r in request.getfixturevalue("model2")
                ["ranks"]]
    return request.getfixturevalue("data2model2")


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_train_steps_on_a_model_axis_match_reference(case, request):
    """Two steps from the same params: loss, grad_norm and lr, and every
    parameter after the steps (gathered: a GLU `wi` back in [gate | val]),
    against the reference's jitted one-device steps at the same
    microbatches (remat changes no value there)."""
    mesh, arch, sched, kind, remat = case
    out = _train_results(request, mesh)[0][case[1:]]
    want_p, want_m = _reference_run(arch, kind, 2 if sched == "scan" else 1)
    assert out["schedule"] == sched
    for got, want in zip(out["metrics"], want_m):
        for k in ("loss", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=TOL_METRIC), k
    got_l, want_l = (jax.tree.leaves(out["params"]),
                     jax.tree.leaves(want_p))
    assert len(got_l) == len(want_l) > 0
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, atol=TOL_PARAM)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_replicated_leaves_bit_identical_across_model_ranks(mesh, request):
    """After two steps, every leaf the model axis does not split (the
    norms) is the same bits on every rank of a model group: their
    gradients arrive equal there (no sum over the model axis)."""
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
# The autograd ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", R.BLOCKS)
def test_autograd_op_block_matches_one_rank(block, model2):
    """The block's loss, its input's gradient and each weight shard's
    gradient on model:2, against the same block on one rank (its
    gradients sliced as the shards are): "mlp" and "attention" (the entry
    op on the normed input, the row-parallel sum), "head" (gemma3-12b's
    tied, soft-capped head: the entry op and the vocab gather under the
    cross entropy), "embed" (the vocab-sharded lookup's sum)."""
    for r in model2["ranks"]:
        res = r["blocks"][block]
        assert "loss" in res and len(res) >= 2
        for name, (diff, scale) in res.items():
            assert diff <= TOL_GRAD * max(scale, 1.0), (block, name, diff)


def test_op_forwards_are_the_plain_collectives(model2):
    for r in model2["ranks"]:
        assert r["ops"] == {"tp_sum": True, "tp_enter": True,
                            "tp_gather_last": True}


# ---------------------------------------------------------------------------
# The train CLI
# ---------------------------------------------------------------------------

CLI = ("--arch h2o-danube-1.8b --reduced --depth 2 --seq 32 --batch 8 "
       "--steps 4 --log-every 1 --remat none --microbatches 1 "
       "--optimizer adamw_f32 --device cpu")
CLI_RUNS = {"one": [], "model:2": ["--mesh", "model:2"],
            "data:2,model:2": ["--mesh", "data:2,model:2"],
            "--model-parallel 2": ["--model-parallel", "2"]}


@functools.lru_cache(maxsize=1)
def _cli():
    """Every CLI run, started together: {name: stdout}."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI.split(),
         *extra], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, extra in CLI_RUNS.items()}
    out = {}
    for k, p in procs.items():
        o, e = p.communicate(timeout=R.TIMEOUT)
        assert p.returncode == 0, (k, e[-3000:])
        out[k] = o
    return out


def _final(out):
    return float(re.search(r"final loss ([0-9.]+)", out).group(1))


@pytest.mark.parametrize("run", [k for k in CLI_RUNS if k != "one"])
def test_cli_on_a_model_axis_matches_one_device_final_loss(run):
    """The CLI's final loss on the model axis equals the one-device CLI's
    (the twin of test_cli_forced_pipe_matches_flat_final_loss; bf16
    weights, so the rounding of the f32 partial sums shows); one rank line
    a rank, printed by rank 0 alone; the leaves the model axis holds
    whole with one fingerprint on a model group's ranks; one plan on every
    rank. `--model-parallel 2` is the host mesh {data: 1, model: 2}: the
    same run as `--mesh model:2`."""
    outs = _cli()
    out = outs[run]
    assert _final(out) == pytest.approx(_final(outs["one"]), rel=2e-2)
    assert out.count("final loss") == 1 and "done: 4 steps" in out
    rows = re.findall(r"^rank (\d+): param elements [0-9,]+;.*state "
                      r"fingerprint (\w+); model-whole fingerprint (\w+)$",
                      out, re.M)
    n = 4 if run == "data:2,model:2" else 2
    assert [int(r) for r, _, _ in rows] == list(range(n))
    for d in range(n // 2):
        assert rows[2 * d][2] == rows[2 * d + 1][2]
        assert rows[2 * d][1] != rows[2 * d + 1][1]   # the shards differ
    plans = re.findall(r"^rank \d+ plan: (.*)$", out, re.M)
    assert len(plans) == n and len(set(plans)) == 1
    if run == "--model-parallel 2":
        assert "mesh={'data': 1, 'model': 2}" in out
        assert _final(out) == _final(outs["model:2"])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _target(cfg):
    p = init_params(torch.Generator().manual_seed(9), cfg, "cpu")
    return {"params": p, "opt": TO.init_state(R.CK_OPT, p)}


def _specs(cfg, mesh):
    specs = R.specs_of(cfg, mesh)
    return {"params": specs, "opt": TO.state_specs(R.CK_OPT, specs)}


def _assert_equal_trees(got, want):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l) > 0
    for g, w in zip(got_l, want_l):
        np.testing.assert_array_equal(g, w)


def test_checkpoint_from_model2_restores_onto_one_device_data2_and_reference(
        model2):
    """model:2 saved after two steps: the one-device restore, cut as each
    rank's shards (a GLU `wi` and its column moment half by half), equals
    what each rank held, bit for bit; the data:2 ranks' restore equals its
    slices; the reference restores the same params."""
    cfg = R.cfg_of(R.CK_ARCH, f32=False)
    full, manifest = CK.restore(model2["ckpt_m"], _target(cfg),
                                device="cpu")
    assert manifest["extra"] == {"step": 2}
    full = to_numpy(full)
    for r in model2["ranks"]:
        ck = r["ckpt"]
        for mesh, got in ((LM.Mesh(axis_names=("model",), shape={"model": 2},
                                   coords=ck["coords_m"]), ck["saved"]),
                          (LM.Mesh(axis_names=("data",), shape={"data": 2},
                                   coords=ck["coords_d"]), ck["on_data"])):
            _assert_equal_trees(got, R.rank_slices(full, _specs(cfg, mesh),
                                                   mesh))
    cj, pj, _ = _setup(R.CK_ARCH, f32=False)
    back, _ = JCK.restore(model2["ckpt_m"], {
        "params": pj, "opt": JO.init_state(JO.OptimizerConfig(
            kind="adafactor"), pj)})
    _assert_equal_trees(tree_np(back["params"]), full["params"])


def test_checkpoint_from_data2_restores_onto_model2(model2):
    cfg = R.cfg_of(R.CK_ARCH, f32=False)
    full, manifest = CK.restore(model2["ckpt_d"], _target(cfg),
                                device="cpu")
    assert manifest["step"] == 5
    full = to_numpy(full)
    _assert_equal_trees(full["params"], model2["params"])
    for r in model2["ranks"]:
        ck = r["ckpt"]
        mesh = LM.Mesh(axis_names=("model",), shape={"model": 2},
                       coords=ck["coords_m"])
        _assert_equal_trees(ck["on_model"],
                            R.rank_slices(full, _specs(cfg, mesh), mesh))


# ---------------------------------------------------------------------------
# The refusals that stay
# ---------------------------------------------------------------------------

# (arch, reduced, model axis, kv_shard, a phrase of the reason)
REFUSALS = [
    ("mixtral-8x7b", True, 2, "heads", "MoE blocks"),
    ("xlstm-1.3b", True, 2, "heads", "recurrent blocks"),
    ("nemotron-4-340b", False, 16, "heads", "kv_shard='seq'"),
    ("h2o-danube-1.8b", False, 2, "seq", "kv_shard='seq'"),
    ("musicgen-medium", False, 16, "heads", "query heads"),
    ("h2o-danube-1.8b", False, 5, "heads", "d_ff of 6912"),
    ("h2o-danube-1.8b", False, 3, "heads", "padded vocab of 32000")]


@pytest.mark.parametrize("case", REFUSALS, ids=[c[-1] for c in REFUSALS])
def test_refusals_that_stay(case):
    """Each still raises, naming ROADMAP queue A item 5: make_train_step
    on the mesh, with the shared predicate's first reason. The MoE blocks'
    refusal is lifted (tests/test_torch_tp_moe_train.py trains them): no
    reason names them, and the training check passes reduced mixtral-8x7b
    on the axis, alone or beside a data axis."""
    arch, reduced, m, kv, phrase = case
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    problems = SCH.model_axis_problems(cfg, m, kv)
    # serving and training read the same list
    assert SCH.serving_mesh_problems(cfg, {"model": m}, kv) == problems
    if phrase == "MoE blocks":
        assert problems == []
        SCH.check_training_mesh(cfg, {"model": m}, kv)
        SCH.check_training_mesh(cfg, {"data": 2, "model": m}, kv)
        return
    assert any(phrase in p and "queue A item 5" in p for p in problems), \
        problems
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        SCH.check_training_mesh(cfg, {"model": m}, kv)
    if kv == "heads":
        mesh = LM.Mesh(axis_names=("model",), shape={"model": m},
                       coords={"model": 0}, groups={})
        with pytest.raises(NotImplementedError, match="queue A item 5"):
            SCH.make_train_step(cfg, TrainStepConfig(), mesh=mesh,
                                spec_tree={})


def test_pipe_with_model_refused_as_the_reference():
    """A model axis inside the 1F1B pipeline: the reference's refusal
    (runtime/schedule_kinds.py), word for word."""
    mesh_shape = {"pipe": 2, "model": 2}
    cfg = get_config("h2o-danube-1.8b").reduced()
    with pytest.raises(ValueError) as want:
        JSCH.validate_pipeline(jax_get_config("h2o-danube-1.8b").reduced(),
                               JT.TrainStepConfig(microbatches=2),
                               mesh_shape)
    mesh = LM.Mesh(axis_names=("pipe", "model"), shape=mesh_shape,
                   coords={"pipe": 0, "model": 0},
                   groups={"pipe": None, "model": None})
    with pytest.raises(ValueError) as got:
        SCH.make_train_step(cfg, TrainStepConfig(microbatches=2), mesh=mesh,
                            spec_tree={})
    assert str(got.value) == str(want.value)
    assert "model axis > 1" in str(got.value)


def test_cli_refuses_before_any_rank_starts():
    argv = CLI.split() + ["--arch", "xlstm-1.3b"]
    for extra in (["--mesh", "model:2"], ["--model-parallel", "2"]):
        with pytest.raises(NotImplementedError, match="queue A item 5"):
            LT.main(argv + extra)
