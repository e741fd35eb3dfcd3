"""Training on a mesh of gloo ranks over the CPU, against the reference
package: make_train_step steps on data:2 (FSDP) and on pipe:2 (the 1F1B
pipeline), under adamw_f32 and Adafactor (whose factored moments reduce
across shards and stages: trap F7), against the reference's jitted
one-device step; compressed_psum's bound and unbiasedness; a checkpoint
saved from data:2 restoring onto pipe:2 and onto one device bit for bit,
and in the reference; the training CLI on data:2 and data:2,pipe:2 (the
twin of tests/test_train_pipeline.py::test_forced_pipe_matches_flat_final_
loss); ExecutionPlan.build over a live world; and the refusals."""
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
from repro.runtime import train_step as JT
from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config
from repro_torch.convert import to_numpy
from repro_torch.launch import mesh as LM
from repro_torch.models import init_params
from repro_torch.optim import optimizers as TO
from repro_torch.parallel import sharding as S
from repro_torch.runtime import schedule as SCH
from repro_torch.runtime.train_step import TrainStepConfig

from _torch_parity import tree_np
import _torch_mesh_ranks as R

ARCH = "h2o-danube-1.8b"
B, SEQ = 4, 32
# the tolerances of tests/test_torch_train.py's train steps
LR = 1e-3
TOL_PARAM = 2e-5
TOL_METRIC = 1e-5
ROOT = os.path.join(os.path.dirname(__file__), "..")


@functools.lru_cache(maxsize=1)
def _setup():
    cj = dataclasses.replace(jax_depth(jax_get_config(ARCH).reduced(), 2),
                             param_dtype="float32")
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    rng = np.random.default_rng(11)
    batches = [{k: rng.integers(2, cj.vocab_size, (B, SEQ)).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(2)]
    return cj, pj, batches


@functools.lru_cache(maxsize=None)
def _reference_run(kind, micro):
    cj, pj, batches = _setup()
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


@pytest.mark.parametrize("mesh,micro,schedule,remat,kinds", [
    ({"data": 2}, 1, "single", "none", ("adamw_f32", "adafactor")),
    ({"pipe": 2}, 2, "pipeline_1f1b", "none", ("adamw_f32", "adafactor")),
    ({"data": 2}, 2, "scan", "full", ("adamw_f32",)),
    ({"pipe": 2}, 2, "pipeline_1f1b", "dots", ("adamw_f32",))])
def test_train_steps_on_a_mesh_match_reference(mesh, micro, schedule, remat,
                                               kinds):
    """Two steps from the same params, under adamw_f32 and adafactor (and
    under remat, whose recompute gathers a unit's shards again): loss,
    grad_norm and lr, and every parameter after the steps (gathered),
    against the reference's one-device steps at the same microbatches."""
    cj, pj, batches = _setup()
    out = R.spawn(R.train_steps, 2, ARCH, 2, tree_np(pj), batches, mesh,
                  micro, kinds, LR, remat)[0]
    for kind in kinds:
        want_p, want_m = _reference_run(kind, micro)
        assert out[kind]["schedule"] == schedule
        for got, want in zip(out[kind]["metrics"], want_m):
            for k in ("loss", "grad_norm", "lr"):
                assert got[k] == pytest.approx(want[k], rel=TOL_METRIC), \
                    (kind, k)
        got_l, want_l = (jax.tree.leaves(out[kind]["params"]),
                         jax.tree.leaves(want_p))
        assert len(got_l) == len(want_l) > 0
        for g, w in zip(got_l, want_l):
            np.testing.assert_allclose(g, w, atol=TOL_PARAM, err_msg=kind)


def test_compressed_psum_bound_and_unbiased():
    """One call is within 1.5 x scale of the exact mean (the reference
    test's bound); the mean over 200 generators is within a quarter of the
    scale of it (a rounding toward zero or down would be off by half)."""
    for res in R.spawn(R.psum_case, 2, 200):
        assert res["err"] <= 1.5 * res["scale"] + 1e-6
        assert res["bias"] <= 0.25 * res["scale"]


def test_checkpoint_from_data2_restores_onto_pipe2_one_device_and_reference(
        tmp_path):
    cj = jax_depth(jax_get_config(ARCH).reduced(), 2)
    pj = jax_init_params(jax.random.PRNGKey(3), cj)
    ckdir = str(tmp_path / "ck")
    R.spawn(R.save_sharded, 2, ARCH, 2, tree_np(pj), ckdir, 7)
    assert CK.latest_step(ckdir) == 7
    # one device: the whole tree, bit for bit
    ct = R.cfg_of(ARCH, 2, f32=False)
    ocfg = TO.OptimizerConfig(kind="adafactor")
    p0 = init_params(torch.Generator().manual_seed(9), ct, "cpu")
    full, manifest = CK.restore(ckdir, {"params": p0,
                                        "opt": TO.init_state(ocfg, p0)},
                                device="cpu")
    assert manifest["extra"] == {"step": 7}
    full = to_numpy(full)
    for g, w in zip(jax.tree.leaves(full["params"]),
                    jax.tree.leaves(tree_np(pj))):
        np.testing.assert_array_equal(g, w)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            full["opt"]["f"])[0]:
        np.testing.assert_array_equal(leaf, np.full(leaf.shape, 0.25,
                                                    np.float32))
    # pipe:2: each rank's leaves are the slices of the one-device restore
    for res in R.spawn(R.restore_sharded, 2, ARCH, 2, ckdir, {"pipe": 2}):
        mesh = LM.Mesh(axis_names=("pipe",), shape={"pipe": 2},
                       coords=res["coords"])
        assert res["step"] == 7
        got = jax.tree.leaves(res["tree"])
        specs = jax.tree.leaves(res["specs"],
                                is_leaf=lambda x: isinstance(x, tuple))
        want = jax.tree.leaves(full)
        assert len(got) == len(specs) == len(want)
        for g, s, w in zip(got, specs, want):
            np.testing.assert_array_equal(g, S.local_slice(w, s, mesh))
    # the reference reads what the mesh wrote
    target = {"params": pj, "opt": JO.init_state(
        JO.OptimizerConfig(kind="adafactor"), pj)}
    back, _ = JCK.restore(ckdir, target)
    for g, w in zip(jax.tree.leaves(tree_np(back["params"])),
                    jax.tree.leaves(tree_np(pj))):
        np.testing.assert_array_equal(g, w)


COMMON = ("--arch h2o-danube-1.8b --reduced --depth 4 --seq 32 --batch 8 "
          "--steps 5 --log-every 1 --remat none --microbatches 4 "
          "--optimizer adamw_f32 --device cpu")


def _train(mesh):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *COMMON.split(), "--mesh", mesh], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=R.TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_cli_forced_pipe_matches_flat_final_loss():
    out_flat = _train("data:2")
    out_pipe = _train("data:2,pipe:2")
    assert "schedule=scan" in out_flat
    assert "schedule=pipeline_1f1b" in out_pipe
    finals = [float(re.search(r"final loss ([0-9.]+)", o).group(1))
              for o in (out_flat, out_pipe)]
    assert finals[1] == pytest.approx(finals[0], rel=2e-2)
    assert "done: 5 steps" in out_pipe
    # one line a rank, printed by rank 0 alone
    ranks = re.findall(r"^rank (\d): param elements ([0-9,]+);", out_pipe,
                       re.M)
    assert [int(r) for r, _ in ranks] == [0, 1, 2, 3]
    assert out_pipe.count("final loss") == 1


def test_execution_plan_builds_over_a_live_world():
    out = R.spawn(R.build_live, 2)
    for res in out:
        assert res["axes"] == ("data",) and res["shape"] == {"data": 2}
        assert res["groups"] == ["data"] and res["fsdp"]
        assert "needs 4 devices; only 2 available" in res["refusal"]
    assert [r["coords"]["data"] for r in out] == [0, 1]


def test_refusals():
    """A model axis above 1 over recurrent blocks is not ported (training
    on a model axis is, MoE blocks included: tests/test_torch_tp_train.py,
    tests/test_torch_tp_moe_train.py); nccl never carries more ranks than
    devices, or CPU ranks, and is refused before a process starts."""
    cfg = get_config("xlstm-1.3b").reduced()
    mesh = LM.Mesh(axis_names=("data", "model"),
                   shape={"data": 1, "model": 2}, coords={"data": 0,
                                                          "model": 0},
                   groups={})
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        SCH.make_train_step(cfg, TrainStepConfig(), mesh=mesh, spec_tree={})
    with pytest.raises(ValueError, match="nccl needs CUDA ranks"):
        LM.spawn_ranks(R.build_live, 2, "nccl", "cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="one device per rank"):
            LM.check_backend("nccl", 2, "cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        LM.spawn_ranks(R.build_live, 2, "mpi", "cpu")
