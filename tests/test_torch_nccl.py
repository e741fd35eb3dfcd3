"""The parallel layer on nccl, with one card a rank: comm's collectives
against the same collectives over gloo, the training CLI on
data:2,pipe:2 (FSDP gathers, the 1F1B pipeline's sends, the gradient
reductions, the mesh checkpoint saved and resumed) against the same runs
over gloo, the serve CLI tensor-parallel on model:2 (the f32 partial
sums, the vocab gather, the retention's attention mass; a MoE arch's
experts split over the ranks) against the same run over gloo, and the
training CLI on model:2 (the collectives' backward; a MoE arch's router
gather and gates' gradient sum) against the same run over gloo. Needs
two (the collectives, the serve CLI, training on model:2) or four
(training on data:2,pipe:2) CUDA devices and skips without them; run on
a four-card machine with

    PYTHONPATH=src python -m pytest -q -s --noconftest -m cuda \
        tests/test_torch_nccl.py

This file imports no jax (--noconftest skips tests/conftest.py, which
imports it): it compares the port with itself."""
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import mesh as LM

import _torch_mesh_ranks as R

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ("--arch h2o-danube-1.8b --reduced --depth 4 --seq 256 --batch 8 "
       "--log-every 1 --remat none --microbatches 2 --optimizer adamw_f32 "
       "--device cuda --mesh data:2,pipe:2")
TIMEOUT = 300
SERVE = ("--arch mistral-nemo-12b --reduced --depth 2 --kv paged --compact "
         "--chunk-prefill 16 --kv-block 4 --kv-quant int8 --kv-retain 2 "
         "--requests 6 --prompt-lens 8,20,40 --gen-lens 4,12 --device cuda "
         "--model-parallel 2")
# training on model:2: h2o-danube-1.8b at 2 of its 24 layers, and reduced
# mixtral-8x7b under the plan's expert parallelism (4 experts, 2 a rank)
TRAIN_TP = ("--arch h2o-danube-1.8b --depth 2 --seq 512 --batch 2 "
            "--steps 3 --log-every 1 --remat none --microbatches 1 "
            "--optimizer adafactor --device cuda --mesh model:2")
TRAIN_MOE = ("--arch mixtral-8x7b --reduced --depth 2 --seq 256 --batch 4 "
             "--steps 3 --log-every 1 --remat none --microbatches 1 "
             "--optimizer adamw_f32 --device cuda --mesh model:2")
# reduced mixtral-8x7b on model:2 under the plan's expert parallelism
SERVE_MOE = ("--arch mixtral-8x7b --reduced --depth 2 --kv paged --compact "
             "--chunk-prefill 16 --kv-block 4 --requests 6 --prompt-lens "
             "8,20,40 --gen-lens 4,12 --device cuda --model-parallel 2")


def _cards(n):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} CUDA devices, {have} visible")


def test_nccl_collectives_equal_gloo_on_each_card():
    _cards(2)
    world = 4 if torch.cuda.device_count() >= 4 else 2
    out = LM.spawn_ranks(R.nccl_vs_gloo, world, "nccl", "cuda",
                         timeout=120)
    assert [r["device"] for r in out] == [f"cuda:{i}" for i in range(world)]
    for r in out:
        print(f"nccl_vs_gloo {r}")
        assert all(r["equal"]) and len(r["equal"]) == 9
        assert r["on_card"]
        assert r["staged"]["nccl"] == 0 and r["staged"]["gloo"] > 0


def _train(backend, steps, ckpt=None):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *CLI.split(),
           "--steps", str(steps), "--dist-backend", backend]
    if ckpt:
        cmd += ["--ckpt-dir", ckpt, "--ckpt-interval", "0"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=TIMEOUT)
    print(f"--- {backend}, {steps} steps\n{out.stdout}")
    assert out.returncode == 0, out.stderr[-4000:]
    losses = {int(s): float(v) for s, v in re.findall(
        r"^step +(\d+) loss=([0-9.]+)", out.stdout, re.M)}
    ranks = re.findall(r"^rank (\d): param elements ([0-9,]+);", out.stdout,
                       re.M)
    return out.stdout, losses, ranks


def test_nccl_mesh_trains_and_resumes_as_gloo(tmp_path):
    """3 steps on nccl saving a checkpoint, then a fourth step resumed from
    it, on nccl and on gloo: the same losses as 3 steps on gloo and the
    same resumed step (the learning-rate schedule spans --steps, so a
    resumed run is held to a resumed run)."""
    _cards(4)
    ck = str(tmp_path / "nccl")
    _, want, ranks_g = _train("gloo", 3)
    text, got, ranks_n = _train("nccl", 3, ck)
    assert "schedule=pipeline_1f1b" in text
    assert "collectives not timed (nccl)" in text
    assert re.findall(r"staged through the host (\d+) B", text) == ["0"] * 4
    assert ranks_n == ranks_g and len(ranks_n) == 4
    shutil.copytree(ck, str(tmp_path / "gloo"))
    text_g, step_g, _ = _train("gloo", 4, str(tmp_path / "gloo"))
    text_n, step_n, _ = _train("nccl", 4, ck)
    assert "resumed from step 3" in text_g and "resumed from step 3" in text_n
    assert sorted(got) == sorted(want) == [0, 1, 2]
    assert sorted(step_n) == sorted(step_g) == [3]
    want.update(step_g)
    got.update(step_n)
    for s in want:
        assert got[s] == pytest.approx(want[s], rel=1e-4), (s, got, want)


def _serve(backend, argv=SERVE):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *argv.split(),
           "--dist-backend", backend]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=TIMEOUT)
    print(f"--- serve over {backend}\n{out.stdout}")
    assert out.returncode == 0, out.stderr[-4000:]
    digest = re.findall(r"^tokens digest (\w+)$", out.stdout, re.M)
    ranks = re.findall(r"^rank (\d) \{.*; staged through the host (\d+) B"
                       r".*; tokens digest (\w+)$", out.stdout, re.M)
    return digest, ranks


def test_nccl_tensor_parallel_serving_emits_gloos_tokens():
    """The paged engine on model:2 (an int8 pool under retention) over
    nccl, one card a rank, emits the tokens of the same run over gloo, on
    every rank, staging nothing through the host."""
    _cards(2)
    want, ranks_g = _serve("gloo")
    got, ranks_n = _serve("nccl")
    assert len(want) == len(got) == 1 and got == want
    assert [d for _, _, d in ranks_n] == [want[0]] * 2
    assert [st for _, st, _ in ranks_n] == ["0", "0"]
    assert all(int(st) > 0 for _, st, _ in ranks_g)


def test_nccl_moe_serving_on_model2_emits_gloos_tokens():
    """Reduced mixtral-8x7b on model:2 (each rank half the experts: the
    router's columns gathered, the experts' partial outputs summed) over
    nccl, one card a rank, emits the tokens of the same run over gloo, on
    every rank, staging nothing through the host."""
    _cards(2)
    want, ranks_g = _serve("gloo", SERVE_MOE)
    got, ranks_n = _serve("nccl", SERVE_MOE)
    assert len(want) == len(got) == 1 and got == want
    assert [d for _, _, d in ranks_n] == [want[0]] * 2
    assert [st for _, st, _ in ranks_n] == ["0", "0"]
    assert all(int(st) > 0 for _, st, _ in ranks_g)


@pytest.mark.parametrize("argv", [TRAIN_TP, TRAIN_MOE],
                         ids=["h2o-danube-1.8b", "mixtral-8x7b-ep"])
def test_nccl_training_on_model2_matches_gloo(argv):
    """Three steps on model:2 over nccl, one card a rank, against the same
    run over gloo: the losses and gradient norms (a MoE arch's routers'
    too) within 1e-4 (the same sums, another transport), the ranks' shard
    elements equal, nothing staged through the host on nccl."""
    _cards(2)
    runs = {}
    for backend in ("gloo", "nccl"):
        cmd = [sys.executable, "-m", "repro_torch.launch.train",
               *argv.split(), "--dist-backend", backend]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=TIMEOUT)
        print(f"--- train over {backend}\n{out.stdout}")
        assert out.returncode == 0, out.stderr[-4000:]
        runs[backend] = out.stdout
    steps = {b: [tuple(float(x) for x in m if x) for m in re.findall(
        r"^step +\d+ loss=([0-9.]+) gnorm=([0-9.]+) lr=\S+"
        r"(?: router_gnorm=([0-9.e+-]+))?$", t, re.M)]
        for b, t in runs.items()}
    assert len(steps["gloo"]) == len(steps["nccl"]) == 3
    for got, want in zip(steps["nccl"], steps["gloo"]):
        assert got == pytest.approx(want, rel=1e-4)
    elements = {b: re.findall(r"^rank (\d): param elements ([0-9,]+);", t,
                              re.M) for b, t in runs.items()}
    assert elements["nccl"] == elements["gloo"] and len(elements["nccl"]) == 2
    assert re.findall(r"staged through the host (\d+) B",
                      runs["nccl"]) == ["0", "0"]
    if "mixtral" in argv:
        assert "ep=True" in runs["nccl"]
