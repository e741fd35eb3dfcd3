"""The port's training path against the reference package's, on
h2o-danube-1.8b reduced (its sliding window of 8 bites at seq 32) at 2 unit
repeats, with f32 parameters carried over by params_from_jax: one step's loss
and gradients against jax.value_and_grad(make_loss_fn), under every remat
policy; three make_train_step steps for the single and scan (2
microbatches) schedules under adamw_f32, adamw_bf16 and adafactor (loss,
grad_norm, lr and the parameters); a resume from the reference's optimizer
state through opt_state_from_jax; the int8 gradient round trip
(compress_grads); the launch driver on the CPU; the flash Function on the
path only while autograd records."""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import depth_variant as jax_depth
from repro.models import init_params as jax_init_params
from repro.optim import optimizers as JO
from repro.runtime import train_step as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import depth_variant
from repro_torch.convert import opt_state_from_jax, params_from_jax, to_numpy
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as TA
from repro_torch.optim import optimizers as TO
from repro_torch.runtime import schedule as TS
from repro_torch.runtime import train_step as TT
from repro_torch.tree import tree_leaves

from _torch_parity import tree_np

ARCH = "h2o-danube-1.8b"
B, S = 4, 32
# one step's loss and gradients: f32 on both sides, sums in other orders
TOL_GRAD = 2e-5
# after three optimizer steps at LR: the updates are lr-sized, so the
# parameters are held to a small fraction of one update; loss, grad_norm
# and lr to f32 rounding drift over the steps
LR = 1e-3
TOL_PARAM = 2e-5
TOL_METRIC = 1e-5


def _cfgs():
    cj = dataclasses.replace(jax_get_config(ARCH).reduced(),
                             param_dtype="float32")
    ct = dataclasses.replace(get_config(ARCH).reduced(),
                             param_dtype="float32")
    return jax_depth(cj, 2), depth_variant(ct, 2)


@functools.lru_cache(maxsize=1)
def _setup():
    cj, ct = _cfgs()
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    rng = np.random.default_rng(11)
    batches = [{"tokens": rng.integers(2, cj.vocab_size, (B, S)).astype(
                    np.int32),
                "targets": rng.integers(2, cj.vocab_size, (B, S)).astype(
                    np.int32)} for _ in range(3)]
    return cj, ct, pj, batches


def _torch_params():
    cj, ct, pj, _ = _setup()
    return params_from_jax(tree_np(pj), ct, "cpu")


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(got, want, atol, rtol=0.0):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol)


@functools.lru_cache(maxsize=1)
def _reference_grads():
    cj, _, pj, batches = _setup()
    fn = jax.jit(jax.value_and_grad(JT.make_loss_fn(cj, JT.TrainStepConfig()),
                                    has_aux=True))
    (total, aux), g = fn(pj, {k: jnp.asarray(v)
                              for k, v in batches[0].items()})
    return float(total), float(aux["loss"]), tree_np(g)


@pytest.mark.parametrize("remat", TT.REMAT_POLICIES)
def test_loss_and_grads_match_reference(remat):
    """One step's loss and gradients, through the flash Function (its
    plain versions on the CPU) and every remat policy, against the
    reference's blocked jnp attention under jax.value_and_grad."""
    total_j, loss_j, gj = _reference_grads()
    _, ct, _, batches = _setup()
    pt = _torch_params()
    grad_fn = TT.value_and_grad(TT.make_loss_fn(
        ct, TT.TrainStepConfig(remat=remat)))
    (total_t, met), gt = grad_fn(pt, _tb(batches[0]))
    assert float(met["loss"]) == pytest.approx(loss_j, rel=1e-6)
    assert float(total_t) == pytest.approx(total_j, rel=1e-6)
    for p in tree_leaves(pt):
        assert not p.requires_grad and p.grad is None
    ng = to_numpy(gt)
    scale = max(float(np.abs(x).max()) for x in jax.tree.leaves(gj))
    _assert_tree_close(ng, gj, atol=TOL_GRAD * scale, rtol=1e-4)


def test_flash_function_only_while_autograd_records(monkeypatch):
    """The kernel backend takes flash_attention_trainable when the loss is
    differentiated, the forward-only call otherwise."""
    _, ct, _, batches = _setup()
    pt = _torch_params()
    calls = {"trainable": 0, "fwd": 0}
    orig_t, orig_f = tops.flash_attention_trainable, tops.flash_attention

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tops, "flash_attention_trainable",
                        count("trainable", orig_t))
    monkeypatch.setattr(tops, "flash_attention", count("fwd", orig_f))
    loss_fn = TT.make_loss_fn(ct, TT.TrainStepConfig())
    TT.value_and_grad(loss_fn)(pt, _tb(batches[0]))
    assert calls == {"trainable": ct.n_layers, "fwd": 0}
    with torch.no_grad():
        loss_fn(pt, _tb(batches[0]))
    assert calls == {"trainable": ct.n_layers, "fwd": ct.n_layers}


@functools.lru_cache(maxsize=None)
def _reference_run(kind, micro):
    """The reference's three steps: [(params, opt_state, metrics)] after
    each, as numpy."""
    cj, _, pj, batches = _setup()
    tcfg = JT.TrainStepConfig(
        microbatches=micro, optimizer=JO.OptimizerConfig(kind=kind, lr=LR),
        warmup_steps=2, total_steps=10)
    step = jax.jit(JT.make_train_step(cj, tcfg))
    p, st = pj, JO.init_state(tcfg.optimizer, pj)
    out = []
    for i, b in enumerate(batches):
        p, st, m = step(p, st, {k: jnp.asarray(v) for k, v in b.items()},
                        jnp.asarray(i))
        out.append((tree_np(p), tree_np(st),
                    {k: float(v) for k, v in m.items()}))
    return out


def _torch_step(kind, micro):
    _, ct, _, _ = _setup()
    tcfg = TT.TrainStepConfig(
        microbatches=micro, optimizer=TO.OptimizerConfig(kind=kind, lr=LR),
        warmup_steps=2, total_steps=10)
    return tcfg, TS.make_train_step(ct, tcfg)


@pytest.mark.parametrize("kind", TO.KINDS)
@pytest.mark.parametrize("micro", [1, 2])
def test_train_steps_match_reference(kind, micro):
    """Three make_train_step steps, single (1) and scan (2 microbatches)
    schedules: loss, grad_norm, lr and the parameters after each step."""
    want = _reference_run(kind, micro)
    _, _, _, batches = _setup()
    tcfg, step = _torch_step(kind, micro)
    assert step.schedule == ("scan" if micro > 1 else "single")
    pt = _torch_params()
    st = TO.init_state(tcfg.optimizer, pt)
    for i, b in enumerate(batches):
        pt2, st2, met = step(pt, st, _tb(b), i)
        assert pt2 is pt and st2 is st          # updated in place
        pj, _, mj = want[i]
        for k in ("loss", "grad_norm", "lr"):
            assert float(met[k]) == pytest.approx(mj[k], rel=TOL_METRIC), k
        _assert_tree_close(to_numpy(pt), pj, atol=TOL_PARAM)


@pytest.mark.parametrize("kind", ["adamw_bf16", "adafactor"])
def test_resume_from_reference_optimizer_state(kind):
    """Params and optimizer state after the reference's second step, carried
    over with params_from_jax / opt_state_from_jax: the port's third step
    lands where the reference's does."""
    want = _reference_run(kind, 1)
    _, ct, _, batches = _setup()
    tcfg, step = _torch_step(kind, 1)
    p_np, st_np, _ = want[1]
    pt = params_from_jax(p_np, ct, "cpu")
    st = opt_state_from_jax(st_np, pt, tcfg.optimizer)
    ref_state = TO.init_state(tcfg.optimizer, pt)
    for a, r in zip(tree_leaves(st), tree_leaves(ref_state)):
        assert a.dtype == r.dtype and a.shape == r.shape
    assert int(st["count"]) == 2
    step(pt, st, _tb(batches[2]), 2)
    pj, sj, _ = want[2]
    _assert_tree_close(to_numpy(pt), pj, atol=TOL_PARAM)
    # state stored in bf16 (adamw_bf16) may land one bf16 unit apart
    _assert_tree_close(to_numpy(st), sj, atol=1e-6,
                       rtol=2 ** -7 if kind == "adamw_bf16" else 1e-4)


def test_compressed_gradients_train_step(monkeypatch):
    """compress_grads=True: each step's gradients go through the int8
    stochastic-rounding round trip, every element within one int8 step
    (the leaf's largest |value| / 127) of the uncompressed gradient; the
    loss stays finite; the draws are seeded by the step number, so two runs
    from the same start end bitwise equal. The reference draws with
    jax.random, so the two packages agree in distribution, not bit for
    bit: this holds the port's properties, not the reference's bits."""
    _, ct, _, batches = _setup()
    seen = []
    orig = TS.compress_roundtrip

    def spy(tree, gen):
        out = orig(tree, gen)
        seen.append(([t.clone() for t in tree_leaves(tree)],
                     [t.clone() for t in tree_leaves(out)]))
        return out

    monkeypatch.setattr(TS, "compress_roundtrip", spy)
    tcfg = TT.TrainStepConfig(compress_grads=True,
                              optimizer=TO.OptimizerConfig(lr=LR),
                              warmup_steps=2, total_steps=10)
    runs = []
    for _ in range(2):
        step = TS.make_train_step(ct, tcfg)
        pt = _torch_params()
        st = TO.init_state(tcfg.optimizer, pt)
        losses = []
        for i, b in enumerate(batches):
            _, _, met = step(pt, st, _tb(b), i)
            losses.append(float(met["loss"]))
            assert np.isfinite(losses[-1]) and np.isfinite(
                float(met["grad_norm"]))
        runs.append((to_numpy(pt), losses))
    assert len(seen) == 2 * len(batches)
    for raw, comp in seen:
        moved = 0
        for g, c in zip(raw, comp):
            assert c.dtype == g.dtype and c.shape == g.shape
            step_size = float(g.abs().max()) / 127.0
            assert float((c - g).abs().max()) <= step_size * (1 + 1e-5)
            moved += int((c != g).sum())
        assert moved > 0
    (p0, l0), (p1, l1) = runs
    assert l0 == l1
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)):
        np.testing.assert_array_equal(a, b)
    # the first loss is computed before any update: the uncompressed
    # step's own
    assert l0[0] == pytest.approx(_reference_run("adamw_f32", 1)[0][2]["loss"],
                                  rel=TOL_METRIC)


def test_naive_backend_trains_through_plain_autograd():
    """AttnSettings(backend="naive") differentiates the dense softmax; its
    gradients equal the flash Function's."""
    _, ct, _, batches = _setup()
    pt = _torch_params()
    naive = TT.TrainStepConfig(settings=dataclasses.replace(
        TT.TrainStepConfig().settings, attn=TA.AttnSettings(backend="naive")))
    (_, mk), gk = TT.value_and_grad(TT.make_loss_fn(
        ct, TT.TrainStepConfig()))(pt, _tb(batches[1]))
    (_, mn), gn = TT.value_and_grad(TT.make_loss_fn(ct, naive))(
        pt, _tb(batches[1]))
    assert float(mk["loss"]) == pytest.approx(float(mn["loss"]), rel=1e-6)
    _assert_tree_close(to_numpy(gk), to_numpy(gn), atol=1e-6, rtol=1e-4)


def test_pipeline_schedule_needs_a_mesh():
    """As the reference's make_train_step: the 1F1B schedule without a mesh
    of ranks is refused (tests/test_torch_pipeline.py runs it on one)."""
    _, ct, _, _ = _setup()
    with pytest.raises(ValueError, match="needs a mesh"):
        TS.make_train_step(ct, TT.TrainStepConfig(), schedule="pipeline_1f1b")
    assert TS.pipe_size_of({"data": 2, "pipe": 4}) == 4
    assert TS.fallback_schedule(ct, TT.TrainStepConfig(microbatches=2),
                                {"pipe": 1}) == "scan"


def test_launch_driver_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as LT
    argv = ["--arch", ARCH, "--reduced", "--seq", "16", "--batch", "4",
            "--steps", "3", "--log-every", "1", "--device", "cpu",
            "--microbatches", "3", "--ckpt-dir", str(tmp_path / "ck")]
    assert LT.main(argv) == 0
    out = capsys.readouterr().out
    assert "adjusted microbatches 3 -> 4" in out or \
        "adjusted microbatches 3 -> 2" in out
    assert "WSMC: predicted resident" in out and "step     2" in out
    # the workload class is the run's own, classified on the simulator's
    # ladder, and the plan is searched for it
    assert re.search(r"^WSMC\[fastest/simulate\]: Expanding\.\w+ "
                     r"\(alpha=[0-9.]+, inc=[0-9.]+\) -> plan MemoryPlan\(",
                     out, re.M)
    assert "simulate ladder)" in out
    # a second run resumes from the final checkpoint and has nothing left
    assert LT.main(argv) == 0
    assert "resumed from step 3" in capsys.readouterr().out


def test_serving_entry_points_build_no_graph():
    """With every parameter requiring a gradient and grad mode on, the
    serving entry points record nothing (their caches are written in
    place): the prefill / decode steps, greedy_generate and a paged
    executor's prefill and decode. The cache-free sequence forward follows
    the caller's grad mode."""
    from repro_torch.models import init_params
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_step as SS
    from repro_torch.serving.executor import PagedTorchExecutor
    cfg = get_config("mistral-nemo-12b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(
        rng.integers(2, cfg.vocab_size, (2, 8)).astype(np.int32))
    logits, cache = SS.make_prefill_step(cfg)(params, prompt, context=16)
    assert not logits.requires_grad
    pos = torch.full((2,), 8, dtype=torch.int32)
    logits, cache = SS.make_decode_step(cfg)(params, prompt[:, :1], pos,
                                             cache, context=16)
    assert not logits.requires_grad
    assert not any(t.requires_grad for t in tree_leaves(cache))
    assert tuple(SS.greedy_generate(params, cfg, prompt, 3, 16).shape) == \
        (2, 3)
    ex = PagedTorchExecutor(params, cfg, n_lanes=2, n_blocks=8, kv_block=4,
                            context=16, device="cpu")
    first = ex.prefill_batch([0, 1], prompt.tolist(), [[1, 2], [3, 4]])
    ex.decode(first, [8, 8], [[1, 2, 5], [3, 4, 6]])
    assert not any(t.requires_grad for t in tree_leaves(ex.pool))
    logits, _, aux = M.apply(params, cfg, prompt)
    assert logits.requires_grad
    assert float(aux["lb_loss"]) == 0.0 and float(aux["z_loss"]) == 0.0
    with torch.no_grad():
        assert not M.apply(params, cfg, prompt)[0].requires_grad
