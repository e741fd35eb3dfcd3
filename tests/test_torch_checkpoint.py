"""Checkpoints, the fault-tolerant loop and the data pipeline of the port
against the reference package: a checkpoint written by the reference
restores in the port and one written by the port restores in the
reference, leaf for leaf (bf16 included); a run_train_loop restart is
bitwise equal to an uninterrupted run (the twin of tests/test_fault.py's);
TokenPipeline batches are byte-identical to the reference's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import init_params as jax_init_params
from repro.optim import optimizers as JO
from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import init_params
from repro_torch.optim import optimizers as opt
from repro_torch.runtime import fault as F
from repro_torch.runtime.train_step import TrainStepConfig, make_train_step
from repro_torch.tree import tree_paths

from _torch_parity import tree_np

ARCH = "h2o-danube-1.8b"


@functools.lru_cache(maxsize=1)
def _ref_tree():
    """The reference's bf16 params and adamw_bf16 state (bf16 moments, an
    int32 count) for the reduced config, after one update."""
    cfg = jax_get_config(ARCH).reduced()
    p = jax_init_params(jax.random.PRNGKey(3), cfg)
    ocfg = JO.OptimizerConfig(kind="adamw_bf16")
    st = JO.init_state(ocfg, p)
    g = jax.tree.map(lambda x: jnp.full(x.shape, 0.01, x.dtype), p)
    p, st = jax.jit(functools.partial(JO.apply_updates, ocfg))(p, g, st,
                                                               1e-2)
    return {"params": p, "opt": st}


def _torch_target(device="cpu"):
    cfg = get_config(ARCH).reduced()
    p = init_params(torch.Generator().manual_seed(0), cfg, device=device)
    return {"params": p, "opt": opt.init_state(
        opt.OptimizerConfig(kind="adamw_bf16"), p)}


def _assert_same(torch_tree, jax_tree):
    flat_j = {"//".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  jax_tree)[0]}
    flat_t = {"//".join(str(k) for k in path): leaf
              for path, leaf in tree_paths(torch_tree)}
    assert sorted(flat_t) == sorted(flat_j)
    for k, t in flat_t.items():
        j = flat_j[k]
        want = np.asarray(j.astype(jnp.float32) if j.dtype == jnp.bfloat16
                          else j)
        got = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref = _ref_tree()
    JCK.save(str(tmp_path), 7, ref, extra={"step": 7})
    assert CK.latest_step(str(tmp_path)) == 7
    tree, manifest = CK.restore(str(tmp_path), _torch_target(), device="cpu")
    assert manifest["extra"]["step"] == 7
    assert tree["params"]["embed"]["table"].dtype == torch.bfloat16
    assert tree["opt"]["m"]["embed"]["table"].dtype == torch.bfloat16
    assert tree["opt"]["count"].dtype == torch.int32
    _assert_same(tree, ref)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref = _ref_tree()
    t = _torch_target()
    cfg = get_config(ARCH).reduced()
    t["params"] = params_from_jax(tree_np(ref["params"]), cfg, "cpu")
    t["opt"]["count"] += 5
    thread = CK.save(str(tmp_path), 3, t, extra={"step": 3}, async_=True)
    thread.join()
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        assert '"bfloat16"' in f.read()
    back, manifest = JCK.restore(str(tmp_path), ref)
    assert manifest["step"] == 3
    assert back["params"]["embed"]["table"].dtype == jnp.bfloat16
    _assert_same(t, back)


def test_uncommitted_save_never_shadows_the_last_good_step(tmp_path):
    t = _torch_target()
    CK.save(str(tmp_path), 2, t)
    (tmp_path / "step_00000009.tmp").mkdir()
    assert CK.latest_step(str(tmp_path)) == 2
    with pytest.raises(ValueError, match="shape"):
        bad = dict(t, params=dict(t["params"],
                                  final_norm=torch.zeros(3)))
        CK.restore(str(tmp_path), bad, device="cpu")


def _setup(tmp_path, interval):
    cfg = get_config(ARCH).reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tcfg = TrainStepConfig(optimizer=opt.OptimizerConfig(lr=1e-3),
                           warmup_steps=1, total_steps=20)
    step = make_train_step(cfg, tcfg)
    st = opt.init_state(tcfg.optimizer, params)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4, seed=3))
    mgr = F.CheckpointManager(str(tmp_path / "ck"), interval=interval,
                              async_=True)
    return params, st, step, pipe, mgr


def _clone(tree):
    return jax.tree.map(lambda t: t.clone(), tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_restart_bitwise_matches_uninterrupted(tmp_path):
    """Checkpoint, crash, restore and continue: the same parameters, bit
    for bit, as a run that never stopped (bf16 parameters, adamw_f32)."""
    params, st, step, pipe, mgr = _setup(tmp_path, interval=3)
    p1, o1, _, h1 = F.run_train_loop(train_step=step, params=_clone(params),
                                     opt_state=_clone(st), pipeline=pipe,
                                     n_steps=6)
    with pytest.raises(RuntimeError, match="injected failure"):
        F.run_train_loop(train_step=step, params=_clone(params),
                         opt_state=_clone(st), pipeline=pipe, n_steps=6,
                         ckpt_mgr=mgr, fail_at=4)
    mgr.wait()
    assert mgr.latest_step() == 3
    tree, manifest = mgr.restore({"params": _clone(params),
                                  "opt": _clone(st)}, device="cpu")
    start = manifest["extra"]["step"]
    p2, o2, done, h2 = F.run_train_loop(
        train_step=step, params=tree["params"], opt_state=tree["opt"],
        pipeline=pipe, n_steps=6, start_step=start)
    assert done == 6 and len(h2) == 3
    assert [h["loss"] for h in h2] == [h["loss"] for h in h1[3:]]
    for (_, a), (_, b) in zip(tree_paths(p1), tree_paths(p2)):
        assert torch.equal(a, b)
    for (_, a), (_, b) in zip(tree_paths(o1), tree_paths(o2)):
        assert torch.equal(a, b)


def test_preemption_saves_and_exits(tmp_path):
    params, st, step, pipe, mgr = _setup(tmp_path, interval=100)
    guard = F.PreemptionGuard()

    def on_metrics(s, m):
        if s == 1:
            guard.trigger()

    _, _, done, hist = F.run_train_loop(
        train_step=step, params=params, opt_state=st, pipeline=pipe,
        n_steps=50, ckpt_mgr=mgr, guard=guard, on_metrics=on_metrics,
        watchdog=F.Watchdog())
    assert done == 2 and len(hist) == 2
    assert mgr.latest_step() == 2
    assert set(hist[0]) == {"loss", "lb_loss", "z_loss", "grad_norm", "lr"}


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_token_pipeline_batches_equal_the_reference(n_hosts):
    kw = dict(vocab_size=97, seq_len=40, global_batch=4, seed=5,
              mean_doc_len=16)
    for host in range(n_hosts):
        mine = TokenPipeline(DataConfig(**kw), n_hosts=n_hosts, host_id=host)
        ref = JTokenPipeline(JDataConfig(**kw), n_hosts=n_hosts,
                             host_id=host)
        for step in (0, 3):
            a, b = mine.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "targets"):
                assert a[k].dtype == b[k].dtype == np.int32
                assert a[k].tobytes() == b[k].tobytes()
    assert dataclasses.asdict(DataConfig(**kw)) == dataclasses.asdict(
        JDataConfig(**kw))
