"""The 1F1B pipeline of the port: split_stages' and validate_pipeline's
refusals equal to the reference's; the 1F1B step order; pipeline_1f1b on
2 and 4 gloo ranks equal to running the stages in sequence (outputs and
gradients; the mixed-dtype stage too); and the pipeline loss and
gradients on data:2,pipe:2 (four ranks) of a reduced h2o-danube-1.8b at
depth 4, [8, 32], 4 microbatches, against the reference's single-shot
make_loss_fn under jax.value_and_grad, weights carried over by convert."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs.base import depth_variant as jax_depth
from repro.models import init_params as jax_init_params
from repro.parallel import pipeline as JPPL
from repro.runtime import schedule as JSCH
from repro.runtime import train_step as JT
from repro_torch.parallel import pipeline as PPL
from repro_torch.runtime import schedule as SCH
from repro_torch.runtime.train_step import TrainStepConfig

from _torch_parity import tree_np
import _torch_mesh_ranks as R

ARCH = "h2o-danube-1.8b"
# the tolerances tests/test_torch_train.py holds the scan schedule's
# microbatch accumulation to: loss to f32 drift, gradients to TOL_GRAD of
# the largest gradient (f32 on both sides, sums in other orders)
TOL_METRIC = 1e-5
TOL_GRAD = 2e-5


def test_split_stages_error_paths():
    import torch
    for mod, zeros in ((JPPL, jnp.zeros), (PPL, torch.zeros)):
        out = mod.split_stages({"w": zeros((6, 3))}, 2)
        assert tuple(out["w"].shape) == (2, 3, 3)
        with pytest.raises(ValueError, match="does not divide"):
            mod.split_stages({"w": zeros((6, 3))}, 4)
        with pytest.raises(ValueError, match="n_stages"):
            mod.split_stages({"w": zeros((6, 3))}, 0)


@pytest.mark.parametrize("case", [
    ("h2o-danube-1.8b", 4, {"data": 2, "pipe": 2}),
    ("h2o-danube-1.8b", 1, {"pipe": 2}),
    ("h2o-danube-1.8b", 4, {"data": 1}),
    ("h2o-danube-1.8b", 4, {"pipe": 2, "model": 2}),
    ("mixtral-8x7b", 4, {"pipe": 2}),
    ("internvl2-26b", 4, {"pipe": 2}),
    ("gemma3-12b", 4, {"pipe": 4})])
def test_validate_pipeline_matches_reference(case):
    arch, micro, mesh = case
    from repro_torch.configs import get_config
    got = want = None
    try:
        want = JSCH.validate_pipeline(
            jax_get_config(arch).reduced(),
            JT.TrainStepConfig(microbatches=micro), mesh)
    except ValueError as e:
        want = str(e)
    try:
        got = SCH.validate_pipeline(get_config(arch).reduced(),
                                    TrainStepConfig(microbatches=micro), mesh)
    except ValueError as e:
        got = str(e)
    assert got == want


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 4), (4, 8),
                                              (2, 2)])
def test_one_f_one_b_order(n_stages, n_micro):
    """Each stage runs every microbatch's forward before its backward, in
    microbatch order, with at most min(n_micro, stages - s) in flight."""
    for s in range(n_stages):
        ops = PPL.one_f_one_b(n_micro, n_stages, s)
        assert [i for k, i in ops if k == "F"] == list(range(n_micro))
        assert [i for k, i in ops if k == "B"] == list(range(n_micro))
        live, peak = set(), 0
        for k, i in ops:
            if k == "F":
                live.add(i)
                peak = max(peak, len(live))
            else:
                assert i in live
                live.remove(i)
        assert peak == min(n_micro, n_stages - s)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_1f1b_matches_sequence(n_stages):
    out = R.spawn(R.pipeline_vs_sequence, n_stages, n_stages)
    for res in out:
        assert res["out"] <= 1e-6 and res["gw"] <= 2e-5 and res["gx"] <= 2e-5
        assert res["gx_elsewhere"]
        assert res["mixed_dtype"] == "torch.float32"
        assert res["mixed"] <= 1e-2


def test_pipeline_loss_and_grads_match_reference():
    cj = dataclasses.replace(jax_depth(jax_get_config(ARCH).reduced(), 4),
                             param_dtype="float32")
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(2, cj.vocab_size, (8, 32)).astype(np.int32)
             for k in ("tokens", "targets")}
    (total_j, aux_j), gj = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(cj, JT.TrainStepConfig()), has_aux=True))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    out = R.spawn(R.pipeline_loss, 4, ARCH, 4, tree_np(pj), batch, 4)
    for res in out:
        assert res["total"] == pytest.approx(float(total_j), rel=TOL_METRIC)
        assert res["loss"] == pytest.approx(float(aux_j["loss"]),
                                            rel=TOL_METRIC)
    gj = tree_np(gj)
    scale = max(float(np.abs(x).max()) for x in jax.tree.leaves(gj))
    got, want = jax.tree.leaves(out[0]["grads"]), jax.tree.leaves(gj)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL_GRAD * scale, rtol=1e-4)
