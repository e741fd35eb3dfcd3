"""Every arch of the registry at reduced size through the port, against the
reference package: twins of tests/test_smoke_archs.py (which the reference
marks slow), with the weights carried over from the reference's
`init_params` through numpy. One forward's logits (with prefix embeddings
for the modality-stub arch, internvl2-26b) and one train step's metrics
under remat "dots" and 2 microbatches (the scan schedule), in f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jax_get_config
from repro.models import ModelSettings as JMS, apply as japply
from repro.models import init_params as jax_init_params
from repro.models.attention import AttnSettings as JAS
from repro.optim import optimizers as JO
from repro.runtime.train_step import (TrainStepConfig as JTC,
                                      make_train_step as jmake_train_step)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import apply
from repro_torch.optim import optimizers as TO
from repro_torch.runtime.train_step import TrainStepConfig, make_train_step
from repro_torch.tree import tree_leaves

from _torch_parity import tree_np

JNAIVE = JMS(attn=JAS(backend="naive"))
# f32 logits of an f32 model, up to 8 layers: sums in other orders
ATOL_LOGITS = 1e-4
REL_LOSS = 1e-5


def _pair(arch):
    cj = dataclasses.replace(jax_get_config(arch).reduced(),
                             param_dtype="float32")
    ct = dataclasses.replace(get_config(arch).reduced(),
                             param_dtype="float32")
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    return cj, pj, ct, params_from_jax(tree_np(pj), ct, "cpu")


def test_every_arch_is_covered():
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        get_config(arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits_match_reference(arch):
    cj, pj, ct, pt = _pair(arch)
    b, s = 2, 24
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cj.vocab_size,
                          (b, s - cj.n_prefix_embeds)).astype(np.int32)
    prefix = (rng.standard_normal((b, cj.n_prefix_embeds, cj.d_model))
              .astype(np.float32) if cj.n_prefix_embeds else None)
    lj, cache_j, aux_j = japply(
        pj, cj, jnp.asarray(tokens),
        prefix_embeds=None if prefix is None else jnp.asarray(prefix),
        settings=JNAIVE)
    lt, cache_t, aux_t = apply(
        pt, ct, torch.from_numpy(tokens),
        prefix_embeds=None if prefix is None else torch.from_numpy(prefix))
    assert cache_t is None and cache_j is None
    assert lt.shape == (b, s, ct.padded_vocab_size)
    assert bool(torch.isfinite(lt).all())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL_LOGITS,
                               rtol=0)
    for k in ("lb_loss", "z_loss"):
        assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), rel=1e-5,
                                                abs=1e-7)
    if ct.is_moe:
        assert float(aux_t["lb_loss"]) > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_reference(arch):
    cj, pj, ct, pt = _pair(arch)
    b, s = 4, 16
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cj.vocab_size, (b, s)).astype(
                 np.int32),
             "targets": rng.integers(0, cj.vocab_size, (b, s)).astype(
                 np.int32)}
    if cj.n_prefix_embeds:
        batch["prefix_embeds"] = rng.standard_normal(
            (b, cj.n_prefix_embeds, cj.d_model)).astype(np.float32)
    kw = dict(remat="dots", microbatches=2, warmup_steps=1, total_steps=10)
    jcfg = JTC(optimizer=JO.OptimizerConfig(lr=1e-3), settings=JNAIVE, **kw)
    tcfg = TrainStepConfig(optimizer=TO.OptimizerConfig(lr=1e-3), **kw)
    _, _, mj = jax.jit(jmake_train_step(cj, jcfg))(
        pj, JO.init_state(jcfg.optimizer, pj),
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0))
    before = [t.clone() for t in tree_leaves(pt)]
    _, _, mt = make_train_step(ct, tcfg)(
        pt, TO.init_state(tcfg.optimizer, pt),
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    assert float(mt["loss"]) > 0
    for k in ("loss", "grad_norm"):
        assert float(mt[k]) == pytest.approx(float(mj[k]), rel=REL_LOSS), k
    if ct.is_moe:
        assert float(mt["lb_loss"]) == pytest.approx(float(mj["lb_loss"]),
                                                     rel=REL_LOSS)
    assert sum(float((a - b_).abs().sum())
               for a, b_ in zip(tree_leaves(pt), before)) > 0
