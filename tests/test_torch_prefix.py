"""Prefix embeddings (the modality-stub arch internvl2-26b) in the port
against the reference package: a prefill step over prefix embeds plus a
text prompt, then decode steps at positions n_prefix + p + t, logits and
greedy tokens; the assert that explicit positions and prefix embeds do not
come together; CudaMeasurer's input layout for a prefix arch (prefix
embeds [b, n_prefix, d] in bf16 before seq - n_prefix text tokens), with
the allocator's readings scripted on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelSettings as JMS
from repro.models.attention import AttnSettings as JAS
from repro.runtime import serve_step as JSS
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import measure as TMM
from repro_torch.core import predictor as TPR
from repro_torch.models import apply
from repro_torch.runtime import serve_step as SS
from repro_torch.tree import tree_leaves

from _torch_parity import model_pair, to_np

ARCH = "internvl2-26b"
ATOL = 5e-2     # f32 logits of a bf16 model (tests/test_torch_model.py)
JNAIVE = JMS(attn=JAS(backend="naive"))


def _inputs(cfg, b=2, p=6, seed=8):
    rng = np.random.default_rng(seed)
    prefix = np.array(to_np(jnp.asarray(rng.standard_normal(
        (b, cfg.n_prefix_embeds, cfg.d_model)), jnp.bfloat16)))
    toks = rng.integers(2, cfg.vocab_size, (b, p)).astype(np.int32)
    return prefix, toks


def test_prefix_prefill_then_decode_matches_reference():
    cj, pj, ct, pt = model_pair(ARCH)
    assert ct.n_prefix_embeds == 4
    prefix, toks = _inputs(cj)
    b, p = toks.shape
    n, steps, context = cj.n_prefix_embeds, 5, 24
    jpre, jdec = (JSS.make_prefill_step(cj, JNAIVE),
                  JSS.make_decode_step(cj, JNAIVE))
    tpre, tdec = SS.make_prefill_step(ct), SS.make_decode_step(ct)
    lj, cj_cache = jpre(pj, jnp.asarray(toks), context,
                        prefix_embeds=jnp.asarray(prefix, jnp.bfloat16))
    lt, ct_cache = tpre(pt, torch.from_numpy(toks), context,
                        prefix_embeds=torch.from_numpy(prefix).to(
                            torch.bfloat16))
    for t in range(steps):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0)
        tok_j = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        tok_t = torch.argmax(lt, -1).to(torch.int32)
        np.testing.assert_array_equal(tok_t.numpy(), tok_j)
        pos = np.full((b,), n + p + t, np.int32)
        lj, cj_cache = jdec(pj, jnp.asarray(tok_j)[:, None],
                            jnp.asarray(pos), cj_cache, context)
        lt, ct_cache = tdec(pt, tok_t[:, None], torch.from_numpy(pos),
                            ct_cache, context)


def test_prefix_with_explicit_positions_is_refused():
    _, _, ct, pt = model_pair(ARCH)
    prefix, toks = _inputs(ct)
    with pytest.raises(AssertionError):
        apply(pt, ct, torch.from_numpy(toks),
              positions=torch.zeros(toks.shape, dtype=torch.int32),
              prefix_embeds=torch.from_numpy(prefix))


class _FakeCuda:
    def __init__(self):
        self.reads = [1000, 1100]

    def memory_allocated(self, dev=None):
        return self.reads.pop(0)

    def max_memory_allocated(self, dev=None):
        return 5000

    def reset_peak_memory_stats(self, dev=None):
        pass


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_cuda_measurer_places_prefix_embeds(kind, monkeypatch):
    fake = _FakeCuda()
    for name in ("memory_allocated", "max_memory_allocated",
                 "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    m = object.__new__(TMM.CudaMeasurer)
    TMM.MemoryMeasurer.__init__(m, {"data": 1})
    m.device, m._params = torch.device("cpu"), None
    cfg = get_config(ARCH).reduced()
    seq, b = 16, 2
    calls = []
    orig = SS.make_prefill_step if kind == "prefill" else None
    if kind == "prefill":
        def spy(cfg_, settings=None):
            step = orig(cfg_, settings)

            def run(params, tokens, context, prefix_embeds=None):
                calls.append((tuple(tokens.shape), prefix_embeds.dtype,
                              tuple(prefix_embeds.shape), context))
                return step(params, tokens, context, prefix_embeds)
            return run
        monkeypatch.setattr(SS, "make_prefill_step", spy)
    prof = m.measure(cfg, ShapeConfig("t", kind, seq, b),
                     TPR.MemoryPlan(optimizer="adafactor"))
    params = sum(t.numel() * t.element_size()
                 for t in tree_leaves(m.params_for(cfg)))
    n = cfg.n_prefix_embeds
    # text tokens (and targets) of seq - n positions, prefix embeds in bf16
    text = b * (seq - n) * 4 * (2 if kind == "train" else 1)
    assert prof.argument_bytes >= params + text + b * n * cfg.d_model * 2
    assert m.steps == 1 and m.step_seconds > 0
    if kind == "prefill":
        assert calls == [((b, seq - n), torch.bfloat16,
                          (b, n, cfg.d_model), seq)]
