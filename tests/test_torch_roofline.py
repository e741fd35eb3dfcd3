"""The port's roofline (repro_torch.roofline) against the reference
package's (repro.roofline.analysis): the analytic functions and
report(...).to_dict() under the TPU v5e's numbers equal the reference's on
every arch x shape that shape_applicable admits; under the H100's the
terms divide by the H100's rates. The step counter (roofline.count) on the
meta device: depth 2 minus depth 1 of a dense arch's decode and prefill
equals the unit's matrix products counted by hand; the same step counts
the same on the CPU; a step that cannot run on meta raises, and the
dry-run's roofline then says so instead of reporting a zero."""
import math

import numpy as np
import pytest

from repro import hw as JHW
from repro.configs import SHAPES as JSHAPES, get_config as jget
from repro.roofline import analysis as JRA
from repro_torch import hw as THW
from repro_torch.configs import (ARCH_IDS, SHAPE_ORDER, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.configs.base import (DECODE, PREFILL, TRAIN, ShapeConfig,
                                      depth_variant, model_flops)
from repro_torch.core.predictor import MemoryPlan
from repro_torch.models import layers as L
from repro_torch.models.model import ModelSettings
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import count as RC

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPE_ORDER
         if shape_applicable(get_config(a), SHAPES[s])[0]]


def close(a, b, rel=1e-12):
    """Equal dicts / lists / numbers, floats within `rel`."""
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            close(a[k], b[k], rel)
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        assert math.isclose(a, b, rel_tol=rel, abs_tol=0.0), (a, b)
    else:
        assert a == b, (a, b)


def _costs(seed):
    """Two depth costs (depth 1, depth 2) with a collective mix, the same
    numbers on both sides."""
    rng = np.random.default_rng(seed)
    f1, b1, w1 = (float(x) for x in rng.uniform(1e12, 1e14, 3))
    kinds = {"all-reduce": float(rng.uniform(1e8, 1e9)),
             "all-gather": float(rng.uniform(1e8, 1e9))}
    d1 = (f1, b1, w1, kinds)
    d2 = (2.1 * f1, 1.9 * b1, 2.2 * w1,
          {"all-reduce": 2.3 * kinds["all-reduce"],
           "reduce-scatter": float(rng.uniform(1e8, 1e9))})
    return d1, d2


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_roofline_equals_reference(arch, shape):
    cj, sj = jget(arch), JSHAPES[shape]
    ct, st = get_config(arch), SHAPES[shape]
    for n_chips in (1, 256):
        for q_block in (256, 512):
            a = JRA.scan_corrections(cj, sj, n_chips, q_block=q_block)
            b = RA.scan_corrections(ct, st, n_chips, q_block=q_block)
            close(a.__dict__, b.__dict__)
        for remat in ("none", "dots", "full"):
            close(JRA.analytic_hbm_traffic(cj, sj, n_chips, remat=remat,
                                           microbatches=2),
                  RA.analytic_hbm_traffic(ct, st, n_chips, remat=remat,
                                          microbatches=2))
    d1, d2 = _costs(len(arch) * 7 + len(shape))
    for reps in (1, ct.repeats):
        ja = JRA.extrapolate(JRA.ComponentCost(*d1), JRA.ComponentCost(*d2),
                             reps)
        ta = RA.extrapolate(RA.ComponentCost(*d1), RA.ComponentCost(*d2),
                            reps)
        close(ja.__dict__, ta.__dict__)
    jc = JRA.apply_corrections(ja, JRA.scan_corrections(cj, sj, 256))
    tc = RA.apply_corrections(ta, RA.scan_corrections(ct, st, 256))
    close(jc.__dict__, tc.__dict__)
    for remat in ("none", "full"):
        jr = JRA.report(cj, sj, "single", 256, jc, hw=JHW.TPU_V5E,
                        remat=remat)
        tr = RA.report(ct, st, "single", 256, tc, hw=THW.TPU_V5E,
                       remat=remat)
        assert tr.hw is THW.TPU_V5E
        close(jr.to_dict(), tr.to_dict())


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_report_under_h100_divides_by_its_rates(shape):
    cfg, st = get_config("mistral-nemo-12b"), SHAPES[shape]
    cost = RA.ComponentCost(flops=3.2e15, bytes_accessed=4.1e13,
                            wire_bytes=2.5e11, collectives={"x": 2.5e11})
    rep = RA.report(cfg, st, "card", 1, cost)       # default: the H100
    assert rep.hw is THW.H100
    assert rep.t_comp == 3.2e15 / 989e12
    assert rep.t_mem == 4.1e13 / 3.35e12
    assert rep.t_coll == 2.5e11 / 450e9
    assert rep.mfu_bound == (model_flops(cfg, st) / 989e12) / rep.t_roofline
    assert rep.mfu_bound_analytic == (model_flops(cfg, st) / 989e12) / \
        rep.t_roofline_analytic
    d = rep.to_dict()
    assert "hw" not in d and d["bottleneck"] == rep.bottleneck
    tpu = RA.report(cfg, st, "card", 1, cost, hw=THW.TPU_V5E)
    assert tpu.mfu_bound == (model_flops(cfg, st) / 197e12) / tpu.t_roofline


def _unit_matmul_params(cfg):
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    H, K = cfg.n_heads, cfg.n_kv_heads
    mult = 2 if L.is_glu(cfg.activation) else 1
    return d * H * hd + 2 * d * K * hd + H * hd * d + d * mult * f + f * d


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_counted_unit_flops_equal_the_hand_count(shape):
    """h2o-danube-1.8b (one attention + SwiGLU block a unit) at full
    width: depth 2 minus depth 1 counts 2 x the unit's projection
    parameters x tokens plus the attention's two products (over the
    sliding window's ring at decode; every (query, key) pair of the
    plain attention at prefill, the masked half included)."""
    cfg, st = get_config("h2o-danube-1.8b"), SHAPES[shape]
    assert len(cfg.unit) == 1 and not cfg.tail
    c1, c2 = (RC.count_step(depth_variant(cfg, n), st) for n in (1, 2))
    b, hd, H = st.global_batch, cfg.resolved_head_dim, cfg.n_heads
    if st.kind == DECODE:
        tokens = b
        attn = 2 * (2 * b * H * hd * cfg.unit[0].cache_len(st.context))
    else:
        tokens = b * st.seq_len
        attn = 2 * (2 * b * H * st.seq_len * st.seq_len * hd)
    want = 2 * _unit_matmul_params(cfg) * tokens + attn
    assert c2.flops - c1.flops == want
    assert c2.bytes_accessed > c1.bytes_accessed > 0
    assert c1.wire_bytes == 0 and c1.collectives == {}


KINDS = {"train": ShapeConfig("t", TRAIN, 64, 2),
         "prefill": ShapeConfig("p", PREFILL, 64, 2),
         "decode": ShapeConfig("d", DECODE, 64, 2)}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_counts_equal_the_cpu_counts(arch, kind):
    """The same step at a reduced config counted on the meta device and
    on the CPU: the same FLOPs, and the same bytes except on MoE archs,
    whose F.one_hot checks its indices on the CPU (a min / max read the
    meta device and the card do not make)."""
    cfg = get_config(arch).reduced()
    st = KINDS[kind]
    if cfg.n_prefix_embeds and kind != "decode":
        st = ShapeConfig(st.name, st.kind, cfg.n_prefix_embeds + 32, 2)
    meta = RC.count_step(cfg, st)
    cpu = RC.count_step(cfg, st, device="cpu")
    assert meta.flops == cpu.flops > 0
    if cfg.is_moe:
        assert meta.bytes_accessed <= cpu.bytes_accessed
    else:
        assert meta.bytes_accessed == cpu.bytes_accessed > 0


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_train_count_covers_backward_and_remat(remat):
    """A train step counts its backward (at least twice the forward's
    products) and remat "full"'s recompute of the unit bodies."""
    cfg = get_config("h2o-danube-1.8b")
    st = SHAPES["train_4k"]
    one = depth_variant(cfg, 1)
    fwd = RC.count_step(one, ShapeConfig("p", PREFILL, st.seq_len,
                                         st.global_batch))
    train = RC.count_step(one, st, MemoryPlan(remat=remat))
    none = RC.count_step(one, st, MemoryPlan(remat="none"))
    assert train.flops >= 3 * fwd.flops
    if remat == "full":
        assert train.flops > none.flops
    else:
        assert train.flops == none.flops     # dots keeps every product


def test_uncountable_step_raises_and_the_dryrun_says_so(monkeypatch):
    """A step with a host read (.item()) cannot run on meta: count_step
    raises CountError and the dry-run's roofline is an error, not zero."""
    from repro_torch.launch import dryrun as DR
    orig = L.rmsnorm

    def host_read(scale, x, eps=1e-6):
        float(x.sum())
        return orig(scale, x, eps)

    monkeypatch.setattr(L, "rmsnorm", host_read)
    cfg = get_config("h2o-danube-1.8b").reduced()
    with pytest.raises(RC.CountError, match="cannot count"):
        RC.count_step(cfg, KINDS["decode"])
    out = DR.card_roofline(cfg, KINDS["decode"], MemoryPlan(), "planned", 1,
                           ModelSettings(), THW.H100)
    assert "error" in out and "flops_per_chip" not in out


def test_counting_settings_take_the_plain_paths():
    st = RC.counting_settings(ModelSettings(moe_group=512))
    assert st.attn.backend == "naive" and st.mlstm_backend == "naive"
    assert st.moe_group == 512
    default = RC.counting_settings()
    assert default.attn.backend == "naive" and default.moe_group == 2048
