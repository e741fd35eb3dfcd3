"""The port's serving planner (search.execplan.plan_serving over
core.predictor's capacity inversions) against the reference package's:
twins of the capacity and plan_serving sections of tests/test_paged.py,
the agreement gate of tests/test_bending.py and the plan_serving section
of tests/test_serving.py, and a grid over all ten archs — ring and paged
modes, compact, both admissions, kv_quants, min_agreement, prefill budgets
(fixed and searched), pinned and planned meshes — in which every
ServingPlan and its describe() string must be equal, at the TPU v5e's
numbers and at the H100's (handed to the reference as its own
HardwareSpec)."""
import dataclasses
import enum
import types

import pytest

from repro import hw as JHW
from repro.configs import ARCH_IDS, get_config as jget
from repro.configs.base import ShapeConfig as JShape
from repro.core import measure as JMM
from repro.core import predictor as JPR
from repro.core import profiler as JPF
from repro.search import execplan as JXP
from repro.search import space as JSP
from repro_torch import hw as THW
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core import measure as TMM
from repro_torch.core import predictor as TPR
from repro_torch.core import profiler as TPF
from repro_torch.search import execplan as TXP
from repro_torch.search import space as TSP

GIB = 2**30
J = types.SimpleNamespace(name="reference", HW=JHW, get=jget, Shape=JShape,
                          MM=JMM, PR=JPR, PF=JPF, XP=JXP, SP=JSP,
                          H100=JHW.HardwareSpec(**dataclasses.asdict(
                              THW.H100)))
T = types.SimpleNamespace(name="port", HW=THW, get=tget, Shape=TShape,
                          MM=TMM, PR=TPR, PF=TPF, XP=TXP, SP=TSP,
                          H100=THW.H100)
SIDES = (J, T)


def norm(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, norm(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(norm(v) for v in x)
    return x


def both(fn, *args, **kw):
    got = [fn(s, *args, **kw) for s in SIDES]
    assert norm(got[0]) == norm(got[1])
    return got[1]


def _cfg(s, arch="mistral-nemo-12b"):
    return s.get(arch)


def _shape(s, context=4096, batch=8):
    return s.Shape("paged_t", "decode", context, batch)


def _cls(s, arch="mistral-nemo-12b", shape=None):
    sim = s.MM.SimulatedMeasurer({"data": 8})
    return s.PF.classify_workload(_cfg(s, arch), shape or _shape(s), None,
                                  n_points=2, base_seq=64, measurer=sim)


def _splan(res):
    cls, splan = res
    return cls, splan, splan.describe(), splan.slots(cap=3), \
        splan.pool_blocks(8, 4096)


# --- block math: the requirement model at block granularity ------------------

def test_classification_of_the_serving_shape():
    both(_cls)


def test_block_bytes_tile_the_ring_exactly():
    def run(s):
        cfg, shape = _cfg(s), _shape(s)
        mesh = {"data": 1, "model": 1}
        out = []
        for block in (64, 256):
            plan = s.PR.MemoryPlan(kv_block_size=block)
            per_block = s.PR.kv_block_bytes_per_device(cfg, shape, plan, mesh)
            lane = s.PR.lane_bytes_per_device(cfg, shape, plan, mesh)
            one = dataclasses.replace(shape, global_batch=1)
            ring = s.PR.cache_bytes_per_device(cfg, one, plan, mesh)
            assert per_block > 0
            assert per_block * (shape.context // block) + lane == \
                pytest.approx(ring)
            out.append((per_block, lane, ring))
        return out
    both(run)


def test_block_bytes_kv_shard_aware():
    def run(s):
        cfg = dataclasses.replace(_cfg(s), name="nemo-kv2", n_kv_heads=2)
        mesh = {"data": 1, "model": 4}
        heads = s.PR.kv_block_bytes_per_device(
            cfg, _shape(s), s.PR.MemoryPlan(kv_shard="heads",
                                            kv_block_size=64), mesh)
        seq = s.PR.kv_block_bytes_per_device(
            cfg, _shape(s), s.PR.MemoryPlan(kv_shard="seq",
                                            kv_block_size=64), mesh)
        assert heads > seq > 0
        return heads, seq
    both(run)


def test_serving_block_capacity_is_exact():
    def run(s):
        cfg, shape, cls = _cfg(s), _shape(s), _cls(s)
        mesh = {"data": 2, "model": 2}
        plan = s.PR.MemoryPlan(kv_block_size=64)
        lanes = 4
        nb = s.PR.serving_block_capacity(cfg, shape, plan, cls, mesh,
                                         lanes=lanes, hbm_budget=24 * GIB)
        _, dp, _ = s.PR.mesh_factors(mesh)
        assert nb > 0 and nb % dp == 0
        sh = dataclasses.replace(shape, global_batch=lanes * dp)
        base = (s.PR.resident_bytes(cfg, sh, plan, mesh)
                - s.PR.cache_bytes_per_device(cfg, sh, plan, mesh)
                + lanes * s.PR.lane_bytes_per_device(cfg, sh, plan, mesh))
        tra = s.PR.transient_bytes(cfg, sh, plan, cls, mesh)
        per_block = s.PR.kv_block_bytes_per_device(cfg, shape, plan, mesh)

        def capacity_at(n):
            return s.HW.capacity_from_requirement(base + n * per_block, tra)

        assert capacity_at(nb // dp) <= 24 * GIB
        assert capacity_at(nb // dp + 1) > 24 * GIB
        return nb, base, tra, per_block
    both(run)


def test_serving_block_capacity_monotone_and_bounds():
    def run(s):
        cfg, shape, cls = _cfg(s), _shape(s), _cls(s)
        mesh = {"data": 1, "model": 1}
        plan = s.PR.MemoryPlan(kv_block_size=64)
        caps = [s.PR.serving_block_capacity(cfg, shape, plan, cls, mesh,
                                            lanes=2, hbm_budget=b * GIB)
                for b in (38, 40, 48, 64)]
        assert caps == sorted(caps) and caps[-1] > caps[0] > 0
        assert s.PR.serving_block_capacity(cfg, shape, plan, cls, mesh,
                                           lanes=1, hbm_budget=2**20) == 0
        few = s.PR.serving_block_capacity(cfg, shape, plan, cls, mesh,
                                          lanes=1, hbm_budget=48 * GIB)
        many = s.PR.serving_block_capacity(cfg, shape, plan, cls, mesh,
                                           lanes=8, hbm_budget=48 * GIB)
        assert few > many > 0
        h100 = [s.PR.serving_block_capacity(cfg, shape, plan, cls, mesh,
                                            lanes=n, hw=s.H100)
                for n in (1, 8, 64)]
        with pytest.raises(ValueError, match="kv_block_size"):
            s.PR.serving_block_capacity(cfg, shape, s.PR.MemoryPlan(), cls,
                                        mesh)
        with pytest.raises(ValueError, match="lanes"):
            s.PR.serving_block_capacity(cfg, shape, plan, cls, mesh, lanes=0)
        return caps, few, many, h100
    both(run)


def test_serving_block_capacity_avg_context_frees_blocks():
    def run(s):
        cfg, shape, cls = _cfg(s), _shape(s), _cls(s)
        mesh = {"data": 1, "model": 1}
        plan = s.PR.MemoryPlan(kv_block_size=64)
        worst = s.PR.serving_block_capacity(cfg, shape, plan, cls, mesh,
                                            lanes=8, hbm_budget=48 * GIB)
        short = s.PR.serving_block_capacity(cfg, shape, plan, cls, mesh,
                                            lanes=8, hbm_budget=48 * GIB,
                                            avg_context=128)
        assert short > worst > 0
        return worst, short
    both(run)


def test_prefill_transient_tiled_below_dense():
    def run(s):
        cfg, shape, cls = _cfg(s), _shape(s), _cls(s)
        mesh = {"data": 1, "model": 1}
        plan = s.PR.MemoryPlan(kv_block_size=64)
        kw = dict(prefill_tokens=64, mode="paper")
        out = {(r, k): s.PR.prefill_transient_bytes(cfg, shape, plan, cls,
                                                    mesh, reach=r, kernel=k,
                                                    **kw)
               for r in (256, 4096) for k in ("dense", "tiled")}
        assert out[4096, "dense"] > out[4096, "tiled"] > 0
        assert out[256, "dense"] < out[4096, "dense"]
        assert out[256, "tiled"] == out[4096, "tiled"]
        return out
    both(run)


def test_serving_block_capacity_charges_prefill_transient():
    def run(s):
        cfg, shape, cls = _cfg(s), _shape(s), _cls(s)
        mesh = {"data": 1, "model": 1}
        plan = s.PR.MemoryPlan(kv_block_size=64)
        kw = dict(lanes=8, hbm_budget=48 * GIB, avg_context=128)
        base = s.PR.serving_block_capacity(cfg, shape, plan, cls, mesh, **kw)
        tiled = s.PR.serving_block_capacity(
            cfg, shape, plan, cls, mesh, prefill_tokens=shape.context,
            prefill_kernel="tiled", **kw)
        dense = s.PR.serving_block_capacity(
            cfg, shape, plan, cls, mesh, prefill_tokens=shape.context,
            prefill_kernel="dense", **kw)
        budgeted = s.PR.serving_block_capacity(
            cfg, shape, plan, cls, mesh, prefill_tokens=64,
            prefill_kernel="tiled", **kw)
        assert base >= tiled > dense > 0 and budgeted >= tiled
        return base, tiled, dense, budgeted
    both(run)


# --- plan_serving(kv="paged") -------------------------------------------------

def test_plan_serving_paged_no_card_steps(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("measured step on the card in a hermetic test")
    monkeypatch.setattr(TMM.CudaMeasurer, "_measure", boom)

    def run(s):
        cls = _cls(s)
        lens = [60] * 7 + [2000]
        res = s.XP.plan_serving(_cfg(s), _shape(s), n_devices=4, cls=cls,
                                hbm_budget=12 * GIB, kv="paged",
                                seq_lens=lens)
        got, splan = res
        assert got is cls and splan.capacity > 0 and splan.blocks > 0
        assert splan.kv_block in s.XP.DEFAULT_KV_BLOCKS
        assert "kv_block=" in splan.describe()
        assert splan.slots(cap=3) == 3
        return _splan(res)
    both(run)


def test_plan_serving_paged_beats_ring_2x():
    def run(s):
        cfg, shape, cls = _cfg(s), _shape(s), _cls(s)
        mesh = {"data": 1, "model": 1}

        def req(n):
            sh = dataclasses.replace(shape, global_batch=n)
            return s.PR.predict(cfg, sh, s.PR.MemoryPlan(), cls,
                                mesh).capacity_bytes

        budget = (req(2) + req(3)) / 2

        def pinned(kv_blocks):
            return s.SP.serving_space(cfg, shape, max_devices=1, data=(1,),
                                      model=(1,), kv_blocks=kv_blocks)

        ring = s.XP.plan_serving(cfg, shape, n_devices=1, cls=cls,
                                 hbm_budget=budget, space=pinned((0,)))
        paged = s.XP.plan_serving(cfg, shape, n_devices=1, cls=cls,
                                  hbm_budget=budget,
                                  space=pinned((64, 256)), kv="paged",
                                  seq_lens=[60] * 7 + [shape.context])
        assert ring[1].capacity == 2
        assert paged[1].capacity >= 2 * ring[1].capacity
        assert paged[1].blocks >= paged[1].capacity
        return _splan(ring), _splan(paged)
    both(run)


def test_serving_space_kv_block_knob():
    def run(s):
        cfg, shape = _cfg(s), _shape(s)
        space = s.SP.serving_space(cfg, shape, max_devices=4,
                                   kv_blocks=(64, shape.context * 2))
        cands = space.candidates(cfg, shape)
        assert {c.plan.kv_block_size for c in cands} == {64}
        return cands
    both(run)


def test_plan_serving_prefill_budget_knob():
    def run(s):
        cfg, shape, cls = _cfg(s), _shape(s), _cls(s)
        kw = dict(n_devices=4, cls=cls, hbm_budget=12 * GIB, kv="paged",
                  seq_lens=[60] * 7 + [2000])
        tiled = s.XP.plan_serving(cfg, shape, chunk=8, prefill_budget=16,
                                  prefill_kernel="tiled", **kw)
        assert tiled[1].prefill_budget == 16
        assert "prefill_budget=16" in tiled[1].describe()
        dense = s.XP.plan_serving(cfg, shape, chunk=8, prefill_budget=16,
                                  prefill_kernel="dense", **kw)
        assert tiled[1].capacity >= dense[1].capacity > 0
        plain = s.XP.plan_serving(cfg, shape, **kw)
        assert plain[1].prefill_budget == 0
        searched = s.XP.plan_serving(cfg, shape, chunk=8,
                                     prefill_budgets=(16, 256), **kw)
        assert searched[1].prefill_budget in (16, 256)
        assert searched[1].considered == 2 * plain[1].considered
        with pytest.raises(ValueError, match="needs chunk > 0"):
            s.XP.plan_serving(cfg, shape, prefill_budget=16, **kw)
        with pytest.raises(ValueError, match="unknown prefill_kernel"):
            s.XP.plan_serving(cfg, shape, chunk=8, prefill_kernel="bogus",
                              **kw)
        with pytest.raises(ValueError, match="unknown kv mode"):
            s.XP.plan_serving(cfg, shape, n_devices=1, cls=cls, kv="slab")
        with pytest.raises(ValueError, match="unknown admission"):
            s.XP.plan_serving(cfg, shape, n_devices=1, cls=cls,
                              admission="lucky")
        return [_splan(r) for r in (tiled, dense, plain, searched)]
    both(run)


def test_plan_serving_agreement_gate():
    def run(s):
        cfg, shape, cls = _cfg(s), _shape(s), _cls(s)
        kw = dict(n_devices=4, cls=cls, hbm_budget=12 * GIB, kv="paged",
                  seq_lens=[60] * 7 + [2000],
                  kv_quants=("none", "int8", "int4"), kv_retains=(0, 4))
        free = s.XP.plan_serving(cfg, shape, **kw)[1]
        exact = s.XP.plan_serving(cfg, shape, min_agreement=1.0, **kw)[1]
        gated = s.XP.plan_serving(cfg, shape, min_agreement=0.99, **kw)[1]
        assert free.execution.plan.kv_quant != "none"
        assert free.capacity >= gated.capacity >= exact.capacity
        assert exact.execution.plan.kv_quant == "none" and \
            exact.agreement == 1.0
        assert gated.agreement >= 0.99 and \
            gated.execution.plan.kv_quant == "int8"
        assert "agreement>=" in gated.describe()
        with pytest.raises(ValueError, match="min_agreement"):
            s.XP.plan_serving(cfg, shape, n_devices=4, cls=cls,
                              hbm_budget=12 * GIB, kv="paged",
                              seq_lens=(2000,), kv_quants=("int4",),
                              kv_retains=(0,), min_agreement=0.999)
        lad = s.XP.ladder_priors(gated, 32, min_agreement=0.9)
        return [(p, p.describe()) for p in (free, exact, gated)], lad
    both(run)


# --- plan_serving(kv="ring") ----------------------------------------------------

def test_plan_serving_ring_mesh_and_slots():
    """tests/test_serving.py's plan_serving section (h2o-danube-1.8b)."""
    def run(s):
        arch = "h2o-danube-1.8b"
        cfg, shape = _cfg(s, arch), _shape(s)
        cls = _cls(s, arch)
        auto = s.XP.plan_serving(cfg, shape, n_devices=8, cls=cls,
                                 hbm_budget=8 * GIB)
        one = s.XP.plan_serving(cfg, shape, n_devices=1, cls=cls,
                                hbm_budget=8 * GIB)
        assert auto[1].capacity >= one[1].capacity > 0
        assert auto[1].execution.schedule == "single"
        tight_auto = s.XP.plan_serving(cfg, shape, n_devices=8, cls=cls,
                                       hbm_budget=3 * GIB)
        pinned = s.SP.serving_space(cfg, shape, max_devices=8, data=(1,),
                                    model=(1,))
        host = s.XP.plan_serving(cfg, shape, n_devices=8, cls=cls,
                                 hbm_budget=3 * GIB, space=pinned)
        assert tight_auto[1].capacity > host[1].capacity
        assert auto[1].slots() == auto[1].capacity
        assert auto[1].slots(cap=4) == 4
        return [_splan(r) for r in (auto, one, tight_auto, host)]
    both(run)


# --- the grid: every arch, every mode -----------------------------------------

GRID = (
    dict(kv="ring"),
    dict(kv="ring", n_devices=4),
    dict(kv="paged"),
    dict(kv="paged", compact=True),
    dict(kv="paged", compact=True, admission="worst"),
    dict(kv="paged", admission="optimistic", sigma_k=1.0),
    dict(kv="paged", kv_quants=("none", "int8", "int4"), kv_retains=(0, 8)),
    dict(kv="paged", kv_quants=("none", "int8", "int4"), kv_retains=(0, 8),
         min_agreement=0.99),
    dict(kv="paged", compact=True, chunk=64, prefill_budget=256,
         prefill_kernel="tiled"),
    dict(kv="paged", chunk=64, prefill_budgets=(128, 512),
         prefill_kernel="dense"),
    dict(kv="paged", n_devices=4, kv_blocks=(16, 128)),
)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_serving_equal_on_every_arch(arch):
    """plan_serving over the GRID of modes (classification included, by
    the simulator ladder), on a context-2048 trace of mostly-short
    requests, at a tight budget, the TPU's 16 GiB and the H100's 80 GB:
    every returned ServingPlan, describe() string, slot count and pool size
    equal."""
    def run(s):
        cfg = _cfg(s, arch)
        shape = _shape(s, context=2048, batch=8)
        lens = [63, 200, 255, 519, 1040, 2047, 100, 300]
        out = []
        for hw, budget in ((s.HW.TPU_V5E, 6 * GIB), (s.HW.TPU_V5E, None),
                           (s.H100, None)):
            for g in GRID:
                kw = dict(g)
                n = kw.pop("n_devices", 1)
                if kw["kv"] == "paged":
                    kw.setdefault("seq_lens", lens)
                try:
                    cls, splan = s.XP.plan_serving(
                        cfg, shape, n_devices=n, hbm_budget=budget, hw=hw,
                        **kw)
                except ValueError as e:       # e.g. no candidate passes
                    out.append(("ValueError", str(e)))
                    continue
                out.append((cls, splan, splan.describe(),
                            splan.slots(cap=8),
                            splan.pool_blocks(splan.slots(cap=8), 2048)))
        return out
    both(run)
