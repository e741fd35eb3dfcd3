"""The port's WSMC front end — classifier, profiler (ladder, classification,
knowledge base), planner and the planning half of the sharding strategies
— against the reference package's: twins of the classifier and planner
sections of tests/test_wsmc.py and of tests/test_profiler_kb.py, and
classify_workload / wsmc_plan / default_plan / oracle_plan (simulator) /
plan_deployment on all ten archs, compared exactly at the TPU v5e's
numbers and at the H100's (handed to the reference as its own
HardwareSpec; it has no H100)."""
import dataclasses
import enum
import types

import jax
import pytest

from repro import hw as JHW
from repro.configs import ARCH_IDS, SHAPES as JSHAPES, get_config as jget
from repro.configs import shape_applicable as j_applicable
from repro.configs.base import ShapeConfig as JShape
from repro.core import classifier as JC
from repro.core import expansion as JE
from repro.core import measure as JMM
from repro.core import planner as JPL
from repro.core import predictor as JPR
from repro.core import profiler as JPF
from repro.parallel import sharding as JS
from repro.search import execplan as JXP
from repro_torch import hw as THW
from repro_torch.configs import SHAPES as TSHAPES, get_config as tget
from repro_torch.configs import shape_applicable as t_applicable
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core import classifier as TC
from repro_torch.core import expansion as TE
from repro_torch.core import measure as TMM
from repro_torch.core import planner as TPL
from repro_torch.core import predictor as TPR
from repro_torch.core import profiler as TPF
from repro_torch.parallel import axes as TAX
from repro_torch.parallel import sharding as TS
from repro_torch.search import execplan as TXP

MESH = {"data": 16, "model": 16}
J = types.SimpleNamespace(name="reference", HW=JHW, get=jget, SHAPES=JSHAPES,
                          Shape=JShape, C=JC, E=JE, MM=JMM, PL=JPL, PR=JPR,
                          PF=JPF, S=JS, XP=JXP, applicable=j_applicable,
                          H100=JHW.HardwareSpec(**dataclasses.asdict(
                              THW.H100)))
T = types.SimpleNamespace(name="port", HW=THW, get=tget, SHAPES=TSHAPES,
                          Shape=TShape, C=TC, E=TE, MM=TMM, PL=TPL, PR=TPR,
                          PF=TPF, S=TS, XP=TXP, applicable=t_applicable,
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


def _hws(s):
    return (s.HW.TPU_V5E, s.H100)


def _cls(s, cat="Medium", alpha=0.8, inc=1.0, slope=0.8, intercept=0.0):
    return s.C.Classification(category=s.C.Category(cat), alpha=alpha,
                              inc=inc, slope=slope, intercept=intercept)


def _mk_profile(s, alpha, input_bytes=1e6, n_stages=1, seq=512):
    return s.E.MemoryProfile(
        arch="x", shape_name="s", kind="train", n_devices=8, seq_len=seq,
        global_batch=8, n_stages=n_stages, input_bytes=input_bytes,
        argument_bytes=0.0, transient_bytes=alpha * input_bytes * n_stages,
        output_bytes=0.0, reported_peak=0.0)


# --- classifier: Table I / II thresholds ----------------------------------------

@pytest.mark.parametrize("alpha,inc,cat", [
    (1.0, 2.0, "Expanding.Rapid"),
    (1.5, 2.5, "Expanding.Rapid"),
    (1.0, 1.9, "Expanding.Medium"),
    (5.0, 0.5, "Expanding.Medium"),
    (0.75, 5.0, "Medium"),
    (0.51, 0.1, "Medium"),
    (0.5, 9.0, "Shrinking"),
    (0.1, 0.0, "Shrinking"),
])
def test_classify_thresholds(alpha, inc, cat):
    assert both(lambda s: s.C.classify(alpha, inc)).value == cat


def test_classification_partitions_space():
    def run(s):
        out = []
        for alpha in (0.0, 0.3, 0.5, 0.7, 1.0, 3.0, 50.0):
            for inc in (0.0, 1.0, 2.0, 10.0):
                c = s.C.classify(alpha, inc)
                assert c in s.C.Category
                out.append(c)
        return out
    both(run)


def test_factor_table_is_papers():
    got = both(lambda s: {c.value: f for c, f in s.C.FACTOR_SHUF.items()})
    assert got == {"Expanding.Rapid": 4, "Expanding.Medium": 3,
                   "Medium": 2, "Shrinking": 1}


def test_classify_profiles_and_expansion_ratios():
    """Eqs. 4 / 5 and the classification of a ladder, on profiles built by
    each package from the same bytes (linear, superlinear, one point)."""
    def run(s):
        out = []
        for xs, sq in (((1e6, 2e6, 4e6), False), ((1e6, 2e6, 4e6), True),
                       ((3e6,), False)):
            ps = []
            for x in xs:
                p = _mk_profile(s, 2.0, input_bytes=x)
                if sq:
                    p = dataclasses.replace(p, transient_bytes=x * x / 1e6)
                ps.append(p)
            out.append((s.E.mean_expansion_ratio(ps),
                        s.E.increasing_rate(ps), s.E.fitted_slope(ps),
                        s.E.fitted_intercept(ps), s.C.classify_profiles(ps)))
        return out
    both(run)


# --- planner ----------------------------------------------------------------

def test_candidate_lattice_fastest_first():
    def run(s):
        cands = s.PL.candidate_plans(s.get("h2o-danube-1.8b"),
                                     s.SHAPES["train_4k"])
        pens = [p.step_time_penalty() for p in cands]
        assert pens == sorted(pens)
        assert cands[0].remat == "none" and cands[0].microbatches == 1
        return cands
    both(run)


def test_wsmc_plan_picks_first_fitting():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        out = []
        for hw in _hws(s):
            dec = s.PL.wsmc_plan(cfg, shape, _cls(s), MESH, hw=hw)
            assert dec.prediction.fits and dec.policy == "wsmc"
            cands = [p for p in s.PL.candidate_plans(cfg, shape)
                     if (shape.global_batch // p.microbatches) % 16 == 0]
            for faster in cands[:cands.index(dec.plan)]:
                assert not s.PR.predict(cfg, shape, faster, _cls(s), MESH,
                                        hw=hw).fits
            out.append(dec)
        return out
    both(run)


def test_default_plan_is_safest():
    def run(s):
        plan = s.PL.default_plan(s.get("h2o-danube-1.8b"),
                                 s.SHAPES["train_4k"])
        assert plan.remat == "full" and plan.optimizer == "adafactor"
        return plan
    both(run)


def test_oracle_search_counts_measurements():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        out = []
        for hw in _hws(s):
            budget = hw.hbm_bytes / s.HW.CAPACITY_HEADROOM - hw.reserved_bytes
            calls = []

            def fake_measure(plan):
                calls.append(plan)
                return budget * (0.5 if plan.remat == "full" else 10.0)

            plan, peak, n = s.PL.oracle_plan(cfg, shape, fake_measure, hw=hw)
            assert plan.remat == "full" and n == len(calls) and n > 1
            out.append((plan, peak, n))
        return out
    both(run)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_wsmc_pipeline_equal_on_every_arch(arch):
    """classify_workload (simulator ladder) -> wsmc_plan / default_plan /
    oracle_plan (simulator) / plan_deployment over train, prefill and
    decode shapes, at the TPU's 16 GiB and the H100's 80 GB: the same
    classes, plans, predictions, peaks and runnable execution plans."""
    def run(s):
        cfg = s.get(arch)
        m = s.MM.SimulatedMeasurer(MESH)
        out = []
        for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = s.SHAPES[shape_name]
            if not s.applicable(cfg, shape)[0]:
                continue
            cls = s.PF.classify_workload(cfg, shape, None, n_points=3,
                                         measurer=m)
            out.append((cls, s.PL.default_plan(cfg, shape)))
            for hw in _hws(s):
                out.append(s.PL.wsmc_plan(cfg, shape, cls, MESH, hw=hw))
                out.append(s.PL.oracle_plan(cfg, shape, measurer=m, hw=hw,
                                            max_candidates=6))
                for n, strategy in ((1, "fastest"), (8, "fastest"),
                                    (8, "staged")):
                    ep = s.PL.plan_deployment(cfg, shape, cls, n_devices=n,
                                              strategy=strategy, hw=hw)
                    out.append((ep, ep.describe(), ep.n_devices))
        return out
    both(run)


def test_auto_plan_and_execution_build():
    """auto_plan (the `--mesh auto` preamble) agrees; a one-device plan
    builds without a mesh, a larger one is refused in a world of one rank
    with the reference's message (a live world of more ranks builds it:
    tests/test_torch_mesh_train.py)."""
    def run(s):
        cfg = s.get("h2o-danube-1.8b").reduced()
        shape = s.Shape("t", "train", 256, 8)
        return [s.XP.auto_plan(cfg, shape, n_devices=n) for n in (1, 4)]
    cls1, ep1 = both(run)[0]
    mesh, strategy = ep1.build()
    assert mesh is None and strategy == ep1.strategy()
    _, ep4 = run(T)[1]
    assert ep4.n_devices > 1
    with pytest.raises(ValueError, match=f"needs {ep4.n_devices} devices; "
                       "only 1 available"):
        ep4.build()


# --- sharding, planning half --------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_strategy_matches_reference(arch):
    """default_strategy over an {axis: size} dict equals the reference's
    over a jax Mesh of the same axes (one CPU device: sizes 1) and over no
    mesh; every strategy's rules table equals the reference's."""
    cfg_j, cfg_t = jget(arch), tget(arch)
    assert norm(JS.default_strategy(cfg_j, None)) == \
        norm(TS.default_strategy(cfg_t, None))
    for axes in (("data", "model"), ("data",), ("data", "model", "pipe")):
        mesh = jax.make_mesh((1,) * len(axes), axes)
        assert norm(JS.default_strategy(cfg_j, mesh)) == \
            norm(TS.default_strategy(cfg_t, {a: 1 for a in axes}))
    for ms in ({"data": 16, "model": 16}, {"data": 4, "model": 8,
                                           "pipe": 2}, {"model": 2}):
        got = TS.default_strategy(cfg_t, ms)
        model = ms.get("model", 16)
        assert got.kv_shard == ("heads" if cfg_t.n_kv_heads % model == 0
                                else "seq")
        assert got.ep == (cfg_t.is_moe and cfg_t.n_experts % model == 0)
        assert got.pipeline == (ms.get("pipe", 1) > 1)
    assert TAX.DEFAULT_RULES == JS.pax.DEFAULT_RULES
    for ep in (False, True):
        for kv in ("heads", "seq"):
            for fsdp in (False, True):
                for pipe in (False, True):
                    kw = dict(ep=ep, kv_shard=kv, fsdp=fsdp, pipeline=pipe)
                    assert JS.Strategy(**kw).rules() == \
                        TS.Strategy(**kw).rules()


def test_strategy_for_and_tcfg_for():
    def run(s):
        cfg = s.get("mixtral-8x7b")
        plan = s.PR.MemoryPlan(remat="dots", microbatches=4,
                               optimizer="adafactor", kv_shard="seq")
        st = s.PF.strategy_for(cfg, plan, None)
        tc = s.PF._tcfg_for(plan)
        return st, (tc.remat, tc.microbatches, tc.optimizer.kind)
    both(run)


# --- profiler: ladder_shapes edge cases ------------------------------------------

def test_ladder_ascending_and_capped_at_target():
    def run(s):
        ladder = s.PF.ladder_shapes(s.Shape("t", "train", 4_096, 256),
                                    n_points=3, base_seq=512)
        assert [x.seq_len for x in ladder] == [512, 1024, 2048]
        assert all(x.kind == "train" for x in ladder)
        return ladder
    both(run)


def test_ladder_tiny_target_collapses_and_dedupes():
    def run(s):
        ladder = s.PF.ladder_shapes(s.Shape("t", "train", 256, 8),
                                    n_points=3, base_seq=512)
        assert [x.seq_len for x in ladder] == [256]
        return ladder
    both(run)


def test_ladder_min_seq_flooring():
    def run(s):
        shape = s.Shape("t", "prefill", 32_768, 32)
        a = s.PF.ladder_shapes(shape, n_points=3, base_seq=512, min_seq=512)
        assert [x.seq_len for x in a] == [1024, 2048, 4096]
        b = s.PF.ladder_shapes(shape, n_points=2, base_seq=512, min_seq=3000)
        assert b[0].seq_len == 4096
        return a, b
    both(run)


def test_ladder_decode_clamps_context():
    """Decode rungs never profile below a 1024-token cache: at the serving
    planner's base_seq of 64 every rung clamps to 1024 and dedupes to one
    shape, so the classification has one point (inc 1.0)."""
    def run(s):
        shape = s.Shape("d", "decode", 32_768, 128)
        a = s.PF.ladder_shapes(shape, n_points=3, base_seq=128)
        assert [x.seq_len for x in a] == [1024]
        b = s.PF.ladder_shapes(shape, n_points=3, base_seq=1024)
        assert [x.seq_len for x in b] == [1024, 2048, 4096]
        c = s.PF.ladder_shapes(s.Shape("serve", "decode", 2072, 8),
                               n_points=2, base_seq=64)
        assert [x.seq_len for x in c] == [1024]
        return a, b, c
    both(run)


def test_ladder_names_are_distinct():
    def run(s):
        names = [x.name for x in s.PF.ladder_shapes(
            s.Shape("t", "train", 4_096, 256), n_points=3)]
        assert len(set(names)) == len(names)
        return names
    both(run)


# --- knowledge base ------------------------------------------------------------

def _kb_entry(s, cat, alpha):
    c = s.C.Category(cat)
    return {"category": c.value, "alpha": alpha, "inc": 1.0, "slope": alpha,
            "intercept": 0.0, "factor": s.C.FACTOR_SHUF[c]}


def test_calibrated_factors_empty_kb_is_paper_table():
    def run(s):
        out = s.PF.calibrated_factors({})
        assert out == {c.value: f for c, f in s.C.FACTOR_SHUF.items()}
        return out
    both(run)


def test_calibrated_factors_envelope_with_margin():
    def run(s):
        kb = {"a::train": _kb_entry(s, "Expanding.Medium", 10.0),
              "b::train": _kb_entry(s, "Expanding.Medium", 4.0)}
        out = s.PF.calibrated_factors(kb)
        assert out["Expanding.Medium"] == pytest.approx(11.0)
        assert out["Shrinking"] == 1
        return out
    both(run)


def test_calibrated_factors_never_below_paper():
    def run(s):
        out = s.PF.calibrated_factors(
            {"a::train": _kb_entry(s, "Expanding.Rapid", 0.01)})
        assert out["Expanding.Rapid"] == 4
        return out
    both(run)


def test_build_save_load_roundtrip(tmp_path):
    def run(s):
        entries = {"h2o::train": _cls(s, "Expanding.Medium", 2.5, 1.2, 0.75,
                                      123.0),
                   "xlstm::decode": _cls(s, "Shrinking", 0.2, 1.2, 0.75,
                                         123.0)}
        kb = s.PF.build_knowledge_base(entries)
        assert kb["h2o::train"]["factor"] == 3
        path = str(tmp_path / s.name / "sub" / "kb.json")
        s.PF.save_knowledge_base(path, kb)
        loaded = s.PF.load_knowledge_base(path)
        assert loaded == kb
        factors = s.PF.calibrated_factors(loaded)
        assert factors["Expanding.Medium"] == pytest.approx(3.0)
        with open(path) as f:
            return kb, factors, f.read()
    both(run)


def test_knowledge_base_file_shared_between_packages(tmp_path):
    """A knowledge base the reference's simulator ladder classified and
    saved, the port loads and calibrates to the same factors; and the
    port's own classification of the same workloads builds the same KB."""
    def entries(s):
        m = s.MM.SimulatedMeasurer(MESH)
        return {f"{a}::{k}": s.PF.classify_workload(
            s.get(a), s.SHAPES[k], None, measurer=m)
            for a in ("h2o-danube-1.8b", "xlstm-1.3b", "gemma3-12b")
            for k in ("train_4k", "decode_32k")}
    path = str(tmp_path / "kb.json")
    JPF.save_knowledge_base(path, JPF.build_knowledge_base(entries(J)))
    loaded = TPF.load_knowledge_base(path)
    assert loaded == TPF.build_knowledge_base(entries(T))
    assert TPF.calibrated_factors(loaded) == JPF.calibrated_factors(loaded)


def test_save_knowledge_base_bare_filename(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    TPF.save_knowledge_base("kb.json", {"k": {"category": "Medium",
                                              "alpha": 1.0}})
    assert TPF.load_knowledge_base("kb.json")["k"]["alpha"] == 1.0
    assert JPF.load_knowledge_base("kb.json")["k"]["alpha"] == 1.0
