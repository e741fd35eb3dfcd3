"""The port's plan-search subsystem (repro_torch.search) against the
reference package's (repro.search): every hermetic test of
tests/test_search.py run on both sides with the same inputs, the results
compared exactly (the same floats, the same chosen candidates, the same
counts), and the reference test's own assertions held on the port's side.
The compile-backed staged-vs-exhaustive pin (slow tier there) has no twin:
the port's expensive backend runs on the card. Budgets are checked at the
TPU v5e's numbers and at the H100's (handed to the reference as its own
HardwareSpec)."""
import dataclasses
import enum
import os
import subprocess
import sys
import types

import pytest

from repro import hw as JHW
from repro.configs import ARCH_IDS, SHAPES as JSHAPES, get_config as jget
from repro.configs.base import ShapeConfig as JShape
from repro.core import classifier as JC
from repro.core import measure as JMM
from repro.core import planner as JPL
from repro.core import predictor as JPR
from repro.search import space as JSP
from repro.search import strategies as JST
from repro_torch import hw as THW
from repro_torch.configs import SHAPES as TSHAPES, get_config as tget
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core import classifier as TC
from repro_torch.core import measure as TMM
from repro_torch.core import planner as TPL
from repro_torch.core import predictor as TPR
from repro_torch.search import space as TSP
from repro_torch.search import strategies as TST

MESH = {"data": 16, "model": 16}
J = types.SimpleNamespace(name="reference", HW=JHW, get=jget, SHAPES=JSHAPES,
                          Shape=JShape, C=JC, MM=JMM, PL=JPL, PR=JPR, SP=JSP,
                          ST=JST, H100=JHW.HardwareSpec(
                              **dataclasses.asdict(THW.H100)))
T = types.SimpleNamespace(name="port", HW=THW, get=tget, SHAPES=TSHAPES,
                          Shape=TShape, C=TC, MM=TMM, PL=TPL, PR=TPR, SP=TSP,
                          ST=TST, H100=THW.H100)
SIDES = (J, T)


def norm(x):
    """A package-neutral form of planner results: dataclasses by class name
    and fields, enums by value, containers element by element."""
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
    """fn on each side; asserts the two results are equal, returns the
    port's."""
    got = [fn(s, *args, **kw) for s in SIDES]
    assert norm(got[0]) == norm(got[1])
    return got[1]


def _cls(s, cat="Medium", alpha=0.8, inc=1.0):
    return s.C.Classification(category=s.C.Category(cat), alpha=alpha,
                              inc=inc, slope=alpha, intercept=0.0)


def _hbm(s, gib):
    return dataclasses.replace(s.HW.TPU_V5E, hbm_bytes=int(gib * 2**30))


def _seed_candidate_plans(s, cfg, shape, model_size=16):
    kv = "heads" if cfg.n_kv_heads % model_size == 0 else "seq"
    if shape.kind != "train":
        return [s.PR.MemoryPlan(remat="none", microbatches=1,
                                optimizer="adamw_f32", kv_shard=kv)]
    micros = [m for m in (1, 2, 4, 8, 16, 32, 64)
              if shape.global_batch % m == 0]
    cands = [s.PR.MemoryPlan(remat=r, microbatches=m, optimizer=o,
                             kv_shard=kv)
             for r in ("none", "dots", "full") for m in micros
             for o in ("adamw_f32", "adamw_bf16", "adafactor")]
    return sorted(cands, key=lambda p: p.step_time_penalty())


def _seed_wsmc_plan(s, cfg, shape, cls, mesh_shape, hw):
    dp = mesh_shape.get("pod", 1) * mesh_shape.get("data", 1)
    model_size = mesh_shape.get("model", 16)

    def _divisible(p):
        per_micro = shape.global_batch // p.microbatches
        if shape.kind == "train":
            return per_micro % dp == 0
        return per_micro % dp == 0 or per_micro < dp

    all_cands = _seed_candidate_plans(s, cfg, shape, model_size)
    cands = [p for p in all_cands if _divisible(p)] or all_cands[-1:]
    for i, plan in enumerate(cands):
        pred = s.PR.predict(cfg, shape, plan, cls, mesh_shape, "paper", hw)
        if pred.fits:
            return plan, "wsmc", i + 1
    return cands[-1], "wsmc_overflow", len(cands)


# --- package hygiene ---------------------------------------------------------

def test_import_search_standalone():
    """`import repro_torch.search` works on its own (no prior
    repro_torch.core import), and imports neither jax nor the reference
    package."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    code = ("import sys, repro_torch.search; import repro_torch.core; "
            "repro_torch.core.wsmc_plan; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr


# --- lattice enumeration / constraints ---------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_paper_space_matches_seed_lattice(arch):
    def run(s):
        cfg = s.get(arch)
        out = []
        for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = s.SHAPES[shape_name]
            space = s.SP.paper_space(cfg, shape, MESH)
            got = [c.plan for c in space.candidates(cfg, shape)]
            assert got == _seed_candidate_plans(s, cfg, shape)
            out.append((space.name, len(space), got))
        return out
    both(run)


def test_candidate_plans_wrapper_matches_seed():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        got = s.PL.candidate_plans(cfg, shape)
        assert got == _seed_candidate_plans(s, cfg, shape)
        return got
    both(run)


def test_mesh_space_respects_constraints():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        space = s.SP.mesh_space(cfg, shape, max_devices=64, data=(4, 8, 16),
                                model=(2, 4), pipe=(1, 2))
        cands = space.candidates(cfg, shape)
        assert cands
        for c in cands:
            ms = c.mesh_shape
            assert ms["data"] * ms["model"] * ms["pipe"] <= 64
            assert shape.global_batch % c.plan.microbatches == 0
            assert (shape.global_batch // c.plan.microbatches) \
                % ms["data"] == 0
            if ms["pipe"] > 1:
                assert cfg.n_layers % ms["pipe"] == 0
                assert c.plan.microbatches >= ms["pipe"]
            if c.plan.kv_shard == "heads":
                assert cfg.n_kv_heads % ms["model"] == 0
        assert any(c.mesh_shape["pipe"] == 2 for c in cands)
        return [(c, c.step_time_penalty(), c.describe()) for c in cands]
    both(run)


def test_mesh_space_pipe_needs_layer_divisibility():
    def run(s):
        cfg = s.get("gemma3-12b")
        odd = dataclasses.replace(cfg, n_layers=47, unit=(), tail=())
        shape = s.SHAPES["train_4k"]
        space = s.SP.mesh_space(odd, shape, max_devices=64, data=(8,),
                                model=(2,), pipe=(1, 2))
        cands = space.candidates(odd, shape)
        assert all(c.mesh_shape["pipe"] == 1 for c in cands)
        return cands
    both(run)


def test_mesh_space_no_pipe_for_serving():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["decode_32k"]
        space = s.SP.mesh_space(cfg, shape, max_devices=64, data=(8,),
                                model=(2,), pipe=(1, 2))
        cands = space.candidates(cfg, shape)
        assert cands and all(c.mesh_shape["pipe"] == 1 for c in cands)
        return cands
    both(run)


def test_point_validates_knobs_and_values():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        space = s.SP.hillclimb_space()
        with pytest.raises(KeyError):
            space.point(cfg, warp_drive=True)
        with pytest.raises(ValueError):
            space.point(cfg, remat="everything")
        cand = space.point(cfg, remat="dots", ep=True)
        assert cand.plan.remat == "dots" and cand.extra("ep") is True
        assert cand.plan.microbatches == 1
        assert cand.extra("embed_onehot") is True
        return cand, len(space), cand.describe()
    both(run)


def test_subspace_pins_values():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        space = s.SP.paper_space(cfg, shape, MESH)
        sub = space.subspace(remat="full", optimizer=("adafactor",))
        cands = sub.candidates(cfg, shape)
        assert cands and all(c.plan.remat == "full"
                             and c.plan.optimizer == "adafactor"
                             for c in cands)
        with pytest.raises(KeyError):
            space.subspace(nope=1)
        with pytest.raises(ValueError):
            space.subspace(remat="everything")
        return sub.name, cands
    both(run)


def test_candidate_overrides_buckets():
    def run(s):
        space = s.SP.hillclimb_space()
        cfg = s.get("mixtral-8x7b")
        cand = space.point(cfg, ep=True, moe_group=512, q_block=1024,
                           gather_weights=True, fsdp=False)
        over = s.SP.candidate_overrides(cand)
        assert over["strategy"] == {"ep": True, "fsdp": False}
        assert over["settings"]["moe_group"] == 512
        assert over["attn"]["q_block"] == 1024
        assert over["attn"]["gather_weights"] is True
        base = s.SP.candidate_overrides(space.point(cfg))
        assert "ep" not in base["strategy"]
        return over, base
    both(run)


# --- fastest_first: decision parity with the seed planner --------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fastest_first_matches_seed_wsmc(arch):
    """Across shapes x meshes x categories x budgets (the TPU's 16 GiB, a
    0.5 GiB toy, the H100's 80 GB), both walks reproduce the seed planner's
    decisions and each other's predictions."""
    def run(s):
        cfg = s.get(arch)
        out = []
        for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = s.SHAPES[shape_name]
            for mesh in (MESH, {"pod": 2, "data": 16, "model": 16}):
                for cls in (_cls(s), _cls(s, "Expanding.Rapid", 4.0, 3.0)):
                    for hw in (s.HW.TPU_V5E, _hbm(s, 0.5), s.H100):
                        want = _seed_wsmc_plan(s, cfg, shape, cls, mesh, hw)
                        dec = s.PL.wsmc_plan(cfg, shape, cls, mesh, hw=hw)
                        assert (dec.plan, dec.policy, dec.considered) == want
                        out.append(dec)
        return out
    both(run)


def test_oracle_plan_wrapper_parity():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        budget = s.ST.plan_budget(s.HW.TPU_V5E)
        calls = []

        def fake_measure(plan):
            calls.append(plan)
            return budget * (0.5 if plan.remat == "full" else 10.0)

        plan, peak, n = s.PL.oracle_plan(cfg, shape, fake_measure)
        assert plan.remat == "full"
        assert n == len(calls) and n > 1
        assert all(p.step_time_penalty() <= plan.step_time_penalty()
                   for p in calls)
        return plan, peak, n, calls
    both(run)


def test_fastest_first_plans_the_mesh():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        space = s.SP.mesh_space(cfg, shape, max_devices=256)
        res = s.ST.fastest_first(space, cfg, shape, _cls(s))
        assert res.policy == "wsmc" and res.prediction.fits
        n = 1
        for v in res.mesh_shape.values():
            n *= v
        assert res.mesh_shape and n <= 256
        return res, res.describe_outcome()
    both(run)


# --- staged ------------------------------------------------------------------

def _counting(s):
    class CountingMeasurer(s.MM.SimulatedMeasurer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.n_measures = 0

        def _measure(self, *args, **kwargs):
            self.n_measures += 1
            return super()._measure(*args, **kwargs)
    return CountingMeasurer


def test_staged_verifies_at_most_k():
    def run(s):
        cfg = s.get("mixtral-8x7b")
        shape = s.SHAPES["train_4k"]
        space = s.SP.paper_space(cfg, shape, MESH)
        verifier = _counting(s)(MESH)
        res = s.ST.staged(space, cfg, shape,
                          screener=s.MM.SimulatedMeasurer(MESH),
                          verifier=verifier, k=5)
        assert res.policy == "staged"
        assert verifier.n_measures <= 5
        assert res.measured == verifier.n_measures
        assert res.peak_bytes <= s.ST.plan_budget(s.HW.TPU_V5E)
        assert res.considered == len(space.candidates(cfg, shape))
        assert res.considered > res.measured
        return res, verifier.n_measures
    both(run)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mixtral-8x7b",
                                  "xlstm-1.3b"])
@pytest.mark.parametrize("gib", [0.25, 2.0, 16.0])
def test_staged_never_returns_unfitting_when_fitting_exists(arch, gib):
    def run(s):
        cfg = s.get(arch)
        shape = s.SHAPES["train_4k"]
        hw = _hbm(s, gib)
        space = s.SP.paper_space(cfg, shape, MESH)
        sim = s.MM.SimulatedMeasurer(MESH)
        res = s.ST.staged(space, cfg, shape, screener=sim, verifier=sim,
                          k=5, hw=hw)
        budget = s.ST.plan_budget(hw)
        any_fits = any(sim.measure_peak(cfg, shape, c.plan) <= budget
                       for c in space.candidates(cfg, shape))
        got_peak = sim.measure_peak(cfg, shape, res.plan)
        if any_fits:
            assert res.policy == "staged" and got_peak <= budget
        else:
            assert res.policy == "staged_overflow"
        return res, got_peak
    both(run)


def test_staged_agrees_with_exhaustive_simulated():
    def run(s):
        cfg = s.get("mixtral-8x7b")
        shape = s.SHAPES["train_4k"]
        out = []
        for hw in (_hbm(s, 2.0), s.H100):
            space = s.SP.paper_space(cfg, shape, MESH)
            sim = s.MM.SimulatedMeasurer(MESH)
            st = s.ST.staged(space, cfg, shape, screener=sim, verifier=sim,
                             k=5, hw=hw)
            ex = s.ST.exhaustive_verified(space, cfg, shape, measurer=sim,
                                          hw=hw)
            assert st.plan == ex.plan and st.measured <= ex.measured
            out.append((st, ex))
        return out
    both(run)


# --- greedy coordinate descent ----------------------------------------------

def test_greedy_coordinate_reaches_feasibility():
    def run(s):
        cfg = s.get("mixtral-8x7b")
        shape = s.SHAPES["train_4k"]
        hw = _hbm(s, 4.0)
        space = s.SP.hillclimb_space(MESH)
        scorer = s.ST.CandidateScorer(measurer=s.MM.SimulatedMeasurer(MESH))
        score = s.ST.feasibility_score(scorer, cfg, shape, hw)
        start = space.point(cfg)
        res = s.ST.greedy_coordinate(space, cfg, shape, score=score,
                                     start=start, scorer=scorer)
        assert res.policy == "greedy"
        assert res.measured == scorer.calls > 0
        assert score(res.candidate) <= score(start)
        assert score(start)[0] == 1 and score(res.candidate)[0] == 0
        assert res.considered < len(space)
        return res, score(res.candidate)
    both(run)


def test_greedy_respects_constraints():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.Shape("odd", "train", 512, 6)
        space = s.SP.hillclimb_space(MESH)
        seen = []

        def score(cand):
            seen.append(cand)
            return cand.step_time_penalty()

        res = s.ST.greedy_coordinate(space, cfg, shape, score=score)
        assert all(shape.global_batch % c.plan.microbatches == 0
                   for c in seen)
        assert shape.global_batch % res.plan.microbatches == 0
        return res, seen
    both(run)


# --- plan_for façade ---------------------------------------------------------

def test_plan_for_strategies_agree_on_fitting():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        sim = s.MM.SimulatedMeasurer(MESH)
        budget = s.ST.plan_budget(s.HW.TPU_V5E)
        out = []
        for strategy in ("staged", "exhaustive", "greedy"):
            res = s.ST.plan_for(cfg, shape, None, MESH, strategy=strategy,
                                measurer=sim)
            assert sim.measure_peak(cfg, shape, res.plan) <= budget
            out.append(res)
        res = s.ST.plan_for(cfg, shape, _cls(s), MESH, strategy="fastest")
        assert res.policy in ("wsmc", "wsmc_overflow")
        out.append(res)
        res = s.ST.plan_for(cfg, shape, _cls(s), MESH, strategy="fastest",
                            hw=s.H100)
        out.append(res)
        return out
    both(run)


def test_plan_for_unknown_strategy():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        with pytest.raises(KeyError) as e:
            s.ST.plan_for(cfg, s.SHAPES["train_4k"], None, MESH,
                          strategy="magic")
        return str(e.value), s.ST.CLI_STRATEGIES
    both(run)


# --- pipe / EP mesh dimensions (simulator + predictor) -----------------------

def test_mesh_factors_pipe_shards_weights():
    def run(s):
        got = s.PR.mesh_factors({"data": 4, "model": 2, "pipe": 2})
        assert got == (16, 4, 2)
        assert s.PR.mesh_factors({"data": 4, "model": 2}) == (8, 4, 2)
        return got
    both(run)


def test_simulator_pipe_axis_shards_residents():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        plan = s.PR.MemoryPlan(microbatches=8)
        flat = s.MM.SimulatedMeasurer({"data": 4, "model": 2}).measure(
            cfg, shape, plan)
        piped = s.MM.SimulatedMeasurer(
            {"data": 4, "model": 2, "pipe": 2}).measure(cfg, shape, plan)
        assert piped.argument_bytes < flat.argument_bytes
        assert piped.transient_bytes <= flat.transient_bytes
        return flat, piped
    both(run)


def test_simulator_pipe_decode_cache_split():
    def run(s):
        cfg = s.get("mistral-nemo-12b")
        shape = s.SHAPES["decode_32k"]
        plan = s.PR.MemoryPlan(kv_shard="seq")
        c1 = s.PR.cache_bytes_per_device(cfg, shape, plan,
                                         {"data": 4, "model": 2})
        c2 = s.PR.cache_bytes_per_device(cfg, shape, plan,
                                         {"data": 4, "model": 2, "pipe": 2})
        assert c2 == pytest.approx(c1 / 2)
        return c1, c2
    both(run)


def test_simulator_ep_adds_alltoall_buffers():
    def run(s):
        cfg = s.get("mixtral-8x7b")
        shape = s.SHAPES["train_4k"]
        t_tp = s.MM.SimulatedMeasurer(MESH).measure(cfg, shape)
        t_ep = s.MM.SimulatedMeasurer(MESH, ep=True).measure(cfg, shape)
        assert t_ep.transient_bytes > t_tp.transient_bytes
        dense = s.get("h2o-danube-1.8b")
        d_tp = s.MM.SimulatedMeasurer(MESH).measure(dense, shape)
        d_ep = s.MM.SimulatedMeasurer(MESH, ep=True).measure(dense, shape)
        assert d_ep.transient_bytes == pytest.approx(d_tp.transient_bytes)
        return t_tp, t_ep, d_tp, d_ep
    both(run)


def test_ep_discriminates_profile_cache_key(tmp_path):
    def run(s):
        cache = s.MM.ProfileCache(str(tmp_path / f"{s.name}.json"))
        cfg = s.get("mixtral-8x7b")
        shape = s.SHAPES["train_4k"]
        s.MM.SimulatedMeasurer(MESH, cache=cache).measure(cfg, shape)
        s.MM.SimulatedMeasurer(MESH, cache=cache, ep=True).measure(cfg,
                                                                   shape)
        assert len(cache) == 2
        return sorted(cache._data)
    both(run)


def test_ep_none_resolves_like_default_strategy():
    def run(s):
        cfg = s.get("llama4-scout-17b-a16e")
        shape = s.SHAPES["train_4k"]
        auto = s.SP.Candidate(plan=s.PR.MemoryPlan())
        off = s.SP.Candidate(plan=s.PR.MemoryPlan(), extras=(("ep", False),))
        assert s.ST.resolved_ep(cfg, auto, MESH) is True
        assert s.ST.resolved_ep(cfg, off, MESH) is False
        assert s.ST.measure_key(auto, cfg, MESH) != \
            s.ST.measure_key(off, cfg, MESH)
        scorer = s.ST.CandidateScorer(measurer=s.MM.SimulatedMeasurer(MESH))
        pa, po = scorer.peak(cfg, shape, auto), scorer.peak(cfg, shape, off)
        assert pa > po
        dense = s.get("h2o-danube-1.8b")
        assert s.ST.resolved_ep(dense, auto, MESH) is False
        return pa, po
    both(run)


def test_scorer_builds_per_candidate_simulators():
    def run(s):
        cfg = s.get("mixtral-8x7b")
        shape = s.SHAPES["train_4k"]
        scorer = s.ST.CandidateScorer(measurer=s.MM.SimulatedMeasurer(MESH))
        small = s.SP.Candidate(plan=s.PR.MemoryPlan(),
                               mesh=(("data", 2), ("model", 2)))
        big = s.SP.Candidate(plan=s.PR.MemoryPlan(),
                             mesh=(("data", 16), ("model", 16)))
        ps, pb = scorer.peak(cfg, shape, small), scorer.peak(cfg, shape, big)
        assert ps > pb
        ep = s.SP.Candidate(plan=s.PR.MemoryPlan(), mesh=big.mesh,
                            extras=(("ep", True),))
        pe = scorer.peak(cfg, shape, ep)
        assert pe > pb
        assert scorer.calls == 3
        return ps, pb, pe
    both(run)


def test_scorer_card_backend_needs_one_device():
    """The port's expensive backend measures on one card: the scorer never
    falls back to the simulator for it, and a mesh of more devices is
    refused by the measurer it would clone."""
    with pytest.raises((ValueError, RuntimeError)):
        TMM.CudaMeasurer({"data": 1}, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        TMM.CudaMeasurer({"data": 2, "model": 1}, device="cpu")
