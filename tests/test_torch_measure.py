"""The port's measurement backends (repro_torch.core.measure) against the
reference package's: the simulator's profiles field by field for all ten
archs, the profile cache's file format both ways, twins of the hermetic
tests of tests/test_measure.py (simulator physics, cache, the WSMC
pipeline end to end with no measured step), and the card backend
(CudaMeasurer): it refuses anything but a CUDA device, and its arithmetic
(profile_from_measured, the bytes it reads around one step) on given byte
counts. The compile- and dry-run-backed tests there have no twin: the
port's expensive backend runs on the card."""
import dataclasses
import enum
import types

import pytest
import torch

from repro import hw as JHW
from repro.configs import ARCH_IDS, SHAPES as JSHAPES, get_config as jget
from repro.configs import shape_applicable as j_applicable
from repro.configs.base import ShapeConfig as JShape
from repro.core import expansion as JE
from repro.core import measure as JMM
from repro.core import planner as JPL
from repro.core import predictor as JPR
from repro.core import profiler as JPF
from repro.core.classifier import classify_profiles as j_classify
from repro_torch import hw as THW
from repro_torch.configs import SHAPES as TSHAPES, get_config as tget
from repro_torch.configs import shape_applicable as t_applicable
from repro_torch.configs.base import ShapeConfig as TShape, param_count
from repro_torch.core import expansion as TE
from repro_torch.core import measure as TMM
from repro_torch.core import planner as TPL
from repro_torch.core import predictor as TPR
from repro_torch.core import profiler as TPF
from repro_torch.core.classifier import classify_profiles as t_classify
from repro_torch.tree import tree_leaves

MESH = {"data": 16, "model": 16}
J = types.SimpleNamespace(name="reference", HW=JHW, get=jget, SHAPES=JSHAPES,
                          Shape=JShape, MM=JMM, PL=JPL, PR=JPR, PF=JPF,
                          classify=j_classify, applicable=j_applicable)
T = types.SimpleNamespace(name="port", HW=THW, get=tget, SHAPES=TSHAPES,
                          Shape=TShape, MM=TMM, PL=TPL, PR=TPR, PF=TPF,
                          classify=t_classify, applicable=t_applicable)
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


def sim(s, mesh=None, cache=None, ep=False):
    return s.MM.SimulatedMeasurer(mesh or MESH, cache=cache, ep=ep)


@pytest.fixture
def no_card_steps(monkeypatch):
    """Trip an assertion if anything reaches a measured step on the card
    (the port's counterpart of the reference tests' compile guard)."""
    def boom(*a, **k):
        raise AssertionError("measured step on the card in a hermetic test")
    monkeypatch.setattr(TMM.CudaMeasurer, "_measure", boom)


# --- the simulator, field by field -------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_simulated_profiles_equal_field_by_field(arch):
    """Every MemoryProfile field (and the derived peak / α) equal across
    the two packages: train, prefill and decode shapes, three meshes, plans
    across the knobs, both EP modes."""
    plans = (dict(), dict(remat="full", microbatches=4),
             dict(remat="dots", optimizer="adafactor", kv_shard="seq"),
             dict(microbatches=8, optimizer="adamw_bf16"))
    meshes = (MESH, {"data": 1, "model": 1}, {"data": 4, "model": 2,
                                              "pipe": 2})

    def run(s):
        cfg = s.get(arch)
        out = []
        for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = s.SHAPES[shape_name]
            for mesh in meshes:
                for ep in (False, True):
                    m = sim(s, mesh, ep=ep)
                    for kw in plans:
                        p = m.measure(cfg, shape, s.PR.MemoryPlan(**kw))
                        out.append((p, p.peak_bytes, p.alpha,
                                    p.stage_transient_bytes))
        return out
    both(run)


# --- simulator physics --------------------------------------------------------

def test_resident_at_least_sharded_params():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        p = sim(s).measure(cfg, s.SHAPES["train_4k"])
        assert p.argument_bytes >= (param_count(tget("h2o-danube-1.8b"))
                                    * s.PR.BYTES_PARAM / 256)
        return p
    both(run)


def test_train_remat_ordering():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        temps = [sim(s).measure(cfg, shape, s.PR.MemoryPlan(remat=r))
                 .transient_bytes for r in ("none", "dots", "full")]
        assert temps[0] > temps[1] > temps[2]
        return temps
    both(run)


def test_train_microbatching_shrinks_transients():
    def run(s):
        cfg = s.get("mixtral-8x7b")
        shape = s.SHAPES["train_4k"]
        t1 = sim(s).measure(cfg, shape, s.PR.MemoryPlan(microbatches=1))
        t8 = sim(s).measure(cfg, shape, s.PR.MemoryPlan(microbatches=8))
        assert t8.transient_bytes < t1.transient_bytes
        assert t8.argument_bytes > t1.argument_bytes
        return t1, t8
    both(run)


def test_optimizer_knob_changes_resident_only():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        f32 = sim(s).measure(cfg, shape,
                             s.PR.MemoryPlan(optimizer="adamw_f32"))
        af = sim(s).measure(cfg, shape,
                            s.PR.MemoryPlan(optimizer="adafactor"))
        assert f32.argument_bytes > af.argument_bytes
        assert f32.transient_bytes == pytest.approx(af.transient_bytes)
        return f32, af
    both(run)


def test_decode_resident_includes_cache_and_grows_with_context():
    def run(s):
        cfg = s.get("mistral-nemo-12b")
        short = dataclasses.replace(s.SHAPES["decode_32k"], seq_len=4_096)
        long = s.SHAPES["decode_32k"]
        ps, pl = sim(s).measure(cfg, short), sim(s).measure(cfg, long)
        assert pl.argument_bytes > ps.argument_bytes
        cache = s.PR.cache_bytes_per_device(cfg, long, s.MM.BASELINE_PLAN,
                                            MESH)
        assert cache > 0 and pl.argument_bytes >= cache
        return ps, pl, cache
    both(run)


def test_sharding_scales_down_with_mesh():
    def run(s):
        cfg = s.get("gemma3-12b")
        shape = s.SHAPES["train_4k"]
        small = sim(s, {"data": 4, "model": 2}).measure(cfg, shape)
        big = sim(s, {"data": 16, "model": 16}).measure(cfg, shape)
        assert big.argument_bytes < small.argument_bytes
        assert big.transient_bytes < small.transient_bytes
        return small, big
    both(run)


def test_attention_transient_superlinear_recurrent_linear():
    def run(s):
        def stage_ratio(arch):
            cfg = s.get(arch)
            m = sim(s)
            a = m.measure(cfg, s.Shape("a", "train", 1024, 256))
            b = m.measure(cfg, s.Shape("b", "train", 8192, 256))
            return b.stage_transient_bytes / a.stage_transient_bytes
        att, rec = stage_ratio("h2o-danube-1.8b"), stage_ratio("xlstm-1.3b")
        assert att > rec and att > 8.0
        return att, rec
    both(run)


# --- profile cache ----------------------------------------------------------

def test_cache_roundtrip_and_hit(tmp_path):
    def run(s):
        path = str(tmp_path / f"{s.name}.json")
        cache = s.MM.ProfileCache(path)
        m = sim(s, cache=cache)
        cfg = s.get("h2o-danube-1.8b")
        p1 = m.measure(cfg, s.SHAPES["train_4k"])
        assert cache.misses == 1 and cache.hits == 0
        p2 = m.measure(cfg, s.SHAPES["train_4k"])
        assert cache.hits == 1 and p2 == p1
        cache2 = s.MM.ProfileCache(path)
        assert len(cache2) == 1
        assert sim(s, cache=cache2).measure(cfg, s.SHAPES["train_4k"]) == p1
        assert cache2.hits == 1
        with open(path) as f:
            return p1, f.read()
    both(run)


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J)],
                         ids=["reference-to-port", "port-to-reference"])
def test_cache_file_is_shared_between_packages(tmp_path, writer, reader):
    """A ProfileCache file one package writes, the other reads: the same
    JSON format and keys (backend::arch::shape::plan::mesh), every entry a
    hit with equal fields."""
    path = str(tmp_path / "profiles.json")
    cache = writer.MM.ProfileCache(path)
    keys = []
    for arch in ("h2o-danube-1.8b", "mistral-nemo-12b", "xlstm-1.3b"):
        for shape_name in ("train_4k", "decode_32k"):
            for ep in (False, True):
                m = sim(writer, cache=cache, ep=ep)
                m.measure(writer.get(arch), writer.SHAPES[shape_name],
                          writer.PR.MemoryPlan(remat="dots"))
    keys = sorted(cache._data)
    back = reader.MM.ProfileCache(path)
    assert sorted(back._data) == keys and len(keys) == 12
    for arch in ("h2o-danube-1.8b", "mistral-nemo-12b", "xlstm-1.3b"):
        for shape_name in ("train_4k", "decode_32k"):
            for ep in (False, True):
                m = sim(reader, cache=back, ep=ep)
                got = m.measure(reader.get(arch), reader.SHAPES[shape_name],
                                reader.PR.MemoryPlan(remat="dots"))
                want = sim(writer, ep=ep).measure(
                    writer.get(arch), writer.SHAPES[shape_name],
                    writer.PR.MemoryPlan(remat="dots"))
                assert norm(got) == norm(want)
    assert back.hits == 12 and back.misses == 0


def test_cache_key_separates_backends_plans_meshes():
    def run(s):
        cfg = s.get("h2o-danube-1.8b")
        shape = s.SHAPES["train_4k"]
        base = s.MM.profile_key("simulate", cfg, shape, s.MM.BASELINE_PLAN,
                                MESH)
        others = [s.MM.profile_key("cuda", cfg, shape, s.MM.BASELINE_PLAN,
                                   MESH),
                  s.MM.profile_key("simulate", cfg, shape,
                                   s.PR.MemoryPlan(remat="full"), MESH),
                  s.MM.profile_key("simulate", cfg, shape,
                                   s.MM.BASELINE_PLAN,
                                   {"data": 4, "model": 2})]
        assert all(k != base for k in others)
        return base, others
    both(run)


def test_cache_survives_corrupt_file(tmp_path):
    def run(s):
        path = tmp_path / f"{s.name}.json"
        path.write_text("{not json")
        cache = s.MM.ProfileCache(str(path))
        assert len(cache) == 0
        sim(s, cache=cache).measure(s.get("h2o-danube-1.8b"),
                                    s.SHAPES["train_4k"])
        assert len(s.MM.ProfileCache(str(path))) == 1
        return path.read_text()
    both(run)


def test_measurer_factory():
    m = TMM.measurer_for("simulate", MESH)
    assert isinstance(m, TMM.SimulatedMeasurer)
    with pytest.raises(ValueError):
        TMM.measurer_for("quantum", MESH)
    # the port's expensive backend is "cuda"; the reference's "compile"
    # (XLA) has no counterpart
    with pytest.raises(ValueError):
        TMM.measurer_for("compile", MESH)
    with pytest.raises(TypeError):
        TMM.SimulatedMeasurer(object())
    assert norm(JMM.BASELINE_PLAN) == norm(TMM.BASELINE_PLAN)


# --- the full WSMC pipeline, no step on the card -------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pipeline_end_to_end_zero_card_steps(arch, no_card_steps):
    def run(s):
        m = sim(s)
        cfg = s.get(arch)
        out = []
        for shape_name in ("train_4k", "decode_32k"):
            shape = s.SHAPES[shape_name]
            if not s.applicable(cfg, shape)[0]:
                continue
            ladder = s.PF.profile_ladder(cfg, shape, None, n_points=3,
                                         measurer=m)
            assert 1 <= len(ladder) <= 3
            cls = s.classify(ladder)
            pred = s.PR.predict(cfg, shape, s.MM.BASELINE_PLAN, cls, MESH)
            assert pred.capacity_bytes > 0
            dec = s.PL.wsmc_plan(cfg, shape, cls, MESH)
            assert dec.policy in ("wsmc", "wsmc_overflow")
            plan, peak, n = s.PL.oracle_plan(cfg, shape, measurer=m,
                                             max_candidates=8)
            assert peak > 0 and n >= 1
            out.append((ladder, cls, pred, dec, plan, peak, n))
        return out
    both(run)


def test_oracle_needs_measure_or_measurer():
    for s in SIDES:
        with pytest.raises(TypeError):
            s.PL.oracle_plan(s.get("h2o-danube-1.8b"), s.SHAPES["train_4k"])


def test_oracle_simulator_prefers_fitting_plan(no_card_steps):
    def run(s):
        hbm = dataclasses.replace(s.HW.TPU_V5E, hbm_bytes=2 * 2**30)
        cfg = s.get("mixtral-8x7b")
        shape = s.SHAPES["train_4k"]
        plan, peak, n = s.PL.oracle_plan(cfg, shape, measurer=sim(s),
                                         hw=hbm)
        budget = hbm.hbm_bytes / s.HW.CAPACITY_HEADROOM - hbm.reserved_bytes
        m = sim(s)
        if peak <= budget:
            assert n >= 1
        else:
            cands = s.PL.candidate_plans(cfg, shape)
            best = min(m.measure_peak(cfg, shape, p) for p in cands)
            assert peak == pytest.approx(best)
        return plan, peak, n
    both(run)


def test_classifier_sees_category_spread(no_card_steps):
    def run(s):
        m = sim(s)
        out = []
        for arch in ("h2o-danube-1.8b", "xlstm-1.3b", "gemma3-12b"):
            cfg = s.get(arch)
            for shape_name in ("train_4k", "decode_32k"):
                out.append(s.PF.classify_workload(cfg, s.SHAPES[shape_name],
                                                  None, measurer=m))
        assert len({c.category for c in out}) >= 2
        return out
    both(run)


# --- the card backend ------------------------------------------------------------

def test_cuda_measurer_refuses_the_cpu():
    """No fallback hides the device: CudaMeasurer raises on a CPU device,
    without a CUDA device, and for a mesh of more than one device; the
    profiler's default backend is it, so a default profile raises too."""
    cfg = tget("h2o-danube-1.8b").reduced()
    shape = TShape("t", "decode", 1024, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        TMM.CudaMeasurer({"data": 1}, device="cpu")
    with pytest.raises(NotImplementedError, match="one card"):
        TMM.CudaMeasurer({"data": 2}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            TMM.CudaMeasurer({"data": 1})
        with pytest.raises(RuntimeError, match="is_available"):
            TMM.measurer_for("cuda", {"data": 1})
        with pytest.raises(RuntimeError, match="is_available"):
            TPF.profile_point(cfg, shape, None)
        with pytest.raises(RuntimeError, match="is_available"):
            TPF.classify_workload(cfg, shape, {"data": 1})


def test_profile_from_measured_arithmetic():
    """profile_from_measured on given byte counts builds the MemoryProfile
    the reference's profile_from_compiled builds from the same four numbers
    (XLA's argument / temp / output / peak), field by field."""
    for arch in ("mistral-nemo-12b", "xlstm-1.3b", "gemma3-12b"):
        for kind, seq, batch in (("train", 512, 8), ("prefill", 2048, 4),
                                 ("decode", 1024, 8)):
            arg, tmp, out, peak = 24.5e9, 1.25e9 + seq, 3.5e6, 26.1e9
            ma = types.SimpleNamespace(argument_size_in_bytes=arg,
                                       temp_size_in_bytes=tmp,
                                       output_size_in_bytes=out,
                                       peak_memory_in_bytes=peak)
            compiled = types.SimpleNamespace(memory_analysis=lambda: ma)
            want = JE.profile_from_compiled(
                compiled, jget(arch), JShape("x", kind, seq, batch), 1, 1)
            got = TE.profile_from_measured(
                tget(arch), TShape("x", kind, seq, batch), arg, tmp, out,
                peak, 1, 1)
            assert norm(got) == norm(want)
            assert got.peak_bytes == arg + tmp + out
            assert got.alpha == pytest.approx(
                tmp / tget(arch).n_layers / got.input_bytes, rel=1e-12)


class _FakeCuda:
    """The four allocator readings CudaMeasurer takes, scripted: the bytes
    allocated before the step, the peak over it, the bytes after it."""

    def __init__(self, before, peak, after):
        self.reads = [before, after]
        self.peak = peak
        self.resets = 0

    def memory_allocated(self, dev=None):
        return self.reads.pop(0)

    def max_memory_allocated(self, dev=None):
        return self.peak

    def reset_peak_memory_stats(self, dev=None):
        self.resets += 1


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cuda_measurer_step_arithmetic(kind, monkeypatch):
    """CudaMeasurer's step and bytes, run on the CPU with the allocator's
    readings scripted: the step of each kind runs on the placed tensors,
    argument = the placed tensors' bytes, output = after - before,
    transient = peak - before - output; one set of params per config is
    kept across measurements."""
    fake = _FakeCuda(before=10_000_000, peak=10_000_000 + 7_654_321,
                     after=10_000_000 + 123_456)
    for name in ("memory_allocated", "max_memory_allocated",
                 "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    m = object.__new__(TMM.CudaMeasurer)
    TMM.MemoryMeasurer.__init__(m, {"data": 1})
    m.device, m._params = torch.device("cpu"), None
    cfg = tget("h2o-danube-1.8b").reduced()
    shape = TShape("t", kind, 64, 2)
    plan = TPR.MemoryPlan(optimizer="adafactor") if kind == "train" \
        else TPR.MemoryPlan()
    params = m.params_for(cfg)
    p = m.measure(cfg, shape, plan)
    assert m.params_for(cfg) is params and fake.resets == 1
    n_params = sum(t.numel() * t.element_size()
                   for t in tree_leaves(params))
    assert p.argument_bytes > n_params
    assert p.output_bytes == 123_456
    assert p.transient_bytes == 7_654_321 - 123_456
    assert p.reported_peak == p.argument_bytes + 7_654_321
    assert p.peak_bytes == p.reported_peak
    assert (p.kind, p.seq_len, p.global_batch, p.n_stages) == \
        (kind, 64, 2, cfg.n_layers)
    assert p.input_bytes == TE.embedded_input_bytes(cfg, shape, 1, 1)
    if kind == "decode":
        with pytest.raises(NotImplementedError, match="paged"):
            m.measure(cfg, shape, TPR.MemoryPlan(kv_block_size=16))
