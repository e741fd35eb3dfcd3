"""The port's dry-run (repro_torch.launch.dryrun) against the
reference's (repro.launch.dryrun) under the simulate backend, planned at
the TPU v5e's numbers: run_cell's dict on both production meshes for
every arch x shape, with --mesh auto at a 64-device budget, and the cell
files main([...]) writes, equal to the reference's with the wall-clock
`*_s` keys dropped. The card backend refuses instead of falling back: no
card, or a fixed production mesh (ROADMAP queue A item 5)."""
import importlib
import json
import os

import pytest

from repro_torch import hw as THW
from repro_torch.configs import ARCH_IDS, SHAPE_ORDER, SHAPES
from repro_torch.core import measure as MM
from repro_torch.launch import dryrun as DR


def reference(name):
    """A reference launch module, imported without leaving its
    XLA_FLAGS (512 fake devices) in this process's environment."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def timeless(x):
    """`x` without the wall-clock keys (`*_s`), at any depth."""
    if isinstance(x, dict):
        return {k: timeless(v) for k, v in x.items() if not k.endswith("_s")}
    return x


def both_meshes(mm):
    return {name: mm.SimulatedMeasurer(shape)
            for name, shape in DR.MESH_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_both_meshes_equals_reference(arch):
    """Every shape of one arch, one knowledge base a side carried across
    the shapes as the CLI carries it."""
    JDR = reference("repro.launch.dryrun")
    from repro.core import measure as JMM
    from repro.configs import SHAPES as JSHAPES
    kj, kt = {}, {}
    mj, mt = both_meshes(JMM), both_meshes(MM)
    for shape in SHAPE_ORDER:
        want = JDR.run_cell(arch, JSHAPES[shape], mj, kj)
        got = DR.run_cell(arch, SHAPES[shape], mt, kt, hw=THW.TPU_V5E)
        assert timeless(got) == timeless(want), shape
        assert "roofline" not in got       # the card backend's alone
    assert kt == kj


@pytest.mark.parametrize("shape", SHAPE_ORDER)
def test_run_cell_mesh_auto_equals_reference(shape):
    """--mesh auto at a 64-device budget (as tests/test_schedule.py runs
    the reference's), over the ten archs."""
    JDR = reference("repro.launch.dryrun")
    from repro.core import measure as JMM
    from repro.configs import SHAPES as JSHAPES
    kj, kt = {}, {}
    sj = {"screen": JMM.SimulatedMeasurer(JDR.MESH_SHAPES["single"])}
    st = {"screen": MM.SimulatedMeasurer(DR.MESH_SHAPES["single"])}
    for arch in ARCH_IDS:
        want = JDR.run_cell(arch, JSHAPES[shape], sj, kj, do_roofline=False,
                            auto_mesh=True, backend="simulate",
                            max_devices=64)
        got = DR.run_cell(arch, SHAPES[shape], st, kt, do_roofline=False,
                          auto_mesh=True, backend="simulate",
                          max_devices=64, hw=THW.TPU_V5E)
        assert timeless(got) == timeless(want), arch
        if got["status"] == "ok":
            assert got["mesh_planned"]["n_devices"] == \
                got["execution_plan"]["n_devices"] <= 64


@pytest.mark.parametrize("mesh", ["both", "auto"])
def test_main_writes_the_reference_cells(tmp_path, monkeypatch, capsys,
                                         mesh):
    JDR = reference("repro.launch.dryrun")
    monkeypatch.setattr(DR, "PLAN_HW", THW.TPU_V5E)
    argv = ["--backend", "simulate", "--arch",
            "h2o-danube-1.8b,xlstm-1.3b,mixtral-8x7b", "--shape", "all",
            "--mesh", mesh, "--max-devices", "64"]
    out = {}
    for side, main in (("ref", JDR.main), ("port", DR.main)):
        d = tmp_path / side
        assert main(argv + ["--out", str(d / "cells"),
                            "--kb", str(d / "kb.json")]) == 0
        out[side] = {n: timeless(json.loads((d / "cells" / n).read_text()))
                     for n in sorted(os.listdir(d / "cells"))}
        out[side]["kb"] = json.loads((d / "kb.json").read_text())
    assert len(out["port"]) == 13 and out["port"] == out["ref"]
    # a second run serves every cell from the files
    assert DR.main(argv + ["--out", str(tmp_path / "port" / "cells"), "--kb",
                           str(tmp_path / "port" / "kb.json")]) == 0
    assert capsys.readouterr().out.count("[cached]") == 12


def test_main_plans_for_the_h100_by_default(tmp_path):
    assert DR.PLAN_HW is THW.H100
    d = tmp_path / "cells"
    assert DR.main(["--backend", "simulate", "--arch", "h2o-danube-1.8b",
                    "--shape", "train_4k", "--mesh", "single", "--out",
                    str(d), "--kb", str(tmp_path / "kb.json")]) == 0
    cell = json.loads((d / "h2o-danube-1.8b__train_4k.json").read_text())
    tpu = DR.run_cell("h2o-danube-1.8b", SHAPES["train_4k"],
                      {"single": MM.SimulatedMeasurer(
                          DR.MESH_SHAPES["single"])}, {}, hw=THW.TPU_V5E)
    assert cell["status"] == "ok"
    assert cell["wsmc"]["plan"] != tpu["wsmc"]["plan"]   # 80 GB, not 16 GiB


@pytest.mark.parametrize("mesh", ["single", "multi", "both"])
def test_card_backend_refuses_the_production_meshes(tmp_path, mesh):
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        DR.main(["--backend", "cuda", "--mesh", mesh, "--arch",
                 "h2o-danube-1.8b", "--shape", "long_500k", "--out",
                 str(tmp_path / "c"), "--kb", str(tmp_path / "kb.json")])
    assert not (tmp_path / "c").exists()


def test_card_backend_raises_without_a_card(tmp_path):
    import torch
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="is_available"):
        DR.main(["--backend", "cuda", "--mesh", "auto", "--max-devices",
                 "1", "--arch", "h2o-danube-1.8b", "--shape", "long_500k",
                 "--out", str(tmp_path / "c"), "--kb",
                 str(tmp_path / "kb.json")])
    # run_cell itself: the planned mesh is measured on the card, which
    # raises (no simulator in its place)
    screen = {"screen": MM.SimulatedMeasurer(DR.MESH_SHAPES["single"])}
    with pytest.raises(RuntimeError, match="is_available"):
        DR.run_cell("h2o-danube-1.8b", SHAPES["long_500k"], screen, {},
                    auto_mesh=True, backend="cuda", max_devices=64)


def test_card_backend_plans_one_card(monkeypatch):
    """--backend cuda clamps the device budget to the one card the
    measurer measures on, whatever --max-devices says, and counts the
    planned step's roofline (the measurer here a stand-in for the card)."""
    seen = {}

    class Card(MM.SimulatedMeasurer):
        backend = "cuda"

        def __init__(self, mesh, cache=None):
            seen["mesh"] = dict(mesh)
            super().__init__(mesh, cache)
            self.steps, self.device = 0, None

        def release(self):
            pass

    monkeypatch.setattr(MM, "CudaMeasurer", Card)
    monkeypatch.setattr(DR, "card_entry", lambda *a, **k: {})
    screen = {"screen": MM.SimulatedMeasurer(DR.MESH_SHAPES["single"])}
    res = DR.run_cell("h2o-danube-1.8b", SHAPES["long_500k"], screen, {},
                      auto_mesh=True, backend="cuda", max_devices=256)
    assert res["status"] == "ok" and res["backend"] == "cuda"
    assert res["execution_plan"]["n_devices"] == 1
    assert MM.n_devices_of(seen["mesh"]) == 1
    # the roofline of the measured mesh: counted, under the H100
    r = res["roofline"]
    assert r["hw"] == THW.H100.name and r["n_chips"] == 1
    assert r["flops_per_chip"] > 0 and r["t_coll"] == 0.0
    assert r["t_comp"] == r["flops_per_chip"] / THW.H100.peak_flops_bf16
