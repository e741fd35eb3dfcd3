"""The port's summary tables (repro_torch.launch.summarize) against the
reference's (repro.launch.summarize) on the same cell files: load_cells,
dryrun_table, roofline_table and pick_hillclimb give the same text. The
port's report (launch.report_experiments) states the card and its own
method, and carries none of the reference's TPU narrative or numbers."""
import json
import re

import numpy as np
import pytest

from repro.launch import summarize as JS
from repro_torch import hw as THW
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import measure as MM
from repro_torch.launch import dryrun as DR
from repro_torch.launch import report_experiments as REP
from repro_torch.launch import summarize as TS
from repro_torch.roofline import analysis as RA

ARCHS = ("xlstm-1.3b", "musicgen-medium", "h2o-danube-1.8b", "gemma3-12b",
         "mixtral-8x7b")


def write_cells(d, seed, roofline=True):
    """Simulate cells of ARCHS x every shape on both meshes, a roofline
    of seeded costs on most ok cells (compute-, memory- and
    collective-bound ones among them), and one failed cell."""
    rng = np.random.default_rng(seed)
    d.mkdir()
    meshes = {n: MM.SimulatedMeasurer(s) for n, s in DR.MESH_SHAPES.items()}
    kb = {}
    for arch in ARCHS:
        for shape in SHAPES:
            c = DR.run_cell(arch, SHAPES[shape], meshes, kb)
            if roofline and c["status"] == "ok" and rng.uniform() < 0.8:
                f, b, w = rng.uniform(1e13, 1e16), rng.uniform(1e11, 1e14), \
                    rng.uniform(0, 1e12)
                cost = RA.ComponentCost(f, b, w, {"all-reduce": w})
                c["roofline"] = RA.report(
                    get_config(arch), SHAPES[shape], "single", 256, cost,
                    hw=THW.TPU_V5E).to_dict()
            (d / f"{arch}__{shape}.json").write_text(json.dumps(c))
    (d / "gemma3-12b__train_4k.json").write_text(json.dumps(
        {"arch": "gemma3-12b", "shape": "train_4k", "status": "failed",
         "error": "x"}))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tables_equal_reference(tmp_path, seed):
    write_cells(tmp_path / "cells", seed)
    mine = TS.load_cells(str(tmp_path / "cells"))
    theirs = JS.load_cells(str(tmp_path / "cells"))
    assert mine == theirs and len(mine) == 4 * len(ARCHS)
    assert TS.dryrun_table(mine) == JS.dryrun_table(theirs)
    assert TS.roofline_table(mine) == JS.roofline_table(theirs)
    assert TS.pick_hillclimb(mine) == JS.pick_hillclimb(theirs)
    assert TS.roofline_table(mine).count("\n") > 10
    assert len(TS.pick_hillclimb(mine)) == 2


def test_tables_equal_reference_without_rooflines(tmp_path):
    write_cells(tmp_path / "cells", 0, roofline=False)
    cells = TS.load_cells(str(tmp_path / "cells"))
    assert TS.dryrun_table(cells) == JS.dryrun_table(cells)
    assert TS.roofline_table(cells) == JS.roofline_table(cells)
    assert TS.pick_hillclimb(cells) == JS.pick_hillclimb(cells) == []


def card_cell(arch, shape):
    """A cell as `--backend cuda` writes it (its measured numbers made up
    here: no card)."""
    screen = {"screen": MM.SimulatedMeasurer(DR.MESH_SHAPES["single"])}
    c = DR.run_cell(arch, SHAPES[shape], screen, {}, auto_mesh=True,
                    backend="simulate", max_devices=1)
    c["backend"] = "cuda"
    c["mesh_planned"].update(
        device="NVIDIA H100 80GB HBM3", max_memory_allocated=4115868160,
        predicted_bytes=6.8e10, measured_over_predicted=0.0602,
        simulated_peak_bytes=4.167e9, measured_over_simulated=0.9876)
    cfg = get_config(arch)
    c["roofline"] = DR.card_roofline(cfg, SHAPES[shape], MM.BASELINE_PLAN,
                                     "planned", 1, DR.ModelSettings(),
                                     THW.H100)
    return c


def test_report_names_the_card_and_no_tpu(tmp_path):
    d = tmp_path / "cells"
    write_cells(d, 3)
    (d / "h2o-danube-1.8b__long_500k.json").write_text(json.dumps(
        card_cell("h2o-danube-1.8b", "long_500k")))
    hc = tmp_path / "hc"
    hc.mkdir()
    (hc / "h2o-danube-1.8b__long_500k.json").write_text(json.dumps(
        {"baseline": card_cell("h2o-danube-1.8b", "long_500k")["roofline"]}))
    text = REP.report(str(d), str(tmp_path / "none.json"), str(hc))
    for banned in ("v5e", "197e12", "TPU", "819 GB/s", "819e9"):
        assert banned not in text
    assert not re.search(r"(?<![\d.])819(?![\d.])", text)
    assert "NVIDIA H100 80GB HBM3" in text and "h100_sxm" in text
    assert "| h2o-danube-1.8b × long_500k | none/1/adamw_f32/heads | " \
        "data:1xmodel:1xpipe:1 | 3.83 | " in text
    assert TS.dryrun_table(TS.load_cells(str(d))) in text
    assert TS.roofline_table(TS.load_cells(str(d))) in text
    assert "(no knowledge base)" in text
    assert "| h2o-danube-1.8b × long_500k | baseline | " in text
