"""The port's training CLI (repro_torch.launch.train) against the reference
package's (repro.launch.train), both on the simulate backend: the WSMC
online phase prints the same plan lines — `WSMC[{strategy}/simulate]`,
`WSMC[auto]`, `plan (forced)` and `execution:` — for `--mesh ''`, `--mesh
auto` and a forced plan. The port plans for `PLAN_HW` (an H100); the two
are compared at the reference's hardware (the port's PLAN_HW set to the
TPU v5e spec) and at the H100's (the reference's strategies.plan_for
handed the H100 spec by monkeypatching, nothing edited). At full width the
runs stop where the trainers make their parameters: planning is all that
is compared there."""
import dataclasses

import pytest
import torch

from repro import hw as JHW
from repro.launch import train as JLT
from repro.search import strategies as JST
from repro_torch import hw as HW
from repro_torch.launch import train as LT

JH100 = JHW.HardwareSpec(**dataclasses.asdict(HW.H100))
PLAN_PREFIXES = ("WSMC[", "plan (forced)", "execution:", "note: adjusted")


class _Stop(Exception):
    pass


def _stop(*a, **k):
    raise _Stop


def _plan_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith(PLAN_PREFIXES)]


def _run_both(argv, hw, capsys, monkeypatch, stop=False):
    """(port lines, reference lines) of the same flags, both planning for
    `hw` ("tpu" or "h100")."""
    if hw == "tpu":
        monkeypatch.setattr(LT, "PLAN_HW", HW.TPU_V5E)
    else:
        orig = JST.plan_for
        monkeypatch.setattr(JST, "plan_for", lambda *a, **kw: orig(
            *a, **{**kw, "hw": JH100}))
    if stop:
        monkeypatch.setattr(LT, "init_params", _stop)
        monkeypatch.setattr(JLT, "init_params", _stop)
    out = {}
    for name, main, extra in (("port", LT.main, ["--device", "cpu"]),
                              ("ref", JLT.main, [])):
        capsys.readouterr()
        try:
            assert main(argv + extra) == 0
        except _Stop:
            assert stop
        out[name] = capsys.readouterr().out
    return _plan_lines(out["port"]), _plan_lines(out["ref"]), out["port"]


REDUCED = ["--arch", "h2o-danube-1.8b", "--reduced", "--seq", "64",
           "--batch", "4", "--steps", "1", "--log-every", "1"]
FORCED = ["--remat", "full", "--microbatches", "3", "--optimizer",
          "adafactor"]


@pytest.mark.parametrize("hw", ["tpu", "h100"])
@pytest.mark.parametrize("mode", ["host", "auto", "forced"])
def test_reduced_run_prints_the_reference_plan(mode, hw, capsys,
                                               monkeypatch):
    argv = REDUCED + {"host": [], "auto": ["--mesh", "auto"],
                      "forced": FORCED}[mode]
    port, ref, out = _run_both(argv, hw, capsys, monkeypatch)
    assert port == ref
    head = {"host": "WSMC[fastest/simulate]: ", "auto": "WSMC[auto]: ",
            "forced": "plan (forced): "}[mode]
    assert port[0].startswith(head)
    if mode != "auto":
        assert port[-1].startswith("execution: mesh=data:1xmodel:1 ")
    if mode == "forced":
        assert "adjusted microbatches 3 -> 2" in "\n".join(port)
    assert "WSMC: predicted resident" in out and "step     0" in out


# full width, planning only: the TPU's 16 GiB and the H100's 80 GB admit
# different plans for these
FULL = [(["--arch", "h2o-danube-1.8b", "--seq", "2048", "--batch", "4"],
         "fastest"),
        (["--arch", "h2o-danube-1.8b", "--seq", "2048", "--batch", "4"],
         "staged"),
        (["--arch", "mistral-nemo-12b", "--seq", "4096", "--batch", "8"],
         "greedy"),
        (["--arch", "mixtral-8x7b", "--seq", "4096", "--batch", "8"],
         "fastest")]


@pytest.mark.parametrize("hw", ["tpu", "h100"])
@pytest.mark.parametrize("mesh", ["", "auto"])
@pytest.mark.parametrize("case", range(len(FULL)))
def test_full_width_plans_equal_reference(case, mesh, hw, capsys,
                                          monkeypatch):
    argv, strategy = FULL[case]
    argv = argv + ["--strategy", strategy, "--mesh", mesh]
    port, ref, _ = _run_both(argv, hw, capsys, monkeypatch, stop=True)
    assert port and port == ref


def test_hardware_changes_the_plan(capsys, monkeypatch):
    """The port's own plan for h2o-danube-1.8b at [4, 2048] differs between
    the TPU's memory and the H100's: the planner reads the card it plans
    for."""
    argv = FULL[0][0] + ["--device", "cpu"]
    monkeypatch.setattr(LT, "init_params", _stop)
    lines = {}
    for name, spec in (("tpu", HW.TPU_V5E), ("h100", HW.H100)):
        monkeypatch.setattr(LT, "PLAN_HW", spec)
        with pytest.raises(_Stop):
            LT.main(argv)
        lines[name] = _plan_lines(capsys.readouterr().out)
    assert lines["tpu"] != lines["h100"]


def test_refusals():
    argv = REDUCED + ["--device", "cpu"]
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        LT.main(argv + ["--arch", "xlstm-1.3b", "--mesh", "data:2,model:2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            LT.main(argv + ["--backend", "cuda"])
        with pytest.raises(RuntimeError, match="is_available"):
            LT.main(argv + ["--backend", "cuda", "--mesh", "auto"])
