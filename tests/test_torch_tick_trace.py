"""The decode-tick trace's bookkeeping (launch/tick_trace.py) on synthetic
profiler events: device work is charged to the tick whose host range holds
its start, and the script refuses to run without a CUDA device."""
import os
import subprocess
import sys
from types import SimpleNamespace as NS

import pytest
import torch

from repro_torch.launch import tick_trace as T

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, dev, start, end):
    return NS(name=name, device_type=dev,
              time_range=NS(start=start, end=end))


def test_device_work_is_charged_to_the_tick_that_holds_its_start():
    events = [
        _ev("tick", CPU, 1000, 3000), _ev("tick", CPU, 5000, 6000),
        _ev("tick", CUDA, 1000, 3000),            # the range's device echo
        _ev("gemm", CUDA, 500, 900),              # before any tick
        _ev("gemm", CUDA, 1200, 1700), _ev("copy", CUDA, 2900, 3100),
        _ev("gemm", CUDA, 3500, 3600),            # between ticks
        _ev("copy", CUDA, 5000, 5250), _ev("aten::mm", CPU, 5100, 5200)]
    rows, top, n_dev = T._per_tick(events, torch)
    assert n_dev == 5
    assert rows == [
        {"host_ms": 2.0, "device_ms": 0.7, "device_events": 2},
        {"host_ms": 1.0, "device_ms": 0.25, "device_events": 1}]
    by = {r["name"]: r for r in top}
    assert by["gemm"]["ms_per_tick"] == pytest.approx(0.25)
    assert by["copy"]["ms_per_tick"] == pytest.approx(0.225)
    assert by["copy"]["count_per_tick"] == 1.0
    assert T._stats([3.0, 1.0, 2.0]) == {"n": 3, "mean": 2.0, "median": 2.0,
                                         "min": 1.0, "max": 3.0, "sum": 6.0}


def test_tick_trace_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU exit path does not apply")
    out = subprocess.run(
        [sys.executable, os.path.join("src", "repro_torch", "launch",
                                      "tick_trace.py"), "--root", "."],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
