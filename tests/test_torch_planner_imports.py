"""The port's WSMC front end stands alone: the parallel planning half, the
measurement backends, profiler, planner, search and the serving CLI import
in a fresh interpreter with neither jax nor the reference package in
sys.modules, and import nothing that builds or probes the card."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
MODULES = ("repro_torch.parallel", "repro_torch.parallel.axes",
           "repro_torch.parallel.sharding", "repro_torch.core",
           "repro_torch.core.expansion", "repro_torch.core.measure",
           "repro_torch.core.profiler", "repro_torch.core.planner",
           "repro_torch.search", "repro_torch.search.space",
           "repro_torch.search.strategies", "repro_torch.search.execplan",
           "repro_torch.launch.serve")


def _run(code):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_without_jax_or_reference_package(name):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({name!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('OK')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


def test_planning_modules_do_not_need_torch():
    """Planning is device-free: the search, planner and measurement modules
    load without torch (the card backend imports it when it is built), as
    the reference's load without jax."""
    code = (
        "import sys\n"
        "import repro_torch.search, repro_torch.core.planner\n"
        "import repro_torch.core.measure, repro_torch.parallel.sharding\n"
        "assert 'torch' not in sys.modules, 'torch'\n"
        "print('OK')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr


def test_the_port_exports_what_the_reference_exports():
    """search, core and parallel export the reference's names (the card
    backend CudaMeasurer in the place of CompileMeasurer)."""
    code = (
        "import repro.search as JS, repro.core as JC\n"
        "import repro_torch.search as TS, repro_torch.core as TC\n"
        "import repro_torch.parallel as TP\n"
        "pub = lambda m: {n for n in dir(m) if not n.startswith('_')}\n"
        "assert pub(TS) == pub(JS), pub(TS) ^ pub(JS)\n"
        "want = (pub(JC) - {'CompileMeasurer'}) | {'CudaMeasurer'}\n"
        "got = pub(TC)\n"
        "assert got == want, got ^ want\n"
        "for n in JC._PLANNER_EXPORTS:\n"
        "    assert getattr(TC, n).__name__ == getattr(JC, n).__name__\n"
        "assert {'DEFAULT_RULES', 'Strategy', 'default_strategy'} <= pub(TP)\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
