"""The port stands alone: importing every module of repro_torch (and
chip_smoke.py's own imports) in a fresh interpreter leaves neither jax nor
the reference package in sys.modules, and nothing is built or probed at
import time."""
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


def _module_names():
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return sorted(names)


def _run(code):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax_or_reference_package():
    names = _module_names()
    for want in ("repro_torch.kernels.build", "repro_torch.kernels.ops",
                 "repro_torch.serving.executor", "repro_torch.convert",
                 "repro_torch.core.predictor",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.mlstm_scan",
                 "repro_torch.models.recurrent",
                 "repro_torch.serving.quality",
                 "repro_torch.configs.mistral_nemo_12b",
                 "repro_torch.kernels.flash_attention_bwd",
                 "repro_torch.optim.optimizers", "repro_torch.optim.schedule",
                 "repro_torch.optim.compress",
                 "repro_torch.runtime.train_step",
                 "repro_torch.runtime.schedule", "repro_torch.runtime.fault",
                 "repro_torch.data.pipeline", "repro_torch.checkpoint.ckpt",
                 "repro_torch.launch.train", "repro_torch.tree",
                 "repro_torch.kernels.decode_attention",
                 "repro_torch.models.moe", "repro_torch.roofline.analysis",
                 "repro_torch.roofline.count", "repro_torch.launch.dryrun",
                 "repro_torch.launch.hillclimb",
                 "repro_torch.launch.summarize",
                 "repro_torch.launch.report_experiments"):
        assert want in names
    code = (
        "import importlib, sys\n"
        f"names = {names!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "assert 'ml_dtypes' not in sys.modules\n"
        "print('OK', len(names))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_no_source_file_names_jax_or_the_reference_package():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            for i, line in enumerate(fh, 1):
                assert not pat.match(line), f"{f}:{i}: {line.strip()}"


def test_build_module_imports_without_nvcc_and_raises_only_on_use():
    import torch
    from repro_torch.kernels import (build, decode_attention,
                                     flash_attention, flash_attention_bwd,
                                     mlstm_scan, paged_decode, paged_prefill)
    assert set(build.SOURCES) == {paged_decode.SOURCE, paged_prefill.SOURCE,
                                  flash_attention.SOURCE,
                                  flash_attention_bwd.SOURCE,
                                  mlstm_scan.SOURCE, decode_attention.SOURCE}
    assert len(build.SOURCES) == 6
    for f in build.SOURCES + build.HEADERS:
        assert os.path.exists(os.path.join(build.CSRC, f)), f
    assert paged_decode.launches == 0 and paged_prefill.launches == 0
    assert flash_attention.launches == 0 and mlstm_scan.launches == 0
    assert flash_attention_bwd.launches == 0
    assert decode_attention.launches == 0
    if build.find_nvcc() is None:
        with pytest.raises(build.KernelCompileError, match="nvcc"):
            build.library(paged_decode.SOURCE)
    # a CPU tensor takes the plain version and counts no launch
    q = torch.zeros(1, 1, 1, 4)
    pool = torch.zeros(2, 2, 1, 4)
    pos = torch.full((2, 2), -1, dtype=torch.int32)
    out = paged_decode.paged_decode_attention(
        q, pool, pool.clone(), pos, torch.zeros((1, 1), dtype=torch.int32),
        torch.zeros((1,), dtype=torch.int32))
    assert out.shape == q.shape and paged_decode.launches == 0
    ring = decode_attention.decode_attention_fwd(
        q, pool[:1], pool[:1].clone(), pos[:1],
        torch.zeros((1,), dtype=torch.int32))
    assert ring.shape == q.shape and decode_attention.launches == 0


def test_chip_smoke_fails_without_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU exit path does not apply")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
