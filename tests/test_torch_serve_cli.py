"""The port's serving CLI (repro_torch.launch.serve) at a reduced config on
the CPU, each run in a subprocess: its WSMC plan line equals the reference
CLI's (repro.launch.serve) for the same flags at an explicit
--hbm-budget-gb (planning reads the hardware only through its memory
size, so the port's H100 default and the reference's TPU default agree
there); on the paged and the ring path every request completes with the
tokens of the port's own greedy_generate on the same seeded weights; and
the device is never hidden: --backend cuda on the CPU fails, and so does
--device cuda without a card."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TRACE = ["--requests", "6", "--prompt-lens", "4,8,20", "--gen-lens", "2,4",
         "--seed", "0"]
PAGED = ["--kv", "paged", "--compact", "--chunk-prefill", "8", "--audit",
         "strict"]


def _run(module, args, timeout=600):
    # the reference CLI plans over jax.devices(): a device count another
    # test's import left in XLA_FLAGS (repro.launch.dryrun sets 512) must
    # not reach it
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-m", module] + args, env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def _plan_line(out):
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("WSMC[serving/")]
    assert len(lines) == 1, out.stdout + out.stderr
    return lines[0]


@pytest.mark.parametrize("flags", [
    PAGED + ["--mesh", "auto"],
    ["--kv", "paged", "--chunk-prefill", "8", "--prefill-budget", "16",
     "--admission", "optimistic", "--kv-quant", "int8"],
    ["--kv", "paged", "--chunk-prefill", "8", "--chaos-seed", "3",
     "--policy", "both", "--audit", "count", "--deadline", "40"],
    ["--kv", "paged", "--prefix-share", "--prefix-len", "8", "--slo", "0,1",
     "--admission", "optimistic", "--kv-quant", "int8", "--kv-retain", "2",
     "--min-agreement", "0.9", "--measure-agreement"],
    [],
], ids=["paged-auto", "paged-budget-int8", "chaos-both-deadline",
        "prefix-bend-agreement", "ring"])
def test_plan_line_equals_reference_cli(flags):
    args = ["--arch", "mistral-nemo-12b", "--reduced", "--hbm-budget-gb",
            "8"] + TRACE + flags
    ref = _run("repro.launch.serve", args)
    port = _run("repro_torch.launch.serve", args + ["--device", "cpu"])
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert port.returncode == 0, port.stdout + port.stderr
    assert _plan_line(port) == _plan_line(ref)
    assert _plan_line(port).startswith("WSMC[serving/simulate]: ")
    # the trace line and the completion count match too
    for out in (ref, port):
        assert "completed=6" in out.stdout
        assert "ERROR" not in out.stdout
    trace = [ln for ln in port.stdout.splitlines() if ln.startswith("trace:")]
    assert trace and trace[0] in ref.stdout
    # chaos plans and verdicts, and the policies' occupancy, are the
    # scheduler's: equal line for line
    for key in ("chaos", "  chaos", "occupancy:"):
        want = [ln for ln in ref.stdout.splitlines() if ln.startswith(key)]
        got = [ln for ln in port.stdout.splitlines() if ln.startswith(key)]
        assert got == want
    if "--measure-agreement" in flags:
        assert "agreement=" in port.stdout.split(_plan_line(port))[1]


# The subprocess the token tests run: the CLI's main() with the engine's
# reports captured, then the port's greedy_generate on weights made from
# the CLI's seed, request by request.
TOKENS = r"""
import sys
import torch
from repro_torch.configs import get_config
from repro_torch.launch import serve as SV
from repro_torch.models import init_params
from repro_torch.runtime.serve_step import greedy_generate
from repro_torch.serving import trace_context

reports = []

class Recorded(SV.Engine):
    def run(self, trace):
        rep = super().run(trace)
        reports.append((list(trace), rep))
        return rep

SV.Engine = Recorded
argv = sys.argv[1:]
rc = SV.main(argv)
assert rc == 0, rc
cfg = get_config("{arch}").reduced()
assert len(reports) == 1
trace, rep = reports[0]
assert len(trace) == 6 and max(len(r.prompt) for r in trace) == 20
context = trace_context(trace)
params = init_params(torch.Generator(device="cpu").manual_seed(0), cfg,
                     device="cpu")
assert len(rep.completions) == len(trace)
for c in rep.completions:
    req = trace[c.rid]
    want = greedy_generate(params, cfg, torch.tensor([req.prompt],
                           dtype=torch.int32), req.max_new, context)
    assert list(c.tokens) == want[0].tolist(), (c.rid, c.tokens, want)
print("TOKENS-OK", len(rep.completions))
"""


@pytest.mark.parametrize("arch,flags", [
    ("mistral-nemo-12b", PAGED + ["--mesh", "auto"]),
    ("mistral-nemo-12b", []),
    ("gemma3-12b", []),
], ids=["mistral-paged", "mistral-ring", "gemma3-ring"])
def test_cli_tokens_equal_greedy_generate(arch, flags):
    """Every request of the CLI's run completes (paged: whole-prompt and
    chunked prefill, compacted decode, strict audit; ring: the slot engine)
    with the tokens greedy_generate gives its prompt on the same seeded
    weights."""
    env = dict(os.environ, PYTHONPATH=SRC)
    args = ["--arch", arch, "--reduced", "--device", "cpu"] + TRACE + flags
    out = subprocess.run([sys.executable, "-c", TOKENS.replace("{arch}",
                                                               arch)] + args,
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "TOKENS-OK 6" in out.stdout
    assert "pool: " in out.stdout
    assert "memory:" not in out.stdout        # the card's readings only


def test_cli_backend_cuda_refuses_the_cpu():
    """--backend cuda measures on the card: on the CPU it fails (no
    fallback to the simulator), and the planning guard contradicts it."""
    base = ["--arch", "mistral-nemo-12b", "--reduced", "--device", "cpu",
            "--mesh", "auto"] + TRACE
    out = _run("repro_torch.launch.serve", base + ["--backend", "cuda"])
    assert out.returncode != 0
    assert "CudaMeasurer measures on a CUDA device" in out.stderr
    assert "completed=" not in out.stdout
    out = _run("repro_torch.launch.serve",
               base + ["--backend", "cuda", "--forbid-plan-compiles"])
    assert out.returncode == 2 and "contradicts" in out.stderr
    out = _run("repro_torch.launch.serve",
               base + ["--forbid-plan-compiles"])
    assert out.returncode == 0, out.stdout + out.stderr


def test_cli_device_cuda_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU path does not apply")
    out = _run("repro_torch.launch.serve",
               ["--arch", "mistral-nemo-12b", "--reduced"] + TRACE)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "WSMC[" not in out.stdout
