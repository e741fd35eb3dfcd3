"""Which faults do chip_smoke.py's end-to-end checks catch?

Phase 13: builds the kernels (phase 1), then runs phase 13(b)
(llama4-scout, greedy steps against the plain attention under the kernel
run's MoE routes) and 13(a) (mixtral-8x7b, the paged engine against its
greedy replay under the engine's routes) with the ring decode kernel's
output (ops.decode_attention_fwd, B3) scaled by a factor, patched at run
time. Phase 2 holds the kernel itself at the bf16 tolerance; this shows
how large an error the end-to-end checks see on their own.

Phases 14 to 16 plant each fault in a copy of this checkout's sources
(in a temporary directory), where `chip_smoke.py --phases 1,14` (or
`1,15`, `1,16`) then runs, phases 14 and 16 limited to the runs that
should catch the fault (`--par-runs`, `--tp-runs`). Phase 14 (the
trainer runs in processes of its own): the data axes' gradient mean left out of `sync_grads`, and
gathered shards concatenated in reverse rank order, each for 14(b)
(data:2); the tensor-parallel entry op's backward without its all-reduce
(each rank's share of the input's gradient taken for the whole), and
`tp_sum`'s backward all-reducing the gradient again (M times it), each
for 14(d) (model:2); a MoE block's gates entering `combine` without the
sum of their gradient over the model axis (each rank's experts' share
taken for the whole), and the EP router gather's backward summing the
router's gradient over the group in place of taking this rank's columns
(M times it), each for 14(g) (mixtral-8x7b on model:2 under EP) against
its one rank replaying the ranks' routes. Phase 15: the step counter
counting a train step's forward alone (the backward's and the
optimizer's FLOPs dropped), and the card dry-run measuring with the
simulator instead of the card. Phase 16 (the serve CLI on a model axis):
a GLU `wi` cut contiguously (rank 0 holds the whole gate, rank 1 the
whole val), caught at 16(a) by the ranks' served logits against one
rank's replay of their tokens; and the attention mass left per rank, not
summed over the model axis (the ranks rank blocks for retention each by
its own heads), caught at 16(b) by the ranks' block-table schedules;
mixtral-8x7b's MoE capacity C computed from the rank's own 4 experts
instead of all 8, caught at 16(f) where the ranks keep choices that the
capacity of all 8 experts drops; and the experts' partial y left
unsummed over the model axis, caught at 16(f) by the ranks emitting
apart.

    python3 smoke_mutation.py              # 13(b) at x0.9 and x0.97, 13(a) at x0.9
    python3 smoke_mutation.py --phase 14   # the six parallel-layer faults
    python3 smoke_mutation.py --phase 15   # the two dry-run faults
    python3 smoke_mutation.py --phase 16   # the four model-axis faults
    python3 smoke_mutation.py --phase 14 --only "MoE gates,router gather"
                                           # only the faults so named

Prints, for each case, whether the phase failed (caught) or passed.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = (("13b", 0.9), ("13b", 0.97), ("13a", 0.9))
# (name, file, text, the text planted in its place[, phase 14's runs])
FAULTS_14 = (
    ("sync_grads without the data mean", "src/repro_torch/runtime/schedule.py",
     "            g.div_(dp)\n", "            pass\n", "0 m1 d2,b"),
    ("gathered shards in reverse order", "src/repro_torch/parallel/comm.py",
     "full.narrow(dim, r * k, k)", "full.narrow(dim, (n - 1 - r) * k, k)",
     "0 m1 d2,b"),
    ("the entry op's backward without its all-reduce",
     "src/repro_torch/parallel/comm.py",
     "        return all_reduce(grad, ctx.group, kind=ctx.kind), None, "
     "None\n",
     "        return grad, None, None\n", "0 m1 d2,d"),
    ("tp_sum's backward all-reducing again (M times the gradient)",
     "src/repro_torch/parallel/comm.py",
     "        return grad, None, None\n",
     "        return all_reduce(grad, model_group()), None, None\n",
     "0 m1 d2,d"),
    ("the MoE gates' gradient left unsummed over the model axis",
     "src/repro_torch/models/moe.py",
     "    return comm.tp_enter(gates, kind=\"tp_gate_grad\")\n",
     "    return gates\n", "g,g one"),
    ("the router gather's backward summing over the group",
     "src/repro_torch/models/moe.py",
     "        w = comm.tp_gather_last(w.contiguous(), kind=\"tp_router\")\n",
     "        w = comm.AllGather.apply(w.contiguous(), comm.model_group(),\n"
     "                                 w.dim() - 1)\n", "g,g one"),
)
FAULTS_15 = (
    ("the counter drops the backward's FLOPs",
     "src/repro_torch/roofline/count.py",
     "        return lambda: train(params, opt_state, batch, 0)\n",
     "        return lambda: M.apply(params, cfg, batch[\"tokens\"],\n"
     "                               settings=settings)\n"),
    ("the card dry-run measures with the simulator",
     "src/repro_torch/launch/dryrun.py",
     "planned_m = MM.CudaMeasurer(eplan.mesh_shape, cache=cache)",
     "planned_m = MM.SimulatedMeasurer(eplan.mesh_shape, cache=cache)"),
)
FAULTS_16 = (
    ("wi cut contiguously (the GLU trap)",
     "src/repro_torch/parallel/sharding.py",
     "    if not glu or last is None or last.stop - last.start == "
     "x.shape[-1]:\n",
     "    if True:\n", "a"),
    ("the attention mass not summed over the model axis",
     "src/repro_torch/serving/executor.py",
     "        if self.group is not None:\n"
     "            mass = comm.all_reduce(",
     "        if False:\n"
     "            mass = comm.all_reduce(", "b"),
    ("the MoE capacity from the rank's own experts (E / M)",
     "src/repro_torch/models/moe.py",
     "    C = max(1, int(-(-s * k * cfg.capacity_factor // E)))\n",
     "    C = max(1, int(-(-s * k * cfg.capacity_factor\n"
     "                     // (E // comm.model_size()))))\n", "f"),
    ("the experts' partial y not summed over the model axis",
     "src/repro_torch/models/moe.py",
     "        y = comm.tp_sum(part, kind=\"tp_moe_sum\").to(h.dtype)\n",
     "        y = part.to(h.dtype)\n", "f"),
)
FAULTS = {14: FAULTS_14, 15: FAULTS_15, 16: FAULTS_16}


def planted(phase, only=()):
    """Each fault of `phase` (those whose name holds a string of `only`,
    when given) in a copy of the sources, where the phase runs after phase
    1: whether it failed (caught)."""
    tag = f"[{phase}"
    for name, rel, old, new, *runs in FAULTS[phase]:
        if only and not any(o in name for o in only):
            continue
        tmp = tempfile.mkdtemp(prefix="mutation_")
        try:
            shutil.copytree(os.path.join(HERE, "src"), os.path.join(tmp, "src"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(HERE, "chip_smoke.py"), tmp)
            path = os.path.join(tmp, rel)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in {rel} once")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
            cmd = [sys.executable, "chip_smoke.py", "--phases", f"1,{phase}"]
            if runs:
                cmd += ["--par-runs" if phase == 14 else "--tp-runs",
                        runs[0]]
            out = subprocess.run(cmd, cwd=tmp, capture_output=True,
                                 text=True)
            for line in out.stdout.splitlines():
                if line.startswith(tag) and "] |" not in line and \
                        "] rank " not in line:
                    print(f"  {line}", flush=True)
            failed = [ln for ln in out.stderr.splitlines() if "FAILED" in ln]
            if out.returncode == 0:
                verdict = "passed (not caught)"
            elif any(f"phase {phase}" in ln for ln in failed):
                verdict = "failed (caught)"
            else:
                verdict = f"not reached (exit {out.returncode})"
            print(f"{name}: phase {phase} {verdict}"
                  f"{'; ' + failed[-1] if failed else ''}", flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", type=int, choices=(13, 14, 15, 16),
                    default=13)
    ap.add_argument("--only", default="",
                    help="comma-separated parts of fault names: plant only "
                         "the faults whose name holds one (phases 14-16)")
    args = ap.parse_args()
    phase = args.phase
    if phase in FAULTS:
        return planted(phase, [o for o in args.only.split(",") if o])
    sys.path.insert(0, HERE)
    sys.argv = [os.path.join(HERE, "chip_smoke.py")]
    import torch
    import chip_smoke as C
    from repro_torch.kernels import ops as kops

    phases = {"13a": C.phase_mixtral, "13b": C.phase_scout}
    C.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    orig = kops.decode_attention_fwd
    for tag, scale in CASES:
        kops.decode_attention_fwd = (lambda *a, _s=scale, **k:
                                     orig(*a, **k) * _s)
        try:
            phases[tag]()
            print(f"B3 x{scale}: {tag} passed (not caught)", flush=True)
        except SystemExit:
            print(f"B3 x{scale}: {tag} failed (caught)", flush=True)
        finally:
            kops.decode_attention_fwd = orig
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
