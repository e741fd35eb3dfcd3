"""Decode-tick trace of chip_smoke.py's phase 9(b) on one GPU: gemma3-12b at
full width and depth (48 layers, random bf16 weights from the phase's seed)
served by the compacted chunked paged engine on 8 lanes at context 4096,
the same trace, pool plan and executor as the phase.

The trace is served twice: once as the phase serves it (the host time of
each decode tick), then under torch.profiler, each decode tick inside a
`record_function("tick")` range. For the profiled ticks it reports the host
time, the device time (kernel, copy and set durations that start inside the
tick's host range; a tick ends in the read of its tokens, so its device work
is done when it returns) and their difference, the device's idle time, and
the device time by kernel name.

`--root` names the checkout whose chip_smoke.py and src/ are traced, so that
one call can trace two commits on the same card:

    python3 src/repro_torch/launch/tick_trace.py --root . --out a.json
    python3 src/repro_torch/launch/tick_trace.py --root old --out b.json

Prints the card's `nvidia-smi` name and power limit and a JSON summary line;
`--out` also writes the summary there. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import sys
import time


def _stats(xs):
    xs = sorted(xs)
    n = len(xs)
    return {"n": n, "mean": sum(xs) / n, "median": xs[n // 2],
            "min": xs[0], "max": xs[-1], "sum": sum(xs)}


def _traced(cs, torch):
    """chip_smoke's ClockedExecutor with every decode tick in a
    record_function range."""

    class Traced(cs.ClockedExecutor):
        def decode(self, *a, **kw):
            with torch.profiler.record_function("tick"):
                return super().decode(*a, **kw)

    return Traced


def _per_tick(events, torch):
    """Host and device milliseconds of each 'tick' range, and the device
    time by name, from the profiler's events."""
    cuda = torch.autograd.DeviceType.CUDA
    ticks = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "tick" and e.device_type != cuda)
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == cuda and e.name != "tick")
    rows, names = [], collections.Counter()
    counts = collections.Counter()
    j = 0
    for t0, t1 in ticks:
        while j < len(dev) and dev[j][0] < t0:
            j += 1
        busy, n = 0.0, 0
        while j < len(dev) and dev[j][0] <= t1:
            s, e, name = dev[j]
            busy += e - s
            names[name] += e - s
            counts[name] += 1
            n += 1
            j += 1
        rows.append({"host_ms": (t1 - t0) / 1e3, "device_ms": busy / 1e3,
                     "device_events": n})
    top = [{"name": k[:120], "ms_per_tick": v / 1e3 / max(len(ticks), 1),
            "count_per_tick": counts[k] / max(len(ticks), 1)}
           for k, v in names.most_common(12)]
    return rows, top, len(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="checkout whose chip_smoke.py and src/ to trace")
    ap.add_argument("--out", default=None, help="also write the summary here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("tick_trace: no CUDA device\n")
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = importlib.import_module("chip_smoke")
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    cs.build.build_all()
    for mod in cs.KERNEL_MODULES:
        cs.build.library(mod.SOURCE)
    cfg = cs.get_config("gemma3-12b")
    trace = cs.make_gemma3_trace(cfg)
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 9)
    params = cs.init_params(gen, cfg, device=cs.DEV)
    context = cs.RING_CONTEXT
    plan = cs.plan_pool(cfg, trace, context, "none")
    torch.cuda.synchronize()

    ex, rep, wall = cs.serve(cfg, params, trace, context,
                             plan["pool_blocks"], "none")
    plain_ticks = [1e3 * s for s in ex.decode_s]
    del ex
    torch.cuda.empty_cache()

    cs.ClockedExecutor = _traced(cs, torch)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.time()
    with torch.profiler.profile(activities=acts) as prof:
        ex, rep2, wall2 = cs.serve(cfg, params, trace, context,
                                   plan["pool_blocks"], "none")
    rows, top, n_dev = _per_tick(prof.events(), torch)
    out = {
        "root": root, "smi": smi, "ticks": rep.ticks,
        "decodes": len(plain_ticks), "wall_s": wall,
        "tick_host_ms": _stats(plain_ticks),
        "traced_wall_s": wall2, "traced_ticks": len(rows),
        "device_events": n_dev,
        "traced_tick_host_ms": _stats([r["host_ms"] for r in rows]),
        "traced_tick_device_ms": _stats([r["device_ms"] for r in rows]),
        "traced_tick_idle_ms": _stats([r["host_ms"] - r["device_ms"]
                                       for r in rows]),
        "device_events_per_tick": _stats([r["device_events"] for r in rows]),
        "top_kernels": top,
        "trace_s": time.time() - t0}
    if not rows or n_dev == 0:
        sys.stderr.write("tick_trace: the profiler saw no decode tick or no "
                         "device event\n")
        print(json.dumps(out), flush=True)
        return 1
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
