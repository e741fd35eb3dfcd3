"""Where a MoE training step's peak goes on the card: one train step of
mixtral-8x7b on {data: 1, model: 2} under expert parallelism (phase 14(g)'s
configuration: full width, 2 of 32 layers, Adafactor, [2, 2048]), two
ranks sharing the card over gloo, rank 0 recording every allocation of its
step (`torch.cuda.memory._record_memory_history`). The recorded trace is
replayed to the step's peak, and the bytes live there are split by the
function that allocated them; among them the f32 copies that
`layers.einsum_f32` makes of the expert weights (`wi`, `wo`) and autograd
keeps for the backward.

    python3 moe_memory.py [--depth 2] [--json moe_memory.json]

Needs a CUDA device; prints the card's name and power limit beside the
numbers.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import depth_variant  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import optimizers as OPT  # noqa: E402
from repro_torch.parallel import sharding as SHD  # noqa: E402
from repro_torch.runtime import schedule as SCH  # noqa: E402
from repro_torch.runtime.train_step import TrainStepConfig  # noqa: E402

ARCH, SEQ, BATCH, SEED = "mixtral-8x7b", 2048, 2, 0


def _frames(ev):
    return [f.get("name", "") for f in ev.get("frames", [])]


def peak_breakdown(events, base):
    """Replays an allocation trace (alloc / free_completed events) from
    `base` bytes allocated: (the peak, the bytes live there by the
    innermost function of the port on the allocation's stack, the live
    blocks allocated under einsum_f32 as {size: count})."""
    cur = peak = base
    at = -1
    for i, ev in enumerate(events):
        if ev["action"] == "alloc":
            cur += ev["size"]
        elif ev["action"] == "free_completed":
            cur -= ev["size"]
        if cur > peak:
            peak, at = cur, i
    live = {}
    for ev in events[:at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    by_fn = collections.Counter()
    einsum = collections.Counter()
    for ev in live.values():
        names = _frames(ev)
        fn = next((f.get("name", "") for f in ev.get("frames", [])
                   if "repro_torch" in f.get("filename", "")), "unknown")
        by_fn[fn] += ev["size"]
        if "einsum_f32" in names:
            einsum[ev["size"]] += 1
    return peak, by_fn, einsum


def rank(device, depth):
    mesh = LM.build_mesh({"data": 1, "model": 2})
    cfg = depth_variant(get_config(ARCH), depth)
    specs = SHD.param_specs(cfg, init_params(None, cfg, device="meta"),
                            SHD.Strategy(ep=True), mesh)
    params = SHD.init_local_params(
        torch.Generator(device=device).manual_seed(SEED), cfg, device,
        specs, mesh)
    tcfg = TrainStepConfig(optimizer=OPT.OptimizerConfig(kind="adafactor"),
                           total_steps=1)
    step = SCH.make_train_step(cfg, tcfg, mesh=mesh, spec_tree=specs)
    state = OPT.init_state(tcfg.optimizer, params)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    batch = {k: torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                              generator=gen, device=device)
             for k in ("tokens", "targets")}
    wi, wo = (params["units"][0]["mlp"][k] for k in ("wi", "wo"))
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    record = mesh.rank == 0
    if record:
        torch.cuda.memory._record_memory_history(max_entries=2_000_000)
    step(params, state, batch, 0)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    out = {"rank": mesh.rank, "base": base, "peak": peak,
           "wi_f32": wi[0].numel() * 4, "wo_f32": wo[0].numel() * 4,
           "wi": tuple(wi.shape), "wo": tuple(wo.shape), "layers": depth}
    if record:
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        events = snap["device_traces"][device.index or 0]
        replayed, by_fn, einsum = peak_breakdown(events, base)
        out.update(replayed=replayed, events=len(events),
                   by_fn=dict(by_fn.most_common(12)),
                   einsum=sorted(einsum.items(), reverse=True))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--json", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("moe_memory.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    res = LM.spawn_ranks(rank, 2, "gloo", "cuda", args=(args.depth,),
                         timeout=900)
    r0 = res[0]
    wi_all = r0["wi_f32"] * r0["layers"]
    wo_all = r0["wo_f32"] * r0["layers"]
    copies = sum(size * n for size, n in r0["einsum"]
                 if size in (r0["wi_f32"], r0["wo_f32"]))
    for r in res:
        print(f"rank {r['rank']}: wi {r['wi']}, wo {r['wo']}; allocated "
              f"before the step {r['base'] / 1e9:.3f} GB, "
              f"max_memory_allocated {r['peak'] / 1e9:.3f} GB ({smi})")
    print(f"rank 0's trace ({r0['events']} events) replayed: peak "
          f"{r0['replayed'] / 1e9:.3f} GB (max_memory_allocated "
          f"{r0['peak'] / 1e9:.3f} GB)")
    print(f"live at the peak from einsum_f32, the f32 copies of the expert "
          f"weights: {copies / 1e9:.3f} GB = {copies / r0['peak']:.4f} of "
          f"the peak (all {r0['layers']} layers' wi {wi_all / 1e9:.3f} GB "
          f"+ wo {wo_all / 1e9:.3f} GB in f32); einsum_f32's live blocks "
          f"by size {r0['einsum']}")
    print("live at the peak by allocating function: " + ", ".join(
        f"{k} {v / 1e9:.3f} GB" for k, v in r0["by_fn"].items()))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"ranks": res, "copies": copies, "device": smi}, f,
                      indent=1, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
