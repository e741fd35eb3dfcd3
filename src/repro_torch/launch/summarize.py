"""Summarize dry-run artifacts into the report's tables
(`launch.report_experiments`).

  PYTHONPATH=src python -m repro_torch.launch.summarize artifacts/dryrun

The tables are the reference package's, text for text on the same cells.
A roofline row exists for a cell measured on the card (`--backend cuda`):
its terms are per card, on the H100 (`roofline.analysis.report`).
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

from repro_torch.configs import ARCH_IDS, SHAPE_ORDER

GB = 1024.0**3


def load_cells(d: str) -> Dict[str, dict]:
    cells = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            with open(os.path.join(d, name)) as f:
                cells[name[:-5]] = json.load(f)
    return cells


def fmt_gb(b):
    return f"{b / GB:.2f}"


def dryrun_table(cells) -> str:
    rows = ["| arch | shape | plan (remat/µb/opt/kv) | category | α(ladder→full) | "
            "args GiB/dev | temp GiB/dev | multi-pod temp | status |",
            "|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_IDS:
        for shape in SHAPE_ORDER:
            c = cells.get(f"{arch}__{shape}")
            if c is None:
                continue
            if c["status"] == "skipped":
                rows.append(f"| {arch} | {shape} | — | — | — | — | — | — | "
                            f"SKIP (pure full-attention, sub-quadratic "
                            f"required) |")
                continue
            if c["status"] != "ok":
                rows.append(f"| {arch} | {shape} | — | — | — | — | — | — | "
                            f"FAILED |")
                continue
            w = c.get("wsmc", {})
            p = w.get("plan", {})
            plan = (f"{p.get('remat','?')}/{p.get('microbatches','?')}/"
                    f"{p.get('optimizer','?')}/{p.get('kv_shard','?')}")
            ms = c.get("mesh_single", {})
            mm = c.get("mesh_multi", {})
            rows.append(
                f"| {arch} | {shape} | {plan} | {w.get('category','?')} | "
                f"{w.get('alpha','?')}→{ms.get('alpha_full','?')} | "
                f"{fmt_gb(ms.get('argument_bytes', 0))} | "
                f"{fmt_gb(ms.get('temp_bytes', 0))} | "
                f"{fmt_gb(mm.get('temp_bytes', 0))} | ok |")
    return "\n".join(rows)


def roofline_table(cells) -> str:
    rows = ["| arch | shape | T_comp s | T_mem s (HLO⁄analytic) | T_coll s |"
            " bottleneck | MODEL/HLO | MFU-bound (HLO⁄analytic) | lever |",
            "|---|---|---|---|---|---|---|---|---|"]
    levers = {
        "memory": "cut bytes: fused attn kernel, fewer saves, bigger blocks",
        "collective": "reshard (repeat-kv/EP), bf16 reduce, overlap w/ compute",
        "compute": "raise MXU occupancy / cut dispatch+mask waste",
    }
    for arch in ARCH_IDS:
        for shape in SHAPE_ORDER:
            c = cells.get(f"{arch}__{shape}")
            if not c or c.get("status") != "ok" or "roofline" not in c:
                continue
            r = c["roofline"]
            tma = r.get("t_mem_analytic", 0.0)
            mfa = r.get("mfu_bound_analytic", r["mfu_bound"])
            rows.append(
                f"| {arch} | {shape} | {r['t_comp']:.3f} | "
                f"{r['t_mem']:.3f}⁄{tma:.3f} |"
                f" {r['t_coll']:.3f} | **{r['bottleneck']}** | "
                f"{r['useful_flops_ratio']:.2f} | "
                f"{r['mfu_bound']:.3f}⁄{mfa:.3f} | "
                f"{levers[r['bottleneck']]} |")
    return "\n".join(rows)


def pick_hillclimb(cells) -> List[str]:
    """worst MFU-bound, most collective-bound, most paper-representative."""
    ok = [(k, c) for k, c in cells.items()
          if c.get("status") == "ok" and "roofline" in c]
    if not ok:
        return []
    worst = min(ok, key=lambda kc: kc[1]["roofline"]["mfu_bound"])
    coll = max(ok, key=lambda kc: (kc[1]["roofline"]["t_coll"]
                                   / max(kc[1]["roofline"]["t_roofline"],
                                         1e-9)))
    return [worst[0], coll[0]]


def main(d: str = "artifacts/dryrun"):
    cells = load_cells(d)
    n_ok = sum(c["status"] == "ok" for c in cells.values())
    n_skip = sum(c["status"] == "skipped" for c in cells.values())
    n_fail = sum(c["status"] == "failed" for c in cells.values())
    print(f"## Dry-run summary: {n_ok} ok / {n_skip} skipped / "
          f"{n_fail} failed of {len(cells)} cells\n")
    print(dryrun_table(cells))
    print("\n## Roofline (the measured mesh, per chip)\n")
    print(roofline_table(cells))
    print("\nhillclimb candidates:", pick_hillclimb(cells))


if __name__ == "__main__":
    main(*sys.argv[1:])
