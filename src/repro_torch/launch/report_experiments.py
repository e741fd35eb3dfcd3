"""Generate the port's experiments report from its artifacts (the dry-run
cells, the knowledge base, the hillclimb results).

  PYTHONPATH=src python -m repro_torch.launch.report_experiments \
      [--dryrun artifacts/dryrun] [--kb artifacts/kb.json] \
      [--hillclimb artifacts/hillclimb] > EXPERIMENTS.md

Every number in it comes from the artifacts; the text carries no numbers
of its own.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch import hw as HW
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import planner as PL
from repro_torch.launch.summarize import dryrun_table, load_cells, roofline_table

GB = 1024.0**3


def header(cells, hw: HW.HardwareSpec) -> str:
    cards = sorted({e["device"] for c in cells.values()
                    for k, e in c.items()
                    if k.startswith("mesh_") and "device" in e})
    card = ", ".join(cards) if cards else "no cell measured on a card"
    spec = (f"{hw.hbm_bytes / 1e9:.0f} GB at {hw.hbm_bw / 1e12:.2f} TB/s, "
            f"{hw.peak_flops_bf16 / 1e12:.0f} TFLOP/s bf16")
    return f"""# EXPERIMENTS — the WSMC port on the NVIDIA H100

Paper: *A Workload-Specific Memory Capacity Configuration Approach for
In-Memory Data Analytic Platforms* (Liang, Chang, Su 2017).

Plans are made for `{hw.name}` (`repro_torch.hw`): {spec}.
Cards the measured cells ran on: {card}.

## Method

- **Footprint.** `--backend simulate` cells are the analytical
  simulator's (no device, the production meshes 16×16 and 2×16×16 as
  `{{axis: size}}` sizes). `--backend cuda` cells run one full-depth step
  of the planned shape on one card (`CudaMeasurer`): params, optimizer
  state, cache and inputs placed first, then `max_memory_allocated()`
  over the step, beside the capacity model's prediction (Eq. 7 resident
  + Eq. 6 transient) and the simulator's peak for the same plan.
- **Roofline.** No HLO: each measured cell's step is run on the `meta`
  device at depth 1 and 2 (`roofline/count.py`), FLOPs from
  `FlopCounterMode`, bytes as every aten op's inputs and outputs (no
  fusion credit), and extrapolated to full depth. Every loop iteration is
  counted; the plain attention's masked half is counted too (MODEL/HLO
  below 1). One card, so no collective term. The analytic memory term is
  the perfect-fusion lower bound.
- **WSMC in the loop.** Every cell's plan (remat × microbatches ×
  optimizer × kv layout, and with `--mesh auto` the mesh) comes from the
  planner: the small-shape profiling ladder plus the calibrated Table III
  factors of the knowledge base.
"""


def card_table(cells) -> str:
    """The cells measured on the card: plan, class, the allocator's peak
    beside the capacity model's prediction and the simulator's peak."""
    rows = ["| cell | plan (remat/µb/opt/kv) | mesh | measured GiB | "
            "predicted GiB | measured / predicted | simulated GiB | "
            "measured / simulated |",
            "|---|---|---|---|---|---|---|---|"]
    for key, c in sorted(cells.items()):
        e = c.get("mesh_planned", {})
        if c.get("status") != "ok" or "max_memory_allocated" not in e:
            continue
        ep = c["execution_plan"]
        p = ep["plan"]
        mesh = "x".join(f"{a}:{n}" for a, n in ep["mesh"].items())
        rows.append(
            f"| {c['arch']} × {c['shape']} | {p['remat']}/"
            f"{p['microbatches']}/{p['optimizer']}/{p['kv_shard']} | "
            f"{mesh} | {e['max_memory_allocated'] / GB:.2f} | "
            f"{e['predicted_bytes'] / GB:.2f} | "
            f"{e['measured_over_predicted']:.4f} | "
            f"{e['simulated_peak_bytes'] / GB:.2f} | "
            f"{e['measured_over_simulated']:.4f} |")
    return "\n".join(rows)


def headline_table(cells, hw: HW.HardwareSpec) -> str:
    """The paper's headline (§IV) on the card's memory: the capacity WSMC
    requests (Eq. 11 over the measured peak, or the simulated one) against
    a static request of the whole card, and the plan's step-time penalty
    beside the conservative default's."""
    out = [f"| cell | WSMC plan | capacity req (GiB) | mem saved vs the "
           f"card's {hw.hbm_bytes / 1e9:.0f} GB | step-time penalty | "
           f"default's penalty |",
           "|---|---|---|---|---|---|"]
    saves = []
    for key, c in sorted(cells.items()):
        if c.get("status") != "ok":
            continue
        if "wsmc" in c:
            p, m = c["wsmc"]["plan"], c.get("mesh_single", {})
        elif "execution_plan" in c:
            p, m = c["execution_plan"]["plan"], c.get("mesh_planned", {})
        else:
            continue
        peak = m.get("max_memory_allocated", m.get("peak_static_bytes"))
        if peak is None:
            continue
        cfg, shape = get_config(c["arch"]), SHAPES[c["shape"]]
        cap = min(HW.capacity_from_requirement(peak, 0.0, hw), hw.hbm_bytes)
        plan = PL.MemoryPlan(remat=p["remat"], microbatches=p["microbatches"],
                             optimizer=p["optimizer"], kv_shard=p["kv_shard"])
        dflt = PL.default_plan(cfg, shape)
        saved = 1.0 - cap / hw.hbm_bytes
        saves.append(saved)
        out.append(f"| {c['arch']} × {c['shape']} | {p['remat']}/"
                   f"{p['microbatches']}/{p['optimizer']} | {cap / GB:.2f} | "
                   f"{saved:.0%} | {plan.step_time_penalty():.2f}× | "
                   f"{dflt.step_time_penalty():.2f}× |")
    if saves:
        out.append("")
        out.append(f"Mean memory saved vs a static request of the whole "
                   f"card: {sum(saves) / len(saves):.0%} over "
                   f"{len(saves)} cells.")
    return "\n".join(out)


def kb_table(kb_path: str) -> str:
    if not os.path.exists(kb_path):
        return "(no knowledge base)"
    with open(kb_path) as f:
        kb = json.load(f)
    out = ["| workload | category | α (per-stage) | inc |",
           "|---|---|---|---|"]
    for k in sorted(kb):
        e = kb[k]
        out.append(f"| {k} | {e['category']} | {e['alpha']:.2f} | "
                   f"{e['inc']:.2f} |")
    return "\n".join(out)


def hillclimb_table(d: str) -> str:
    if not os.path.isdir(d):
        return "(no hillclimb results)"
    out = ["| cell | variant | T_comp s | T_mem s (counted⁄analytic) | "
           "bottleneck | MODEL/counted | MFU-bound |",
           "|---|---|---|---|---|---|---|"]
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(d, name)) as f:
            res = json.load(f)
        for vname, r in res.items():
            out.append(f"| {name[:-5].replace('__', ' × ')} | {vname} | "
                       f"{r['t_comp']:.3f} | {r['t_mem']:.3f}⁄"
                       f"{r['t_mem_analytic']:.3f} | {r['bottleneck']} | "
                       f"{r['useful_flops_ratio']:.2f} | "
                       f"{r['mfu_bound']:.3f} |")
    return "\n".join(out)


def report(dryrun_dir: str = "artifacts/dryrun",
           kb_path: str = "artifacts/kb.json",
           hillclimb_dir: str = "artifacts/hillclimb",
           hw: HW.HardwareSpec = HW.H100) -> str:
    cells = load_cells(dryrun_dir) if os.path.isdir(dryrun_dir) else {}
    n = {s: sum(c["status"] == s for c in cells.values())
         for s in ("ok", "skipped", "failed")}
    parts = [header(cells, hw),
             f"## Dry-run ({n['ok']} ok / {n['skipped']} skipped / "
             f"{n['failed']} failed of {len(cells)} cells)\n",
             dryrun_table(cells),
             "\n## Cells measured on the card\n", card_table(cells),
             "\n## Roofline (the measured mesh, per card)\n",
             roofline_table(cells),
             "\n## Headline (from the dry-run cells)\n",
             headline_table(cells, hw),
             "\n## Knowledge base (Table III analogue)\n", kb_table(kb_path),
             "\n## Hillclimb (counted variants, per card)\n",
             hillclimb_table(hillclimb_dir)]
    return "\n".join(parts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="artifacts/dryrun")
    ap.add_argument("--kb", default="artifacts/kb.json")
    ap.add_argument("--hillclimb", default="artifacts/hillclimb")
    args = ap.parse_args(argv)
    print(report(args.dryrun, args.kb, args.hillclimb))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
