"""The multi-pod dry-run.

For every (architecture × input shape) cell:
  1. offline/online WSMC phases pick the memory plan (knowledge base),
  2. the full-depth step is measured: under `--backend simulate` on the
     single-pod (16,16) mesh AND the multi-pod (2,16,16) mesh, compile-free
     in seconds via the analytical measurer (the reference's compile
     backend proves the same footprints from XLA's memory analysis); under
     `--backend cuda` (`--mesh auto` only) on the planned mesh of one card,
     one step run there by `CudaMeasurer` and its bytes read from the
     caching allocator,
  3. depth-1/2 variants counted on the meta device
     (`roofline.count.count_step`) give the roofline terms on the H100
     (the card backend only: the reference likewise computes its roofline
     only under its measuring backend).

Artifacts: one JSON per cell under --out, plus a summary table
(`launch.summarize`).

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \
      --out artifacts/dryrun [--no-roofline] [--kb artifacts/kb.json] \
      [--backend simulate] [--profile-cache artifacts/profiles.json]
  python -m repro_torch.launch.dryrun --backend cuda --mesh auto \
      --max-devices 1 --arch h2o-danube-1.8b --shape long_500k

Plans are made for `PLAN_HW`, an H100 (`run_cell(hw=...)`; the parity
tests pass `HW.TPU_V5E` and get the reference's cells). `--backend cuda`
measures on one card: `--mesh auto` clamps `--max-devices` to 1 (as the
reference clamps it to its devices), and the fixed production meshes
raise — a measurement over a mesh is not ported (ROADMAP queue A item
5); nothing falls back to the simulator. `--paper-faithful` keeps the reference's
flag: its two beyond-paper levers (a one-hot embedding matmul, GQA heads
repeated for sharding) have no counterpart here, so the port's default
settings already are the paper-faithful ones.
"""
import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict

from repro_torch import hw as HW
from repro_torch.configs import (ARCH_IDS, SHAPES, SHAPE_ORDER, get_config,
                                 shape_applicable)
from repro_torch.configs.base import ShapeConfig, depth_variant
from repro_torch.core import measure as MM
from repro_torch.core import predictor as PR
from repro_torch.core import profiler as PF
from repro_torch.core.classifier import Classification, Category
from repro_torch.models.model import ModelSettings
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import count as RC
from repro_torch.search import execplan as XP
from repro_torch.search import strategies as ST

# Mesh shapes the dry-run sweeps under --backend simulate (plain dicts are
# all the simulator needs).
MESH_SHAPES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}
# the cards CudaMeasurer measures on
CUDA_MAX_DEVICES = 1
# the device main() plans for (the parity tests set the reference's)
PLAN_HW = HW.H100
MESH_REFUSED = ("--backend cuda measures on one card: use --mesh auto "
                "(a measurement over the production meshes is not ported: "
                "ROADMAP queue A item 5)")


def classification_for(cfg, shape, measurer: MM.MemoryMeasurer,
                       kb: Dict) -> Classification:
    key = f"{cfg.name}::{shape.kind}"
    if key in kb:
        e = kb[key]
        return Classification(category=Category(e["category"]),
                              alpha=e["alpha"], inc=e["inc"],
                              slope=e["slope"], intercept=e["intercept"])
    cls = PF.classify_workload(cfg, shape, None, n_points=3, base_seq=512,
                               measurer=measurer)
    kb[key] = {"category": cls.category.value, "alpha": cls.alpha,
               "inc": cls.inc, "slope": cls.slope,
               "intercept": cls.intercept, "factor": cls.factor}
    return cls


def card_entry(cfg, shape, plan, cls, mesh_shape, kb, device, ep) -> dict:
    """What a measurement on the card adds to its mesh entry: the
    allocator's peak over the step, the capacity model's prediction for the
    same plan (Eq. 7 resident + Eq. 6 transient under the class) and the
    simulator's peak for it."""
    import torch
    peak = torch.cuda.max_memory_allocated(device)
    predicted = (PR.resident_bytes(cfg, shape, plan, mesh_shape)
                 + PR.transient_bytes(cfg, shape, plan, cls, mesh_shape,
                                      factors=PF.calibrated_factors(kb)))
    simulated = MM.SimulatedMeasurer(mesh_shape, ep=ep).measure_peak(
        cfg, shape, plan)
    return {"device": torch.cuda.get_device_name(device),
            "max_memory_allocated": int(peak),
            "predicted_bytes": float(predicted),
            "measured_over_predicted": peak / predicted,
            "simulated_peak_bytes": float(simulated),
            "measured_over_simulated": peak / simulated}


def card_roofline(cfg, shape, plan, mesh_name: str, n_chips: int,
                  settings: ModelSettings, hw: HW.HardwareSpec) -> dict:
    """The roofline of the plan's step, counted on the meta device at
    depth 1 and 2 and extrapolated; {"error": ...} where a step cannot be
    counted (never a zero)."""
    t0 = time.time()
    # microbatches=1: the per-step cost equals the full-batch single-micro
    # cost (as the reference lowers it)
    rplan = dataclasses.replace(plan, microbatches=1)
    try:
        costs = [RC.count_step(depth_variant(cfg, n), shape, rplan, settings)
                 for n in (1, 2)]
    except RC.CountError as e:
        return {"error": str(e), "analysis_s": round(time.time() - t0, 1)}
    total = RA.extrapolate(costs[0], costs[1], cfg.repeats)
    rep = RA.report(cfg, shape, mesh_name, n_chips, total, hw=hw,
                    remat=rplan.remat)
    out = rep.to_dict()
    out["hw"] = hw.name
    out["analysis_s"] = round(time.time() - t0, 1)
    return out


def run_cell(arch: str, shape: ShapeConfig,
             measurers: Dict[str, MM.MemoryMeasurer],
             kb: Dict, do_roofline: bool = True,
             plan_override=None, settings_fn=ModelSettings,
             strategy: str = "fastest", *, auto_mesh: bool = False,
             backend: str = "simulate", cache=None,
             max_devices: int = 256,
             hw: HW.HardwareSpec = HW.H100) -> dict:
    cfg = get_config(arch)
    result = {"arch": arch, "shape": shape.name, "kind": shape.kind}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        result["status"] = "skipped"
        result["reason"] = reason
        return result

    # The single-pod measurer anchors profiling; a multi-only sweep (--mesh
    # multi) profiles on the multi-pod mesh instead.
    single_m = measurers.get("single") or next(iter(measurers.values()))
    result["backend"] = backend if auto_mesh else single_m.backend
    # --- WSMC online phase (profiling ladder on the single-pod mesh) ----
    t0 = time.time()
    cls = classification_for(cfg, shape, single_m, kb)
    plan = plan_override
    if auto_mesh:
        # plan the mesh, then measure on it: the measurement target IS the
        # planned mesh (pipe included), not a CLI-fixed one
        sim = (single_m if single_m.backend == "simulate"
               else MM.SimulatedMeasurer(single_m.mesh_shape))
        if backend == "cuda":
            # the planned mesh must be one CudaMeasurer can measure on
            max_devices = min(max_devices, CUDA_MAX_DEVICES)
        eplan = XP.plan_execution(cfg, shape, cls, n_devices=max_devices,
                                  strategy=strategy, measurer=sim,
                                  factors=PF.calibrated_factors(kb), hw=hw)
        plan = eplan.plan
        result["execution_plan"] = {
            "mesh": eplan.mesh_shape, "schedule": eplan.schedule,
            "ep": eplan.ep, "plan": dataclasses.asdict(eplan.plan),
            "policy": eplan.policy, "n_devices": eplan.n_devices,
            "strategy": strategy,
        }
        print(f"[{arch} × {shape.name}] planned: {eplan.describe()}",
              flush=True)
        if backend == "simulate":
            planned_m = MM.SimulatedMeasurer(eplan.mesh_shape, cache=cache,
                                             ep=eplan.ep)
        else:
            planned_m = MM.CudaMeasurer(eplan.mesh_shape, cache=cache)
        measurers = {"planned": planned_m}
    elif plan is None:
        factors = PF.calibrated_factors(kb)
        decision = ST.plan_for(cfg, shape, cls, single_m.mesh_shape,
                               strategy=strategy, measurer=single_m,
                               factors=factors, hw=hw)
        plan = decision.plan
        result["wsmc"] = {
            "category": cls.category.value,
            "alpha": round(cls.alpha, 3),
            "inc": round(cls.inc, 3),
            "plan": dataclasses.asdict(plan),
            "policy": decision.policy,
            "strategy": strategy,
            "considered": decision.considered,
            "measured": decision.measured,
        }
        if decision.prediction is not None:
            result["wsmc"]["pred_capacity_bytes"] = \
                decision.prediction.capacity_bytes
            result["wsmc"]["pred_fits"] = decision.prediction.fits
        if decision.peak_bytes is not None:
            result["wsmc"]["verified_peak_bytes"] = decision.peak_bytes
    result["profile_s"] = round(time.time() - t0, 1)

    # --- full-depth measurement on each mesh ----------------------------
    for mesh_name, measurer in measurers.items():
        t0 = time.time()
        # re-plan per mesh: microbatch divisibility depends on the dp size
        # (auto mode already planned plan + mesh together)
        if plan_override is None and not auto_mesh:
            mesh_plan = ST.plan_for(cfg, shape, cls, measurer.mesh_shape,
                                    strategy=strategy, measurer=measurer,
                                    factors=PF.calibrated_factors(kb),
                                    hw=hw).plan
        else:
            mesh_plan = plan
        steps = getattr(measurer, "steps", 0)
        prof = measurer.measure(cfg, shape, mesh_plan, settings=settings_fn())
        entry = {
            "argument_bytes": int(prof.argument_bytes),
            "output_bytes": int(prof.output_bytes),
            "temp_bytes": int(prof.transient_bytes),
            "peak_static_bytes": int(prof.peak_bytes),
            "measure_s": round(time.time() - t0, 1),
            "n_devices": int(MM.n_devices_of(measurer.mesh_shape)),
            "alpha_full": round(prof.alpha, 3),
        }
        if measurer.backend == "cuda":
            if measurer.steps > steps:      # not served from the cache
                entry.update(card_entry(
                    cfg, shape, mesh_plan, cls, measurer.mesh_shape, kb,
                    measurer.device, result.get("execution_plan", {}).get(
                        "ep", False)))
            measurer.release()
        print(f"[{arch} × {shape.name} × {mesh_name}] "
              f"{measurer.backend} measure: args={entry['argument_bytes']} "
              f"temp={entry['temp_bytes']} out={entry['output_bytes']}",
              flush=True)
        result[f"mesh_{mesh_name}"] = entry
        # --- roofline (depth-extrapolated counts) on the card's mesh ---
        if do_roofline and measurer.backend == "cuda":
            result["roofline"] = card_roofline(
                cfg, shape, mesh_plan, mesh_name, entry["n_devices"],
                settings_fn(), hw)

    result["status"] = "ok"
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "auto"],
                    help="'auto' = plan the mesh per cell (mesh_space "
                         "search) and measure on the planned mesh")
    ap.add_argument("--max-devices", type=int, default=256,
                    help="device budget for --mesh auto planning (1 under "
                         "--backend cuda)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--kb", default="artifacts/kb.json")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--paper-faithful", action="store_true",
                    help="the reference's baseline settings: the port's "
                         "defaults, which have none of its beyond-paper "
                         "levers (accepted, changes nothing)")
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "simulate"],
                    help="memory-measurement backend: 'cuda' = one step "
                         "on the card, the allocator's bytes (--mesh auto "
                         "only), 'simulate' = closed-form analytical "
                         "model (no device)")
    ap.add_argument("--strategy", default="fastest",
                    choices=list(ST.CLI_STRATEGIES),
                    help="plan-search strategy: 'fastest' = the paper's "
                         "predicted walk, 'staged' = simulator-screened "
                         "top-k verified on --backend, 'exhaustive' = "
                         "verify every candidate, 'greedy' = coordinate "
                         "hillclimb")
    ap.add_argument("--profile-cache", default=None,
                    help="path of the on-disk MemoryProfile cache (keyed by "
                         "arch × shape × plan × mesh × backend)")
    args = ap.parse_args(argv)

    if args.backend == "cuda":
        if args.mesh != "auto":
            raise NotImplementedError(MESH_REFUSED)
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("--backend cuda: torch.cuda.is_available() "
                               "is False; --backend simulate plans without "
                               "a card")

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPE_ORDER) if args.shape == "all" else args.shape.split(",")

    cache = MM.ProfileCache(args.profile_cache) if args.profile_cache else None
    measurers = {}
    if args.mesh == "auto":
        # classification screen: always the device-free simulator; the
        # measurement mesh is planned per cell inside run_cell
        measurers["screen"] = MM.SimulatedMeasurer(MESH_SHAPES["single"],
                                                   cache=cache)
    for name in ("single", "multi"):
        if args.mesh in (name, "both"):
            measurers[name] = MM.measurer_for(args.backend, MESH_SHAPES[name],
                                              cache=cache)

    os.makedirs(args.out, exist_ok=True)
    kb = {}
    if os.path.exists(args.kb):
        kb = PF.load_knowledge_base(args.kb)

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            shape = SHAPES[shape_name]
            cell_path = os.path.join(args.out, f"{arch}__{shape_name}.json")
            if os.path.exists(cell_path):
                with open(cell_path) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[cached] {arch} × {shape_name}:"
                          f" {prev['status']}", flush=True)
                    n_ok += prev["status"] == "ok"
                    n_skip += prev["status"] == "skipped"
                    continue
            t0 = time.time()
            try:
                result = run_cell(arch, shape, measurers, kb,
                                  do_roofline=not args.no_roofline,
                                  strategy=args.strategy,
                                  auto_mesh=args.mesh == "auto",
                                  backend=args.backend, cache=cache,
                                  max_devices=args.max_devices,
                                  hw=PLAN_HW)
            except Exception as e:  # noqa: BLE001 — record and continue
                result = {"arch": arch, "shape": shape_name,
                          "status": "failed", "error": str(e),
                          "traceback": traceback.format_exc()}
            result["total_s"] = round(time.time() - t0, 1)
            with open(cell_path, "w") as f:
                json.dump(result, f, indent=2)
            PF.save_knowledge_base(args.kb, kb)
            st = result["status"]
            n_ok += st == "ok"
            n_skip += st == "skipped"
            n_fail += st == "failed"
            print(f"[{st}] {arch} × {shape_name} ({result['total_s']}s)",
                  flush=True)
            if st == "failed":
                print(result["error"], flush=True)

    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} failed",
          flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
