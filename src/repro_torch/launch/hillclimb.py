"""Perf hillclimbing harness: search the optimization-variant space and
count one (arch × shape) cell under named variants, reporting the three
roofline terms + deltas.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \
      --arch h2o-danube-1.8b --shape train_4k \
      --variants baseline,remat_dots,remat_full [--memory]

Each named variant is a point in the hillclimb ConfigSpace
(`repro_torch.search.space.hillclimb_space`) — the knobs the WSMC planner
owns plus the reference's beyond-paper levers.

The harness always runs a *planning phase* first: the selected --strategy
searches the space through the --backend measurer (`simulate`: the
device-free simulator on the single-pod production mesh shape; `cuda`:
steps measured on one card, over the same space on a mesh of one
device). With no --variants it stops there. Listed variants are
first scored with the simulate-backed feasibility score (the ordering
greedy_coordinate climbs on); the --compile-budget best, plus the first
listed variant as the delta baseline, are then counted.

Counting (the reference lowers and compiles each variant on the
production mesh and reads XLA's cost analysis): `roofline.count` runs the
variant's step on the meta device at depth 1 and 2, one device, and
`roofline.analysis` extrapolates and reports under `PLAN_HW`, the H100.
`--memory` also measures the variant's full-depth step on the card
(`CudaMeasurer`). A variant that sets a lever with no counterpart in the
port's ModelSettings / AttnSettings on one card (`NO_COUNTERPART`, or
kv_shard=seq) prints `<name> FAILED: no counterpart on one card: <knobs>`
and is left out of the results, as the reference prints a variant whose
lowering failed.
"""
import argparse
import dataclasses
import json
import os
import time
from typing import Dict

from repro_torch import hw as HW
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import depth_variant
from repro_torch.core import measure as MM
from repro_torch.core import profiler as PF
from repro_torch.core.predictor import MemoryPlan
from repro_torch.models.model import ModelSettings
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import count as RC
from repro_torch.search import space as SP
from repro_torch.search import strategies as ST

# The planning phase scores candidates against the single-pod production
# mesh shape — a plain dict is all the simulator needs.
PLAN_MESH_SHAPE = {"data": 16, "model": 16}
# the card backend measures on one device
CARD_MESH_SHAPE = {"data": 1, "model": 1}
# the device the plans and the roofline are for (the parity tests set the
# reference's)
PLAN_HW = HW.H100

SPACE = SP.hillclimb_space(PLAN_MESH_SHAPE)


def measure_space(space: SP.ConfigSpace) -> SP.ConfigSpace:
    """Enumeration-based strategies (fastest/staged/exhaustive) see only
    what a measurer can distinguish: the plan knobs + ep. The other extras
    are ordering-neutral twins — pinning them to their baselines shrinks
    the lattice ~400x without changing any decision; greedy walks the full
    space point-by-point and keeps every lever."""
    return space.subspace(
        "hillclimb/measure",
        **{k.name: (k.values[0],) for k in space.knobs
           if k.group == "extra" and k.name != "ep"})


MEASURE_SPACE = measure_space(SPACE)

# Named points in SPACE: knob assignments the space validates (unknown
# knobs / values raise at lookup).
VARIANTS: Dict[str, Dict[str, object]] = {
    "baseline": {},
    # --- beyond-paper levers ---
    "onehot_embed": dict(embed_onehot=True),
    "attn_replicated": dict(repeat_kv=False),
    "repeat_kv": dict(repeat_kv=True),
    "gather_w": dict(gather_weights=True),
    "gather_w+onehot": dict(gather_weights=True, embed_onehot=True),
    "remat_dots": dict(remat="dots"),
    "remat_full": dict(remat="full"),
    "no_fsdp": dict(fsdp=False),
    "ep": dict(ep=True),
    "kv_heads": dict(kv_shard="heads"),
    "kv_seq": dict(kv_shard="seq"),
    "qb_1024": dict(q_block=1024, kv_block=1024),
    "qb_256": dict(q_block=256, kv_block=256),
    "micro_4": dict(microbatches=4),
    "moe_group_512": dict(moe_group=512),
    "moe_group_1024": dict(moe_group=1024),
    "ep+group512": dict(ep=True, moe_group=512),
    "ep+g512+onehot": dict(ep=True, moe_group=512, embed_onehot=True),
    "ep+g512+oh+gw": dict(ep=True, moe_group=512, embed_onehot=True,
                          gather_weights=True),
    "ep+g512+oh+qb1k": dict(ep=True, moe_group=512, embed_onehot=True,
                            q_block=1024, kv_block=1024),
    "onehot+dots": dict(remat="dots", embed_onehot=True),
    "onehot+nofsdp": dict(embed_onehot=True, fsdp=False),
}

# Levers a variant may set that the port cannot express on one card: the
# embedding is a row gather (no one-hot matmul), attention has no block
# sizes to choose on the plain path nor heads to repeat or weights to
# gather for sharding, and EP needs a model axis (queue A item 5).
NO_COUNTERPART = ("embed_onehot", "repeat_kv", "gather_weights", "q_block",
                  "kv_block", "ep")


class NoCounterpart(ValueError):
    """A variant sets a lever the port has no counterpart of on one card."""


def run_variant(cfg, shape, cand: SP.Candidate, assign=None,
                measure_memory: bool = False,
                hw: HW.HardwareSpec = HW.H100):
    """The variant's roofline on one card: its step counted on the meta
    device at depth 1 and 2, extrapolated, reported under `hw`; with
    `measure_memory` its full-depth step measured on the card."""
    plan = cand.plan
    missing = [k for k in assign or {} if k in NO_COUNTERPART]
    if plan.kv_shard == "seq":
        missing.append("kv_shard=seq")
    if missing:
        raise NoCounterpart(f"no counterpart on one card: "
                            f"{','.join(missing)}")
    rplan = dataclasses.replace(plan, microbatches=1)
    # the MoE routing group is the one settings lever the port has
    settings = ModelSettings(moe_group=SP.candidate_overrides(cand)[
        "settings"].get("moe_group", ModelSettings.moe_group))
    t0 = time.time()
    costs = [RC.count_step(depth_variant(cfg, n), shape, rplan, settings)
             for n in (1, 2)]
    total = RA.extrapolate(costs[0], costs[1], cfg.repeats)
    rep = RA.report(cfg, shape, "card", 1, total, hw=hw, remat=rplan.remat)
    out = rep.to_dict()
    out["count_s"] = round(time.time() - t0, 1)
    if measure_memory:
        measurer = MM.CudaMeasurer(CARD_MESH_SHAPE)
        prof = measurer.measure(cfg, shape, plan, settings=settings)
        measurer.release()
        out["temp_bytes"] = int(prof.transient_bytes)
        out["argument_bytes"] = int(prof.argument_bytes)
    return out


def plan_phase(cfg, shape, base_cand: SP.Candidate, strategy: str,
               backend: str, hw: HW.HardwareSpec = HW.H100):
    """Search the variant space through the MemoryMeasurer interface.
    Under --backend simulate this runs nothing on a device; under cuda
    every verification is a step measured on the card, over the space on
    one device."""
    if backend == "simulate":
        measurer = MM.SimulatedMeasurer(PLAN_MESH_SHAPE)
        space, mspace = SPACE, MEASURE_SPACE
    else:
        measurer = MM.CudaMeasurer(CARD_MESH_SHAPE)
        space = SP.hillclimb_space(CARD_MESH_SHAPE)
        mspace = measure_space(space)
        base_cand = dataclasses.replace(base_cand,
                                        mesh=tuple(CARD_MESH_SHAPE.items()))
    scorer = ST.CandidateScorer(measurer=measurer)
    budget = ST.plan_budget(hw)

    name = ST.get_strategy(strategy).__name__
    if name == "greedy_coordinate":
        res = ST.greedy_coordinate(
            space, cfg, shape, start=base_cand, scorer=scorer,
            score=ST.feasibility_score(scorer, cfg, shape, hw))
    elif name == "staged":
        res = ST.staged(mspace, cfg, shape,
                        screener=MM.SimulatedMeasurer(measurer.mesh_shape),
                        verifier=measurer, hw=hw)
    elif name == "exhaustive_verified":
        res = ST.exhaustive_verified(mspace, cfg, shape, measurer=measurer,
                                     hw=hw)
    else:   # fastest_first needs a classification from the profiling ladder
        cls = PF.classify_workload(cfg, shape, None, n_points=2, base_seq=64,
                                   measurer=measurer)
        res = ST.fastest_first(mspace, cfg, shape, cls, hw=hw)
    # report the already-verified peak: greedy's winner is memoized in the
    # scorer (free), and the simulator costs nothing — never re-measure
    peak = res.peak_bytes
    if peak is None and (backend == "simulate"
                         or name == "greedy_coordinate"):
        peak = scorer.peak(cfg, shape, res.candidate)
    if peak is not None:
        mem = f"peak={peak / 2**30:.2f}GiB fits={peak <= budget}"
    else:
        mem = (f"pred_capacity="
               f"{res.prediction.capacity_bytes / 2**30:.2f}GiB")
    print(f"plan[{strategy}/{backend}]: {res.candidate.describe()} "
          f"policy={res.policy} considered={res.considered} "
          f"measured={res.measured} {mem}", flush=True)
    if backend != "simulate":
        measurer.release()
    return res


def prune_variants(cfg, shape, named_cands, keep: int,
                   hw: HW.HardwareSpec = HW.H100):
    """The measurement-phase shortlist: score every requested variant
    through the device-free simulator with the same feasibility ordering
    greedy_coordinate uses, and count only the `keep` best. The first
    listed variant (the delta baseline) always survives. Extras-only twins
    (ordering-neutral levers the memory screen cannot tell apart) tie; ties
    break by LISTING ORDER — put the variants whose roofline deltas you
    care about most first, or raise --compile-budget (0 = count all).
    Pruned names are printed, never silently skipped. Returns the kept
    names in their original order."""
    names = list(named_cands)
    if keep <= 0 or len(names) <= keep:
        return names
    scorer = ST.CandidateScorer(measurer=MM.SimulatedMeasurer(PLAN_MESH_SHAPE))
    score = ST.feasibility_score(scorer, cfg, shape, hw)
    ranked = sorted(names[1:],
                    key=lambda n: (score(named_cands[n]), names.index(n)))
    kept = {names[0], *ranked[:max(keep - 1, 0)]}
    dropped = [n for n in names if n not in kept]
    print(f"prune[simulate]: compiling {len(kept)}/{len(names)} variants "
          f"(budget {keep}; ties break by listing order); pruned: "
          f"{','.join(dropped)}", flush=True)
    return [n for n in names if n in kept]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="",
                    help="comma-separated named variants to count; empty = "
                         "planning phase only")
    ap.add_argument("--compile-budget", type=int, default=5,
                    help="max variants to count after the simulate-backed "
                         "shortlist screen (0 = count all; the reference's "
                         "name)")
    ap.add_argument("--plan", default="",
                    help="remat,microbatches,optimizer,kv_shard")
    ap.add_argument("--strategy", default="greedy",
                    choices=list(ST.CLI_STRATEGIES),
                    help="planning-phase search strategy over the variant "
                         "space")
    ap.add_argument("--backend", default="simulate",
                    choices=["simulate", "cuda"],
                    help="measurement backend for the planning phase; "
                         "simulate = no device, cuda = steps on one card")
    ap.add_argument("--memory", action="store_true",
                    help="also measure each counted variant's step on the "
                         "card (CudaMeasurer)")
    ap.add_argument("--out", default="artifacts/hillclimb")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    base_plan = MemoryPlan()
    if args.plan:
        r, m, o, kv = args.plan.split(",")
        base_plan = MemoryPlan(remat=r, microbatches=int(m), optimizer=o,
                               kv_shard=kv)
    base_cand = SPACE.point(cfg, base=SP.Candidate(plan=base_plan))

    plan_phase(cfg, shape, base_cand, args.strategy, args.backend, PLAN_HW)
    if not args.variants:
        return 0

    named_cands = {vname: SPACE.point(cfg, base=base_cand, **VARIANTS[vname])
                   for vname in args.variants.split(",")}
    shortlist = prune_variants(cfg, shape, named_cands, args.compile_budget,
                               PLAN_HW)

    os.makedirs(args.out, exist_ok=True)
    results = {}
    base = None
    for vname in shortlist:
        cand = named_cands[vname]
        try:
            r = run_variant(cfg, shape, cand, VARIANTS[vname], args.memory,
                            PLAN_HW)
        except (NoCounterpart, RC.CountError) as e:
            print(f"{vname:16s} FAILED: {e}", flush=True)
            continue
        results[vname] = r
        if base is None:
            base = r

        def delta(k):
            return (r[k] / base[k] - 1.0) * 100 if base[k] else 0.0

        extra = (f" temp={r.get('temp_bytes', 0) / 2**30:.2f}GiB"
                 if args.memory and "temp_bytes" in r else "")
        print(f"{vname:16s} comp={r['t_comp']:.3f}s({delta('t_comp'):+.0f}%) "
              f"mem={r['t_mem']:.3f}s({delta('t_mem'):+.0f}%) "
              f"coll={r['t_coll']:.3f}s({delta('t_coll'):+.0f}%) "
              f"roof={r['t_roofline']:.3f}s "
              f"bottleneck={r['bottleneck']} "
              f"mfu_bound={r['mfu_bound']:.3f}{extra}", flush=True)
    path = os.path.join(args.out, f"{args.arch}__{args.shape}.json")
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing.update(results)
    with open(path, "w") as f:
        json.dump(existing, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
