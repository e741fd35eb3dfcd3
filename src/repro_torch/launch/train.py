"""End-to-end training driver of the port, after the reference package's
launch/train.py.

The memory plan (remat x microbatches x optimizer) comes from the flags
(default: `MemoryPlan()`); the WSMC online phase that plans it (profiling
ladder, classification, plan search) waits for the profiler (ROADMAP A3),
and `--mesh` for the parallel layer (A8). The workload class the capacity
model needs is fixed here by hand: Expanding.Medium, the class the reference
package's compile-free simulator assigns h2o-danube-1.8b's training step at
seq 2048, batch 4; for any other model or shape `main` says that the
prediction uses that workload's factors. `main` prints the capacity
model's resident + transient prediction for the plan and, on a CUDA
device, the measured `torch.cuda.max_memory_allocated()` beside it.

Examples:
  # tiny CPU run (reduced config), 50 steps:
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --reduced --seq 128 --batch 8 --steps 50 --device cpu

  # full width on one GPU, a few steps:
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --seq 2048 --batch 4 --steps 4 --lr 1e-4
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TRAIN, ShapeConfig, depth_variant
from repro_torch.core import classifier as CL
from repro_torch.core import predictor as PR
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import init_params
from repro_torch.models.model import require_device
from repro_torch.optim import optimizers as opt
from repro_torch.runtime import fault as F
from repro_torch.runtime import schedule as SCH
from repro_torch.runtime.train_step import TrainStepConfig
from repro_torch.tree import tree_leaves

# Fixed by hand until the profiler is ported (ROADMAP A3): the reference
# simulator's classification of h2o-danube-1.8b's training step (alpha
# 29.79, inc 1.11: Expanding.Medium, Table III factor 3).
TRAIN_WORKLOAD = CL.Classification(
    category=CL.Category.EXPANDING_MEDIUM, alpha=29.794921875,
    inc=1.1100134710372702, slope=772.5, intercept=-100352000.0)
# (arch, seq, batch) the fixed class was measured for; any other run's
# prediction uses this workload's factors, and `main` says so
TRAIN_WORKLOAD_OF = ("h2o-danube-1.8b", 2048, 4)
MESH = {"data": 1, "model": 1}


def reduced_100m(cfg):
    """~100M-parameter variant of an arch family (examples deliverable)."""
    return dataclasses.replace(
        cfg.reduced(), name=cfg.name + "-100m",
        d_model=512, head_dim=64, n_heads=8,
        n_kv_heads=min(8, max(1, cfg.n_kv_heads)),
        d_ff=0 if cfg.d_ff == 0 else 2048, vocab_size=32000,
        lru_width=None if cfg.lru_width is None else 512)


def fit_microbatches(plan, batch: int):
    """Clamp the plan's microbatch count to one that divides the global
    batch (the scan schedule's only constraint without a pipe axis),
    preferring the nearest to the planned value."""
    m0 = max(plan.microbatches, 1)
    if batch % m0 == 0:
        return plan
    fits = [m for m in range(1, batch + 1) if batch % m == 0]
    micro = min(fits, key=lambda m: (abs(m - m0), m))
    print(f"note: adjusted microbatches {m0} -> {micro} to fit "
          f"batch={batch}")
    return dataclasses.replace(plan, microbatches=micro)


def predicted_bytes(cfg, shape: ShapeConfig, plan: PR.MemoryPlan):
    """(resident, transient) bytes the capacity model predicts for one
    device running `plan`."""
    return (PR.resident_bytes(cfg, shape, plan, MESH),
            PR.transient_bytes(cfg, shape, plan, TRAIN_WORKLOAD, MESH))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--reduced-100m", action="store_true")
    ap.add_argument("--depth", type=int, default=0,
                    help="override depth to N unit repeats")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=100)
    ap.add_argument("--remat", default="")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--optimizer", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced_100m:
        cfg = reduced_100m(cfg)
    elif args.reduced:
        cfg = cfg.reduced()
    if args.depth:
        cfg = depth_variant(cfg, args.depth)
    shape = ShapeConfig("train_cli", TRAIN, args.seq, args.batch)

    plan = PR.MemoryPlan()
    if args.remat:
        plan = dataclasses.replace(plan, remat=args.remat)
    if args.microbatches:
        plan = dataclasses.replace(plan, microbatches=args.microbatches)
    if args.optimizer:
        plan = dataclasses.replace(plan, optimizer=args.optimizer)
    plan = fit_microbatches(plan, args.batch)
    tcfg = TrainStepConfig(
        remat=plan.remat, microbatches=plan.microbatches,
        optimizer=opt.OptimizerConfig(kind=plan.optimizer, lr=args.lr),
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(gen, cfg, device=dev)
    opt_state = opt.init_state(tcfg.optimizer, params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    step_fn = SCH.make_train_step(cfg, tcfg)
    print(f"arch={cfg.name} params={n_params:,} device={dev} "
          f"schedule={step_fn.schedule} plan={plan}")
    res, tra = predicted_bytes(cfg, shape, plan)
    arch0, seq0, batch0 = TRAIN_WORKLOAD_OF
    print(f"WSMC: predicted resident {res / 1e9:.3f} GB + transient "
          f"{tra / 1e9:.3f} GB = {(res + tra) / 1e9:.3f} GB "
          f"(class {TRAIN_WORKLOAD.category.value}, fixed: classified for "
          f"{arch0} at seq {seq0}, batch {batch0})")
    if (cfg.name, args.seq, args.batch) != TRAIN_WORKLOAD_OF:
        print(f"WSMC: note: this run is {cfg.name} at seq {args.seq}, batch "
              f"{args.batch}; its transient term uses the fixed class's "
              "factors, not its own (classification needs the profiler, "
              "ROADMAP A3)")

    data_pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=args.seq,
                                         global_batch=args.batch,
                                         seed=args.seed))
    ckpt_mgr = (F.CheckpointManager(args.ckpt_dir, args.ckpt_interval)
                if args.ckpt_dir else None)
    start_step = 0
    if ckpt_mgr and ckpt_mgr.latest_step() is not None:
        tree = {"params": params, "opt": opt_state}
        tree, manifest = ckpt_mgr.restore(tree, device=dev)
        params, opt_state = tree["params"], tree["opt"]
        start_step = manifest["extra"].get("step", manifest["step"])
        print(f"resumed from step {start_step}")

    guard = F.PreemptionGuard(install=True)
    watchdog = F.Watchdog()

    def on_metrics(step, m):
        if step % args.log_every == 0:
            print(f"step {step:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.2f} lr={m['lr']:.2e}", flush=True)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    params, opt_state, last, hist = F.run_train_loop(
        train_step=step_fn, params=params, opt_state=opt_state,
        pipeline=data_pipe, n_steps=args.steps, ckpt_mgr=ckpt_mgr,
        watchdog=watchdog, guard=guard, start_step=start_step,
        on_metrics=on_metrics)
    dt = time.time() - t0
    if hist:
        print(f"done: {last - start_step} steps in {dt:.1f}s "
              f"({dt / max(last - start_step, 1):.2f}s/step), "
              f"final loss {hist[-1]['loss']:.4f}")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"memory: torch.cuda.max_memory_allocated() "
              f"{peak / 1e9:.3f} GB; predicted {(res + tra) / 1e9:.3f} GB; "
              f"measured / predicted {peak / (res + tra):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
