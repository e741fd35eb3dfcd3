"""End-to-end training driver of the port, after the reference package's
launch/train.py.

WSMC is in the loop: unless the flags force every knob, the trainer profiles
the workload on a small-shape ladder, classifies it, and applies the
planned memory configuration (remat x microbatches x optimizer) before the
first real step (the paper's section III-E online phase). The plan is made
for the card this trainer runs on: `PLAN_HW` (an H100's 80 GB), where the
reference plans for a TPU v5e.

  --backend simulate  classify with the device-free simulator (default);
  --backend cuda      classify with one step per ladder point measured on
                      the card (core.measure.CudaMeasurer); its params are
                      released before the trainer makes its own, and the
                      planning steps and their time are printed;
  --mesh ''           the (data, model) host mesh of the world's devices,
                      its model axis from --model-parallel (which spawns
                      that many ranks where no world is live);
  --mesh auto         the mesh is a planned output (search.execplan
                      .auto_plan over the world's devices);
  --mesh data:2,pipe:2  a forced mesh: FSDP over "data", the 1F1B pipeline
                      over "pipe", tensor parallelism over "model" (the
                      single and scan schedules, on archs without
                      recurrent blocks; a MoE arch under expert
                      parallelism where its experts tile the axis, else
                      tensor parallelism inside the experts:
                      runtime.schedule.check_training_mesh; not inside the
                      pipeline);
  --routes-out F      MoE archs: every routing call's experts and kept
                      choices, keyed by (step, microbatch, layer), to F;
  --replay-routes F   MoE archs: each routing call takes the entry of its
                      (step, microbatch, layer) in another run's F (a
                      remat recompute takes what its forward took), so a
                      one-rank run can take a mesh's routes.

A mesh of more than one rank runs as that many processes: under
`torchrun` the world torchrun made (one process per rank, `--mesh auto`
plans over its size); otherwise the CLI spawns its own local ranks
(`launch.mesh.spawn_ranks`), joined over `--dist-backend` (default nccl on
the card, which needs one card a rank, and gloo on the CPU; gloo also lets
ranks share one card). Every rank reads the same global batch and keeps
its rows; rank 0 prints. `main` prints the capacity model's resident +
transient prediction for the plan under the classified workload and, on a
CUDA device, the measured `torch.cuda.max_memory_allocated()` beside it;
on a mesh, one line a rank: its parameter elements, its peak, its flash
forward / backward launches, the bytes its collectives staged through
the host (in all and by kind), a fingerprint of its final state (params
and optimizer state) and one of the leaves it holds whole on the model
axis (equal on the ranks of a model group), with a route tape a digest
of its MoE routes; and each rank's class and plan (the ranks of a `--backend cuda` model axis plan alike: its
readings are reduced over the ranks).

Examples:
  # tiny CPU run (reduced config), 50 steps:
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --reduced --seq 128 --batch 8 --steps 50 --device cpu

  # full width on one GPU, a few steps, classified on the card:
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --seq 2048 --batch 4 --steps 4 --lr 1e-4 --backend cuda

  # four ranks on the CPU, FSDP over data and two pipeline stages:
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --reduced --depth 4 --seq 32 --batch 8 --steps 5 --device cpu \\
      --remat none --microbatches 4 --optimizer adamw_f32 \\
      --mesh data:2,pipe:2

  # four ranks on the CPU, FSDP over data and tensor parallelism over model:
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --reduced --depth 4 --seq 32 --batch 8 --steps 5 --device cpu \\
      --remat none --microbatches 1 --optimizer adamw_f32 \\
      --mesh data:2,model:2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch import hw as HW
from repro_torch.checkpoint.ckpt import fingerprint
from repro_torch.configs import get_config
from repro_torch.configs.base import TRAIN, ShapeConfig, depth_variant
from repro_torch.core import measure as MM
from repro_torch.core import predictor as PR
from repro_torch.core import profiler as PF
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention_bwd as FB
from repro_torch.launch import mesh as LM
from repro_torch.models import init_params
from repro_torch.models import moe as MOE
from repro_torch.models.model import require_device
from repro_torch.optim import optimizers as opt
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as S
from repro_torch.runtime import fault as F
from repro_torch.runtime import schedule as SCH
from repro_torch.runtime import schedule_kinds as SK
from repro_torch.runtime.train_step import TrainStepConfig
from repro_torch.search import execplan as XP
from repro_torch.search import space as SP
from repro_torch.search import strategies as ST
from repro_torch.tree import tree_leaves

# the device the plan is made for
PLAN_HW = HW.H100


def reduced_100m(cfg):
    """~100M-parameter variant of an arch family (examples deliverable)."""
    return dataclasses.replace(
        cfg.reduced(), name=cfg.name + "-100m",
        d_model=512, head_dim=64, n_heads=8,
        n_kv_heads=min(8, max(1, cfg.n_kv_heads)),
        d_ff=0 if cfg.d_ff == 0 else 2048, vocab_size=32000,
        lru_width=None if cfg.lru_width is None else 512)


def fit_microbatches(cfg, plan, mesh_shape: dict, batch: int):
    """Clamp the plan's microbatch count to what the mesh can execute: it
    must divide the global batch and, on pipe meshes, satisfy the shared
    1F1B executability predicate (schedule_kinds.pipeline_problems: fill
    the pipeline, per-microbatch batch divisible by the data axes; the
    flat schedules need the per-microbatch batch divisible by the data
    axes, which split each microbatch's rows). Prefers the nearest valid
    value to the planned one."""
    pipe = max(int(mesh_shape.get("pipe", 1)), 1)
    dp = int(mesh_shape.get("pod", 1)) * int(mesh_shape.get("data", 1))

    def ok(m):
        if batch % m or (batch // m) % dp:
            return False
        if pipe <= 1:
            return True
        return SK.pipeline_executable(cfg, m, mesh_shape, batch)

    m0 = max(plan.microbatches, 1)
    if ok(m0):
        return plan
    fits = [m for m in range(1, batch + 1) if ok(m)]
    if not fits:
        why = "; ".join(SK.pipeline_problems(cfg, m0, mesh_shape, batch))
        raise ValueError(f"global batch {batch} cannot run on mesh "
                         f"{mesh_shape}: {why}")
    micro = min(fits, key=lambda m: (abs(m - m0), m))
    print(f"note: adjusted microbatches {m0} -> {micro} to fit "
          f"pipe={pipe}, batch={batch}")
    return dataclasses.replace(plan, microbatches=micro)


def parse_mesh(spec: str) -> dict:
    """'data:2,pipe:2' -> {'data': 2, 'pipe': 2}. Unknown axis names are
    rejected: a typo ('pip:2') would otherwise train on an inert axis."""
    out = {}
    for part in spec.split(","):
        axis, sep, n = part.partition(":")
        axis = axis.strip()
        if not sep or not n.strip().isdigit() or int(n) < 1:
            raise ValueError(f"bad --mesh entry {part!r}; want axis:size "
                             "with size >= 1")
        if axis not in LM.CANONICAL_AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; "
                             f"known: {LM.CANONICAL_AXES}")
        if axis in out:
            raise ValueError(f"duplicate mesh axis {axis!r} in {spec!r}")
        out[axis] = int(n)
    return out


def routes_digest(calls) -> str:
    """A digest of a keyed route tape's experts and kept choices, in the
    order of their sites."""
    return fingerprint([t for key in sorted(calls, key=repr)
                        for t in calls[key]])


def _report_ranks(mesh, params, opt_state, spec_tree, dev, before, steps,
                  plan_line, tape=None):
    """Rank 0 prints one line a rank: its parameter elements, its peak
    device memory, its flash launches, the bytes its collectives staged
    through the host (and by kind) and the seconds they took (host clock),
    a step; the fingerprint of its params and optimizer state
    (`ckpt.fingerprint`), and of its params the model axis does not split
    (equal on every rank of a model group); with a route tape, the digest
    of its routes (equal on every rank of a model group); then each rank's
    plan line.
    nccl collectives run on the stream and are not timed. Returns 1 when
    a rank planned other than rank 0."""
    fwd, bwd, staged, secs = (a - b for a, b in zip(_counters()[:4],
                                                     before[:4]))
    kinds = {k: v - before[4].get(k, 0)
             for k, v in comm.staged_by_kind.items()
             if v - before[4].get(k, 0)}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    steps = max(steps, 1)
    whole = [t for t, s in zip(tree_leaves(params), tree_leaves(spec_tree))
             if "model" not in s.axes()]
    mine = (mesh.rank, sum(x.numel() for x in tree_leaves(params)), peak,
            fwd, bwd, staged / steps, secs / steps,
            {k: v / steps for k, v in kinds.items()},
            fingerprint({"params": params, "opt": opt_state}),
            fingerprint(whole),
            "" if tape is None else f"; routes digest "
            f"{routes_digest(tape.calls)}", plan_line)
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, mine)
    gloo = dist.get_backend() == "gloo"
    for r, n, pk, f, b, st, sec, by_kind, fp, fp_whole, routes, _ in rows:
        mem = ("not measured (CPU)" if pk is None
               else f"{pk / 1e9:.3f} GB")
        took = f"{sec:.2f} s a step" if gloo else "not timed (nccl)"
        kind = ", ".join(f"{k} {v:.0f}" for k, v in sorted(
            by_kind.items(), key=str)) or "none"
        print(f"rank {r}: param elements {n:,}; max_memory_allocated "
              f"{mem}; flash launches forward {f}, backward {b}; staged "
              f"through the host {st:.0f} B a step; collectives {took}; "
              f"by kind ({kind}); state fingerprint {fp}; model-whole "
              f"fingerprint {fp_whole}{routes}")
    for row in rows:
        print(f"rank {row[0]} plan: {row[-1]}")
    bad = sum(row[-1] != rows[0][-1] for row in rows)
    if bad:
        print(f"ERROR: {bad} rank(s) planned other than rank 0")
        return 1
    return 0


def _counters():
    return (FA.launches, FB.launches, comm.staged_bytes, comm.seconds,
            dict(comm.staged_by_kind))


def predicted_bytes(cfg, shape: ShapeConfig, plan: PR.MemoryPlan, cls,
                    mesh_shape):
    """(resident, transient) bytes the capacity model predicts for one
    device of `mesh_shape` running `plan`, the transient under the
    workload class `cls`."""
    return (PR.resident_bytes(cfg, shape, plan, mesh_shape),
            PR.transient_bytes(cfg, shape, plan, cls, mesh_shape))


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
    ap.add_argument("--mesh", default="",
                    help="'' = the (data, model) host mesh of the world's "
                         "devices; 'auto' = plan the mesh over them; "
                         "'data:2,pipe:2' = forced mesh")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the host mesh's model axis, as the reference's "
                         "flag: M ranks are spawned (or torchrun's world "
                         "taken) and the model axis is the largest size "
                         "up to M that divides the world")
    ap.add_argument("--strategy", default="fastest",
                    choices=list(ST.CLI_STRATEGIES),
                    help="plan-search strategy for the WSMC online phase")
    ap.add_argument("--backend", default="simulate",
                    choices=["simulate", "cuda"],
                    help="memory-measurement backend for the profiling "
                         "ladder: simulate = nothing run on the card; cuda "
                         "= one step per point on the card")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=100)
    ap.add_argument("--remat", default="")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--optimizer", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--routes-out", default="",
                    help="MoE archs: write every MoE routing call's chosen "
                         "experts and kept choices, keyed by (step, "
                         "microbatch, layer), to this file (torch.save; "
                         "rank 0)")
    ap.add_argument("--replay-routes", default="",
                    help="MoE archs: another run's --routes-out file (the "
                         "same steps and rows): every MoE routing call "
                         "takes the experts and kept choices of its (step, "
                         "microbatch, layer) there (its own are still the "
                         "ones --routes-out writes)")
    ap.add_argument("--dist-backend", default="",
                    choices=["", *LM.BACKENDS],
                    help="torch.distributed backend of a mesh's ranks "
                         "(default nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    backend = args.dist_backend or ("nccl" if dev.type == "cuda"
                                    else "gloo")
    forced_mesh = (parse_mesh(args.mesh) if args.mesh not in ("", "auto")
                   else None)
    if args.model_parallel < 1:
        ap.error("--model-parallel must be >= 1")
    cfg = get_config(args.arch)
    if args.reduced_100m:
        cfg = reduced_100m(cfg)
    elif args.reduced:
        cfg = cfg.reduced()
    if args.depth:
        cfg = depth_variant(cfg, args.depth)
    if (args.routes_out or args.replay_routes) and not cfg.is_moe:
        ap.error("--routes-out/--replay-routes need a MoE arch")
    if forced_mesh and forced_mesh.get("pipe", 1) <= 1:
        # refused here, before any rank starts
        SCH.check_training_mesh(cfg, forced_mesh)
    live = dist.is_available() and dist.is_initialized()
    if not live:
        world = (int(os.environ["WORLD_SIZE"]) if LM.under_torchrun()
                 else args.model_parallel if args.mesh == "" else 1)
        if args.mesh == "" and world > 1:
            SCH.check_training_mesh(cfg, XP.host_execution(
                cfg, ShapeConfig("train_cli", TRAIN, args.seq, args.batch),
                PR.MemoryPlan(), world, args.model_parallel).mesh_shape)
        if forced_mesh:
            n = 1
            for v in forced_mesh.values():
                n *= v
            if LM.under_torchrun() and n != world:
                raise ValueError(f"--mesh {args.mesh!r} needs {n} ranks; "
                                 f"torchrun started {world}")
            world = n
        if world > 1:
            return LM.spawn_ranks(LM.cli_rank, world, backend, dev.type,
                                  args=(main, argv))[0]
    world = dist.get_world_size() if live else 1
    if live and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    shape = ShapeConfig("train_cli", TRAIN, args.seq, args.batch)

    forced_plan = None
    if args.remat and args.microbatches and args.optimizer:
        forced_plan = PR.MemoryPlan(remat=args.remat,
                                    microbatches=args.microbatches,
                                    optimizer=args.optimizer)

    def apply_overrides(plan):
        if args.remat:
            plan = dataclasses.replace(plan, remat=args.remat)
        if args.microbatches:
            plan = dataclasses.replace(plan, microbatches=args.microbatches)
        if args.optimizer:
            plan = dataclasses.replace(plan, optimizer=args.optimizer)
        return plan

    if args.mesh and args.model_parallel != 1:
        print("note: --model-parallel only shapes the legacy host mesh; "
              "with --mesh the model axis comes from the plan/spec")

    # ---- WSMC online phase: plan (and possibly the mesh) ----------------
    base_seq = min(64, args.seq)
    cuda_measurer = mesh = None
    if args.mesh == "auto":
        if args.backend == "cuda":
            cuda_measurer = MM.CudaMeasurer({"data": world})
        cls, eplan = XP.auto_plan(cfg, shape, n_devices=world,
                                  strategy=args.strategy, base_seq=base_seq,
                                  measurer=cuda_measurer, hw=PLAN_HW)
        plan = fit_microbatches(cfg, apply_overrides(eplan.plan),
                                eplan.mesh_shape, args.batch)
        if plan != eplan.plan:
            eplan = dataclasses.replace(
                eplan, plan=plan,
                schedule=SCH.schedule_kind(TRAIN, plan.microbatches,
                                           eplan.pipe))
        print(f"WSMC[auto]: {cls.category.value} (alpha={cls.alpha:.2f}, "
              f"inc={cls.inc:.2f}) -> {eplan.describe()}")
    else:
        mesh_shape = forced_mesh or XP.host_execution(
            cfg, shape, PR.MemoryPlan(), world,
            args.model_parallel).mesh_shape
        if args.backend == "cuda":
            # a model axis measures over its group: the mesh is made now
            if int(mesh_shape.get("model", 1)) > 1:
                mesh = LM.build_mesh(mesh_shape)
            measurer = cuda_measurer = MM.CudaMeasurer(
                mesh_shape, group=SCH.model_group_of(mesh))
        else:
            measurer = MM.SimulatedMeasurer(mesh_shape)
        # a forced plan is used as it stands; the class still sizes the
        # prediction printed below
        cls = PF.classify_workload(cfg, shape, mesh_shape, n_points=2,
                                   base_seq=base_seq, measurer=measurer)
        if forced_plan is not None:
            # the CLI has no kv flag: resolve the cache layout against the
            # mesh's model axis
            plan = dataclasses.replace(
                forced_plan,
                kv_shard=SP.kv_auto(cfg, int(mesh_shape.get("model", 1))))
            policy = "forced"
            print(f"plan (forced): {plan}")
        else:
            res = ST.plan_for(cfg, shape, cls, mesh_shape,
                              strategy=args.strategy, measurer=measurer,
                              hw=PLAN_HW)
            plan = apply_overrides(res.plan)
            policy = res.policy
            print(f"WSMC[{args.strategy}/{args.backend}]: "
                  f"{cls.category.value} (alpha={cls.alpha:.2f}, "
                  f"inc={cls.inc:.2f}) -> plan {plan} "
                  f"{res.describe_outcome()}")
        plan = fit_microbatches(cfg, plan, mesh_shape, args.batch)
        eplan = XP.for_mesh(cfg, shape, plan, mesh_shape, policy=policy)
        print(f"execution: {eplan.describe()}")
    if eplan.pipe <= 1:
        SCH.check_training_mesh(cfg, eplan.mesh_shape, eplan.plan.kv_shard)
    if mesh is None:
        mesh, strategy = eplan.build(world)
    else:
        strategy = eplan.strategy()
    plan_line = (f"{cls.category.value} (alpha={cls.alpha:.6f}, "
                 f"inc={cls.inc:.6f}) -> {eplan.describe()}")
    if cuda_measurer is not None:
        print(f"planning: {cuda_measurer.steps} steps measured on the card "
              f"in {cuda_measurer.step_seconds:.2f}s")
        cuda_measurer.release()

    plan = eplan.plan
    tcfg = TrainStepConfig(
        remat=plan.remat, microbatches=plan.microbatches,
        optimizer=opt.OptimizerConfig(kind=plan.optimizer, lr=args.lr),
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    spec_tree = ckpt_specs = None
    if mesh is None:
        params = init_params(gen, cfg, device=dev)
        n_params = sum(x.numel() for x in tree_leaves(params))
    else:
        abstract = init_params(None, cfg, device="meta")
        n_params = sum(x.numel() for x in tree_leaves(abstract))
        spec_tree = S.param_specs(cfg, abstract, strategy, mesh)
        del abstract
        params = S.init_local_params(gen, cfg, dev, spec_tree, mesh)
        ckpt_specs = {"params": spec_tree,
                      "opt": opt.state_specs(tcfg.optimizer, spec_tree)}
    opt_state = opt.init_state(tcfg.optimizer, params)
    step_fn = SCH.make_train_step(cfg, tcfg, mesh=mesh,
                                  schedule=eplan.schedule,
                                  spec_tree=spec_tree)
    print(f"arch={cfg.name} params={n_params:,} device={dev} "
          f"mesh={eplan.mesh_shape} schedule={eplan.schedule}")
    res, tra = predicted_bytes(cfg, shape, plan, cls, eplan.mesh_shape)
    print(f"WSMC: predicted resident {res / 1e9:.3f} GB + transient "
          f"{tra / 1e9:.3f} GB = {(res + tra) / 1e9:.3f} GB (class "
          f"{cls.category.value}, alpha {cls.alpha:.2f}, inc {cls.inc:.2f}, "
          f"{args.backend} ladder)")

    data_pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=args.seq,
                                         global_batch=args.batch,
                                         seed=args.seed))
    ckpt_mgr = (F.CheckpointManager(args.ckpt_dir, args.ckpt_interval,
                                    mesh=mesh, spec_tree=ckpt_specs)
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
            router = (f" router_gnorm={m['router_grad_norm']:.6e}"
                      if "router_grad_norm" in m else "")
            print(f"step {step:5d} loss={m['loss']:.6f} "
                  f"gnorm={m['grad_norm']:.6f} lr={m['lr']:.2e}{router}",
                  flush=True)

    tape = None
    if args.routes_out or args.replay_routes:
        tape = MOE.RouteTape(torch.load(args.replay_routes)
                             if args.replay_routes else None, keyed=True)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = _counters()
    t0 = time.time()
    with (MOE.routing(tape) if tape is not None
          else contextlib.nullcontext()):
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
    if args.routes_out and (mesh is None or mesh.rank == 0):
        torch.save(tape.calls, args.routes_out)
    if mesh is not None:
        return _report_ranks(mesh, params, opt_state, spec_tree, dev, before,
                             last - start_step, plan_line, tape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
