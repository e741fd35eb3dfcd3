"""Serving CLI of the port, after the reference package's
launch/serve.py: replay a deterministic synthetic trace through the
memory-governed engine.

The CLI is deliberately thin — all scheduling lives in
`repro_torch.serving.Engine`, all capacity governance in
`search.execplan.plan_serving` (which inverts the WSMC requirement model:
`predictor.serving_capacity` turns the per-device memory budget into a
maximum concurrent-sequence count, and the engine's slot pool is sized
from it; everything beyond queues). Planning defaults to the device-free
simulator, so the only steps run on the card are those that serve
traffic; `--backend cuda` classifies the workload with steps measured on
the card instead (`core.measure.CudaMeasurer`, honored on the `--mesh
auto` path too).

Differences from the reference CLI:
  * the plan is made for the card this CLI runs on: `plan_serving`
    gets `hw=HW.H100` (80 GB), where the reference CLI passes no `hw`
    and so plans for a TPU v5e's 16 GiB. At an explicit `--hbm-budget-gb`
    the two CLIs print the same plan line, since planning reads the
    hardware only through its memory size;
  * `--device` (default cuda; raises without a CUDA device) takes the
    place of the jax device list. The devices are ranks: the world
    `torchrun` made, or `--model-parallel M` local ranks the CLI spawns
    (`launch.mesh.spawn_ranks`, joined over `--dist-backend`: nccl with
    one card a rank, gloo to share one card or on the CPU). The mesh is
    {data: 1, model: M} and serving is tensor-parallel over "model"
    (explicit collectives, `parallel.comm`) where the reference runs GSPMD
    under its axis rules, the params cut under the plan's strategy (a MoE
    arch's experts by expert parallelism where the plan resolved EP, else
    tensor parallelism inside them); a plan with a data (or pipe) axis
    above 1, and an arch the model axis does not cover, raise naming
    ROADMAP queue A item 5 (`runtime.schedule.serving_mesh_problems`)
    before any rank allocates its params;
  * `--backend` is simulate or cuda, and `--forbid-plan-compiles` forbids
    a CudaMeasurer step during planning;
  * the executors are TorchExecutor (ring) and PagedTorchExecutor (paged),
    and on the card the run ends with torch.cuda.max_memory_allocated()
    beside the plan's predicted resident + transient bytes;
  * the run prints a digest of the completions' tokens; on more than one
    rank, one line a rank (its parameter elements against the spec tree's
    shard and `predictor.sharded_param_count`, its pool bytes against the
    predictor's per-device blocks, its peak against the plan's prediction,
    its attention kernels' launches, the bytes its collectives staged
    through the host by kind, a digest of the block tables the engine gave
    its steps and of its tokens), and the CLI fails if any rank's tokens,
    schedule or plan differ from rank 0's.

Examples:
  # CPU, reduced config:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
      --reduced --device cpu --requests 8 --prompt-lens 4,8 \
      --gen-lens 2,4,8 [--mesh auto] [--policy continuous|static|both]
  # one H100, full width, paged:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \
      --kv paged --compact --chunk-prefill 256 --mesh auto --requests 16 \
      --prompt-lens 64,200,256,520,1024,2048 --gen-lens 16,24,32 \
      [--backend simulate|cuda]
  # two ranks, tensor-parallel, on the CPU (reduced config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \
      --reduced --device cpu --kv paged --compact --chunk-prefill 8 \
      --model-parallel 2 --requests 6 --prompt-lens 4,8,20 --gen-lens 2,4
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch import hw as HW
from repro_torch.configs import get_config
from repro_torch.configs.base import DECODE, ShapeConfig, depth_variant
from repro_torch.core import measure as MM
from repro_torch.core import predictor as PR
from repro_torch.core.predictor import MemoryPlan
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_decode as PD
from repro_torch.kernels import paged_prefill as PP
from repro_torch.launch import mesh as LM
from repro_torch.models import init_params
from repro_torch.models import moe as MOE
from repro_torch.models.model import require_device
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as S
from repro_torch.runtime import schedule as SCH
from repro_torch.search import execplan as XP
from repro_torch.search import space as SP
from repro_torch.serving import (AUDIT_MODES, BlockAllocator,
                                 ChaosAllocator, ChaosExecutor, Engine,
                                 FaultPlan, LadderConfig, OnlineLengthStats,
                                 describe_trace, leak_check, length_stats,
                                 survivor_mismatches, synthetic_trace,
                                 trace_context)
from repro_torch.serving.executor import (PagedTorchExecutor, TokenLog,
                                          TorchExecutor, history_key)


def _int_list(s: str):
    return tuple(int(v) for v in s.split(",") if v)


def tokens_digest(reports) -> str:
    """sha256 of every report's completions: (rid, tokens) in rid order."""
    h = hashlib.sha256()
    for rep in reports:
        for c in sorted(rep.completions, key=lambda c: c.rid):
            h.update(repr((c.rid, tuple(int(t) for t in c.tokens)))
                     .encode())
    return h.hexdigest()


def token_records(trace, reports, log):
    """{rid: tokens} of the last report's completions, and {rid: one
    record per token} from the token log: the served step's top logits
    ([ids, values]) and the row's standard deviation, or None where the
    log filed nothing for that token."""
    prompts = {int(r.rid): list(r.prompt) for r in trace}
    tokens = {int(c.rid): [int(t) for t in c.tokens]
              for c in reports[-1].completions}
    records = {}
    for rid, toks in tokens.items():
        rows = []
        for k in range(len(toks)):
            rec = log.records.get(history_key(prompts[rid] + toks[:k]))
            rows.append(None if rec is None else [rec[0], rec[1], rec[2]])
        records[rid] = rows
    return tokens, records


def replay_force(trace, path):
    """{history key: token} that makes a run emit the tokens of another
    run's `--tokens-out` file (the same trace)."""
    with open(path) as f:
        theirs = {int(k): v for k, v in json.load(f)["tokens"].items()}
    force = {}
    for r in trace:
        toks = theirs.get(int(r.rid), [])
        for k, t in enumerate(toks):
            force[history_key(list(r.prompt) + toks[:k])] = int(t)
    return force


def predicted_pool_bytes(cfg, shape: ShapeConfig, splan, n_slots: int,
                         n_blocks: int) -> float:
    """The bytes the predictor charges one device for the pool this CLI
    builds: paged, (n_blocks + 1) x kv_block_bytes_per_device (the scratch
    block included) plus n_slots x lane_bytes_per_device; a slot pool,
    cache_bytes_per_device at n_slots sequences."""
    ex = splan.execution
    sh = dataclasses.replace(shape, kind=DECODE, global_batch=n_slots)
    if not splan.kv_block:
        return PR.cache_bytes_per_device(cfg, sh, ex.plan, ex.mesh_shape)
    return ((n_blocks + 1) * PR.kv_block_bytes_per_device(
        cfg, sh, ex.plan, ex.mesh_shape)
        + n_slots * PR.lane_bytes_per_device(cfg, sh, ex.plan,
                                             ex.mesh_shape))


def _tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _planning_peaks(cfg, measurer, mesh_shape):
    """Each step the card measured while planning: this rank's peak, the
    peak reduced over the ranks, and the simulator's for the same point
    (bytes)."""
    sim = MM.SimulatedMeasurer(mesh_shape)
    return [(sh.kind, sh.seq_len, sh.global_batch, mine[3], red[3],
             sim.measure(cfg, sh, plan).peak_bytes)
            for sh, plan, mine, red in measurer.records]


def _report_ranks(cfg, mesh, specs, params, executor, splan, shape, n_slots,
                  n_blocks, predicted, dev, digest, plan_line,
                  planning, draw_peak) -> int:
    """Rank 0 prints one line a rank: parameter elements against the spec
    tree's shard and the predictor's sharded_param_count, pool bytes
    against the predictor's, the peak against the plan's prediction, the
    attention kernels' launches and the engine's step calls, the bytes
    staged through the host by kind, the digests of the block tables the
    engine gave the steps (the schedule: retention's drops included) and
    of the tokens; and, where the card measured planning steps, each
    step's peak on the rank, over the ranks and in the simulator; and the
    rank's peak up to its params (planning and the draws, `draw_peak`).
    Returns 1 when a rank's tokens, schedule or plan differ from rank
    0's."""
    from repro_torch.tree import tree_leaves
    abstract = init_params(None, cfg, device="meta")
    want = sum(int(torch.Size(S.local_shape(t.shape, s, mesh)).numel())
               for t, s in zip(tree_leaves(abstract), tree_leaves(specs)))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    mine = dict(rank=mesh.rank, coords=dict(mesh.coords),
                elements=sum(t.numel() for t in tree_leaves(params)),
                spec_elements=want, pool=_tree_bytes(executor.pool),
                peak=peak,
                launches=dict(paged_decode=PD.launches,
                              paged_prefill=PP.launches,
                              decode_attention=DA.launches,
                              flash_attention=FA.launches),
                calls=dict(decodes=executor.decodes,
                           chunk_calls=getattr(executor, "chunk_calls", 0),
                           prefills=executor.prefills,
                           prefill_calls=_prefill_calls(executor)),
                staged=comm.staged_bytes, by_kind=dict(comm.staged_by_kind),
                schedule=getattr(executor, "schedule_digest", "none"),
                digest=digest, plan=plan_line, planning=planning,
                draw_peak=draw_peak)
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, mine)
    sharded = PR.sharded_param_count(cfg, splan.execution.mesh_shape)
    pool_want = predicted_pool_bytes(cfg, shape, splan, n_slots, n_blocks)
    bad = 0
    for r in rows:
        mem = ("not measured (CPU)" if r["peak"] is None else
               f"{r['peak'] / 1e9:.3f} GB (predicted {predicted / 1e9:.3f}"
               f" GB, measured / predicted {r['peak'] / predicted:.4f})")
        kinds = ", ".join(f"{k} {v}" for k, v in sorted(
            r["by_kind"].items(), key=str)) or "none"
        print(f"rank {r['rank']} {r['coords']}: param elements "
              f"{r['elements']:,} (spec tree {r['spec_elements']:,}; "
              f"sharded_param_count {sharded:,.0f}); pool {r['pool']} B "
              f"(predicted {pool_want:.0f} B); max_memory_allocated {mem}; "
              f"launches " + ", ".join(f"{k} {v}" for k, v in
                                      r["launches"].items())
              + "; calls " + ", ".join(f"{k} {v}" for k, v in
                                      r["calls"].items())
              + f"; staged through the host {r['staged']} B ({kinds}); "
              f"schedule digest {r['schedule']}; tokens digest "
              f"{r['digest']}")
        print(f"rank {r['rank']} plan: {r['plan']}")
        if r["draw_peak"] is not None:
            print(f"rank {r['rank']} params drawn: max_memory_allocated "
                  f"{r['draw_peak'] / 1e9:.3f} GB (planning and the "
                  f"draws)")
        for kind, seq, batch, own, red, sim in r["planning"]:
            print(f"rank {r['rank']} planning step {kind} seq {seq} batch "
                  f"{batch}: peak {own:.0f} B on this rank, {red:.0f} B "
                  f"max over the ranks, simulator {sim:.0f} B")
        bad += (r["digest"], r["plan"], r["schedule"]) != (
            rows[0]["digest"], rows[0]["plan"], rows[0]["schedule"])
    if bad:
        print(f"ERROR: {bad} rank(s) emitted tokens, planned or scheduled "
              "other than rank 0")
        return 1
    return 0


def _prefill_calls(executor) -> int:
    """Prefill steps the executor ran (each launches the flash kernel once
    an attention layer)."""
    if isinstance(executor, PagedTorchExecutor):
        return sum(executor.shape_calls["prefill"].values())
    return executor.prefill_calls


def predicted_bytes(cfg, shape: ShapeConfig, splan, cls, n_slots: int,
                    n_blocks: int, seq_lens, compact: bool, chunk: int):
    """(resident, transient) bytes the plan's capacity model charges the
    engine this CLI builds: `n_slots` lanes and, paged, a pool of
    `n_blocks` blocks plus the scratch block; the transient is the term the
    planner's inversion charged (predictor.serving_block_capacity: the
    expected reach and, with `compact`, the bucketed expected width unless
    admission is "worst"; the prefill budget over `chunk`-sized pieces)."""
    ex = splan.execution
    plan, mesh = ex.plan, ex.mesh_shape
    sh = dataclasses.replace(shape, kind=DECODE, global_batch=n_slots)
    if not splan.kv_block:
        pred = PR.predict(cfg, sh, plan, cls, mesh, hw=HW.H100)
        return pred.resident_bytes, pred.transient_bytes
    resident = (PR.resident_bytes(cfg, sh, plan, mesh)
                - PR.cache_bytes_per_device(cfg, sh, plan, mesh)
                + n_slots * PR.lane_bytes_per_device(cfg, sh, plan, mesh)
                + (n_blocks + 1) * PR.kv_block_bytes_per_device(
                    cfg, sh, plan, mesh))
    block = splan.kv_block
    lens = [max(int(s), 1) for s in seq_lens] or [1]
    reach, width = shape.context, n_slots
    if splan.admission != "worst":
        avg = -(-sum(lens) // len(lens))
        reach = min(-(-avg // block) * block, shape.context)
        if compact:
            e_frac = (sum(lens) / len(lens)) / max(lens)
            width = XP._bucket_cover(
                max(1, int(-(-(n_slots * e_frac) // 1))), n_slots)
    if plan.kv_retain > 0:
        reach = min(reach, (plan.kv_retain + 1) * block)
    sh_t = dataclasses.replace(sh, seq_len=reach, global_batch=width)
    transient = PR.transient_bytes(cfg, sh_t, plan, cls, mesh)
    if splan.prefill_budget:
        transient = max(transient, PR.prefill_transient_bytes(
            cfg, shape, plan, cls, mesh,
            prefill_tokens=splan.prefill_budget, reach=reach,
            width=-(-splan.prefill_budget // max(chunk, 1)),
            kernel=splan.prefill_kernel))
    return resident, transient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--depth", type=int, default=0,
                    help="override depth to N unit repeats")
    # trace knobs (deterministic: same seed + knobs => same trace)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-lens", type=_int_list, default=(4, 8))
    ap.add_argument("--gen-lens", type=_int_list, default=(2, 4, 8))
    ap.add_argument("--arrival-mean", type=float, default=1.0,
                    help="mean inter-arrival ticks; <=0 = burst at tick 0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--context", type=int, default=0,
                    help="ring-cache extent; 0 = max prompt+gen in the trace")
    # planning knobs
    ap.add_argument("--mesh", default="", choices=["", "auto"],
                    help="'' = (data, model) host mesh from --model-parallel; "
                         "'auto' = search the serving lattice for the mesh "
                         "that maximizes admitted concurrency")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the model axis (tensor parallelism); "
                         "without torchrun the CLI spawns this many local "
                         "ranks")
    ap.add_argument("--dist-backend", default="",
                    choices=["", *LM.BACKENDS],
                    help="torch.distributed backend of the ranks (default "
                         "nccl on cuda, one card a rank; gloo on cpu, or "
                         "to share one card)")
    ap.add_argument("--backend", default="simulate",
                    choices=["simulate", "cuda"],
                    help="measurement backend for workload classification; "
                         "simulate = no step on the card at startup; cuda "
                         "= one measured step per ladder point")
    ap.add_argument("--hbm-budget-gb", type=float, default=0.0,
                    help="per-device memory budget for admission (GiB); "
                         "0 = the H100's full 80 GB")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--kv", default="ring", choices=["ring", "paged"],
                    help="KV pool layout: 'ring' = worst-case whole-"
                         "sequence slots (baseline); 'paged' = block pool "
                         "with per-sequence block tables — admission "
                         "charges actual footprint, so short requests "
                         "stop paying max-context bytes")
    ap.add_argument("--kv-block", type=int, default=0,
                    help="paged KV block size in positions; 0 = search "
                         "the serving lattice for it")
    ap.add_argument("--compact", action="store_true",
                    help="paged only: run the decode step at bucketed "
                         "lane widths and pack active lanes into the "
                         "smallest covering bucket each tick — partially "
                         "occupied ticks stop paying full pool width")
    ap.add_argument("--chunk-prefill", type=int, default=0,
                    help="paged only: split prompts longer than this into "
                         "chunks of this many positions, interleaved with "
                         "decode ticks (rounded up to a kv-block multiple; "
                         "0 = whole-prompt prefill at admission)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="paged only: cap on prompt tokens prefilled per "
                         "tick across all mid-prefill lanes, fair-shared "
                         "over SLO classes (needs --chunk-prefill; 0 = "
                         "every pending lane advances one chunk per tick). "
                         "The planner charges the budget — not the whole "
                         "prompt — as the prefill transient, so a tight "
                         "budget converts transient headroom into lanes")
    ap.add_argument("--prefill-kernel", default="tiled",
                    choices=["tiled", "dense"],
                    help="prefill transient model for planning: 'tiled' = "
                         "the fused flash-prefill kernel (O(chunk x block) "
                         "tiles, no score matrix or dequantized fp context "
                         "in device memory); 'dense' = the plain path that "
                         "materializes O(chunk x context) scores")
    ap.add_argument("--admission", default="worst",
                    choices=["worst", "optimistic"],
                    help="paged only: block reservation discipline. "
                         "'worst' reserves every block a request can "
                         "write (deadlock-free; nothing is preempted); "
                         "'optimistic' reserves E[blocks] + sigma-k "
                         "margin from the trace's length stats and "
                         "evicts-and-requeues (SLO class, then lowest "
                         "progress) when the prediction misses")
    ap.add_argument("--sigma-k", type=float, default=1.0,
                    help="safety margin in per-bucket std deviations for "
                         "--admission optimistic reservations")
    ap.add_argument("--prefix-share", action="store_true",
                    help="paged only: refcount-share the physical blocks "
                         "of the common system-prompt prefix across "
                         "requests (one prefill per unique prefix); "
                         "needs --prefix-len and chunked prefill "
                         "(defaults --chunk-prefill to one kv block)")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="shared system-prompt tokens prepended to every "
                         "request's own prompt (0 = no shared prefix)")
    ap.add_argument("--kv-quant", default="none",
                    choices=["none", "int8", "int4"],
                    help="paged only: per-block KV quantization. Blocks "
                         "store int8 (or nibble-packed int4) codes plus "
                         "per-position absmax scales; the decode kernel "
                         "dequantizes on the block-table DMA path, so "
                         "the fp pool is never materialized")
    ap.add_argument("--kv-retain", type=int, default=0,
                    help="paged only: keep only the k most-attended "
                         "blocks per sequence (plus the write tail), "
                         "evicting cold blocks back to the allocator "
                         "free list after each decode tick (0 = exact, "
                         "keep everything)")
    ap.add_argument("--min-agreement", type=float, default=0.0,
                    help="planner floor on predicted token agreement: "
                         "bending candidates (quantized/retained) whose "
                         "agreement prior falls below this are dropped "
                         "before capacity scoring")
    ap.add_argument("--measure-agreement", action="store_true",
                    help="after serving, replay every request through "
                         "exact greedy_generate and report the measured "
                         "token-agreement fraction (slow: one reference "
                         "decode per unique prompt)")
    ap.add_argument("--slo", type=_int_list, default=(0,),
                    help="SLO classes requests draw from (0 = strictest, "
                         "evicted last under pool pressure)")
    ap.add_argument("--max-slots", type=int, default=8,
                    help="cap on the engine's slot pool / decode lanes "
                         "(the WSMC capacity is the bound; this caps it "
                         "for small hosts)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="paged only: arm the deterministic chaos harness "
                         "with this seed — transient executor/allocator "
                         "faults, one mid-run 25%% pool shrink, request "
                         "cancellations and a lane stall, all replayed "
                         "identically per seed. After the run the CLI "
                         "leak-checks the allocator ledger and replays "
                         "the trace fault-free to prove every surviving "
                         "completion is token-identical")
    ap.add_argument("--deadline", type=int, default=0,
                    help="per-request deadline in ticks from arrival; "
                         "requests still unfinished are cancelled cleanly "
                         "(blocks freed, cause-tagged in the report). "
                         "0 = no deadline")
    ap.add_argument("--audit", default="off", choices=list(AUDIT_MODES),
                    help="paged only: every-tick allocator ledger audit. "
                         "'strict' fails the run on the first corrupt "
                         "tick, 'count' tallies violations into the "
                         "report, 'off' skips the sweep")
    ap.add_argument("--policy", default="continuous",
                    choices=["continuous", "static", "both"])
    ap.add_argument("--tokens-out", default="",
                    help="write the completions' tokens and, for every "
                         "token, the top logits of the step that emitted "
                         "it and their row's standard deviation (JSON: "
                         "{\"tokens\": {rid: tokens}, \"logits\": {rid: "
                         "[[ids, values, std], ...]}}) to this file (rank 0)")
    ap.add_argument("--replay", default="",
                    help="another run's --tokens-out file (the same "
                         "trace): emit its tokens in place of the argmax, "
                         "so that with --tokens-out the two runs' logits "
                         "meet at every token")
    ap.add_argument("--routes-out", default="",
                    help="MoE archs: write every MoE routing call's chosen "
                         "experts and kept choices, in call order, to this "
                         "file (torch.save; rank 0)")
    ap.add_argument("--replay-routes", default="",
                    help="MoE archs: another run's --routes-out file (a "
                         "run of the same schedule, e.g. under --replay of "
                         "its tokens): every MoE routing call takes that "
                         "call's experts and kept choices (its own are "
                         "still the ones --routes-out writes)")
    ap.add_argument("--forbid-plan-compiles", action="store_true",
                    help="fail if planning runs a measured step on the card "
                         "(CI guard; incompatible with --backend cuda)")
    args = ap.parse_args(argv)

    if args.forbid_plan_compiles and args.backend == "cuda":
        ap.error("--forbid-plan-compiles contradicts --backend cuda")
    if args.kv != "paged" and (args.compact or args.chunk_prefill):
        ap.error("--compact/--chunk-prefill need --kv paged (the ring "
                 "executor has no lane buckets or block tables)")
    if args.kv != "paged" and (args.admission != "worst"
                               or args.prefix_share):
        ap.error("--admission optimistic/--prefix-share need --kv paged "
                 "(the reservation ledger lives on the BlockAllocator)")
    if args.prefix_share and not args.prefix_len:
        ap.error("--prefix-share needs --prefix-len > 0 (there is no "
                 "shared prefix to share otherwise)")
    if args.prefill_budget < 0:
        ap.error("--prefill-budget must be >= 0")
    if args.prefill_budget and not (args.kv == "paged"
                                    and args.chunk_prefill):
        ap.error("--prefill-budget needs --kv paged and --chunk-prefill "
                 "(the budget schedules prompt chunks over block tables; "
                 "whole-prompt prefill is all-or-nothing)")
    if args.kv != "paged" and (args.kv_quant != "none" or args.kv_retain):
        ap.error("--kv-quant/--kv-retain need --kv paged (quantized "
                 "codes and retention both live on the block pool)")
    if args.kv_retain < 0:
        ap.error("--kv-retain must be >= 0")
    if args.kv != "paged" and args.chaos_seed is not None:
        ap.error("--chaos-seed needs --kv paged (pool shrinks and "
                 "allocation faults inject into the block ledger)")
    if args.kv != "paged" and args.audit != "off":
        ap.error("--audit needs --kv paged (the audit sweeps the "
                 "BlockAllocator ledger)")
    if args.deadline < 0:
        ap.error("--deadline must be >= 0")
    if args.model_parallel < 1:
        ap.error("--model-parallel must be >= 1")

    dev = require_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.depth:
        cfg = depth_variant(cfg, args.depth)
    backend = args.dist_backend or ("nccl" if dev.type == "cuda"
                                    else "gloo")
    live = dist.is_available() and dist.is_initialized()
    if not live:
        world = (int(os.environ["WORLD_SIZE"]) if LM.under_torchrun()
                 else args.model_parallel)
        if world > 1:
            if args.mesh == "":
                SCH.check_serving_mesh(cfg, XP.host_execution(
                    cfg, ShapeConfig("serve", DECODE, 1, 1), MemoryPlan(),
                    world, args.model_parallel).mesh_shape)
            return LM.spawn_ranks(LM.cli_rank, world, backend, dev.type,
                                  args=(main, argv))[0]
    world = dist.get_world_size() if live else 1
    if live and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    trace = synthetic_trace(args.requests, vocab_size=cfg.vocab_size,
                            seed=args.seed, prompt_lens=args.prompt_lens,
                            gen_lens=args.gen_lens,
                            mean_interarrival=args.arrival_mean,
                            prefix_len=args.prefix_len,
                            slo_classes=args.slo)
    context = args.context or trace_context(trace)
    n_devices = world
    shape = ShapeConfig("serve_trace", DECODE, context,
                        max(args.max_slots, 1))
    budget = (args.hbm_budget_gb * 2**30) if args.hbm_budget_gb else None

    # -- plan: mesh + kv sharding + admission bound -------------------------
    # The measurement guard is scoped to planning only (restored after), so
    # a later call in the same process can still measure legitimately.
    guard = None
    if args.forbid_plan_compiles:
        def _forbidden(*a, **k):
            raise AssertionError(
                "measured step on the card during serve planning "
                "(--forbid-plan-compiles)")
        guard = MM.CudaMeasurer._measure
        MM.CudaMeasurer._measure = _forbidden
    kv_blocks = ((args.kv_block,) if args.kv_block
                 else tuple(b for b in XP.DEFAULT_KV_BLOCKS if b <= context)
                 or (context,))
    paged_kw = {}
    if args.kv == "paged":
        # the planner maximizes EXPECTED admitted concurrency under the
        # trace's own length distribution (written positions per request)
        # the pool is always sized expected-case (plan_serving default);
        # optimistic admission additionally reserves a sigma-k margin, so
        # the planner carries the same margin into the pool size
        paged_kw = dict(kv="paged", kv_blocks=kv_blocks,
                        seq_lens=[len(r.prompt) + r.max_new - 1
                                  for r in trace],
                        compact=args.compact,
                        sigma_k=(args.sigma_k
                                 if args.admission == "optimistic" else 0.0),
                        kv_quants=(args.kv_quant,),
                        kv_retains=(args.kv_retain,),
                        min_agreement=args.min_agreement,
                        prefill_budget=args.prefill_budget,
                        prefill_kernel=args.prefill_kernel,
                        chunk=args.chunk_prefill)
    measurer = None
    mesh = None
    try:
        if args.mesh == "auto":
            if args.backend == "cuda":
                measurer = MM.CudaMeasurer({"data": n_devices}, device=dev)
            cls, splan = XP.plan_serving(cfg, shape, n_devices=n_devices,
                                         hbm_budget=budget,
                                         measurer=measurer, hw=HW.H100,
                                         **paged_kw)
        else:
            host = XP.host_execution(cfg, shape, MemoryPlan(),
                                     n_devices, args.model_parallel)
            SCH.check_serving_mesh(cfg, host.mesh_shape)
            if n_devices > 1:
                mesh = LM.build_mesh(host.mesh_shape)
            if args.backend == "cuda":
                measurer = MM.CudaMeasurer(
                    host.mesh_shape, device=dev,
                    group=mesh.groups["model"] if mesh else None)
            else:
                measurer = MM.SimulatedMeasurer(host.mesh_shape)
            pinned = SP.serving_space(
                cfg, shape, max_devices=n_devices,
                data=(host.mesh_shape.get("data", 1),),
                model=(host.mesh_shape.get("model", 1),),
                kv_blocks=kv_blocks if args.kv == "paged" else (0,),
                kv_quants=((args.kv_quant,) if args.kv == "paged"
                           else ("none",)),
                kv_retains=((args.kv_retain,) if args.kv == "paged"
                            else (0,)),
                # the engine splits its cache over kv heads on a model axis
                kv_shards=(("heads",) if host.mesh_shape.get("model", 1) > 1
                           else ("heads", "seq")))
            cls, splan = XP.plan_serving(cfg, shape, n_devices=n_devices,
                                         hbm_budget=budget,
                                         measurer=measurer, space=pinned,
                                         hw=HW.H100, **paged_kw)
    finally:
        if guard is not None:
            MM.CudaMeasurer._measure = guard
        if isinstance(measurer, MM.CudaMeasurer):
            # free the measured steps' params before the engine's own
            measurer.release()
    print(f"WSMC[serving/{args.backend}]: {cls.category.value} -> "
          f"{splan.describe()}")
    print("trace:", describe_trace(trace))
    mesh_shape = splan.execution.mesh_shape
    SCH.check_serving_mesh(cfg, mesh_shape, splan.execution.plan.kv_shard)
    if n_devices > 1 and mesh is None:
        n = 1
        for v in mesh_shape.values():
            n *= int(v)
        if n != n_devices:
            raise ValueError(f"the plan's mesh {mesh_shape} uses {n} of "
                             f"the {n_devices} ranks")
        mesh = LM.build_mesh(mesh_shape)

    n_slots = splan.slots(cap=min(args.max_slots, len(trace)))
    if n_slots < 1:
        print("no serving capacity under the budget; nothing admitted")
        return 1
    n_blocks = splan.pool_blocks(n_slots, context)
    if args.kv == "paged":
        print(f"pool: {n_slots} lanes, {n_blocks} blocks of "
              f"{splan.kv_block} positions (+1 scratch), context {context}")
    else:
        print(f"pool: {n_slots} slots, context {context}")

    # -- chaos plan ---------------------------------------------------------
    chaos = args.chaos_seed is not None
    plan = None
    if chaos:
        # place shrinks inside the run: rough tick horizon = arrival span
        # plus serial work over the lane count
        work = sum(len(r.prompt) + r.max_new for r in trace)
        horizon = max(64, max(r.arrival for r in trace)
                      + work // max(n_slots, 1))
        plan = FaultPlan.generate(args.chaos_seed, ticks=horizon,
                                  n_requests=len(trace), n_lanes=n_slots,
                                  n_cancels=max(1, len(trace) // 8),
                                  n_stalls=1)
        print("chaos:", plan.describe())

    # -- serve --------------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    specs = None
    if mesh is not None:
        # this rank's shards of the one-rank params: the same draws, each
        # leaf cut as it is drawn, under the plan's strategy (its EP mode
        # as the planner resolved it)
        specs = S.param_specs(cfg, init_params(None, cfg, device="meta"),
                              splan.execution.strategy(), mesh)
        params = S.init_local_params(gen, cfg, dev, specs, mesh)
    else:
        params = init_params(gen, cfg, device=dev)
    group = mesh.groups["model"] if mesh is not None else None
    draw_peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        # the peak since the process started: planning's and the draws'
        draw_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tape = None
    if args.routes_out or args.replay_routes:
        if not cfg.is_moe:
            ap.error("--routes-out/--replay-routes need a MoE arch")
        tape = MOE.RouteTape(torch.load(args.replay_routes)
                             if args.replay_routes else None)
    policies = (["continuous", "static"] if args.policy == "both"
                else [args.policy])
    reports = []
    failures = []
    force = replay_force(trace, args.replay) if args.replay else None
    log = None
    for policy in policies:
        if args.tokens_out or args.replay:
            log = TokenLog(force=force)
        chunk = 0
        if args.kv == "paged":
            if args.chunk_prefill:       # align up to the block size
                chunk = -(-args.chunk_prefill // splan.kv_block) \
                    * splan.kv_block
            elif args.prefix_share:      # suffixes ride the chunked path
                chunk = splan.kv_block
            executor = PagedTorchExecutor(
                params, cfg, n_lanes=n_slots, n_blocks=n_blocks,
                kv_block=splan.kv_block, context=context,
                compact=args.compact, chunk=chunk,
                kv_quant=args.kv_quant, kv_retain=args.kv_retain,
                device=dev, mesh=mesh, log=log)
            reservation = ("expected"
                           if args.admission == "optimistic"
                           else "worst")
            if chaos:
                allocator = ChaosAllocator(n_blocks, splan.kv_block,
                                           reservation, plan=plan)
            else:
                allocator = BlockAllocator(n_blocks, splan.kv_block,
                                           reservation=reservation)
        else:
            executor = TorchExecutor(params, cfg, n_slots=n_slots,
                                     context=context, device=dev, mesh=mesh,
                                     log=log)
            allocator = None

        def mk_stats():
            # EW-updated online stats: reservations track the live
            # length distribution, and the report carries observed
            # sigma_k per prompt bucket
            if args.admission != "optimistic":
                return None
            return OnlineLengthStats(base=length_stats(trace))
        run_exec = ChaosExecutor(executor, plan) if chaos else executor
        engine = Engine(run_exec, n_slots, policy=policy,
                        allocator=allocator, chunk_prefill=chunk,
                        prefill_budget=args.prefill_budget,
                        prefix_share=args.prefix_share,
                        stats=mk_stats(), sigma_k=args.sigma_k,
                        kv_retain=(args.kv_retain
                                   if args.kv == "paged" else 0),
                        deadline=args.deadline, faults=plan,
                        ladder=(LadderConfig() if chaos else None),
                        audit=args.audit)
        t0 = time.time()
        with (MOE.routing(tape) if tape is not None
              else contextlib.nullcontext()):
            report = engine.run(trace)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        lp = report.latency_percentiles()
        tp = report.ttft_percentiles()
        print(report.describe() + f" wall={dt:.2f}s "
              f"compiles={executor.compile_counts()}")
        if lp and tp:  # both empty when nothing completed
            print(f"  latency p50/p95/p99={lp['p50']:.0f}/"
                  f"{lp['p95']:.0f}/{lp['p99']:.0f} ticks "
                  f"ttft p50/p95/p99={tp['p50']:.0f}/{tp['p95']:.0f}/"
                  f"{tp['p99']:.0f} mean_ttft={report.mean_ttft():.1f} "
                  f"evictions={report.evictions}")
        if args.measure_agreement:
            from repro_torch.serving.quality import token_agreement
            with comm.model_axis(group):
                agree = token_agreement(params, cfg, trace, report,
                                        context=context, device=dev)
            print(f"  {agree.describe()}")
        if chaos:
            # prove the harness didn't corrupt anything: the drained
            # ledger must be whole, and every request the chaos run
            # completed must be token-identical to a fault-free
            # replay (same executor, reset pool, clean allocator)
            problems = leak_check(allocator)
            executor.reset()
            clean = Engine(
                executor, n_slots, policy=policy,
                allocator=BlockAllocator(n_blocks, splan.kv_block,
                                         reservation=reservation),
                chunk_prefill=chunk,
                prefill_budget=args.prefill_budget,
                prefix_share=args.prefix_share,
                stats=mk_stats(), sigma_k=args.sigma_k,
                kv_retain=(args.kv_retain
                           if args.kv == "paged" else 0)).run(trace)
            problems += survivor_mismatches(report, clean)
            if problems:
                for p in problems:
                    print(f"  CHAOS FAILURE: {p}")
                failures.extend(problems)
            else:
                print(f"  chaos: ledger clean, "
                      f"{len(report.completions)} survivors "
                      f"token-identical to fault-free replay")
        reports.append(report)

    res, tra = predicted_bytes(
        cfg, shape, splan, cls, n_slots, n_blocks,
        paged_kw.get("seq_lens", ()), args.compact, args.chunk_prefill)
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"memory: torch.cuda.max_memory_allocated() {peak} B; "
              f"predicted resident {res:.0f} B + transient {tra:.0f} B = "
              f"{res + tra:.0f} B; measured / predicted "
              f"{peak / (res + tra):.4f}")
    digest = tokens_digest(reports)
    print(f"tokens digest {digest}")
    if mesh is None and hasattr(executor, "schedule_digest"):
        print(f"schedule digest {executor.schedule_digest}")
    if args.tokens_out and (mesh is None or mesh.rank == 0):
        tokens, records = token_records(trace, reports, log)
        with open(args.tokens_out, "w") as f:
            json.dump({"tokens": tokens, "logits": records}, f)
    if args.routes_out and (mesh is None or mesh.rank == 0):
        torch.save(tape.calls, args.routes_out)
    plan_line = f"{cls.category.value} -> {splan.describe()}"
    planning = (_planning_peaks(cfg, measurer, splan.execution.mesh_shape)
                if isinstance(measurer, MM.CudaMeasurer) else [])
    if mesh is not None and _report_ranks(
            cfg, mesh, specs, params, executor, splan, shape, n_slots,
            n_blocks, res + tra, dev, digest, plan_line, planning,
            draw_peak):
        return 1
    if args.policy == "both" and len(reports) == 2:
        cont, stat = reports
        print(f"occupancy: continuous={cont.occupancy():.3f} vs "
              f"static={stat.occupancy():.3f} "
              f"(+{(cont.occupancy() - stat.occupancy()) * 100:.1f} pts)")
    if failures:
        print(f"ERROR: {len(failures)} chaos check(s) failed")
        return 1
    if chaos or args.deadline:
        # faults and deadlines may legitimately cancel requests; every
        # request must still be ACCOUNTED for — completed or cause-tagged
        done = min(len(r.completions) + len(r.cancellations)
                   for r in reports)
        if done != len(trace):
            print(f"ERROR: {done}/{len(trace)} requests accounted for")
            return 1
        return 0
    completed = min(len(r.completions) for r in reports)
    if completed != len(trace):
        print(f"ERROR: {completed}/{len(trace)} requests completed")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
