#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases 1,2    # build + kernel checks only
    python3 chip_smoke.py --phases 1,8    # build + the training path only
    python3 chip_smoke.py --phases 1,9    # build + gemma3-12b ring/slot only
    python3 chip_smoke.py --phases 1,10   # build + recurrentgemma-9b only
    python3 chip_smoke.py --phases 1,11   # build + the serving CLI only
    python3 chip_smoke.py --phases 1,12   # build + the training CLI only
    python3 chip_smoke.py --phases 1,13   # build + MoE and prefix embeds only
    python3 chip_smoke.py --phases 1,14   # build + the parallel layer only
    python3 chip_smoke.py --phases 1,14 --par-runs "0 m1 d2,d"
                                          # build + phase 14's model:2 run
    python3 chip_smoke.py --phases 1,15   # build + the dry-run, roofline,
                                          # hillclimb and reports only
    python3 chip_smoke.py --phases 1,16   # build + serving on a model axis
    python3 chip_smoke.py --phases 1,16 --tp-runs f
                                          # build + phase 16's run (f)

Phases, each of which fails the run (non-zero exit) if it fails:
  1. device: the card's name and power limit, its properties beside the
     constants the capacity model uses; build the six CUDA kernel sources
     from src/repro_torch/kernels/csrc/, one nvcc each, all started
     together.
  2. each kernel's wrapper against its plain PyTorch version on the card, at
     serving shapes and at odd ones: bf16 / int8 / int4 / f32 pools for the
     paged kernels, block sizes 4 to 128, unassigned table entries, inert
     lanes, the decode's block mass at every block size and codec, the
     prefill's tensor-core body for every codec at head_dim 80, 128 and
     256 (each prefill case prints the attend body its C entry point
     reports and fails unless bf16 queries over a bf16 / int8 / int4 pool
     ran the tensor cores and f32 the CUDA cores); f32 / bf16, causal /
     window / chunk, G = 1, 2, 4,
     lengths no tile divides and padded rows for flash attention (lse too;
     head_dim 80 and h2o-danube-1.8b's training shape among them);
     for the flash backward (dq, dk, dv) f32 / bf16, causal / window /
     chunk, G = 1, 2, 4, head_dim 16 to 256 (80 among them), lengths no
     tile divides, padded rows, rows that see nothing, h2o-danube-1.8b's
     training shape [4, 2048, 32, 80], and an autograd round trip through
     ops.flash_attention_trainable against autograd through the plain
     forward; both flash kernels also at the tensor-core body's tile
     edges (s = 127, 129, 1025 at head_dim 80, G = 12), at every padded
     head width of the tensor-core bodies (head_dim 40, 96, 112, 160, 224
     besides the path's), and at the serving paths' head layouts (gemma3-12b's local prefill [1, 2048, 16, 256]
     window 1024, recurrentgemma-9b's [1, 3000, 16, 256] window 2048);
     every flash case prints the body its C entry point reports and fails
     unless bf16 ran the tensor-core body and f32 the CUDA-core one; for the mLSTM scan the reference sweep (dk != dv too), with
     and without a carried state, fresh rows, padded steps, padding-only
     rows, f32 / bf16 and xlstm-1.3b's serving shape [32, 256, 1024], and
     the two-pass design's edges (dv not a multiple of its 32-column state
     tile, dk not a multiple of its 128-row update pass, one folded head,
     chunks of 96); for ring decode f32 / bf16, no mask / window / chunk,
     G = 1, 2, 4, 12, 16 (query-row groups of 1, 2, 4), head_dim 64, 80,
     128, 256, every split count from 1 to the kernel's cap, rings wrapped
     at heterogeneous positions, inert lanes and empty rings (exact zeros),
     lengths no tile or warp group divides and the ring shapes of phases
     6, 9, 10 and 13; flash and ring decode also at llama4-scout's (G 5)
     and internvl2-26b's (G 6) heads; every kernel a model axis runs at
     its ranks' head counts (phases 14 and 16).
  3. the main path at full width: mistral-nemo-12b, all 40 layers, random
     bf16 weights from a seed; the capacity model sizes the KV block pool;
     the engine serves a seeded trace of short and long prompts through
     PagedTorchExecutor (whole-prompt prefill for prompts up to the chunk,
     chunked prefill above it, compacted decode, strict allocator audit),
     with a bf16 pool and again with an int8 pool. Launch counters are
     zeroed just before and read just after.
  4. the same trace at 4 layers with the kernels and with the plain
     versions: token streams equal, or the first divergence judged.
  5. predicted resident + transient bytes of phase 3's plan beside
     torch.cuda.max_memory_allocated() (printed, not asserted).
  6. a fixed subset of the trace through greedy_generate at full width and
     depth (whole-prompt prefill into ring caches through the flash kernel,
     then ring decode through the ring decode kernel: 40 launches a decode
     step), held against phase 3's bf16-pool streams, the first
     divergence judged; then the int8 pool's token agreement with
     serving.quality.token_agreement (printed, not asserted).
  7. the recurrent path at full width and depth: xlstm-1.3b, all 48 layers
     (42 mLSTM + 6 sLSTM), random weights from a seed; mLSTM and sLSTM
     state in per-lane pool leaves (nothing paged); the engine serves 12
     requests on 8 lanes (whole-prompt and chunked prefill, compacted
     decode, strict audit); mLSTM scan launches = 42 x prefill calls, none
     in decode ticks; predicted memory (lane-state term apart) beside
     torch.cuda.max_memory_allocated(); a subset replayed through
     greedy_generate, divergences judged by the rms logit difference; the
     trace at 8 layers with the kernel and with the plain scan, judged as
     in phase 4; per-block host times and the lane gather / scatter.
  8. the training path at full width and depth: h2o-danube-1.8b, all 24
     layers, random bf16 weights from a seed, batches of [4, 2048] tokens
     from the port's TokenPipeline through run_train_loop: 6 steps of
     adamw_f32 without remat on the single schedule, then 2 steps each of
     remat "full", remat "dots", 2 microbatches (the scan schedule) and
     adafactor; loss and grad_norm finite, flash forward / backward
     launches exactly 24 x steps x microbatches (the forward twice under
     remat), nothing else launched; per plan
     torch.cuda.max_memory_allocated() beside the
     capacity model's resident and transient terms (printed, not
     asserted); at 2 layers, one step's loss and gradients through the
     kernels against those through the plain dense attention (loss
     within 1e-4 of itself, each gradient leaf within 5e-2).
  9. ring/slot serving at full width and depth: gemma3-12b, all 48 layers
     (40 local with window 1024, 8 global), random bf16 weights from a
     seed, context 4096, 8 lanes; a seeded trace of 16 requests (prompts
     64-2048, 16-32 new tokens) served (a) by the slot engine and
     TorchExecutor (every layer a ring: ring decode launches = 48 x decode
     ticks, flash = 48 x prefill calls) and (b) by the compacted chunked
     paged engine (the 8 global layers page through kernels 1 and 2, the
     40 local rings take ring decode and the plain ring chunk append;
     strict audit); launch counters zeroed just before and read just
     after, counts asserted exactly; torch.cuda.max_memory_allocated()
     beside the capacity model's prediction for both plans; the lane
     copies of a compacted step timed; the trace again at 6 layers (one
     unit) through the kernels and the plain versions on both engines,
     judged as in phase 4.
 10. the same for recurrentgemma-9b, all 38 blocks (26 RG-LRU, 12 local
     attention with window 2048 and one kv head), context 4096 (the
     attention layers are rings, nothing pages), 12 requests with prompts
     64-3000 (rings wrap during prefill and at decode): ring decode
     launches = 12 x decode ticks on both engines; RG-LRU state in
     per-lane leaves; kernels against plain versions at one unit plus the
     tail.
 11. the serving CLI (repro_torch.launch.serve) in process through its
     main(argv), after the earlier phases' tensors are freed, each run
     failing the phase on a non-zero return: (a) mistral-nemo-12b at full
     width and depth, --kv paged --compact --chunk-prefill 256 --mesh auto
     with no --kv-block, phase 3's trace (16 requests, 8 lanes), strict
     audit: plan_serving classifies the workload on the simulator's ladder
     and, with the H100's 80 GB, chooses the block size and the pool;
     every request completes, paged decode, paged prefill and flash
     attention each launch, nothing else; the chosen class beside phase
     3's hand-fixed Medium; torch.cuda.max_memory_allocated() beside the
     plan's predicted bytes (printed, not asserted); (b) the same
     configuration with --backend cuda: the workload classified from
     steps measured on the card (CudaMeasurer over the ladder), its class,
     alpha and inc beside (a)'s (printed, not asserted); (c) gemma3-12b
     through the ring path (TorchExecutor), 8 requests: ring decode and
     flash attention launch, the paged kernels do not.
 12. the training CLI (repro_torch.launch.train) in process through its
     main(argv): h2o-danube-1.8b at full width and depth, [4, 2048], 4
     steps, planned by the WSMC online phase under HW.H100, once with
     --backend simulate and once with --backend cuda (the class from a
     two-point ladder, seq 64 and 128, of train steps measured on the
     card); each run's class, plan, predicted and measured peak and
     flash launches (forward and backward, planning steps included, both
     > 0); fails on a non-zero return or a measured peak above the card's
     memory.
 13. MoE and prefix embeddings at full width: (a) mixtral-8x7b at 8 of
     its 32 layers (depth the one cut; 23 GB of bf16 weights) through the
     compacted chunked paged engine as in phase 3 (8 lanes, blocks of 16,
     chunks of 256, a bf16 pool, 16 seeded requests with prompts of
     64-2048, strict audit), launches counted exactly; four requests
     replayed through greedy_generate with the engine's MoE routes (each
     token's experts and the choices that found a capacity slot: the
     engine routes a decode tick's whole lane batch and a chunk's pad
     rows too, fault F13), each divergence printed with both logit gaps,
     the rms logit difference up to it held under REL_BOUND;
     (b) llama4-scout-17b-a16e at 2 of its 12 unit repeats (8 layers)
     through greedy_generate, 4 seeded prompts of 64-512 tokens, 32 new
     tokens each (flash and ring decode launches counted exactly); (c)
     internvl2-26b at full depth: prefill_step over 1024 seeded bf16
     prefix embeddings and a 200-token prompt, then 32 decode steps at
     positions 1224 + t. (b) and (c) are held against the same steps
     through the plain attention and ring decode, the plain run taking
     the kernel run's MoE routes (REL_BOUND).
 14. the parallel layer on the card: the training CLI in subprocesses,
     h2o-danube-1.8b at full width, [4, 2048], 3 steps, seed 0,
     --optimizer adamw_f32, ranks sharing the card over gloo (every
     collective staged through the host), the runs of a wave (PAR_WAVES)
     beside each other: (0) one rank at 4 and 2 microbatches at full
     depth (24 layers), and at 1 and 2 at PAR_CUT (2) layers, the losses
     and gradient norms to match; (a) --mesh pipe:2, 4 microbatches (the
     1F1B pipeline, 2 ranks); (b) --mesh data:2, 1 microbatch, PAR_CUT
     layers (FSDP, 2 ranks), saving a checkpoint at its last step,
     restored onto one device (each rank's slices of it the state the
     rank held), onto data:2,pipe:2 (4 ranks) and onto model:2 (2 ranks),
     each rank's leaves bit for bit the slices of the one-device restore;
     (c) --mesh data:2,pipe:2, 2 microbatches, PAR_CUT layers (4 ranks);
     (d) --mesh model:2, 1 microbatch, PAR_CUT layers (tensor
     parallelism, 2 ranks), saving a checkpoint restored onto one device
     and onto data:2 as (b)'s; (e) --mesh data:2,model:2, PAR_CUT layers (FSDP over data
     and tensor parallelism over model, 4 ranks); (f) --mesh model:2
     --backend cuda, PAR_CUT layers: the online phase classifies and plans
     (remat, microbatches) from train steps CudaMeasurer measures over the
     model group, every rank's class and plan one; (g) mixtral-8x7b at
     full width and MX_TRAIN_DEPTH (2) of its 32 layers, [2, 2048],
     Adafactor, --mesh model:2 --backend cuda under the expert
     parallelism its plan resolves (4 experts a rank), writing its MoE
     routes and a checkpoint (restored onto one device and onto model:2
     under tensor parallelism inside the experts), against one rank
     replaying its routes (g one), its kept choices against the global
     capacity rule exactly, a free one rank's route partings counted
     (g free); (h) mixtral-8x7b at PAR_H_DEPTH (1) layer on model:2 under
     tensor parallelism inside the experts, by rank functions beside (g)'s
     wave, against one rank in this process taking its routes; then
     compressed_psum over a data:2 world on CUDA tensors the size of the
     largest leaf, within 1.5 x scale. Each run is judged once its
     one-rank run has ended. Fails on a
     rank's non-zero exit, step 1's loss more than 1e-4 or its gradient
     norm (a MoE arch's routers' norm too) more than 1e-3 relative from
     the one-rank run's at the same depth and microbatches (later steps'
     losses 1e-3), per-rank
     parameter elements other than the spec tree's (pipe:2:
     predictor.sharded_param_count exactly), flash launches per rank other
     than stage layers x microbatches x steps (forward twice under the
     pipeline's recompute or a remat), on a model axis the leaves a rank
     holds whole (the norms) or the MoE routes other than bit-identical
     on a model group's ranks after the last step, or ranks planning
     apart; prints each
     rank's max_memory_allocated against the predictor's figure, the step
     wall and the bytes staged a step, by kind.
 15. the dry-run, the roofline, the hillclimb and the reports, through
     their CLIs' main(argv) in process: (a) the simulate sweep, every arch
     x shape on the 16x16 and 2x16x16 meshes (no cell may fail); (b) four
     cells one card holds (h2o-danube-1.8b, xlstm-1.3b, recurrentgemma-9b
     at long_500k; recurrentgemma-9b at decode_32k), each planned at
     --max-devices 1 by the simulator and confirmed under the plan budget,
     then `--backend cuda --mesh auto --max-devices 1`: one full-width,
     full-depth decode step measured on the card by CudaMeasurer (the
     allocator's peak beside the capacity model's and the simulator's
     figures) and its roofline counted on the meta device at depth 1 and
     2 under HW.H100; each cell ok, with a roofline, and the ring decode
     kernel launched once per attention layer (none on xlstm-1.3b); (c)
     the hillclimb on h2o-danube-1.8b x train_4k: baseline, remat_dots,
     remat_full counted (the model's FLOPs at most the counted ones, remat
     full above the baseline), onehot_embed refused for want of a
     counterpart; then a --memory baseline on (b)'s first cell; (d)
     summarize and report_experiments over (b)'s cells.
 16. serving on a model axis: the serve CLI in subprocesses on
     --model-parallel M, its ranks sharing the card over gloo (every
     collective staged through the host), the runs of a wave (TP_WAVES)
     at once: (a) mistral-nemo-12b at full width and TP_CUT (10) of its
     40 layers on model:2, paged, --compact, --chunk-prefill 256, blocks
     of 16, a bf16 pool, simulate planning, 8 requests of 64-1024 prompt
     and 16-32 generated tokens; (b) the same at full depth with an int8
     pool and --kv-retain 2 (the attention mass summed over the ranks); (c)
     --backend cuda at TP_CUT layers on 2 requests: CudaMeasurer over the
     model axis, every rank's class and plan one, the measured per-rank
     peak of each planning step beside the simulator's; (d) 8 of
     mistral-nemo-12b's layers on model:4, 4 requests; (e) gemma3-12b at
     12 layers on model:2 through the slot engine (ring decode on the
     local and global rings, flash prefill); (f) mixtral-8x7b at full
     width and TP_MOE_DEPTH (8) of its 32 layers on model:2 under expert
     parallelism (each rank 4 of its 8 experts), paged as (a), its ranks'
     MoE routes written (--routes-out); (g) mixtral-8x7b at TP_EXPERTS_DEPTH
     (2) layers on model:2 under tensor parallelism inside the experts
     (Strategy(ep=False), which no CLI switch selects): rank functions
     that launch.mesh.spawn_ranks starts serve one request (a 300-token
     prompt in chunks and 5 decode steps) through the paged engine. Each run
     writes, for every token, the top 8 logits of the step that emitted
     it (--tokens-out); then one rank of the same CLI and trace, in
     process, replays the ranks' tokens (--replay) and logs its own; the
     one-rank replays of (f) and (g) also take the ranks' MoE routes
     (--replay-routes), so that the comparison judges the sharded expert
     products; the ranks' kept choices must be those the capacity of the
     global expert count keeps of their experts, exactly; where the one
     rank's own router would have chosen otherwise on that replay, and a
     free replay of (f) (its own routes), are counted, not judged. Fails
     on a rank's non-zero
     exit, ranks emitting, scheduling or planning apart, one rank
     scheduling other block tables (retention's drops) under the same
     tokens, the two sides' top logits more than TP_DRIFT_BOUND of the
     spread apart at any token or lacking each other's argmax (where the
     argmaxes differ, trap T2, both gaps are printed), per-rank parameter
     elements other than the spec tree's, a pool other than the
     predictor's per-device blocks, or attention launches other than
     layers x steps a rank; prints each rank's peak against the plan's
     prediction, its peak while drawing its shards and the bytes it
     staged through the host by kind. Phase 2 holds the four kernels at
     the ranks' head counts (mixtral's under its window too), and the
     flash forward and backward at phase 14's.
  then: each kernel timed at the largest shape its path launched it at
  (the paged kernels also at every shape phase 3 launched them at, with
  the launches each shape had and the sum of launches x time)
  (the flash forward and backward also at phase 8's training shape, the
  forward also at phase 9's padded slot prefill [8, 2048, 16, 256] under
  window 1024; ring decode at phase 9's slot-mode global ring [8, 4096, 8,
  256]), beside its plain version, its bound and (flash attention, forward
  and backward; ring decode) the one PyTorch call that computes the same
  function; the flash rows also with their TFLOP/s and share of 989
  TFLOP/s; one JSON line `kernels`, where the launches of phases 12 to
  16 are added to the rows of their kernels (`launches_by_phase`).

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device the script exits non-zero and prints no result.
"""
import argparse
import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; this "
                     "script needs an NVIDIA GPU\n")
    sys.exit(1)

from repro_torch import hw as HW  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (DECODE, MLP_MOE, TRAIN,  # noqa: E402
                                      BlockSpec, ShapeConfig, depth_variant,
                                      param_count)
from repro_torch.core import classifier as CL, predictor as PR  # noqa: E402
from repro_torch.core import measure as MM  # noqa: E402
from repro_torch.core import profiler as PF  # noqa: E402
from repro_torch.kernels import (build, decode_attention,  # noqa: E402
                                 flash_attention, flash_attention_bwd,
                                 mlstm_scan, paged_decode, paged_prefill)
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import hillclimb as HC  # noqa: E402
from repro_torch.launch import report_experiments as REP  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.launch import summarize as SUM  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import ModelSettings, init_params  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402
from repro_torch.checkpoint import ckpt as CK  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.optim import optimizers as OPT  # noqa: E402
from repro_torch.optim.compress import compressed_psum  # noqa: E402
from repro_torch.parallel import comm as COMM  # noqa: E402
from repro_torch.parallel import sharding as SHD  # noqa: E402
from repro_torch.runtime import fault as FT  # noqa: E402
from repro_torch.runtime import schedule as SCH  # noqa: E402
from repro_torch.runtime import serve_step as SS  # noqa: E402
from repro_torch.runtime import train_step as TS  # noqa: E402
from repro_torch.search import execplan as XP  # noqa: E402
from repro_torch.search import strategies as ST  # noqa: E402
from repro_torch.serving import (BlockAllocator, Engine, leak_check,  # noqa: E402
                                 synthetic_trace, trace_context)
from repro_torch.serving import quality as Q  # noqa: E402
from repro_torch.serving.executor import (  # noqa: E402
    PagedTorchExecutor, TokenLog, TorchExecutor)
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

DEV = torch.device("cuda:0")
SEED = 0
KERNEL_MODULES = (paged_decode, paged_prefill, flash_attention,
                  flash_attention_bwd, mlstm_scan, decode_attention)

# Tolerances of kernel vs plain version on the card. Both sides compute in
# f32 from the same stored values (for a quantised pool the plain version is
# asked to dequantise rows to f32, as the kernel does in registers), so what
# is left is the order of f32 sums and, for bf16 queries, the output's one
# rounding to bf16 on each side.
TOL_F32 = 1e-4      # f32 pools and queries: two f32 summation orders over up
                    # to 4096 positions
TOL_BF16 = 1e-3     # bf16 output: where the two f32 results straddle a
                    # rounding boundary they land one bf16 unit apart, which
                    # is at most 2^-7 of the value (RTOL_BF16); the absolute
                    # term covers values near zero. At a context of 2000
                    # positions an output element is of the order of 0.03
                    # and a dropped 16-row block moves it by about 0.01.
RTOL_BF16 = 2.0 ** -7
TOL_MASS = 1e-4     # per-block softmax share in [0, 1], f32 on both sides
TOL_LSE = 1e-4      # flash lse: f32 on both sides from the same stored
                    # inputs, values of order 10 (rows that see nothing:
                    # -1e30 on both)
RTOL_ML = 1e-4      # mLSTM scan, f32 results: sums of up to 1024 products
                    # in two orders (about 1e-6 of the largest term each)
                    # and expf within 2 ULP, so 1e-4 of the value plus 1e-4
                    # of the folded head's largest value (results that
                    # cancel to near zero carry the terms' absolute error)
# Phase 4: a token divergence between kernel and plain runs is accepted only
# where the top-2 logit gap is below this fraction of that row's logit
# standard deviation on both sides. The two runs differ by bf16 roundings of
# the attention output carried through a bf16 residual stream: of the order
# of 1% of that deviation after 4 layers (10x margin). A decided argmax over
# 131072 random logits has a typical gap of 0.2 of it, so a kernel that
# attends to wrong rows diverges far above the bound.
GAP_BOUND = 0.1
# Phase 6: greedy_generate and the engine differ by more than kernels: ring
# decode at width 1 against paged decode at the engine's widths (other
# matrix-product shapes), whole-prompt against chunked prefill; bf16
# roundings of all of it carried through 40 layers and through the cached
# K/V of every earlier token. Its first divergences are judged by the
# logits themselves: at the step where the two split (same tokens so far),
# the rms of their difference over the rms spread of the greedy logits must
# stay below this. Drift of roundings is expected at a few per cent; a path
# that attends to wrong rows or positions leaves logits that agree only in
# what the token embedding and the MLPs carry, tens of per cent apart.
REL_BOUND = 0.1

# Flash backward (dq, dk, dv) against its plain version: both recompute p
# from the same stored inputs and lse in f32, in other orders; dk and dv sum
# over up to sq x G (query, head) rows. f32 results: within RTOL_BWD of
# (|value| + the tensor's largest |value|). bf16 results: each side rounds
# its f32 result once to bf16, so one bf16 unit apart where the two straddle
# a rounding boundary (RTOL_BF16 of the value), plus ATOL_BWD_BF16 of the
# tensor's largest |value| for values near zero.
RTOL_BWD = 1e-4
ATOL_BWD_BF16 = 1e-3
# The autograd round trip in bf16 differs by more than roundings of the
# results: the kernel path takes D = rowsum(dO * O) from the output rounded
# to bf16 (the flash algorithm, as the reference's), autograd through the
# plain forward differentiates the f32 softmax. Each output element carries
# up to 2^-9 of itself, summed over head_dim against dO: a few tenths of a
# per cent of the largest gradient at head_dim 80, so 2 % of the largest
# |value|.
ATOL_AUTOGRAD_BF16 = 2e-2

PEAK_BYTES_PER_S = HW.H100.hbm_bw            # 3.35e12
PEAK_BF16_FLOPS = HW.H100.peak_flops_bf16    # 989e12
# the mLSTM scan's arithmetic is f32 (as the reference package's): the
# card's f32 rate outside the tensor cores (NVIDIA's H100 SXM data sheet)
PEAK_F32_FLOPS = 67e12


def log(msg):
    print(msg, flush=True)


def error_lines(text, tail=60):
    """A failed run's standard error to log: every line that names an
    error (each rank's, the first to fail among them), then the last
    `tail` lines."""
    lines = text.splitlines()
    named = [ln for ln in lines[:-tail] if "Error" in ln or "error" in ln]
    return named + lines[-tail:]


def fail(msg):
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


def _zero_launches():
    for mod in KERNEL_MODULES:
        mod.launches = 0


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------

def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_device():
    smi = nvidia_smi_line()
    log(f"[1] nvidia-smi name, power.limit: {smi}")
    p = torch.cuda.get_device_properties(0)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{p.name}: {p.total_memory} bytes, {p.multi_processor_count} SMs, "
        f"sm_{p.major}{p.minor}")
    log(f"[1] capacity-model constants (hw.H100): hbm_bytes="
        f"{HW.H100.hbm_bytes} hbm_bw={HW.H100.hbm_bw:.3e} "
        f"peak_flops_bf16={HW.H100.peak_flops_bf16:.3e} "
        f"shared_memory_per_block={HW.H100.vmem_bytes}")
    t0 = time.time()
    paths = build.build_all()
    log(f"[1] built {len(paths)} kernel libraries in {time.time() - t0:.1f}s "
        f"with {build.find_nvcc()}")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if ("registers" in line or "error" in line.lower()
                    or "_tc_kernel" in line
                    or ("spill" in line and not re.search(
                        r"\b0 bytes spill stores, 0 bytes spill loads",
                        line))):
                log(f"[1]   {name}: {line.strip()}")
    for mod in KERNEL_MODULES:
        build.library(mod.SOURCE)
    return smi


# ---------------------------------------------------------------------------
# Kernel cases
# ---------------------------------------------------------------------------

_POOL_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
MN = dict(K=8, G=4, hd=128)      # mistral-nemo-12b's attention heads
GM = dict(K=8, G=2, hd=256)      # gemma3-12b's
RG = dict(K=1, G=16, hd=256)     # recurrentgemma-9b's (MQA)
SC = dict(K=8, G=5, hd=128)      # llama4-scout-17b-a16e's
VL = dict(K=8, G=6, hd=128)      # internvl2-26b's


def make_pool(gen, *, lens, K, hd, bs, m_blocks, codec, extra_blocks=3):
    """A filled pool on the card: lane i holds positions 0..lens[i]-1 in
    shuffled physical blocks (block 0 left as scratch), every payload row
    random (unused slots too: their position is -1). Returns (cache dict,
    tables [b, m_blocks] int32)."""
    b = len(lens)
    nb = [-(-n // bs) for n in lens]
    n_blocks = sum(nb) + extra_blocks + 1
    rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (1,),
                                                  generator=gen,
                                                  device=DEV).item()))
    ids = np.arange(1, n_blocks)
    rng.shuffle(ids)
    tables = np.full((b, m_blocks), -1, np.int32)
    pos = np.full((n_blocks, bs), -1, np.int32)
    nxt = 0
    for i, n in enumerate(lens):
        mine = ids[nxt:nxt + nb[i]]
        nxt += nb[i]
        tables[i, :nb[i]] = mine
        p = np.arange(nb[i] * bs).reshape(nb[i], bs)
        pos[mine] = np.where(p < n, p, -1)
    k = torch.randn((n_blocks, bs, K, hd), generator=gen, device=DEV)
    v = torch.randn((n_blocks, bs, K, hd), generator=gen, device=DEV)
    cache = {"pos": torch.from_numpy(pos).to(DEV)}
    if codec in _POOL_DT:
        cache["kb"], cache["vb"] = (k.to(_POOL_DT[codec]),
                                    v.to(_POOL_DT[codec]))
    else:
        cache["kb"], cache["ks"] = A.quantize_kv(k, codec)
        cache["vb"], cache["vs"] = A.quantize_kv(v, codec)
    return cache, torch.from_numpy(tables).to(DEV)


def clone_cache(cache):
    return {n: t.clone() for n, t in cache.items()}


def scales_of(cache):
    return cache.get("ks"), cache.get("vs")


def check_close(name, got, want, tol):
    """|got - want| <= tol + rtol * |want| elementwise (rtol only for the
    bf16 tolerance); returns the largest absolute error."""
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: kernel output not finite")
    diff = (got.float() - want.float()).abs()
    rtol = RTOL_BF16 if tol == TOL_BF16 else 0.0
    over = diff - (tol + rtol * want.float().abs())
    if not float(over.max()) <= 0.0:
        fail(f"{name}: max abs err {float(diff.max()):.3e} exceeds "
             f"{tol:.1e} + {rtol:.1e} * |value| by {float(over.max()):.3e}")
    return float(diff.max())


def decode_case(gen, name, *, lens, K, G, hd, bs, codec, qdt=torch.bfloat16,
                window=None, chunk=None, mass=False, m_blocks=None,
                inert=(), holes=()):
    """Kernel 1 against its plain version. `inert` lanes get position -1
    and an empty table; `holes` are (lane, logical block) entries set to
    -1 (a block the retention policy dropped)."""
    b = len(lens)
    mb = m_blocks or max(-(-max(lens) // bs), 1)
    cache, tables = make_pool(gen, lens=lens, K=K, hd=hd, bs=bs, m_blocks=mb,
                              codec=codec)
    positions = torch.tensor([n - 1 for n in lens], dtype=torch.int32,
                             device=DEV)
    for i in inert:
        positions[i] = -1
        tables[i, :] = -1
    for i, j in holes:
        tables[i, j] = -1
    q = torch.randn((b, K, G, hd), generator=gen, device=DEV).to(qdt)
    ks, vs = scales_of(cache)
    kw = dict(window=window, chunk=chunk, k_scales=ks, v_scales=vs,
              return_mass=mass)
    got = paged_decode.paged_decode_attention(
        q, cache["kb"], cache["vb"], cache["pos"], tables, positions, **kw)
    torch.cuda.synchronize()
    want = paged_decode.paged_decode_attention_plain(
        q, cache["kb"], cache["vb"], cache["pos"], tables, positions,
        dequant_dtype=torch.float32, **kw)
    tol = TOL_F32 if (qdt == torch.float32 and codec == "f32") else TOL_BF16
    if mass:
        err = check_close(name, got[0], want[0], tol)
        check_close(name + " mass", got[1], want[1], TOL_MASS)
    else:
        err = check_close(name, got, want, tol)
    for i in inert:
        o = got[0] if mass else got
        if float(o[i].float().abs().max()) != 0.0:
            fail(f"{name}: inert lane {i} output not zero")
    return err


def prefill_case(gen, name, *, hist, clens, C, K, G, hd, bs, codec,
                 qdt=torch.bfloat16, window=None, chunk=None, m_blocks=None,
                 unmapped_tail=False, holes=()):
    """Kernel 2 against its plain version: lane i holds hist[i] positions
    and appends clens[i] <= C tokens (the rest of the chunk is padding).
    Outputs to tolerance; pool positions, payload / codes exact and scales
    within 1 ULP over the whole pool. `unmapped_tail` leaves the last
    logical block the chunk reaches unmapped: its rows must write nothing.
    `holes` are (lane, logical block) entries of the history set to -1 (a
    block the retention policy dropped). Every case reports the attend body
    its C entry point ran: the tensor cores for bf16 queries over a bf16 /
    int8 / int4 pool at a head width they take, else the CUDA cores."""
    b = len(hist)
    total = [h + c for h, c in zip(hist, clens)]
    mb = m_blocks or max(-(-max(total) // bs), 1)
    # allocate blocks for history + chunk, then invalidate what the chunk
    # will write (make_pool marks them written)
    cache, tables = make_pool(gen, lens=total, K=K, hd=hd, bs=bs,
                              m_blocks=mb, codec=codec)
    tb = tables.cpu().numpy()
    pos = cache["pos"].cpu().numpy()
    for i in range(b):
        for p in range(hist[i], total[i]):
            pos[tb[i, p // bs], p % bs] = -1
    cache["pos"] = torch.from_numpy(pos).to(DEV)
    if unmapped_tail:
        for i in range(b):
            tables[i, (total[i] - 1) // bs] = -1
    for i, j in holes:
        if (j + 1) * bs > hist[i]:
            fail(f"{name}: hole {j} of lane {i} reaches the chunk's rows")
        tables[i, j] = -1
    positions = np.full((b, C), -1, np.int32)
    for i in range(b):
        positions[i, :clens[i]] = hist[i] + np.arange(clens[i])
    positions = torch.from_numpy(positions).to(DEV)
    q = torch.randn((b, C, K, G, hd), generator=gen, device=DEV).to(qdt)
    kn = torch.randn((b, C, K, hd), generator=gen, device=DEV).to(qdt)
    vn = torch.randn((b, C, K, hd), generator=gen, device=DEV).to(qdt)
    ca, cb = clone_cache(cache), clone_cache(cache)
    got = paged_prefill.paged_prefill_attention(
        q, kn, vn, ca["kb"], ca["vb"], ca["pos"], tables, positions,
        window=window, chunk=chunk, k_scales=ca.get("ks"),
        v_scales=ca.get("vs"))
    torch.cuda.synchronize()
    tc = codec != "f32" and hd % 8 == 0 and hd <= 256
    body = check_body(name, paged_prefill, qdt if tc else torch.float32)
    want = paged_prefill.paged_prefill_attention_plain(
        q, kn, vn, cb["kb"], cb["vb"], cb["pos"], tables, positions,
        window=window, chunk=chunk, k_scales=cb.get("ks"),
        v_scales=cb.get("vs"), dequant_dtype=torch.float32)
    tol = TOL_F32 if (qdt == torch.float32 and codec == "f32") else TOL_BF16
    err = check_close(name, got, want, tol)
    for n in ("pos", "kb", "vb"):
        if not torch.equal(ca[n], cb[n]):
            bad = int((ca[n] != cb[n]).sum())
            fail(f"{name}: pool leaf {n} differs from the plain version's "
                 f"in {bad} elements")
    for n in ("ks", "vs"):
        if n in ca:
            ulp = (ca[n].view(torch.int32).long()
                   - cb[n].view(torch.int32).long()).abs().max()
            if int(ulp) > 1:
                fail(f"{name}: scale leaf {n} off by {int(ulp)} ULP")
    if unmapped_tail and not torch.equal(ca["pos"][0], cache["pos"][0]):
        fail(f"{name}: scratch block written")
    log(f"[2] {name}: {body} body, max abs err {err:.3e}")
    return err


def ring_positions(ends, L, empty=()):
    """[b, L] int32 on the card: lane i's ring holds positions up to
    ends[i] at slot pos % L (the latest L of them: ends[i] >= L has
    wrapped, so slot 0 is not its oldest position); `empty` lanes hold
    nothing."""
    e = np.asarray(ends, np.int64)[:, None]
    slots = np.arange(L)[None]
    pos = e - np.mod(e - slots, L)
    pos = np.where(pos >= 0, pos, -1)
    for i in empty:
        pos[i] = -1
    return torch.from_numpy(pos.astype(np.int32)).to(DEV)


def ring_case(gen, name, *, L, K, G, hd, ends, qdt=torch.bfloat16,
              kvdt=None, window=None, chunk=None, empty=(), inert=(),
              kv_block=512):
    """Kernel 6 (ring decode) against its plain version: lane i's ring of
    L slots (ring_positions) is queried at position ends[i]; `inert` lanes
    at -1. Inert lanes and empty rings must give exact zeros."""
    kvdt = kvdt or qdt
    b = len(ends)
    cpos = ring_positions(ends, L, empty)
    positions = torch.tensor(ends, dtype=torch.int32, device=DEV)
    for i in inert:
        positions[i] = -1
    q = torch.randn((b, K, G, hd), generator=gen, device=DEV).to(qdt)
    k = torch.randn((b, L, K, hd), generator=gen, device=DEV).to(kvdt)
    v = torch.randn((b, L, K, hd), generator=gen, device=DEV).to(kvdt)
    args = (q, k, v, cpos, positions)
    got = decode_attention.decode_attention_fwd(
        *args, window=window, chunk=chunk, kv_block=kv_block)
    torch.cuda.synchronize()
    want = decode_attention.decode_attention_plain(*args, window=window,
                                                   chunk=chunk)
    tol = (TOL_F32 if qdt == torch.float32 and kvdt == torch.float32
           else TOL_BF16)
    err = check_close(name, got, want, tol)
    for i in set(empty) | set(inert):
        if float(got[i].float().abs().max()) != 0.0:
            fail(f"{name}: lane {i} sees nothing but its output is not zero")
    return err


def check_body(name, mod, dt):
    """The body the C entry point of `mod` reported for its last launch:
    the tensor cores for bf16, the CUDA cores for f32."""
    want = "tensor-core bf16" if dt == torch.bfloat16 else "cuda-core f32"
    if mod.last_body != want:
        fail(f"{name}: the launch ran the {mod.last_body} body, want {want}")
    return mod.last_body


# (head_dim, length, G, window) of the padded head widths 48, 96, 112,
# 160 and 224 that no path runs: each has its own tile and occupancy
# settings in both flash kernels
PADDED_WIDTHS = ((40, 131, 3, None), (96, 197, 6, 64), (112, 263, 4, None),
                 (160, 141, 12, 100), (224, 77, 2, None))


def flash_case(gen, name, *, b, s, K, G, hd, qdt=torch.bfloat16,
               window=None, chunk=None, lens=None, start=0):
    """Kernel 3 against its plain version, out and lse. Row i holds
    lens[i] positions start.. and is padded with -1 to s (queries and
    keys); `start` > 0 puts positions away from the indices."""
    lens = lens or [s] * b
    pos = np.full((b, s), -1, np.int32)
    for i, n in enumerate(lens):
        pos[i, :n] = start + np.arange(n)
    pos = torch.from_numpy(pos).to(DEV)
    q = torch.randn((b, s, K * G, hd), generator=gen, device=DEV).to(qdt)
    k = torch.randn((b, s, K, hd), generator=gen, device=DEV).to(qdt)
    v = torch.randn((b, s, K, hd), generator=gen, device=DEV).to(qdt)
    got, lse = flash_attention.flash_attention_fwd(
        q, k, v, pos, pos, window=window, chunk=chunk, return_lse=True)
    torch.cuda.synchronize()
    body = check_body(name, flash_attention, qdt)
    want, lse_want = flash_attention.flash_attention_plain(
        q, k, v, pos, pos, window=window, chunk=chunk, return_lse=True)
    tol = TOL_F32 if qdt == torch.float32 else TOL_BF16
    err = check_close(name, got, want, tol)
    lerr = check_close(name + " lse", lse, lse_want, TOL_LSE)
    log(f"[2] {name}: {body} body, max abs err out {err:.3e}, lse "
        f"{lerr:.3e}")
    return err


def check_bwd(name, got, want, atol_bf16=ATOL_BWD_BF16):
    """A flash-backward result against the plain version's, with the
    tolerance of its dtype (RTOL_BWD; RTOL_BF16 and `atol_bf16`); returns
    the largest absolute error."""
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: kernel result not finite")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    top = float(w.abs().max())
    if got.dtype == torch.bfloat16:
        bound = RTOL_BF16 * w.abs() + atol_bf16 * top
    else:
        bound = RTOL_BWD * (w.abs() + top)
    over = diff - bound
    if not float(over.max()) <= 0.0:
        fail(f"{name}: max abs err {float(diff.max()):.3e} (largest |value| "
             f"{top:.3e}) exceeds the bound by {float(over.max()):.3e}")
    return float(diff.max())


def flash_bwd_case(gen, name, *, b, s, K, G, hd, qdt=torch.bfloat16,
                   window=None, chunk=None, lens=None, start=0, blind=0):
    """Kernel 6 against its plain version: dq, dk, dv from the forward
    kernel's out and lse and a random dO. Row i holds lens[i] positions
    start.. and is padded with -1 to s; `blind` > 0 sets the first `blind`
    keys of row 0 to position -1, so its first `blind` queries see nothing
    (lse -1e30): their dq must be exactly 0."""
    lens = lens or [s] * b
    pos = np.full((b, s), -1, np.int32)
    for i, n in enumerate(lens):
        pos[i, :n] = start + np.arange(n)
    qpos = torch.from_numpy(pos).to(DEV)
    kp = pos.copy()
    kp[0, :blind] = -1
    kpos = torch.from_numpy(kp).to(DEV)
    q = torch.randn((b, s, K * G, hd), generator=gen, device=DEV).to(qdt)
    k = torch.randn((b, s, K, hd), generator=gen, device=DEV).to(qdt)
    v = torch.randn((b, s, K, hd), generator=gen, device=DEV).to(qdt)
    do = torch.randn((b, s, K * G, hd), generator=gen, device=DEV).to(qdt)
    out, lse = flash_attention.flash_attention_fwd(
        q, k, v, qpos, kpos, window=window, chunk=chunk, return_lse=True)
    args = (q, k, v, out, lse, do, qpos, kpos)
    got = flash_attention_bwd.flash_attention_bwd(*args, window=window,
                                                  chunk=chunk)
    torch.cuda.synchronize()
    body = check_body(name, flash_attention_bwd, qdt)
    want = flash_attention_bwd.flash_attention_bwd_plain(
        *args, window=window, chunk=chunk)
    errs = [check_bwd(f"{name} {n}", a, w)
            for n, a, w in zip(("dq", "dk", "dv"), got, want)]
    log(f"[2] {name}: {body} body, max abs err dq {errs[0]:.3e} dk "
        f"{errs[1]:.3e} dv {errs[2]:.3e}")
    if blind:
        if float(lse[0, :blind].max()) > -1e29:
            fail(f"{name}: the blind rows saw something (lse "
                 f"{float(lse[0, :blind].max())})")
        if float(got[0][0, :blind].float().abs().max()) != 0.0:
            fail(f"{name}: a row that sees nothing has a non-zero dq")
    return errs


def flash_autograd_case(gen, name, *, b, s, K, G, hd, qdt, window=None):
    """One autograd round trip: gradients of sum(out * w) through
    ops.flash_attention_trainable (forward and backward kernels) against
    autograd through the plain forward flash_attention_plain."""
    pos = torch.arange(s, dtype=torch.int32, device=DEV)[None].repeat(b, 1)
    q = torch.randn((b, s, K, G, hd), generator=gen, device=DEV).to(qdt)
    k = torch.randn((b, s, K, hd), generator=gen, device=DEV).to(qdt)
    v = torch.randn((b, s, K, hd), generator=gen, device=DEV).to(qdt)
    w = torch.randn((b, s, K, G, hd), generator=gen, device=DEV).to(qdt)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        return torch.autograd.grad((out.float() * w.float()).sum(), leaves)

    nb = flash_attention_bwd.launches
    got = grads(lambda q_, k_, v_: kops.flash_attention_trainable(
        q_, k_, v_, pos, pos, window=window))
    if flash_attention_bwd.launches != nb + 1:
        fail(f"{name}: the autograd Function did not launch the backward "
             "kernel")
    bodies = (check_body(name, flash_attention, qdt),
              check_body(name, flash_attention_bwd, qdt))
    want = grads(lambda q_, k_, v_: flash_attention.flash_attention_plain(
        q_.reshape(b, s, K * G, hd), k_, v_, pos, pos,
        window=window).reshape(b, s, K, G, hd))
    errs = [check_bwd(f"{name} {n}", a, w_, ATOL_AUTOGRAD_BF16)
            for n, a, w_ in zip(("dq", "dk", "dv"), got, want)]
    log(f"[2] {name}: {bodies[0]} / {bodies[1]} bodies, max abs err dq "
        f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}")
    return errs


def check_rel(name, got, want):
    """|got - want| <= RTOL_ML * (|want| + the largest |want| of the same
    folded head) elementwise, for the mLSTM scan's f32 results; returns the
    largest absolute error."""
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: kernel result not finite")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    head = w.abs().reshape(w.shape[0], -1).amax(dim=1)
    head = head.reshape((-1,) + (1,) * (w.dim() - 1))
    over = diff - RTOL_ML * (w.abs() + head)
    if not float(over.max()) <= 0.0:
        fail(f"{name}: max abs err {float(diff.max()):.3e} exceeds "
             f"{RTOL_ML:.0e} x (|value| + head max) by "
             f"{float(over.max()):.3e}")
    return float(diff.max())


def mlstm_case(gen, name, *, bh, s, dk, dv, chunk, dt=torch.float32,
               initial=False, fresh=(), pad_tail=0, pad_rows=()):
    """Kernel 4 against its plain version: out (bf16: the bf16 tolerance;
    f32: check_rel), C, n and m (check_rel). `fresh` rows of the initial
    state are a fresh lane's (C, n = 0, m = -1e30); the last `pad_tail`
    steps of every row and all steps of `pad_rows` are padding (i = -1e30,
    f = 1e4), as chunked prefill pads them."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    q, k = (rnd(bh, s, dk) * 0.5).to(dt), (rnd(bh, s, dk) * 0.5).to(dt)
    v = rnd(bh, s, dv).to(dt)
    ig, fg = rnd(bh, s), rnd(bh, s) + 2.0
    if pad_tail:
        ig[:, s - pad_tail:] = mlstm_scan.NEG_INF
        fg[:, s - pad_tail:] = 1e4
    for r in pad_rows:
        ig[r], fg[r] = mlstm_scan.NEG_INF, 1e4
    init = None
    if initial:
        C0, n0, m0 = rnd(bh, dk, dv), rnd(bh, dk).abs(), rnd(bh, 1)
        for r in fresh:
            C0[r], n0[r], m0[r] = 0.0, 0.0, mlstm_scan.NEG_INF
        init = (C0, n0, m0)
    got = mlstm_scan.mlstm_scan_fwd(q, k, v, ig, fg, chunk=chunk,
                                    initial=init)
    torch.cuda.synchronize()
    # the tensor-core body takes bf16 rows of whole 16-byte pieces
    body = check_body(name, mlstm_scan,
                      dt if dk % 8 == 0 else torch.float32)
    want = mlstm_scan.mlstm_scan_plain(q, k, v, ig, fg, chunk=chunk,
                                       initial=init)
    if dt == torch.bfloat16:
        err = check_close(name, got[0], want[0], TOL_BF16)
    else:
        err = check_rel(name, got[0], want[0])
    for nm, a, b in zip(("C", "n", "m"), got[1], want[1]):
        check_rel(f"{name} {nm}", a, b)
    for r in pad_rows:
        if r in fresh and float(got[0][r].float().abs().max()) != 0.0:
            fail(f"{name}: padding-only fresh row {r} output not zero")
    log(f"[2] {name}: {body} body, max abs err out {err:.3e}")
    return err


def phase_kernels():
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    errs = {"paged_decode": 0.0, "paged_prefill": 0.0,
            "flash_attention": 0.0, "flash_attention_train": 0.0,
            "flash_attention_bwd": 0.0, "mlstm_scan": 0.0,
            "decode_attention": 0.0}
    n = 0
    S = dict(K=8, G=4, hd=128, bs=16)      # mistral-nemo-12b serving shapes

    def d(name, **kw):
        nonlocal n
        errs["paged_decode"] = max(errs["paged_decode"],
                                   decode_case(gen, "decode " + name, **kw))
        n += 1

    def p(name, **kw):
        nonlocal n
        errs["paged_prefill"] = max(errs["paged_prefill"],
                                    prefill_case(gen, "prefill " + name, **kw))
        n += 1

    for codec in ("bf16", "int8", "int4"):
        d(f"serve w1 ctx256 {codec}", lens=[256], codec=codec, **S)
        d(f"serve w8 mixed {codec}", codec=codec, **S,
          lens=[2048, 300, 1777, 1024, 513, 4096, 257, 1500])
        d(f"serve w16 ctx<=4096 {codec} window", codec=codec, window=1024,
          lens=[4096, 256, 1000, 2222, 3333, 512, 768, 1025] * 2, **S)
        d(f"serve w8 mass inert hole {codec}", codec=codec, mass=True,
          lens=[1024, 300, 1777, 640, 513, 2048, 257, 1500],
          m_blocks=128, inert=(3,), holes=((0, 5), (2, 0)), **S)
    d("serve w8 f32 pool f32 q", codec="f32", qdt=torch.float32,
      lens=[2048, 300, 1777, 1024, 513, 4096, 257, 1500], **S)
    d("serve chunk-local", codec="bf16", chunk=512, lens=[1500, 700], **S)
    d("serve w8 f32 window", codec="f32", qdt=torch.float32, window=1024,
      lens=[2048, 300, 1777, 1024, 513, 4096, 257, 1500], **S)
    d("serve f32 chunk-local", codec="f32", qdt=torch.float32, chunk=512,
      lens=[1500, 700, 512, 513], **S)
    # odd shapes: the tests' sizes and the registry's
    for codec in ("f32", "bf16", "int8", "int4"):
        qdt = torch.float32 if codec == "f32" else torch.bfloat16
        d(f"hd16 G2 bs4 {codec}", K=2, G=2, hd=16, bs=4, codec=codec,
          qdt=qdt, lens=[13, 7, 16, 1], m_blocks=6, mass=True, inert=(3,))
        d(f"hd256 G2 bs64 {codec}", K=4, G=2, hd=256, bs=64, codec=codec,
          qdt=qdt, lens=[700, 64, 65])
    d("G1 bs128 hd128", K=8, G=1, hd=128, bs=128, codec="bf16",
      lens=[1000, 129], mass=True)
    d("hd256 G4 bs128 int8", K=2, G=4, hd=256, bs=128, codec="int8",
      lens=[300, 128])
    d("G12 hd192 bs8", K=2, G=12, hd=192, bs=8, codec="bf16", lens=[100, 9])
    d("trimmed table", K=8, G=4, hd=128, bs=16, codec="bf16",
      lens=[40, 33], m_blocks=3)
    d("bs6 (tile rows not a multiple of 4)", K=2, G=4, hd=64, bs=6,
      codec="int8", lens=[100, 61, 7], mass=True)
    # the streaming body's block mass (a lane group walks whole pool blocks,
    # splits and pages hold whole blocks) at every block size, every codec
    # (16 int8 / 32 int4 codes a lane), an unassigned middle entry, inert
    # lanes; int4 at hd 16 (one lane a row, 8 of its 16 bytes); one lane
    # over many pages of 1024 positions a split
    for codec in ("f32", "bf16", "int8", "int4"):
        qdt = torch.float32 if codec == "f32" else torch.bfloat16
        d(f"mass bs64 hd256 G2 hole {codec}", K=4, G=2, hd=256, bs=64,
          codec=codec, qdt=qdt, lens=[700, 64, 65], mass=True,
          holes=((0, 3),))
        d(f"mass bs8 G12 hd192 {codec}", K=2, G=12, hd=192, bs=8,
          codec=codec, qdt=qdt, lens=[100, 9, 300], mass=True, inert=(1,))
        d(f"mass bs128 G4 hd256 {codec}", K=2, G=4, hd=256, bs=128,
          codec=codec, qdt=qdt, lens=[300, 128, 1000], mass=True,
          holes=((2, 1),))
        d(f"mass bs6 G4 hd64 hole {codec}", K=2, G=4, hd=64, bs=6,
          codec=codec, qdt=qdt, lens=[100, 61, 7], mass=True,
          holes=((0, 4),))
        d(f"mass bs16 serve heads window {codec}", codec=codec, qdt=qdt,
          window=700, lens=[2048, 300, 1777, 1024], mass=True,
          holes=((2, 10),), **S)
    d("int4 hd16 G4 bs16 window mass inert", K=2, G=4, hd=16, bs=16,
      codec="int4", lens=[200, 33, 1], window=50, mass=True, inert=(2,))
    d("int4 hd16 G1 bs4 chunk", K=2, G=1, hd=16, bs=4, codec="int4",
      lens=[77, 20], chunk=32)
    d("int4 hd80 G2 bs16 (40-byte rows)", K=2, G=2, hd=80, bs=16,
      codec="int4", lens=[500, 17], mass=True)
    d("int8 hd80 G4 bs16", K=2, G=4, hd=80, bs=16, codec="int8",
      lens=[500, 17])
    d("one lane 40000 positions int8 mass (pages within a split)", K=1,
      G=4, hd=64, bs=16, codec="int8", lens=[40000], mass=True)
    d("one lane 40000 positions bf16", K=1, G=4, hd=64, bs=16,
      codec="bf16", lens=[40000])

    for codec in ("bf16", "int8", "int4"):
        p(f"serve fresh w4 {codec}", hist=[0, 0, 0, 0],
          clens=[256, 256, 100, 1], C=256, codec=codec, **S)
        p(f"serve history w2 {codec}", hist=[1024, 3840], clens=[256, 256],
          C=256, codec=codec, **S)
        p(f"serve half-full odd w3 {codec}", hist=[1000, 7, 2040],
          clens=[256, 8, 201], C=256, codec=codec, m_blocks=256, **S)
    p("serve f32", hist=[1000, 7], clens=[256, 77], C=256, codec="f32",
      qdt=torch.float32, **S)
    p("serve window", hist=[1500], clens=[256], C=256, codec="bf16",
      window=512, **S)
    p("serve f32 window", hist=[1500, 100], clens=[256, 256], C=256,
      codec="f32", qdt=torch.float32, window=512, **S)
    p("serve f32 chunk-local", hist=[1400, 300], clens=[256, 256], C=256,
      codec="f32", qdt=torch.float32, chunk=512, **S)
    p("serve chunk-local int8", hist=[900], clens=[256], C=256,
      codec="int8", chunk=512, **S)
    p("serve unmapped tail", hist=[500, 16], clens=[200, 256], C=256,
      codec="int8", unmapped_tail=True, **S)
    for codec in ("f32", "bf16", "int8", "int4"):
        qdt = torch.float32 if codec == "f32" else torch.bfloat16
        p(f"hd16 G2 bs4 C8 {codec}", hist=[6, 9, 0], clens=[8, 5, 3], C=8,
          K=2, G=2, hd=16, bs=4, codec=codec, qdt=qdt, m_blocks=6)
        p(f"hd256 G2 bs64 C64 {codec}", hist=[100, 0], clens=[64, 33], C=64,
          K=4, G=2, hd=256, bs=64, codec=codec, qdt=qdt)
    p("G1 bs128 C128", hist=[130], clens=[128], C=128, K=8, G=1, hd=128,
      bs=128, codec="bf16")
    p("bs6 C30 (tile rows not a multiple of 4)", hist=[50, 0], clens=[30, 17],
      C=30, K=2, G=4, hd=64, bs=6, codec="int4")
    # the tensor-core body: every codec at hd 80 (40-byte int4 rows, 8-byte
    # copies) and at gemma3-12b's global layers (hd 256, G 2), a K/V tile
    # spanning an unassigned middle entry of the history, pool blocks of 6
    # (tiles across block edges) and of 128 (a tile inside one block)
    for codec in ("bf16", "int8", "int4"):
        p(f"tc hd80 G4 C64 {codec}", hist=[300, 17, 0], clens=[64, 40, 64],
          C=64, K=2, G=4, hd=80, bs=16, codec=codec)
        p(f"tc gemma3 global hd256 G2 C128 {codec}", hist=[700, 0],
          clens=[128, 77], C=128, bs=16, codec=codec, **GM)
        p(f"tc hole mid-tile C64 {codec}", hist=[500, 200], clens=[64, 50],
          C=64, K=2, G=4, hd=128, bs=16, codec=codec,
          holes=((0, 5), (1, 2), (1, 3)))
        p(f"tc bs6 C48 {codec}", hist=[100, 7], clens=[48, 30], C=48, K=2,
          G=4, hd=128, bs=6, codec=codec, holes=((0, 3),))
        p(f"tc bs128 C128 window {codec}", hist=[300, 0], clens=[128, 128],
          C=128, K=2, G=4, hd=128, bs=128, codec=codec, window=200)

    def f(name, **kw):
        nonlocal n
        errs["flash_attention"] = max(errs["flash_attention"],
                                      flash_case(gen, "flash " + name, **kw))
        n += 1

    # the reference kernel tests' sweep (causal, window 48, chunk 64,
    # single tile; G = 2, 4, 1)
    for qdt in (torch.float32, torch.bfloat16):
        t = "f32" if qdt == torch.float32 else "bf16"
        f(f"s128 K2 G2 hd32 {t}", b=2, s=128, K=2, G=2, hd=32, qdt=qdt)
        f(f"s128 K1 G4 hd16 window48 {t}", b=2, s=128, K=1, G=4, hd=16,
          qdt=qdt, window=48)
        f(f"s256 K2 G1 hd64 chunk64 {t}", b=2, s=256, K=2, G=1, hd=64,
          qdt=qdt, chunk=64)
        f(f"s64 K4 G1 hd8 window16 {t}", b=2, s=64, K=4, G=1, hd=8, qdt=qdt,
          window=16)
        # lengths no tile divides, at mistral-nemo's heads
        f(f"s200 serve heads {t}", b=2, s=200, qdt=qdt, **MN)
        f(f"s777 serve heads window300 {t}", b=1, s=777, qdt=qdt,
          window=300, **MN)
        # rows of different lengths padded with -1; positions off the
        # indices
        f(f"ragged w3 s300 {t}", b=3, s=300, lens=[300, 123, 7], qdt=qdt,
          **MN)
        f(f"offset positions s129 chunk64 {t}", b=2, s=129, start=1000,
          lens=[129, 64], chunk=64, qdt=qdt, **MN)
    f("hd256 G2 f32", b=2, s=100, K=2, G=2, hd=256, qdt=torch.float32)
    f("G12 hd192 bf16", b=1, s=90, K=2, G=12, hd=192)
    # the serving shapes: a whole-prompt prefill group, a greedy prefill
    f("serve w8 s256", b=8, s=256, **MN)
    f("greedy w1 s2048", b=1, s=2048, **MN)
    DN = dict(K=8, G=4, hd=80)       # h2o-danube-1.8b's attention heads
    # head_dim 80 at lengths no tile divides, then phase 8's training shape
    # [4, 2048, 32, 80], 8 kv heads, causal under the 4096 window (its
    # error is the flash_attention[train] row's)
    for qdt in (torch.float32, torch.bfloat16):
        t = "f32" if qdt == torch.float32 else "bf16"
        f(f"s333 danube heads {t}", b=2, s=333, qdt=qdt, lens=[333, 200],
          **DN)
        f(f"s517 danube heads window100 {t}", b=1, s=517, qdt=qdt,
          window=100, **DN)
    # the tensor-core body's tile edges (16-row mma tiles, 128-row blocks
    # of 10 positions at G = 12, 64-key tiles) and the serving paths' real
    # head layouts: gemma3-12b's local prefill, recurrentgemma-9b's (MQA)
    for s in (127, 129, 1025):
        f(f"tile edge s{s} K2 G12 hd80 bf16", b=1, s=s, K=2, G=12, hd=80)
    # the tensor-core body's other padded head widths (48, 96, 112, 160,
    # 224: each its own tile and occupancy settings) at odd lengths, G > 1
    for hd, s, G, window in PADDED_WIDTHS:
        w = f" window{window}" if window else ""
        f(f"hd{hd} s{s} K2 G{G}{w} ragged bf16", b=2, s=s, K=2, G=G, hd=hd,
          window=window, lens=[s, s // 2 + 3])
    f("gemma3 local prefill [1, 2048, 16, 256] window1024 bf16", b=1, s=2048,
      window=1024, **GM)
    f("rgemma prefill [1, 3000, 16, 256] window2048 bf16", b=1, s=3000,
      window=2048, **RG)
    # phase 13's head layouts: llama4-scout's chunk-local (chunk 8192) and
    # global layers (G 5) at the greedy prefills' lengths and across chunk
    # edges, internvl2-26b's (G 6) prefix prefill [1, 1224, 48, 128]
    for qdt in (torch.float32, torch.bfloat16):
        t = "f32" if qdt == torch.float32 else "bf16"
        f(f"scout chunk-local s512 chunk8192 {t}", b=1, s=512, chunk=8192,
          qdt=qdt, **SC)
        f(f"scout global ragged s384 {t}", b=2, s=384, lens=[384, 64],
          qdt=qdt, **SC)
        f(f"internvl ragged s300 {t}", b=2, s=300, lens=[300, 201], qdt=qdt,
          **VL)
    f("scout chunk-local s1100 chunk512 ragged bf16", b=2, s=1100, chunk=512,
      lens=[1100, 700], **SC)
    f("internvl prefix prefill [1, 1224, 48, 128] bf16", b=1, s=1224, **VL)
    errs["flash_attention_train"] = flash_case(
        gen, "flash train [4, 2048, 32, 80] window4096", b=4, s=2048,
        window=4096, **DN)
    n += 1

    bwd_errs = {"dq": 0.0, "dk": 0.0, "dv": 0.0}

    def fb(name, fn=flash_bwd_case, **kw):
        nonlocal n
        for key, e in zip(("dq", "dk", "dv"), fn(gen, "flash bwd " + name,
                                                  **kw)):
            bwd_errs[key] = max(bwd_errs[key], e)
        n += 1

    # the reference kernel tests' sweep (causal, window 48, chunk 64; G = 2,
    # 4, 1), then head_dim 80 and 128, lengths no tile divides, rows padded
    # with -1, positions off the indices, rows that see nothing
    for qdt in (torch.float32, torch.bfloat16):
        t = "f32" if qdt == torch.float32 else "bf16"
        fb(f"s128 K2 G2 hd32 {t}", b=2, s=128, K=2, G=2, hd=32, qdt=qdt)
        fb(f"s128 K1 G4 hd16 window48 {t}", b=2, s=128, K=1, G=4, hd=16,
           qdt=qdt, window=48)
        fb(f"s256 K2 G1 hd64 chunk64 {t}", b=2, s=256, K=2, G=1, hd=64,
           qdt=qdt, chunk=64)
        fb(f"s200 danube heads {t}", b=2, s=200, qdt=qdt, **DN)
        fb(f"s333 danube heads window100 {t}", b=1, s=333, qdt=qdt,
           window=100, **DN)
        fb(f"s300 K8 G4 hd128 ragged {t}", b=3, s=300, K=8, G=4, hd=128,
           lens=[300, 123, 7], qdt=qdt)
        fb(f"s129 K2 G2 hd80 offset chunk64 {t}", b=2, s=129, K=2, G=2,
           hd=80, start=1000, lens=[129, 64], chunk=64, qdt=qdt)
        fb(f"s100 danube heads blind rows {t}", b=2, s=100, blind=37,
           lens=[100, 60], qdt=qdt, **DN)
        fb(f"s97 K4 G1 hd64 window16 blind rows {t}", b=1, s=97, K=4, G=1,
           hd=64, window=16, blind=20, qdt=qdt)
    fb("hd256 G2 f32", b=2, s=100, K=2, G=2, hd=256, qdt=torch.float32)
    fb("G12 hd192 bf16", b=1, s=90, K=2, G=12, hd=192)
    for s in (127, 129, 1025):
        fb(f"tile edge s{s} K2 G12 hd80 bf16", b=1, s=s, K=2, G=12, hd=80)
    for hd, s, G, window in PADDED_WIDTHS:
        w = f" window{window}" if window else ""
        fb(f"hd{hd} s{s} K2 G{G}{w} ragged bf16", b=2, s=s, K=2, G=G, hd=hd,
           window=window, lens=[s, s // 2 + 3])
    # more query heads per kv head than the bf16 dK/dV tile holds: the
    # wrapper refuses before any launch
    G = flash_attention_bwd.BF16_MAX_G + 1
    q = torch.zeros((1, 4, G, 16), dtype=torch.bfloat16, device=DEV)
    k = torch.zeros((1, 4, 1, 16), dtype=torch.bfloat16, device=DEV)
    lse = torch.zeros((1, 4, G), device=DEV)
    pos = torch.arange(4, dtype=torch.int32, device=DEV)[None]
    nb = flash_attention_bwd.launches
    try:
        flash_attention_bwd.flash_attention_bwd(q, k, k, q, lse, q, pos, pos)
        fail(f"flash bwd G{G} bf16: launched past the tile's query rows")
    except ValueError as e:
        if flash_attention_bwd.launches != nb:
            fail(f"flash bwd G{G} bf16: counted a launch it refused")
        log(f"[2] flash bwd G{G} bf16: refused ({e})")
    fb("gemma3 local [1, 2048, 16, 256] window1024 bf16", b=1, s=2048,
       window=1024, **GM)
    fb("rgemma [1, 3000, 16, 256] window2048 bf16", b=1, s=3000,
       window=2048, **RG)
    # the training shape of phase 8: [4, 2048, 32, 80], 8 kv heads, causal
    # under the 4096 window
    fb("train [4, 2048, 32, 80] window4096", b=4, s=2048, window=4096, **DN)
    fb("autograd f32 window128", fn=flash_autograd_case, b=2, s=300,
       qdt=torch.float32, window=128, **DN)
    fb("autograd bf16", fn=flash_autograd_case, b=1, s=512,
       qdt=torch.bfloat16, **DN)
    # phase 14's per-rank head counts on a model axis (its runs d, e, f):
    # each rank runs the flash kernels at n_kv_heads / M kv heads, G and hd
    # unchanged: h2o-danube-1.8b on model:2 (K 4) and model:4 (K 2), causal
    # under its 4096 window, at its training rows [4, 2048] and at lengths
    # no tile divides, rows that see nothing among them
    for K in (4, 2):
        TPB = dict(K=K, G=4, hd=80, window=4096)
        f(f"tp K{K} train [4, 2048, {4 * K}, 80] window4096 bf16", b=4,
          s=2048, **TPB)
        fb(f"tp K{K} train [4, 2048, {4 * K}, 80] window4096 bf16", b=4,
           s=2048, **TPB)
        for qdt in (torch.float32, torch.bfloat16):
            t = "f32" if qdt == torch.float32 else "bf16"
            fb(f"tp K{K} G4 hd80 s333 ragged window4096 {t}", b=2, s=333,
               lens=[333, 200], qdt=qdt, **TPB)
            fb(f"tp K{K} G4 hd80 s517 blind rows window4096 {t}", b=1,
               s=517, blind=30, qdt=qdt, **TPB)
    # phase 14(g) and (h): mixtral-8x7b's training rows [2, 2048] under its
    # 4096 window, a rank of model:2 at 4 of its 8 kv heads (16 query
    # heads) and the one-rank runs at all 8 (32), G 4, hd 128
    for K in (4, 8):
        MXT = dict(K=K, G=4, hd=128, window=4096)
        name = f"mixtral train K{K} [2, 2048, {4 * K}, 128] window4096 bf16"
        f(name, b=2, s=2048, **MXT)
        fb(name, b=2, s=2048, **MXT)
    errs["flash_attention_bwd"] = max(bwd_errs.values())

    def ml(name, **kw):
        nonlocal n
        errs["mlstm_scan"] = max(errs["mlstm_scan"],
                                 mlstm_case(gen, "mlstm " + name, **kw))
        n += 1

    # the reference kernel tests' sweep (dk != dv in the second), with and
    # without a carried state, f32 and bf16
    for dt in (torch.float32, torch.bfloat16):
        t = "f32" if dt == torch.float32 else "bf16"
        for init in (False, True):
            i = " initial" if init else ""
            ml(f"s128 bh4 dk16 dv16 c32 {t}{i}", bh=4, s=128, dk=16, dv=16,
               chunk=32, dt=dt, initial=init)
            ml(f"s64 bh2 dk8 dv24 c64 {t}{i}", bh=2, s=64, dk=8, dv=24,
               chunk=64, dt=dt, initial=init)
            ml(f"s96 bh8 dk32 dv32 c32 {t}{i}", bh=8, s=96, dk=32, dv=32,
               chunk=32, dt=dt, initial=init)
    # a fresh row (m0 = -1e30) beside carried ones, trailing padded steps
    # (i = -1e30, f = 1e4), rows of padding only (one fresh, one carried)
    ml("fresh rows", bh=4, s=64, dk=20, dv=40, chunk=32, initial=True,
       fresh=(1, 3))
    ml("padded tail", bh=4, s=128, dk=64, dv=64, chunk=64, initial=True,
       fresh=(0,), pad_tail=37)
    ml("padding-only rows", bh=4, s=32, dk=16, dv=16, chunk=32, initial=True,
       fresh=(2,), pad_rows=(1, 2), dt=torch.bfloat16)
    # xlstm-1.3b's heads (dk = dv = 1024): short whole prompts (one chunk of
    # 9 or 64), a 256-token chunk call with padding, the serving shape
    ml("full width s9 c9 bf16", bh=4, s=9, dk=1024, dv=1024, chunk=128,
       dt=torch.bfloat16)
    ml("full width s64 bf16", bh=8, s=64, dk=1024, dv=1024, chunk=128,
       dt=torch.bfloat16)
    ml("full width f32 initial", bh=4, s=256, dk=1024, dv=1024, chunk=128,
       initial=True, fresh=(1,), pad_tail=100)
    ml("serve [32, 256, 1024] c128 bf16 initial", bh=32, s=256, dk=1024,
       dv=1024, chunk=128, dt=torch.bfloat16, initial=True, fresh=(5, 17),
       pad_tail=55)
    # the two-pass design's edges: dv not a multiple of the 32-column state
    # tile, dk not a multiple of the 128-row update pass, one folded head,
    # chunks of 96 (three 32-row score tiles, a partial position slice);
    # f32 and bf16, with and without a carried state, fresh rows, padded
    # tails and padding-only rows at full width
    ml("dk1024 dv1000 bf16 initial", bh=2, s=256, dk=1024, dv=1000,
       chunk=128, dt=torch.bfloat16, initial=True, fresh=(1,), pad_tail=20)
    ml("dk200 dv72 c96 f32 initial", bh=3, s=192, dk=200, dv=72, chunk=96,
       initial=True, fresh=(2,), pad_tail=5)
    ml("dk512 dv256 c96 bf16", bh=2, s=192, dk=512, dv=256, chunk=96,
       dt=torch.bfloat16)
    for dt in (torch.float32, torch.bfloat16):
        t = "f32" if dt == torch.float32 else "bf16"
        ml(f"bh1 full width {t}", bh=1, s=256, dk=1024, dv=1024, chunk=128,
           dt=dt)
        ml(f"bh1 full width {t} initial fresh", bh=1, s=128, dk=1024,
           dv=1024, chunk=128, dt=dt, initial=True, fresh=(0,))
        ml(f"full width {t} padding-only rows initial", bh=4, s=128,
           dk=1024, dv=1024, chunk=128, dt=dt, initial=True, fresh=(1,),
           pad_rows=(1, 2), pad_tail=40)
    ml("full width s9 c9 f32 initial", bh=4, s=9, dk=1024, dv=1024,
       chunk=128, initial=True, fresh=(3,))
    def r(name, **kw):
        nonlocal n
        errs["decode_attention"] = max(errs["decode_attention"],
                                       ring_case(gen, "ring " + name, **kw))
        n += 1

    # the shapes of phases 9 and 10 (gemma3-12b's local and global rings,
    # recurrentgemma-9b's MQA ring), rings wrapped at heterogeneous
    # positions, f32 and bf16
    wrap8 = [5000, 1023, 1024, 3, 2047, 700, 1500, 4095]
    for dt in (torch.float32, torch.bfloat16):
        t = "f32" if dt == torch.float32 else "bf16"
        r(f"gemma3 local [8, 1024] window1024 {t}", L=1024, ends=wrap8,
          window=1024, qdt=dt, **GM)
        r(f"gemma3 global [8, 4096] {t}", L=4096, qdt=dt, **GM,
          ends=[4095, 300, 1777, 4000, 513, 2048, 257, 1500])
        r(f"rgemma [8, 2048] window2048 {t}", L=2048, window=2048, qdt=dt,
          ends=[3000, 2047, 2048, 64, 4095, 1000, 2500, 100], **RG)
        r(f"chunk512 G4 hd128 L1000 {t}", L=1000, ends=[1999, 512, 5],
          chunk=512, qdt=dt, **MN)
        r(f"no mask G4 hd128 L2080 (greedy ring) {t}", L=2080, ends=[2070],
          qdt=dt, **MN)
    # G = 1, 2, 4, 16; head_dim 64, 128, 256; lengths no tile divides;
    # inert lanes and empty rings; a tile cap below the kernel's own
    r("G1 hd64 L37 window20 f32", L=37, ends=[100, 36, 5], K=2, G=1, hd=64,
      window=20, qdt=torch.float32)
    r("G16 hd64 L4099 chunk1000", L=4099, ends=[9000, 4098, 1], K=2, G=16,
      hd=64, chunk=1000)
    r("G16 hd128 L777", L=777, ends=[800, 776, 1500], K=1, G=16, hd=128)
    r("G2 hd256 inert and empty lanes", L=300, ends=[400, 299, 10, 50],
      inert=(1,), empty=(2,), K=2, G=2, hd=256)
    r("G4 hd128 all inert", L=64, ends=[10, 70], inert=(0, 1), **MN)
    r("G2 hd256 bf16 q f32 ring", L=1024, ends=[3000, 900], window=1024,
      kvdt=torch.float32, **GM)
    r("G2 hd256 kv_block16", L=1000, ends=[1200, 999, 17], kv_block=16,
      **GM)
    r("G1 hd128 single slot", L=1, ends=[0, 5], K=4, G=1, hd=128)
    # every split count from 1 to the kernel's cap (one lane, one kv head:
    # a split takes two tiles of kv_block = 16), rings that wrapped,
    # lengths no tile divides, the head widths and group sizes in turn
    _, splits = decode_attention._bound()
    cap = splits(1, 1, 64, 1 << 20, 16)
    for ns in range(1, cap + 1):
        L = 32 * ns - ns % 16
        hd, G = (64, 128, 256)[ns % 3], (1, 2, 4, 16)[ns % 4]
        if splits(1, 1, hd, L, 16) != ns:
            fail(f"ring: L {L} at kv_block 16 takes "
                 f"{splits(1, 1, hd, L, 16)} splits, want {ns}")
        r(f"split {ns}/{cap} L{L} G{G} hd{hd}", L=L, ends=[L + 37 * ns],
          K=1, G=G, hd=hd, kv_block=16)
    # head widths 64 / 128 / 256 (4, 2 and 1 ring rows a warp step) x
    # G 1 / 2 / 4 / 16 (1, 2, 4 and 4 x 4 query rows a block) on
    # wrapped rings whose length no warp group divides, one lane inert
    for hd in (64, 128, 256):
        for G in (1, 2, 4, 16):
            r(f"hd{hd} G{G} L517 wrapped, inert lane", L=517, K=2, G=G,
              hd=hd, ends=[2000, 516, 900], inert=(1,))
    # f32 rings at every query-row group, inert and empty lanes after a wrap
    for G in (1, 2, 4, 16):
        r(f"f32 ring G{G} hd128 L1031 inert and empty", L=1031, K=2, G=G,
          hd=128, ends=[3000, 1031, 5000, 77], inert=(1,), empty=(2,),
          qdt=torch.float32)
    r("bf16 q f32 ring G16 hd64 window300 after a wrap", L=700, K=1, G=16,
      hd=64, ends=[1500, 699], window=300, kvdt=torch.float32)
    # phase 13's rings: llama4-scout's global and chunk-local layers (G 5)
    # at the greedy context (544 slots) and at a whole chunk, wrapped, with
    # a chunk edge inside the ring; internvl2-26b's (G 6) after the prefix
    for dt in (torch.float32, torch.bfloat16):
        t = "f32" if dt == torch.float32 else "bf16"
        r(f"scout global [4, 544] wrapped {t}", L=544, qdt=dt,
          ends=[543, 63, 300, 1000], **SC)
        r(f"scout chunk-local [4, 544] chunk8192 {t}", L=544, chunk=8192,
          qdt=dt, ends=[543, 200, 9000, 8200], **SC)
        r(f"scout chunk-local [2, 8192] chunk8192 wrapped {t}", L=8192,
          chunk=8192, qdt=dt, ends=[9000, 20000], **SC)
        r(f"internvl [3, 1256] {t}", L=1256, qdt=dt,
          ends=[1255, 1224, 3000], **VL)
    r("G12 hd80 (a partial query-row group, a partial lane group)", L=333,
      K=2, G=12, hd=80, ends=[1000, 200])
    # phase 16's per-rank head counts (its ranks launch every attention
    # kernel at n_kv_heads / M kv heads, G and hd unchanged; the paged
    # decode picks its context split from lanes x kv heads, so K 4 and K 2
    # take other splits than K 8): mistral-nemo-12b on model:2 (K 4) and
    # model:4 (K 2), blocks of 16, 8 lanes, its 1056-position context,
    # bf16 and int8 pools, the block mass with retention's holes; the
    # chunk prefill at 256; the whole-prompt flash prefill; gemma3-12b on
    # model:2 (K 4, G 2, hd 256): its local and global rings and prefill
    for K in (4, 2):
        TP = dict(K=K, G=4, hd=128, bs=16)
        for codec in ("bf16", "int8"):
            d(f"tp K{K} w1 ctx1056 mass {codec}", lens=[1056], codec=codec,
              mass=True, **TP)
            d(f"tp K{K} w8 mixed mass holes {codec}", codec=codec, mass=True,
              lens=[1056, 300, 1040, 64, 520, 1024, 80, 700],
              holes=((0, 3), (2, 7), (5, 1)), **TP)
            d(f"tp K{K} w4 trimmed table {codec}", codec=codec,
              lens=[530, 64, 1000, 17], m_blocks=64, **TP)
            p(f"tp K{K} fresh w4 C256 {codec}", hist=[0, 0, 0, 0],
              clens=[256, 256, 64, 8], C=256, codec=codec, **TP)
            p(f"tp K{K} history w8 C256 {codec}",
              hist=[768, 256, 512, 0, 0, 256, 0, 768],
              clens=[256, 256, 8, 64, 256, 264 - 256, 200, 256], C=256,
              codec=codec, **TP)
        f(f"tp K{K} G4 hd128 prefill w1 s64 bf16", b=1, s=64, K=K, G=4,
          hd=128)
        f(f"tp K{K} G4 hd128 prefill w2 s520 ragged bf16", b=2, s=520,
          lens=[520, 256], K=K, G=4, hd=128)
    # phase 16(f) and (g): mixtral-8x7b on model:2, each rank at 4 of its
    # 8 kv heads (G 4, hd 128, the heads of mistral-nemo-12b's ranks above)
    # under its 4096 window, which no position of the trace's 1056-position
    # context leaves
    MX4 = dict(K=4, G=4, hd=128, window=4096)
    d("tp mixtral K4 w8 mixed window4096 bf16", codec="bf16", bs=16,
      lens=[1056, 300, 1040, 64, 520, 1024, 80, 700], **MX4)
    p("tp mixtral K4 history w8 C256 window4096 bf16", codec="bf16", bs=16,
      hist=[768, 256, 512, 0, 0, 256, 0, 768],
      clens=[256, 256, 8, 64, 256, 8, 200, 256], C=256, **MX4)
    f("tp mixtral K4 prefill w2 s520 ragged window4096 bf16", b=2, s=520,
      lens=[520, 256], **MX4)
    GM4 = dict(GM, K=4)
    r("tp gemma3 K4 local [4, 1024] window1024 wrapped bf16", L=1024,
      window=1024, ends=[1223, 63, 1100, 300], **GM4)
    r("tp gemma3 K4 global [4, 1224] bf16", L=1224, ends=[1223, 63, 1100,
                                                           300], **GM4)
    f("tp gemma3 K4 local prefill [1, 1200] window1024 bf16", b=1, s=1200,
      window=1024, **GM4)
    f("tp gemma3 K4 global prefill [1, 1200] bf16", b=1, s=1200, **GM4)
    f("tp gemma3 K4 global prefill [1, 64] bf16", b=1, s=64, **GM4)
    log(f"[2] {n} kernel-vs-plain cases agree on the card: max abs err "
        f"decode {errs['paged_decode']:.3e}, prefill "
        f"{errs['paged_prefill']:.3e}, flash {errs['flash_attention']:.3e} "
        f"(training shape {errs['flash_attention_train']:.3e}), "
        f"mlstm out {errs['mlstm_scan']:.3e}, ring decode "
        f"{errs['decode_attention']:.3e}, flash backward dq "
        f"{bwd_errs['dq']:.3e} dk {bwd_errs['dk']:.3e} dv "
        f"{bwd_errs['dv']:.3e} "
        f"(tolerances: f32 {TOL_F32:.0e}, bf16 "
        f"{TOL_BF16:.0e} + {RTOL_BF16:.1e} * |value|, mass {TOL_MASS:.0e}, "
        f"lse {TOL_LSE:.0e}, mlstm f32 {RTOL_ML:.0e} x (|value| + the "
        f"head's largest |value|), flash backward f32 {RTOL_BWD:.0e} x "
        f"(|value| + the tensor's largest |value|), bf16 {RTOL_BF16:.1e} * "
        f"|value| + {ATOL_BWD_BF16:.0e} x the tensor's largest |value| "
        f"({ATOL_AUTOGRAD_BF16:.0e} for the bf16 autograd round trip); "
        f"pool codes, payload and positions exact, scales <= 1 ULP)")
    return errs


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

KV_BLOCK, LANES, CHUNK = 16, 8, 256
HBM_BUDGET = 72e9       # bytes of the card the deployment may plan for
# Phase 3 sizes its pool under a workload class fixed by hand: Medium (paper
# Table III factor 2), the class the reference package's simulator assigns
# decode. Phase 11 plans the same trace through the profiler instead.
WORKLOAD = CL.Classification(category=CL.Category.MEDIUM, alpha=0.8, inc=1.0,
                             slope=0.8, intercept=0.0)
MESH = {"data": 1, "model": 1}


def make_trace(cfg):
    """16 requests; prompts of up to CHUNK tokens take whole-prompt
    prefill, longer ones chunked prefill."""
    return synthetic_trace(16, vocab_size=cfg.vocab_size, seed=SEED + 7,
                           prompt_lens=(64, 200, 256, 520, 1024, 2048),
                           gen_lens=(16, 24, 32), mean_interarrival=2.0)


def plan_pool(cfg, trace, context, kv_quant):
    """Size the block pool with the capacity model for the H100 spec under
    HBM_BUDGET, capped at what the lanes can ever hold."""
    plan = PR.MemoryPlan(kv_block_size=KV_BLOCK, kv_quant=kv_quant)
    shape = ShapeConfig("serve", DECODE, context, LANES)
    lens = [len(r.prompt) + r.max_new for r in trace]
    avg = -(-sum(lens) // len(lens))
    kw = dict(lanes=LANES, hw=HW.H100, hbm_budget=HBM_BUDGET,
              avg_context=avg, decode_width=LANES,
              prefill_tokens=LANES * CHUNK, prefill_kernel="tiled",
              prefill_width=LANES)
    blocks = PR.serving_block_capacity(cfg, shape, plan, WORKLOAD, MESH, **kw)
    per_seq = -(-context // KV_BLOCK)
    pool_blocks = max(min(blocks, LANES * per_seq), 1)
    # the same terms serving_block_capacity sums, at the pool actually built
    sh = dataclasses.replace(shape, global_batch=LANES)
    base = (PR.resident_bytes(cfg, sh, plan, MESH)
            - PR.cache_bytes_per_device(cfg, sh, plan, MESH)
            + LANES * PR.lane_bytes_per_device(cfg, sh, plan, MESH))
    per_block = PR.kv_block_bytes_per_device(cfg, sh, plan, MESH)
    reach = min(-(-avg // KV_BLOCK) * KV_BLOCK, context)
    tra = max(
        PR.transient_bytes(cfg, dataclasses.replace(sh, seq_len=reach), plan,
                           WORKLOAD, MESH),
        PR.prefill_transient_bytes(cfg, shape, plan, WORKLOAD, MESH,
                                   prefill_tokens=LANES * CHUNK, reach=reach,
                                   width=LANES, kernel="tiled"))
    # the pool is allocated one block larger (scratch block 0)
    resident = base + (pool_blocks + 1) * per_block
    return {"capacity_blocks": int(blocks), "pool_blocks": int(pool_blocks),
            "resident": float(resident), "transient": float(tra),
            "per_block": float(per_block)}


class Clocked:
    """Keeps the host seconds of each decode tick in `decode_s`: a tick
    ends in the read of its tokens, so its work on the card is done when
    the call returns. Mixed into an executor."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.decode_s = []

    def decode(self, *a, **kw):
        t0 = time.time()
        out = super().decode(*a, **kw)
        self.decode_s.append(time.time() - t0)
        return out


class Recording(Clocked):
    """Records, per argmax call, what each active row was fed (decode: the
    input token and its position; chunk: the chunk's tokens and start;
    whole-prompt prefill: the prompt and 0), the token chosen, the row's
    top-2 logit gap as a fraction of the row's logit standard deviation
    (phase 4 judges divergences with it) and, with `keep_logits`, the rows'
    logits on the host (phases 6 and 7 judge with them); and the mLSTM scan
    kernel's launches made inside decode ticks (there should be none).
    Mixed into an executor: the paged one packs a decode tick's active
    rows first (PACKED), the slot one computes every slot's row."""
    PACKED = True

    def __init__(self, *a, keep_logits=False, **kw):
        super().__init__(*a, **kw)
        self.calls = []
        self._fed, self._rows = [], []
        self.keep_logits = keep_logits
        self.decode_mlstm_launches = 0

    def decode(self, tokens, positions, tables=None, lanes=None):
        rows = list(lanes if lanes is not None else range(len(tokens)))
        self._fed = [(int(tokens[i]), int(positions[i])) for i in rows]
        self._rows = list(range(len(rows))) if self.PACKED else rows
        before = mlstm_scan.launches
        out = super().decode(tokens, positions, tables, lanes)
        self.decode_mlstm_launches += mlstm_scan.launches - before
        return out

    def prefill_batch(self, lanes, prompts, tables=None):
        self._fed = [(tuple(int(t) for t in p), 0) for p in prompts]
        self._rows = list(range(len(prompts)))
        return super().prefill_batch(lanes, prompts, tables)

    def prefill_chunks(self, lanes, chunks, starts, *a, **kw):
        self._fed = [(tuple(int(t) for t in c), int(s))
                     for c, s in zip(chunks, starts)]
        self._rows = list(range(len(chunks)))
        return super().prefill_chunks(lanes, chunks, starts, *a, **kw)

    def _argmax(self, logits):
        lg = logits[self._rows].float()
        top = lg.topk(2, dim=-1).values
        gap = ((top[:, 0] - top[:, 1]) / lg.std(dim=-1)).cpu().numpy()
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        kept = lg.cpu() if self.keep_logits else None
        self.calls.append((self._fed, toks[self._rows].copy(), gap, kept))
        return toks


class ClockedExecutor(Clocked, PagedTorchExecutor):
    pass


class ClockedSlotExecutor(Clocked, TorchExecutor):
    pass


class RecordingExecutor(Recording, PagedTorchExecutor):
    pass


class RecordingSlotExecutor(Recording, TorchExecutor):
    PACKED = False


# every kernel of the path, or every kernel's plain version
SETTINGS = {"kernel": ModelSettings(),
            "naive": ModelSettings(attn=A.AttnSettings(backend="naive"),
                                   mlstm_backend="naive")}


def tick_times(ex):
    """A log fragment: the decode ticks' host times."""
    t = np.asarray(ex.decode_s) * 1e3
    return (f"decode ticks {np.mean(t):.1f} ms on average (median "
            f"{np.median(t):.1f}, {np.min(t):.1f}-{np.max(t):.1f}), "
            f"{t.sum() / 1e3:.2f} s in all")


def serve(cfg, params, trace, context, n_blocks, kv_quant, backend="kernel",
          record=False, keep_logits=False, prefill_budget=0,
          recorder=None):
    kw = dict(keep_logits=keep_logits) if record else {}
    cls = (recorder or RecordingExecutor) if record else ClockedExecutor
    ex = cls(params, cfg, n_lanes=LANES, n_blocks=n_blocks, kv_block=KV_BLOCK,
             context=context, compact=True, chunk=CHUNK, kv_quant=kv_quant,
             settings=SETTINGS[backend], device=DEV, **kw)
    if not all(t.device.type == DEV.type for P in ex.pool["units"]
               for t in P.values()):
        fail("the pool is not on the card")
    alloc = BlockAllocator(n_blocks, KV_BLOCK)
    eng = Engine(ex, LANES, allocator=alloc, chunk_prefill=CHUNK,
                 prefill_budget=prefill_budget, audit="strict")
    t0 = time.time()
    rep = eng.run(trace)
    torch.cuda.synchronize()
    dt = time.time() - t0
    if len(rep.completions) != len(trace):
        fail(f"{len(rep.completions)} of {len(trace)} requests completed")
    for c in rep.completions:
        req = trace[c.rid]
        if len(c.tokens) != req.max_new or \
                not all(0 <= t < cfg.padded_vocab_size for t in c.tokens):
            fail(f"request {c.rid}: bad token stream {c.tokens}")
    if rep.audit_failures or rep.audits != rep.ticks:
        fail(f"allocator audit: {rep.audit_failures} failures, "
             f"{rep.audits} audits over {rep.ticks} ticks")
    leaks = leak_check(alloc)
    if leaks:
        fail(f"allocator leaks: {leaks}")
    return ex, rep, dt


def phase_main(cfg, params):
    trace = make_trace(cfg)
    lens = [len(r.prompt) for r in trace]
    if min(lens) > CHUNK or max(lens) <= CHUNK:
        fail("the trace must hold prompts both up to and above the chunk")
    context = trace_context(trace)
    counts, shapes, plans, reps = {}, {}, {}, {}
    peak, calls = {}, None
    for kv_quant in ("none", "int8"):
        plan = plan_pool(cfg, trace, context, kv_quant)
        plans[kv_quant] = plan
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        ex, rep, dt = serve(cfg, params, trace, context, plan["pool_blocks"],
                            kv_quant, record=kv_quant == "none",
                            keep_logits=kv_quant == "none")
        nd, npf = paged_decode.launches, paged_prefill.launches
        nfa = flash_attention.launches
        if decode_attention.launches:
            fail(f"ring decode launched {decode_attention.launches} times: "
                 "every layer of this model pages")
        peak[kv_quant] = torch.cuda.max_memory_allocated()
        if rep.prefill_calls <= 0 or ex.chunk_calls <= 0:
            fail(f"whole-prompt prefill calls {rep.prefill_calls}, chunk "
                 f"calls {ex.chunk_calls}: both paths must run")
        want_d, want_p = cfg.n_layers * ex.decodes, cfg.n_layers * ex.chunk_calls
        want_f = cfg.n_layers * rep.prefill_calls
        if (nd <= 0 or npf <= 0 or nfa <= 0 or nd != want_d
                or npf != want_p or nfa != want_f):
            fail(f"launch counters: decode {nd} (want {want_d}), prefill "
                 f"{npf} (want {want_p}), flash {nfa} (want {want_f})")
        counts[kv_quant] = (nd, npf, nfa)
        # each step's shapes and how many calls each had
        shapes[kv_quant] = {k: dict(sorted(c.items()))
                            for k, c in ex.shape_calls.items()}
        reps[kv_quant] = rep
        if kv_quant == "none":
            calls = ex.calls
        gen_tokens = sum(len(c.tokens) for c in rep.completions)
        whole = sum(len(r.prompt) for r in trace if len(r.prompt) <= CHUNK)
        log(f"[3] {cfg.name} {cfg.n_layers} layers kv_quant={kv_quant}: "
            f"{len(rep.completions)}/{len(trace)} requests, "
            f"{rep.prefill_tokens} prompt tokens ({whole} in "
            f"{rep.prefill_calls} whole-prompt prefill calls, the rest in "
            f"{ex.chunk_calls} chunk calls), {gen_tokens} generated tokens "
            f"in {ex.decodes} decode "
            f"ticks, {rep.ticks} ticks, {dt:.2f}s wall "
            f"({tick_times(ex)}); pool "
            f"{plan['pool_blocks']} blocks (capacity model allows "
            f"{plan['capacity_blocks']} under {HBM_BUDGET:.3e} B), peak "
            f"blocks {rep.peak_blocks}; kernel launches decode {nd} = "
            f"{cfg.n_layers} x {ex.decodes}, prefill {npf} = {cfg.n_layers} "
            f"x {ex.chunk_calls}, flash {nfa} = {cfg.n_layers} x "
            f"{rep.prefill_calls}; audit clean; shapes {shapes[kv_quant]}; "
            f"batch rows holding a request / rows computed at the bucketed "
            f"widths: prefill {ex.rows_real['prefill']}/"
            f"{ex.rows_computed['prefill']}, decode "
            f"{ex.rows_real['decode_compact']}/"
            f"{ex.rows_computed['decode_compact']}, chunk "
            f"{ex.rows_real['chunk']}/{ex.rows_computed['chunk']}")
        del ex
    return trace, context, counts, shapes, plans, peak, reps, calls


# ---------------------------------------------------------------------------
# Phase 4: kernels vs plain versions end to end, 4 layers
# ---------------------------------------------------------------------------

def phase_identity(cfg, params, trace, context, units=4, tag="4",
                   slots=False):
    """The trace at `units` repeats of the unit pattern, every kernel of the
    path against every plain version: through the paged engine, or with
    `slots` through the slot engine."""
    cfg4 = depth_variant(cfg, units)
    p4 = dict(params)
    p4["units"] = [{name: {k: v[:units] for k, v in sub.items()}
                    for name, sub in unit.items()}
                   for unit in params["units"]]
    n_blocks = LANES * (-(-context // KV_BLOCK))
    runs = {}
    for backend in ("kernel", "naive"):
        if slots:
            ex, rep, dt = serve_slots(cfg4, p4, trace, context,
                                      backend=backend, record=True)
        else:
            ex, rep, dt = serve(cfg4, p4, trace, context, n_blocks, "none",
                                backend=backend, record=True)
        runs[backend] = (ex.calls, {c.rid: c.tokens for c in rep.completions})
    (ca, ta), (cb, tb) = runs["kernel"], runs["naive"]
    same = sum(ta[r] == tb[r] for r in ta)
    if len(ca) != len(cb):
        fail("kernel and plain runs made different numbers of calls")
    # The schedule does not depend on token values, so the two runs' calls
    # line up one to one. A row is a FRESH divergence where both runs fed it
    # the same input and chose different tokens (after that the request's
    # inputs differ, and so may everything it emits). Each one is judged.
    fresh = []
    for i, ((fa, tok_a, gap_a, _), (fb, tok_b, gap_b, _)) in enumerate(
            zip(ca, cb)):
        for j in range(len(fa)):
            if fa[j] == fb[j] and tok_a[j] != tok_b[j]:
                fresh.append((i, j, int(tok_a[j]), int(tok_b[j]),
                              float(gap_a[j]), float(gap_b[j])))
    if same != len(ta) and not fresh:
        fail("streams differ but no call diverged on equal inputs")
    worst = max((max(f[4], f[5]) for f in fresh), default=0.0)
    log(f"[{tag}] {cfg4.name}, {cfg4.n_layers} layers, "
        f"{'slot' if slots else 'paged'} engine, kernels vs plain "
        f"versions on the card: {same}/"
        f"{len(ta)} token streams equal; {len(fresh)} fresh divergences "
        f"(same input, different token), largest top-2 gap among them "
        f"{worst:.4f} of the row's logit std (bound {GAP_BOUND})")
    if fresh:
        i, j, a_, b_, ga, gb = fresh[0]
        log(f"[{tag}]   first: call {i} row {j}: kernel token {a_} (gap "
            f"{ga:.4f}), plain token {b_} (gap {gb:.4f})")
    if worst >= GAP_BOUND:
        fail("token divergence at a decided argmax: a fault, not a near-tie")


# ---------------------------------------------------------------------------
# Phase 6: greedy_generate at full width and depth against the engine
# ---------------------------------------------------------------------------

def greedy_subset(trace):
    """The requests phase 6 replays: the first whole-prompt one, the one
    with the shortest prompt, the first with the longest (chunked), and
    the first chunked one shorter than that."""
    lens = {r.rid: len(r.prompt) for r in trace}
    longest = max(lens.values())
    picks = [next(r for r in lens if lens[r] <= CHUNK),
             min(lens, key=lambda r: lens[r]),
             next(r for r in lens if lens[r] == longest),
             next(r for r in lens if CHUNK < lens[r] < longest)]
    return tuple(dict.fromkeys(picks))


def top2_gap(logits):
    """Each row's top-2 logit gap as a fraction of the row's standard
    deviation."""
    lg = logits.float()
    top = lg.topk(2, dim=-1).values
    return ((top[:, 0] - top[:, 1]) / lg.std(dim=-1)).cpu().numpy()


def greedy_gaps(cfg, params, prompt, n_steps, context, settings=None,
                prefix=None):
    """greedy_generate's steps one by one, with row 0's tokens, top-2 gaps
    and logits (on the host). `prompt` [b, p]: every row decodes its own
    argmax. With `prefix` [b, n, d] the prefill takes those prefix
    embeddings before the prompt, and decode starts at position n + p."""
    prefill = SS.make_prefill_step(cfg, settings)
    decode = SS.make_decode_step(cfg, settings)
    b = prompt.shape[0]
    base = prompt.shape[1] + (0 if prefix is None else prefix.shape[1])
    logits, cache = prefill(params, prompt, context=context,
                            prefix_embeds=prefix)
    toks, gaps, rows = [], [], []
    for t in range(n_steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(int(tok[0]))
        gaps.append(float(top2_gap(logits)[0]))
        rows.append(logits[0].float().cpu())
        if t + 1 < n_steps:
            pos = torch.full((b,), base + t, dtype=torch.int32, device=DEV)
            logits, cache = decode(params, tok[:, None], pos, cache,
                                   context=context)
    return toks, gaps, rows


def engine_row(calls, prompt, tokens, d):
    """(gap, logits) of the engine row that chose tokens[d] (phase 3's
    recorded calls): for d = 0 the row fed the whole prompt or its last
    chunk, after that the row fed (tokens[d - 1], its position)."""
    P = tuple(prompt)
    for fed, toks, gap, kept in calls:
        for j, f in enumerate(fed):
            if d == 0:
                hit = (isinstance(f[0], tuple) and f[1] + len(f[0]) == len(P)
                       and f[0] == P[f[1]:])
            else:
                hit = f == (tokens[d - 1], len(P) + d - 1)
            if hit and int(toks[j]) == tokens[d]:
                return float(gap[j]), kept[j]
    fail(f"no engine call chose token {d} of the stream {tokens[:d + 1]}")


def rel_diff(a, b):
    """rms(a - b) / rms spread of a, for two logit rows."""
    return float((a - b).std() / a.std())


def replay_greedy(cfg, params, trace, rids, context):
    """Requests `rids` of the trace through greedy_generate, one at a
    time: ({rid: tokens}, wall seconds)."""
    by_rid = {r.rid: r for r in trace}
    outs = {}
    t0 = time.time()
    for rid in rids:
        req = by_rid[rid]
        prompt = torch.tensor([req.prompt], dtype=torch.int32, device=DEV)
        outs[rid] = SS.greedy_generate(params, cfg, prompt, req.max_new,
                                       context)[0].tolist()
    torch.cuda.synchronize()
    return outs, time.time() - t0


def judge_greedy(tag, cfg, params, trace, rids, outs, dt, eng, calls,
                 context, against, launches):
    """Where a greedy stream `outs[rid]` splits from the engine's `eng[rid]`,
    the rms difference of the two paths' logits at each token up to the
    split (the engine's from its recorded `calls`); fails above
    REL_BOUND."""
    by_rid = {r.rid: r for r in trace}
    judged = []
    for rid in rids:
        g, e = outs[rid], eng[rid]
        if g == e:
            continue
        d = next(i for i in range(len(g)) if g[i] != e[i])
        req = by_rid[rid]
        prompt = torch.tensor([req.prompt], dtype=torch.int32, device=DEV)
        toks, gaps, rows = greedy_gaps(cfg, params, prompt, req.max_new,
                                       context)
        if toks != g:
            fail(f"request {rid}: greedy_generate and its steps one by one "
                 "emit different tokens")
        erows = [engine_row(calls, req.prompt, e, t) for t in range(d + 1)]
        rel = [rel_diff(rows[t], erows[t][1]) for t in range(d + 1)]
        judged.append((rid, d, g[d], e[d], gaps[d], erows[d][0], rel))
    equal = sum(outs[r] == eng[r] for r in rids)
    worst = max((max(j[6]) for j in judged), default=0.0)
    log(f"[{tag}] greedy_generate, {cfg.n_layers} layers, requests "
        f"{list(rids)} (prompts {[len(by_rid[r].prompt) for r in rids]} "
        f"tokens) in {dt:.2f}s: {equal}/{len(rids)} "
        f"streams equal to "
        f"{against}; "
        f"{launches}; largest rms logit difference up to a first "
        f"divergence {worst:.4f} of the logits' rms spread (bound "
        f"{REL_BOUND})")
    for rid, d, a_, b_, ga, ge, rel in judged:
        log(f"[{tag}]   request {rid}: first divergence at token {d}: "
            f"greedy {a_} (top-2 gap {ga:.4f} of its logit std), engine "
            f"{b_} (gap {ge:.4f}); rms logit difference by token 0..{d}: "
            f"{[round(x, 4) for x in rel]}")
    if worst >= REL_BOUND:
        fail("greedy and engine logits apart by more than rounding drift")


def greedy_controls(tag, cfg, params, req, context, n_steps, plain_name,
                    plain):
    """Controls for judge_greedy: the greedy path against itself at batch 2
    (the same prompt twice: other matrix-product shapes, nothing else) and
    with the plain versions `plain` — the drift that roundings alone leave
    at this depth (printed, not asserted)."""
    one = torch.tensor([req.prompt], dtype=torch.int32, device=DEV)
    t1, _, r1 = greedy_gaps(cfg, params, one, n_steps, context)
    for name, (t2, _, r2) in (
            ("at batch 2", greedy_gaps(cfg, params, one.repeat(2, 1),
                                       n_steps, context)),
            (plain_name, greedy_gaps(cfg, params, one, n_steps, context,
                                     plain))):
        n = next((i for i in range(len(t1)) if t1[i] != t2[i]), len(t1))
        rel = [round(rel_diff(r1[t], r2[t]), 4)
               for t in range(min(n + 1, len(t1)))]
        log(f"[{tag}] control, request {req.rid} ({len(req.prompt)} "
            f"tokens): greedy {name} against greedy: tokens equal up to {n} "
            f"of {len(t1)}; rms logit difference by token: {rel}")


def phase_greedy(cfg, params, trace, context, reps, calls):
    rids = greedy_subset(trace)
    by_rid = {r.rid: r for r in trace}
    eng = {c.rid: list(c.tokens) for c in reps["none"].completions}
    _zero_launches()
    outs, dt = replay_greedy(cfg, params, trace, rids, context)
    nfa, nda = flash_attention.launches, decode_attention.launches
    steps = sum(by_rid[r].max_new - 1 for r in rids)
    if (nfa != cfg.n_layers * len(rids) or nda != cfg.n_layers * steps
            or paged_decode.launches or paged_prefill.launches):
        fail(f"greedy launches: flash {nfa} (want {cfg.n_layers} x "
             f"{len(rids)}), ring decode {nda} (want {cfg.n_layers} x "
             f"{steps}), paged decode {paged_decode.launches}, "
             f"paged prefill {paged_prefill.launches} (want 0)")
    judge_greedy("6", cfg, params, trace, rids, outs, dt, eng, calls,
                 context, "the bf16-pool engine's",
                 f"flash launches {nfa} = {cfg.n_layers} x {len(rids)}, "
                 f"ring decode launches {nda} = {cfg.n_layers} x {steps} "
                 f"decode steps")
    req = by_rid[rids[0]]
    greedy_controls("6", cfg, params, req, context, req.max_new,
                    "with the plain attention (prefill and ring decode)",
                    ModelSettings(attn=A.AttnSettings(backend="naive")))
    ref_cache = {(tuple(by_rid[r].prompt), by_rid[r].max_new):
                 np.asarray(outs[r], np.int32) for r in rids}
    t0 = time.time()
    agree = {q: Q.token_agreement(params, cfg, trace, reps[q],
                                  context=context, ref_cache=ref_cache,
                                  device=DEV) for q in ("int8", "none")}
    log(f"[6] token_agreement against greedy_generate, all "
        f"{len(trace)} requests ({time.time() - t0:.2f}s): int8 pool "
        f"{agree['int8'].describe()}, first divergences "
        f"{list(agree['int8'].first_divergence)}; bf16 pool "
        f"{agree['none'].describe()}")
    s = max(len(by_rid[r].prompt) for r in rids)
    return nfa, (1, s), nda


# ---------------------------------------------------------------------------
# Phase 7: xlstm-1.3b at full width and depth (mLSTM + sLSTM lane state)
# ---------------------------------------------------------------------------

XL_SEED = SEED + 5
XL_CONTROL_STEPS = 3


def make_xlstm_trace(cfg):
    """12 requests. Whole prompts (up to CHUNK) of 64, 128 or 256 tokens
    only: a whole prompt of 128 < p <= 256 that 128 does not divide is
    refused by both packages (ROADMAP C, reference fault F6). Chunked
    prompts of 512-2048, two of 1000 among them, so that chunk calls carry
    padded steps through the scan. With this seed eight long prompts
    arrive within three ticks, and a prefill budget of a chunk per lane
    (the capacity plan's prefill_tokens) lets chunk calls reach all 8
    lanes: the scan's serving shape [32, 256, 1024]."""
    return synthetic_trace(12, vocab_size=cfg.vocab_size, seed=SEED + 10,
                           prompt_lens=(64, 128, 256, 512, 1000, 1536, 2048),
                           gen_lens=(16, 24, 32), mean_interarrival=1.0)


def replayable(p):
    """greedy_generate prefills a whole prompt: min(128, p) must divide p."""
    return p <= 128 or p % 128 == 0


def n_mixers(cfg, kind):
    return sum(1 for b in cfg.blocks() if b.mixer == kind)


def phase_xlstm(phases):
    """Phase 7. Returns what the `kernels` line needs of it."""
    cfg = get_config("xlstm-1.3b")
    nm = n_mixers(cfg, "mlstm")
    gen = torch.Generator(device=DEV).manual_seed(XL_SEED)
    t0 = time.time()
    params = init_params(gen, cfg, device=DEV)
    torch.cuda.synchronize()
    leaves = list(tree_leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    f32 = sum(t.numel() * 4 for t in leaves if t.dtype == torch.float32)
    log(f"[7] {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} layers ({nm} "
        f"mLSTM + {n_mixers(cfg, 'slstm')} sLSTM), {cfg.n_heads} heads, "
        f"inner {int(cfg.mlstm_proj_factor * cfg.d_model)}, vocab "
        f"{cfg.vocab_size}: {w_bytes / 1e9:.3f} GB of weights ({f32 / 1e9:.3f}"
        f" GB of it f32 gate leaves) made on the card from seed {XL_SEED} in "
        f"{time.time() - t0:.1f}s")
    trace = make_xlstm_trace(cfg)
    lens = [len(r.prompt) for r in trace]
    if min(lens) > CHUNK or max(lens) <= CHUNK:
        fail("the trace must hold prompts both up to and above the chunk")
    context = trace_context(trace)
    plan = plan_pool(cfg, trace, context, "none")
    sh = dataclasses.replace(ShapeConfig("serve", DECODE, context, LANES),
                             global_batch=LANES)
    lane_pred = LANES * PR.lane_bytes_per_device(
        cfg, sh, PR.MemoryPlan(kv_block_size=KV_BLOCK), MESH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    for mod in KERNEL_MODULES:
        mod.launches = 0
    ex, rep, dt = serve(cfg, params, trace, context, plan["pool_blocks"],
                        "none", record=True, keep_logits=True,
                        prefill_budget=LANES * CHUNK)
    nml = mlstm_scan.launches
    peak = torch.cuda.max_memory_allocated()
    pool_bytes = sum(t.numel() * t.element_size()
                     for P in ex.pool["units"] + ex.pool["tail"]
                     for t in P.values())
    if rep.prefill_calls <= 0 or ex.chunk_calls <= 0:
        fail(f"whole-prompt prefill calls {rep.prefill_calls}, chunk calls "
             f"{ex.chunk_calls}: both paths must run")
    want = nm * (rep.prefill_calls + ex.chunk_calls)
    other = (paged_decode.launches, paged_prefill.launches,
             flash_attention.launches, decode_attention.launches)
    if nml <= 0 or nml != want or ex.decode_mlstm_launches or any(other):
        fail(f"launch counters: mlstm {nml} (want {nm} x "
             f"({rep.prefill_calls} + {ex.chunk_calls}) = {want}), in decode "
             f"ticks {ex.decode_mlstm_launches} (want 0), attention kernels "
             f"{other} (want 0)")
    shapes = {k: sorted(v) for k, v in ex._shapes.items()}
    gen_tokens = sum(len(c.tokens) for c in rep.completions)
    log(f"[7] {cfg.name} {cfg.n_layers} layers: {len(rep.completions)}/"
        f"{len(trace)} requests, {rep.prefill_tokens} prompt tokens "
        f"({rep.prefill_calls} whole-prompt prefill calls, {ex.chunk_calls} "
        f"chunk calls), {gen_tokens} generated tokens in {ex.decodes} decode "
        f"ticks, {rep.ticks} ticks, {dt:.2f}s wall "
        f"({tick_times(ex)}); allocator "
        f"{plan['pool_blocks']} blocks (nothing paged; capacity model "
        f"allows {plan['capacity_blocks']}); mlstm launches {nml} = {nm} x "
        f"({rep.prefill_calls} + {ex.chunk_calls}), 0 in decode ticks; "
        f"audit clean; shapes {shapes}")
    pred = plan["resident"] + plan["transient"]
    log(f"[7] WSMC: predicted resident {plan['resident'] / 1e9:.3f} GB (lane "
        f"state {lane_pred / 1e9:.3f} GB = {LANES} lanes x "
        f"{lane_pred / LANES / 1e9:.4f} GB) + transient "
        f"{plan['transient'] / 1e9:.3f} GB = {pred / 1e9:.3f} GB; measured: "
        f"pool leaves {pool_bytes / 1e9:.3f} GB, "
        f"torch.cuda.max_memory_allocated() {peak / 1e9:.3f} GB (weights "
        f"{w_bytes / 1e9:.3f} GB, allocated before the run "
        f"{base_alloc / 1e9:.3f} GB); measured / predicted = "
        f"{peak / pred:.4f}")
    calls = ex.calls
    del ex
    t0 = time.time()
    greedy_s = xlstm_greedy(cfg, params, trace, context, rep, calls)
    log(f"[7] greedy replay {time.time() - t0:.2f}s")
    if 4 in phases:
        t0 = time.time()
        phase_identity(cfg, params, trace, context, units=1, tag="7")
        log(f"[7] 8-layer kernel-vs-plain runs {time.time() - t0:.2f}s")
    chunk_w = max(w for w, _ in shapes["chunk"])
    layer_times(cfg, params, chunk_w)
    big = max([(4 * chunk_w, CHUNK)]
              + [(4 * w, p) for w, p in shapes["prefill"]],
              key=lambda x: x[0] * x[1])
    return {"launches": nml, "largest": big, "greedy": greedy_s}


def xlstm_greedy(cfg, params, trace, context, rep, calls):
    """A subset of the trace through greedy_generate at full width and
    depth, held against the engine's streams; where one splits, the rms
    difference of the two paths' logits is judged as phase 6 does."""
    nm = n_mixers(cfg, "mlstm")
    lens = {r.rid: len(r.prompt) for r in trace}
    ok = [r for r in lens if replayable(lens[r])]
    longest = max(lens[r] for r in ok)
    picks = [next(r for r in ok if lens[r] <= CHUNK),
             next(r for r in ok if lens[r] == longest),
             next((r for r in ok if CHUNK < lens[r] < longest), ok[0])]
    rids = tuple(dict.fromkeys(picks))
    eng = {c.rid: list(c.tokens) for c in rep.completions}
    mlstm_scan.launches = 0
    outs, dt = replay_greedy(cfg, params, trace, rids, context)
    if mlstm_scan.launches != nm * len(rids):
        fail(f"greedy mlstm launches {mlstm_scan.launches} (want {nm} x "
             f"{len(rids)})")
    judge_greedy("7", cfg, params, trace, rids, outs, dt, eng, calls,
                 context, "the engine's",
                 f"mlstm launches {nm} x {len(rids)}")
    # controls on the longest replayed prompt (chunked in the engine), its
    # first XL_CONTROL_STEPS tokens
    req = next(r for r in trace if r.rid == picks[1])
    greedy_controls("7", cfg, params, req, context,
                    min(XL_CONTROL_STEPS, req.max_new), "with the plain scan",
                    SETTINGS["naive"])
    return dt


def host_ms(fn, reps):
    """Wall time of fn() on the host clock, ending in a synchronize: what a
    caller waits for, launch overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t0) / reps * 1e3


def layer_times(cfg, params, w):
    """Where a chunk call and a decode tick spend their time: one mLSTM and
    one sLSTM block at [w, CHUNK] and [w, 1] (host clock, synchronised), and
    the gather and scatter of w lanes' state (CUDA events)."""
    x = torch.randn((w, CHUNK, cfg.d_model), device=DEV).to(torch.bfloat16)
    pos = torch.arange(CHUNK, dtype=torch.int32, device=DEV)[None].repeat(
        w, 1)
    pm = {k: v[0] for k, v in params["units"][0]["mixer"].items()}
    ps = {k: v[0] for k, v in params["units"][7]["mixer"].items()}
    sm = R.mlstm_state_init(cfg, w, DEV)
    ss = R.slstm_state_init(cfg, w, DEV)
    t = {
        "mlstm chunk": host_ms(lambda: R.mlstm_apply(
            pm, cfg, x, state=sm, positions=pos), 3),
        "slstm chunk": host_ms(lambda: R.slstm_apply(
            ps, cfg, x, state=ss, positions=pos), 2),
        "mlstm decode": host_ms(lambda: R.mlstm_apply(
            pm, cfg, x[:, :1], state=sm, decode=True), 10),
        "slstm decode": host_ms(lambda: R.slstm_apply(
            ps, cfg, x[:, :1], state=ss, decode=True), 10),
    }
    pool = SS.init_paged_pool(cfg, LANES, 2, KV_BLOCK, KV_BLOCK, device=DEV)
    log(f"[7] per block at width {w} (host ms, synchronised): " + ", ".join(
        f"{k} {v:.3f}" for k, v in t.items()) + f"; a step runs "
        f"{n_mixers(cfg, 'mlstm')} mLSTM + {n_mixers(cfg, 'slstm')} sLSTM "
        f"blocks; " + lane_copies(pool, w))
    del pool


def lane_copies(pool, w):
    """The gather and the scatter of w lanes' per-lane leaves of a paged
    pool, each timed with CUDA events: a line for the log."""
    ids = torch.arange(w, dtype=torch.int32, device=DEV)
    sub = SS.gather_pool_lanes(pool, ids)
    nbytes = sum(v.numel() * v.element_size()
                 for P, Q in zip(sub["units"] + sub["tail"],
                                 pool["units"] + pool["tail"])
                 if P is not Q for v in P.values())
    g = time_ms(lambda: SS.gather_pool_lanes(pool, ids), 3)
    sc = time_ms(lambda: SS.scatter_pool_lanes(pool, sub, ids), 3)
    del sub
    return (f"gather of {w} lanes' per-lane leaves ({nbytes / 1e9:.3f} GB) "
            f"{g:.3f} ms, scatter {sc:.3f} ms (each "
            f"{nbytes / (g * 1e-3) / 1e12:.2f} / "
            f"{nbytes / (sc * 1e-3) / 1e12:.2f} TB/s read + written)")


# ---------------------------------------------------------------------------
# Phases 9 and 10: ring/slot serving and windowed layers (gemma3-12b,
# recurrentgemma-9b) at full width and depth
# ---------------------------------------------------------------------------

# the context the deployment reserves: gemma3-12b's local layers are rings
# of 1024 and its global ones span the context; recurrentgemma-9b's
# window-2048 layers are rings (a layer pages only when its ring spans the
# context)
RING_CONTEXT = 4096


def serve_slots(cfg, params, trace, context, backend="kernel", record=False):
    """The trace through the slot engine (continuous policy) and
    TorchExecutor on LANES slots."""
    cls = RecordingSlotExecutor if record else ClockedSlotExecutor
    ex = cls(params, cfg, n_slots=LANES, context=context,
             settings=SETTINGS[backend], device=DEV)
    if not all(t.device.type == DEV.type for P in ex.pool["units"]
               for t in P.values()):
        fail("the slot pool is not on the card")
    t0 = time.time()
    rep = Engine(ex, LANES).run(trace)
    torch.cuda.synchronize()
    dt = time.time() - t0
    if len(rep.completions) != len(trace):
        fail(f"{len(rep.completions)} of {len(trace)} requests completed")
    for c in rep.completions:
        if len(c.tokens) != trace[c.rid].max_new or \
                not all(0 <= t < cfg.padded_vocab_size for t in c.tokens):
            fail(f"request {c.rid}: bad token stream {c.tokens}")
    return ex, rep, dt


def plan_slots(cfg, trace, context):
    """The capacity model's terms for the slot pool of LANES slots (every
    attention layer a ring, nothing paged): the slots it allows under
    HBM_BUDGET, and resident + transient at LANES slots, the transient the
    larger of a decode tick's and a whole-prompt prefill's of the longest
    prompt at the pool's width (the slot engine pads every prefill to
    it)."""
    plan = PR.MemoryPlan()
    shape = ShapeConfig("serve", DECODE, context, LANES)
    cap = PR.serving_capacity(cfg, shape, plan, WORKLOAD, MESH, hw=HW.H100,
                              hbm_budget=HBM_BUDGET)
    longest = max(len(r.prompt) for r in trace)
    tra = max(PR.transient_bytes(cfg, shape, plan, WORKLOAD, MESH),
              PR.prefill_transient_bytes(cfg, shape, plan, WORKLOAD, MESH,
                                         prefill_tokens=LANES * longest,
                                         reach=longest, width=LANES,
                                         kernel="tiled"))
    return {"capacity_slots": int(cap),
            "resident": float(PR.resident_bytes(cfg, shape, plan, MESH)),
            "transient": float(tra),
            "caches": float(PR.cache_bytes_per_device(cfg, shape, plan,
                                                      MESH))}


def launch_counts():
    return {m.__name__.rsplit(".", 1)[-1]: m.launches
            for m in KERNEL_MODULES}


def check_launches(tag, what, got, want):
    """Every kernel's launch count equals `want` (0 where not named)."""
    full = {k: want.get(k, 0) for k in got}
    if got != full or not any(full.values()):
        fail(f"[{tag}] {what}: launches {got}, want {full}")


def phase_ring_model(arch, tag, seed, trace):
    """Phase 9 (gemma3-12b) or 10 (recurrentgemma-9b): the trace through
    the slot engine, then the compacted chunked paged engine; launch
    counters zeroed just before and read just after each, counts asserted
    exactly; memory beside the capacity model's prediction; the trace
    again at one unit (plus the tail) through the kernels and through the
    plain versions, on both engines. Returns what the `kernels` line
    needs."""
    cfg = get_config(arch)
    left = torch.cuda.memory_allocated()
    if left > 1e9:
        fail(f"[{tag}] earlier phases left {left / 1e9:.3f} GB allocated: "
             "the memory measured here would count it")
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.time()
    params = init_params(gen, cfg, device=DEV)
    torch.cuda.synchronize()
    w_bytes = _bytes_of(params)
    context = RING_CONTEXT
    attn = [b for b in cfg.blocks() if b.is_attn]
    n_paged = sum(SS.is_paged_block(b, context) for b in attn)
    n_ring = len(attn) - n_paged
    rings = sorted({b.cache_len(context) for b in attn
                    if not SS.is_paged_block(b, context)})
    log(f"[{tag}] {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} layers "
        f"({len(attn)} attention: {n_paged} paged at context {context}, "
        f"{n_ring} per-lane rings of {rings}), {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv heads x {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}: {w_bytes / 1e9:.3f} GB of "
        f"weights made on the card from seed {seed} in "
        f"{time.time() - t0:.1f}s")
    lens = [len(r.prompt) for r in trace]
    if min(lens) > CHUNK or max(lens) <= max(rings):
        fail("the trace must hold whole prompts and prompts longer than "
             "the rings")
    out = {"cfg": cfg}

    # (a) the slot engine: every attention layer a ring
    slot = plan_slots(cfg, trace, context)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    ex, rep, dt = serve_slots(cfg, params, trace, context)
    got = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches(tag, "slot engine", got, {
        "decode_attention": len(attn) * ex.decodes,
        "flash_attention": len(attn) * rep.prefill_calls})
    gen_tokens = sum(len(c.tokens) for c in rep.completions)
    pool_bytes = _bytes_of(ex.pool)
    log(f"[{tag}] (a) slot engine, {cfg.n_layers} layers: "
        f"{len(rep.completions)}/{len(trace)} requests, {rep.prefill_tokens} "
        f"prompt tokens in {rep.prefill_calls} whole-prompt prefill calls "
        f"(each padded to {LANES} rows), {gen_tokens} generated tokens in "
        f"{ex.decodes} decode ticks at width {LANES}, {rep.ticks} ticks, "
        f"{dt:.2f}s wall; {tick_times(ex)}; ring decode "
        f"launches "
        f"{got['decode_attention']} = {len(attn)} x {ex.decodes}, flash "
        f"{got['flash_attention']} = {len(attn)} x {rep.prefill_calls}")
    pred = slot["resident"] + slot["transient"]
    log(f"[{tag}] (a) WSMC slot plan: the capacity model allows "
        f"{slot['capacity_slots']} slots under {HBM_BUDGET:.3e} B; at "
        f"{LANES}: predicted resident {slot['resident'] / 1e9:.3f} GB (rings "
        f"and states {slot['caches'] / 1e9:.3f} GB) + transient "
        f"{slot['transient'] / 1e9:.3f} GB = {pred / 1e9:.3f} GB; measured: "
        f"slot pool {pool_bytes / 1e9:.3f} GB, "
        f"torch.cuda.max_memory_allocated() {peak / 1e9:.3f} GB (weights "
        f"{w_bytes / 1e9:.3f} GB); measured / predicted = {peak / pred:.4f}")
    out["slot"] = {"launches": got["decode_attention"],
                   "flash": got["flash_attention"]}
    slot_streams = {c.rid: c.tokens for c in rep.completions}
    del ex

    # (b) the compacted chunked paged engine: full-context layers page,
    # windowed ones keep per-lane rings
    plan = plan_pool(cfg, trace, context, "none")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    ex, rep, dt = serve(cfg, params, trace, context, plan["pool_blocks"],
                        "none")
    got = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches(tag, "paged engine", got, {
        "paged_decode": n_paged * ex.decodes,
        "paged_prefill": n_paged * ex.chunk_calls,
        "decode_attention": n_ring * ex.decodes,
        "flash_attention": len(attn) * rep.prefill_calls})
    if rep.prefill_calls <= 0 or ex.chunk_calls <= 0:
        fail(f"whole-prompt prefill calls {rep.prefill_calls}, chunk calls "
             f"{ex.chunk_calls}: both paths must run")
    same = sum(slot_streams[c.rid] == c.tokens for c in rep.completions)
    shapes = {k: sorted(v) for k, v in ex._shapes.items()}
    leaves = ([(P, 1) for P in ex.pool["units"]]
              + [(P, 0) for P in ex.pool["tail"]])
    lane_leaves = [P for P, ax in leaves if "kb" not in P]
    if any(t.shape[ax] != LANES for P, ax in leaves if "kb" not in P
           for t in P.values()):
        fail("a per-lane pool leaf has no lane axis of the pool's width")
    n_rec = sum(1 for P in lane_leaves if "pos" not in P)
    log(f"[{tag}] (b) paged engine, {cfg.n_layers} layers: "
        f"{len(rep.completions)}/{len(trace)} requests, {rep.prefill_tokens} "
        f"prompt tokens ({rep.prefill_calls} whole-prompt prefill calls, "
        f"{ex.chunk_calls} chunk calls), {ex.decodes} compacted decode "
        f"ticks, {rep.ticks} ticks, {dt:.2f}s wall; "
        f"{tick_times(ex)}; "
        f"launches paged decode "
        f"{got['paged_decode']} = {n_paged} x {ex.decodes}, paged prefill "
        f"{got['paged_prefill']} = {n_paged} x {ex.chunk_calls}, ring decode "
        f"{got['decode_attention']} = {n_ring} x {ex.decodes}, flash "
        f"{got['flash_attention']} = {len(attn)} x {rep.prefill_calls}; "
        f"audit clean; {same}/{len(trace)} streams equal to the slot "
        f"engine's; pool: {len(leaves) - len(lane_leaves)} paged leaf "
        f"groups, {len(lane_leaves) - n_rec} per-lane rings, {n_rec} "
        f"per-lane recurrent states (unit leaves stacked over "
        f"{cfg.repeats} repeats); shapes {shapes}")
    pred = plan["resident"] + plan["transient"]
    lane = LANES * PR.lane_bytes_per_device(
        cfg, dataclasses.replace(ShapeConfig("serve", DECODE, context, LANES),
                                 global_batch=LANES),
        PR.MemoryPlan(kv_block_size=KV_BLOCK), MESH)
    log(f"[{tag}] (b) WSMC paged plan: pool {plan['pool_blocks']} blocks "
        f"(capacity model allows {plan['capacity_blocks']}); predicted "
        f"resident {plan['resident'] / 1e9:.3f} GB (per-lane rings and "
        f"states {lane / 1e9:.3f} GB = {LANES} lanes x "
        f"{lane / LANES / 1e9:.4f} GB) + transient "
        f"{plan['transient'] / 1e9:.3f} GB = {pred / 1e9:.3f} GB; "
        f"torch.cuda.max_memory_allocated() {peak / 1e9:.3f} GB; measured / "
        f"predicted = {peak / pred:.4f}")
    log(f"[{tag}] (b) lane copies of a compacted step at width {LANES}: "
        + lane_copies(ex.pool, LANES))
    out["paged"] = {"launches": got["decode_attention"]}
    del ex
    torch.cuda.empty_cache()

    # the trace at one unit (and the tail), kernels against plain versions
    t0 = time.time()
    phase_identity(cfg, params, trace, context, units=1, tag=tag, slots=True)
    phase_identity(cfg, params, trace, context, units=1, tag=tag)
    log(f"[{tag}] {depth_variant(cfg, 1).n_layers}-layer kernel-vs-plain "
        f"runs {time.time() - t0:.2f}s")
    del params
    torch.cuda.empty_cache()
    return out


def make_gemma3_trace(cfg):
    """16 requests: whole prompts (up to CHUNK) and chunked ones up to 2048,
    longer than the local rings of 1024 (they wrap during prefill); 1010
    tokens plus 16-32 new ones wrap them at decode."""
    return synthetic_trace(16, vocab_size=cfg.vocab_size, seed=SEED + 9,
                           prompt_lens=(64, 200, 256, 520, 1010, 2048),
                           gen_lens=(16, 24, 32), mean_interarrival=2.0)


def make_rgemma_trace(cfg):
    """12 requests: whole prompts (up to CHUNK) and chunked ones up to
    3000, longer than the window-2048 rings (they wrap during prefill);
    2030 tokens plus 24-32 new ones wrap them at decode."""
    return synthetic_trace(12, vocab_size=cfg.vocab_size, seed=SEED + 11,
                           prompt_lens=(64, 200, 256, 700, 1500, 2030,
                                        3000),
                           gen_lens=(24, 32), mean_interarrival=2.0)


# ---------------------------------------------------------------------------
# Phase 8: training h2o-danube-1.8b at full width and depth
# ---------------------------------------------------------------------------

TR_ARCH = "h2o-danube-1.8b"
TR_SEED = SEED + 8
TR_SEQ, TR_BATCH = 2048, 4
TR_LR = 1e-4
# (optimizer, remat, microbatches, steps): the main run first, then one
# further plan per memory knob
TR_PLANS = (("adamw_f32", "none", 1, 6), ("adamw_f32", "full", 1, 2),
            ("adamw_f32", "dots", 1, 2), ("adamw_f32", "none", 2, 2),
            ("adafactor", "none", 1, 2))
# The 2-layer check: one step's gradients through the flash kernels against
# those through the plain dense attention (AttnSettings(backend="naive")),
# from the same bf16 parameters and batch. Each path rounds its attention
# output and its dq / dk / dv to bf16 (2^-8 of the value each) and the
# backward carries the roundings through two layers and the bf16 residual
# stream: per leaf, ||g_kernel - g_plain|| / ||g_plain|| near 1e-2 is
# rounding; a kernel that drops or misplaces pairs moves whole rows of the
# gradient, far above 5e-2.
REL_GRAD_BOUND = 0.05
# ... and its loss: a mean over 8192 tokens of f32 log-softmax terms whose
# logits differ by the forward's bf16 roundings alone; they read 1.6e-6 of
# the loss apart (10.066322 / 10.066306, NVIDIA H100 80GB HBM3, 700.00 W).
# A kernel that attends to wrong rows moves the loss by far more.
REL_LOSS_BOUND = 1e-4


def train_class(cfg):
    """The class the simulator's two-point ladder (seq 64, 128) assigns
    phase 8's training step (Expanding.Medium, alpha 29.79): phase 8's
    predictions are made under it, as the trainer's on --backend
    simulate."""
    shape = ShapeConfig("train", TRAIN, TR_SEQ, TR_BATCH)
    return PF.classify_workload(cfg, shape, MESH, n_points=2,
                                base_seq=min(64, TR_SEQ),
                                measurer=MM.SimulatedMeasurer(MESH))


def _bytes_of(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def train_plan(cfg, params, pipe, kind, remat, micro, steps):
    """`steps` steps of run_train_loop under one memory plan, a fresh
    optimizer state; returns what the log and the checks need."""
    tcfg = TS.TrainStepConfig(
        remat=remat, microbatches=micro,
        optimizer=OPT.OptimizerConfig(kind=kind, lr=TR_LR),
        warmup_steps=2, total_steps=max(steps, 3))
    step_fn = TS.make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    st = OPT.init_state(tcfg.optimizer, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    _zero_launches()
    t0 = time.time()

    def on_metrics(i, m):
        times.append(time.time())
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            fail(f"training plan {kind}/{remat}/{micro}: step {i} loss "
                 f"{m['loss']} grad_norm {m['grad_norm']}")

    _, _, done, hist = FT.run_train_loop(
        train_step=step_fn, params=params, opt_state=st, pipeline=pipe,
        n_steps=steps, on_metrics=on_metrics)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    opt_bytes = _bytes_of(st)
    del st
    if done != steps or len(hist) != steps:
        fail(f"training plan {kind}/{remat}/{micro}: {done} of {steps} "
             "steps")
    n = cfg.n_layers * steps
    want_f = n * micro * (2 if remat in ("full", "dots") else 1)
    want_b = n * micro
    if (launches["flash_attention"] != want_f
            or launches["flash_attention_bwd"] != want_b
            or any(launches[k] for k in ("paged_decode", "paged_prefill",
                                         "mlstm_scan", "decode_attention"))):
        fail(f"training plan {kind}/{remat}/{micro}: launches {launches}, "
             f"want flash forward {want_f} (= {cfg.n_layers} x {steps} x "
             f"{micro}{' x 2, recomputed' if want_f > want_b else ''}), "
             f"backward {want_b}, nothing else")
    shape = ShapeConfig("train", TRAIN, TR_SEQ, TR_BATCH)
    res, tra = LT.predicted_bytes(cfg, shape, PR.MemoryPlan(
        remat=remat, microbatches=micro, optimizer=kind), train_class(cfg),
        MESH)
    step_s = [b - a for a, b in zip([t0] + times[:-1], times)]
    return {"plan": f"{kind}/remat={remat}/microbatches={micro}",
            "steps": steps, "loss": [h["loss"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist],
            "step_s": step_s, "wall": wall,
            "fwd": launches["flash_attention"],
            "bwd": launches["flash_attention_bwd"],
            "peak": peak, "resident": res, "transient": tra,
            "opt_bytes": opt_bytes}


def grad_check_2layers(cfg, params, batch):
    """Phase 8's kernel-vs-plain check at 2 layers and full width: loss and
    per-leaf relative gradient difference of one step."""
    cfg2 = depth_variant(cfg, 2)
    p2 = dict(params)
    p2["units"] = [{name: {k: v[:2] for k, v in sub.items()}
                    for name, sub in unit.items()} for unit in params["units"]]
    out = {}
    for backend in ("kernel", "naive"):
        tcfg = TS.TrainStepConfig(settings=ModelSettings(
            attn=A.AttnSettings(backend=backend)))
        (_, met), g = TS.value_and_grad(TS.make_loss_fn(cfg2, tcfg))(p2,
                                                                     batch)
        out[backend] = (float(met["loss"]), g)
        torch.cuda.synchronize()
    (lk, gk), (ln, gn) = out["kernel"], out["naive"]
    worst, where = 0.0, None
    for (path, a), (_, b) in zip(tree_paths(gk), tree_paths(gn)):
        if not torch.isfinite(a.float()).all():
            fail(f"2-layer check: kernel gradient {path} not finite")
        den = float(b.float().norm())
        rel = float((a.float() - b.float()).norm()) / max(den, 1e-30)
        if rel > worst:
            worst, where = rel, "/".join(map(str, path))
    return lk, ln, worst, where


def phase_train():
    """Phase 8. Returns what the `kernels` line needs of it."""
    cfg = get_config(TR_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(TR_SEED)
    t0 = time.time()
    params = init_params(gen, cfg, device=DEV)
    torch.cuda.synchronize()
    w_bytes = _bytes_of(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[8] {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} layers, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"window {cfg.unit[0].window}: {n_params:,} parameters, "
        f"{w_bytes / 1e9:.3f} GB of bf16 weights made on the card from seed "
        f"{TR_SEED} in {time.time() - t0:.1f}s")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TR_SEQ, global_batch=TR_BATCH,
                                    seed=TR_SEED))
    runs = []
    for kind, remat, micro, steps in TR_PLANS:
        r = train_plan(cfg, params, pipe, kind, remat, micro, steps)
        runs.append(r)
        pred = r["resident"] + r["transient"]
        log(f"[8] plan {r['plan']}: {steps} steps of [{TR_BATCH}, {TR_SEQ}] "
            f"tokens in {r['wall']:.2f}s (per step "
            f"{[round(x, 3) for x in r['step_s']]} s); "
            f"loss "
            f"{[round(x, 4) for x in r['loss']]}; grad_norm "
            f"{[round(x, 4) for x in r['grad_norm']]}; flash launches "
            f"forward {r['fwd']}, backward {r['bwd']}")
        log(f"[8] WSMC plan {r['plan']}: predicted resident "
            f"{r['resident'] / 1e9:.3f} GB + transient "
            f"{r['transient'] / 1e9:.3f} GB = {pred / 1e9:.3f} GB; "
            f"torch.cuda.max_memory_allocated() {r['peak'] / 1e9:.3f} GB "
            f"(weights {w_bytes / 1e9:.3f} GB, optimizer state "
            f"{r['opt_bytes'] / 1e9:.3f} GB); measured / predicted = "
            f"{r['peak'] / pred:.4f}")
    torch.cuda.empty_cache()
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in pipe.batch_at(0).items()}
    t0 = time.time()
    lk, ln, worst, where = grad_check_2layers(cfg, params, batch)
    log(f"[8] 2 layers at full width, one step through the flash kernels "
        f"and through the plain dense attention ({time.time() - t0:.2f}s): "
        f"loss {lk:.6f} / {ln:.6f} (relative difference "
        f"{abs(lk - ln) / abs(ln):.4e}, bound {REL_LOSS_BOUND}); largest "
        f"per-leaf relative gradient difference {worst:.4e} at {where} "
        f"(bound {REL_GRAD_BOUND})")
    if not (np.isfinite(lk) and abs(lk - ln) <= REL_LOSS_BOUND * abs(ln)):
        fail(f"2-layer check: loss {lk} through the kernels, {ln} plain")
    if worst > REL_GRAD_BOUND:
        fail("2-layer check: kernel gradients apart from the plain "
             "attention's by more than bf16 roundings")
    main_run = runs[0]
    return {"fwd": main_run["fwd"], "bwd": main_run["bwd"],
            "steps": main_run["steps"], "cfg": cfg}


# ---------------------------------------------------------------------------
# Kernel timings at the main path's shapes, and the `kernels` line
# ---------------------------------------------------------------------------

def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def pool_row_bytes(cfg, codec):
    """Stored bytes of one (position, kv head) row of K or V, scale
    included."""
    hd = cfg.resolved_head_dim
    return {"bf16": 2 * hd, "int8": hd + 4, "int4": hd // 2 + 4}[codec]


def time_decode(cfg, gen, w, mb, codec, plain=True):
    """Paged decode at w lanes whose tables hold mb blocks, every lane at
    mb * KV_BLOCK - 3 positions (the most a call of that shape reads): the
    kernel (and, with `plain`, its plain version; else None), and the bytes
    and operations the function needs for these inputs."""
    K, G, hd = cfg.n_kv_heads, cfg.q_group, cfg.resolved_head_dim
    n = mb * KV_BLOCK - 3
    lens = [n] * w
    cache, tables = make_pool(gen, lens=lens, K=K, hd=hd, bs=KV_BLOCK,
                              m_blocks=mb, codec=codec)
    positions = torch.full((w,), n - 1, dtype=torch.int32, device=DEV)
    q = torch.randn((w, K, G, hd), generator=gen, device=DEV).to(
        torch.bfloat16)
    ks, vs = scales_of(cache)
    args = (q, cache["kb"], cache["vb"], cache["pos"], tables, positions)
    kw = dict(k_scales=ks, v_scales=vs)
    ms = time_ms(lambda: paged_decode.paged_decode_attention(*args, **kw), 20)
    if plain:
        plain = time_ms(
            lambda: paged_decode.paged_decode_attention_plain(*args, **kw), 5)
    rows = w * n
    nbytes = (rows * K * 2 * pool_row_bytes(cfg, codec) + rows * 4
              + 2 * q.numel() * 2 + tables.numel() * 4 + w * 4)
    flops = 4.0 * rows * K * G * hd
    return ms, plain, nbytes, flops


def time_prefill(cfg, gen, w, mb, codec, plain=True):
    """Paged prefill of a CHUNK-token chunk at w lanes whose tables hold mb
    blocks, every lane's history filling them (the most a call of that
    shape reads): the kernel (and, with `plain`, its plain version; else
    None), and the bytes and operations the function needs."""
    K, G, hd = cfg.n_kv_heads, cfg.q_group, cfg.resolved_head_dim
    C = CHUNK
    hist = max(mb * KV_BLOCK - C, 0)
    cache, tables = make_pool(gen, lens=[hist + C] * w, K=K, hd=hd,
                              bs=KV_BLOCK, m_blocks=mb, codec=codec)
    positions = (hist + torch.arange(C, dtype=torch.int32, device=DEV)
                 )[None].repeat(w, 1)
    q = torch.randn((w, C, K, G, hd), generator=gen, device=DEV).to(
        torch.bfloat16)
    kn = torch.randn((w, C, K, hd), generator=gen, device=DEV).to(
        torch.bfloat16)
    vn = torch.randn((w, C, K, hd), generator=gen, device=DEV).to(
        torch.bfloat16)
    ks, vs = scales_of(cache)
    args = (q, kn, vn, cache["kb"], cache["vb"], cache["pos"], tables,
            positions)
    kw = dict(k_scales=ks, v_scales=vs)
    ms = time_ms(lambda: paged_prefill.paged_prefill_attention(*args, **kw), 5)
    if plain:
        plain = time_ms(
            lambda: paged_prefill.paged_prefill_attention_plain(*args, **kw),
            3)
    row = pool_row_bytes(cfg, codec)
    # read: q, k_new, v_new, the history rows, tables, positions; written:
    # o and the chunk's rows (payload, scales, positions)
    nbytes = (2 * q.numel() * 2 + 2 * kn.numel() * 2
              + w * hist * (K * 2 * row + 4) + w * C * (K * 2 * row + 4)
              + tables.numel() * 4 + positions.numel() * 4)
    visible = sum(hist + c + 1 for c in range(C))      # causal, per lane
    flops = 4.0 * w * visible * K * G * hd
    return ms, plain, nbytes, flops


def time_flash(cfg, gen, w, s, window=None):
    """Flash attention at [w, s] causal (under `window` if given), cfg's
    heads, bf16: the kernel, its plain version and
    scaled_dot_product_attention (the one PyTorch call that computes the
    same function, with is_causal or the equivalent boolean mask; timed
    here, never called by the port), and the bytes and operations the
    function needs for these inputs."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.randn((w, s, H, hd), generator=gen, device=DEV).to(
        torch.bfloat16)
    k = torch.randn((w, s, K, hd), generator=gen, device=DEV).to(
        torch.bfloat16)
    v = torch.randn((w, s, K, hd), generator=gen, device=DEV).to(
        torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device=DEV)[None].repeat(w, 1)
    args = (q, k, v, pos, pos)
    kw = dict(window=window)
    ms = time_ms(lambda: flash_attention.flash_attention_fwd(*args, **kw), 10)
    plain = time_ms(
        lambda: flash_attention.flash_attention_plain(*args, **kw), 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None or window >= s:
        mask = dict(is_causal=True)
    else:
        i = torch.arange(s, device=DEV)
        mask = dict(attn_mask=(i[None] <= i[:, None])
                    & (i[None] > i[:, None] - window))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **mask)

    lib = time_ms(sdpa, 10)
    dev = float((sdpa().transpose(1, 2).float()
                 - flash_attention.flash_attention_plain(*args, **kw).float()
                 ).abs().max())
    # q, k, v read once, o written once, both position vectors read
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 2 * pos.numel() * 4
    # two products of 2 * hd operations per visible pair and query head
    flops = 4.0 * hd * H * visible_pairs(pos, pos, window=window)
    return ms, plain, lib, dev, nbytes, flops


def visible_pairs(qpos, kpos, window=None, chunk=None):
    """(query, key) pairs the position mask lets through, summed over the
    batch rows: the work the attention of these inputs needs."""
    return int(A._mask(qpos, kpos, BlockSpec(window=window,
                                             chunk=chunk)).sum())


def time_flash_bwd(cfg, gen, w, s):
    """The flash backward at [w, s] causal under cfg's window, its heads,
    bf16: the kernels (D computed first, as the wrapper does), the plain
    version, and the backward of scaled_dot_product_attention(is_causal,
    enable_gqa) (the one PyTorch call that computes the same function;
    timed here, never called by the port); the bytes and operations the
    function needs for these inputs."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    window = cfg.unit[0].window
    bf = torch.bfloat16
    q = torch.randn((w, s, H, hd), generator=gen, device=DEV).to(bf)
    k = torch.randn((w, s, K, hd), generator=gen, device=DEV).to(bf)
    v = torch.randn((w, s, K, hd), generator=gen, device=DEV).to(bf)
    do = torch.randn((w, s, H, hd), generator=gen, device=DEV).to(bf)
    pos = torch.arange(s, dtype=torch.int32, device=DEV)[None].repeat(w, 1)
    out, lse = flash_attention.flash_attention_fwd(
        q, k, v, pos, pos, window=window, return_lse=True)
    args = (q, k, v, out, lse, do, pos, pos)
    ms = time_ms(lambda: flash_attention_bwd.flash_attention_bwd(
        *args, window=window), 5)
    plain = time_ms(lambda: flash_attention_bwd.flash_attention_bwd_plain(
        *args, window=window), 2)
    got = flash_attention_bwd.flash_attention_bwd(*args, window=window)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    lib = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                              retain_graph=True), 5)
    lib_g = torch.autograd.grad(lib_out, (qt, kt, vt), dot)
    dev = max(float((a.transpose(1, 2).float() - b.float()).abs().max())
              for a, b in zip(lib_g, got))
    # read: q, k, v, out, dO (bf16), lse (f32), both position vectors;
    # written: dq, dk, dv
    nbytes = (2 * (3 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
              + 2 * 4 * pos.numel() + 2 * (q.numel() + 2 * k.numel()))
    pairs = visible_pairs(pos, pos, window=window)
    # five products of 2 * hd operations per visible pair and query head:
    # s = q k^T, dO v^T, dv = p^T dO, dq = ds k, dk = ds^T q
    flops = 10.0 * hd * H * pairs
    return ms, plain, lib, dev, nbytes, flops, pairs


def flash_row(name, src, replaces, launches, err, timed, shape, **extra):
    """A flash kernel's `kernels` row from its timing (ms, plain, library
    ms, library deviation, bytes, operations): the bound, the achieved
    TFLOP/s (the visible pairs' operations over the kernel's time) and its
    share of the card's 989 TFLOP/s."""
    ms, plain, lib, dev, nbytes, flops = timed[:6]
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    rate = flops / (ms * 1e-3)
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib, "library_max_abs_dev": dev, "shape": shape,
            "bytes": nbytes, "operations": flops,
            "tflops": rate / 1e12, "share_of_peak": rate / PEAK_BF16_FLOPS,
            **extra}


SRC_FA = "src/repro_torch/kernels/csrc/flash_attention.cu"
SRC_FB = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
REPL_FA = "src/repro/kernels/flash_attention.py:111"
REPL_FB = "src/repro/kernels/flash_attention_bwd.py:170"


def slot_prefill_row(cfg, launches, err):
    """The flash forward at gemma3-12b's padded slot prefill [8, 2048, 16,
    256] under its local layers' window 1024 (40 of its 48 flash launches a
    prefill call)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    window = min(b.window for b in cfg.blocks() if b.is_attn and b.window)
    shape = {"batch": LANES, "positions": 2048, "heads": cfg.n_heads,
             "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
             "window": window}
    return flash_row("flash_attention[slot_prefill]", SRC_FA, REPL_FA,
                     launches, err,
                     time_flash(cfg, gen, LANES, 2048, window=window), shape)


def train_rows(tr, errs):
    """The `kernels` line's rows of the training path: the flash forward
    and backward at phase 8's shape [4, 2048, 32, 80]."""
    cfg = tr["cfg"]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    shape = {"batch": TR_BATCH, "positions": TR_SEQ, "heads": cfg.n_heads,
             "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
             "window": cfg.unit[0].window}
    fwd = time_flash(cfg, gen, TR_BATCH, TR_SEQ)
    bwd = time_flash_bwd(cfg, gen, TR_BATCH, TR_SEQ)
    return [flash_row("flash_attention[train]", SRC_FA, REPL_FA, tr["fwd"],
                      errs["flash_attention_train"], fwd, shape),
            flash_row("flash_attention_bwd", SRC_FB, REPL_FB, tr["bwd"],
                      errs["flash_attention_bwd"], bwd, shape,
                      visible_pairs=bwd[6],
                      launches_per_step=tr["bwd"] // tr["steps"])]


def kernel_rows(cfg, counts, shapes, errs, greedy=None):
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    rows = []
    fa = [("prefill_batch",
           max(shapes["none"]["prefill"], key=lambda x: x[0] * x[1] ** 2),
           counts["none"][2])]
    if greedy is not None:
        fa.append(("greedy", greedy[1], greedy[0]))
    for label, (w, s), launches in fa:
        rows.append(flash_row(
            f"flash_attention[{label}]", SRC_FA, REPL_FA, launches,
            errs["flash_attention"], time_flash(cfg, gen, w, s),
            {"batch": w, "positions": s, "heads": cfg.n_heads,
             "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim}))
    for kv_quant, codec in (("none", "bf16"), ("int8", "int8")):
        nd, npf, _ = counts[kv_quant]
        for (name, src, replaces, timer, key, launches) in (
                ("paged_decode", "src/repro_torch/kernels/csrc/paged_decode.cu",
                 "src/repro/kernels/decode_attention.py:306", time_decode,
                 "decode_compact", nd),
                ("paged_prefill",
                 "src/repro_torch/kernels/csrc/paged_prefill.cu",
                 "src/repro/kernels/prefill_attention.py:294", time_prefill,
                 "chunk", npf)):
            calls = shapes[kv_quant][key]
            w, mb = max(calls, key=lambda s: s[0] * s[1])
            ms, plain, nbytes, flops = timer(cfg, gen, w, mb, codec)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            # every shape the path launched the kernel at, each call a
            # launch per layer, timed at the most that shape reads: their
            # sum over launches is the kernel's share of the phase's wall
            if sum(calls.values()) * cfg.n_layers != launches:
                fail(f"{name}[{codec}]: {sum(calls.values())} calls of "
                     f"{cfg.n_layers} layers, {launches} launches")
            per = {f"{sw}x{smb}": (cfg.n_layers * c,
                                   ms if (sw, smb) == (w, mb) else
                                   timer(cfg, gen, sw, smb, codec,
                                         plain=False)[0])
                   for (sw, smb), c in sorted(calls.items())}
            top = max(per, key=lambda k: per[k][0])
            rows.append({
                "name": f"{name}[{codec}]", "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "shape": {"lanes": w, "table_blocks": mb, "block": KV_BLOCK,
                          "chunk": CHUNK if name == "paged_prefill" else 1},
                "bytes": nbytes, "operations": flops,
                "launch_shapes": {k: n for k, (n, _) in per.items()},
                "ms_by_shape": {k: t for k, (_, t) in per.items()},
                "most_launched_shape": top, "ms_most_launched": per[top][1],
                "launches_x_ms": sum(n * t for n, t in per.values())})
    return rows


# ---------------------------------------------------------------------------

def time_mlstm(gen, bh, s, dk, dv, chunk=128):
    """The mLSTM scan at [bh, s, dk / dv], bf16 q/k/v and a carried f32
    state (chunk calls carry one): kernel and plain version, and the bytes
    and operations the function needs (f32 arithmetic)."""
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    q, k, v = (rnd(bh, s, d).to(bf) for d in (dk, dk, dv))
    ig, fg = rnd(bh, s), rnd(bh, s) + 2.0
    init = (rnd(bh, dk, dv), rnd(bh, dk).abs(), rnd(bh, 1))
    args = (q, k, v, ig, fg)
    ms = time_ms(lambda: mlstm_scan.mlstm_scan_fwd(*args, chunk=chunk,
                                                   initial=init), 5)
    plain = time_ms(lambda: mlstm_scan.mlstm_scan_plain(*args, chunk=chunk,
                                                        initial=init), 3)
    c = min(chunk, s)
    nc = s // c
    # q, k, v and out in bf16, gates f32, the state read and written once
    nbytes = (2 * bh * s * (2 * dk + dv) + 2 * bh * s * 4
              + 2 * bh * (dk * dv + dk + 1) * 4 + 2 * bh * s * dv)
    # per (head, chunk): q k^T, the weighted scores times v, q C, the C
    # update (2 operations per product), q.n and the n update
    flops = bh * nc * (2.0 * c * c * dk + 2.0 * c * c * dv
                       + 4.0 * c * dk * dv + 4.0 * c * dk)
    # what the two kernels compute (csrc/mlstm_scan.cu, its bf16 body): per
    # (head, chunk) the scores of ceil(c / 32) tiles of 32 rows x 128
    # columns and the sum of k a, once; per 32-column tile of dv and chunk,
    # over 128 rows and dk in tiles of 64, each state product twice (the
    # f32 operand's bf16 hi and lo halves: q C, sw v, the C update), q.n
    # and the n update
    tiles, up = -(-dv // 32), (lambda x, m: -(-x // m) * m)
    pass1 = 2.0 * up(c, 32) * 128 * dk + 2.0 * c * dk
    pass2 = (2 * 2.0 * 128 * 32 * up(dk, 64) + 2.0 * 128 * up(dk, 64)
             + 2 * 2.0 * 128 * 32 * up(c, 16)
             + 2 * 2.0 * up(dk, 64) * 32 * up(c, 16) + 2.0 * dk)
    kernel_flops = bh * nc * (pass1 + tiles * pass2)
    return ms, plain, nbytes, flops, kernel_flops


def mlstm_row(xl, err):
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    cfg = get_config("xlstm-1.3b")
    hd = int(cfg.mlstm_proj_factor * cfg.d_model) // cfg.n_heads
    bh, s = xl["largest"]
    ms, plain, nbytes, flops, kflops = time_mlstm(gen, bh, s, hd, hd)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return {"name": "mlstm_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mlstm_scan.cu",
            "replaces": "src/repro/kernels/mlstm_scan.py:125",
            "launches": xl["launches"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "shape": {"folded_heads": bh, "positions": s, "dk": hd, "dv": hd,
                      "chunk": min(128, s)},
            "bytes": nbytes, "operations": flops,
            "kernel_operations": kflops}


def time_ring_decode(cfg, gen, b, L):
    """Ring decode at [b, L] rings of cfg's heads, bf16, every slot filled
    and visible (the rings have wrapped): the kernel, the plain version,
    and scaled_dot_product_attention with a boolean position mask and
    enable_gqa on the same inputs (the one PyTorch call that computes the
    same function; timed here, never called by the port); the bytes and
    operations the function needs for these inputs."""
    K, G, hd = cfg.n_kv_heads, cfg.q_group, cfg.resolved_head_dim
    bf = torch.bfloat16
    ends = [L - 1 + 977 * i for i in range(b)]
    cpos = ring_positions(ends, L)
    positions = torch.tensor(ends, dtype=torch.int32, device=DEV)
    q = torch.randn((b, K, G, hd), generator=gen, device=DEV).to(bf)
    k = torch.randn((b, L, K, hd), generator=gen, device=DEV).to(bf)
    v = torch.randn((b, L, K, hd), generator=gen, device=DEV).to(bf)
    args = (q, k, v, cpos, positions)
    ms = time_ms(lambda: decode_attention.decode_attention_fwd(*args), 20)
    plain = time_ms(lambda: decode_attention.decode_attention_plain(*args),
                    5)
    vis = A._mask(positions[:, None], cpos, BlockSpec())[:, 0]
    qt = q.reshape(b, K * G, 1, hd)
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    mask = vis[:, None, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)

    lib = time_ms(sdpa, 20)
    dev = float((sdpa().reshape(b, K, G, hd).float()
                 - decode_attention.decode_attention_plain(*args).float()
                 ).abs().max())
    pairs = int(vis.sum())
    # K and V of every slot read once, positions read once, q read and o
    # written once
    nbytes = (2 * k.numel() * 2 + cpos.numel() * 4 + 2 * q.numel() * 2
              + positions.numel() * 4)
    flops = 4.0 * hd * G * K * pairs          # q.k and p.v per head
    return ms, plain, lib, dev, nbytes, flops, pairs


def ring_row(g3, rg, err):
    """The `kernels` line's row of kernel 6, ring decode, timed at the
    largest shape on its path: gemma3-12b's slot-mode global ring
    [8, 4096, 8, 256]."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    cfg = g3["cfg"]
    ms, plain, lib, dev, nbytes, flops, pairs = time_ring_decode(
        cfg, gen, LANES, RING_CONTEXT)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    local = [b.cache_len(RING_CONTEXT) for b in cfg.blocks()
             if b.window is not None][0]
    ms_local, _, lib_local, _, nb_local, _, _ = time_ring_decode(
        cfg, gen, LANES, local)
    row = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ring_decode.cu",
           "replaces": "src/repro/kernels/decode_attention.py:84",
           "launches": g3["slot"]["launches"], "max_abs_err": err,
           "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib, "library_max_abs_dev": dev,
           "shape": {"lanes": LANES, "ring": RING_CONTEXT,
                     "kv_heads": cfg.n_kv_heads, "group": cfg.q_group,
                     "head_dim": cfg.resolved_head_dim},
           "bytes": nbytes, "operations": flops, "visible_pairs": pairs,
           "local_ring": {"ring": local, "ms": ms_local,
                          "library_ms": lib_local,
                          "bound_ms": nb_local / PEAK_BYTES_PER_S * 1e3},
           "launches_paged_gemma3": g3["paged"]["launches"]}
    if rg is not None:
        row["launches_slot_recurrentgemma"] = rg["slot"]["launches"]
        row["launches_paged_recurrentgemma"] = rg["paged"]["launches"]
    return row


def run_mistral(phases, errs):
    """Phases 3-6 on mistral-nemo-12b; returns its kernels' rows."""
    cfg = get_config("mistral-nemo-12b")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    t0 = time.time()
    params = init_params(gen, cfg, device=DEV)
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    torch.cuda.synchronize()
    log(f"[3] {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} layers, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {n_bytes / 1e9:.2f} GB of bf16 weights made "
        f"on the card from seed {SEED} in {time.time() - t0:.1f}s")
    t0 = time.time()
    (trace, context, counts, shapes, plans, peak, reps,
     calls) = phase_main(cfg, params)
    log(f"[3] phase 3 {time.time() - t0:.2f}s")
    if 4 in phases:
        t0 = time.time()
        phase_identity(cfg, params, trace, context)
        log(f"[4] phase 4 {time.time() - t0:.2f}s")
    if 5 in phases:
        for kv_quant, plan in plans.items():
            pred = plan["resident"] + plan["transient"]
            log(f"[5] WSMC kv_quant={kv_quant}: predicted resident "
                f"{plan['resident'] / 1e9:.3f} GB + transient "
                f"{plan['transient'] / 1e9:.3f} GB = {pred / 1e9:.3f} "
                f"GB; torch.cuda.max_memory_allocated() "
                f"{peak[kv_quant] / 1e9:.3f} GB; measured / predicted = "
                f"{peak[kv_quant] / pred:.4f} (weights "
                f"{n_bytes / 1e9:.3f} GB, pool "
                f"{(plan['pool_blocks'] + 1) * plan['per_block'] / 1e9:.3f}"
                f" GB)")
    greedy = None
    if 6 in phases:
        t0 = time.time()
        greedy = phase_greedy(cfg, params, trace, context, reps, calls)
        log(f"[6] phase 6 {time.time() - t0:.2f}s")
    return kernel_rows(cfg, counts, shapes, errs, greedy)


# ---------------------------------------------------------------------------
# Phase 11: the serving CLI plans the deployment on the card
# ---------------------------------------------------------------------------

# phase 3's trace (make_trace: seed SEED + 7, the same lengths and arrivals);
# no --kv-block, so plan_serving chooses the block size
CLI_PAGED = ["--arch", "mistral-nemo-12b", "--kv", "paged", "--compact",
             "--chunk-prefill", str(CHUNK), "--mesh", "auto",
             "--max-slots", str(LANES), "--requests", "16",
             "--prompt-lens", "64,200,256,520,1024,2048",
             "--gen-lens", "16,24,32", "--arrival-mean", "2.0",
             "--seed", str(SEED + 7), "--audit", "strict"]
CLI_RING = ["--arch", "gemma3-12b", "--kv", "ring", "--max-slots", "8",
            "--requests", "8", "--prompt-lens", "64,200,512",
            "--gen-lens", "8,16", "--seed", str(SEED + 11)]


def run_cli(tag, argv):
    """SV.main(argv + --device cuda) in process, its standard output
    captured and logged line by line; plan_serving's result and every
    CudaMeasurer profile recorded; launch counters zeroed just before and
    read just after. Fails the run on a non-zero return, an exit or an
    exception."""
    plans, profiles = [], []
    plan_serving, measure = XP.plan_serving, MM.CudaMeasurer._measure

    def recorded_plan(*a, **kw):
        plans.append(plan_serving(*a, **kw))
        return plans[-1]

    def recorded_measure(self, *a, **kw):
        t0 = time.time()
        profiles.append((measure(self, *a, **kw), time.time() - t0))
        return profiles[-1][0]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    buf = io.StringIO()
    XP.plan_serving, MM.CudaMeasurer._measure = (recorded_plan,
                                                 recorded_measure)
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            rc = SV.main(argv + ["--device", "cuda"])
    except SystemExit as e:
        rc = f"exit {e.code}"
    except Exception as e:              # noqa: BLE001 — logged, then failed
        rc = f"{type(e).__name__}: {e}"
    finally:
        XP.plan_serving, MM.CudaMeasurer._measure = plan_serving, measure
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = launch_counts()
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[11{tag}] | {line}")
    if rc != 0:
        fail(f"phase 11({tag}): the serve CLI returned {rc}")
    if len(plans) != 1:
        fail(f"phase 11({tag}): plan_serving ran {len(plans)} times")
    m = re.search(r"^WSMC\[serving/(\w+)\]: (\S+) -> (.*)$", out, re.M)
    if m is None:
        fail(f"phase 11({tag}): no WSMC plan line")
    cls, splan = plans[0]
    if m.group(2) != cls.category.value or m.group(3) != splan.describe():
        fail(f"phase 11({tag}): the plan line does not print the plan")
    if splan.hbm_budget != HW.H100.hbm_bytes:
        fail(f"phase 11({tag}): planned for {splan.hbm_budget} bytes, not "
             f"the H100's {HW.H100.hbm_bytes}")
    mem = re.search(r"measured / predicted ([0-9.]+)", out)
    done = re.search(r"completed=(\d+)", out)
    if mem is None or done is None:
        fail(f"phase 11({tag}): no memory or report line")
    return {"out": out, "cls": cls, "splan": splan, "profiles": profiles,
            "counts": counts, "wall": dt, "ratio": float(mem.group(1)),
            "completed": int(done.group(1))}


def phase_cli():
    """Phase 11: the serve CLI plans and serves on the card (paged,
    simulated and measured classification; ring)."""
    res = {}
    a = run_cli("a", CLI_PAGED)
    n, cls, sp = a["completed"], a["cls"], a["splan"]
    pool = re.search(r"^pool: (\d+) lanes, (\d+) blocks of (\d+) positions",
                     a["out"], re.M)
    c = a["counts"]
    if n != 16 or "audits=" not in a["out"] or ":clean" not in a["out"]:
        fail(f"phase 11(a): {n} of 16 requests completed, or the audit is "
             "not clean")
    if pool is None or int(pool.group(3)) != sp.kv_block \
            or sp.kv_block not in XP.DEFAULT_KV_BLOCKS \
            or int(pool.group(2)) != sp.pool_blocks(LANES,
                                                    int(re.search(
                                                        r"context (\d+)",
                                                        a["out"]).group(1))):
        fail("phase 11(a): the pool is not the plan's")
    if (c["paged_decode"] <= 0 or c["paged_prefill"] <= 0
            or c["flash_attention"] <= 0 or c["decode_attention"]
            or c["mlstm_scan"] or c["flash_attention_bwd"]):
        fail(f"phase 11(a): launches {c}")
    log(f"[11a] mistral-nemo-12b through the serve CLI: class "
        f"{cls.category.value} (alpha {cls.alpha!r}, inc {cls.inc!r}, "
        f"simulated ladder) beside phase 3's hand-fixed "
        f"{WORKLOAD.category.value}; plan_serving with HW.H100 chose "
        f"kv_block={sp.kv_block} (of {XP.DEFAULT_KV_BLOCKS}), capacity "
        f"{sp.capacity} lanes, {sp.blocks} blocks; pool {pool.group(1)} "
        f"lanes x {pool.group(2)} blocks; {n}/16 requests, audit clean; "
        f"launches paged decode {c['paged_decode']}, paged prefill "
        f"{c['paged_prefill']}, flash {c['flash_attention']}; measured / "
        f"predicted peak {a['ratio']}; {a['wall']:.2f}s")
    res["a"] = a
    b = run_cli("b", CLI_PAGED + ["--backend", "cuda"])
    if b["completed"] != 16 or not b["profiles"]:
        fail(f"phase 11(b): {b['completed']} of 16 requests, "
             f"{len(b['profiles'])} measured profiles")
    for p, t in b["profiles"]:
        log(f"[11b] CudaMeasurer {p.shape_name} ({p.kind}, seq {p.seq_len}, "
            f"batch {p.global_batch}): argument {p.argument_bytes:.0f} B, "
            f"transient {p.transient_bytes:.0f} B, output "
            f"{p.output_bytes:.0f} B, input {p.input_bytes:.0f} B, alpha "
            f"{p.alpha!r}; {t:.2f}s")
    cb = b["cls"]
    log(f"[11b] class measured on the card {cb.category.value} (alpha "
        f"{cb.alpha!r}, inc {cb.inc!r}) beside the simulator's "
        f"{cls.category.value} (alpha {cls.alpha!r}, inc {cls.inc!r}) from "
        f"{len(b['profiles'])} ladder point(s) (base_seq 64: every decode "
        f"rung clamps to a 1024 context and dedupes, so inc is 1.0 by "
        f"construction); plan {b['splan'].describe()}; measured / predicted "
        f"peak {b['ratio']}; {b['wall']:.2f}s")
    res["b"] = b
    r = run_cli("c", CLI_RING)
    c = r["counts"]
    if r["completed"] != 8 or r["splan"].kv_block:
        fail(f"phase 11(c): {r['completed']} of 8 requests, "
             f"kv_block {r['splan'].kv_block}")
    if (c["decode_attention"] <= 0 or c["flash_attention"] <= 0
            or c["paged_decode"] or c["paged_prefill"] or c["mlstm_scan"]):
        fail(f"phase 11(c): launches {c}")
    log(f"[11c] gemma3-12b through the serve CLI's ring path: class "
        f"{r['cls'].category.value}; capacity {r['splan'].capacity} slots; "
        f"8/8 requests; launches ring decode {c['decode_attention']}, flash "
        f"{c['flash_attention']}; measured / predicted peak {r['ratio']}; "
        f"{r['wall']:.2f}s")
    res["c"] = r
    return res


# ---------------------------------------------------------------------------
# Phase 12: the trainer's WSMC online phase on the card
# ---------------------------------------------------------------------------

TRAIN_CLI = ["--arch", TR_ARCH, "--seq", str(TR_SEQ), "--batch",
             str(TR_BATCH), "--steps", "4", "--lr", str(TR_LR),
             "--log-every", "1", "--seed", str(TR_SEED)]


def run_train_cli(backend):
    """LT.main(TRAIN_CLI + --backend) in process, its standard output
    captured and logged line by line; the classification and every
    CudaMeasurer profile recorded by wrapping them for the run; launch
    counters zeroed just before and read just after. Fails the run on a
    non-zero return, an exit or an exception."""
    classes, profiles = [], []
    classify, measure = PF.classify_workload, MM.CudaMeasurer._measure

    def recorded_classify(*a, **kw):
        classes.append(classify(*a, **kw))
        return classes[-1]

    def recorded_measure(self, *a, **kw):
        t0 = time.time()
        profiles.append((measure(self, *a, **kw), time.time() - t0))
        return profiles[-1][0]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _zero_launches()
    buf = io.StringIO()
    PF.classify_workload, MM.CudaMeasurer._measure = (recorded_classify,
                                                      recorded_measure)
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            rc = LT.main(TRAIN_CLI + ["--backend", backend,
                                      "--device", "cuda"])
    except SystemExit as e:
        rc = f"exit {e.code}"
    except Exception as e:              # noqa: BLE001 — logged, then failed
        rc = f"{type(e).__name__}: {e}"
    finally:
        PF.classify_workload, MM.CudaMeasurer._measure = classify, measure
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = launch_counts()
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[12] {backend} | {line}")
    if rc != 0:
        fail(f"phase 12 ({backend}): the trainer returned {rc}")
    plan = re.search(rf"^WSMC\[fastest/{backend}\]: (\S+) .* -> plan "
                     r"(MemoryPlan\(.*?\)) ", out, re.M)
    execution = re.search(r"^execution: (.*)$", out, re.M)
    mem = re.search(r"max_memory_allocated\(\) ([0-9.]+) GB; predicted "
                    r"([0-9.]+) GB; measured / predicted ([0-9.]+)", out)
    losses = [float(x) for x in re.findall(r"^step +\d+ loss=([0-9.]+)",
                                           out, re.M)]
    if plan is None or execution is None or mem is None or len(classes) != 1:
        fail(f"phase 12 ({backend}): no plan, execution or memory line, or "
             f"{len(classes)} classifications")
    if plan.group(1) != classes[0].category.value:
        fail(f"phase 12 ({backend}): the plan line does not print the class")
    if len(losses) != 4 or not all(np.isfinite(losses)):
        fail(f"phase 12 ({backend}): losses {losses}")
    peak = float(mem.group(1)) * 1e9
    total = torch.cuda.get_device_properties(0).total_memory
    if peak > total:
        fail(f"phase 12 ({backend}): measured peak {peak:.0f} B exceeds the "
             f"card's {total} B")
    if (counts["flash_attention"] <= 0 or counts["flash_attention_bwd"] <= 0
            or any(counts[k] for k in ("paged_decode", "paged_prefill",
                                       "mlstm_scan", "decode_attention"))):
        fail(f"phase 12 ({backend}): launches {counts}")
    if backend == "cuda" and not profiles:
        fail("phase 12 (cuda): no step was measured on the card")
    if backend == "simulate" and profiles:
        fail("phase 12 (simulate): the simulator ran steps on the card")
    return {"cls": classes[0], "plan": plan.group(2),
            "execution": execution.group(1), "peak": peak,
            "predicted": float(mem.group(2)) * 1e9,
            "ratio": float(mem.group(3)), "profiles": profiles,
            "counts": counts, "wall": dt, "losses": losses}


def phase_train_cli():
    """Phase 12: the trainer plans its own memory configuration on the
    card, classified by the simulator and then by steps on the card."""
    runs = {b: run_train_cli(b) for b in ("simulate", "cuda")}
    sim, card = runs["simulate"], runs["cuda"]
    for p, t in card["profiles"]:
        log(f"[12] CudaMeasurer {p.shape_name} ({p.kind}, seq {p.seq_len}, "
            f"batch {p.global_batch}): argument {p.argument_bytes:.0f} B, "
            f"transient {p.transient_bytes:.0f} B, output "
            f"{p.output_bytes:.0f} B, alpha {p.alpha!r}; {t:.2f}s")
    cs, cc = sim["cls"], card["cls"]
    log(f"[12] {TR_ARCH} at [{TR_BATCH}, {TR_SEQ}]: class measured on the "
        f"card {cc.category.value} (alpha {cc.alpha!r}, inc {cc.inc!r}) "
        f"beside the simulator's {cs.category.value} (alpha {cs.alpha!r}, "
        f"inc {cs.inc!r}), from {len(card['profiles'])} ladder steps on the "
        f"card in {sum(t for _, t in card['profiles']):.2f}s")
    for name, r in runs.items():
        log(f"[12] --backend {name}: plan under HW.H100 {r['plan']}; "
            f"execution {r['execution']}; predicted peak "
            f"{r['predicted'] / 1e9:.3f} GB, "
            f"torch.cuda.max_memory_allocated() {r['peak'] / 1e9:.3f} GB, "
            f"measured / predicted {r['ratio']} (phase 8's plans, under "
            f"the simulator's class, print theirs); flash launches "
            f"forward {r['counts']['flash_attention']}, backward "
            f"{r['counts']['flash_attention_bwd']} (planning steps "
            f"included); losses {r['losses']}; {r['wall']:.2f}s")
    return {"fwd": sum(r["counts"]["flash_attention"] for r in runs.values()),
            "bwd": sum(r["counts"]["flash_attention_bwd"]
                       for r in runs.values())}


# ---------------------------------------------------------------------------
# Phase 13: MoE and prefix embeddings at full width
# ---------------------------------------------------------------------------

# (a) runs 8 of mixtral-8x7b's 32 layers, cut for the script's time limit
# (PERF.md lists the cuts with the seconds they saved)
MX_ARCH, MX_UNITS, MX_SEED = "mixtral-8x7b", 8, SEED + 13
SC_ARCH, SC_UNITS, SC_SEED = "llama4-scout-17b-a16e", 2, SEED + 14
SC_PROMPTS, SC_NEW = (64, 200, 384, 512), 32
VL_ARCH, VL_SEED, VL_TEXT, VL_DECODES = "internvl2-26b", SEED + 15, 200, 32


# moe.route replaced by hook(route, params, cfg, h) for the duration
# (routing); each token's choices that found a capacity slot
# (kept_choices); route's outputs with each token's experts and kept
# choices given (forced_route): the port's own, which the serve CLI's
# --replay-routes uses too
routing = MOE.routing
kept_choices = MOE.kept_choices
forced_route = MOE.forced_route


def greedy_routes_hook(cfg, p, routes, force=False):
    """A routing hook for one greedy stream (batch 1) over a prompt of p
    tokens: its prefill routes positions 0..p-1 through each MoE layer in
    turn, then every decode step the next position. Records each (MoE
    layer, position)'s experts and kept choices [k] into `routes` or, with
    `force`, makes each take those."""
    n_moe = sum(b.mlp == MLP_MOE for b in cfg.blocks())
    calls = [0]

    def hook(route, params, cfg_, h):
        step, layer = divmod(calls[0], n_moe)
        calls[0] += 1
        pos = range(p) if step == 0 else [p + step - 1]
        if tuple(h.shape[:2]) != (1, len(pos)):
            fail(f"a greedy MoE call of shape {tuple(h.shape)} at step "
                 f"{step}, want [1, {len(pos)}]")
        if force:
            ex, kp = (torch.stack([routes[layer, q][j] for q in pos])[None]
                      .to(h.device) for j in (0, 1))
            return forced_route(params, cfg_, h, ex, kp)
        out = route(params, cfg_, h)
        ex, kp = out[2][0].cpu(), kept_choices(out[0], out[2])[0].cpu()
        for i, q in enumerate(pos):
            routes[layer, q] = (ex[i], kp[i])
        return out
    return hook


class RouteRecordingExecutor(RecordingExecutor):
    """RecordingExecutor that also keeps, for every call and fed row, the
    MoE routes of the row's real positions, MoE layer by layer: the experts
    and the kept choices [layers, n, k] (`fed_routes`). A chunk or a prompt
    (never longer than ModelSettings.moe_group) routes as one group a row,
    a decode tick as one group over the batch."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.fed_routes = []

    def _routed(self, run, real, decode=False):
        got = []

        def hook(route, params, cfg, h):
            out = route(params, cfg, h)
            got.append((out[2], kept_choices(out[0], out[2])))
            return out
        with routing(hook):
            out = run()
        ex, kp = (torch.stack([g[j].reshape(-1, 1, g[j].shape[-1])
                               if decode else g[j] for g in got]).cpu()
                  for j in (0, 1))
        self.fed_routes.append([(f, ex[:, r, :n], kp[:, r, :n])
                                for f, r, n in zip(self._fed, self._rows,
                                                   real)])
        return out

    def decode(self, tokens, positions, tables=None, lanes=None):
        n = len(lanes if lanes is not None else tokens)
        return self._routed(
            lambda: super(RouteRecordingExecutor, self).decode(
                tokens, positions, tables, lanes), [1] * n, decode=True)

    def prefill_batch(self, lanes, prompts, tables=None):
        return self._routed(
            lambda: super(RouteRecordingExecutor, self).prefill_batch(
                lanes, prompts, tables), [len(p) for p in prompts])

    def prefill_chunks(self, lanes, chunks, starts, *a, **kw):
        return self._routed(
            lambda: super(RouteRecordingExecutor, self).prefill_chunks(
                lanes, chunks, starts, *a, **kw), [len(c) for c in chunks])


def engine_routes(ex, prompt, tokens):
    """{(MoE layer, position): (experts [k], kept [k])} of one request in
    the engine: its prompt, and each decode input that chose tokens[1:]."""
    P, out = tuple(prompt), {}
    dec = {(tokens[t - 1], len(P) + t - 1) for t in range(1, len(tokens))}
    for call in ex.fed_routes:
        for f, e, kp in call:
            if isinstance(f[0], tuple):
                if P[f[1]:f[1] + len(f[0])] != f[0]:
                    continue
                pos = range(f[1], f[1] + len(f[0]))
            elif f in dec:
                pos = [f[1]]
            else:
                continue
            for li in range(e.shape[0]):
                for i, q in enumerate(pos):
                    out[li, q] = (e[li, i], kp[li, i])
    return out


def phase_mixtral():
    """Phase 13(a): mixtral-8x7b at MX_UNITS of its 32 layers through the
    compacted chunked paged engine (bf16 pool), then four requests through
    greedy_generate with the engine's MoE routes. Returns the launches."""
    full = get_config(MX_ARCH)
    cfg = depth_variant(full, MX_UNITS)
    gen = torch.Generator(device=DEV).manual_seed(MX_SEED)
    t0 = time.time()
    params = init_params(gen, cfg, device=DEV)
    torch.cuda.synchronize()
    w_bytes = _bytes_of(params)
    log(f"[13a] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers (depth "
        f"the one cut: all {full.n_layers} are "
        f"{param_count(full) * 2 / 1e9:.1f} GB in bf16), d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff}, "
        f"capacity factor {cfg.capacity_factor}, window "
        f"{cfg.unit[0].window}: {w_bytes / 1e9:.3f} GB of bf16 weights made "
        f"on the card from seed {MX_SEED} in {time.time() - t0:.1f}s")
    trace = synthetic_trace(16, vocab_size=cfg.vocab_size, seed=MX_SEED,
                            prompt_lens=(64, 200, 256, 520, 1024, 2048),
                            gen_lens=(16, 24, 32), mean_interarrival=2.0)
    context = trace_context(trace)
    plan = plan_pool(cfg, trace, context, "none")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    ex, rep, dt = serve(cfg, params, trace, context, plan["pool_blocks"],
                        "none", record=True, keep_logits=True,
                        recorder=RouteRecordingExecutor)
    nd, npf, nfa = (paged_decode.launches, paged_prefill.launches,
                    flash_attention.launches)
    peak = torch.cuda.max_memory_allocated()
    want = {"paged_decode": cfg.n_layers * ex.decodes,
            "paged_prefill": cfg.n_layers * ex.chunk_calls,
            "flash_attention": cfg.n_layers * rep.prefill_calls}
    check_launches("13a", "the paged engine", launch_counts(), want)
    if rep.prefill_calls <= 0 or ex.chunk_calls <= 0:
        fail("13a: both prefill paths must run")
    pred = plan["resident"] + plan["transient"]
    eng_drops = sum(int((~kp).sum()) for call in ex.fed_routes
                    for _, _, kp in call)
    log(f"[13a] paged engine: {len(rep.completions)}/{len(trace)} requests, "
        f"{rep.prefill_tokens} prompt tokens ({rep.prefill_calls} "
        f"whole-prompt prefill calls, {ex.chunk_calls} chunk calls), "
        f"{ex.decodes} decode ticks, {dt:.2f}s wall ({tick_times(ex)}); "
        f"audit clean; launches paged decode {nd} = {cfg.n_layers} x "
        f"{ex.decodes}, paged prefill {npf} = {cfg.n_layers} x "
        f"{ex.chunk_calls}, flash {nfa} = {cfg.n_layers} x "
        f"{rep.prefill_calls}; pool {plan['pool_blocks']} blocks; predicted "
        f"{pred / 1e9:.3f} GB (resident {plan['resident'] / 1e9:.3f} + "
        f"transient {plan['transient'] / 1e9:.3f}), "
        f"torch.cuda.max_memory_allocated() {peak / 1e9:.3f} GB, measured / "
        f"predicted {peak / pred:.4f}; MoE choices dropped for want of "
        f"capacity over the requests' real positions: {eng_drops}")
    # The engine routes a decode tick's whole lane batch, and a chunk with
    # its pad rows, as one group (F13): its capacity drops, and a router
    # near-tie that rounding moves, are its own. The replay takes the
    # engine's experts and kept choices token by token, so that the two
    # paths compute the same function and differ by rounding alone.
    rids = greedy_subset(trace)
    by_rid = {r.rid: r for r in trace}
    eng = {c.rid: list(c.tokens) for c in rep.completions}
    forced = {rid: engine_routes(ex, by_rid[rid].prompt, eng[rid])
              for rid in rids}
    _zero_launches()
    t0 = time.time()
    outs = {}
    for rid in rids:
        req = by_rid[rid]
        prompt = torch.tensor([req.prompt], dtype=torch.int32, device=DEV)
        with routing(greedy_routes_hook(cfg, len(req.prompt), forced[rid],
                                        force=True)):
            outs[rid] = SS.greedy_generate(params, cfg, prompt, req.max_new,
                                           context)[0].tolist()
    torch.cuda.synchronize()
    gdt = time.time() - t0
    steps = sum(by_rid[r].max_new - 1 for r in rids)
    check_launches("13a", "greedy_generate", launch_counts(),
                   {"flash_attention": cfg.n_layers * len(rids),
                    "decode_attention": cfg.n_layers * steps})
    greedy_launches = launch_counts()
    equal, worst = 0, 0.0
    for rid in rids:
        g, e, req = outs[rid], eng[rid], by_rid[rid]
        prompt = torch.tensor([req.prompt], dtype=torch.int32, device=DEV)
        with routing(greedy_routes_hook(cfg, len(req.prompt), forced[rid],
                                        force=True)):
            toks, gaps, rows = greedy_gaps(cfg, params, prompt, req.max_new,
                                           context)
        if toks != g:
            fail(f"13a request {rid}: greedy_generate and its steps one by "
                 "one emit different tokens")
        d = next((i for i in range(len(g)) if g[i] != e[i]), len(g) - 1)
        erows = [engine_row(ex.calls, req.prompt, e, t) for t in range(d + 1)]
        rel = [rel_diff(rows[t], erows[t][1]) for t in range(d + 1)]
        worst = max(worst, max(rel))
        if g == e:
            equal += 1
            log(f"[13a]   request {rid} ({len(req.prompt)} prompt tokens): "
                f"{len(g)} tokens equal; largest rms logit difference "
                f"{max(rel):.4f}")
        else:
            log(f"[13a]   request {rid} ({len(req.prompt)} prompt tokens): "
                f"first divergence at token {d}: greedy {g[d]} (top-2 gap "
                f"{gaps[d]:.4f} of its logit std), engine {e[d]} (gap "
                f"{erows[d][0]:.4f}); rms logit difference by token 0..{d}: "
                f"{[round(x, 4) for x in rel]}")
    log(f"[13a] greedy_generate with the engine's MoE routes, "
        f"{cfg.n_layers} layers, requests {list(rids)} (prompts "
        f"{[len(by_rid[r].prompt) for r in rids]} tokens) in {gdt:.2f}s: "
        f"{equal}/{len(rids)} streams equal to the engine's token for "
        f"token; flash launches {greedy_launches['flash_attention']}, ring "
        f"decode launches {greedy_launches['decode_attention']}; largest "
        f"rms logit difference up to a first divergence {worst:.4f} (bound "
        f"{REL_BOUND})")
    if worst >= REL_BOUND:
        fail("13a: greedy and engine logits apart by more than rounding "
             "drift with the same MoE routes")
    return {"paged_decode": nd, "paged_prefill": npf, "flash_engine": nfa,
            "flash_greedy": greedy_launches["flash_attention"],
            "decode_attention": greedy_launches["decode_attention"]}


def judge_plain(tag, cfg, params, prompt, n_steps, context, want,
                prefix=None):
    """The greedy steps through the kernels (their tokens must be `want`,
    the entry point's) and through the plain versions (attention and ring
    decode), from the same weights and inputs, the plain run's MoE layers
    made to take the kernel run's routes: the rms logit difference up to
    the first divergence must stay below REL_BOUND. Returns (tokens equal
    up to, rms differences)."""
    routes = {}

    def routed(force):
        if not any(b.mlp == MLP_MOE for b in cfg.blocks()):
            return contextlib.nullcontext()
        return routing(greedy_routes_hook(cfg, prompt.shape[1], routes,
                                          force))
    with routed(False):
        toks, _, rows = greedy_gaps(cfg, params, prompt, n_steps, context,
                                    prefix=prefix)
    if toks != want:
        fail(f"[{tag}] the entry point and its steps one by one emit "
             "different tokens")
    with routed(True):
        ptoks, _, prows = greedy_gaps(cfg, params, prompt, n_steps, context,
                                      SETTINGS["naive"], prefix=prefix)
    n = next((i for i in range(n_steps) if toks[i] != ptoks[i]), n_steps)
    rel = [rel_diff(rows[t], prows[t]) for t in range(min(n + 1, n_steps))]
    if max(rel) >= REL_BOUND:
        fail(f"[{tag}] kernels and plain versions apart by more than "
             f"rounding drift: {rel}")
    return n, rel


def phase_scout():
    """Phase 13(b): llama4-scout-17b-a16e at SC_UNITS of its 12 unit
    repeats through greedy_generate."""
    full = get_config(SC_ARCH)
    cfg = depth_variant(full, SC_UNITS)
    gen = torch.Generator(device=DEV).manual_seed(SC_SEED)
    t0 = time.time()
    params = init_params(gen, cfg, device=DEV)
    torch.cuda.synchronize()
    log(f"[13b] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers "
        f"({SC_UNITS} of {full.repeats} unit repeats of 3 chunked-local + 1 "
        f"global; depth the one cut), "
        f"d_model {cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, "
        f"vocab {cfg.vocab_size}: {_bytes_of(params) / 1e9:.3f} GB of bf16 "
        f"weights from seed {SC_SEED} in {time.time() - t0:.1f}s")
    rng = np.random.default_rng(SC_SEED)
    prompts = [torch.tensor(rng.integers(0, cfg.vocab_size, (1, p)),
                            dtype=torch.int32, device=DEV)
               for p in SC_PROMPTS]
    context = max(SC_PROMPTS) + SC_NEW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.time()
    outs = [SS.greedy_generate(params, cfg, p, SC_NEW, context)[0].tolist()
            for p in prompts]
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = launch_counts()
    check_launches("13b", "greedy_generate", counts,
                   {"flash_attention": cfg.n_layers * len(prompts),
                    "decode_attention": cfg.n_layers * len(prompts)
                    * (SC_NEW - 1)})
    for o in outs:
        if len(o) != SC_NEW or not all(0 <= t < cfg.padded_vocab_size
                                       for t in o):
            fail(f"13b: bad token stream {o}")
    peak = torch.cuda.max_memory_allocated()
    judged = [judge_plain("13b", cfg, params, p, SC_NEW, context, o)
              for p, o in zip(prompts, outs)]
    log(f"[13b] greedy_generate, prompts {list(SC_PROMPTS)} tokens, "
        f"{SC_NEW} new tokens each, in {dt:.2f}s: launches flash "
        f"{counts['flash_attention']}, ring decode "
        f"{counts['decode_attention']}; "
        f"torch.cuda.max_memory_allocated() {peak / 1e9:.3f} GB; against "
        f"the plain attention and ring decode with the kernel run's MoE "
        f"routes: tokens equal up to {[j[0] for j in judged]} of {SC_NEW}, "
        f"largest rms logit difference up to a first divergence "
        f"{max(max(j[1]) for j in judged):.4f} (bound {REL_BOUND})")
    return counts


def phase_internvl():
    """Phase 13(c): internvl2-26b at full depth: prefill_step over 1024
    bf16 prefix embeddings and a text prompt, then VL_DECODES decode
    steps at positions 1024 + p + t."""
    cfg = get_config(VL_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(VL_SEED)
    t0 = time.time()
    params = init_params(gen, cfg, device=DEV)
    torch.cuda.synchronize()
    log(f"[13c] {cfg.name}: all {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_prefix_embeds} prefix embeddings: "
        f"{_bytes_of(params) / 1e9:.3f} GB of bf16 weights from seed "
        f"{VL_SEED} in {time.time() - t0:.1f}s")
    n = cfg.n_prefix_embeds
    prefix = torch.randn((1, n, cfg.d_model), generator=gen,
                         device=DEV).to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (1, VL_TEXT), generator=gen,
                           device=DEV, dtype=torch.int32)
    context = n + VL_TEXT + VL_DECODES
    prefill = SS.make_prefill_step(cfg)
    decode = SS.make_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.time()
    logits, cache = prefill(params, prompt, context=context,
                            prefix_embeds=prefix)
    toks = [torch.argmax(logits, dim=-1).to(torch.int32)]
    for t in range(VL_DECODES):
        pos = torch.full((1,), n + VL_TEXT + t, dtype=torch.int32,
                         device=DEV)
        logits, cache = decode(params, toks[-1][:, None], pos, cache,
                               context=context)
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
    torch.cuda.synchronize()
    dt = time.time() - t0
    out = [int(t[0]) for t in toks]
    counts = launch_counts()
    check_launches("13c", "prefix prefill and decode", counts,
                   {"flash_attention": cfg.n_layers,
                    "decode_attention": cfg.n_layers * VL_DECODES})
    if not torch.isfinite(logits).all() or \
            not all(0 <= t < cfg.padded_vocab_size for t in out):
        fail(f"13c: bad logits or tokens {out}")
    peak = torch.cuda.max_memory_allocated()
    del cache
    eq, rel = judge_plain("13c", cfg, params, prompt,
                                VL_DECODES + 1, context, out, prefix=prefix)
    log(f"[13c] prefill of {n} prefix embeddings + {VL_TEXT} text tokens, "
        f"then {VL_DECODES} decode steps at positions {n + VL_TEXT}.."
        f"{n + VL_TEXT + VL_DECODES - 1}, in {dt:.2f}s: launches flash "
        f"{counts['flash_attention']}, ring decode "
        f"{counts['decode_attention']}; torch.cuda.max_memory_allocated() "
        f"{peak / 1e9:.3f} GB; against the plain attention and ring decode: "
        f"tokens equal up to {eq} of {VL_DECODES + 1}, largest rms logit "
        f"difference up to a first divergence {max(rel):.4f} (bound "
        f"{REL_BOUND})")
    return counts


def phase_moe_prefix():
    res = {}
    for tag, fn in (("a", phase_mixtral), ("b", phase_scout),
                    ("c", phase_internvl)):
        t0 = time.time()
        res[tag] = fn()
        torch.cuda.empty_cache()
        log(f"[13{tag}] phase 13({tag}) {time.time() - t0:.2f}s")
    return res


# ---------------------------------------------------------------------------
# Phase 14: the parallel layer on the card
# ---------------------------------------------------------------------------

PAR_STEPS = 3
PAR_SEED = 0
PAR_CLI = ["--arch", TR_ARCH, "--seq", str(TR_SEQ), "--batch", str(TR_BATCH),
           "--steps", str(PAR_STEPS), "--lr", str(TR_LR), "--log-every",
           "1", "--seed", str(PAR_SEED), "--optimizer", "adamw_f32",
           "--device", "cuda", "--dist-backend", "gloo"]
# the depth (layers) that the gloo runs over a data or model axis (b)-(f)
# are cut to, for the script's time limit, and their one-rank runs beside
# them at that depth (PERF.md lists each cut with the seconds it saved);
# the one-rank runs at full depth and (a) keep the config's 24 layers, and
# no run cuts width
PAR_CUT = 2
M1C, M2C = f"0 m1 d{PAR_CUT}", f"0 m2 d{PAR_CUT}"
CKPT = "ckpt"        # the run saves its checkpoint at its last step
ROUTES = "routes"    # the run writes its MoE routes (--routes-out)
REPLAY = "replay"    # the run takes (g)'s routes (--replay-routes)
# (g): mixtral-8x7b at full width and 2 of its 32 layers (depth the one
# cut), trained with Adafactor (its AdamW state would be 25 GB a layer
# pair) at [2, 2048], one routing group of 2048 a row; on model:2 under the
# expert parallelism its plan resolves (8 experts tile the axis: 4 a rank),
# planned by CudaMeasurer over the model group; judged against one rank at
# the same depth that takes the ranks' routes ("g one"), and a free one
# rank ("g free") whose route partings are counted
MX_TRAIN_DEPTH = 2
MX_TRAIN = ("--arch", MX_ARCH, "--batch", "2", "--optimizer", "adafactor")
# (tag, --mesh, microbatches (None: the online phase plans them and the
# remat), the one-rank run whose losses it matches ("{m}": at its planned
# microbatches), depth (0: the config's), extra CLI flags)
PAR_RUNS = (
    ("0 m4", "", 4, None, 0, ()),
    ("0 m2", "", 2, None, 0, ()),
    (M1C, "", 1, None, PAR_CUT, ()),
    (M2C, "", 2, None, PAR_CUT, ()),
    ("a", "pipe:2", 4, "0 m4", 0, ()),
    ("b", "data:2", 1, M1C, PAR_CUT, (CKPT,)),
    ("c", "data:2,pipe:2", 2, M2C, PAR_CUT, ()),
    ("d", "model:2", 1, M1C, PAR_CUT, (CKPT,)),
    ("e", "data:2,model:2", 1, M1C, PAR_CUT, ()),
    ("f", "model:2", None, "0 m{m} d" + str(PAR_CUT), PAR_CUT,
     ("--backend", "cuda")),
    ("g", "model:2", 1, "g one", MX_TRAIN_DEPTH,
     (CKPT, ROUTES, "--backend", "cuda") + MX_TRAIN),
    ("g one", "", 1, None, MX_TRAIN_DEPTH, (REPLAY, ROUTES) + MX_TRAIN),
    ("g free", "", 1, None, MX_TRAIN_DEPTH, (ROUTES,) + MX_TRAIN))
# the runs that share the card at once (each a process of its own and its
# ranks; a run's peak is its own process's). A one-rank run at full depth
# peaks at 35 and 43 GB at 4 and 2 microbatches, a rank of (a) near 17 GB;
# the runs at PAR_CUT layers at 12-15 GB one rank, 3-10 GB a rank on a
# mesh; a rank of (g) 12-16 GB, its one-rank runs 25-30 GB each; (h) (rank
# functions, "h") two ranks near 8 GB, then one rank in this process. (g)'s
# one-rank runs need its routes, so they run in the last wave, beside (d)
PAR_WAVES = (("0 m4", M1C, "f"), ("b", "g", "h"), ("a", "e"),
             ("0 m2", M2C, "c"), ("d", "g one", "g free"))
# (the run whose checkpoint, the layouts it is restored onto by ranks of
# their own, a run in whose wave the restore is made (None: after the
# last wave)); each restore is also held against the run's own ranks. A
# layout's " tp" puts a MoE arch's experts under tensor parallelism
# inside the experts (Strategy(ep=False)), else the run's own strategy
PAR_RESTORES = (("b", ("data:2,pipe:2", "model:2"), "a"),
                ("d", ("data:2",), None), ("g", ("model:2 tp",), None))
# step 1 is taken before any update: its loss and gradient norm are the
# same in every layout up to the order of its sums (its loss at random
# weights is about ln V whatever the layout, so the norm is the sharper
# test of a gradient; for a MoE arch the routers' part of the norm too,
# which a wrong sum of the gates' or the router's gradient moves while the
# whole norm barely does); later steps drift a little further. Sound runs
# have spread 0 (step 1) and up to 6.8e-5 (later) on the loss
PAR_FIRST_BOUND = 1e-4
PAR_GNORM_BOUND = 1e-3
PAR_LATER_BOUND = 1e-3
PAR_TIMEOUT = 600
PAR_RANK_LINE = re.compile(
    r"^rank (\d+): param elements ([0-9,]+); max_memory_allocated "
    r"([0-9.]+) GB; flash launches forward (\d+), backward (\d+); staged "
    r"through the host ([0-9.]+) B a step; collectives ([0-9.]+) s a step; "
    r"by kind \((.*)\); state fingerprint (\w+); model-whole fingerprint "
    r"(\w+)(?:; routes digest (\w+))?$", re.M)
PAR_STEP_LINE = re.compile(
    r"^step +\d+ loss=([0-9.]+) gnorm=([0-9.]+) lr=\S+"
    r"(?: router_gnorm=([0-9.e+-]+))?$", re.M)


def par_mesh(spec):
    return LT.parse_mesh(spec.split()[0]) if spec else {}


def par_flag(tag, flag, default):
    """The value of `flag` among run `tag`'s extra CLI flags."""
    extra = PAR_BY_TAG[tag][5]
    return extra[extra.index(flag) + 1] if flag in extra else default


def par_cfg(tag):
    cfg = get_config(par_flag(tag, "--arch", TR_ARCH))
    depth = PAR_BY_TAG[tag][4]
    return depth_variant(cfg, depth) if depth else cfg


def par_layout(cfg, mesh, ep=False, kind="adamw_f32"):
    """(the spec tree of the trainer's {"params", "opt"} checkpoint on
    `mesh` under Strategy(ep), a target of this rank's leaf shapes on the
    meta device)."""
    abstract = init_params(None, cfg, device="meta")
    strategy = SHD.Strategy(ep=ep, pipeline=mesh.axis_size("pipe") > 1)
    specs = SHD.param_specs(cfg, abstract, strategy, mesh)
    ocfg = OPT.OptimizerConfig(kind=kind)
    local = tree_map(lambda t, s: torch.empty(
        SHD.local_shape(t.shape, s, mesh), dtype=t.dtype, device="meta"),
        abstract, specs)
    return ({"params": specs, "opt": OPT.state_specs(ocfg, specs)},
            {"params": local, "opt": OPT.init_state(ocfg, local)})


def rank_mesh(shape, r):
    """The Mesh (no groups) of global rank r on {axis: size} `shape`."""
    axes = tuple(a for a, _ in LM._ordered(shape))
    c, rest = {}, r
    for a in reversed(axes):
        c[a], rest = rest % shape[a], rest // shape[a]
    return LM.Mesh(axis_names=axes, shape=dict(shape), coords=c, rank=r)


def rank_elements(cfg, shape, strategy=None):
    """Each rank's parameter elements under the spec tree on `shape`
    (under `strategy`; by default the trainer's, pipelined over a pipe
    axis)."""
    out = []
    abstract = init_params(None, cfg, device="meta")
    strategy = strategy or SHD.Strategy(pipeline=shape.get("pipe", 1) > 1)
    for r in range(int(np.prod(list(shape.values())))):
        mesh = rank_mesh(shape, r)
        specs = SHD.param_specs(cfg, abstract, strategy, mesh)
        out.append(sum(int(np.prod(SHD.local_shape(t.shape, s, mesh)))
                       for t, s in zip(tree_leaves(abstract),
                                       tree_leaves(specs))))
    return out


def routes_path(tmp, tag):
    return os.path.join(tmp, f"routes_{tag.replace(' ', '_')}.pt")


def start_par(tag, tmp):
    """The training CLI of run `tag` in a subprocess leading a process
    group of its own (it spawns its ranks on the card, joined over gloo),
    its output to files under `tmp`."""
    _, mesh, micro, _, depth, extra = PAR_BY_TAG[tag]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *PAR_CLI,
           "--mesh", mesh]
    if micro is not None:
        cmd += ["--remat", "none", "--microbatches", str(micro)]
    if depth:
        cmd += ["--depth", str(depth)]
    if CKPT in extra:
        cmd += ["--ckpt-dir", os.path.join(tmp, f"ckpt_{tag}"),
                "--ckpt-interval", "0"]
    if ROUTES in extra:
        cmd += ["--routes-out", routes_path(tmp, tag)]
    if REPLAY in extra:
        cmd += ["--replay-routes", routes_path(tmp, "g")]
    cmd += [x for x in extra if x not in (CKPT, ROUTES, REPLAY)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    name = tag.replace(" ", "_")
    out = open(os.path.join(tmp, f"{name}.out"), "w+")
    err = open(os.path.join(tmp, f"{name}.err"), "w+")
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=out, stderr=err,
                            text=True, start_new_session=True)
    return {"proc": proc, "out": out, "err": err, "t0": time.time()}


def wait_par(started):
    """Waits for every started run, each given PAR_TIMEOUT from its start;
    a run that exits non-zero or runs out of time stops the others and
    fails the phase. Returns {tag: (stdout, wall)}."""
    done = {}
    try:
        while len(done) < len(started):
            for tag, st in started.items():
                if tag in done:
                    continue
                rc = st["proc"].poll()
                if rc is None and time.time() - st["t0"] > PAR_TIMEOUT:
                    fail(f"phase 14({tag}): the trainer ran past "
                         f"{PAR_TIMEOUT} s")
                if rc is None:
                    continue
                st["out"].seek(0)
                done[tag] = (st["out"].read(), time.time() - st["t0"])
                if rc != 0:
                    for line in done[tag][0].splitlines():
                        log(f"[14 {tag}] | {line}")
                    st["err"].seek(0)
                    for line in error_lines(st["err"].read()):
                        log(f"[14 {tag}] ! {line}")
                    fail(f"phase 14({tag}): the trainer exited with {rc}")
            time.sleep(0.2)
    finally:
        stop_ranks(started)
    return done


def parse_par(tag, text, wall):
    """A finished run's output, logged line by line, and parsed."""
    for line in text.splitlines():
        log(f"[14 {tag}] | {line}")
    steps = PAR_STEP_LINE.findall(text)
    losses = [float(a) for a, _, _ in steps]
    gnorms = [float(b) for _, b, _ in steps]
    router = [float(c) for _, _, c in steps if c]
    done = re.search(r"^done: (\d+) steps in ([0-9.]+)s", text, re.M)
    pred = re.search(r"= ([0-9.]+) GB \(class", text)
    execution = re.search(r"^execution: .*remat=(\w+) micro=(\d+) .*"
                          r"ep=(True|False)", text, re.M)
    ranks = [dict(rank=int(m[0]), elements=int(m[1].replace(",", "")),
                  peak=float(m[2]) * 1e9, fwd=int(m[3]), bwd=int(m[4]),
                  staged=float(m[5]), comm_s=float(m[6]), kinds=m[7],
                  state=m[8], whole=m[9], routes=m[10])
             for m in PAR_RANK_LINE.findall(text)]
    if len(losses) != PAR_STEPS or not all(np.isfinite(losses)) or \
            done is None or pred is None or execution is None or \
            (par_cfg(tag).is_moe and len(router) != PAR_STEPS):
        fail(f"phase 14({tag}): losses {losses}, router gradient norms "
             f"{router}, or no done, prediction or execution line")
    peak = re.search(r"max_memory_allocated\(\) ([0-9.]+) GB", text)
    planning = re.search(r"^planning: (\d+) steps measured on the card in "
                         r"([0-9.]+)s", text, re.M)
    return {"losses": losses, "gnorms": gnorms, "router": router,
            "step_s": float(done.group(2)) / PAR_STEPS,
            "wall": wall, "predicted": float(pred.group(1)) * 1e9,
            "remat": execution.group(1), "micro": int(execution.group(2)),
            "ep": execution.group(3) == "True",
            "ranks": ranks, "peak0": float(peak.group(1)) * 1e9,
            "plans": re.findall(r"^rank \d+ plan: (.*)$", text, re.M),
            "planning": planning.groups() if planning else None,
            "memory": re.search(r"^memory: .*$", text, re.M)}


def judge_steps(tag, run, want, where):
    """A run's losses, step 1's gradient norm and (a MoE arch) step 1's
    router gradient norm against another run's (`want`, described by
    `where`): PAR_FIRST_BOUND, PAR_LATER_BOUND and PAR_GNORM_BOUND.
    Returns the log text."""
    rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                               want["losses"])]
    rel_g = abs(run["gnorms"][0] - want["gnorms"][0]) / abs(want["gnorms"][0])
    rel_r = (abs(run["router"][0] - want["router"][0]) / abs(
        want["router"][0]) if run["router"] else 0.0)
    text = (f"losses {run['losses']} against {where}'s {want['losses']} "
            f"(relative {rel}); step 1's gradient norm {run['gnorms'][0]!r}"
            f" against {want['gnorms'][0]!r} (relative {rel_g!r}); later "
            f"norms {run['gnorms'][1:]} against {want['gnorms'][1:]}")
    if run["router"]:
        text += (f"; the routers' gradient norms {run['router']} against "
                 f"{want['router']} (step 1 relative {rel_r!r})")
    if rel[0] > PAR_FIRST_BOUND or max(rel[1:]) > PAR_LATER_BOUND or \
            rel_g > PAR_GNORM_BOUND or rel_r > PAR_GNORM_BOUND:
        fail(f"phase 14({tag}): {text}: bounds {PAR_FIRST_BOUND} (step "
             f"1's loss), then {PAR_LATER_BOUND}; {PAR_GNORM_BOUND} on "
             "step 1's gradient norms")
    return text


def judge_run(runs, tag, tmp=None):
    """Phase 14's gates on one run: its losses and gradient norms against
    its one-rank run, each rank's parameter elements and flash launches,
    on a model axis the fingerprints of the leaves it holds whole (and a
    MoE arch's routes) equal on a model group's ranks and every rank's
    plan one; a MoE run's kept choices the global capacity rule's; and its
    report. Returns the run's flash forward and backward launches over its
    ranks (none for a one-rank run, which prints no rank line)."""
    _, mesh, _, ref, _, _ = PAR_BY_TAG[tag]
    run = runs[tag]
    cfg = par_cfg(tag)
    shape = par_mesh(mesh)
    micro = run["micro"]
    pipe = shape.get("pipe", 1)
    model = shape.get("model", 1)
    layers = cfg.n_layers // pipe
    twice = (2 if pipe > 1 else 1) * (2 if run["remat"] != "none" else 1)
    want_fwd = layers * micro * twice * PAR_STEPS
    want_bwd = layers * micro * PAR_STEPS
    if ref is None:
        log(f"[14 {tag}] one rank, {cfg.name} at {cfg.n_layers} layers, "
            f"{micro} microbatches: losses {run['losses']}, gradient norms "
            f"{run['gnorms']}{', router ' + str(run['router']) if run['router'] else ''}"
            f", {run['step_s']:.2f} s a step, peak "
            f"{run['peak0'] / 1e9:.3f} GB against "
            f"{run['predicted'] / 1e9:.3f} GB predicted "
            f"({run['peak0'] / run['predicted']:.4f}), {run['wall']:.2f} s "
            "with start-up")
        return 0, 0
    ref = ref.format(m=micro)
    if ref not in runs:
        fail(f"phase 14({tag}): no one-rank run {ref!r} to match its plan")
    text = judge_steps(tag, run, runs[ref], f"({ref})")
    log(f"[14 {tag}] --mesh {mesh}, {cfg.name} at {cfg.n_layers} layers, "
        f"remat {run['remat']}, {micro} microbatches, ep={run['ep']}: "
        f"{text}; {run['step_s']:.2f} s a step, {run['wall']:.2f} s with "
        "start-up")
    elements = rank_elements(cfg, shape, SHD.Strategy(
        ep=run["ep"], pipeline=pipe > 1))
    sharded = PR.sharded_param_count(cfg, shape)
    if len(run["ranks"]) != len(elements):
        fail(f"phase 14({tag}): {len(run['ranks'])} rank lines")
    fwd = bwd = 0
    for r in run["ranks"]:
        n = elements[r["rank"]]
        log(f"[14 {tag}] rank {r['rank']}: {r['elements']:,} parameter "
            f"elements (spec tree {n:,}; predictor.sharded_param_count "
            f"{sharded:,.0f}, difference {r['elements'] - sharded:,.0f}"
            f"); max_memory_allocated {r['peak'] / 1e9:.3f} GB against "
            f"{run['predicted'] / 1e9:.3f} GB predicted, measured / "
            f"predicted {r['peak'] / run['predicted']:.4f}; flash "
            f"launches {r['fwd']} / {r['bwd']} (predicted {want_fwd} / "
            f"{want_bwd}); staged through the host {r['staged']:.0f} B "
            f"a step ({r['kinds']}); collectives {r['comm_s']:.2f} s of "
            f"the step's {run['step_s']:.2f} s ({nvidia_smi_line()})")
        if r["elements"] != n:
            fail(f"phase 14({tag}): rank {r['rank']} holds "
                 f"{r['elements']} parameter elements, spec tree {n}")
        if pipe > 1 and "data" not in shape and n != sharded:
            fail(f"phase 14({tag}): {n} elements against the "
                 f"predictor's {sharded}")
        if (r["fwd"], r["bwd"]) != (want_fwd, want_bwd):
            fail(f"phase 14({tag}): rank {r['rank']} launched "
                 f"{r['fwd']} / {r['bwd']} flash kernels, predicted "
                 f"{want_fwd} / {want_bwd}")
        fwd, bwd = fwd + r["fwd"], bwd + r["bwd"]
    if model > 1:
        groups = {}
        for r in run["ranks"]:
            groups.setdefault(r["rank"] // model, set()).add(
                (r["whole"], r["routes"]))
        if any(len(g) != 1 for g in groups.values()):
            fail(f"phase 14({tag}): the leaves the model axis holds whole "
                 f"(the norms), or the MoE routes, differ between a model "
                 f"group's ranks after the last step: {groups}")
        log(f"[14 {tag}] the leaves each rank holds whole (the norms) "
            f"{'and the MoE routes ' if cfg.is_moe else ''}are "
            f"bit-identical on a model group's ranks after step "
            f"{PAR_STEPS}: fingerprints {sorted(groups.items())}")
    if len(set(run["plans"])) != 1 or len(run["plans"]) != len(elements):
        fail(f"phase 14({tag}): the ranks planned apart: {run['plans']}")
    if run["planning"] is not None:
        log(f"[14 {tag}] the online phase on the card: "
            f"{run['planning'][0]} steps measured over the model group in "
            f"{run['planning'][1]}s; every rank's class and plan "
            f"{run['plans'][0]}; {run['memory'].group(0)} (rank 0)")
    if cfg.is_moe:
        judge_train_routes(runs, tag, ref, cfg, tmp)
    return fwd, bwd


def tape_list(calls):
    """A keyed route tape's entries in the order of their sites."""
    return [calls[k] for k in sorted(calls, key=repr)]


def judge_train_routes(runs, tag, ref, cfg, tmp):
    """A MoE run's routes (rank 0's tape: the ranks route alike, their
    digests equal): every routing group's kept choices the global capacity
    rule's (judge_routes, which also counts where the one rank replaying
    them, `ref`, would have routed otherwise); a free one-rank run's
    partings from them and its losses, counted, not judged."""
    ranks = torch.load(routes_path(tmp, tag))
    one = torch.load(routes_path(tmp, ref))
    if sorted(ranks, key=repr) != sorted(one, key=repr):
        fail(f"phase 14({tag}): ({ref}) routed at other sites than the "
             "ranks")
    log(f"[14 {tag}] {len(ranks)} routing calls (step, layer), "
        + judge_routes(tag, cfg, tape_list(one), tape_list(ranks)))
    free = f"{ref.split()[0]} free"
    if free in runs:
        mine = torch.load(routes_path(tmp, free))
        n, parted = route_partings(tag, tape_list(mine), tape_list(ranks))
        rel = [abs(a - b) / abs(b) for a, b in zip(runs[free]["losses"],
                                                   runs[tag]["losses"])]
        log(f"[14 {tag}] a free one-rank run ({free}; its own routes; "
            f"counted, not judged): routes apart from the ranks' at "
            f"{parted} of {n} routed tokens, {parted / max(n, 1):.5f}; its "
            f"losses {runs[free]['losses']} relative {rel} to the ranks', "
            f"step 1's gradient norm {runs[free]['gnorms'][0]!r}, the "
            f"routers' {runs[free]['router'][0]!r}")


# ---------------------------------------------------------------------------
# (h): mixtral-8x7b under tensor parallelism inside the experts, by rank
# functions
# ---------------------------------------------------------------------------

# 1 of mixtral-8x7b's 32 layers at full width, on {data: 1, model: 2} under
# Strategy(ep=False): each rank its [gate_r | val_r] columns of all 8
# experts (wi [1, 8, 4096, 14336] a rank) and the router whole; the steps,
# optimizer and rows of (g), data from its own seed
PAR_H_DEPTH = 1
PAR_H_SEED = PAR_SEED + 14


def h_cfg():
    return depth_variant(get_config(MX_ARCH), PAR_H_DEPTH)


def h_train(cfg, params, device, mesh=None, specs=None, forced=None):
    """(h)'s PAR_STEPS Adafactor steps on `params` (this rank's shards on
    `mesh`, or the whole tree), every MoE routing call on a keyed route
    tape (forced to `forced`'s entries where given): the metrics, the tape,
    the flash launches, the step seconds and the final params and state."""
    tcfg = TS.TrainStepConfig(
        optimizer=OPT.OptimizerConfig(kind="adafactor", lr=TR_LR),
        warmup_steps=max(PAR_STEPS // 10, 1), total_steps=PAR_STEPS)
    step = SCH.make_train_step(cfg, tcfg, mesh=mesh, spec_tree=specs)
    state = OPT.init_state(tcfg.optimizer, params)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TR_SEQ, global_batch=2,
                                    seed=PAR_H_SEED))
    tape = MOE.RouteTape(forced, keyed=True)
    fa, fb = flash_attention.launches, flash_attention_bwd.launches
    t0 = time.time()
    with MOE.routing(tape):
        params, state, _, hist = FT.run_train_loop(
            train_step=step, params=params, opt_state=state, pipeline=pipe,
            n_steps=PAR_STEPS)
    torch.cuda.synchronize(device)
    return {"losses": [m["loss"] for m in hist],
            "gnorms": [m["grad_norm"] for m in hist],
            "router": [m["router_grad_norm"] for m in hist],
            "tape": tape.calls, "fwd": flash_attention.launches - fa,
            "bwd": flash_attention_bwd.launches - fb,
            "step_s": (time.time() - t0) / PAR_STEPS, "params": params,
            "state": state}


def h_rank(device):
    """One rank of (h), spawned by launch.mesh.spawn_ranks: its shards
    under Strategy(ep=False), drawn from PAR_H_SEED as one device draws
    them, then h_train; its shapes, peak, staged bytes by kind and
    fingerprints."""
    mesh = LM.build_mesh({"data": 1, "model": 2})
    cfg = h_cfg()
    specs = SHD.param_specs(cfg, init_params(None, cfg, device="meta"),
                            SHD.Strategy(ep=False), mesh)
    params = SHD.init_local_params(
        torch.Generator(device=device).manual_seed(PAR_H_SEED), cfg,
        device, specs, mesh)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    COMM.staged_by_kind.clear()
    out = h_train(cfg, params, device, mesh, specs)
    whole = [t for t, s in zip(tree_leaves(out["params"]),
                               tree_leaves(specs)) if "model" not in s.axes()]
    return {"rank": mesh.rank, "losses": out["losses"],
            "gnorms": out["gnorms"], "router": out["router"],
            "tape": out["tape"], "fwd": out["fwd"], "bwd": out["bwd"],
            "step_s": out["step_s"],
            "peak": torch.cuda.max_memory_allocated(device),
            "wi": tuple(out["params"]["units"][0]["mlp"]["wi"].shape),
            "router_shape": tuple(
                out["params"]["units"][0]["mlp"]["router"].shape),
            "elements": sum(t.numel() for t in tree_leaves(out["params"])),
            "staged": {k: v / PAR_STEPS
                       for k, v in COMM.staged_by_kind.items()},
            "whole": CK.fingerprint(whole)}


def run_h():
    """(h): its two ranks on the card over gloo, then one rank (in this
    process, the whole params from the same seed) taking their routes:
    (the ranks' results, the one rank's, the ranks' wall, the one rank's
    wall)."""
    t0 = time.time()
    ranks = LM.spawn_ranks(h_rank, 2, "gloo", "cuda", timeout=PAR_TIMEOUT)
    t1 = time.time()
    cfg = h_cfg()
    params = init_params(torch.Generator(device=DEV).manual_seed(PAR_H_SEED),
                         cfg, device=DEV)
    one = h_train(cfg, params, DEV, forced=ranks[0]["tape"])
    del params, one["params"], one["state"]
    torch.cuda.empty_cache()
    return ranks, one, t1 - t0, time.time() - t1


def judge_h(ranks, one, wall, one_wall):
    """(h)'s gates: each rank's wi every expert's [gate_r | val_r] columns
    and the router whole, its elements the spec tree's, its flash launches
    layers x steps; the ranks' losses, norms, routes and the leaves they
    hold whole equal; the one rank's losses and norms against theirs
    (judge_steps); the ranks' kept choices the global capacity rule's.
    Returns the launches over the ranks and the one rank."""
    cfg = h_cfg()
    shape = {"data": 1, "model": 2}
    elements = rank_elements(cfg, shape, SHD.Strategy(ep=False))
    want = PAR_H_DEPTH * PAR_STEPS
    r0 = ranks[0]
    for r in ranks:
        log(f"[14 h] rank {r['rank']} of 2: {r['elements']:,} parameter "
            f"elements (spec tree {elements[r['rank']]:,}), wi {r['wi']}, "
            f"router {r['router_shape']}; max_memory_allocated "
            f"{r['peak'] / 1e9:.3f} GB; flash launches {r['fwd']} / "
            f"{r['bwd']} (predicted {want} / {want}); {r['step_s']:.2f} s "
            f"a step; staged through the host a step "
            f"{ {k: round(v) for k, v in r['staged'].items()} } "
            f"({nvidia_smi_line()})")
        if r["wi"] != (PAR_H_DEPTH, cfg.n_experts, cfg.d_model, cfg.d_ff) \
                or r["router_shape"] != (PAR_H_DEPTH, cfg.d_model,
                                         cfg.n_experts):
            fail(f"phase 14(h): rank {r['rank']}'s wi {r['wi']} or router "
                 f"{r['router_shape']} is not TP inside the experts")
        if r["elements"] != elements[r["rank"]]:
            fail(f"phase 14(h): rank {r['rank']} holds {r['elements']} "
                 f"parameter elements, spec tree {elements[r['rank']]}")
        if (r["fwd"], r["bwd"]) != (want, want):
            fail(f"phase 14(h): rank {r['rank']} launched {r['fwd']} / "
                 f"{r['bwd']} flash kernels, predicted {want} / {want}")
        if (r["losses"], r["gnorms"], r["router"], r["whole"]) != (
                r0["losses"], r0["gnorms"], r0["router"], r0["whole"]):
            fail("phase 14(h): the ranks' losses, norms or the leaves they "
                 "hold whole differ")
        if route_partings("h", tape_list(r["tape"]),
                          tape_list(r0["tape"]))[1]:
            fail("phase 14(h): the ranks route apart")
    if (one["fwd"], one["bwd"]) != (want, want):
        fail(f"phase 14(h): one rank launched {one['fwd']} / {one['bwd']} "
             f"flash kernels, predicted {want} / {want}")
    text = judge_steps("h", r0, one, "one rank taking their routes")
    routes = judge_routes("h", cfg, tape_list(one["tape"]),
                          tape_list(r0["tape"]))
    log(f"[14 h] 2 ranks, {cfg.name} at {cfg.n_layers} layer(s), tensor "
        f"parallelism inside the experts: {text}; {routes}; walls "
        f"{wall:.2f}s (2 ranks with start-up, beside the runs of its wave) "
        f"and {one_wall:.2f}s (one rank, {one['step_s']:.2f} s a step)")
    return (sum(r["fwd"] for r in ranks) + one["fwd"],
            sum(r["bwd"] for r in ranks) + one["bwd"])


def _slices_fingerprint(full, specs, mesh):
    return CK.fingerprint([SHD.local_slice(t, s, mesh) for t, s in
                           zip(tree_leaves(full), tree_leaves(specs))])


def layout_ep(run, layout):
    """The expert layout a restore onto `layout` takes: " tp" tensor
    parallelism inside the experts, else the run's own."""
    return False if layout.endswith(" tp") else run["ep"]


def restore_fingerprints(device, ckpt_dir, tag, mesh_spec, ep):
    """One rank of `mesh_spec`: run `tag`'s checkpoint restored onto this
    rank's layout (under Strategy(ep)), on the card; its fingerprint and
    the shape of its first unit's leaves."""
    mesh = LM.build_mesh(par_mesh(mesh_spec))
    specs, target = par_layout(par_cfg(tag), mesh, ep,
                               par_flag(tag, "--optimizer", "adamw_f32"))
    tree, manifest = CK.restore(ckpt_dir, target, device=device, mesh=mesh,
                                spec_tree=specs)
    mlp = tree["params"]["units"][0]["mlp"]
    return {"rank": mesh.rank, "step": manifest["step"],
            "on_card": all(t.device == device for t in tree_leaves(tree)),
            "fingerprint": CK.fingerprint(tree),
            "wi": tuple(mlp["wi"].shape)}


def _spawn_restore(ckpt_dir, tag, layout, ep):
    """(the ranks' restore_fingerprints onto `layout`, seconds)."""
    t0 = time.time()
    res = LM.spawn_ranks(restore_fingerprints, int(np.prod(list(
        par_mesh(layout).values()))), "gloo", "cuda",
        args=(ckpt_dir, tag, layout, ep), timeout=PAR_TIMEOUT)
    return res, time.time() - t0


def check_restore(runs, tag, layouts, ckpt_dir):
    """Run `tag`'s checkpoint restored onto one device (the card, whole),
    each of its ranks' slices of it against the state that rank held at
    its last step, bit for bit (the fingerprints its rank line printed);
    and, at the same time, onto each layout of `layouts` by ranks of their
    own, each rank's leaves bit for bit the slices of the one-device
    restore."""
    cfg = par_cfg(tag)
    t0 = time.time()
    pool = ThreadPoolExecutor(len(layouts))
    spawned = {layout: pool.submit(_spawn_restore, ckpt_dir, tag, layout,
                                   layout_ep(runs[tag], layout))
               for layout in layouts}
    try:
        return _check_restores(runs, tag, cfg, ckpt_dir, spawned, t0)
    finally:
        pool.shutdown(wait=True)


def _check_restores(runs, tag, cfg, ckpt_dir, spawned, t0):
    mesh = PAR_BY_TAG[tag][1]
    kind = par_flag(tag, "--optimizer", "adamw_f32")
    abstract = init_params(None, cfg, device="meta")
    ocfg = OPT.OptimizerConfig(kind=kind)
    full, manifest = CK.restore(ckpt_dir, {
        "params": abstract, "opt": OPT.init_state(ocfg, abstract)},
        device=DEV)
    n_leaves = len(tree_leaves(full))
    size = sum(t.numel() * t.element_size() for t in tree_leaves(full))
    if manifest["step"] != PAR_STEPS:
        fail(f"phase 14({tag}): its checkpoint holds step "
             f"{manifest['step']}")
    shape = par_mesh(mesh)
    ep = runs[tag]["ep"]
    for r in runs[tag]["ranks"]:
        rm = rank_mesh(shape, r["rank"])
        got = _slices_fingerprint(full, par_layout(cfg, rm, ep, kind)[0], rm)
        if got != r["state"]:
            fail(f"phase 14({tag}): rank {r['rank']}'s slices of its "
                 f"checkpoint restored onto one device (fingerprint {got}) "
                 f"are not the state it held ({r['state']})")
    log(f"[14 {tag}] its checkpoint (step {manifest['step']}, {n_leaves} "
        f"leaves, {size} B) restored onto one device (the card): each "
        f"rank's slices of it are the params and optimizer state the rank "
        f"held, bit for bit ({time.time() - t0:.2f}s)")
    out = {"leaves": n_leaves, "bytes": size, "s": {}}
    for layout, fut in spawned.items():
        lshape = par_mesh(layout)
        lep = layout_ep(runs[tag], layout)
        res, out["s"][layout] = fut.result()
        for r in res:
            rm = rank_mesh(lshape, r["rank"])
            want = _slices_fingerprint(full, par_layout(cfg, rm, lep,
                                                        kind)[0], rm)
            if (r["fingerprint"] != want or not r["on_card"]
                    or r["step"] != PAR_STEPS):
                fail(f"phase 14({tag}): its checkpoint restored onto "
                     f"{layout}, rank {r['rank']}: fingerprint "
                     f"{r['fingerprint']} against the one-device restore's "
                     f"slices {want}, on the card {r['on_card']}, step "
                     f"{r['step']}")
        log(f"[14 {tag}] its checkpoint restored onto {layout} (wi "
            f"{res[0]['wi']} a rank): every rank's leaves equal the "
            f"one-device restore's slices bit for bit "
            f"({out['s'][layout]:.2f}s, beside the one-device restore)")
    del full
    torch.cuda.empty_cache()
    return out


def psum_check(device, shape):
    """compressed_psum over the data group of a data:2 world, on CUDA f32
    tensors of `shape`: its error against the exact mean, the shared
    scale, its time and the bytes it staged through the host."""
    mesh = LM.build_mesh({"data": 2})
    group, r = mesh.groups["data"], mesh.coords["data"]
    x = torch.randn(shape, generator=torch.Generator(device=device)
                    .manual_seed(SEED + 140 + r), device=device)
    scale = float(COMM.all_reduce(x.abs().max(), group, op="max")) / 127.0
    staged = COMM.staged_bytes
    torch.cuda.synchronize()
    t0 = time.time()
    got = compressed_psum(x, group, torch.Generator(device=device)
                          .manual_seed(SEED + 150 + r))
    torch.cuda.synchronize()
    dt = time.time() - t0
    staged = COMM.staged_bytes - staged
    want = COMM.all_reduce(x, group)
    del x
    err = float((got - want / 2).abs().max())
    return {"err": err, "scale": scale, "ms": dt * 1e3, "staged": staged,
            "on_card": got.is_cuda}


def psum_phase(cfg):
    """compressed_psum at the largest leaf's size, two ranks."""
    abstract = init_params(None, cfg, device="meta")
    big = max(tree_leaves(abstract), key=lambda t: t.numel())
    shape = tuple(big.shape)
    del abstract
    out = LM.spawn_ranks(psum_check, 2, "gloo", "cuda", args=(shape,),
                         timeout=PAR_TIMEOUT)
    for r, res in enumerate(out):
        log(f"[14 psum] rank {r}: compressed_psum over [{shape}] f32 on the "
            f"card {res['on_card']}: max abs err {res['err']!r} against "
            f"the exact mean, scale {res['scale']!r} (bound 1.5 x scale = "
            f"{1.5 * res['scale']!r}); {res['ms']:.1f} ms, staged through "
            f"the host {res['staged']} B")
        if not res["on_card"] or res["err"] > 1.5 * res["scale"]:
            fail(f"phase 14(psum): compressed_psum err {res['err']} > 1.5 x "
                 f"{res['scale']}")
    return {"shape": shape, "err": max(r["err"] for r in out),
            "scale": out[0]["scale"]}


PAR_BY_TAG = {r[0]: r for r in PAR_RUNS}


def par_ready(runs, tag):
    """Whether run `tag`'s one-rank run has finished (or it has none)."""
    ref = PAR_BY_TAG[tag][3]
    return ref is None or ref.format(m=runs[tag]["micro"]) in runs


def phase_parallel(only=None):
    """Phase 14: the trainer on meshes of ranks sharing the card over
    gloo, the runs of a wave (PAR_WAVES) at once, each run judged against
    its one-rank run once that has run ((h), rank functions, in a thread
    beside its wave); the checkpoints of (b), (d) and (g) restored onto
    other layouts; compressed_psum at the largest leaf's size. `only`
    limits the runs (and the checks that need them) to those tags."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_par_")
    runs, walls, launches, restores = {}, {}, {}, {}

    def restore_all(todo):
        for tag, layouts, _ in todo:
            restores[tag] = check_restore(runs, tag, layouts,
                                          os.path.join(tmp, f"ckpt_{tag}"))
            shutil.rmtree(os.path.join(tmp, f"ckpt_{tag}"),
                          ignore_errors=True)

    later = []               # restores to make while a later wave runs
    pool = ThreadPoolExecutor(1)
    h = None
    try:
        for wave in PAR_WAVES:
            wave = [t for t in wave if only is None or t in only]
            if not wave:
                continue
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            t0 = time.time()
            started = {}
            try:
                if "h" in wave:
                    h = pool.submit(run_h)
                for tag in wave:
                    if tag != "h":
                        started[tag] = start_par(tag, tmp)
                now = [r for r in later if r[2] in wave]
                later = [r for r in later if r not in now]
                restore_all(now)
            except BaseException:
                stop_ranks(started)
                raise
            later += [r for r in PAR_RESTORES if r[0] in wave]
            done = wait_par(started)
            if "h" in wave:
                try:
                    h = h.result()
                except (RuntimeError, TimeoutError) as e:
                    fail(f"phase 14(h): its ranks failed: {e}")
            walls["wave " + ", ".join(wave)] = time.time() - t0
            for tag in started:
                runs[tag] = parse_par(tag, *done[tag])
            for tag in runs:
                if tag not in launches and par_ready(runs, tag):
                    launches[tag] = judge_run(runs, tag, tmp)
            if "h" in wave:
                launches["h"] = judge_h(*h)
                walls["h"], walls["h one rank"] = h[2], h[3]
        for tag in runs:
            if tag not in launches:
                launches[tag] = judge_run(runs, tag, tmp)
        restore_all(later)
        psum = psum_phase(par_cfg("0 m4")) if only is None else None
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    log("[14] walls " + ", ".join(f"({k}) {v:.2f}s"
                                  for k, v in walls.items()))
    log("[14] flash launches forward / backward over each run's ranks: "
        + ", ".join(f"({k}) {f} / {b}" for k, (f, b) in launches.items()
                    if f or b))
    log("[14] these runs are ranks sharing one card over gloo (each "
        "collective staged through the host), the runs of a wave beside "
        "each other, not a multi-GPU measurement")
    return {"fwd": sum(f for f, _ in launches.values()),
            "bwd": sum(b for _, b in launches.values()),
            "by_run": launches, "restore": restores, "psum": psum}


# ---------------------------------------------------------------------------
# Phase 15: the dry-run, the roofline, the hillclimb and the reports
# ---------------------------------------------------------------------------

# the cells one card holds: the simulator's peak under the plan budget
# (80 GB / (4/3) - 300 MB) at --max-devices 1
DR_CELLS = (("h2o-danube-1.8b", "long_500k"), ("xlstm-1.3b", "long_500k"),
            ("recurrentgemma-9b", "long_500k"),
            ("recurrentgemma-9b", "decode_32k"))
HC_VARIANTS = ("baseline", "remat_dots", "remat_full", "onehot_embed")
HC_MEMORY_CELL = DR_CELLS[0]


def in_process(tag, main, argv, quiet=False):
    """main(argv) in process, its standard output captured (and logged
    line by line unless `quiet`); launch counters zeroed just before and
    read just after. Fails the run on a non-zero return, an exit or an
    exception. Returns (output, launches, wall)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _zero_launches()
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    except SystemExit as e:
        rc = f"exit {e.code}"
    except Exception as e:              # noqa: BLE001 — logged, then failed
        rc = f"{type(e).__name__}: {e}"
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    out = buf.getvalue()
    if not quiet or rc != 0:
        for line in out.splitlines():
            log(f"[15{tag}] | {line}")
    if rc not in (0, None):
        fail(f"phase 15({tag}): {main.__module__}.main returned {rc}")
    return out, counts, wall


def read_cell(d, arch, shape):
    with open(os.path.join(d, f"{arch}__{shape}.json")) as f:
        return json.load(f)


def n_attention(cfg):
    return sum(b.is_attn for b in cfg.blocks())


def dryrun_sweep(d, kb):
    """(a): the simulate sweep over every arch x shape on both production
    meshes."""
    _, counts, wall = in_process("a", DR.main, [
        "--backend", "simulate", "--arch", "all", "--shape", "all",
        "--mesh", "both", "--out", d, "--kb", kb], quiet=True)
    cells = SUM.load_cells(d)
    n = {s: sum(c["status"] == s for c in cells.values())
         for s in ("ok", "skipped", "failed")}
    log(f"[15a] simulate sweep, every arch x shape on 16x16 and 2x16x16: "
        f"{n['ok']} ok, {n['skipped']} skipped, {n['failed']} failed of "
        f"{len(cells)} cells; {wall:.2f}s")
    if n["failed"] or len(cells) != 40 or any(counts.values()):
        fail(f"phase 15(a): {n} of {len(cells)} cells, launches {counts}")
    return {"n": n, "wall": wall}


def dryrun_card(d_sim, d_card, kb):
    """(b): the four cells planned at --max-devices 1 by the simulator,
    each confirmed to fit one card, then measured on it (--backend cuda)
    with the roofline counted on the meta device."""
    budget = ST.plan_budget(HW.H100)
    left = torch.cuda.memory_allocated()
    log(f"[15b] allocated before the cells: {left} B")
    rows = []
    for arch, shape in DR_CELLS:
        cell_argv = ["--mesh", "auto", "--max-devices", "1", "--arch", arch,
                     "--shape", shape, "--kb", kb]
        in_process("b", DR.main, ["--backend", "simulate", "--out", d_sim]
                   + cell_argv, quiet=True)
        sim = read_cell(d_sim, arch, shape)
        peak = sim["mesh_planned"]["peak_static_bytes"]
        if sim["status"] != "ok" or peak > budget:
            fail(f"phase 15(b): {arch} x {shape}: the planner's cell "
                 f"{sim['status']}, simulated peak {peak} B over the plan "
                 f"budget {budget:.0f} B")
        _, counts, wall = in_process("b", DR.main, [
            "--backend", "cuda", "--out", d_card] + cell_argv)
        c = read_cell(d_card, arch, shape)
        e, r = c.get("mesh_planned", {}), c.get("roofline", {})
        cfg = get_config(arch)
        want = {"decode_attention": n_attention(cfg)}
        if (c["status"] != "ok" or c.get("backend") != "cuda"
                or e.get("n_devices") != 1
                or e.get("max_memory_allocated", 0) <= 0
                or "error" in r or r.get("flops_per_chip", 0) <= 0
                or r.get("hw") != HW.H100.name):
            fail(f"phase 15(b): {arch} x {shape}: status {c['status']}, "
                 f"backend {c.get('backend')}, mesh entry {e}, roofline {r}")
        if counts != {k: want.get(k, 0) for k in counts}:
            fail(f"phase 15(b): {arch} x {shape}: launches {counts}, want "
                 f"{want} (one measured decode step)")
        with open(kb) as f:
            k = json.load(f)[f"{cfg.name}::{c['kind']}"]
        p = c["execution_plan"]
        log(f"[15b] {arch} x {shape}: class {k['category']} (alpha "
            f"{k['alpha']!r}); plan mesh={p['mesh']} schedule="
            f"{p['schedule']} {p['plan']} policy={p['policy']}; simulated "
            f"peak {peak} B (budget {budget:.0f}); on the card "
            f"max_memory_allocated {e['max_memory_allocated']} B, "
            f"predicted {e['predicted_bytes']:.0f} B (measured / predicted "
            f"{e['measured_over_predicted']!r}), simulated "
            f"{e['simulated_peak_bytes']:.0f} B (measured / simulated "
            f"{e['measured_over_simulated']!r}); roofline under HW.H100 "
            f"(computed from the counts) t_comp {r['t_comp']!r} s, t_mem "
            f"{r['t_mem']!r} s (analytic {r['t_mem_analytic']!r}), t_coll "
            f"{r['t_coll']!r} s, bottleneck {r['bottleneck']}, "
            f"flops {r['flops_per_chip']!r}, bytes {r['bytes_per_chip']!r}, "
            f"MODEL/counted {r['useful_flops_ratio']!r}, counted in "
            f"{r['analysis_s']}s; launches {counts}; {wall:.2f}s")
        rows.append({"arch": arch, "shape": shape, "wall": wall,
                     "launches": counts["decode_attention"]})
    return rows


def hillclimb_card(d):
    """(c): four variants of h2o-danube-1.8b x train_4k counted (one with
    no counterpart), then one --memory baseline on a cell of (b)."""
    out, counts, wall = in_process("c", HC.main, [
        "--arch", TR_ARCH, "--shape", "train_4k", "--variants",
        ",".join(HC_VARIANTS), "--out", d])
    with open(os.path.join(d, f"{TR_ARCH}__train_4k.json")) as f:
        res = json.load(f)
    refused = re.search(r"^onehot_embed +FAILED: no counterpart on one "
                        r"card: embed_onehot$", out, re.M)
    if refused is None or sorted(res) != sorted(HC_VARIANTS[:3]) or \
            any(counts.values()):
        fail(f"phase 15(c): results {sorted(res)}, the one-hot line "
             f"{refused is not None}, launches {counts}")
    base, full = res["baseline"], res["remat_full"]
    # the counter sees every product of the step: forward, backward
    # (twice the forward's products) and remat's recompute, so the model's
    # 6·N·D (+ attention) is at most what it counts
    if any(r["flops_per_chip"] <= 0 or r["useful_flops_ratio"] > 1.0
           for r in res.values()) or full["t_comp"] <= base["t_comp"]:
        fail("phase 15(c): counted " + ", ".join(
            f"{n} {r['flops_per_chip']!r} FLOPs, MODEL/counted "
            f"{r['useful_flops_ratio']!r}" for n, r in res.items()))
    log(f"[15c] {TR_ARCH} x train_4k counted: " + "; ".join(
        f"{n} t_comp {r['t_comp']!r} s t_mem {r['t_mem']!r} s "
        f"MODEL/counted {r['useful_flops_ratio']!r}"
        for n, r in res.items()) + f"; {wall:.2f}s")
    arch, shape = HC_MEMORY_CELL
    _, counts, wall_m = in_process("c", HC.main, [
        "--arch", arch, "--shape", shape, "--variants", "baseline",
        "--memory", "--out", d])
    with open(os.path.join(d, f"{arch}__{shape}.json")) as f:
        mem = json.load(f)["baseline"]
    n = n_attention(get_config(arch))
    if (mem.get("argument_bytes", 0) <= 0
            or counts != {k: n if k == "decode_attention" else 0
                          for k in counts}):
        fail(f"phase 15(c): --memory baseline {mem}, launches {counts}")
    log(f"[15c] {arch} x {shape} --memory baseline: argument "
        f"{mem['argument_bytes']} B, transient {mem['temp_bytes']} B, "
        f"t_comp {mem['t_comp']!r} s; ring decode launches "
        f"{counts['decode_attention']}; {wall_m:.2f}s")
    return {"wall": wall + wall_m, "launches": counts["decode_attention"]}


def reports(d_card, kb, d_hc):
    """(d): summarize and report_experiments over (b)'s cells."""
    summary, _, w1 = in_process("d", SUM.main, d_card)
    text, _, w2 = in_process("d", REP.main, ["--dryrun", d_card, "--kb", kb,
                                             "--hillclimb", d_hc])
    rows = [ln for ln in summary.splitlines()
            if ln.startswith("| ") and "**" in ln]
    if (f"{len(DR_CELLS)} ok / 0 skipped / 0 failed" not in summary
            or len(rows) != len(DR_CELLS) or "v5e" in text
            or "197e12" in text or torch.cuda.get_device_name(0) not in text):
        fail(f"phase 15(d): {len(rows)} roofline rows, or the report names "
             "a TPU or not the card")
    log(f"[15d] summarize and report_experiments over (b)'s cells: "
        f"{len(rows)} roofline rows; {w1 + w2:.2f}s")


def phase_dryrun():
    """Phase 15: the dry-run swept by the simulator, four cells measured
    on the card with their rooflines, the hillclimb, the reports."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    d = {k: os.path.join(tmp, k) for k in ("sweep", "sim", "card", "hc")}
    kb = os.path.join(tmp, "kb.json")
    walls = {}
    try:
        t0 = time.time()
        dryrun_sweep(d["sweep"], kb)
        walls["a"] = time.time() - t0
        t0 = time.time()
        cells = dryrun_card(d["sim"], d["card"], kb)
        walls["b"] = time.time() - t0
        t0 = time.time()
        hc = hillclimb_card(d["hc"])
        walls["c"] = time.time() - t0
        t0 = time.time()
        reports(d["card"], kb, d["hc"])
        walls["d"] = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("[15] walls " + ", ".join(f"({k}) {v:.2f}s" for k, v in walls.items()))
    return {"decode_attention": sum(c["launches"] for c in cells)
            + hc["launches"]}


# ---------------------------------------------------------------------------
# Phase 16: serving on a model axis (tensor parallelism over ranks)
# ---------------------------------------------------------------------------

# the seeded trace of (a)-(c): 8 requests, prompts of 64-1024 tokens, 16-32
# generated; the pool pinned (blocks of 16, 8 lanes) so that one rank and
# the ranks plan the same pool and run the same schedule
TP_TRACE = ["--requests", "8", "--prompt-lens", "64,256,520,1024",
            "--gen-lens", "16,24,32", "--seed", str(SEED + 16),
            "--max-slots", "8"]
TP_PAGED = ["--arch", "mistral-nemo-12b", "--kv", "paged", "--compact",
            "--chunk-prefill", "256", "--kv-block", "16", "--audit",
            "strict", *TP_TRACE]
# (a) and (c) run 10 of mistral-nemo-12b's 40 layers, cut for the
# script's time limit (PERF.md lists the cuts with the seconds they saved).
# (b) keeps its 40: at 10 layers the ranks' retention dropped other blocks
# than one rank's under the same tokens (attention masses near a tie,
# summed in another order), which its schedule check refuses
TP_CUT = 10
# (d): 8 of mistral-nemo-12b's 40 layers on model:4, 4 requests
TP_DEEP4 = ["--arch", "mistral-nemo-12b", "--depth", "8", "--kv", "paged",
            "--compact", "--chunk-prefill", "256", "--kv-block", "16",
            "--requests", "4", "--prompt-lens", "64,520,1024", "--gen-lens",
            "16,32", "--seed", str(SEED + 17), "--max-slots", "4"]
# (e): gemma3-12b at 2 of its 8 units (12 layers) through the slot engine
TP_RING = ["--arch", "gemma3-12b", "--depth", "2", "--kv", "ring",
           "--requests", "4", "--prompt-lens", "64,256,1200", "--gen-lens",
           "16,24", "--seed", str(SEED + 18), "--max-slots", "4"]
# (c): planned by CudaMeasurer over the model axis, then a short trace
TP_CUDA = ["--arch", "mistral-nemo-12b", "--kv", "paged", "--compact",
           "--chunk-prefill", "256", "--kv-block", "16", "--backend", "cuda",
           "--depth", str(TP_CUT), "--requests", "2", "--prompt-lens",
           "64,256", "--gen-lens", "16", "--seed", str(SEED + 19),
           "--max-slots", "8"]
# (f): mixtral-8x7b at full width and 8 of its 32 layers on model:2, paged
# as (a), under the expert parallelism its plan resolves (8 experts tile the
# axis: 4 a rank); the ranks write their MoE routes for the replay
TP_MOE_DEPTH = 8
TP_MOE = ["--arch", "mixtral-8x7b", "--depth", str(TP_MOE_DEPTH), "--kv",
          "paged", "--compact", "--chunk-prefill", "256", "--kv-block", "16",
          "--audit", "strict", *TP_TRACE]
# (tag, argv, model ranks, whether one rank replays the ranks' tokens; (c)'s
# ranks are held to each other only). (g) is no CLI run: tp_experts_rank
TP_STEPS = (("a", TP_PAGED + ["--depth", str(TP_CUT)], 2, True),
            ("b", TP_PAGED + ["--kv-quant", "int8", "--kv-retain", "2"], 2,
             True),
            ("c", TP_CUDA, 2, False),
            ("d", TP_DEEP4, 4, True),
            ("e", TP_RING, 2, True),
            ("f", TP_MOE, 2, True))
# (g): mixtral-8x7b at 2 layers on model:2 under tensor parallelism inside
# the experts (each rank its [gate_r | val_r] columns of all 8 experts):
# one request, a 300-token prompt (chunks of 256 and 44) and 6 tokens (5
# decode steps), through the paged engine that rank functions build
TP_EXPERTS_DEPTH = 2
TP_EXPERTS_SEED = SEED + 20
TP_EXPERTS_TRACE = dict(prompt_lens=(300,), gen_lens=(6,))
# the steps whose ranks share the card at once. A rank draws its shards
# slice by slice (sharding.init_local_params), so it peaks near its shards:
# mistral-nemo-12b at 40 layers 12.2 GB of bf16 a rank, mixtral-8x7b at 8
# layers 11.9 GB, and (b) and (f) share a wave, four processes; (d) (8
# layers, 4 ranks) and (e) (12 layers, 2 ranks) together peak near 35 GB.
# (a) and (c) at 10 layers (under 5 GB a rank) share a wave with (g) (2
# layers, under 4 GB a rank), six processes: beside (d) and (e) (eight), a
# rank of (d) met "Connection closed by peer" in a collective
TP_WAVES = (("a", "c", "g"), ("b", "f"), ("d", "e"))
# per-device planning budgets (GiB): the ranks' plans fit the card together
TP_BUDGET_GB = {1: 60, 2: 30, 4: 16}
TP_TIMEOUT = 400
# The ranks' logits against one rank's at every token the ranks emitted
# (one rank replays the ranks' tokens, so both saw the same tokens before
# each): the largest difference at the ids both put in their top 8, over the
# one-rank row's standard deviation. The two sum their f32 partial products
# in other orders and split B1's context at other points, and carry those
# roundings through bf16 activations of every layer and every earlier
# token's K/V: a drift of a few per cent of the spread rms, and a tail over
# hundreds of tokens x 8 ids. A path that attends to wrong rows or heads, or
# sums the wrong pieces, leaves logits of the order of the spread apart
# (a GLU `wi` cut contiguously: 1.40 of it, PERF.md).
TP_DRIFT_BOUND = 0.25
TP_RANK_LINE = re.compile(
    r"^rank (\d+) \{[^}]*\}: param elements ([0-9,]+) \(spec tree "
    r"([0-9,]+); sharded_param_count ([0-9,]+)\); pool (\d+) B \(predicted "
    r"(\d+) B\); max_memory_allocated ([0-9.]+) GB \(predicted ([0-9.]+) "
    r"GB, measured / predicted ([0-9.]+)\); launches paged_decode (\d+), "
    r"paged_prefill (\d+), decode_attention (\d+), flash_attention (\d+); "
    r"calls decodes (\d+), chunk_calls (\d+), prefills (\d+), "
    r"prefill_calls (\d+); staged through the host (\d+) B \((.*)\); "
    r"schedule digest (\w+); tokens digest (\w+)$", re.M)


def tp_cfg(argv):
    cfg = get_config(argv[argv.index("--arch") + 1])
    if "--depth" in argv:
        cfg = depth_variant(cfg, int(argv[argv.index("--depth") + 1]))
    return cfg


def _served(tag, out):
    """(tokens digest, pool line, completed requests) of a CLI run."""
    dig = re.search(r"^tokens digest (\w+)$", out, re.M)
    pool = re.search(r"^pool: (.*)$", out, re.M)
    done = re.search(r"completed=(\d+)", out)
    if dig is None or pool is None or done is None:
        fail(f"phase 16({tag}): no digest, pool or report line")
    return dig.group(1), pool.group(1), int(done.group(1))


def replay_one(tag, argv, tokens_out, replay, extra=()):
    """The serve CLI on one rank, in process, replaying the tokens of
    another run's --tokens-out file (`replay`) and writing its own logits
    at each (`tokens_out`), `extra` arguments after them: its digest,
    pool, schedule digest and wall."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            rc = SV.main(argv + ["--tokens-out", tokens_out, "--replay",
                                 replay, "--device", "cuda", "--hbm-budget-gb",
                                 str(TP_BUDGET_GB[1]), *extra])
    except Exception as e:              # noqa: BLE001 — logged, then failed
        rc = f"{type(e).__name__}: {e}"
    torch.cuda.synchronize()
    wall = time.time() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[16{tag} one rank] | {line}")
    if rc != 0:
        fail(f"phase 16({tag}): the one-rank serve CLI returned {rc}")
    digest, pool, done = _served(tag, out)
    sched = re.search(r"^schedule digest (\w+)$", out, re.M)
    torch.cuda.empty_cache()
    return {"digest": digest, "pool": pool, "done": done, "wall": wall,
            "schedule": sched.group(1) if sched else "none",
            "tokens": tokens_out}


def routes_file(tmp, tag, side):
    return os.path.join(tmp, f"{tag}_{side}_routes.pt")


def start_ranks(tag, argv, world, tokens_out, tmp):
    """The serve CLI on `world` model ranks sharing the card over gloo,
    started in a subprocess leading a process group of its own (it spawns
    its ranks; stop_ranks kills the group), its tokens and the logits at
    each written to `tokens_out`, a MoE arch's routes too."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *argv,
           "--device", "cuda", "--model-parallel", str(world),
           "--dist-backend", "gloo", "--hbm-budget-gb",
           str(TP_BUDGET_GB[world]), "--tokens-out", tokens_out]
    if tp_cfg(argv).is_moe:
        cmd += ["--routes-out", routes_file(tmp, tag, "ranks")]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = open(os.path.join(tmp, f"{tag}.out"), "w+")
    err = open(os.path.join(tmp, f"{tag}.err"), "w+")
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=out, stderr=err,
                            text=True, start_new_session=True)
    return {"proc": proc, "out": out, "err": err, "t0": time.time(),
            "world": world, "tokens": tokens_out}


def stop_ranks(started):
    """Kills what is left of the started runs (each CLI with its ranks)."""
    for st in started.values():
        if st["proc"].poll() is None:
            try:
                os.killpg(st["proc"].pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            st["proc"].wait()


def wait_ranks(started):
    """Waits for every started run, each given TP_TIMEOUT from its start;
    a run that exits non-zero or runs out of time stops the others and
    fails the phase. Returns {tag: wall}."""
    walls = {}
    while len(walls) < len(started):
        for tag, st in started.items():
            if tag in walls:
                continue
            rc = st["proc"].poll()
            if rc is None and time.time() - st["t0"] > TP_TIMEOUT:
                stop_ranks(started)
                fail(f"phase 16({tag}): the serve CLI ran past "
                     f"{TP_TIMEOUT} s")
            if rc is None:
                continue
            walls[tag] = time.time() - st["t0"]
            if rc != 0:
                stop_ranks(started)
                read_ranks(tag, st, walls[tag])
                st["err"].seek(0)
                for line in error_lines(st["err"].read()):
                    log(f"[16{tag}] ! {line}")
                fail(f"phase 16({tag}): the serve CLI on {st['world']} ranks "
                     f"exited with {rc}")
        time.sleep(0.2)
    return walls


def read_ranks(tag, st, wall):
    """A finished run's output, logged line by line, and parsed: its
    digest, pool, completions, one record a rank and the ranks' plans."""
    st["out"].seek(0)
    text = st["out"].read()
    for line in text.splitlines():
        log(f"[16{tag}] | {line}")
    if st["proc"].returncode != 0:
        return None
    world = st["world"]
    digest, pool, done = _served(tag, text)
    ranks = []
    for m in TP_RANK_LINE.findall(text):
        (r, el, spec_el, sharded, pool_b, pool_p, peak, pred, ratio, pd,
         pp, da, fa, dec, chunks, pre, pre_calls, staged, kinds, sched,
         dig) = m
        ranks.append(dict(
            rank=int(r), elements=int(el.replace(",", "")),
            spec=int(spec_el.replace(",", "")),
            sharded=int(sharded.replace(",", "")), pool=int(pool_b),
            pool_pred=int(pool_p), peak=float(peak) * 1e9,
            pred=float(pred) * 1e9, ratio=float(ratio),
            launches={"paged_decode": int(pd), "paged_prefill": int(pp),
                      "decode_attention": int(da),
                      "flash_attention": int(fa)},
            decodes=int(dec), chunks=int(chunks), prefill_calls=int(pre_calls),
            staged=int(staged), kinds=kinds, schedule=sched, digest=dig))
    plans = re.findall(r"^rank (\d+) plan: (.*)$", text, re.M)
    planning = re.findall(r"^rank (\d+) planning step (.*)$", text, re.M)
    drawn = dict(re.findall(r"^rank (\d+) params drawn: "
                            r"max_memory_allocated ([0-9.]+) GB", text, re.M))
    for r in ranks:
        r["draw_peak"] = float(drawn.get(str(r["rank"]), "nan")) * 1e9
    if len(ranks) != world or len(plans) != world:
        fail(f"phase 16({tag}): {len(ranks)} rank lines, {len(plans)} plan "
             f"lines for {world} ranks")
    return {"digest": digest, "pool": pool, "done": done, "wall": wall,
            "ranks": ranks, "plans": [p for _, p in plans],
            "planning": planning, "tokens": st["tokens"]}


def judge_logits(tag, run, one, judged=True):
    """The ranks' served logits against one rank's at every token the ranks
    emitted: one rank replayed the ranks' tokens, so each token's row on
    both sides follows the same tokens. Each side's row is the top 8 logits
    of the step that emitted the token. Fails where a side logged nothing,
    where one rank does not put the ranks' token in its top 8, where the
    ranks do not put one rank's argmax in theirs, or where the logits at
    the ids both hold differ by more than TP_DRIFT_BOUND of one rank's
    spread. Where one rank's argmax is another token (trap T2: the ranks'
    own run parts there from one rank's), both gaps between the two tokens
    are logged. With `judged` False nothing fails and nothing is logged:
    a token without a common top 8 is counted with those over the bound.
    Returns (tokens compared, tokens where the argmaxes differ, the
    largest difference over the spread, the rms of them all, tokens past
    the bound or without a common top 8)."""
    with open(run["tokens"]) as f:
        mine = json.load(f)
    with open(one["tokens"]) as f:
        theirs = json.load(f)
    if mine["tokens"] != theirs["tokens"]:
        fail(f"phase 16({tag}): one rank did not replay the ranks' tokens")
    n, parted, worst, sq, m, over = 0, 0, 0.0, 0.0, 0, 0
    for rid in sorted(mine["tokens"], key=int):
        toks = mine["tokens"][rid]
        for k, tok in enumerate(toks):
            a, b = mine["logits"][rid][k], theirs["logits"][rid][k]
            if a is None or b is None:
                fail(f"phase 16({tag}): request {rid} token {k}: no logits "
                     "logged")
            ta, tb = dict(zip(a[0], a[1])), dict(zip(b[0], b[1]))
            std, best = b[2], b[0][0]
            if tok not in ta or tok not in tb or best not in ta:
                if not judged:
                    over += 1
                    n += 1
                    continue
                fail(f"phase 16({tag}): request {rid} token {k}: the ranks "
                     f"emit {tok}, one rank's argmax is {best}, and one "
                     "side's top 8 lacks the other's token: not a near-tie")
            rel = [abs(ta[i] - tb[i]) / std for i in ta if i in tb]
            drift = max(rel)
            worst = max(worst, drift)
            sq += sum(r * r for r in rel)
            m += len(rel)
            over += drift > TP_DRIFT_BOUND
            if best != tok:
                parted += 1
            if best != tok and judged:
                log(f"[16{tag}] request {rid} token {k}: the ranks' argmax "
                    f"{tok} is {(ta[tok] - ta[best]) / a[2]:.4f} of their "
                    f"spread above {best}; one rank's {best} "
                    f"{(tb[best] - tb[tok]) / std:.4f} of its spread above "
                    f"{tok} (a near-tie)")
            if drift > TP_DRIFT_BOUND and judged:
                fail(f"phase 16({tag}): request {rid} token {k}: the ranks' "
                     f"top logits {drift:.4f} of the spread from one rank's "
                     f"(bound {TP_DRIFT_BOUND}): not a rounding drift")
            n += 1
    return n, parted, worst, (sq / max(m, 1)) ** 0.5, over


def judge_tp(tag, argv, world, run, one):
    """Phase 16's gates on one run of `world` ranks and its one-rank replay
    (or None): the same pool, completions and block-table schedule
    (retention's drops included) as one rank under the same tokens, and the
    served logits at every token within TP_DRIFT_BOUND (judge_logits);
    every rank's tokens, schedule and plan rank 0's; each rank's parameter
    elements the spec tree's shard, its pool the predictor's per-device
    blocks, its kernels launched once a layer and call; its peak beside
    the plan's prediction and its staged bytes printed. Returns the ranks'
    launches summed."""
    cfg = tp_cfg(argv)
    n_attn = n_attention(cfg)
    paged = "paged" in argv
    mesh_shape = {"data": 1, "model": world}
    elements = rank_elements(cfg, mesh_shape,
                             SHD.default_strategy(cfg, mesh_shape))
    if one is not None:
        if (run["pool"], run["done"]) != (one["pool"], one["done"]):
            fail(f"phase 16({tag}): {world} ranks ran pool {run['pool']} "
                 f"and completed {run['done']}, one rank pool "
                 f"{one['pool']} and {one['done']}")
        if paged and one["schedule"] != run["ranks"][0]["schedule"]:
            fail(f"phase 16({tag}): under the same tokens the ranks gave "
                 "their steps other block tables than one rank (schedule "
                 f"{run['ranks'][0]['schedule'][:16]}, one rank "
                 f"{one['schedule'][:16]})")
        compared, parted, worst, rms, _ = judge_logits(tag, run, one)
    if len(set(run["plans"])) != 1:
        fail(f"phase 16({tag}): the ranks planned apart: {run['plans']}")
    total = {k: 0 for k in ("paged_decode", "paged_prefill",
                            "decode_attention", "flash_attention")}
    for r in run["ranks"]:
        # the card's planning steps (CudaMeasurer: a ring decode or a
        # prefill at a ladder point) launch the ring decode or the flash
        # kernel once a layer too
        steps = [t.split()[0] for k, t in run["planning"]
                 if int(k) == r["rank"]]
        want = {"paged_decode": n_attn * r["decodes"] if paged else 0,
                "paged_prefill": n_attn * r["chunks"] if paged else 0,
                "decode_attention": n_attn * (
                    steps.count("decode")
                    + (0 if paged else r["decodes"])),
                "flash_attention": n_attn * (r["prefill_calls"]
                                             + steps.count("prefill"))}
        log(f"[16{tag}] rank {r['rank']} of {world}: {r['elements']:,} "
            f"parameter elements (spec tree {elements[r['rank']]:,}; "
            f"predictor.sharded_param_count {r['sharded']:,}, difference "
            f"{r['elements'] - r['sharded']:,}: the replicated norms); pool "
            f"{r['pool']} B against the predictor's {r['pool_pred']} B; "
            f"max_memory_allocated {r['peak'] / 1e9:.3f} GB against the "
            f"plan's {r['pred'] / 1e9:.3f} GB (measured / predicted "
            f"{r['ratio']}); {r['draw_peak'] / 1e9:.3f} GB while drawing "
            f"its shards; launches {r['launches']} (predicted {want}: "
            f"{n_attn} layers x {r['decodes']} decode ticks, "
            f"{r['chunks']} chunk calls, {r['prefill_calls']} prefill "
            f"calls); staged through the host {r['staged']} B "
            f"({r['kinds']}); {run['wall']:.2f}s with start-up "
            f"({nvidia_smi_line()})")
        if r["elements"] != elements[r["rank"]] or r["spec"] != r["elements"]:
            fail(f"phase 16({tag}): rank {r['rank']} holds {r['elements']} "
                 f"parameter elements, spec tree {elements[r['rank']]}")
        if r["pool"] != r["pool_pred"]:
            fail(f"phase 16({tag}): rank {r['rank']}'s pool {r['pool']} B, "
                 f"predicted {r['pool_pred']} B")
        if r["launches"] != want or not r["decodes"]:
            fail(f"phase 16({tag}): rank {r['rank']} launched "
                 f"{r['launches']}, predicted {want}")
        if (r["digest"], r["schedule"]) != (run["digest"],
                                            run["ranks"][0]["schedule"]):
            fail(f"phase 16({tag}): rank {r['rank']}'s tokens or schedule "
                 "differ from rank 0's")
        for k in total:
            total[k] += r["launches"][k]
    for line in run["planning"]:
        log(f"[16{tag}] planning on the card: rank {line[0]} {line[1]}")
    if "--backend" in argv and len(run["planning"]) < world:
        fail(f"phase 16({tag}): the card measured no planning step on "
             "every rank")
    if one is None:
        same = "every rank the same tokens (no one-rank run)"
        one_wall = ""
    else:
        same = (f"one rank, replaying the ranks' tokens, ran the same "
                f"schedule and puts its argmax on the ranks' token at "
                f"{compared - parted} of {compared} tokens (near-ties at the "
                f"other {parted}); the top logits at most {worst:.4f} of the "
                f"spread apart (bound {TP_DRIFT_BOUND}), rms {rms:.4f}")
        one_wall = f"{one['wall']:.2f}s (one rank's replay) and "
    log(f"[16{tag}] {world} ranks: {same}; pool {run['pool']}, plan "
        f"{run['plans'][0]}; walls {one_wall}{run['wall']:.2f}s ({world} "
        f"ranks with start-up, beside the other runs of its wave)")
    return total


def route_partings(tag, mine, theirs):
    """(routed tokens, tokens whose experts or kept choices differ) of two
    MoE route tapes of one schedule, call by call (layer x group rows x
    positions)."""
    if len(mine) != len(theirs):
        fail(f"phase 16({tag}): {len(mine)} MoE routing calls against "
             f"{len(theirs)}")
    n = parted = 0
    for (e, k), (e2, k2) in zip(mine, theirs):
        if e.shape != e2.shape:
            fail(f"phase 16({tag}): a routing call of {tuple(e.shape)} "
                 f"against {tuple(e2.shape)}: another schedule")
        diff = ((e != e2) | (k != k2)).any(-1)
        n += diff.numel()
        parted += int(diff.sum())
    return n, parted


def judge_routes(tag, cfg, own, ranks):
    """The ranks' routes against the capacity rule of one device: each
    group's kept choices exactly those that the global expert count's
    capacity C keeps of its experts (moe.capacity_slots, C computed here
    from cfg.n_experts), inert lanes and pad rows included. And, counted
    but not judged, where the one rank's own router, on the replay that
    took the ranks' routes, would have chosen otherwise (router near-ties,
    its input apart from the ranks' by rounding). Returns the log text."""
    n = broken = 0
    for e, kept in ranks:
        s = e.shape[1]
        C = max(1, int(-(-s * cfg.top_k * cfg.capacity_factor
                         // cfg.n_experts)))
        want = torch.stack([keep.any(-1) for _, keep in
                            MOE.capacity_slots(e, cfg.n_experts, C)], -1)
        n += e.shape[0] * s
        broken += int((want != kept).any(-1).sum())
    if broken:
        fail(f"phase 16({tag}): the ranks kept other choices than the "
             f"capacity of {cfg.n_experts} experts keeps at {broken} of {n} "
             "routed tokens")
    m, parted = route_partings(tag, own, ranks)
    return (f"the ranks' kept choices are the global capacity rule's at "
            f"all {n} routed tokens; the one rank's own router, on the "
            f"replay that took their routes, would have chosen other "
            f"experts or kept other choices at {parted} of {m} "
            f"({parted / max(m, 1):.5f}: router near-ties; counted, not "
            f"judged)")


def free_replay(tag, argv, run, tmp):
    """(f)'s one rank replaying the ranks' tokens with its own MoE routes:
    its route partings from the ranks' and its logit drift, counted and
    logged, not judged."""
    one = replay_one(tag + " free", argv, os.path.join(tmp, f"{tag}_free.json"),
                     run["tokens"], extra=["--routes-out",
                                           routes_file(tmp, tag, "free")])
    n, parted = route_partings(tag, torch.load(routes_file(tmp, tag, "free")),
                               torch.load(routes_file(tmp, tag, "ranks")))
    compared, argmax, worst, rms, over = judge_logits(tag, run, one,
                                                      judged=False)
    log(f"[16{tag}] a free replay (the ranks' tokens, its own MoE routes; "
        f"counted, not judged): routes apart at {parted} of {n} routed "
        f"tokens; argmaxes apart at {argmax} of {compared} tokens, {over} "
        f"tokens past {TP_DRIFT_BOUND} of the spread or without a common "
        f"top 8, the largest {worst:.4f}, rms {rms:.4f}; {one['wall']:.2f}s")


def experts_cfg():
    return depth_variant(get_config(MX_ARCH), TP_EXPERTS_DEPTH)


def serve_experts(cfg, params, device, mesh=None, replay=None, forced=None):
    """(g)'s request through the compacted chunked paged engine (chunk
    256, blocks of 16), every MoE routing call on a RouteTape; with
    `replay` (a token file) and `forced` (a route tape) it emits those
    tokens and takes those routes. Its tokens and top logits (the serve
    CLI's --tokens-out records), route tape, launches and calls."""
    trace = synthetic_trace(1, vocab_size=cfg.vocab_size,
                            seed=TP_EXPERTS_SEED, mean_interarrival=0.0,
                            **TP_EXPERTS_TRACE)
    context = trace_context(trace)
    n_blocks = -(-context // KV_BLOCK) + 2
    tlog = TokenLog(force=SV.replay_force(trace, replay) if replay else None)
    ex = PagedTorchExecutor(params, cfg, n_lanes=1, n_blocks=n_blocks,
                            kv_block=KV_BLOCK, context=context, compact=True,
                            chunk=CHUNK, device=device, mesh=mesh, log=tlog)
    eng = Engine(ex, 1, allocator=BlockAllocator(n_blocks, KV_BLOCK),
                 chunk_prefill=CHUNK, audit="strict")
    tape = MOE.RouteTape(forced)
    _zero_launches()
    with MOE.routing(tape):
        rep = eng.run(trace)
    torch.cuda.synchronize(device)
    tokens, records = SV.token_records(trace, [rep], tlog)
    return {"tokens": tokens, "logits": records, "routes": tape.calls,
            "launches": launch_counts(), "decodes": ex.decodes,
            "chunks": ex.chunk_calls,
            "prefills": sum(ex.shape_calls["prefill"].values()),
            "done": len(rep.completions), "schedule": ex.schedule_digest}


def tp_experts_rank(device):
    """One rank of (g), spawned by launch.mesh.spawn_ranks: mixtral-8x7b's
    shards under Strategy(ep=False) (tensor parallelism inside the
    experts) on {data: 1, model: 2}, drawn from TP_EXPERTS_SEED as one
    device draws them, then serve_experts; with its shard shapes, peaks
    (while drawing, while serving) and staged bytes."""
    mesh = LM.build_mesh({"data": 1, "model": 2})
    cfg = experts_cfg()
    specs = SHD.param_specs(cfg, init_params(None, cfg, device="meta"),
                            SHD.Strategy(ep=False), mesh)
    t0 = time.time()
    params = SHD.init_local_params(
        torch.Generator(device=device).manual_seed(TP_EXPERTS_SEED), cfg,
        device, specs, mesh)
    torch.cuda.synchronize(device)
    draw = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t1 = time.time()
    out = serve_experts(cfg, params, device, mesh)
    out.update(rank=mesh.rank, draw_peak=draw,
               peak=torch.cuda.max_memory_allocated(device),
               wi=tuple(params["units"][0]["mlp"]["wi"].shape),
               elements=sum(t.numel() for t in tree_leaves(params)),
               staged=dict(COMM.staged_by_kind), draw_s=t1 - t0,
               serve_s=time.time() - t1)
    return out


def spawn_experts():
    """(g)'s two ranks on the card over gloo: (their results, wall)."""
    t0 = time.time()
    res = LM.spawn_ranks(tp_experts_rank, 2, "gloo", "cuda",
                         timeout=TP_TIMEOUT)
    return res, time.time() - t0


def judge_experts(ranks, wall, tmp):
    """(g): both ranks the same tokens, routes and schedule, each rank's
    wi its columns of every expert and its elements the spec tree's
    shard, its attention kernels launched once a layer and call; one rank
    (the whole params from the same seed, in process) replaying the
    ranks' tokens and routes within TP_DRIFT_BOUND of their logits; the
    ranks' kept choices the global capacity rule's (judge_routes). Returns
    the ranks' launches summed."""
    cfg = experts_cfg()
    n_attn = n_attention(cfg)
    shape = {"data": 1, "model": 2}
    elements = rank_elements(cfg, shape, SHD.Strategy(ep=False))
    r0 = ranks[0]
    total = {k: 0 for k in r0["launches"]}
    for r in ranks:
        want = dict({k: 0 for k in r["launches"]},
                    paged_decode=n_attn * r["decodes"],
                    paged_prefill=n_attn * r["chunks"],
                    flash_attention=n_attn * r["prefills"])
        log(f"[16g] rank {r['rank']} of 2: {r['elements']:,} parameter "
            f"elements (spec tree {elements[r['rank']]:,}), wi {r['wi']}; "
            f"max_memory_allocated {r['draw_peak'] / 1e9:.3f} GB while "
            f"drawing its shards ({r['draw_s']:.2f}s), {r['peak'] / 1e9:.3f}"
            f" GB while serving ({r['serve_s']:.2f}s); launches "
            f"{r['launches']} (predicted {want}: {n_attn} layers x "
            f"{r['decodes']} decode ticks, {r['chunks']} chunk calls, "
            f"{r['prefills']} prefill calls); staged through the host "
            f"{r['staged']} B ({nvidia_smi_line()})")
        if r["wi"] != (TP_EXPERTS_DEPTH, cfg.n_experts, cfg.d_model,
                       cfg.d_ff):
            fail(f"phase 16(g): rank {r['rank']}'s wi {r['wi']} is not its "
                 "[gate_r | val_r] columns of every expert")
        if r["elements"] != elements[r["rank"]]:
            fail(f"phase 16(g): rank {r['rank']} holds {r['elements']} "
                 f"parameter elements, spec tree {elements[r['rank']]}")
        if r["launches"] != want or not r["decodes"] or r["done"] != 1:
            fail(f"phase 16(g): rank {r['rank']} launched {r['launches']}, "
                 f"predicted {want}, completed {r['done']}")
        if (r["tokens"], r["schedule"]) != (r0["tokens"], r0["schedule"]):
            fail("phase 16(g): the ranks emit or schedule apart")
        if route_partings("g", r["routes"], r0["routes"])[1]:
            fail("phase 16(g): the ranks route apart")
        for k in total:
            total[k] += r["launches"][k]
    mine = os.path.join(tmp, "g_ranks.json")
    with open(mine, "w") as f:
        json.dump({"tokens": r0["tokens"], "logits": r0["logits"]}, f)
    t0 = time.time()
    cfg = experts_cfg()
    params = init_params(torch.Generator(device=DEV).manual_seed(
        TP_EXPERTS_SEED), cfg, device=DEV)
    one = serve_experts(cfg, params, DEV, replay=mine, forced=r0["routes"])
    del params
    torch.cuda.empty_cache()
    theirs = os.path.join(tmp, "g_one.json")
    with open(theirs, "w") as f:
        json.dump({"tokens": one["tokens"], "logits": one["logits"]}, f)
    if one["schedule"] != r0["schedule"]:
        fail("phase 16(g): one rank scheduled other block tables")
    compared, parted, worst, rms, _ = judge_logits(
        "g", {"tokens": mine}, {"tokens": theirs})
    own = judge_routes("g", cfg, one["routes"], r0["routes"])
    log(f"[16g] 2 ranks, tensor parallelism inside the experts: one rank, "
        f"replaying the ranks' tokens and routes, puts its argmax on the "
        f"ranks' token at {compared - parted} of {compared} tokens; the top "
        f"logits at most {worst:.4f} of the spread apart (bound "
        f"{TP_DRIFT_BOUND}), rms {rms:.4f}; {own}; walls {wall:.2f}s (2 "
        f"ranks with start-up, beside the other runs of its wave) and "
        f"{time.time() - t0:.2f}s (one rank)")
    return total


def phase_tp(only=None):
    """Phase 16: the serve CLI on model:2 and model:4, ranks sharing the
    card over gloo, the runs of a wave (TP_WAVES) at once, (g)'s rank
    functions beside them in a thread; then one rank of the same CLI and
    trace, in process, replays each run's tokens (a MoE arch's routes
    too), and the two are held to each other token by token (judge_tp,
    judge_experts). `only` limits the runs (a set of tags)."""
    steps = {tag: (argv, world, replay)
             for tag, argv, world, replay in TP_STEPS
             if only is None or tag in only}
    walls, runs, totals = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    experts = None
    pool = ThreadPoolExecutor(1)
    try:
        for wave in TP_WAVES:
            wave = tuple(t for t in wave if t in steps
                         or (t == "g" and (only is None or t in only)))
            if not wave:
                continue
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            t0 = time.time()
            started = {}
            try:
                if "g" in wave:
                    experts = pool.submit(spawn_experts)
                for tag in wave:
                    if tag == "g":
                        continue
                    argv, world, _ = steps[tag]
                    started[tag] = start_ranks(
                        tag, argv, world,
                        os.path.join(tmp, f"{tag}_ranks.json"), tmp)
                ends = wait_ranks(started)
                if "g" in wave:
                    try:
                        experts = experts.result()
                    except (RuntimeError, TimeoutError) as e:
                        fail(f"phase 16(g): its ranks failed: {e}")
            finally:
                stop_ranks(started)
            for tag in started:
                runs[tag] = read_ranks(tag, started[tag], ends[tag])
                walls[tag] = ends[tag]
            if len(wave) > 1:
                walls["wave " + "".join(wave)] = time.time() - t0
        for tag, (argv, world, replay) in steps.items():
            t0 = time.time()
            extra = []
            if tp_cfg(argv).is_moe:
                extra = ["--replay-routes", routes_file(tmp, tag, "ranks"),
                         "--routes-out", routes_file(tmp, tag, "one")]
            one = (replay_one(tag, argv, os.path.join(tmp, f"{tag}_one.json"),
                              runs[tag]["tokens"], extra) if replay else None)
            totals[tag] = judge_tp(tag, argv, world, runs[tag], one)
            if extra:
                log(f"[16{tag}] " + judge_routes(
                    tag, tp_cfg(argv),
                    torch.load(routes_file(tmp, tag, "one")),
                    torch.load(routes_file(tmp, tag, "ranks"))))
                walls[tag + " one rank"] = time.time() - t0
                t0 = time.time()
                free_replay(tag, argv, runs[tag], tmp)
                walls[tag + " free replay"] = time.time() - t0
            else:
                walls[tag + " one rank"] = time.time() - t0
        if experts is not None:
            t0 = time.time()
            totals["g"] = judge_experts(*experts, tmp)
            walls["g"] = experts[1]
            walls["g one rank"] = time.time() - t0
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    log("[16] walls " + ", ".join(f"({k}) {v:.2f}s"
                                  for k, v in walls.items()))
    log("[16] these runs are ranks sharing one card over gloo (each "
        "collective staged through the host), the runs of a wave beside "
        "each other, not a multi-GPU measurement")
    return totals


def add_launches(rows, name, phase, n):
    """Adds `n` launches of phase `phase` to the row `name` of the kernels
    line (its `launches` and its `launches_by_phase`)."""
    for r in rows:
        if r["name"] == name:
            r["launches"] += n
            r.setdefault("launches_by_phase", {})[phase] = n
            return
    fail(f"no kernels row {name}")


ALL_PHASES = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16",
                    help="comma-separated phases to run (1 always runs)")
    ap.add_argument("--tp-runs", default="",
                    help="comma-separated tags of phase 16's runs to make "
                         "(default every run)")
    ap.add_argument("--par-runs", default="",
                    help="comma-separated tags of phase 14's runs to make "
                         "(default every run, the restores and "
                         "compressed_psum; a run needs its one-rank run)")
    args = ap.parse_args()
    phases = {int(x) for x in args.phases.split(",")}
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    errs = {"paged_decode": None, "paged_prefill": None,
            "flash_attention": None, "flash_attention_train": None,
            "flash_attention_bwd": None, "mlstm_scan": None,
            "decode_attention": None}
    if 2 in phases:
        t0 = time.time()
        errs = phase_kernels()
        log(f"[2] phase 2 {time.time() - t0:.2f}s")
    rows = []
    if 3 in phases:
        rows += run_mistral(phases, errs)
        torch.cuda.empty_cache()
    if 7 in phases:
        t0 = time.time()
        xl = phase_xlstm(phases)
        log(f"[7] phase 7 {time.time() - t0:.2f}s")
        rows.append(mlstm_row(xl, errs["mlstm_scan"]))
        torch.cuda.empty_cache()
    if 8 in phases:
        t0 = time.time()
        tr = phase_train()
        log(f"[8] phase 8 {time.time() - t0:.2f}s")
        rows += train_rows(tr, errs)
        torch.cuda.empty_cache()
    g3 = rg = None
    if 9 in phases:
        t0 = time.time()
        cfg = get_config("gemma3-12b")
        g3 = phase_ring_model("gemma3-12b", 9, SEED + 9,
                              make_gemma3_trace(cfg))
        log(f"[9] phase 9 {time.time() - t0:.2f}s")
    if 10 in phases:
        t0 = time.time()
        cfg = get_config("recurrentgemma-9b")
        rg = phase_ring_model("recurrentgemma-9b", 10, SEED + 10,
                              make_rgemma_trace(cfg))
        log(f"[10] phase 10 {time.time() - t0:.2f}s")
    if 11 in phases:
        torch.cuda.empty_cache()
        t0 = time.time()
        phase_cli()
        log(f"[11] phase 11 {time.time() - t0:.2f}s")
    p12 = p13 = p14 = p15 = p16 = None
    if 12 in phases:
        torch.cuda.empty_cache()
        t0 = time.time()
        p12 = phase_train_cli()
        log(f"[12] phase 12 {time.time() - t0:.2f}s")
    if 13 in phases:
        torch.cuda.empty_cache()
        t0 = time.time()
        p13 = phase_moe_prefix()
        log(f"[13] phase 13 {time.time() - t0:.2f}s")
    if 14 in phases:
        torch.cuda.empty_cache()
        t0 = time.time()
        p14 = phase_parallel({t.strip() for t in args.par_runs.split(",")}
                             if args.par_runs else None)
        log(f"[14] phase 14 {time.time() - t0:.2f}s")
    if 15 in phases:
        torch.cuda.empty_cache()
        t0 = time.time()
        p15 = phase_dryrun()
        log(f"[15] phase 15 {time.time() - t0:.2f}s")
    if 16 in phases:
        torch.cuda.empty_cache()
        t0 = time.time()
        p16 = phase_tp({t.strip() for t in args.tp_runs.split(",")}
                       if args.tp_runs else None)
        log(f"[16] phase 16 {time.time() - t0:.2f}s")
    if g3 is not None:
        rows.append(ring_row(g3, rg, errs["decode_attention"]))
        rows.append(slot_prefill_row(g3["cfg"], g3["slot"]["flash"],
                                     errs["flash_attention"]))
    if ALL_PHASES <= phases:
        # the launches of phases 12 to 16, each counted from zero just
        # before its path and read just after (phase 14: every rank of its
        # meshes (a)-(c), over its training loop; phase 15: the steps the
        # dry-run and the hillclimb measured on the card; phase 16: every
        # rank of its runs (a)-(g) on a model axis), added to their
        # kernels' rows
        a, b, c = p13["a"], p13["b"], p13["c"]
        for tag, codec in (("a", "bf16"), ("b", "int8"), ("c", "bf16"),
                           ("d", "bf16"), ("f", "bf16"), ("g", "bf16")):
            t = p16[tag]
            add_launches(rows, f"paged_decode[{codec}]", "16" + tag,
                         t["paged_decode"])
            add_launches(rows, f"paged_prefill[{codec}]", "16" + tag,
                         t["paged_prefill"])
            add_launches(rows, "flash_attention[prefill_batch]", "16" + tag,
                         t["flash_attention"])
        for tag in ("c", "e"):          # (c): the card's planning steps
            add_launches(rows, "decode_attention", "16" + tag,
                         p16[tag]["decode_attention"])
        add_launches(rows, "flash_attention[slot_prefill]", "16e",
                     p16["e"]["flash_attention"])
        for name, phase, n in (
                ("flash_attention[train]", "12", p12["fwd"]),
                ("flash_attention_bwd", "12", p12["bwd"]),
                ("flash_attention[train]", "14", p14["fwd"]),
                ("flash_attention_bwd", "14", p14["bwd"]),
                ("paged_decode[bf16]", "13a", a["paged_decode"]),
                ("paged_prefill[bf16]", "13a", a["paged_prefill"]),
                ("flash_attention[prefill_batch]", "13a", a["flash_engine"]),
                ("flash_attention[greedy]", "13a", a["flash_greedy"]),
                ("flash_attention[greedy]", "13b", b["flash_attention"]),
                ("flash_attention[greedy]", "13c", c["flash_attention"]),
                ("decode_attention", "13a", a["decode_attention"]),
                ("decode_attention", "13b", b["decode_attention"]),
                ("decode_attention", "13c", c["decode_attention"]),
                ("decode_attention", "15", p15["decode_attention"])):
            add_launches(rows, name, phase, n)
    for r in rows:
        lib = ("" if r["library_ms"] is None else
               f", library {r['library_ms']:.4f} ms")
        rate = ("" if "tflops" not in r else
                f", {r['tflops']:.1f} TFLOP/s = "
                f"{100 * r['share_of_peak']:.2f} % of 989")
        log(f"[k] {r['name']}: {r['ms']:.4f} ms at {r['shape']}, plain "
            f"{r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}{rate}, {r['launches']} launches on its "
            f"path ({smi})")
        if "launch_shapes" in r:
            log(f"[k]   {r['name']} by shape (lanes x table blocks): "
                f"launches {r['launch_shapes']}, ms {r['ms_by_shape']}; "
                f"most launched {r['most_launched_shape']} at "
                f"{r['ms_most_launched']:.4f} ms; sum of launches x ms "
                f"{r['launches_x_ms']:.1f}")
    log(f"total {time.time() - t_start:.1f}s")
    if not ALL_PHASES <= phases:
        log("partial run (not every phase): no kernels line, no result line")
        return 0
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
