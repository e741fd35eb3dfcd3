#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases 1,2    # build + kernel checks only

Phases, each of which fails the run (non-zero exit) if it fails:
  1. device: the card's name and power limit, its properties beside the
     constants the capacity model uses; build both CUDA kernels from
     src/repro_torch/kernels/csrc/.
  2. each kernel's wrapper against its plain PyTorch version on the card, at
     serving shapes and at odd ones, bf16 / int8 / int4 / f32 pools.
  3. the main path at full width: mistral-nemo-12b, all 40 layers, random
     bf16 weights from a seed; the capacity model sizes the KV block pool;
     the engine serves a seeded trace through PagedTorchExecutor (chunked
     prefill, compacted decode, strict allocator audit), with a bf16 pool
     and again with an int8 pool. Launch counters are zeroed just before
     and read just after.
  4. the same trace at 4 layers with the kernels and with the plain
     versions: token streams equal, or the first divergence judged.
  5. predicted resident + transient bytes of phase 3's plan beside
     torch.cuda.max_memory_allocated() (printed, not asserted).
  then: each kernel timed at the largest shape phase 3 launched it at,
  beside its plain version and its bound; one JSON line `kernels`.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device the script exits non-zero and prints no result.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
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
from repro_torch.configs.base import DECODE, ShapeConfig, depth_variant  # noqa: E402
from repro_torch.core import classifier as CL, predictor as PR  # noqa: E402
from repro_torch.kernels import build, paged_decode, paged_prefill  # noqa: E402
from repro_torch.models import ModelSettings, init_params  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.serving import (BlockAllocator, Engine, leak_check,  # noqa: E402
                                 synthetic_trace, trace_context)
from repro_torch.serving.executor import PagedTorchExecutor  # noqa: E402

DEV = torch.device("cuda:0")
SEED = 0

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
# Phase 4: a token divergence between kernel and plain runs is accepted only
# where the top-2 logit gap is below this fraction of that row's logit
# standard deviation on both sides. The two runs differ by bf16 roundings of
# the attention output carried through a bf16 residual stream: of the order
# of 1% of that deviation after 4 layers (10x margin). A decided argmax over
# 131072 random logits has a typical gap of 0.2 of it, so a kernel that
# attends to wrong rows diverges far above the bound.
GAP_BOUND = 0.1

PEAK_BYTES_PER_S = HW.H100.hbm_bw            # 3.35e12
PEAK_BF16_FLOPS = HW.H100.peak_flops_bf16    # 989e12


def log(msg):
    print(msg, flush=True)


def fail(msg):
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


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
            if "registers" in line or "error" in line.lower():
                log(f"[1]   {name}: {line.strip()}")
    build.library(paged_decode.SOURCE)
    build.library(paged_prefill.SOURCE)
    return smi


# ---------------------------------------------------------------------------
# Kernel cases
# ---------------------------------------------------------------------------

_POOL_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


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
                 unmapped_tail=False):
    """Kernel 2 against its plain version: lane i holds hist[i] positions
    and appends clens[i] <= C tokens (the rest of the chunk is padding).
    Outputs to tolerance; pool positions, payload / codes exact and scales
    within 1 ULP over the whole pool. `unmapped_tail` leaves the last
    logical block the chunk reaches unmapped: its rows must write nothing."""
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
    return err


def phase_kernels():
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    errs = {"paged_decode": 0.0, "paged_prefill": 0.0}
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
    log(f"[2] {n} kernel-vs-plain cases agree on the card: max abs err "
        f"decode {errs['paged_decode']:.3e}, prefill "
        f"{errs['paged_prefill']:.3e} (tolerances: f32 {TOL_F32:.0e}, bf16 "
        f"{TOL_BF16:.0e} + {RTOL_BF16:.1e} * |value|, mass {TOL_MASS:.0e}; pool codes, payload and "
        f"positions exact, scales <= 1 ULP)")
    return errs


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

KV_BLOCK, LANES, CHUNK = 16, 8, 256
HBM_BUDGET = 72e9       # bytes of the card the deployment may plan for
# The profiling front end (core/profiler) is not ported yet, so the workload
# class the capacity model needs is fixed by hand: Medium (paper Table III
# factor 2), the class the reference package's simulator assigns decode.
WORKLOAD = CL.Classification(category=CL.Category.MEDIUM, alpha=0.8, inc=1.0,
                             slope=0.8, intercept=0.0)
MESH = {"data": 1, "model": 1}


def make_trace(cfg):
    return synthetic_trace(16, vocab_size=cfg.vocab_size, seed=SEED + 7,
                           prompt_lens=(520, 777, 1024, 1500, 2048),
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


class RecordingExecutor(PagedTorchExecutor):
    """Records, per argmax call, what each active row was fed (decode: the
    input token and its position; chunk: the chunk's tokens and start), the
    token chosen, and the row's top-2 logit gap as a fraction of the row's
    logit standard deviation (phase 4 judges divergences with it)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = []
        self._fed = []

    def decode(self, tokens, positions, tables, lanes=None):
        rows = lanes if lanes is not None else range(len(tokens))
        self._fed = [(int(tokens[i]), int(positions[i])) for i in rows]
        return super().decode(tokens, positions, tables, lanes)

    def prefill_chunks(self, lanes, chunks, starts, *a, **kw):
        self._fed = [(tuple(int(t) for t in c), int(s))
                     for c, s in zip(chunks, starts)]
        return super().prefill_chunks(lanes, chunks, starts, *a, **kw)

    def _argmax(self, logits):
        n = len(self._fed)
        lg = logits[:n].float()
        top = lg.topk(2, dim=-1).values
        gap = ((top[:, 0] - top[:, 1]) / lg.std(dim=-1)).cpu().numpy()
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        self.calls.append((self._fed, toks[:n].copy(), gap))
        return toks


def serve(cfg, params, trace, context, n_blocks, kv_quant, backend="kernel",
          record=False):
    cls = RecordingExecutor if record else PagedTorchExecutor
    ex = cls(params, cfg, n_lanes=LANES, n_blocks=n_blocks, kv_block=KV_BLOCK,
             context=context, compact=True, chunk=CHUNK, kv_quant=kv_quant,
             settings=ModelSettings(attn=A.AttnSettings(backend=backend)),
             device=DEV)
    if not all(t.is_cuda for t in ex.pool["units"][0].values()):
        fail("the pool is not on the card")
    alloc = BlockAllocator(n_blocks, KV_BLOCK)
    eng = Engine(ex, LANES, allocator=alloc, chunk_prefill=CHUNK,
                 audit="strict")
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
    if rep.prefill_calls != 0:
        fail("whole-prompt prefill was called")
    return ex, rep, dt


def phase_main(cfg, params):
    trace = make_trace(cfg)
    if min(len(r.prompt) for r in trace) <= CHUNK:
        fail("trace holds a prompt that would take whole-prompt prefill")
    context = trace_context(trace)
    counts, shapes, plans = {}, {}, {}
    peak = {}
    for kv_quant in ("none", "int8"):
        plan = plan_pool(cfg, trace, context, kv_quant)
        plans[kv_quant] = plan
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        paged_decode.launches = 0
        paged_prefill.launches = 0
        ex, rep, dt = serve(cfg, params, trace, context, plan["pool_blocks"],
                            kv_quant)
        nd, npf = paged_decode.launches, paged_prefill.launches
        peak[kv_quant] = torch.cuda.max_memory_allocated()
        want_d, want_p = cfg.n_layers * ex.decodes, cfg.n_layers * ex.chunk_calls
        if nd <= 0 or npf <= 0 or nd != want_d or npf != want_p:
            fail(f"launch counters: decode {nd} (want {want_d}), prefill "
                 f"{npf} (want {want_p})")
        counts[kv_quant] = (nd, npf)
        shapes[kv_quant] = {k: sorted(v) for k, v in ex._shapes.items()}
        gen_tokens = sum(len(c.tokens) for c in rep.completions)
        log(f"[3] {cfg.name} {cfg.n_layers} layers kv_quant={kv_quant}: "
            f"{len(rep.completions)}/{len(trace)} requests, "
            f"{rep.prefill_tokens} prompt tokens in {ex.chunk_calls} chunk "
            f"calls, {gen_tokens} generated tokens in {ex.decodes} decode "
            f"ticks, {rep.ticks} ticks, {dt:.2f}s wall; pool "
            f"{plan['pool_blocks']} blocks (capacity model allows "
            f"{plan['capacity_blocks']} under {HBM_BUDGET:.3e} B), peak "
            f"blocks {rep.peak_blocks}; kernel launches decode {nd} = "
            f"{cfg.n_layers} x {ex.decodes}, prefill {npf} = {cfg.n_layers} "
            f"x {ex.chunk_calls}; audit clean; shapes {shapes[kv_quant]}; "
            f"batch rows holding a request / rows computed at the bucketed "
            f"widths: decode {ex.rows_real['decode_compact']}/"
            f"{ex.rows_computed['decode_compact']}, chunk "
            f"{ex.rows_real['chunk']}/{ex.rows_computed['chunk']}")
        del ex
    return trace, context, counts, shapes, plans, peak


# ---------------------------------------------------------------------------
# Phase 4: kernels vs plain versions end to end, 4 layers
# ---------------------------------------------------------------------------

def phase_identity(cfg, params, trace, context):
    cfg4 = depth_variant(cfg, 4)
    p4 = dict(params)
    p4["units"] = [{name: {k: v[:4] for k, v in sub.items()}
                    for name, sub in unit.items()}
                   for unit in params["units"]]
    n_blocks = LANES * (-(-context // KV_BLOCK))
    runs = {}
    for backend in ("kernel", "naive"):
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
    for i, ((fa, tok_a, gap_a), (fb, tok_b, gap_b)) in enumerate(zip(ca, cb)):
        for j in range(len(fa)):
            if fa[j] == fb[j] and tok_a[j] != tok_b[j]:
                fresh.append((i, j, int(tok_a[j]), int(tok_b[j]),
                              float(gap_a[j]), float(gap_b[j])))
    if same != len(ta) and not fresh:
        fail("streams differ but no call diverged on equal inputs")
    worst = max((max(f[4], f[5]) for f in fresh), default=0.0)
    log(f"[4] 4 layers, kernels vs plain versions on the card: {same}/"
        f"{len(ta)} token streams equal; {len(fresh)} fresh divergences "
        f"(same input, different token), largest top-2 gap among them "
        f"{worst:.4f} of the row's logit std (bound {GAP_BOUND})")
    if fresh:
        i, j, a_, b_, ga, gb = fresh[0]
        log(f"[4]   first: call {i} row {j}: kernel token {a_} (gap "
            f"{ga:.4f}), plain token {b_} (gap {gb:.4f})")
    if worst >= GAP_BOUND:
        fail("token divergence at a decided argmax: a fault, not a near-tie")


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


def time_decode(cfg, gen, w, mb, codec):
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
    plain = time_ms(
        lambda: paged_decode.paged_decode_attention_plain(*args, **kw), 5)
    rows = w * n
    nbytes = (rows * K * 2 * pool_row_bytes(cfg, codec) + rows * 4
              + 2 * q.numel() * 2 + tables.numel() * 4 + w * 4)
    flops = 4.0 * rows * K * G * hd
    return ms, plain, nbytes, flops


def time_prefill(cfg, gen, w, mb, codec):
    K, G, hd = cfg.n_kv_heads, cfg.q_group, cfg.resolved_head_dim
    C = CHUNK
    hist = mb * KV_BLOCK - C
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
    plain = time_ms(
        lambda: paged_prefill.paged_prefill_attention_plain(*args, **kw), 3)
    row = pool_row_bytes(cfg, codec)
    # read: q, k_new, v_new, the history rows, tables, positions; written:
    # o and the chunk's rows (payload, scales, positions)
    nbytes = (2 * q.numel() * 2 + 2 * kn.numel() * 2
              + w * hist * (K * 2 * row + 4) + w * C * (K * 2 * row + 4)
              + tables.numel() * 4 + positions.numel() * 4)
    visible = sum(hist + c + 1 for c in range(C))      # causal, per lane
    flops = 4.0 * w * visible * K * G * hd
    return ms, plain, nbytes, flops


def kernel_rows(cfg, counts, shapes, errs):
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    rows = []
    for kv_quant, codec in (("none", "bf16"), ("int8", "int8")):
        nd, npf = counts[kv_quant]
        for (name, src, replaces, timer, key, launches) in (
                ("paged_decode", "src/repro_torch/kernels/csrc/paged_decode.cu",
                 "src/repro/kernels/decode_attention.py:306", time_decode,
                 "decode_compact", nd),
                ("paged_prefill",
                 "src/repro_torch/kernels/csrc/paged_prefill.cu",
                 "src/repro/kernels/prefill_attention.py:294", time_prefill,
                 "chunk", npf)):
            w, mb = max(shapes[kv_quant][key], key=lambda s: s[0] * s[1])
            ms, plain, nbytes, flops = timer(cfg, gen, w, mb, codec)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            rows.append({
                "name": f"{name}[{codec}]", "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "shape": {"lanes": w, "table_blocks": mb, "block": KV_BLOCK,
                          "chunk": CHUNK if name == "paged_prefill" else 1},
                "bytes": nbytes, "operations": flops})
    return rows


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="comma-separated phases to run (1 always runs)")
    args = ap.parse_args()
    phases = {int(x) for x in args.phases.split(",")}
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()
    errs = {"paged_decode": None, "paged_prefill": None}
    if 2 in phases:
        errs = phase_kernels()
    rows = []
    if 3 in phases:
        cfg = get_config("mistral-nemo-12b")
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        t0 = time.time()
        params = init_params(gen, cfg, device=DEV)
        n_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(params))
        torch.cuda.synchronize()
        log(f"[3] {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} layers, "
            f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads x "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}: {n_bytes / 1e9:.2f} GB of bf16 weights made "
            f"on the card from seed {SEED} in {time.time() - t0:.1f}s")
        trace, context, counts, shapes, plans, peak = phase_main(cfg, params)
        if 4 in phases:
            phase_identity(cfg, params, trace, context)
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
        rows = kernel_rows(cfg, counts, shapes, errs)
        for r in rows:
            log(f"[k] {r['name']}: {r['ms']:.4f} ms at {r['shape']}, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
                f"{r['bound_by']}, {r['launches']} launches on the main path")
    log(f"total {time.time() - t_start:.1f}s")
    if not {1, 2, 3, 4, 5} <= phases:
        log("partial run (not every phase): no kernels line, no result line")
        return 0
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
