"""Token-agreement harness for capacity bending.

Quantized KV blocks and block-granular retention buy admitted sequences
with bytes that used to hold exact state, so "how many lanes fit" is only
half the ledger — this module supplies the other half: for every
completion an engine emitted, replay the request through the exact
per-request reference path (`greedy_generate`, fp ring cache, no dropping)
and count position-wise token matches. The agreement fraction gates the
capacity model's bends (`min_agreement`).

Agreement is measured on greedy argmax token ids, the strictest cheap
proxy: a bent cache either reproduces the exact token stream or it
doesn't, and the first divergence position is recorded per request so
drift (late divergence, long prompts) is distinguishable from damage
(immediate divergence).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.model import require_device
from repro_torch.runtime.serve_step import greedy_generate


@dataclasses.dataclass(frozen=True)
class AgreementReport:
    """Position-wise greedy-token agreement of an engine run vs exact."""
    agreement: float                     # matched / compared, in [0, 1]
    matched: int
    compared: int
    per_request: Tuple[float, ...]       # per-rid fraction, trace order
    first_divergence: Tuple[int, ...]    # per-rid index, -1 = identical

    def describe(self) -> str:
        exact = sum(1 for d in self.first_divergence if d < 0)
        return (f"agreement={self.agreement:.4f} "
                f"({self.matched}/{self.compared} tokens, "
                f"{exact}/{len(self.per_request)} requests exact)")


@torch.no_grad()
def token_agreement(params, cfg, trace: Sequence, report, *,
                    context: int, settings=None,
                    ref_cache: Optional[Dict] = None,
                    device="cuda") -> AgreementReport:
    """Score a finished engine run against the exact reference decoder.

    `trace` is the request list the engine ran (each with `.rid`,
    `.prompt`, `.max_new`); `report` is its ServeReport. Each completion
    is compared token-by-token against `greedy_generate` on the same
    prompt, run on `device` (where `params` lie; default "cuda", raises
    without a CUDA device) — the fp, full-cache, single-sequence path — so
    any mismatch is attributable to the bend (quantization error or dropped
    blocks), not to scheduling. Requests are deduplicated by prompt/length
    so prefix-heavy traces don't pay the reference decode twice; pass a
    shared `ref_cache` dict to reuse references across calls (e.g. scoring
    many bend settings against the same trace).
    """
    device = require_device(device)
    by_rid = {r.rid: r for r in trace}
    if ref_cache is None:
        ref_cache = {}
    fracs, firsts = [], []
    matched = compared = 0
    for c in sorted(report.completions, key=lambda c: c.rid):
        req = by_rid[c.rid]
        key = (tuple(req.prompt), req.max_new)
        if key not in ref_cache:
            prompt = torch.tensor([list(req.prompt)], dtype=torch.int32,
                                  device=device)
            out = greedy_generate(params, cfg, prompt, n_steps=req.max_new,
                                  context=context, settings=settings)
            ref_cache[key] = out[0].cpu().numpy()
        ref = ref_cache[key]
        got = np.asarray(c.tokens, dtype=ref.dtype)
        n = min(len(got), len(ref))
        hits = got[:n] == ref[:n]
        matched += int(hits.sum())
        compared += n
        fracs.append(float(hits.mean()) if n else 1.0)
        div = int(np.argmin(hits)) if not hits.all() else -1
        firsts.append(div)
    return AgreementReport(
        agreement=(matched / compared) if compared else 1.0,
        matched=matched, compared=compared,
        per_request=tuple(fracs), first_divergence=tuple(firsts))


@torch.no_grad()
def measure_bend(params, cfg, trace: Sequence, *, n_lanes: int,
                 n_blocks: int, kv_block: int, context: int,
                 kv_quant: str = "none", kv_retain: int = 0,
                 settings=None, compact: bool = False, chunk: int = 0,
                 reservation: str = "worst", prefix_share: bool = False,
                 engine_kwargs: Optional[dict] = None, device="cuda"):
    """Run a bent paged engine over `trace` and score it in one call.

    Builds the PagedTorchExecutor on `device` with the requested bend, an
    allocator sized to the pool, and an Engine with retention enforcement,
    then returns `(ServeReport, AgreementReport)`. The throughput numbers
    and the quality numbers come from the SAME run, so a caller can't
    report capacity from one configuration and fidelity from another.
    """
    from repro_torch.serving.engine import BlockAllocator, Engine
    from repro_torch.serving.executor import PagedTorchExecutor
    executor = PagedTorchExecutor(
        params, cfg, n_lanes=n_lanes, n_blocks=n_blocks, kv_block=kv_block,
        context=context, settings=settings, compact=compact, chunk=chunk,
        kv_quant=kv_quant, kv_retain=kv_retain, device=device)
    allocator = BlockAllocator(n_blocks, kv_block, reservation=reservation)
    kw = dict(engine_kwargs or {})
    kw.setdefault("kv_retain", kv_retain)
    kw.setdefault("prefix_share", prefix_share)
    kw.setdefault("chunk_prefill", chunk)
    report = Engine(executor, n_lanes, allocator=allocator, **kw).run(trace)
    agree = token_agreement(params, cfg, trace, report, context=context,
                            settings=settings, device=device)
    return report, agree
