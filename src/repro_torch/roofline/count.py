"""One step's FLOPs and bytes, counted on the meta device: the port's
counterpart of the reference's XLA cost analysis and HLO parse
(`compiled.cost_analysis()`, `roofline/hlo.py`), for one device.

`count_step(cfg, shape, plan, settings)` builds the params (and the
optimizer state, the batch, the decode cache) as empty tensors on the
`meta` device — shapes and dtypes only, no card memory, no weights — and
runs one step of the shape's kind there:

  train    the train step under the plan's remat at microbatches=1 (as the
           reference lowers it: its microbatch loop is a scan counted
           once, so the per-step cost is the full-batch one-micro cost),
           forward, backward and optimizer update;
  prefill  the prefill step (the ring caches the prompt fills, the last
           token's logits);
  decode   one decode step over a ring cache of the shape's context.

It runs through the plain paths: `AttnSettings(backend="naive")` and
`mlstm_backend="naive"` (a CUDA kernel does not run on meta).

FLOPs come from `torch.utils.flop_counter.FlopCounterMode`, which counts
the matrix-product ops (mm, bmm, addmm, baddbmm, convolutions, attention
calls), the backward's included. Bytes come from `ByteCounter`: the sum of
every aten op's tensor arguments and results, each counted whole — the
same upper bound with no fusion credit that the HLO's "bytes accessed"
is. An op whose result is a view of an argument moves nothing and counts
zero. `wire_bytes` is 0: one device, no collectives.

Differences from the reference's counted cost:
- every loop iteration runs, so every one is counted (the reference
  counts a scan body once and adds `analysis.scan_corrections`); the
  corrections are *not* added to a counted cost and stay a term of
  `analysis.analytic_hbm_traffic` alone. A sequential recurrence (the
  sLSTM's time loop) is counted step by step: minutes at 32k positions;
- the plain attention computes every (query, key) product and masks
  half of them afterwards, so the count includes the masked half, and
  `RooflineReport.useful_flops_ratio` shows that waste (as it shows a
  remat's recompute).

A step that cannot run on meta (a `.item()`, a shape that depends on the
data) raises `CountError`; nothing reports a zero count.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (DECODE, PREFILL, TRAIN, ModelConfig,
                                      ShapeConfig)
from repro_torch.core.predictor import MemoryPlan
from repro_torch.models import model as M
from repro_torch.roofline.analysis import ComponentCost

# aten ops that move no data besides those whose result is a view
_NO_DATA = (torch.ops.aten._unsafe_view.default,)


class CountError(RuntimeError):
    """A step that cannot be counted on the meta device."""


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Bytes each aten op reads and writes: its tensor arguments and its
    tensor results, each counted whole (no fusion credit). An op whose
    result is a view of an argument counts zero, and so does a copy
    between devices (a constant made on the host, as RoPE's frequencies,
    is a transfer, not device-memory traffic)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _NO_DATA:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if outs and any(t.device != outs[0].device for t in ins):
            return out
        self.bytes += _nbytes(ins) + _nbytes(outs)
        return out


def counting_settings(settings=None) -> M.ModelSettings:
    """`settings` (default ModelSettings()) on the plain attention and
    mLSTM paths, the only ones that run on the meta device."""
    st = settings or M.ModelSettings()
    return dataclasses.replace(
        st, attn=dataclasses.replace(st.attn, backend="naive"),
        mlstm_backend="naive")


def _step(cfg: ModelConfig, shape: ShapeConfig, plan: MemoryPlan,
          settings: M.ModelSettings, dev: torch.device):
    """A closure running one step of `shape`'s kind on inputs made on
    `dev` (zeros: the count does not depend on values)."""
    from repro_torch.core import profiler as PF
    from repro_torch.optim import optimizers as OPT
    from repro_torch.runtime import schedule as SCH
    from repro_torch.runtime import serve_step as SS
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(0))
    params = M.init_params(gen, cfg, device=dev)
    b, s = shape.global_batch, shape.seq_len
    n_pre = cfg.n_prefix_embeds

    def tokens(rows, cols):
        return torch.zeros((rows, cols), dtype=torch.int32, device=dev)

    prefix = (torch.zeros((b, n_pre, cfg.d_model), dtype=torch.bfloat16,
                          device=dev)
              if n_pre and shape.kind != DECODE else None)
    if shape.kind == TRAIN:
        tcfg = PF._tcfg_for(dataclasses.replace(plan, microbatches=1),
                            settings)
        opt_state = OPT.init_state(tcfg.optimizer, params)
        batch = {"tokens": tokens(b, s - n_pre),
                 "targets": tokens(b, s - n_pre)}
        if prefix is not None:
            batch["prefix_embeds"] = prefix
        train = SCH.make_train_step(cfg, tcfg)
        return lambda: train(params, opt_state, batch, 0)
    if shape.kind == PREFILL:
        prefill = SS.make_prefill_step(cfg, settings)
        toks = tokens(b, s - n_pre)
        return lambda: prefill(params, toks, context=s, prefix_embeds=prefix)
    if shape.kind == DECODE:
        cache = M.init_cache(cfg, b, shape.context, device=dev)
        toks = tokens(b, 1)
        positions = torch.full((b,), shape.context - 1, dtype=torch.int32,
                               device=dev)
        decode = SS.make_decode_step(cfg, settings)
        return lambda: decode(params, toks, positions, cache,
                              context=shape.context)
    raise ValueError(f"unknown shape kind {shape.kind!r}")


def count_step(cfg: ModelConfig, shape: ShapeConfig,
               plan: MemoryPlan = MemoryPlan(), settings=None,
               device="meta") -> ComponentCost:
    """FLOPs and bytes of one step of `shape`'s kind, on one device.
    `device` is the meta device unless a test counts on the CPU (the same
    count). Raises CountError where the step cannot run there or counts
    nothing."""
    dev = torch.device(device)
    what = f"{shape.kind} step of {cfg.name} ({cfg.n_layers} layers)"
    try:
        step = _step(cfg, shape, plan, counting_settings(settings), dev)
        flops = FlopCounterMode(display=False)
        moved = ByteCounter()
        with flops, moved:
            step()
    except (RuntimeError, NotImplementedError) as e:
        raise CountError(f"cannot count the {what} on {dev}: {e}") from e
    n_flops, n_bytes = flops.get_total_flops(), moved.bytes
    if n_flops <= 0 or n_bytes <= 0:
        raise CountError(f"the {what} counted {n_flops} FLOPs and {n_bytes} "
                         "bytes")
    return ComponentCost(flops=float(n_flops), bytes_accessed=float(n_bytes),
                         wire_bytes=0.0, collectives={})
