"""Three-term roofline: the analytic half of the reference package's
roofline/analysis.py.

The layer-stack cost comes from *depth extrapolation*: count the model at
depth 1 and depth 2 (same width, shapes, mesh), then

    unit_cost   = cost(depth2) - cost(depth1)
    outside     = cost(depth1) - unit_cost
    total       = outside + repeats × unit_cost

All quantities are per device. Terms on the hardware `hw` the report is
made for (default `HW.H100`): T_comp = FLOPs / hw.peak_flops_bf16,
T_mem = bytes / hw.hbm_bw, T_coll = wire_bytes / hw.ici_link_bw. Roofline
time = max of the three; the dominant term is the hillclimbing target.
`report(..., hw=HW.TPU_V5E)` gives exactly the reference's numbers, whose
MFU bounds divide by the TPU's peak whatever `hw` is; here they divide by
the report's own `hw.peak_flops_bf16`.

The reference's `cost_dict` and `component_cost(compiled)` read XLA's
cost analysis and the partitioned HLO of a compiled step
(`launch/compile.py`, `roofline/hlo.py`); a PyTorch step has nothing
compiled ahead of time, so none of the three has a counterpart. The
port counts a step itself: `roofline.count.count_step` runs it on the
meta device and returns the same `ComponentCost`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch import hw as HW
from repro_torch.configs.base import (ATTN, DECODE, MLSTM, RGLRU, SLSTM, TRAIN,
                                      ModelConfig, ShapeConfig, model_flops,
                                      param_count)


@dataclasses.dataclass
class ComponentCost:
    flops: float
    bytes_accessed: float
    wire_bytes: float
    collectives: Dict[str, float]


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    t_comp: float
    t_mem: float
    t_coll: float
    model_flops_total: float
    collectives: Dict[str, float]
    t_mem_analytic: float = 0.0    # perfect-fusion lower bound
    # the hardware the terms are computed for (not part of to_dict)
    hw: HW.HardwareSpec = HW.H100

    @property
    def t_roofline(self) -> float:
        return max(self.t_comp, self.t_mem, self.t_coll)

    @property
    def t_roofline_analytic(self) -> float:
        """Roofline with the perfect-fusion memory bound (optimistic)."""
        mem = self.t_mem_analytic or self.t_mem
        return max(self.t_comp, mem, self.t_coll)

    @property
    def mfu_bound_analytic(self) -> float:
        per_chip_model = self.model_flops_total / self.n_chips
        return (per_chip_model / self.hw.peak_flops_bf16) / \
            max(self.t_roofline_analytic, 1e-30)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much counted compute is
        'useful' (catches remat recompute, masked-block waste, dispatch
        overhead)."""
        hlo_total = self.flops_per_chip * self.n_chips
        return self.model_flops_total / max(hlo_total, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound: the score if the
        chip hits peak on the dominant term."""
        per_chip_model = self.model_flops_total / self.n_chips
        return (per_chip_model / self.hw.peak_flops_bf16) / \
            max(self.t_roofline, 1e-30)

    def to_dict(self) -> dict:
        """The reference's keys: every field but `hw`, and the derived
        terms."""
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "hw"}
        d["collectives"] = dict(self.collectives)
        d.update(t_roofline=self.t_roofline, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 mfu_bound=self.mfu_bound,
                 t_roofline_analytic=self.t_roofline_analytic,
                 mfu_bound_analytic=self.mfu_bound_analytic)
        return d


def extrapolate(depth1: ComponentCost, depth2: ComponentCost,
                repeats: int) -> ComponentCost:
    def comb(a1, a2):
        unit = max(a2 - a1, 0.0)
        outside = max(a1 - unit, 0.0)
        return outside + repeats * unit

    coll = {}
    for k in set(depth1.collectives) | set(depth2.collectives):
        coll[k] = comb(depth1.collectives.get(k, 0.0),
                       depth2.collectives.get(k, 0.0))
    return ComponentCost(
        flops=comb(depth1.flops, depth2.flops),
        bytes_accessed=comb(depth1.bytes_accessed, depth2.bytes_accessed),
        # wire must be the sum of per-kind compositions: composing the
        # clamped totals misses kind-mix shifts between depths
        wire_bytes=sum(coll.values()),
        collectives=coll,
    )


def scan_corrections(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
                     q_block: int = 512, mlstm_chunk: int = 128
                     ) -> ComponentCost:
    """Analytic FLOPs/bytes of the *inner* scans a cost analysis that counts
    a scan body once would miss.

    The reference's compiled roofline counts the blocked attention (q
    blocks × kv blocks), the mLSTM chunk scan, the sLSTM time scan and the
    RG-LRU associative scan once each and adds their work from shapes here
    (per chip; batch/head sharding divides by n_chips). The port's counter
    (`roofline.count`) counts every iteration, so this is not added to a
    counted cost; it stays a term of `analytic_hbm_traffic`.
    """
    if shape.kind == DECODE:
        return ComponentCost(0.0, 0.0, 0.0, {})   # no inner scans in decode
    b, s = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    mult = 3.0 if shape.kind == TRAIN else 1.0    # fwd + bwd(2x)
    # attention-with-remat recomputes the forward once more in backward
    remat_mult = 4.0 if shape.kind == TRAIN else 1.0
    B = 2.0                                        # bf16 streams
    flops = bytes_ = 0.0
    for blk in cfg.blocks():
        if blk.mixer == ATTN:
            if blk.window is not None:
                w = min(blk.window, s)
                kv_per_q = (w * (w + 1) / 2 + (s - w) * w) / s if w < s \
                    else (s + 1) / 2
                span_reads = -(-s // q_block) * (min(w, s) + q_block)
            elif blk.chunk is not None:
                c = min(blk.chunk, s)
                kv_per_q = (c + 1) / 2
                span_reads = (s // max(c, 1) or 1) * (c / q_block) * c
            else:
                kv_per_q = (s + 1) / 2
                span_reads = -(-s // q_block) * s   # every q block reads all kv
            flops += 4.0 * b * s * kv_per_q * H * hd * mult
            bytes_ += b * (span_reads * K * hd * 2 * B * remat_mult
                           + s * H * hd * 2 * B * mult)
        elif blk.mixer == MLSTM:
            inner = int(cfg.mlstm_proj_factor * cfg.d_model)
            dh = inner // cfg.n_heads
            c = mlstm_chunk
            nc = max(s // c, 1)
            per_chunk = (2 * c * c * (dh + dh)      # qk^T + sw·v
                         + 4 * c * dh * dh)          # state update + inter
            flops += b * cfg.n_heads * nc * per_chunk * mult
            bytes_ += b * s * (3 * inner + 2 * cfg.n_heads) * B * mult \
                + b * cfg.n_heads * nc * dh * dh * 4.0   # state spills (f32)
        elif blk.mixer == SLSTM:
            d = cfg.d_model
            dh = d // cfg.n_heads
            # recurrent matmul per step + per-step weight re-read (the
            # sequential scan cannot keep R on chip across big d)
            flops += b * s * (2 * d * 4 * dh) * mult
            bytes_ += s * (d * 4 * dh) * B * mult + b * s * 8 * d * 4.0
        elif blk.mixer == RGLRU:
            w = cfg.lru_width or cfg.d_model
            passes = 2 * max(math.ceil(math.log2(max(s, 2))), 1)
            flops += b * s * w * passes * 2 * mult
            bytes_ += b * s * w * passes * 4.0 * mult
    return ComponentCost(flops=flops / n_chips, bytes_accessed=bytes_ / n_chips,
                         wire_bytes=0.0, collectives={})


def analytic_hbm_traffic(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
                         remat: str = "none", microbatches: int = 1,
                         opt_state_bytes: float = 8.0) -> float:
    """Perfect-fusion device-memory traffic lower bound, per chip per step
    (bytes).

    The counted 'bytes accessed' sums every op's operands and outputs with
    no fusion credit (an upper bound); this model assumes ideal fusion:
    weights streamed once per pass, activations written once at block
    boundaries + re-read by backward, optimizer state r/w once. The truth
    lies between the two — the roofline reports both.
    """
    n_params = param_count(cfg)
    w_bytes = 2.0 * n_params / n_chips                  # bf16, sharded
    toks = shape.tokens
    d = cfg.d_model
    B = 2.0
    # per-token activation bytes saved at block boundaries (write + read):
    saved_per_layer = {"none": 14.0, "dots": 8.0, "full": 2.0}[remat] * d * B
    act = 2.0 * toks * saved_per_layer * cfg.n_layers / n_chips
    passes = {"none": 3.0, "dots": 3.5, "full": 4.0}[remat] \
        if shape.kind == TRAIN else 1.0                  # fwd(+bwd)(+remat)
    total = w_bytes * passes * max(microbatches, 1)
    if shape.kind == TRAIN:
        total += act
        total += n_params * (4.0 + 2.0 * opt_state_bytes) / n_chips  # grads+opt
        vocab_passes = 3.0
    else:
        vocab_passes = 1.0
    total += vocab_passes * toks * cfg.padded_vocab_size * 4.0 / n_chips
    if shape.kind == DECODE:                             # cache read + write
        hd = cfg.resolved_head_dim
        for blk in cfg.blocks():
            if blk.is_attn:
                L = blk.cache_len(shape.context)
                total += (shape.global_batch * L * cfg.n_kv_heads * hd
                          * 2 * B) / n_chips
            elif blk.mixer == MLSTM:
                inner = int(cfg.mlstm_proj_factor * d)
                dh = inner // cfg.n_heads
                total += shape.global_batch * cfg.n_heads * dh * dh * 8.0 \
                    / n_chips
    # inner-scan streams (attention kv re-reads etc.) — shared with the
    # corrections model:
    total += scan_corrections(cfg, shape, n_chips).bytes_accessed
    return total


def apply_corrections(cost: ComponentCost, corr: ComponentCost
                      ) -> ComponentCost:
    return ComponentCost(
        flops=cost.flops + corr.flops,
        bytes_accessed=cost.bytes_accessed + corr.bytes_accessed,
        wire_bytes=cost.wire_bytes + corr.wire_bytes,
        collectives=cost.collectives,
    )


def report(cfg: ModelConfig, shape: ShapeConfig, mesh_name: str,
           n_chips: int, cost: ComponentCost,
           hw: HW.HardwareSpec = HW.H100,
           remat: str = "none", microbatches: int = 1) -> RooflineReport:
    analytic = analytic_hbm_traffic(cfg, shape, n_chips, remat=remat,
                                    microbatches=1)
    return RooflineReport(
        arch=cfg.name,
        shape=shape.name,
        mesh=mesh_name,
        n_chips=n_chips,
        flops_per_chip=cost.flops,
        bytes_per_chip=cost.bytes_accessed,
        wire_bytes_per_chip=cost.wire_bytes,
        t_comp=cost.flops / hw.peak_flops_bf16,
        t_mem=cost.bytes_accessed / hw.hbm_bw,
        t_coll=cost.wire_bytes / hw.ici_link_bw,
        model_flops_total=model_flops(cfg, shape),
        collectives=cost.collectives,
        t_mem_analytic=analytic / hw.hbm_bw,
        hw=hw,
    )
