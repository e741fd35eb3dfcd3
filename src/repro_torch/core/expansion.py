"""Memory Expansion Ratio — the paper's Data Expansion Ratio (Eqs. 2-5)
re-grounded in the XLA memory model (DESIGN.md §2).

  Data_input  -> per-device *embedded input bytes*: the batch tokens this
                 device processes, materialized at model width (the paper's
                 "data loaded into Storage Memory", Eq. 7).
  Data_shuf   -> per-device *transient bytes*: XLA temp allocation — live
                 activations, remat residuals, collective buffers — the
                 intermediate data the workload "shuffles" between its
                 stages (layers/microbatches).
  α           -> per-stage transient / embedded-input            (Eq. 4)
  inc         -> mean Δ(per-stage transient) / Δinput, relative
                 to the base α (dimensionless growth rate)       (Eq. 5)

Stage normalization (DESIGN.md §9): Spark stages execute serially and the
paper takes the max over stages; under BPTT every layer's residuals stay
live simultaneously, so XLA's temp covers *all* stages. We therefore define
the expansion ratio per stage (layer) — temp / (n_stages · input) — keeping
the paper's α thresholds discriminative, and the capacity predictor
multiplies back by the live-stage count (remat controls how many survive).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.configs.base import ModelConfig, ShapeConfig

BYTES_ACT = 2  # bf16 activations


@dataclasses.dataclass(frozen=True)
class MemoryProfile:
    arch: str
    shape_name: str
    kind: str
    n_devices: int
    seq_len: int
    global_batch: int
    n_stages: int             # serial "stages" = layer blocks
    input_bytes: float        # per-device embedded input (α denominator)
    argument_bytes: float     # per-device resident (params+opt+cache+inputs)
    transient_bytes: float    # per-device temp (α numerator, all stages)
    output_bytes: float
    reported_peak: float

    @property
    def peak_bytes(self) -> float:
        """Static peak: resident + transients + outputs (conservative; the
        CPU backend's reported peak ignores arguments)."""
        return self.argument_bytes + self.transient_bytes + self.output_bytes

    @property
    def stage_transient_bytes(self) -> float:
        return self.transient_bytes / max(self.n_stages, 1)

    @property
    def alpha(self) -> float:
        return self.stage_transient_bytes / max(self.input_bytes, 1.0)


def embedded_input_bytes(cfg: ModelConfig, shape: ShapeConfig,
                         n_devices: int, dp_size: int) -> float:
    """Per-device Data_input: the data this step *loads* at model width —
    the token batch for train/prefill, the attended context for decode
    (Eq. 7's 'data loading' stage; the decode step's working set is its
    cache read, exactly as KMeans' was its cached dataset)."""
    batch_per_dp = max(shape.global_batch // max(dp_size, 1), 1)
    toks = batch_per_dp * shape.seq_len   # DECODE: seq_len = context
    per_tok = cfg.d_model * BYTES_ACT
    return float(toks * per_tok)


def expansion_ratio(profile: MemoryProfile) -> float:
    """Paper Eq. 4."""
    return profile.alpha


def mean_expansion_ratio(profiles: Sequence[MemoryProfile]) -> float:
    """Paper §III-C: 'the Data Expansion Ratio of the workload is the
    average over the input data set DS'."""
    return sum(p.alpha for p in profiles) / max(len(profiles), 1)


def increasing_rate(profiles: Sequence[MemoryProfile]) -> float:
    """Paper Eq. 5: mean finite-difference slope of (per-stage) transient vs
    input over the ascending ladder, normalized by the base α so inc is the
    dimensionless growth rate: 1 = linear scaling, >= 2 = superlinear
    (Table II's Expanding.Rapid threshold)."""
    ps = sorted(profiles, key=lambda p: p.input_bytes)
    if len(ps) < 2:
        return 1.0
    base_alpha = max(ps[0].alpha, 1e-9)
    slopes = []
    for a, b in zip(ps[:-1], ps[1:]):
        dx = b.input_bytes - a.input_bytes
        if dx <= 0:
            continue
        slopes.append((b.stage_transient_bytes - a.stage_transient_bytes) / dx)
    if not slopes:
        return 1.0
    return (sum(slopes) / len(slopes)) / base_alpha


def fitted_slope(profiles: Sequence[MemoryProfile]) -> float:
    """Least-squares transient = slope·input + const (beyond-paper 'fitted'
    predictor mode); returns slope in bytes/byte."""
    ps = sorted(profiles, key=lambda p: p.input_bytes)
    n = len(ps)
    if n == 1:
        return ps[0].alpha
    xs = [p.input_bytes for p in ps]
    ys = [p.transient_bytes for p in ps]
    mx = sum(xs) / n
    my = sum(ys) / n
    denom = sum((x - mx) ** 2 for x in xs)
    if denom <= 0:
        return ps[0].alpha
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom


def fitted_intercept(profiles: Sequence[MemoryProfile]) -> float:
    ps = sorted(profiles, key=lambda p: p.input_bytes)
    slope = fitted_slope(ps)
    n = len(ps)
    return (sum(p.transient_bytes for p in ps)
            - slope * sum(p.input_bytes for p in ps)) / n
