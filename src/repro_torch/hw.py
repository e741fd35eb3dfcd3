"""Hardware constants used by the WSMC capacity model.

The port's target is one NVIDIA H100 (SXM, 80 GB HBM3); `H100` holds the
card's published numbers (NVIDIA's data sheet, dense rates, full 700 W
power limit). `TPU_V5E` stays as data only: the parity tests hand the same
spec to this package's predictor and to the reference package's, so the
two capacity models are compared on equal inputs.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    hbm_bytes: int              # device memory per chip
    hbm_bw: float               # bytes/s per chip
    ici_link_bw: float          # bytes/s per inter-chip link (one direction)
    ici_links_per_chip: int     # links per chip
    vmem_bytes: int             # fast on-chip memory one kernel block can
                                # use (H100: shared memory per thread block)
    # Runtime reserve: allocator + runtime scratch. Plays the role of the
    # paper's "Reserved Memory" (RM, 300MB in Spark's default).
    reserved_bytes: int = 300 * 1024 * 1024


TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bytes=16 * 1024**3,
    hbm_bw=819e9,
    ici_link_bw=50e9,
    ici_links_per_chip=4,
    vmem_bytes=128 * 1024 * 1024,
)

# One H100 SXM: 80 GB HBM3 at 3.35 TB/s, 989 TFLOP/s dense bf16, 227 KB of
# shared memory usable by one thread block, NVLink at 450 GB/s each way
# (counted here as one link).
H100 = HardwareSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bytes=80 * 10**9,
    hbm_bw=3.35e12,
    ici_link_bw=450e9,
    ici_links_per_chip=1,
    vmem_bytes=227 * 1024,
)

# The paper's Eq. 11 headroom factor: capacity = spark_mem * 4/3 + RM.
# We keep 4/3 as the fragmentation / runtime-scratch margin.
CAPACITY_HEADROOM = 4.0 / 3.0


def capacity_from_requirement(resident_bytes: float, transient_bytes: float,
                              hw: HardwareSpec = TPU_V5E) -> float:
    """Paper Eq. 11: Mem_cap = Mem_spark * 4/3 + RM, per device."""
    return (resident_bytes + transient_bytes) * CAPACITY_HEADROOM + hw.reserved_bytes
