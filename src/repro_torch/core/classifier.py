"""Workload classification — the paper's Tables I and II, verbatim.

Four categories over (α, inc):
  Expanding.Rapid   α >= 1, inc >= 2
  Expanding.Medium  α >= 1, inc <  2
  Medium            0.5 < α < 1
  Shrinking         α <= 0.5

Table III capacity factors {4, 3, 2, 1} — kept as the per-category
conservative multipliers (DESIGN.md §9 records the reinterpretation over
the fitted slope for the beyond-paper predictor mode).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

from repro_torch.core import expansion as E


class Category(str, enum.Enum):
    EXPANDING_RAPID = "Expanding.Rapid"
    EXPANDING_MEDIUM = "Expanding.Medium"
    MEDIUM = "Medium"
    SHRINKING = "Shrinking"


# Paper Table III.
FACTOR_SHUF = {
    Category.EXPANDING_RAPID: 4.0,
    Category.EXPANDING_MEDIUM: 3.0,
    Category.MEDIUM: 2.0,
    Category.SHRINKING: 1.0,
}

ALPHA_EXPANDING = 1.0     # Table I
ALPHA_SHRINKING = 0.5     # Table I
INC_RAPID = 2.0           # Table II


@dataclasses.dataclass(frozen=True)
class Classification:
    category: Category
    alpha: float
    inc: float
    slope: float            # fitted bytes/byte (beyond-paper mode)
    intercept: float

    @property
    def factor(self) -> float:
        return FACTOR_SHUF[self.category]


def classify(alpha: float, inc: float) -> Category:
    if alpha >= ALPHA_EXPANDING:
        return (Category.EXPANDING_RAPID if inc >= INC_RAPID
                else Category.EXPANDING_MEDIUM)
    if alpha <= ALPHA_SHRINKING:
        return Category.SHRINKING
    return Category.MEDIUM


def classify_profiles(profiles: Sequence[E.MemoryProfile]) -> Classification:
    alpha = E.mean_expansion_ratio(profiles)
    inc = E.increasing_rate(profiles)
    return Classification(
        category=classify(alpha, inc),
        alpha=alpha,
        inc=inc,
        slope=E.fitted_slope(profiles),
        intercept=E.fitted_intercept(profiles),
    )
