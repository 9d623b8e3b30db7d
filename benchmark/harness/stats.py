"""Order statistics, in plain Python."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) with linear interpolation between the
    two nearest ranks (numpy's default method)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    at = (len(xs) - 1) * q / 100.0
    lo = math.floor(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def mean(values: Sequence[float]) -> float:
    return math.fsum(values) / len(values)
