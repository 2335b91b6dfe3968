"""Percentiles and spreads as the benchmark reports them."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    sample at or below it (a missing sample is +inf and ranks last)."""
    if not values:
        raise ValueError("percentile of no samples")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
