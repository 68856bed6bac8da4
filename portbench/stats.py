"""The arithmetic of the benchmark's numbers: percentiles, and the union of
device intervals (a copy of ``lbm_tpu_torch.models.driver``'s
``_busy_seconds``)."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: int) -> float:
    """The q-th percentile (q in 1..99) of ``values``, linearly interpolated
    between order statistics (``statistics.quantiles(..., method='inclusive')``)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals given in us."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] (us) that no interval covers."""
    out, pos = [], lo
    for a, b in sorted(intervals):
        if a > pos:
            out.append((pos, min(a, hi)))
        pos = max(pos, b)
        if pos >= hi:
            break
    if pos < hi:
        out.append((pos, hi))
    return [(a, b) for a, b in out if b > a]
