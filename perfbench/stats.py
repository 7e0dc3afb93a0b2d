"""Percentiles and the tokens a stream produced in a window."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values`` by the nearest rank
    at or above it: the smallest value with at least ``q``% of the values
    at or below it. Every sample counts, a request that missed (``inf``)
    included."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def tokens_produced(stamps: Sequence[float], t0: float, t1: float,
                    join: float = 1e-3) -> float:
    """Tokens of one stream produced in ``[t0, t1)``. Tokens arrive in
    bursts (a decode chunk's tokens are read back together); stamps less
    than ``join`` seconds apart are one burst, and a burst's tokens count
    as produced evenly since the burst before it, so a burst that
    straddles an edge of the window counts in part. The stream's first
    burst (the prefill's token) counts where it arrived."""
    bursts: list = []
    for s in stamps:
        if bursts and s - bursts[-1][0] < join:
            bursts[-1] = (s, bursts[-1][1] + 1)
        else:
            bursts.append((s, 1))
    total = 0.0
    for i, (b, k) in enumerate(bursts):
        if i == 0:
            total += k if t0 <= b < t1 else 0
            continue
        a = bursts[i - 1][0]
        total += k * max(0.0, min(b, t1) - max(a, t0)) / (b - a)
    return total
