"""Arithmetic of the end-to-end metrics: over every chunk of the window and
the whole window, never a median of pieces."""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank ``q``-th percentile of all values (a missing value is
    ``math.inf`` and ranks last); None when there are none."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def lags_ms(due: Sequence[float], done: Sequence[Optional[float]]) -> List[float]:
    """Per chunk, ms from its due time to its completion; ``inf`` where it
    never completed (a missing chunk misses every limit)."""
    return [math.inf if d is None else (d - t) * 1e3 for t, d in zip(due, done)]


def goodput_gbps(sizes: Iterable[int], done: Iterable[bool], seconds: float) -> float:
    """Raw bits of the chunks complete (and correct) when the window closed,
    over the window's length, in Gbps."""
    return sum(n * 8 for n, d in zip(sizes, done) if d) / seconds / 1e9


def even_schedule(n: int, seconds: float) -> List[float]:
    """``n`` arrivals evenly spaced over the window, the first at its start."""
    return [i * seconds / n for i in range(n)]


def poisson_schedule(rng, n: int, seconds: float) -> List[float]:
    """A Poisson process on the window conditioned on ``n`` arrivals: ``n``
    sorted uniform times. Every seed gets the same number of arrivals."""
    return sorted(rng.uniform(0.0, seconds, n).tolist())
