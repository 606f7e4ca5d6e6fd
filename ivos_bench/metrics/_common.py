"""Shared arithmetic of the metric readers (not a metric itself)."""
from __future__ import annotations

import math
from typing import Iterable, Optional


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile, None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def traced_reads(run) -> int:
    return len(run.counts.reads) if run.counts is not None else 0


def untraced_rounds(run) -> list:
    """The rounds that did not overlap the profiled part of the window,
    which the profiler slows: every round of an untraced run."""
    return [r for r in run.rounds if not r.traced]
