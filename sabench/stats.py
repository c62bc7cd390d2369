"""The benchmark's arithmetic: the union of intervals, rates over whole
builds, and the spread that sets a bound."""
from __future__ import annotations

import math
import statistics


def merged_intervals(intervals, lo=-math.inf, hi=math.inf) -> list:
    """The union of the (start, end) intervals, each clipped to [lo, hi],
    as sorted disjoint (start, end) pairs."""
    out = []
    for start, end in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def idle_gaps(merged, lo, hi) -> list:
    """The (start, end) gaps of [lo, hi] that no merged interval covers."""
    gaps, cur = [], lo
    for start, end in merged:
        if start > cur:
            gaps.append((cur, start))
        cur = max(cur, end)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def rate_over_builds(builds, t_start: float) -> float | None:
    """Data tokens of every whole build over the time from the window's
    start to the end of the last: `builds` are (tokens, t_end) pairs."""
    if not builds:
        return None
    end = max(t_end for _, t_end in builds)
    return sum(tokens for tokens, _ in builds) / (end - t_start)


def quartile_spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (Python's `statistics.quantiles`, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
