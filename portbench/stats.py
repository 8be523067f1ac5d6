"""The benchmark's arithmetic: percentiles, the union of intervals, rates
and the spread of a set of runs. Frozen with the benchmark: the program's
own copies (`bench_train.percentile`, `profile_infer.busy_us`) may
change, these do not."""
from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def percentile(xs: Sequence[float], q: float) -> float:
    """The q-th percentile of xs by nearest rank (the smallest value with
    at least q% of the values at or below it)."""
    xs = sorted(xs)
    if not xs:
        raise ValueError("percentile of no values")
    return xs[min(len(xs) - 1, max(0, -(-q * len(xs) // 100) - 1))]


def median(xs: Sequence[float]) -> float:
    return statistics.median(xs)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float,
         stop: float) -> List[Tuple[float, float]]:
    """The stretches of [start, stop) that no interval covers."""
    out, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, stop)))
        at = max(at, e)
        if at >= stop:
            break
    if at < stop:
        out.append((at, stop))
    return [(s, e) for s, e in out if e > s]


def rate(work: float, seconds: float) -> float:
    """Work per second over a window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of
    the median (Python's `statistics.quantiles`, n=4)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
