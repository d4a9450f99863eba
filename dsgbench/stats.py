"""The benchmark's arithmetic on measured numbers: rates, percentiles and
the union of device intervals. Plain Python, no torch."""
from __future__ import annotations


def rate(count: int, seconds: float) -> float:
    """Work completed per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return count / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) of ``values`` by linear
    interpolation between closest ranks (numpy's default method), so the
    95th of 1..100 is 95.05. Raises on an empty sample."""
    xs = sorted(values)
    if not xs:
        raise ValueError("the percentile of no values")
    if not 0 < q < 100:
        raise ValueError(f"q={q} is not in (0, 100)")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals, overlaps once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """``intervals`` cut to ``[lo, hi]``; the empty ones dropped."""
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return out


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers, in order."""
    out, at = [], lo
    for a, b in sorted(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


__all__ = ["rate", "percentile", "union_length", "clip", "gaps"]
