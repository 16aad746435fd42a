"""Arithmetic the metrics share: percentiles, interval unions and the
self time of spans.  Pure Python, no clock of its own."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest
    sample with at least q% of the samples at or below it."""
    xs = sorted(values)
    if not xs:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def union_length(intervals, lo: float | None = None,
                 hi: float | None = None) -> float:
    """Length of the union of (start, end) intervals, clipped to
    [lo, hi] where given."""
    spans = []
    for a, b in intervals:
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b > a:
            spans.append((a, b))
    spans.sort()
    total, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def self_times_ms(spans, parent_names, child_pred) -> list[float]:
    """For each span whose name is in ``parent_names``: its duration
    minus the part of it that its direct children satisfying
    ``child_pred(name)`` cover, in ms.  Spans are the tracer's dicts
    (``span_id``, ``parent``, ``name``, ``start`` in s, ``duration_ms``)."""
    children: dict[str, list] = {}
    for s in spans:
        if s.get("parent") and child_pred(s["name"]):
            children.setdefault(s["parent"], []).append(s)
    out = []
    for s in spans:
        if s["name"] not in parent_names:
            continue
        a = s["start"]
        b = a + s["duration_ms"] / 1e3
        covered = union_length(
            ((c["start"], c["start"] + c["duration_ms"] / 1e3)
             for c in children.get(s["span_id"], ())), a, b)
        out.append(max(0.0, (b - a - covered) * 1e3))
    return out


def mean(values) -> float | None:
    xs = list(values)
    return sum(xs) / len(xs) if xs else None
