"""Perf counters + histograms.

The metric model of reference src/common/perf_counters.h:154 (typed
counters: u64 count, time, averages with (sum,count) pairs) and
src/perf_histogram.h (2D axis-configured histograms), exposed as
``perf dump``-style nested dicts (admin socket / mgr report payloads).

Port copy of ceph_tpu/common/perf.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from enum import Enum


class CounterType(Enum):
    U64 = "u64"          # monotonically increasing counter
    GAUGE = "gauge"      # settable level
    TIME = "time"        # accumulated seconds
    LONGRUNAVG = "avg"   # (sum, count) average pair
    HISTOGRAM = "hist"   # log2-bucketed distribution (perf_histogram.h)


# log2 histogram layout: bucket i counts samples with value <= 2**i
# (bucket 0 is le=1, bucket 30 is le=2**30); the last bucket is the
# +Inf overflow.  Unit-agnostic — latency instrumentation records
# microseconds by convention (counter names carry a _us suffix), so
# the span is 1us .. ~18min before overflow.
HIST_BUCKETS = 32


def bucket_index(value: float) -> int:
    """The log2 bucket a sample lands in (exact at power-of-2 edges:
    2**k goes to le=2**k, 2**k + eps to le=2**(k+1))."""
    if value <= 1.0:
        return 0
    m, e = math.frexp(value)           # value = m * 2**e, m in [0.5, 1)
    idx = e - 1 if m == 0.5 else e
    return min(idx, HIST_BUCKETS - 1)


def bucket_le(i: int) -> float:
    """Inclusive upper bound of bucket i (+Inf for the overflow)."""
    if i >= HIST_BUCKETS - 1:
        return math.inf
    return float(1 << i)


def _hist_counts(h: dict | None) -> list[int]:
    """Bucket list of a dumped histogram, normalized to ints and padded
    to at least HIST_BUCKETS.  Mixed-version daemons can dump shorter or
    longer bucket arrays (a histogram layout change mid-upgrade) — the
    mgr merges whatever arrives, so mismatched counts must pad, never
    raise or silently drop samples."""
    if not h:
        return [0] * HIST_BUCKETS
    counts = [int(x) for x in h.get("buckets", ())]
    if len(counts) < HIST_BUCKETS:
        counts += [0] * (HIST_BUCKETS - len(counts))
    return counts


def hist_merge(a: dict | None, b: dict | None) -> dict:
    """Merge two dumped histograms (elementwise bucket sum) — the mgr
    aggregates per-daemon dumps into cluster series with this.
    Mismatched bucket counts merge by padding the shorter side with
    zeros (no sample is lost, no IndexError)."""
    if not a:
        a = {"buckets": [], "sum": 0.0, "count": 0}
    if not b:
        b = {"buckets": [], "sum": 0.0, "count": 0}
    ab, bb = _hist_counts(a), _hist_counts(b)
    n = max(len(ab), len(bb))
    ab += [0] * (n - len(ab))
    bb += [0] * (n - len(bb))
    return {
        "buckets": [x + y for x, y in zip(ab, bb)],
        "sum": float(a.get("sum", 0.0)) + float(b.get("sum", 0.0)),
        "count": int(a.get("count", 0)) + int(b.get("count", 0)),
    }


def hist_delta(cur: dict | None, prev: dict | None) -> dict:
    """``cur - prev`` of two cumulative histogram dumps: the
    distribution of ONLY the samples recorded between the two
    snapshots.  This is the sliding-window primitive: counters are
    monotonic, so the window histogram is the elementwise difference
    of its edge snapshots.  Buckets clamp at 0 (a daemon restart
    resets counters; a negative window would corrupt quantiles)."""
    ca, cb = _hist_counts(cur), _hist_counts(prev)
    n = max(len(ca), len(cb))
    ca += [0] * (n - len(ca))
    cb += [0] * (n - len(cb))
    buckets = [max(0, x - y) for x, y in zip(ca, cb)]
    cur = cur or {}
    prev = prev or {}
    return {
        "buckets": buckets,
        "sum": max(0.0, float(cur.get("sum", 0.0))
                   - float(prev.get("sum", 0.0))),
        "count": sum(buckets),
    }


def hist_quantile(h: dict, q: float) -> float | None:
    """Quantile estimate from a dumped histogram: locate the bucket
    holding rank q*count, linearly interpolate inside it (Prometheus
    histogram_quantile semantics).  Overflow bucket returns its lower
    bound.  Exact and deterministic given the bucket counts.  An EMPTY
    histogram has no quantiles: returns ``None`` (callers render it as
    absent/0, but must not mistake it for a measured 0)."""
    counts = list(h.get("buckets", ()))
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    last = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= rank:
            lo = 0.0 if i == 0 else bucket_le(i - 1)
            hi = bucket_le(i)
            if math.isinf(hi):
                return lo
            frac = min(1.0, max(0.0, (rank - cum) / c))
            return lo + (hi - lo) * frac
        cum += c
        last = bucket_le(i)
    return last if not math.isinf(last) else bucket_le(HIST_BUCKETS - 2)


def hist_frac_above(h: dict, threshold: float) -> float:
    """Fraction of recorded samples whose value exceeds ``threshold``
    — the error-budget numerator for a latency SLO (``pXX <= T`` burns
    budget at ``frac_above(T) / (1 - 0.XX)``).  Exact when the
    threshold sits on a log2 bucket edge; inside a bucket the count
    splits by linear interpolation (the same uniform-within-bucket
    assumption hist_quantile makes).  Empty histograms burn nothing."""
    counts = list(h.get("buckets", ()))
    total = sum(counts)
    if total <= 0:
        return 0.0
    above = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        lo = 0.0 if i == 0 else bucket_le(i - 1)
        hi = bucket_le(i)
        if threshold <= lo:
            above += c
        elif threshold < hi:                 # inside this bucket
            if math.isinf(hi):
                continue   # overflow bucket: value == lower bound
            above += c * (hi - threshold) / (hi - lo)
    return above / total


def counter_scalar(val) -> float:
    """Scalar view of ONE dumped counter value, whatever its type.

    perf dumps are not uniformly scalar: LONGRUNAVG dumps
    ``{"sum", "avgcount"}`` and HISTOGRAM ``{"buckets", "sum",
    "count"}`` — code that sums ``dump()[subsys][key]`` across daemons
    breaks the day a key changes type.  This mirrors
    :meth:`PerfCounters.value`: dict forms collapse to their ``sum``.
    """
    if isinstance(val, dict):
        return float(val.get("sum", 0.0))
    return float(val)


def counter_sum(dumps, subsys: str, key: str) -> float:
    """Sum one counter across many daemons' ``dump()`` outputs,
    tolerating daemons without the subsystem or key (mixed-version
    clusters mid-upgrade)."""
    return sum(
        counter_scalar(d.get(subsys, {}).get(key, 0.0)) for d in dumps
    )


@dataclass
class _Counter:
    type: CounterType
    value: float = 0.0
    sum: float = 0.0
    count: int = 0
    buckets: list[int] = field(default_factory=list)


class PerfCounters:
    """One subsystem's counter set (PerfCounters analog); create via
    PerfCountersCollection.create()."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: dict[str, _Counter] = {}

    def add(self, key: str, ctype: CounterType = CounterType.U64) -> None:
        with self._lock:
            if key in self._counters:
                return
            c = _Counter(ctype)
            if ctype == CounterType.HISTOGRAM:
                c.buckets = [0] * HIST_BUCKETS
            self._counters[key] = c

    def hinc(self, key: str, value: float) -> None:
        """Record one sample into a HISTOGRAM counter."""
        with self._lock:
            c = self._counters[key]
            c.buckets[bucket_index(value)] += 1
            c.sum += value
            c.count += 1

    def inc(self, key: str, by: float = 1) -> None:
        with self._lock:
            c = self._counters[key]
            c.value += by

    def dec(self, key: str, by: float = 1) -> None:
        self.inc(key, -by)

    def set(self, key: str, value: float) -> None:
        with self._lock:
            self._counters[key].value = value

    def tinc(self, key: str, seconds: float) -> None:
        """Accumulate elapsed time (or any (sum,count) sample)."""
        with self._lock:
            c = self._counters[key]
            c.sum += seconds
            c.count += 1
            c.value = c.sum

    def time(self, key: str):
        """Context manager measuring a code section into a TIME/AVG counter."""
        perf = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                perf.tinc(key, time.perf_counter() - self.t0)
                return False

        return _Timer()

    def value(self, key: str, default: float = 0.0) -> float:
        """Point read of a scalar counter (U64/GAUGE/TIME); LONGRUNAVG
        and HISTOGRAM return their accumulated sum.  Missing counters
        return ``default`` — bench/smoke assertions poll by name
        without caring whether registration already happened."""
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                return default
            if c.type in (CounterType.LONGRUNAVG, CounterType.HISTOGRAM):
                return c.sum
            return c.value

    def dump(self) -> dict:
        with self._lock:
            out = {}
            for key, c in self._counters.items():
                if c.type == CounterType.HISTOGRAM:
                    out[key] = {"buckets": list(c.buckets),
                                "sum": c.sum, "count": c.count}
                elif c.type == CounterType.LONGRUNAVG or c.count:
                    out[key] = {"sum": c.sum, "avgcount": c.count}
                else:
                    out[key] = c.value
            return out

    def quantile(self, key: str, q: float) -> float:
        """Quantile of a live HISTOGRAM counter (hist_quantile on a
        point-in-time dump); 0.0 when no samples were recorded yet
        (bench/smoke callers poll before traffic lands)."""
        with self._lock:
            c = self._counters[key]
            h = {"buckets": list(c.buckets), "count": c.count}
        got = hist_quantile(h, q)
        return 0.0 if got is None else got

    def reset(self) -> None:
        with self._lock:
            for c in self._counters.values():
                c.value = c.sum = 0.0
                c.count = 0
                if c.buckets:
                    c.buckets = [0] * len(c.buckets)


class Histogram:
    """Linear/log-binned histogram (perf_histogram.h analog, 1D form)."""

    def __init__(self, name: str, buckets: list[float]):
        self.name = name
        self.buckets = list(buckets)  # upper bounds, ascending
        self.counts = [0] * (len(buckets) + 1)
        self._lock = threading.Lock()

    def sample(self, value: float) -> None:
        with self._lock:
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def dump(self) -> dict:
        with self._lock:
            return {
                "buckets": self.buckets,
                "counts": list(self.counts),
            }


class PerfCountersCollection:
    """Process-wide registry; the ``perf dump`` aggregation point."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sets: dict[str, PerfCounters] = {}
        self._hists: dict[str, Histogram] = {}

    def create(self, name: str) -> PerfCounters:
        with self._lock:
            return self._sets.setdefault(name, PerfCounters(name))

    def create_histogram(self, name: str, buckets: list[float]) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, buckets)
            return h

    def dump(self) -> dict:
        with self._lock:
            out = {name: s.dump() for name, s in self._sets.items()}
            for name, h in self._hists.items():
                out[name + "_histogram"] = h.dump()
            return out
