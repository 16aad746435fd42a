"""Bounded on-mgr time-series store: the retention layer.

Counterpart of ceph_tpu/common/tsdb.py: the same module over the
port's imports.

Every verdict the cluster renders today (SLO burn, roofline %, rebuild
rate) is computed over ONE sliding window and then forgotten — nothing
can answer "what did the burn rate do over the last ten minutes" or
correlate rebuild throughput with client tail latency over time, which
arxiv 1709.05365 shows is exactly how EC-cluster interference gets
diagnosed.  :class:`TSDB` fixes that with per-series ring buffers fed
from the existing digest cycle:

- **raw tier**: one ``(t, value)`` point per feed (~report_interval,
  5s in production), bounded by ``raw_points``;
- **minute tier**: ``tier1_s`` (60s) buckets carrying
  ``(t, sum, count, min, max)``;
- **hour tier**: ``tier2_s`` (3600s) buckets of the same shape, merged
  up from closed minute buckets.

Aggregates carry sum/count/min/max — never a pre-computed mean or
quantile — so merging two buckets is exact (sums add, mins min, maxes
max) and downstream mean/rate math is identical whichever tier served
the query.  Aggregation happens on ingest, not from the raw ring, so a
raw eviction never corrupts tier math.

Everything is bounded: ring capacities per tier, ``max_series`` on the
catalog (excess series are dropped and counted, never grown), and time
comes from the caller — the store itself is deterministic and
timer-free, same feeds => same contents (what the cfg16 bit-identical
A/B and the replay tests rely on).
"""

from __future__ import annotations

from collections import deque

# storage shapes (tuples, not dicts: ~5x smaller per point)
#   raw point:  (t, value)
#   agg bucket: (bucket_start_t, sum, count, min, max)

TIERS = ("raw", "1m", "1h")


def agg_new(t: float, value: float) -> tuple:
    """Open a new aggregate bucket seeded with one sample."""
    v = float(value)
    return (float(t), v, 1, v, v)


def agg_add(agg: tuple, value: float) -> tuple:
    """Fold one sample into an open bucket (exact: no averaging)."""
    t, s, n, mn, mx = agg
    v = float(value)
    return (t, s + v, n + 1, min(mn, v), max(mx, v))


def agg_merge(a: tuple, b: tuple) -> tuple:
    """Merge two buckets exactly; keeps the earlier start time.

    Because buckets carry sum/count/min/max, the merge is associative
    and lossless — the known-answer property the tier tests pin."""
    return (min(a[0], b[0]), a[1] + b[1], a[2] + b[2],
            min(a[3], b[3]), max(a[4], b[4]))


def agg_mean(agg: tuple) -> float:
    return agg[1] / agg[2] if agg[2] else 0.0


class Series:
    """One named series: a raw ring plus two aggregate tiers with one
    open (partial) bucket each.  Closed buckets are immutable."""

    __slots__ = ("name", "raw", "m1", "h1", "_open_m1", "_open_h1",
                 "tier1_s", "tier2_s", "evictions")

    def __init__(self, name: str, raw_points: int, m1_points: int,
                 h1_points: int, tier1_s: float, tier2_s: float):
        self.name = name
        self.raw: deque[tuple] = deque(maxlen=max(2, int(raw_points)))
        self.m1: deque[tuple] = deque(maxlen=max(2, int(m1_points)))
        self.h1: deque[tuple] = deque(maxlen=max(2, int(h1_points)))
        self._open_m1: tuple | None = None
        self._open_h1: tuple | None = None
        self.tier1_s = float(tier1_s)
        self.tier2_s = float(tier2_s)
        self.evictions = 0

    def _bucket(self, t: float, width: float) -> float:
        return t - (t % width)

    def observe(self, t: float, value: float) -> None:
        t = float(t)
        if len(self.raw) == self.raw.maxlen:
            self.evictions += 1
        self.raw.append((t, float(value)))
        # minute tier: roll the open bucket when t crosses its boundary
        b1 = self._bucket(t, self.tier1_s)
        if self._open_m1 is not None and self._open_m1[0] != b1:
            closed = self._open_m1
            if len(self.m1) == self.m1.maxlen:
                self.evictions += 1
            self.m1.append(closed)
            self._roll_h1(closed)
            self._open_m1 = None
        if self._open_m1 is None:
            self._open_m1 = (b1, float(value), 1,
                             float(value), float(value))
        else:
            self._open_m1 = agg_add(self._open_m1, value)

    def _roll_h1(self, closed_m1: tuple) -> None:
        """Fold a CLOSED minute bucket into the hour tier (hour buckets
        are merged minute buckets — exact by construction)."""
        b2 = self._bucket(closed_m1[0], self.tier2_s)
        anchored = (b2,) + closed_m1[1:]
        if self._open_h1 is not None and self._open_h1[0] != b2:
            if len(self.h1) == self.h1.maxlen:
                self.evictions += 1
            self.h1.append(self._open_h1)
            self._open_h1 = None
        if self._open_h1 is None:
            self._open_h1 = anchored
        else:
            self._open_h1 = agg_merge(self._open_h1, anchored)

    # -- reads -------------------------------------------------------------
    def last(self) -> tuple | None:
        return self.raw[-1] if self.raw else None

    def tier_points(self, tier: str) -> list[tuple]:
        """All retained points of one tier, oldest first.  Aggregate
        tiers include the open bucket so fresh data is queryable
        without waiting for the boundary to roll."""
        if tier == "raw":
            return list(self.raw)
        if tier == "1m":
            out = list(self.m1)
            if self._open_m1 is not None:
                out.append(self._open_m1)
            return out
        if tier == "1h":
            out = list(self.h1)
            if self._open_h1 is not None:
                out.append(self._open_h1)
            return out
        raise ValueError(f"unknown tier {tier!r}")

    def point_count(self) -> int:
        return len(self.raw) + len(self.m1) + len(self.h1) \
            + (1 if self._open_m1 is not None else 0) \
            + (1 if self._open_h1 is not None else 0)


class TSDB:
    """The bounded store: a catalog of :class:`Series` with shared
    tier geometry, plus the query planner the mgr surfaces call."""

    def __init__(self, raw_points: int = 720, m1_points: int = 1440,
                 h1_points: int = 336, tier1_s: float = 60.0,
                 tier2_s: float = 3600.0, max_series: int = 4096):
        self.raw_points = int(raw_points)
        self.m1_points = int(m1_points)
        self.h1_points = int(h1_points)
        self.tier1_s = float(tier1_s)
        self.tier2_s = float(tier2_s)
        self.max_series = int(max_series)
        self.series: dict[str, Series] = {}
        self.dropped_series = 0

    @classmethod
    def from_conf(cls, conf) -> "TSDB":
        return cls(raw_points=int(conf["tsdb_raw_points"]),
                   m1_points=int(conf["tsdb_minute_points"]),
                   h1_points=int(conf["tsdb_hour_points"]),
                   tier1_s=float(conf["tsdb_tier1_s"]),
                   tier2_s=float(conf["tsdb_tier2_s"]),
                   max_series=int(conf["tsdb_max_series"]))

    def _get(self, name: str) -> Series | None:
        s = self.series.get(name)
        if s is None:
            if len(self.series) >= self.max_series:
                # bounded catalog: drop + count, never grow unbounded
                self.dropped_series += 1
                return None
            s = self.series[name] = Series(
                name, self.raw_points, self.m1_points, self.h1_points,
                self.tier1_s, self.tier2_s)
        return s

    def observe(self, t: float, name: str, value) -> None:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        s = self._get(str(name))
        if s is not None:
            s.observe(t, v)

    def observe_many(self, t: float, values: dict) -> None:
        for name, v in values.items():
            self.observe(t, name, v)

    # -- query -------------------------------------------------------------
    def names(self, prefix: str = "") -> list[str]:
        if not prefix:
            return sorted(self.series)
        return sorted(n for n in self.series if n.startswith(prefix))

    def last(self, name: str) -> tuple | None:
        s = self.series.get(name)
        return s.last() if s is not None else None

    def _pick_tier(self, s: Series, start: float | None) -> str:
        """Finest tier whose retention still covers the requested
        start; an open-ended query reads raw."""
        if start is None or not s.raw:
            return "raw"
        if s.raw[0][0] <= start or len(s.raw) < s.raw.maxlen:
            # raw covers the window — or the ring has never wrapped,
            # in which case raw IS the complete history and a coarser
            # tier can only blur the same data
            return "raw"
        m1 = s.tier_points("1m")
        if m1 and m1[0][0] <= start:
            return "1m"
        return "1h"

    def query(self, name: str, start: float | None = None,
              end: float | None = None, tier: str = "auto",
              max_points: int = 0) -> dict:
        """One series, one tier, time-sliced.  Raw points render as
        ``[t, value]``; aggregate points as
        ``[t, sum, count, min, max]`` (JSON-friendly lists)."""
        s = self.series.get(name)
        if s is None:
            return {"series": name, "tier": "raw", "points": []}
        use = self._pick_tier(s, start) if tier == "auto" else tier
        pts = s.tier_points(use)
        if start is not None:
            if use == "raw":
                pts = [p for p in pts if p[0] >= start]
            else:
                # aggregate buckets are stamped with their START; keep
                # any bucket whose [b, b+width) span overlaps the
                # window, or a start landing mid-bucket silently loses
                # the open bucket (and with it the whole lead-up)
                width = s.tier1_s if use == "1m" else s.tier2_s
                pts = [p for p in pts if p[0] + width > start]
        if end is not None:
            pts = [p for p in pts if p[0] <= end]
        if max_points and len(pts) > max_points:
            pts = pts[-max_points:]
        return {"series": name, "tier": use,
                "points": [list(p) for p in pts]}

    def query_prefix(self, prefix: str, start: float | None = None,
                     end: float | None = None, tier: str = "auto",
                     max_points: int = 0) -> dict[str, dict]:
        return {n: self.query(n, start, end, tier, max_points)
                for n in self.names(prefix)}

    def stats(self) -> dict:
        return {
            "series": len(self.series),
            "points": sum(s.point_count()
                          for s in self.series.values()),
            "evictions": sum(s.evictions
                             for s in self.series.values()),
            "dropped_series": self.dropped_series,
        }
