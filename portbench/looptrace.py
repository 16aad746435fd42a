"""What the port's loop monitor saw in a run's window
(``ceph_tpu_torch.common.tracing``, on in a traced run: every entity
samples ops).  A program without one reads as nothing: the readers of
the metrics built on it return None."""

from __future__ import annotations


def monitor():
    """The run's loop monitor, or None where the program has none."""
    try:
        from ceph_tpu_torch.common import tracing
    except ImportError:
        return None
    get = getattr(tracing, "loop_monitor", None)
    return get() if get is not None else None


def window_buckets(run):
    """(bucket, share of it inside the window) for every bucket of the
    loop monitor that overlaps [t_open, t_close]; None where there is no
    monitor, or where the ring has dropped buckets of the window."""
    mon = monitor()
    if mon is None or run.t_open is None or not mon.buckets:
        return None
    width = getattr(mon, "bucket_ns", None) or 10_000_000
    lo, hi = int(run.t_open * 1e9), int(run.t_close * 1e9)
    if mon.evictions and mon.buckets[0][0] > lo - width:
        return None
    out = []
    for b in mon.buckets:
        a, z = max(b[0], lo), min(b[0] + width, hi)
        if z > a:
            out.append((b, (z - a) / width))
    return out


def window_labels(run) -> dict | None:
    """The loop's busy ns in the window by label (span name, ``gc`` or
    ``unspanned:<callback>``), the edge buckets in proportion; None as
    for ``window_buckets``."""
    window = window_buckets(run)
    if window is None:
        return None
    by: dict[str, float] = {}
    for b, share in window:
        for label, ns in b[3].items():
            by[label] = by.get(label, 0.0) + ns * share
    return by


def spans_with(run, key: str, names=None, prefix=None) -> list[dict]:
    """The window's spans that carry ``key``, by name or name prefix."""
    return [s for s in run.spans if key in s
            and (names is None or s["name"] in names)
            and (prefix is None or s["name"].startswith(prefix))]
