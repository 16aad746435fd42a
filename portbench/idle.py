"""Why the card sat idle: the device's idle time in a traced run's window,
split by what the host's event loop ran meanwhile.

    python3 -m portbench.idle --workload <cell> --seed <n> --seconds <s>

Runs the cell traced (``run.run_cell(..., trace=True)``, as ``--trace 1``
does), prints its result line, then one line of JSON:

- ``fit``: the profiler's clock placed on the span clock
  (``perf_counter_ns``).  The offset is the one that puts the most
  profiled B1 kernels (``gf2_words_kernel``) inside the device interval
  of an ``osd:ec:launch`` span (``dev_t_ns``, ``dev_ms``: CUDA events
  around the launch).  ``placed`` is their share; a kernel's residual is
  its distance outside the nearest such interval (0 inside); ``slack``
  is how far the offset may move with every placed kernel staying in;
  ``launch_before_host`` counts launch spans whose device interval starts
  before their host start (``t_ns``); ``device_launches`` is the
  daemons' count of every EC launch in the window, spanned or not.
- ``idle``: the card's idle time inside the window, split by the loop
  monitor's 10 ms buckets: each bucket's busy time by label (a span name
  or ``unspanned:<callback>``) in proportion, the rest ``loop idle``.
- ``loop``: the loop's busy time in the window by label, its unspanned
  share, and whether the monitor's ring kept the whole window.
- ``launch``: the mean coalesced EC launch: its host time, the worker
  thread's CPU in it and its device time.

The launches' device intervals are placed on the span clock by an
anchor the program takes anew every second, so one offset fits the
whole window.

Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys

from portbench import run as bench
from portbench.looptrace import monitor, window_buckets, window_labels
from portbench.stats import percentile

KERNEL = "gf2_words_kernel"
SEARCH_NS = 1_000_000_000    # the fit looks this far around the guess
TOP = 15


def launches(run) -> list[tuple[int, int, int]]:
    """(dev_start_ns, dev_end_ns, host_start_ns) of each launch, once."""
    out = {}
    for s in run.spans:
        if s["name"] == "osd:ec:launch" and "dev_t_ns" in s:
            a = s["dev_t_ns"]
            out[(s["entity"], s["t_ns"])] = (a, a + round(s["dev_ms"] * 1e6),
                                             s["t_ns"])
    return sorted(out.values())


def device_ns(run) -> list[tuple[str, int, int]]:
    """The profiled device events, in ns from the profile's start."""
    return [(n, round(a * 1e9), round(b * 1e9))
            for n, a, b in run.devtrace.events]


def fit_offset(kernels, spans, guess: int, search: int = SEARCH_NS
               ) -> dict:
    """The offset (ns, added to a profiled time) that places the most
    kernels inside a launch's device interval."""
    marks = []
    starts = [a for a, _, _ in spans]
    for ks, ke in kernels:
        lo = bisect.bisect_left(starts, ks + guess - search - 10**9)
        for a, b, _ in spans[lo:]:
            if a > ke + guess + search:
                break
            o0, o1 = a - ks, b - ke
            if o1 >= o0 and abs((o0 + o1) / 2 - guess) <= search:
                marks += [(o0, 1), (o1 + 1, -1)]
    if not marks:
        return {"offset_ns": guess, "slack_ns": None}
    marks.sort()
    best = cur = 0
    lo = hi = guess
    for i, (o, d) in enumerate(marks):
        cur += d
        end = marks[i + 1][0] - 1 if i + 1 < len(marks) else o
        # the most kernels placed; of equals, the nearest to the guess
        if cur > best or (cur == best and abs((o + end) / 2 - guess)
                          < abs((lo + hi) / 2 - guess)):
            best, lo, hi = cur, o, end
    return {"offset_ns": (lo + hi) // 2, "slack_ns": (hi - lo) // 2}


def nearest(kernel, spans, starts, offset: int):
    """(distance outside, launch) of the launch interval nearest to a
    placed kernel."""
    a0, a1 = kernel[0] + offset, kernel[1] + offset
    i = bisect.bisect_right(starts, a0)
    best = (10**12, None)
    for sp in spans[max(0, i - 2):i + 2]:
        d = max(0, sp[0] - a0) + max(0, a1 - sp[1])
        if d < best[0]:
            best = (d, sp)
    return best


def residuals(kernels, spans, offset: int) -> list[int]:
    """Each kernel's distance outside the nearest launch interval."""
    starts = [a for a, _, _ in spans]
    return [nearest(k, spans, starts, offset)[0] for k in kernels]


def unplaced(kernels, spans, offset: int, lo: int) -> list[list[float]]:
    """Up to 20 kernels outside every launch interval: their time in the
    window (s), and how far the nearest launch's device interval starts
    before and ends after them (us; negative: the kernel sticks out)."""
    starts = [a for a, _, _ in spans]
    out = []
    for k in kernels:
        d, sp = nearest(k, spans, starts, offset)
        if d and sp is not None and len(out) < 20:
            a0, a1 = k[0] + offset, k[1] + offset
            out.append([(a0 - lo) / 1e9, (a0 - sp[0]) / 1e3,
                        (sp[1] - a1) / 1e3])
    return out


def busy_union(intervals) -> list[tuple[int, int]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_intervals(busy, lo: int, hi: int) -> list[tuple[int, int]]:
    out, t = [], lo
    for a, b in busy:
        if b <= lo or a >= hi:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def split_idle(idle, mon, lo: int, hi: int) -> dict[str, float]:
    """Idle ns by what the loop did in each bucket (uniform inside it)."""
    width = mon.bucket_ns
    buckets = {b[0]: b for b in mon.buckets if lo - width < b[0] < hi}
    out: dict[str, float] = {}
    for a, b in idle:
        t = a - a % width
        while t < b:
            o = min(b, t + width) - max(a, t)
            bk = buckets.get(t)
            busy = 0
            if bk is not None:
                for label, ns in bk[3].items():
                    out[label] = out.get(label, 0.0) + o * ns / width
                busy = bk[1]
            out["loop idle"] = out.get("loop idle", 0.0) + \
                o * max(0.0, 1.0 - busy / width)
            t += width
    return out


def analyse(run) -> dict:
    lo, hi = int(run.t_open * 1e9), int(run.t_close * 1e9)
    mon = monitor()
    out: dict = {}
    window = window_buckets(run)
    if window is not None:
        by = window_labels(run)
        busy = sum(by.values())
        ops = len(run.done_ops())
        out["loop"] = {
            "busy_s": busy / 1e9,
            "steps_per_op": sum(b[2] * share for b, share in window) / ops
            if ops else None,
            "unspanned_share": sum(v for k, v in by.items()
                                   if k.startswith("unspanned:")) / busy
            if busy else None,
            "by_label": [[k, v / 1e9, v / busy] for k, v in sorted(
                by.items(), key=lambda kv: -kv[1])[:TOP]],
        }
    if mon is not None:
        out["monitor"] = {"evictions": mon.evictions,
                          "buckets": len(mon.buckets),
                          "kept_window": window is not None}
    once = {(s["entity"], s["t_ns"]): s for s in run.spans
            if s["name"] == "osd:ec:launch" and "t_ns" in s}
    if once:
        n = len(once)
        out["launch"] = {
            "launches": n,
            "host_ms": sum(s["duration_ms"] for s in once.values()) / n,
            "thread_ms": sum(s.get("thread_ms", 0.0)
                             for s in once.values()) / n,
            "dev_ms": sum(s.get("dev_ms", 0.0) for s in once.values()) / n,
        }
    if run.devtrace is None:
        return out
    spans = launches(run)
    events = device_ns(run)
    kernels = sorted((a, b) for n, a, b in events if KERNEL in n)
    guess = int(run.devtrace._t0 * 1e9)
    fit = fit_offset(kernels, spans, guess)
    off = fit["offset_ns"]
    res = residuals(kernels, spans, off) if spans else []
    out["fit"] = {
        "kernels": len(kernels), "launches": len(spans),
        # every launch the daemons counted in the window, spanned or not
        "device_launches": run.counters.get("ec_device_launches"),
        "offset_from_guess_us": (off - guess) / 1e3,
        "slack_us": None if fit["slack_ns"] is None
        else fit["slack_ns"] / 1e3,
        "placed": (sum(1 for r in res if r == 0) / len(res)) if res else None,
        "residual_median_us": percentile(res, 50) / 1e3 if res else None,
        "residual_p99_us": percentile(res, 99) / 1e3 if res else None,
        "launch_before_host": sum(1 for a, _, h in spans if a < h),
        "unplaced": unplaced(kernels, spans, off, lo),
    }
    # the card's busy time on the span clock
    busy = busy_union((a + off, b + off) for _, a, b in events)
    idle = idle_intervals(busy, lo, hi)
    idle_ns = sum(b - a for a, b in idle)
    table = split_idle(idle, mon, lo, hi) if mon is not None else {}
    out["idle"] = {
        "idle_s": idle_ns / 1e9, "window_s": (hi - lo) / 1e9,
        "by_label": [[k, v / 1e9, v / idle_ns if idle_ns else None]
                     for k, v in sorted(table.items(),
                                        key=lambda kv: -kv[1])[:TOP]],
    }
    return out


def main(argv=None) -> int:
    bench.cache_env()
    ap = argparse.ArgumentParser(prog="python -m portbench.idle")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.idle: needs a CUDA device", file=sys.stderr)
        return 2
    spec = bench.load_cell(args.workload)
    result, run = bench.run_cell(spec, args.seed, args.seconds, True)
    print(json.dumps(result), flush=True)
    # the end-to-end metrics of the traced run, beside the untraced
    # runs', for the cost of the trace
    traced = {m["name"]: bench.reader(m["name"])(run)
              for m in spec["end_to_end"]}
    print(json.dumps({"idle_analysis": analyse(run),
                      "traced_end_to_end": traced}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
