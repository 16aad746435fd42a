"""SLO engine: declarative service-level objectives over the histogram layer.

Counterpart of ceph_tpu/common/slo.py: the same module over the
port's imports.

Targets are declared in conf (``slo_put_p99_ms = 50``) and evaluated
from the log2 latency histograms over a sliding window: the
counters are cumulative, so the window's distribution is the
elementwise difference of its edge snapshots (:func:`hist_delta`).
Three objective kinds:

- **latency** (``put_p99_ms`` / ``get_p999_ms`` / ``op_p50_ms`` ...):
  quantile of the windowed ``op_{w,r}_latency_us`` histogram, in ms.
  The error budget burns at ``frac_above(threshold) / (1 - q)`` — the
  multiwindow burn-rate alerting model of the SRE workbook: burn 1.0
  spends budget exactly at the allowed rate, burn > 1.0 means the
  quantile is over target.
- **error_rate**: windowed ``op_error / op`` ratio; burn =
  ``rate / target``.
- **rebuild_floor_gibs**: while recovery is active, the windowed
  ``ec_repair_rebuild_bytes`` rate must stay ABOVE the floor (a
  too-slow rebuild stretches the degraded window — arxiv 1906.08602's
  tail amplifier); burn = ``floor / rate``.

Violations pass through raise/clear hysteresis (``slo_raise_evals``
consecutive bad evaluations to raise, ``slo_clear_evals`` good ones to
clear) so one noisy window cannot flap cluster health, and surface as
an ``SLO_VIOLATION`` health warning naming the failing objective and
the worst daemon.  The mgr module (services/mgr_slo.py) feeds this
engine from per-OSD perf dumps and exports per-objective burn-rate
gauges to Prometheus.
"""

from __future__ import annotations

import re
from collections import deque
from dataclasses import dataclass

from ceph_tpu_torch.common.perf import (
    counter_scalar,
    hist_delta,
    hist_frac_above,
    hist_merge,
    hist_quantile,
)

_LATENCY_RE = re.compile(r"^(put|get|op)_p(\d+)_ms$")
_LATENCY_SOURCE = {
    "put": "op_w_latency_us",
    "get": "op_r_latency_us",
    "op": "op_latency_us",
}
# burn rates cap here: 0-traffic denominators would otherwise render
# inf into health messages and prometheus lines
BURN_CAP = 1000.0


@dataclass(frozen=True)
class SLOTarget:
    """One declared objective (parsed from conf)."""

    objective: str          # conf-facing name, e.g. "put_p99_ms"
    threshold: float        # ms / ratio / GiB/s depending on kind
    kind: str               # "latency" | "error_rate" | "rebuild_floor"
    quantile: float = 0.0   # latency only: 0.99 for p99, 0.999 for p999
    source: str = ""        # latency only: histogram counter name


def make_target(objective: str, threshold: float) -> SLOTarget:
    """Parse one ``name=value`` objective into a typed target."""
    m = _LATENCY_RE.match(objective)
    if m:
        digits = m.group(2)             # "99" -> 0.99, "999" -> 0.999
        q = int(digits) / (10 ** len(digits))
        if not 0.0 < q < 1.0:
            raise ValueError(f"bad quantile in SLO objective {objective}")
        return SLOTarget(objective, float(threshold), "latency", q,
                         _LATENCY_SOURCE[m.group(1)])
    if objective == "error_rate":
        return SLOTarget(objective, float(threshold), "error_rate")
    if objective == "rebuild_floor_gibs":
        return SLOTarget(objective, float(threshold), "rebuild_floor")
    raise ValueError(f"unknown SLO objective {objective!r}")


def parse_slo_targets(spec: str) -> list[SLOTarget]:
    """Parse a free-form target list: ``put_p99_ms=50,get_p999_ms=200``
    (comma or whitespace separated)."""
    out = []
    for part in re.split(r"[,\s]+", spec.strip()):
        if not part:
            continue
        name, _, val = part.partition("=")
        out.append(make_target(name.strip(), float(val)))
    return out


def targets_from_conf(conf) -> list[SLOTarget]:
    """Targets from the typed conf options plus the free-form
    ``slo_targets`` string (for objectives outside the canonical four,
    e.g. ``op_p50_ms=5``).  A 0 threshold disables an objective."""
    out = []
    for key, obj in (("slo_put_p99_ms", "put_p99_ms"),
                     ("slo_get_p999_ms", "get_p999_ms"),
                     ("slo_error_rate", "error_rate"),
                     ("slo_rebuild_floor_gibs", "rebuild_floor_gibs")):
        v = float(conf[key] or 0.0)
        if v > 0:
            out.append(make_target(obj, v))
    spec = str(conf["slo_targets"] or "")
    if spec:
        out.extend(parse_slo_targets(spec))
    return out


class SnapshotWindow:
    """Delta view between two cumulative per-daemon snapshots.

    The SLO verdict, the utilization telemetry, and the QoS controller
    all consume the same sliding window: counters are cumulative, so a
    window's distribution/total is the elementwise difference of its
    edge snapshots.  Factoring the delta math here means every consumer
    reads the identical distributions the verdict was computed from
    instead of re-deriving them from raw snapshots."""

    def __init__(self, old: dict[str, dict], new: dict[str, dict],
                 span: float):
        self.old = old
        self.new = new
        self.span = float(span)

    def hist(self, source: str) -> tuple[dict, dict[str, dict]]:
        """(cluster-merged window histogram, {daemon: window hist})."""
        per: dict[str, dict] = {}
        merged: dict = {}
        for daemon, dump in self.new.items():
            cur = dump.get(source)
            if not isinstance(cur, dict) or "buckets" not in cur:
                continue
            d = hist_delta(cur, self.old.get(daemon, {}).get(source))
            per[daemon] = d
            merged = hist_merge(merged, d)
        return merged or {"buckets": [], "sum": 0.0, "count": 0}, per

    def scalar(self, key: str) -> tuple[float, dict[str, float]]:
        """(cluster-total window delta, {daemon: delta}) of a counter."""
        per: dict[str, float] = {}
        for daemon, dump in self.new.items():
            if key not in dump:
                continue
            d = counter_scalar(dump.get(key, 0.0)) - counter_scalar(
                self.old.get(daemon, {}).get(key, 0.0))
            per[daemon] = max(0.0, d)
        return sum(per.values()), per

    def pair(self, key: str) -> tuple[float, float]:
        """Window delta of a LONGRUNAVG counter: (sum, count)."""
        ds = dc = 0.0
        for daemon, dump in self.new.items():
            cur = dump.get(key)
            if not isinstance(cur, dict):
                continue
            prev = self.old.get(daemon, {}).get(key, {})
            if not isinstance(prev, dict):
                prev = {}
            ds += float(cur.get("sum", 0.0)) - float(prev.get("sum", 0.0))
            dc += float(cur.get("avgcount", 0)) \
                - float(prev.get("avgcount", 0))
        return max(0.0, ds), max(0.0, dc)


_EMPTY_WINDOW = SnapshotWindow({}, {}, 0.0)


class SLOEngine:
    """Sliding-window evaluation of declared targets over per-daemon
    perf dumps, with raise/clear hysteresis and health rendering."""

    def __init__(self, targets: list[SLOTarget], window: float = 30.0,
                 raise_evals: int = 2, clear_evals: int = 2):
        self.targets = list(targets)
        self.window = float(window)
        self.raise_evals = max(1, int(raise_evals))
        self.clear_evals = max(1, int(clear_evals))
        # (t, {daemon -> perf dump}) — cumulative snapshots; the window
        # keeps one snapshot at/before the trailing edge as delta base
        self._snaps: deque[tuple[float, dict[str, dict]]] = deque()
        self._bad: dict[str, int] = {}
        self._good: dict[str, int] = {}
        self.active: dict[str, dict] = {}    # objective -> last bad eval
        self.last_eval: list[dict] = []

    # -- snapshot window ---------------------------------------------------
    def observe(self, t: float, per_daemon: dict[str, dict]) -> None:
        """Feed one cluster snapshot (daemon name -> perf dump)."""
        self._snaps.append((float(t), per_daemon))
        while len(self._snaps) > 2 and self._snaps[1][0] <= t - self.window:
            self._snaps.popleft()

    def window_span(self) -> float:
        if len(self._snaps) < 2:
            return 0.0
        return self._snaps[-1][0] - self._snaps[0][0]

    def snapshot_window(self) -> SnapshotWindow:
        """The current sliding window as a :class:`SnapshotWindow` —
        the one shared delta view the verdict, the utilization layer,
        and the QoS controller all read.  Empty (zero-span) window
        until two snapshots have been observed."""
        if len(self._snaps) < 2:
            return _EMPTY_WINDOW
        return SnapshotWindow(self._snaps[0][1], self._snaps[-1][1],
                              self.window_span())

    def _window_hist(self, source: str):
        """(cluster-merged window histogram, {daemon: window histogram})."""
        return self.snapshot_window().hist(source)

    def _window_scalar(self, key: str):
        """(cluster-total window delta, {daemon: delta}) of a counter."""
        return self.snapshot_window().scalar(key)

    # -- evaluation --------------------------------------------------------
    def _eval_latency(self, tgt: SLOTarget) -> dict:
        merged, per = self._window_hist(tgt.source)
        thr_us = tgt.threshold * 1000.0
        q_us = hist_quantile(merged, tgt.quantile)
        value = None if q_us is None else q_us / 1000.0
        allowed = max(1e-9, 1.0 - tgt.quantile)
        burn = min(BURN_CAP, hist_frac_above(merged, thr_us) / allowed)
        worst, worst_frac = None, -1.0
        for daemon, h in per.items():
            frac = hist_frac_above(h, thr_us)
            if frac > worst_frac and (h.get("count") or 0) > 0:
                worst, worst_frac = daemon, frac
        return {"value": value, "unit": "ms", "burn_rate": burn,
                "ok": value is None or burn <= 1.0, "worst_daemon": worst,
                "samples": int(merged.get("count", 0))}

    def _eval_error_rate(self, tgt: SLOTarget) -> dict:
        errs, per_e = self._window_scalar("op_error")
        ops, per_o = self._window_scalar("op")
        value = None if ops <= 0 else errs / ops
        burn = 0.0 if value is None else min(
            BURN_CAP, value / max(tgt.threshold, 1e-9))
        worst, worst_rate = None, -1.0
        for daemon, n in per_o.items():
            if n <= 0:
                continue
            rate = per_e.get(daemon, 0.0) / n
            if rate > worst_rate:
                worst, worst_rate = daemon, rate
        return {"value": value, "unit": "ratio", "burn_rate": burn,
                "ok": value is None or value <= tgt.threshold,
                "worst_daemon": worst, "samples": int(ops)}

    def _eval_rebuild_floor(self, tgt: SLOTarget,
                            recovery_active: bool) -> dict:
        span = self.window_span()
        delta, per = self._window_scalar("ec_repair_rebuild_bytes")
        rate = (delta / span / (1 << 30)) if span > 0 else 0.0
        if not recovery_active:
            # nothing to rebuild: the floor is idle, not violated
            return {"value": rate, "unit": "GiB/s", "burn_rate": 0.0,
                    "ok": True, "worst_daemon": None, "samples": 0,
                    "idle": True}
        burn = min(BURN_CAP, tgt.threshold / max(rate, 1e-9))
        worst = None
        if per:
            # the daemon rebuilding slowest is dragging the floor
            worst = min(per, key=lambda d: per[d])
        return {"value": rate, "unit": "GiB/s", "burn_rate": burn,
                "ok": rate >= tgt.threshold, "worst_daemon": worst,
                "samples": int(delta)}

    def evaluate(self, recovery_active: bool = False) -> list[dict]:
        """One evaluation pass over every declared target; drives the
        hysteresis state and returns per-objective records."""
        results = []
        for tgt in self.targets:
            if tgt.kind == "latency":
                rec = self._eval_latency(tgt)
            elif tgt.kind == "error_rate":
                rec = self._eval_error_rate(tgt)
            else:
                rec = self._eval_rebuild_floor(tgt, recovery_active)
            rec["objective"] = tgt.objective
            rec["target"] = tgt.threshold
            rec["window_s"] = round(self.window_span(), 3)
            if rec["ok"]:
                self._bad[tgt.objective] = 0
                self._good[tgt.objective] = \
                    self._good.get(tgt.objective, 0) + 1
                if (tgt.objective in self.active
                        and self._good[tgt.objective] >= self.clear_evals):
                    del self.active[tgt.objective]
            else:
                self._good[tgt.objective] = 0
                self._bad[tgt.objective] = \
                    self._bad.get(tgt.objective, 0) + 1
                if self._bad[tgt.objective] >= self.raise_evals:
                    self.active[tgt.objective] = rec
            rec["violating"] = tgt.objective in self.active
            results.append(rec)
        self.last_eval = results
        return results

    # -- health + gauges ---------------------------------------------------
    def health_checks(self) -> dict[str, dict]:
        """``SLO_VIOLATION`` health payload (mgr_stat passes any dict
        with a severity straight into cluster health)."""
        if not self.active:
            return {}
        worst_obj = max(self.active,
                        key=lambda o: self.active[o]["burn_rate"])
        w = self.active[worst_obj]
        detail = []
        for obj, rec in sorted(self.active.items()):
            val = rec["value"]
            val_s = "n/a" if val is None else f"{val:.4g}{rec['unit']}"
            detail.append(
                f"objective {obj}: {val_s} vs target "
                f"{rec['target']:g}{rec['unit']} "
                f"(burn {rec['burn_rate']:.2f}x, worst daemon "
                f"{rec['worst_daemon'] or 'n/a'})")
        # "message" is load-bearing: HealthMonitor's leader tick logs
        # v["message"] for every new check
        return {"SLO_VIOLATION": {
            "severity": "HEALTH_WARN",
            "message": (
                f"{len(self.active)} SLO objective(s) violated; worst "
                f"{worst_obj} burning {w['burn_rate']:.2f}x budget "
                f"({w['worst_daemon'] or 'n/a'})"),
            "detail": detail,
            "count": len(self.active),
        }}

    def gauges(self) -> dict[str, dict]:
        """Per-objective gauge values for the Prometheus exposition."""
        out = {}
        for rec in self.last_eval:
            out[rec["objective"]] = {
                "burn_rate": rec["burn_rate"],
                "ok": 0.0 if rec["violating"] else 1.0,
                "value": rec["value"] if rec["value"] is not None else 0.0,
            }
        return out


def class_burn(hist: dict, targets: list[SLOTarget]) -> float:
    """Instantaneous burn of one tenant class: its windowed class
    histogram judged against every declared LATENCY objective, worst
    one wins.  Classes share the cluster's latency targets — a class
    burns when ITS ops miss the same bar everyone is held to."""
    if not hist or not (hist.get("count") or 0):
        return 0.0
    burn = 0.0
    for tgt in targets:
        if tgt.kind != "latency":
            continue
        allowed = max(1e-9, 1.0 - tgt.quantile)
        burn = max(burn, hist_frac_above(hist, tgt.threshold * 1000.0)
                   / allowed)
    return min(BURN_CAP, burn)


class MultiWindowBurn:
    """Per-class multiwindow burn pairs — the SRE-workbook 5m/1h
    model.

    Each report cycle feeds one instantaneous burn sample per class;
    the pair is the time-average over a FAST window (default 5m:
    "it's still happening") and a SLOW window (default 1h: "it spent
    material budget").  A class violates only while BOTH exceed 1.0 —
    a brief spike can't page (slow window dilutes it) and a long-ago
    incident can't page (fast window has recovered).  Raise/clear
    hysteresis on top, same discipline as :class:`SLOEngine`.

    Pure and timer-free: time comes from the caller, so the
    known-answer hysteresis tests drive synthetic clocks and the
    seed-7 storm replay gets the same edge sequence every run."""

    def __init__(self, fast_s: float = 300.0, slow_s: float = 3600.0,
                 raise_evals: int = 2, clear_evals: int = 2):
        self.fast_s = float(fast_s)
        self.slow_s = max(float(slow_s), self.fast_s)
        self.raise_evals = max(1, int(raise_evals))
        self.clear_evals = max(1, int(clear_evals))
        self._samples: dict[str, deque[tuple[float, float]]] = {}
        self._bad: dict[str, int] = {}
        self._good: dict[str, int] = {}
        self.active: dict[str, dict] = {}   # class -> last bad record
        self.last_eval: dict[str, dict] = {}

    def observe(self, t: float, clazz: str, burn: float) -> None:
        dq = self._samples.setdefault(str(clazz), deque())
        dq.append((float(t), float(burn)))
        horizon = float(t) - self.slow_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

    @staticmethod
    def _window_avg(dq: deque, t: float, span: float) -> float:
        vals = [b for ts, b in dq if ts >= t - span]
        return sum(vals) / len(vals) if vals else 0.0

    def evaluate(self, t: float) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for clazz, dq in sorted(self._samples.items()):
            fast = self._window_avg(dq, t, self.fast_s)
            slow = self._window_avg(dq, t, self.slow_s)
            burning = fast > 1.0 and slow > 1.0
            if burning:
                self._good[clazz] = 0
                self._bad[clazz] = self._bad.get(clazz, 0) + 1
                if self._bad[clazz] >= self.raise_evals:
                    self.active[clazz] = {
                        "fast_burn": fast, "slow_burn": slow}
            else:
                self._bad[clazz] = 0
                self._good[clazz] = self._good.get(clazz, 0) + 1
                if (clazz in self.active
                        and self._good[clazz] >= self.clear_evals):
                    del self.active[clazz]
            out[clazz] = {
                "class": clazz,
                "fast_burn": round(fast, 4),
                "slow_burn": round(slow, 4),
                "fast_window_s": self.fast_s,
                "slow_window_s": self.slow_s,
                "burning": burning,
                "violating": clazz in self.active,
            }
        self.last_eval = out
        return out

    def worst(self) -> str | None:
        """The violating class burning fastest (None while clear)."""
        if not self.active:
            return None
        return max(self.active,
                   key=lambda c: self.active[c]["fast_burn"])
