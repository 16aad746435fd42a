"""TSDB mgr module: the retention layer of the observability stack.

Counterpart of ceph_tpu/services/mgr_tsdb.py: the same module over the
port's imports.

``TSDBMonitor`` runs LAST in the module dispatch order, so each report
cycle it records what the cycle actually CONCLUDED — the SLO verdicts
the engine just rendered, the tenant-class burn pairs, the utilization
rates, the QoS defense-plane position, the delta-collect payload
accounting, the tracer health counters, and the per-signature device
kernel profile — into the bounded :class:`ceph_tpu.common.tsdb.TSDB`
ring store.  Everything downstream reads from here:

- ``Mgr.ts_query`` / the dashboard ``/api/ts`` endpoint / the ``ts
  query`` admin-socket command serve time-sliced series,
- the digest gains a bounded ``tsdb`` section (catalog stats, raw
  tails, kernel table, tracer rates) that rides mgr report to the mon
  so ``ceph-tpu top`` can render it from anywhere in the cluster,
- forensic bundles attach the last ten minutes of every relevant
  series (``forensics_contrib``), so a bundle shows the LEAD-UP to a
  violation, not just the moment of capture.

The module issues no collects of its own: it harvests the snapshot the
SLO module (which runs earlier the same cycle) already pulled.
"""

from __future__ import annotations

import time

from ceph_tpu_torch.common.perf import hist_quantile
from ceph_tpu_torch.services.mgr_modules import MgrModule

# series namespaces a forensic bundle attaches (the burn-rate /
# rebuild / class-histogram lead-up a post-mortem reads)
FORENSIC_PREFIXES = ("slo.", "class.", "util.", "qos.", "tracer.",
                     "collect.", "kernel.")
FORENSIC_WINDOW_S = 600.0


def _add_device_us(agg: dict, rec: dict) -> None:
    """Sum a signature's device time where the OSDs report one."""
    dev = float(rec.get("device_us", 0.0) or 0.0)
    if dev:
        agg["device_us"] = agg.get("device_us", 0.0) + dev


def _kernel_seconds(agg: dict, wall_s: float) -> float:
    """A signature's launch seconds: the card's time where it was
    measured (``time_base`` "device"), else the host's."""
    if agg.get("device_us"):
        agg["time_base"] = "device"
        return agg["device_us"] / 1e6
    return wall_s


class TSDBMonitor(MgrModule):
    name = "ts"

    def __init__(self, mgr):
        super().__init__(mgr)
        self.tsdb = None
        # tracer eviction RATE between our own cycles: the counter is
        # cumulative, the warning condition is "still evicting NOW"
        self._prev_evictions = 0.0
        self._prev_evict_t = 0.0
        self.last_tracer: dict = {}
        self.last_kernels: dict[str, dict] = {}

    def _ensure(self):
        # lazy like the SLO engine: conf overrides installed after
        # construction are honored
        if self.tsdb is None:
            from ceph_tpu_torch.common.tsdb import TSDB

            self.tsdb = TSDB.from_conf(self.mgr.conf)
        return self.tsdb

    async def serve_once(self) -> None:
        db = self._ensure()
        now = time.time()
        feed: dict[str, float] = {}
        slo = self.mgr.modules.get("slo")
        if slo is not None:
            for rec in getattr(slo, "last_eval", None) or ():
                obj = rec.get("objective")
                feed[f"slo.{obj}.burn"] = rec.get("burn_rate", 0.0)
                if rec.get("value") is not None:
                    feed[f"slo.{obj}.value"] = rec["value"]
            for cls, rec in (getattr(slo, "class_eval", None)
                             or {}).items():
                feed[f"slo.class.{cls}.fast_burn"] = \
                    rec.get("fast_burn", 0.0)
                feed[f"slo.class.{cls}.slow_burn"] = \
                    rec.get("slow_burn", 0.0)
            for cls, h in (getattr(slo, "class_hists", None)
                           or {}).items():
                feed[f"class.{cls}.ops"] = h.get("count") or 0
                q = hist_quantile(h, 0.99)
                if q is not None:
                    feed[f"class.{cls}.p99_ms"] = q / 1000.0
            for key, val in (getattr(slo, "util", None) or {}).items():
                if isinstance(val, (int, float)):
                    feed[f"util.{key}"] = val
        qos = self.mgr.modules.get("qos")
        tick = getattr(qos, "last_tick", None) or {}
        if tick:
            feed["qos.burn"] = tick.get("burn", 0.0)
            feed["qos.burning"] = 1.0 if tick.get("burning") else 0.0
        cs = self.mgr.collect_stats
        feed["collect.payload_bytes"] = cs.get("last_payload_bytes", 0)
        feed["collect.resyncs"] = cs.get("resyncs", 0)
        self._harvest_daemons(feed, slo, now)
        db.observe_many(now, feed)

    def _harvest_daemons(self, feed: dict, slo, now: float) -> None:
        """Tracer health + device-kernel profile, summed across the
        per-daemon dumps the SLO module collected this cycle."""
        snap = getattr(slo, "last_snap", None) or {}
        evictions = orphans = 0.0
        kernels: dict[str, dict] = {}
        for dump in snap.values():
            evictions += float(dump.get("tracer_ring_evictions", 0)
                               or 0)
            orphans += float(dump.get("tracer_orphan_spans", 0) or 0)
            for sig, rec in (dump.get("ec_kernels") or {}).items():
                agg = kernels.setdefault(sig, {
                    "launches": 0, "stripes": 0, "wall_us": 0.0,
                    "hbm_bytes": 0})
                agg["launches"] += int(rec.get("launches", 0))
                agg["stripes"] += int(rec.get("stripes", 0))
                agg["wall_us"] += float(rec.get("wall_us", 0.0))
                agg["hbm_bytes"] += int(rec.get("hbm_bytes", 0))
                _add_device_us(agg, rec)
        feed["tracer.ring_evictions"] = evictions
        feed["tracer.orphan_spans"] = orphans
        rate = 0.0
        if self._prev_evict_t:
            dt = max(1e-9, now - self._prev_evict_t)
            rate = max(0.0, evictions - self._prev_evictions) / dt
        feed["tracer.eviction_rate"] = rate
        self._prev_evictions = evictions
        self._prev_evict_t = now
        self.last_tracer = {
            "ring_evictions": int(evictions),
            "orphan_spans": int(orphans),
            "eviction_rate": round(rate, 4),
        }
        peak = float(self.mgr.conf["ec_hbm_peak_gibps"] or 0.0)
        for sig, agg in kernels.items():
            wall_s = agg["wall_us"] / 1e6
            wall_s = _kernel_seconds(agg, wall_s)
            agg["gibps"] = round(
                agg["hbm_bytes"] / (1 << 30) / wall_s, 3) \
                if wall_s > 0 else 0.0
            agg["roofline_pct"] = round(
                100.0 * agg["gibps"] / peak, 3) if peak > 0 else 0.0
            feed[f"kernel.{sig}.wall_us"] = agg["wall_us"]
            feed[f"kernel.{sig}.launches"] = agg["launches"]
            feed[f"kernel.{sig}.hbm_bytes"] = agg["hbm_bytes"]
            feed[f"kernel.{sig}.gibps"] = agg["gibps"]
        self.last_kernels = kernels

    # -- query surfaces ----------------------------------------------------
    def query(self, name: str = "", start: float | None = None,
              end: float | None = None, tier: str = "auto",
              prefix: str = "", max_points: int = 0) -> dict:
        """The one query entry point every surface delegates to
        (``Mgr.ts_query``, ``/api/ts``, the ``ts query`` asok)."""
        db = self._ensure()
        if prefix and not name:
            return {"stats": db.stats(),
                    "series": db.query_prefix(
                        prefix, start, end, tier,
                        int(max_points or 0))}
        if not name:
            return {"stats": db.stats(), "names": db.names()}
        return db.query(name, start, end, tier, int(max_points or 0))

    # -- mgr surfaces ------------------------------------------------------
    def digest_contrib(self) -> dict:
        db = self._ensure()
        cap = int(self.mgr.conf["tsdb_digest_points"])
        tails = {n: db.query(n, tier="raw",
                             max_points=cap)["points"]
                 for n in db.names()}
        return {"tsdb": {
            "stats": db.stats(),
            "tracer": dict(self.last_tracer),
            "kernels": {sig: dict(a)
                        for sig, a in self.last_kernels.items()},
            "collect": dict(self.mgr.collect_stats),
            "tails": tails,
        }}

    def forensics_contrib(self) -> dict:
        """The last ten minutes of every relevant series: the bundle
        must show the lead-up, not just the moment of capture."""
        db = self._ensure()
        start = time.time() - FORENSIC_WINDOW_S
        series: dict[str, dict] = {}
        for prefix in FORENSIC_PREFIXES:
            series.update(db.query_prefix(prefix, start=start))
        return {"window_s": FORENSIC_WINDOW_S,
                "stats": db.stats(), "series": series}

    def prom_metrics(self) -> dict[str, dict]:
        db = self._ensure()
        st = db.stats()
        return {
            "ceph_tsdb_series": {
                "help": "series retained by the mgr tsdb",
                "samples": [("", float(st["series"]))]},
            "ceph_tsdb_points": {
                "help": "points retained across all tsdb tiers",
                "samples": [("", float(st["points"]))]},
            "ceph_tsdb_evictions": {
                "help": "ring evictions across all tsdb series",
                "samples": [("", float(st["evictions"]))]},
            "ceph_tracer_eviction_rate": {
                "help": "cluster tracer span-ring evictions per "
                        "second (nonzero = traces being lost NOW)",
                "samples": [("", float(
                    self.last_tracer.get("eviction_rate", 0.0)))]},
        }
