"""SLO + utilization mgr module: the serving-observability brain.

Counterpart of ceph_tpu/services/mgr_slo.py: the same module over the
port's imports.

``SLOMonitor`` drives :class:`ceph_tpu.common.slo.SLOEngine` from the
per-OSD perf dumps the mgr already polls: each report cycle feeds one
cumulative snapshot into the engine's sliding window, evaluates every
conf-declared objective, and

- raises ``SLO_VIOLATION`` cluster health (mgr_stat passes the payload
  straight to the mon's health map) naming the failing objective and
  the worst daemon,
- contributes ``slo`` + ``utilization`` digest sections the dashboard
  panels and ``/api/slo`` serve,
- exports per-objective error-budget burn-rate gauges plus the
  utilization rate gauges to the Prometheus scrape (``prom_metrics``
  hook rendered by ``Mgr.prometheus_text``).

The utilization layer turns the raw EC counters into rates over
the same window: achieved device GiB/s vs the HBM roofline
(``ec_launch_bytes`` over encode+decode launch-us), coalescer
occupancy (ops per launch) and window-wait quantiles, resident-cache
hit rate, and the rebuild-GiB/s vs client-p99 interference pair —
the panel arxiv 1906.08602 says decides EC tail latency.
"""

from __future__ import annotations

import time

from ceph_tpu_torch.common.perf import hist_quantile
from ceph_tpu_torch.common.slo import (
    MultiWindowBurn,
    SLOEngine,
    class_burn,
    targets_from_conf,
)
from ceph_tpu_torch.services.mgr_modules import MgrModule


class SLOMonitor(MgrModule):
    name = "slo"

    def __init__(self, mgr):
        super().__init__(mgr)
        self.engine: SLOEngine | None = None
        self.last_eval: list[dict] = []
        self.util: dict = {}
        # per-tenant-class multiwindow burn pairs (5m/1h): built
        # lazily from conf like the engine; class_eval holds the last
        # evaluate() output for the digest/tsdb/health surfaces
        self.class_burns: MultiWindowBurn | None = None
        self._class_labels: tuple[str, ...] = ()
        self.class_eval: dict[str, dict] = {}
        self.class_hists: dict[str, dict] = {}  # cls -> window hist
        # the last per-daemon snapshot collect() produced — the tsdb
        # retention module (which runs after us) harvests counters
        # from it instead of issuing a second collect
        self.last_snap: dict[str, dict] = {}
        # forensic auto-capture transition tracking: a capture fires
        # on the RAISE edge of SLO_VIOLATION (engine or tenant class)
        # and SLOW_OPS (mon health), never while the condition merely
        # persists
        self._prev_active: set[str] = set()
        self._prev_class_active: set[str] = set()
        self._slow_ops_raised = False

    def _ensure_engine(self) -> SLOEngine:
        # built lazily so conf overrides installed after construction
        # (vstart passes them per-entity) are honored; an empty target
        # list still windows the counters for the utilization layer
        if self.engine is None:
            conf = self.mgr.conf
            self.engine = SLOEngine(
                targets_from_conf(conf),
                window=float(conf["slo_window"]),
                raise_evals=int(conf["slo_raise_evals"]),
                clear_evals=int(conf["slo_clear_evals"]),
            )
        return self.engine

    def _ensure_classes(self) -> MultiWindowBurn:
        if self.class_burns is None:
            conf = self.mgr.conf
            self._class_labels = tuple(
                s.strip()
                for s in str(conf["slo_class_labels"] or "").split(",")
                if s.strip())
            self.class_burns = MultiWindowBurn(
                fast_s=float(conf["slo_burn_fast_s"]),
                slow_s=float(conf["slo_burn_slow_s"]),
                raise_evals=int(conf["slo_raise_evals"]),
                clear_evals=int(conf["slo_clear_evals"]),
            )
        return self.class_burns

    async def serve_once(self) -> None:
        eng = self._ensure_engine()
        snap = await self.mgr.collect()
        per_daemon = {f"osd.{o}": counters
                      for o, counters in snap["osd_perf"].items()}
        self.last_snap = per_daemon
        now = time.monotonic()
        eng.observe(now, per_daemon)
        # recovery state from the previous cycle's digest (this cycle's
        # is being built around us) — one report_interval of lag on the
        # rebuild-floor objective, never on the latency objectives
        digest = self.mgr.last_digest or {}
        recovery = int(digest.get("degraded_objects", 0)) > 0
        self.last_eval = eng.evaluate(recovery_active=recovery)
        # per-class attribution: each class's windowed histogram judged
        # against the SAME latency objectives everyone is held to, fed
        # into the 5m/1h multiwindow pair
        cb = self._ensure_classes()
        if self._class_labels:
            win = eng.snapshot_window()
            for cls in self._class_labels:
                merged, _ = win.hist(f"op_class_{cls}_latency_us")
                self.class_hists[cls] = merged
                cb.observe(now, cls, class_burn(merged, eng.targets))
            self.class_eval = cb.evaluate(now)
        self.util = self._utilization(eng)
        await self._forensic_triggers(eng, snap)

    async def _forensic_triggers(self, eng: SLOEngine,
                                 snap: dict) -> None:
        """Flight-recorder integration: journal SLO eval transitions
        and fan an automatic forensic capture on raise edges."""
        jr = self.mgr.journal
        active = set(eng.active)
        for obj in sorted(active - self._prev_active):
            rec = eng.active[obj]
            jr.emit("slo.raise", objective=obj,
                    burn_rate=round(float(rec.get("burn_rate", 0.0)),
                                    3),
                    worst_daemon=rec.get("worst_daemon") or "")
        for obj in sorted(self._prev_active - active):
            jr.emit("slo.clear", objective=obj)
        slo_raised = bool(active - self._prev_active)
        self._prev_active = active
        # tenant-class raise/clear edges mirror the objective edges:
        # journaled for the flight recorder, capture-triggering below
        cb = self.class_burns
        class_active = set(cb.active) if cb is not None else set()
        for cls in sorted(class_active - self._prev_class_active):
            rec = cb.active[cls]
            jr.emit("slo.class_raise", tenant_class=cls,
                    fast_burn=round(float(rec["fast_burn"]), 3),
                    slow_burn=round(float(rec["slow_burn"]), 3))
        for cls in sorted(self._prev_class_active - class_active):
            jr.emit("slo.class_clear", tenant_class=cls)
        class_raised = bool(class_active - self._prev_class_active)
        self._prev_class_active = class_active
        # SLOW_OPS comes from the mon's health map (OSD beacons), so
        # read it off the status snapshot collect() already fetched
        checks = ((snap.get("status") or {}).get("health") or {}) \
            .get("checks", {})
        slow = checks.get("SLOW_OPS")
        slow_raised = slow is not None and not self._slow_ops_raised
        self._slow_ops_raised = slow is not None
        if not (slo_raised or slow_raised or class_raised):
            return
        if slo_raised or class_raised:
            payload = self.health_checks().get("SLO_VIOLATION", {})
            worst = ""
            worst_obj = ""
            if eng.active:
                worst_obj = max(
                    eng.active,
                    key=lambda o: eng.active[o]["burn_rate"])
                worst = eng.active[worst_obj].get("worst_daemon") or ""
            await self.mgr.maybe_auto_capture(
                "SLO_VIOLATION", worst_daemon=worst,
                detail={"message": payload.get("message", ""),
                        "detail": payload.get("detail", []),
                        "objective": worst_obj,
                        "tenant_class":
                            (cb.worst() if cb is not None else None)
                            or ""})
        else:
            await self.mgr.maybe_auto_capture(
                "SLOW_OPS",
                detail={"message": (slow or {}).get("message", "")})

    # -- utilization telemetry (rates from the EC counters) ---------------
    def _win_pair(self, eng: SLOEngine, key: str) -> tuple[float, float]:
        """Window delta of a LONGRUNAVG counter: (sum, count)."""
        return eng.snapshot_window().pair(key)

    def _utilization(self, eng: SLOEngine) -> dict:
        gib = float(1 << 30)
        win = eng.snapshot_window()
        span = win.span
        peak = float(self.mgr.conf["ec_hbm_peak_gibps"] or 1.0)

        launch_bytes, _ = win.scalar("ec_launch_bytes")
        enc_h, _ = win.hist("ec_encode_launch_us")
        dec_h, _ = win.hist("ec_decode_launch_us")
        launch_s = (enc_h.get("sum", 0.0) + dec_h.get("sum", 0.0)) / 1e6
        device_gibps = (launch_bytes / gib / launch_s) if launch_s > 0 \
            else 0.0

        occ_sum, occ_n = win.pair("ec_coalesce_occupancy")
        wait_h, _ = win.hist("ec_coalesce_wait_hist_us")
        hits, _ = win.scalar("ec_resident_hits")
        misses, _ = win.scalar("ec_resident_misses")
        lookups = hits + misses
        rebuild_bytes, _ = win.scalar("ec_repair_rebuild_bytes")
        cli_h, _ = win.hist("op_latency_us")

        def q_ms(h, q):
            v = hist_quantile(h, q)
            return 0.0 if v is None else round(v / 1000.0, 4)

        return {
            "window_s": round(span, 3),
            # device roofline: achieved GiB/s through EC launches vs
            # the conf'd HBM peak — the % of hardware we actually use
            "device_gibps": round(device_gibps, 3),
            "roofline_pct": round(100.0 * device_gibps / peak, 3),
            "launch_bytes": int(launch_bytes),
            "launch_seconds": round(launch_s, 6),
            # coalescer: how full each shared launch ran, and what the
            # micro-window cost waiters
            "coalesce_occupancy": round(occ_sum / occ_n, 3)
            if occ_n > 0 else 0.0,
            "coalesce_launches": int(occ_n),
            "coalesce_wait_p50_us": round(hist_quantile(wait_h, 0.5)
                                          or 0.0, 1),
            "coalesce_wait_p99_us": round(hist_quantile(wait_h, 0.99)
                                          or 0.0, 1),
            # resident cache
            "resident_hit_rate": round(hits / lookups, 4)
            if lookups > 0 else 0.0,
            # interference panel: rebuild throughput against the
            # client tail it competes with, over the SAME window
            "rebuild_gibps": round(rebuild_bytes / gib / span, 4)
            if span > 0 else 0.0,
            "client_p50_ms": q_ms(cli_h, 0.5),
            "client_p99_ms": q_ms(cli_h, 0.99),
            "client_p999_ms": q_ms(cli_h, 0.999),
        }

    # -- mgr surfaces ------------------------------------------------------
    def health_checks(self) -> dict[str, dict]:
        """``SLO_VIOLATION`` naming the burning tenant class alongside
        the worst daemon.  Three shapes: objective-only (engine
        violations, no class burning), merged (class detail appended to
        the engine's payload), and class-only (a standalone raise when
        a class pair violates while every cluster objective is ok —
        e.g. a small gold tenant drowning inside a healthy average)."""
        base = self.engine.health_checks() if self.engine else {}
        cb = self.class_burns
        if cb is None or not cb.active:
            return base
        worst_cls = cb.worst() or ""
        wrec = cb.active.get(worst_cls, {})
        cls_msg = (f"tenant class {worst_cls} burning "
                   f"{float(wrec.get('fast_burn', 0.0)):.2f}x (5m) / "
                   f"{float(wrec.get('slow_burn', 0.0)):.2f}x (1h)")
        cls_detail = []
        for cls, rec in sorted(cb.active.items()):
            cls_detail.append(
                f"tenant class {cls}: fast burn "
                f"{float(rec.get('fast_burn', 0.0)):.2f}x / slow burn "
                f"{float(rec.get('slow_burn', 0.0)):.2f}x")
        slo = base.get("SLO_VIOLATION")
        if slo is None:
            return {**base, "SLO_VIOLATION": {
                "severity": "HEALTH_WARN",
                "message": cls_msg,
                "detail": cls_detail,
                "count": len(cb.active),
                "tenant_class": worst_cls,
            }}
        slo = dict(slo)
        slo["message"] = f"{slo.get('message', '')}; {cls_msg}"
        slo["detail"] = list(slo.get("detail", ())) + cls_detail
        slo["tenant_class"] = worst_cls
        return {**base, "SLO_VIOLATION": slo}

    def digest_contrib(self) -> dict:
        eng = self.engine
        cb = self.class_burns
        return {
            "slo": {
                "objectives": self.last_eval,
                "violations": sorted(eng.active) if eng else [],
                "window_s": eng.window_span() if eng else 0.0,
                "classes": self.class_eval,
                "class_violations": sorted(cb.active) if cb else [],
            },
            "utilization": self.util,
        }

    def prom_metrics(self) -> dict[str, dict]:
        """Extra gauge families for the Prometheus exposition."""
        out: dict[str, dict] = {}
        per_obj: dict[str, list] = {"burn_rate": [], "ok": [],
                                    "value": []}
        if self.engine is not None:
            from ceph_tpu_torch.services.mgr import prom_label

            for obj, vals in sorted(self.engine.gauges().items()):
                lab = prom_label(objective=obj)
                for k in per_obj:
                    per_obj[k].append((lab, float(vals[k])))
        if self.class_eval:
            from ceph_tpu_torch.services.mgr import prom_label

            fast, slow = [], []
            for cls, rec in sorted(self.class_eval.items()):
                lab = prom_label(tenant_class=cls)
                fast.append((lab, float(rec.get("fast_burn", 0.0))))
                slow.append((lab, float(rec.get("slow_burn", 0.0))))
            out["ceph_slo_class_fast_burn"] = {
                "help": "tenant-class error-budget burn over the fast "
                        "(5m) window", "samples": fast}
            out["ceph_slo_class_slow_burn"] = {
                "help": "tenant-class error-budget burn over the slow "
                        "(1h) window", "samples": slow}
        out["ceph_slo_burn_rate"] = {
            "help": "error-budget burn rate per SLO objective "
                    "(1.0 = spending exactly the allowed budget)",
            "samples": per_obj["burn_rate"]}
        out["ceph_slo_ok"] = {
            "help": "1 while the objective meets target "
                    "(0 = SLO_VIOLATION active)",
            "samples": per_obj["ok"]}
        out["ceph_slo_value"] = {
            "help": "measured value per SLO objective over the window",
            "samples": per_obj["value"]}
        u = self.util
        for key, help_ in (
                ("device_gibps", "achieved EC device throughput GiB/s"),
                ("roofline_pct", "achieved device GiB/s as % of the "
                                 "HBM roofline (ec_hbm_peak_gibps)"),
                ("coalesce_occupancy", "ops per coalesced launch over "
                                       "the window"),
                ("coalesce_wait_p99_us", "coalescer window-wait p99 us"),
                ("resident_hit_rate", "device-resident shard cache hit "
                                      "rate"),
                ("rebuild_gibps", "repair engine rebuild throughput "
                                  "GiB/s"),
                ("client_p99_ms", "cluster client op p99 ms over the "
                                  "window"),
        ):
            out[f"ceph_util_{key}"] = {
                "help": help_,
                "samples": [("", float(u.get(key, 0.0)))]}
        return out
