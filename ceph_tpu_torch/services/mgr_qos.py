"""QoS defense-plane mgr module: the actuator fan-out.

Counterpart of ceph_tpu/services/mgr_qos.py: the same module over the
port's imports.

``QoSMonitor`` runs directly after ``SLOMonitor`` each report cycle
(module dispatch is insertion-ordered), reads the evaluation the SLO
engine just made plus the SAME sliding snapshot window the verdict was
computed from (:meth:`SLOEngine.window`), and drives the
:class:`ceph_tpu.common.qos.QoSController` tick:

- an ``mclock`` retune decision fans a ``qos_set`` wire cmd to every
  up OSD, shrinking/restoring the recovery / backfill / scrub class
  reservations+limits (three AIMD positions off one burn signal),
- burning-flag TRANSITIONS fan out as ``slo_burning`` in the same
  ``qos_set`` payloads: each OSD's ScrubEngine parks its in-flight
  sweep (cursor held) while the cluster burns and resumes on clear,
- per-OSD adaptive hedge timeouts push to exactly the OSDs whose
  shard-read tail moved,
- every decision journals a ``qos.retune`` / ``qos.hedge_push`` event
  into the flight recorder (same seed => same event sequence)
  and surfaces as ``ceph_qos_*`` Prometheus gauges, the ``qos`` digest
  section (dashboard ``/api/qos``), and forensic bundles via
  ``forensics_contrib`` — a capture shows what the defense plane was
  doing at violation time.

The third actuator family (RGW admission control) is front-door-local
— services/rgw_http.py sheds with ``503 Slow Down`` from its own conf
— so this module only aggregates its shed telemetry, it does not push
to it.
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.common.qos import QoSController
from ceph_tpu_torch.services.mgr_modules import MgrModule


class QoSMonitor(MgrModule):
    name = "qos"

    def __init__(self, mgr):
        super().__init__(mgr)
        self.controller: QoSController | None = None
        self.last_tick: dict = {}
        self._pushed_limit: float | None = None
        self._pushed_burning = False

    def _enabled(self) -> bool:
        return bool(self.mgr.conf["qos_enable"])

    def _ensure_controller(self) -> QoSController:
        # lazy like SLOMonitor's engine: vstart installs conf
        # overrides per-entity after construction
        if self.controller is None:
            self.controller = QoSController.from_conf(self.mgr.conf)
        return self.controller

    async def serve_once(self) -> None:
        if not self._enabled():
            return
        slo = self.mgr.modules.get("slo")
        eng = getattr(slo, "engine", None)
        if eng is None or not slo.last_eval:
            return
        ctrl = self._ensure_controller()
        out = ctrl.tick(slo.last_eval, eng.snapshot_window())
        self.last_tick = out
        jr = self.mgr.journal
        payloads: dict[int, dict] = {}      # osd id -> qos_set data
        osdmap = self.mgr.monc.osdmap
        up = {osd: info for osd, info in
              (osdmap.osds.items() if osdmap else ())
              if info.up}

        # the replication class is not an mClock class: its decision is
        # actuated as a token-bucket rate on the sync agents by the
        # multisite mgr module (which reads last_tick), so it is
        # journaled here but never fanned to OSDs
        rp = out.get("replication")
        if rp and rp["changed"]:
            jr.emit("qos.retune", actuator="sync-agent",
                    clazz="replication",
                    limit=round(rp["limit"], 3),
                    reservation=round(rp["reservation"], 3),
                    floor=round(rp["floor"], 3),
                    burn=round(out["burn"], 3),
                    burning=out["burning"])

        for clazz in ("recovery", "backfill", "scrub"):
            dec = out.get(clazz)
            if not dec or not dec["changed"]:
                continue
            jr.emit("qos.retune", actuator="mclock", clazz=clazz,
                    limit=round(dec["limit"], 3),
                    reservation=round(dec["reservation"], 3),
                    floor=round(dec["floor"], 3),
                    burn=round(out["burn"], 3),
                    burning=out["burning"])
            for osd in up:
                payloads.setdefault(
                    osd, {}).setdefault("mclock", {})[clazz] = {
                        "reservation": dec["reservation"],
                        "limit": dec["limit"],
                    }
            if clazz == "recovery":
                self._pushed_limit = dec["limit"]

        for daemon, timeout in sorted(out["hedge"].items()):
            # daemons are keyed "osd.N" by SLOMonitor's snapshot feed
            try:
                osd = int(str(daemon).split(".", 1)[1])
            except (IndexError, ValueError):
                continue
            if osd not in up:
                continue
            payloads.setdefault(osd, {})["hedge_timeout"] = timeout
            jr.emit("qos.hedge_push", daemon=str(daemon),
                    timeout_ms=round(timeout * 1e3, 3))

        # the scrub pause gate: the daemons park in-flight sweeps
        # while the cluster burns SLO, so a burning-flag TRANSITION
        # must reach every up OSD even when no mClock class retuned
        # this tick — and any payload already going out carries the
        # current flag so a restarted OSD re-learns it for free
        burning = bool(out["burning"])
        if burning != self._pushed_burning:
            self._pushed_burning = burning
            jr.emit("qos.scrub_gate",
                    action="pause" if burning else "resume",
                    burn=round(out["burn"], 3))
            for osd in up:
                payloads.setdefault(osd, {})
        for data in payloads.values():
            data["slo_burning"] = burning

        if payloads:
            await asyncio.gather(*(
                self.mgr.osd_request(osd, up[osd].addr, "qos_set",
                                     **data)
                for osd, data in payloads.items()))

    # -- mgr surfaces ------------------------------------------------------
    def _rgw_sheds(self) -> dict:
        """Front-door shed telemetry: rgw_http publishes its counters
        into the shared process namespace via the proc journal — count
        qos.shed events still in the ring (best effort)."""
        from ceph_tpu_torch.common.events import proc_journal

        sheds = [e for e in proc_journal().snapshot()
                 if e.get("type") == "qos.shed"]
        return {"recent_sheds": len(sheds)}

    def digest_contrib(self) -> dict:
        if not self._enabled():
            return {"qos": {"enabled": False}}
        ctrl = self.controller
        out = {"enabled": True}
        if ctrl is not None:
            out.update(ctrl.state())
            out["burning"] = bool(self.last_tick.get("burning", False))
            out["burn"] = round(
                float(self.last_tick.get("burn", 0.0)), 3)
        out.update(self._rgw_sheds())
        return {"qos": out}

    def forensics_contrib(self) -> dict:
        """Controller state folded into every forensic bundle."""
        if self.controller is None:
            return {}
        state = self.controller.state()
        state["enabled"] = self._enabled()
        state["burning"] = bool(self.last_tick.get("burning", False))
        return state

    def prom_metrics(self) -> dict[str, dict]:
        ctrl = self.controller
        if ctrl is None:
            return {}
        from ceph_tpu_torch.services.mgr import prom_label

        st = ctrl.state()
        out = {
            "ceph_qos_recovery_limit": {
                "help": "controller-set recovery-class mClock limit "
                        "ops/s (AIMD position)",
                "samples": [("", float(st["recovery_limit"]))]},
            "ceph_qos_recovery_floor": {
                "help": "recovery pacing floor ops/s (derived from "
                        "slo_rebuild_floor_gibs and the share/ops "
                        "floors)",
                "samples": [("", float(st["recovery_floor"]))]},
            "ceph_qos_backfill_limit": {
                "help": "controller-set backfill-class mClock limit "
                        "ops/s (planned-motion AIMD position)",
                "samples": [("", float(st["backfill_limit"]))]},
            "ceph_qos_backfill_floor": {
                "help": "backfill pacing floor ops/s (share/ops "
                        "floors; planned motion has no rebuild-GiB "
                        "term)",
                "samples": [("", float(st["backfill_floor"]))]},
            "ceph_qos_scrub_limit": {
                "help": "controller-set scrub-class mClock limit "
                        "ops/s (integrity-verification AIMD position)",
                "samples": [("", float(st["scrub_limit"]))]},
            "ceph_qos_scrub_floor": {
                "help": "scrub pacing floor ops/s (share/ops floors; "
                        "verification of fully-redundant data is "
                        "squeezed hardest under client burn)",
                "samples": [("", float(st["scrub_floor"]))]},
            "ceph_qos_replication_limit": {
                "help": "controller-set replication-class pacing rate "
                        "ops/s pushed to multisite sync agents (fourth "
                        "AIMD position)",
                "samples": [("", float(st["replication_limit"]))]},
            "ceph_qos_replication_floor": {
                "help": "replication pacing floor ops/s — the bound on "
                        "how fast RPO may grow while clients burn",
                "samples": [("", float(st["replication_floor"]))]},
            "ceph_qos_retunes": {
                "help": "cumulative mClock retune decisions",
                "samples": [("", float(st["retunes"]))]},
            "ceph_qos_burning": {
                "help": "1 while the controller sees client latency "
                        "burn > 1.0",
                "samples": [("", 1.0 if self.last_tick.get("burning")
                             else 0.0)]},
        }
        hedge = [(prom_label(daemon=d), float(ms))
                 for d, ms in sorted(st["hedge_timeouts_ms"].items())]
        out["ceph_qos_hedge_timeout_ms"] = {
            "help": "adaptive EC hedge-read timeout pushed per OSD",
            "samples": hedge or [("", 0.0)]}
        return out
