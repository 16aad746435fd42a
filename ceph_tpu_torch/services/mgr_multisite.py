"""Multisite mgr module: geo-replication telemetry + QoS actuation.

Counterpart of ceph_tpu/services/mgr_multisite.py: the same module over the
port's imports.

``MultisiteMonitor`` runs after ``QoSMonitor`` each report cycle
(module dispatch is insertion-ordered) and closes the replication leg
of the defense loop:

- it reads the replication-class decision the QoS controller just made
  (``QoSMonitor.last_tick["replication"]``) and pushes the pacing rate
  to every attached sync agent via :meth:`RGWSyncAgent.set_rate` — the
  replication class is not an mClock class, so the fan-out is
  in-process to the agents the local zone runs, not a wire cmd to
  OSDs; each push journals ``qos.replication_push``,
- it polls each agent's :meth:`lag` ledger (entries AND bytes
  acked-but-unreplicated per bucket/shard — the live RPO estimate) and
  perf counters, folding both into the ``multisite`` digest section,
  ``ceph_rgw_sync_*`` Prometheus gauges, and forensic bundles.

A zone that runs no orchestrator (single-site deployments) simply has
nothing attached and the module is a no-op.
"""

from __future__ import annotations

from ceph_tpu_torch.services.mgr_modules import MgrModule


class MultisiteMonitor(MgrModule):
    name = "multisite"

    def __init__(self, mgr):
        super().__init__(mgr)
        self.orchestrators: list = []
        self._pushed_rate: float | None = None
        self.last_lag: dict = {}

    def attach(self, orchestrator) -> None:
        """Register a SyncOrchestrator whose agents this module
        measures and paces (vstart wires the zone's own)."""
        if orchestrator not in self.orchestrators:
            self.orchestrators.append(orchestrator)

    def _agents(self) -> dict[str, object]:
        out = {}
        for orch in self.orchestrators:
            for (src, dst), agent in getattr(orch, "agents",
                                             {}).items():
                out[f"{src}->{dst}"] = agent
        return out

    async def serve_once(self) -> None:
        agents = self._agents()
        if not agents:
            return
        # 1. actuate the replication QoS class: the limit the
        # controller last decided becomes every agent's pacing rate
        qos = self.mgr.modules.get("qos")
        dec = (qos.last_tick.get("replication")
               if qos is not None and qos.last_tick else None)
        if dec is not None:
            rate = float(dec["limit"])
            if rate != self._pushed_rate:
                for agent in agents.values():
                    if hasattr(agent, "set_rate"):
                        agent.set_rate(rate)
                self._pushed_rate = rate
                self.mgr.journal.emit(
                    "qos.replication_push", rate=round(rate, 3),
                    agents=len(agents))
        # 2. refresh the lag ledger (the live RPO estimate)
        lag: dict[str, dict] = {}
        for pair, agent in sorted(agents.items()):
            if not hasattr(agent, "lag"):
                continue
            try:
                lag[pair] = await agent.lag()
            except Exception:            # noqa: BLE001 — source down
                lag[pair] = {"entries": -1, "bytes": -1,
                             "unreachable": True}
        self.last_lag = lag

    # -- mgr surfaces ------------------------------------------------------
    def digest_contrib(self) -> dict:
        agents = self._agents()
        if not agents:
            return {}
        out = {
            "agents": {pair: agent.status()
                       for pair, agent in sorted(agents.items())
                       if hasattr(agent, "status")},
            "lag": {pair: {"entries": led.get("entries", 0),
                           "bytes": led.get("bytes", 0)}
                    for pair, led in sorted(self.last_lag.items())},
            "pushed_rate": self._pushed_rate,
        }
        return {"multisite": out}

    def forensics_contrib(self) -> dict:
        d = self.digest_contrib()
        return d.get("multisite", {})

    def prom_metrics(self) -> dict[str, dict]:
        agents = self._agents()
        if not agents:
            return {}
        from ceph_tpu_torch.services.mgr import prom_label

        def samples(counter_key):
            out = []
            for pair, agent in sorted(agents.items()):
                perf = getattr(agent, "perf", None)
                if perf is None:
                    continue
                out.append((prom_label(pair=pair),
                            float(perf.value(counter_key))))
            return out or [("", 0.0)]

        out = {
            "ceph_rgw_sync_put_ops": {
                "help": "objects replicated by put replay",
                "samples": samples("sync_put_ops")},
            "ceph_rgw_sync_del_ops": {
                "help": "deletes replicated by replay",
                "samples": samples("sync_del_ops")},
            "ceph_rgw_sync_bytes": {
                "help": "payload bytes replicated",
                "samples": samples("sync_bytes")},
            "ceph_rgw_sync_reconciles": {
                "help": "version-level ops converged by re-reading "
                        "current source state",
                "samples": samples("sync_reconcile_ops")},
            "ceph_rgw_sync_retries": {
                "help": "per-shard error retries (deterministic "
                        "backoff engaged)",
                "samples": samples("sync_retries")},
            "ceph_rgw_sync_conflict_skips": {
                "help": "incoming writes skipped by last-writer-wins "
                        "(destination held a newer write)",
                "samples": samples("sync_conflict_skips")},
            "ceph_rgw_sync_purged": {
                "help": "destination-only keys removed by full-sync "
                        "resync (a revived zone's unreplicated writes)",
                "samples": samples("sync_purged")},
            "ceph_rgw_sync_paced_waits": {
                "help": "replication ops delayed by the QoS pacing "
                        "token bucket",
                "samples": samples("sync_paced_waits")},
            "ceph_rgw_sync_trim_seq": {
                "help": "latest source-shard sequence trimmed after "
                        "replay",
                "samples": samples("sync_trim_seq")},
            "ceph_rgw_sync_lag_entries": {
                "help": "datalog entries acked on the source but not "
                        "yet replayed (RPO ledger, entries)",
                "samples": samples("sync_lag_entries")},
            "ceph_rgw_sync_lag_bytes": {
                "help": "bytes acked on the source but not yet "
                        "replayed (RPO ledger, bytes)",
                "samples": samples("sync_lag_bytes")},
        }
        return out
