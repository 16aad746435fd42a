"""MgrStatMonitor: the mgr-fed PGMap digest at the monitor.

Counterpart of ceph_tpu/mon/mgr_stat.py: the same module over the
port's imports.

Reference src/mon/MgrStatMonitor.cc: the manager aggregates per-daemon
MPGStats into a PGMap (src/mon/PGMap.cc) and periodically sends the
monitor a digest (MMonMgrReport) carrying pg state counts, pool usage,
and health checks; ``ceph status``'s pgmap section, ``ceph df`` and
``ceph pg stat`` are all served from that digest, and PG_* health
checks are derived from it.

Digest shape (all optional, the mgr fills what it knows):
  {"pgs_by_state": {"active+clean": 10, ...},
   "num_pgs": N, "num_objects": N, "num_bytes": N,
   "pools": {pool_id: {"name", "num_pgs", "num_objects", "num_bytes",
                        "degraded": N}},
   "degraded_objects": N, "osd_df": {osd: {"bytes_used": N}}}
"""

from __future__ import annotations

from ceph_tpu_torch.mon.service import (
    EINVAL_RC,
    ENOENT_RC,
    CommandResult,
    PaxosService,
)
from ceph_tpu_torch.mon.store import StoreTransaction
from ceph_tpu_torch.msg.codec import decode, encode

PREFIX = "mgrstat"

# One definition of the orch <-> config-key store contract: the mon
# writes specs/tombstones here, the mgr orchestrator module reads them
# back via config-key commands.
from ceph_tpu_torch.mon.config_monitor import KEY_PREFIX as CONFKEY_PREFIX

ORCH_SPEC_PREFIX = "orch/spec/"
ORCH_RM_PREFIX = "orch/rm/"

# mirrored by services/mgr_perf.py (the modules read what we stage)
_PQ_SPEC_PREFIX = "mgr/osd_perf_query/"
_TRASH_SCHED_PREFIX = "mgr/rbd_support/trash_sched/"


class MgrStatMonitor(PaxosService):
    prefix = PREFIX

    def __init__(self, mon):
        super().__init__(mon)
        self.digest: dict = {}
        self.crashes: dict[str, dict] = {}

    def refresh(self) -> None:
        raw = self.store.get(PREFIX, "digest")
        self.digest = decode(raw) if raw is not None else {}
        self.crashes = {}
        for key in self.store.keys(PREFIX):
            if key.startswith("crash/"):
                craw = self.store.get(PREFIX, key)
                if craw is not None:
                    self.crashes[key[len("crash/"):]] = decode(craw)

    # -- status surface ----------------------------------------------------
    def pgmap_summary(self) -> dict:
        d = self.digest
        return {
            "num_pgs": int(d.get("num_pgs", 0)),
            "pgs_by_state": dict(d.get("pgs_by_state", {})),
            "num_objects": int(d.get("num_objects", 0)),
            "num_bytes": int(d.get("num_bytes", 0)),
            "degraded_objects": int(d.get("degraded_objects", 0)),
            "misplaced_objects": int(d.get("misplaced_objects", 0)),
        }

    def health_checks(self) -> dict[str, dict]:
        checks: dict[str, dict] = {}
        d = self.digest
        # mgr-module checks ride the digest (pg_autoscaler etc.)
        for code, v in d.get("health_checks", {}).items():
            if isinstance(v, dict) and "severity" in v:
                checks[str(code)] = dict(v)
        recent = [cid for cid, c in self.crashes.items()
                  if not c.get("archived")]
        if recent:
            checks["RECENT_CRASH"] = {
                "severity": "HEALTH_WARN",
                "message": f"{len(recent)} daemon crashes not archived",
                "detail": sorted(recent),
            }
        degraded = int(d.get("degraded_objects", 0))
        if degraded:
            checks["PG_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "message":
                    f"Degraded data redundancy: {degraded} objects "
                    "degraded",
            }
        # misplaced is NOT lost redundancy (planned motion: every
        # object still fully redundant on its old holders), but health
        # stays WARN until the backfill engine finishes draining so
        # wait-for-clean callers really wait for motion-complete
        misplaced = int(d.get("misplaced_objects", 0))
        if misplaced:
            checks["OBJECT_MISPLACED"] = {
                "severity": "HEALTH_WARN",
                "message": f"{misplaced} objects misplaced "
                           "(backfill in progress)",
            }
        inactive = {
            s: n for s, n in d.get("pgs_by_state", {}).items()
            if "active" not in s and n
        }
        if inactive:
            total = sum(inactive.values())
            checks["PG_AVAILABILITY"] = {
                "severity": "HEALTH_WARN",
                "message": f"Reduced data availability: {total} pgs "
                           f"inactive ({inactive})",
            }
        return checks

    # -- orch surface ------------------------------------------------------
    # ``ceph orch`` commands (reference src/pybind/mgr/orchestrator
    # module.py command handlers): specs persist as orch/spec/<type>
    # keys in the config-key store; the mgr orchestrator module
    # (services/orchestrator.py, which imports THESE constants)
    # reconciles and reports inventory through the digest.
    _ORCH_SPEC_PREFIX = ORCH_SPEC_PREFIX
    _ORCH_RM_PREFIX = ORCH_RM_PREFIX
    _CONFKEY = CONFKEY_PREFIX

    def _orch_specs(self) -> dict[str, dict]:
        import json

        specs = {}
        for key in self.store.keys(self._CONFKEY):
            if not key.startswith(self._ORCH_SPEC_PREFIX):
                continue
            raw = self.store.get(self._CONFKEY, key)
            try:
                specs[key[len(self._ORCH_SPEC_PREFIX):]] = \
                    json.loads((raw or b"{}").decode())
            except ValueError:
                continue
        return specs

    def _orch_preprocess(self, cmd: dict) -> CommandResult | None:
        name = cmd.get("prefix", "")
        orch = self.digest.get("orchestrator", {})
        if name == "orch ls":
            daemons = orch.get("daemons", [])
            out = {}
            for stype, spec in sorted(self._orch_specs().items()):
                out[stype] = {
                    "service_type": stype,
                    "target": 0 if spec.get("deleted")
                    else int(spec.get("count", 0)),
                    "running": sum(1 for d in daemons
                                   if d.get("type") == stype),
                    "unmanaged": bool(spec.get("unmanaged")),
                    "deleted": bool(spec.get("deleted")),
                }
            return CommandResult(data=out)
        if name == "orch ps":
            return CommandResult(data=orch.get("daemons", []))
        if name == "orch host ls":
            return CommandResult(data=orch.get("hosts", []))
        if name == "orch status":
            return CommandResult(data={
                "available": bool(orch.get("available")),
                "backend": "devcluster" if orch.get("available")
                else None,
                "last_actions": orch.get("last_actions", []),
            })
        return None

    def _orch_prepare(self, cmd: dict, tx: StoreTransaction
                      ) -> CommandResult | None:
        import json

        name = cmd.get("prefix", "")
        if name == "orch apply":
            stype = str(cmd.get("service_type", ""))
            if stype not in ("osd", "mds", "rgw"):
                return CommandResult(
                    EINVAL_RC, f"unknown service type {stype!r}")
            try:
                count = int(cmd.get("count", 0))
            except (TypeError, ValueError):
                return CommandResult(EINVAL_RC, "count must be an int")
            if count < 0 or count > 1000:
                return CommandResult(EINVAL_RC,
                                     f"count {count} out of range")
            spec = {"service_type": stype, "count": count,
                    "unmanaged": bool(cmd.get("unmanaged", False))}
            tx.put(self._CONFKEY, self._ORCH_SPEC_PREFIX + stype,
                   json.dumps(spec).encode())
            return CommandResult(
                outs=f"Scheduled {stype} update (count {count})")
        if name == "orch rm":
            stype = str(cmd.get("service_type", ""))
            specs = self._orch_specs()
            if stype not in specs:
                return CommandResult(ENOENT_RC,
                                     f"no spec for {stype!r}")
            spec = dict(specs[stype])
            spec["deleted"] = True
            spec["unmanaged"] = False
            tx.put(self._CONFKEY, self._ORCH_SPEC_PREFIX + stype,
                   json.dumps(spec).encode())
            return CommandResult(outs=f"Removing service {stype}")
        if name == "orch daemon rm":
            dname = str(cmd.get("name", ""))
            if "." not in dname:
                return CommandResult(
                    EINVAL_RC, f"bad daemon name {dname!r}")
            tx.put(self._CONFKEY, self._ORCH_RM_PREFIX + dname, b"1")
            return CommandResult(outs=f"Scheduled removal of {dname}")
        return None

    # -- commands ----------------------------------------------------------
    def preprocess_command(self, cmd: dict) -> CommandResult | None:
        name = cmd.get("prefix", "")
        if name.startswith("orch"):
            return self._orch_preprocess(cmd)
        if name == "pg stat":
            return CommandResult(data=self.pgmap_summary())
        if name == "balancer status":
            return CommandResult(data=self.digest.get("balancer", {
                "active": False, "mode": "none",
            }))
        if name == "progress":
            return CommandResult(data=self.digest.get("progress", []))
        if name == "device ls":
            return CommandResult(data=self.digest.get("device_health",
                                                      {}))
        if name == "telemetry show":
            return CommandResult(data=self.digest.get("telemetry", {}))
        if name == "insights":
            return CommandResult(data=self.digest.get("insights", {}))
        if name == "snap-schedule status":
            return CommandResult(
                data=self.digest.get("snap_schedule", {}))
        if name == "osd pool autoscale-status":
            return CommandResult(data=self.digest.get("pg_autoscale",
                                                      {}))
        if name == "crash ls":
            return CommandResult(data=[
                {"crash_id": cid,
                 "entity": c.get("entity", "?"),
                 "timestamp": c.get("timestamp", 0),
                 "archived": bool(c.get("archived"))}
                for cid, c in sorted(self.crashes.items())
            ])
        if name == "crash info":
            cid = str(cmd.get("id", ""))
            if cid not in self.crashes:
                return CommandResult(ENOENT_RC, f"no crash {cid!r}")
            return CommandResult(data=self.crashes[cid])
        if name == "df":
            pools = {
                int(pid): dict(p)
                for pid, p in self.digest.get("pools", {}).items()
            }
            return CommandResult(data={
                "pools": pools,
                "total_bytes": int(self.digest.get("num_bytes", 0)),
                "osd_df": self.digest.get("osd_df", {}),
            })
        if name == "iostat":
            return CommandResult(data=self.digest.get("iostat", {}))
        if name == "ts status":
            # the observability rollup `ceph-tpu top` renders: every
            # section rides the mgr-report digest, so this works from
            # any client that can reach the mon — no mgr socket needed
            return CommandResult(data={
                "tsdb": self.digest.get("tsdb", {}),
                "slo": self.digest.get("slo", {}),
                "utilization": self.digest.get("utilization", {}),
                "qos": self.digest.get("qos", {}),
                "health_checks": self.digest.get("health_checks", {}),
            })
        if name == "rbd perf image iostat":
            rs = self.digest.get("rbd_support", {})
            return CommandResult(data=rs.get("image_iostat", {}))
        if name == "rbd trash purge schedule ls":
            import json

            out = []
            for key in self.store.keys(CONFKEY_PREFIX):
                if not key.startswith(_TRASH_SCHED_PREFIX):
                    continue
                raw = self.store.get(CONFKEY_PREFIX, key)
                try:
                    spec = json.loads(raw) if raw else {}
                except ValueError:
                    spec = {}
                out.append({
                    "pool": key[len(_TRASH_SCHED_PREFIX):], **spec,
                })
            return CommandResult(data=out)
        if name == "rbd trash purge schedule status":
            rs = self.digest.get("rbd_support", {})
            return CommandResult(data=rs.get("trash_schedules", {}))
        if name == "osd perf query ls":
            import json

            out = []
            for key in self.store.keys(CONFKEY_PREFIX):
                if not key.startswith(_PQ_SPEC_PREFIX):
                    continue
                raw = self.store.get(CONFKEY_PREFIX, key)
                try:
                    spec = json.loads(raw) if raw else {}
                except ValueError:
                    spec = {}
                out.append({"qid": int(key[len(_PQ_SPEC_PREFIX):]),
                            **spec})
            return CommandResult(data=out)
        if name == "osd perf counters get":
            q = self.digest.get("osd_perf_query", {})
            qid = str(cmd.get("qid", ""))
            if qid not in q:
                return CommandResult(
                    ENOENT_RC, f"no perf query {qid!r} (not installed "
                    "yet, or unknown)")
            return CommandResult(data=q[qid])
        return None

    def prepare_command(self, cmd: dict, tx: StoreTransaction
                        ) -> CommandResult:
        name = cmd.get("prefix", "")
        if name.startswith("orch"):
            r = self._orch_prepare(cmd, tx)
            if r is not None:
                return r
        if name == "mgr report":
            digest = cmd.get("digest")
            if not isinstance(digest, dict):
                return CommandResult(EINVAL_RC, "digest must be a dict")
            tx.put(PREFIX, "digest", encode(digest))
            return CommandResult(outs="report accepted")
        if name == "rbd trash purge schedule add":
            import json

            pool = str(cmd.get("pool", ""))
            if not pool:
                return CommandResult(EINVAL_RC, "pool required")
            try:
                interval = float(cmd.get("interval", 900))
            except (TypeError, ValueError):
                return CommandResult(EINVAL_RC,
                                     "interval must be seconds")
            if interval <= 0:
                return CommandResult(EINVAL_RC, "interval must be > 0")
            tx.put(CONFKEY_PREFIX, _TRASH_SCHED_PREFIX + pool,
                   json.dumps({"interval": interval}).encode())
            return CommandResult(
                outs=f"trash purge every {interval:g}s on {pool!r}")
        if name == "rbd trash purge schedule rm":
            pool = str(cmd.get("pool", ""))
            if self.store.get(CONFKEY_PREFIX,
                              _TRASH_SCHED_PREFIX + pool) is None:
                return CommandResult(ENOENT_RC,
                                     f"no schedule for {pool!r}")
            tx.erase(CONFKEY_PREFIX, _TRASH_SCHED_PREFIX + pool)
            return CommandResult(outs=f"schedule for {pool!r} removed")
        if name == "osd perf query add":
            import json

            qtype = str(cmd.get("type", ""))
            if qtype not in ("by_pool", "by_client", "rbd_image",
                            "by_object_prefix"):
                return CommandResult(EINVAL_RC,
                                     f"unknown query type {qtype!r}")
            qids = [
                int(k[len(_PQ_SPEC_PREFIX):])
                for k in self.store.keys(CONFKEY_PREFIX)
                if k.startswith(_PQ_SPEC_PREFIX)
            ]
            qid = max(qids, default=0) + 1
            tx.put(CONFKEY_PREFIX, f"{_PQ_SPEC_PREFIX}{qid}",
                   json.dumps({"type": qtype}).encode())
            return CommandResult(data={"qid": qid},
                                 outs=f"added query {qid}")
        if name == "osd perf query rm":
            qid = str(cmd.get("qid", ""))
            if self.store.get(CONFKEY_PREFIX,
                              _PQ_SPEC_PREFIX + qid) is None:
                return CommandResult(ENOENT_RC, f"no query {qid!r}")
            tx.erase(CONFKEY_PREFIX, _PQ_SPEC_PREFIX + qid)
            return CommandResult(outs=f"removed query {qid}")
        if name == "crash post":
            report = cmd.get("report")
            if not isinstance(report, dict) \
                    or not report.get("crash_id"):
                return CommandResult(
                    EINVAL_RC, "report must be a dict with a crash_id"
                )
            cid = str(report["crash_id"])
            tx.put(PREFIX, f"crash/{cid}", encode(dict(report)))
            return CommandResult(outs=f"posted crash {cid}")
        if name == "crash archive":
            cid = str(cmd.get("id", ""))
            if cid not in self.crashes:
                return CommandResult(ENOENT_RC, f"no crash {cid!r}")
            report = dict(self.crashes[cid])
            report["archived"] = True
            tx.put(PREFIX, f"crash/{cid}", encode(report))
            return CommandResult(outs=f"archived crash {cid}")
        if name == "crash rm":
            cid = str(cmd.get("id", ""))
            if cid not in self.crashes:
                return CommandResult(ENOENT_RC, f"no crash {cid!r}")
            tx.erase(PREFIX, f"crash/{cid}")
            return CommandResult(outs=f"removed crash {cid}")
        return super().prepare_command(cmd, tx)
