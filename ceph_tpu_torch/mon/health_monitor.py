"""HealthMonitor: aggregated cluster health with mutes and log output.

Counterpart of ceph_tpu/mon/health_monitor.py: the same module over the
port's imports.

Reference src/mon/HealthMonitor.cc + mon/health_check.h: every paxos
service contributes named checks (health_check_map_t) with a severity;
the monitor folds them into HEALTH_OK/WARN/ERR, supports
``health mute <code> [--sticky]`` (mute dropped automatically when the
check clears unless sticky), and logs transitions to the cluster log
("Health check failed: ... (CODE)" / "Health check cleared: CODE").
"""

from __future__ import annotations

from ceph_tpu_torch.mon.service import ENOENT_RC, CommandResult, PaxosService
from ceph_tpu_torch.mon.store import StoreTransaction
from ceph_tpu_torch.msg.codec import decode, encode

PREFIX = "health"

_SEV_RANK = {"HEALTH_OK": 0, "HEALTH_WARN": 1, "HEALTH_ERR": 2}


class HealthMonitor(PaxosService):
    prefix = PREFIX

    def __init__(self, mon):
        super().__init__(mon)
        self.mutes: dict[str, dict] = {}       # code -> {sticky: bool}
        self._prev_codes: dict[str, str] = {}  # code -> severity (leader)

    def refresh(self) -> None:
        raw = self.store.get(PREFIX, "mutes")
        self.mutes = decode(raw) if raw is not None else {}

    # -- aggregation -------------------------------------------------------
    def gather(self) -> dict[str, dict]:
        """Merge health checks from every service plus monitor-local
        quorum state.  Returns code -> {severity, message, [detail]}."""
        checks: dict[str, dict] = {}
        for svc in self.mon.services.values():
            if svc is self:
                continue
            checks.update(svc.health_checks())
        monmap = self.mon.monmap
        quorum = self.mon.elector.quorum
        if quorum and len(quorum) < len(monmap):
            out = sorted(set(monmap) - set(quorum))
            checks["MON_DOWN"] = {
                "severity": "HEALTH_WARN",
                "message": f"{len(out)}/{len(monmap)} mons down: {out}",
            }
        return checks

    def summary(self, detail: bool = False) -> dict:
        checks = self.gather()
        active = {c: v for c, v in checks.items() if c not in self.mutes}
        status = "HEALTH_OK"
        for v in active.values():
            if _SEV_RANK.get(v["severity"], 2) > _SEV_RANK[status]:
                status = v["severity"]
        out = {
            "status": status,
            "checks": {
                c: (v if detail else
                    {k: v[k] for k in ("severity", "message") if k in v})
                for c, v in active.items()
            },
        }
        muted = {c: v for c, v in checks.items() if c in self.mutes}
        if muted:
            out["muted"] = sorted(muted)
        return out

    # -- leader maintenance ------------------------------------------------
    def tick_transitions(self) -> tuple[list[dict], dict[str, bytes | None]]:
        """Leader-side: diff current checks against the previous tick.
        Returns (cluster-log entries, store mutations for mute expiry)."""
        checks = self.gather()
        logs: list[dict] = []
        jr = getattr(self.mon, "journal", None)
        epoch = self.mon.osd_monitor.osdmap.epoch
        for code, v in checks.items():
            if self._prev_codes.get(code) != v["severity"]:
                if jr is not None:
                    jr.emit("health.raise", epoch=epoch, code=code,
                            severity=v["severity"],
                            message=v["message"])
                logs.append({
                    "who": f"mon.{self.mon.name}",
                    "level": "warn" if v["severity"] != "HEALTH_ERR"
                    else "error",
                    "message":
                        f"Health check failed: {v['message']} ({code})",
                })
        cleared_mutes = False
        for code in list(self._prev_codes):
            if code not in checks:
                if jr is not None:
                    jr.emit("health.clear", epoch=epoch, code=code)
                logs.append({
                    "who": f"mon.{self.mon.name}",
                    "level": "info",
                    "message": f"Health check cleared: {code}",
                })
                # non-sticky mutes evaporate when the check clears
                if code in self.mutes and not self.mutes[code].get(
                        "sticky"):
                    self.mutes.pop(code)
                    cleared_mutes = True
        if self._prev_codes and not checks:
            logs.append({
                "who": f"mon.{self.mon.name}", "level": "info",
                "message": "Cluster is now healthy",
            })
        self._prev_codes = {c: v["severity"] for c, v in checks.items()}
        mutations: dict[str, bytes | None] = (
            {"mutes": encode(self.mutes)} if cleared_mutes else {}
        )
        return logs, mutations

    # -- commands ----------------------------------------------------------
    def preprocess_command(self, cmd: dict) -> CommandResult | None:
        name = cmd.get("prefix", "")
        if name == "health":
            return CommandResult(data=self.summary())
        if name == "health detail":
            return CommandResult(data=self.summary(detail=True))
        return None

    def prepare_command(self, cmd: dict, tx: StoreTransaction
                        ) -> CommandResult:
        name = cmd.get("prefix", "")
        if name == "health mute":
            code = str(cmd.get("code", ""))
            mutes = dict(self.mutes)
            mutes[code] = {"sticky": bool(cmd.get("sticky", False))}
            tx.put(PREFIX, "mutes", encode(mutes))
            return CommandResult(outs=f"muted {code}")
        if name == "health unmute":
            code = str(cmd.get("code", ""))
            if code not in self.mutes:
                return CommandResult(ENOENT_RC, f"{code} not muted")
            mutes = dict(self.mutes)
            mutes.pop(code)
            tx.put(PREFIX, "mutes", encode(mutes))
            return CommandResult(outs=f"unmuted {code}")
        return super().prepare_command(cmd, tx)
