"""LogMonitor: the replicated cluster log.

Counterpart of ceph_tpu/mon/log_monitor.py: the same module over the
port's imports.

Reference src/mon/LogMonitor.{h,cc}: daemons send MLog batches of
LogEntry (who/stamp/level/message); the leader assigns sequence numbers,
commits them through paxos, and serves ``ceph log last [n] [level]``.
Health transitions and notable events land here too ("Health check
failed: ..."), so the cluster log is the operator's first debugging
surface.  A bounded window is kept (trimmed like the reference's
log_max_recent).
"""

from __future__ import annotations

import time
from collections import deque

from ceph_tpu_torch.mon.service import EINVAL_RC, CommandResult, PaxosService
from ceph_tpu_torch.mon.store import StoreTransaction
from ceph_tpu_torch.msg.codec import decode, encode

PREFIX = "logm"
KEEP_ENTRIES = 500

LEVELS = ("debug", "info", "warn", "error")


class LogMonitor(PaxosService):
    prefix = PREFIX

    def __init__(self, mon):
        super().__init__(mon)
        self.last_seq = 0
        self.entries: deque[dict] = deque(maxlen=KEEP_ENTRIES)

    # -- state ------------------------------------------------------------
    def refresh(self) -> None:
        seq = self.store.get_int(PREFIX, "seq")
        if seq <= self.last_seq:
            return
        lo = max(self.last_seq + 1, seq - KEEP_ENTRIES + 1)
        for s in range(lo, seq + 1):
            raw = self.store.get(PREFIX, f"e{s}")
            if raw is not None:
                self.entries.append(decode(raw))
        self.last_seq = seq

    # -- mutation ----------------------------------------------------------
    def stage_entries(self, entries: list[dict],
                      tx: StoreTransaction) -> int:
        """Assign sequence numbers and stage; returns count staged.
        Caller holds the mon mutate lock and runs the paxos propose."""
        seq = self.last_seq
        staged = 0
        for e in entries:
            level = str(e.get("level", "info"))
            if level not in LEVELS:
                level = "info"
            msg = str(e.get("message", ""))[:4096]
            if not msg:
                continue
            seq += 1
            entry = {
                "seq": seq,
                "stamp": float(e.get("stamp") or time.time()),
                "who": str(e.get("who", "mon")),
                "level": level,
                "message": msg,
            }
            tx.put(PREFIX, f"e{seq}", encode(entry))
            staged += 1
        if staged:
            tx.put(PREFIX, "seq", seq)
            old = seq - KEEP_ENTRIES
            for s in range(max(1, old - len(entries)), old + 1):
                tx.erase(PREFIX, f"e{s}")
        return staged

    # -- commands ----------------------------------------------------------
    def preprocess_command(self, cmd: dict) -> CommandResult | None:
        if cmd.get("prefix", "") == "log last":
            try:
                num = int(cmd.get("num", 20))
            except (TypeError, ValueError):
                return CommandResult(EINVAL_RC, "bad num")
            level = cmd.get("level")
            if level is not None and level not in LEVELS:
                return CommandResult(
                    EINVAL_RC, f"level must be one of {LEVELS}"
                )
            out = [
                e for e in self.entries
                if level is None
                or LEVELS.index(e["level"]) >= LEVELS.index(level)
            ]
            return CommandResult(data=out[-num:])
        return None

    def prepare_command(self, cmd: dict, tx: StoreTransaction
                        ) -> CommandResult:
        if cmd.get("prefix", "") == "log":
            message = str(cmd.get("message", ""))
            if not message:
                return CommandResult(EINVAL_RC, "empty log message")
            n = self.stage_entries([{
                "who": str(cmd.get("who", "client")),
                "level": str(cmd.get("level", "info")),
                "message": message,
            }], tx)
            return CommandResult(outs=f"logged {n} entries")
        return super().prepare_command(cmd, tx)
