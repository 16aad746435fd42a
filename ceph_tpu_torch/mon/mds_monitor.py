"""MDSMonitor: the FSMap service (filesystems + MDS daemon states).

Counterpart of ceph_tpu/mon/mds_monitor.py: the same module over the
port's imports.

Reference src/mon/MDSMonitor.cc + src/mds/FSMap.cc: ``fs new`` binds a
named filesystem to its metadata/data pools; MDS daemons announce
themselves with beacons (MMDSBeacon) and the monitor assigns roles —
one active per filesystem, the rest standby; a beacon-silent active is
failed over to a standby; clients discover the active MDS address from
the map (``mds stat``).

Proposals are staged only on STATE changes (registration, role moves,
failover); routine beacons refresh leader-local liveness without
touching paxos — the reference's beacon path makes the same split.
"""

from __future__ import annotations

import time

from ceph_tpu_torch.mon.service import (
    EEXIST_RC,
    EINVAL_RC,
    ENOENT_RC,
    CommandResult,
    PaxosService,
)
from ceph_tpu_torch.mon.store import StoreTransaction
from ceph_tpu_torch.msg.codec import decode, encode

PREFIX = "mdsmap"

STATE_ACTIVE = "up:active"
STATE_STANDBY = "up:standby"
STATE_DOWN = "down"


class MDSMonitor(PaxosService):
    prefix = PREFIX

    def __init__(self, mon):
        super().__init__(mon)
        self.epoch = 0
        self.filesystems: dict[str, dict] = {}
        self.mds: dict[str, dict] = {}       # name -> {addr, fs, state}
        self._last_beacon: dict[str, float] = {}   # leader-local
        self._loads: dict[str, float] = {}         # leader-local
        self.pending = False

    # -- state ------------------------------------------------------------
    def refresh(self) -> None:
        raw = self.store.get(PREFIX, "fsmap")
        if raw is None:
            return
        m = decode(raw)
        self.epoch = int(m["epoch"])
        self.filesystems = {str(k): dict(v)
                            for k, v in m["filesystems"].items()}
        self.mds = {str(k): dict(v) for k, v in m["mds"].items()}

    def _stage(self, tx: StoreTransaction) -> None:
        self.epoch += 1
        tx.put(PREFIX, "fsmap", encode({
            "epoch": self.epoch,
            "filesystems": self.filesystems,
            "mds": self.mds,
        }))

    def encode_pending(self, tx: StoreTransaction) -> bool:
        if not self.pending:
            return False
        self.pending = False
        self._stage(tx)
        return True

    # -- beacons (MMDSBeacon) ---------------------------------------------
    def handle_beacon(self, name: str, addr: str, fs: str,
                      load: float = 0.0) -> bool:
        """Record liveness; returns True when a map change was staged
        (registration, address change, or a role assignment)."""
        self._last_beacon[name] = time.monotonic()
        self._loads[name] = float(load)   # observability only, no paxos
        info = self.mds.get(name)
        if info is not None and info["addr"] == addr \
                and info["state"] != STATE_DOWN:
            return False
        state, rank = self._pick_role(name, fs)
        self.mds[name] = {
            "addr": addr, "fs": fs, "state": state, "rank": rank,
        }
        if state == STATE_ACTIVE:
            # a daemon assigned straight to an active rank (no standby
            # phase) must learn its rank NOW, not at the next beacon
            # ack — it would otherwise serve with rank-0 journal/table
            self._notify_takeover(name, addr)
        self.pending = True
        return True

    def _held_ranks(self, fs: str, skip: str = "") -> set[int]:
        return {int(i.get("rank", 0)) for n, i in self.mds.items()
                if n != skip and i["fs"] == fs
                and i["state"] == STATE_ACTIVE}

    def _pick_role(self, name: str, fs: str) -> tuple[str, int]:
        """Fill active ranks 0..max_mds-1 (FSMap rank assignment);
        everyone else stands by."""
        max_mds = int(self.filesystems.get(fs, {}).get("max_mds", 1))
        held = self._held_ranks(fs, skip=name)
        for rank in range(max_mds):
            if rank not in held:
                return STATE_ACTIVE, rank
        return STATE_STANDBY, -1

    def promote_standbys(self, fs: str) -> bool:
        """Fill vacant ranks from standbys (after max_mds raise or a
        failover); returns True when the map changed."""
        changed = False
        while True:
            max_mds = int(self.filesystems.get(fs, {}).get("max_mds", 1))
            held = self._held_ranks(fs)
            vacant = next((r for r in range(max_mds) if r not in held),
                          None)
            if vacant is None:
                return changed
            standby = next((n for n, i in self.mds.items()
                            if i["fs"] == fs
                            and i["state"] == STATE_STANDBY), None)
            if standby is None:
                return changed
            self.mds[standby]["state"] = STATE_ACTIVE
            self.mds[standby]["rank"] = vacant
            self.mon.cluster_log(
                "info", f"mds.{standby} takes rank {vacant} for fs "
                f"{fs!r}"
            )
            self._notify_takeover(standby, self.mds[standby]["addr"])
            changed = True

    async def tick(self) -> None:
        """Leader: age out beacon-silent daemons and fail over."""
        grace = self.mon.conf["mds_beacon_grace"]
        now = time.monotonic()
        changed = False
        for name, info in self.mds.items():
            if info["state"] == STATE_DOWN:
                continue
            last = self._last_beacon.get(name)
            if last is None:
                # first sight since this mon became leader: start the
                # clock now rather than instantly failing the daemon
                self._last_beacon[name] = now
                continue
            if now - last > grace:
                was_active = info["state"] == STATE_ACTIVE
                info["state"] = STATE_DOWN
                changed = True
                self.mon.cluster_log(
                    "warn", f"mds.{name} failed (no beacon for "
                    f"{grace:g}s)"
                )
                if was_active:
                    # the standby's in-memory table/journal view is as
                    # old as its boot; promote_standbys notifies it to
                    # resync for the failed rank BEFORE clients discover
                    # it (an ino handed out by the failed active must
                    # never be re-allocated)
                    self.promote_standbys(info["fs"])
        if changed:
            self.pending = True
            await self.mon.propose_pending()

    def _notify_takeover(self, name: str, addr: str) -> None:
        import asyncio

        from ceph_tpu_torch.msg.message import Message

        rank = int(self.mds.get(name, {}).get("rank", 0))

        async def _send():
            try:
                await self.mon.msgr.send_to(
                    addr, Message("mds_takeover",
                                  {"name": name, "rank": rank}),
                    f"mds.{name}",
                )
            except (ConnectionError, OSError):
                # backup path: the mds also resyncs when its beacon
                # acks report the standby->active transition
                pass

        asyncio.get_running_loop().create_task(_send())

    # -- health ------------------------------------------------------------
    def health_checks(self) -> dict[str, dict]:
        checks: dict[str, dict] = {}
        down = sorted(n for n, i in self.mds.items()
                      if i["state"] == STATE_DOWN)
        if down:
            checks["MDS_DOWN"] = {
                "severity": "HEALTH_WARN",
                "message": f"{len(down)} mds daemons down",
                "detail": [f"mds.{n} is down" for n in down],
            }
        for fs in self.filesystems:
            if not any(i["fs"] == fs and i["state"] == STATE_ACTIVE
                       for i in self.mds.values()):
                checks["FS_WITH_FAILED_MDS"] = {
                    "severity": "HEALTH_ERR",
                    "message": f"filesystem {fs!r} has no active mds",
                }
        return checks

    # -- commands ----------------------------------------------------------
    def _fs_pools_exist(self, meta: str, data: str) -> bool:
        names = {p.name for p in
                 self.mon.osd_monitor.osdmap.pools.values()}
        return meta in names and data in names

    def _fs_summary(self, fs: str) -> dict:
        """Per-fs member aggregation shared by 'mds stat' and
        'fs status' (one source of truth for rank/load reporting)."""
        members = {n: i for n, i in self.mds.items()
                   if i["fs"] == fs}
        return {
            "actives": sorted(
                ({"name": n, "addr": i["addr"],
                  "rank": int(i.get("rank", 0)),
                  "state": i["state"],
                  "load": round(self._loads.get(n, 0.0), 3)}
                 for n, i in members.items()
                 if i["state"] == STATE_ACTIVE),
                key=lambda a: a["rank"]),
            "standby": sorted(n for n, i in members.items()
                              if i["state"] == STATE_STANDBY),
            "down": sorted(n for n, i in members.items()
                           if i["state"] == STATE_DOWN),
            "max_mds": int(self.filesystems.get(fs, {}).get(
                "max_mds", 1)),
        }

    def preprocess_command(self, cmd: dict) -> CommandResult | None:
        name = cmd.get("prefix", "")
        if name == "fs ls":
            return CommandResult(data=[
                {"name": fs, **info}
                for fs, info in sorted(self.filesystems.items())
            ])
        if name == "fs status":
            # the `ceph fs status` operator summary: per-rank state
            # with the beacon-carried load (mds_bal load exchange);
            # DOWN daemons stay visible — hiding a failed rank from
            # the diagnostic command would defeat its purpose
            out = {}
            for fs in self.filesystems:
                s = self._fs_summary(fs)
                out[fs] = {
                    "ranks": [{"rank": a["rank"], "name": a["name"],
                               "state": a["state"],
                               "load": a["load"]}
                              for a in s["actives"]],
                    "standbys": s["standby"],
                    "down": s["down"],
                    "meta_pool": self.filesystems[fs].get(
                        "meta_pool", ""),
                    "data_pool": self.filesystems[fs].get(
                        "data_pool", ""),
                    "max_mds": s["max_mds"],
                }
            return CommandResult(data=out)
        if name == "mds stat":
            out = {}
            for fs in self.filesystems:
                s = self._fs_summary(fs)
                rank0 = next((a for a in s["actives"]
                              if a["rank"] == 0), None)
                out[fs] = {
                    # rank-0 kept under the legacy "active" key
                    "active": ({"name": rank0["name"],
                                "addr": rank0["addr"]}
                               if rank0 else None),
                    "actives": s["actives"],
                    "max_mds": s["max_mds"],
                    "standby": s["standby"],
                    "down": s["down"],
                }
            return CommandResult(data={"epoch": self.epoch,
                                       "filesystems": out})
        return None

    def prepare_command(self, cmd: dict, tx: StoreTransaction
                        ) -> CommandResult:
        name = cmd.get("prefix", "")
        if name == "fs new":
            fs = str(cmd.get("fs_name", ""))
            meta, data = str(cmd.get("metadata", "")), \
                str(cmd.get("data", ""))
            if not fs or not meta or not data:
                return CommandResult(
                    EINVAL_RC, "fs new <fs_name> <metadata> <data>"
                )
            if fs in self.filesystems:
                return CommandResult(EEXIST_RC, f"fs {fs!r} exists")
            if not self._fs_pools_exist(meta, data):
                return CommandResult(
                    ENOENT_RC, f"pools {meta!r}/{data!r} must exist"
                )
            self.filesystems[fs] = {
                "meta_pool": meta, "data_pool": data,
                "created": time.time(), "max_mds": 1,
            }
            self._stage(tx)
            return CommandResult(outs=f"filesystem {fs!r} created")
        if name == "fs set_max_mds":
            fs = str(cmd.get("fs_name", ""))
            if fs not in self.filesystems:
                return CommandResult(ENOENT_RC, f"no fs {fs!r}")
            try:
                n = int(cmd.get("max_mds", 1))
            except (TypeError, ValueError):
                return CommandResult(EINVAL_RC, "max_mds must be int")
            if not 1 <= n <= 16:
                return CommandResult(EINVAL_RC,
                                     "max_mds must be in [1, 16]")
            self.filesystems[fs]["max_mds"] = n
            self.promote_standbys(fs)
            self._stage(tx)
            return CommandResult(outs=f"fs {fs!r} max_mds = {n}")
        if name == "fs rm":
            fs = str(cmd.get("fs_name", ""))
            if fs not in self.filesystems:
                return CommandResult(ENOENT_RC, f"no fs {fs!r}")
            if any(i["fs"] == fs and i["state"] == STATE_ACTIVE
                   for i in self.mds.values()) \
                    and not cmd.get("force"):
                return CommandResult(
                    EINVAL_RC,
                    f"fs {fs!r} has an active mds (use force)"
                )
            del self.filesystems[fs]
            for info in self.mds.values():
                if info["fs"] == fs:
                    info["state"] = STATE_DOWN
            self._stage(tx)
            return CommandResult(outs=f"filesystem {fs!r} removed")
        return super().prepare_command(cmd, tx)
