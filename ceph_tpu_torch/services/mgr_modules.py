"""Mgr module framework: balancer, pg_autoscaler, progress.

Counterpart of ceph_tpu/services/mgr_modules.py: the same module over the
port's imports.

The reference manager embeds Python modules (src/mgr/ActivePyModules.cc;
src/pybind/mgr/*) that observe cluster maps/stats and act through mon
commands.  Here a module is an object the Mgr drives on its report
cycle: ``serve_once`` may issue mon commands (the balancer's upmap
moves), ``digest_contrib`` folds module state into the PGMap digest the
monitor persists (so ``ceph balancer status`` / ``ceph progress`` are
served mon-side), and ``health_checks`` raises module health warnings
(the pg_autoscaler's POOL_TOO_FEW_PGS).

Crash reporting (reference src/pybind/mgr/crash) lives mon-side in
MgrStatMonitor ("crash post/ls/info/archive" commands + RECENT_CRASH
health check); no mgr loop is needed for it.
"""

from __future__ import annotations

import time



class MgrModule:
    name = ""
    can_run = True

    def __init__(self, mgr):
        self.mgr = mgr

    async def serve_once(self) -> None:
        """One maintenance pass, called per mgr report cycle."""

    def digest_contrib(self) -> dict:
        """Extra digest sections (merged into the mgr report)."""
        return {}

    def health_checks(self) -> dict[str, dict]:
        return {}


class Balancer(MgrModule):
    """Upmap balancer: even out per-OSD PG counts.

    The reference balancer's upmap mode (src/pybind/mgr/balancer/
    module.py + OSDMap::calc_pg_upmaps): rank OSDs by PG-count
    deviation off the epoch-cached bulk table and propose a BATCH of
    ``osd pg-upmap-items`` remaps per cycle (up to ``max_moves``),
    re-ranking after each proposed move so every move targets the
    current extremes.  Batching is what converges a 200-OSD cluster in
    a handful of cycles instead of one-PG-per-cycle trickle; peering
    churn stays bounded by the batch cap.
    """

    name = "balancer"
    max_deviation = 1          # stop when max-min <= this
    max_moves = 8              # upmap proposals per cycle

    def __init__(self, mgr, active: bool = True):
        super().__init__(mgr)
        self.active = active
        self.last_optimize = ""
        self.optimizations = 0

    def _pg_distribution(self):
        """(pg counts per up-OSD, pg -> up set) over all pools.

        The full-map scan reads the map's OSDMapMapping cache (one
        vectorized rule evaluation per pool per epoch, shared with the
        OSDs' peering rescans); upmap/pg_temp overrides still apply per
        PG on top of the raw CRUSH rows."""
        m = self.mgr.monc.osdmap
        counts = {o: 0 for o, i in m.osds.items()
                  if i.up and i.in_cluster}
        placement = {}
        for pool in m.pools.values():
            raw_rows, lens = m.mapping().raw_rows(pool.pool_id)
            for ps in range(pool.pg_num):
                raw = raw_rows[ps, :int(lens[ps])]
                up = m.raw_row_to_up(pool.pool_id, ps,
                                     [int(o) for o in raw])
                placement[(pool.pool_id, ps)] = up
                for o in up:
                    if o in counts:
                        counts[o] += 1
        return counts, placement

    async def serve_once(self) -> None:
        if not self.active or self.mgr.monc.osdmap is None:
            return
        counts, placement = self._pg_distribution()
        if len(counts) < 2:
            return
        m = self.mgr.monc.osdmap
        moved: set[tuple[int, int]] = set()
        moves = 0
        while moves < self.max_moves:
            hot = max(counts, key=lambda o: counts[o])
            cold = min(counts, key=lambda o: counts[o])
            diff = counts[hot] - counts[cold]
            if diff <= self.max_deviation:
                if moves == 0:
                    self.last_optimize = "balanced"
                break
            if moves > 0 and diff < 2:
                # a further move would only swap the extremes, not
                # shrink the spread — stop the batch here
                break
            pgid = next(
                ((pid, ps) for (pid, ps), up in placement.items()
                 if hot in up and cold not in up
                 and (pid, ps) not in moved),
                None,
            )
            if pgid is None:
                break
            pid, ps = pgid
            up = placement[pgid]
            # hot may sit in the up set via an existing (a -> hot)
            # remap; rewriting that pair to (a -> cold) keeps one
            # hop per raw slot (appending (hot, cold) would be dead
            # weight: hot is not in the raw set)
            pairs = list(m.pg_upmap_items.get(pgid, []))
            for i, (frm, to) in enumerate(pairs):
                if to == hot:
                    pairs[i] = (frm, cold)
                    break
            else:
                pairs.append((hot, cold))
            r = await self.mgr.monc.command(
                "osd pg-upmap-items", pgid=f"{pid}.{ps}",
                mappings=[list(p) for p in pairs],
            )
            if r["rc"] != 0:
                break
            moved.add(pgid)
            moves += 1
            self.optimizations += 1
            self.last_optimize = (
                f"moved pg {pid}.{ps} osd.{hot} -> osd.{cold}"
                + (f" (+{moves - 1} more this cycle)" if moves > 1
                   else "")
            )
            # re-rank off the proposed state so the next move targets
            # the NEW extremes without a full re-scan
            counts[hot] -= 1
            counts[cold] += 1
            placement[pgid] = [cold if o == hot else o for o in up]

    def digest_contrib(self) -> dict:
        return {"balancer": {
            "active": self.active,
            "mode": "upmap",
            "optimizations": self.optimizations,
            "last_optimize": self.last_optimize,
        }}


class PGAutoscaler(MgrModule):
    """pg_num autoscaler (reference src/pybind/mgr/pg_autoscaler):
    the ideal PG count per pool is ~100 PGs per OSD spread over the
    pool's replicas/shards, rounded to a power of two.  Pools in
    warn mode (default) get health warnings; pools set to
    ``pg_autoscale_mode on`` are resized — pg_num first (a local
    split), then pgp_num (placement migration) once the split landed.
    """

    name = "pg_autoscaler"
    target_per_osd = 100
    MERGE_GRACE_S = 60.0        # operator merge window before catch-up

    def __init__(self, mgr):
        super().__init__(mgr)
        self._last_cmd: dict[tuple, int] = {}
        self._pgp_lag_since: dict[str, float] = {}

    def _cluster_busy(self) -> bool:
        digest = getattr(self.mgr, "last_digest", None) or {}
        if int(digest.get("degraded_objects", 0)):
            return True
        for state, count in (digest.get("pgs_by_state")
                             or {}).items():
            if count and any(tok in state for tok in
                             ("peering", "recovering", "backfill",
                              "degraded")):
                return True
        return False

    async def _apply(self, pool: str, var: str, val: int) -> None:
        if self._last_cmd.get((pool, var)) == int(val):
            return                  # waiting for the map to catch up
        self._last_cmd[(pool, var)] = int(val)
        try:
            await self.mgr.monc.command(
                "osd pool set", pool=pool, var=var, val=str(val))
        except (ConnectionError, TimeoutError):
            self._last_cmd.pop((pool, var), None)   # retry next cycle

    async def serve_once(self) -> None:
        """ACTIVE mode (pool pg_autoscale_mode=on): apply the
        recommendation the reference's module applies — grow pg_num
        stepwise (PG splitting is local while pgp_num trails), then
        advance pgp_num so placement follows."""
        m = self.mgr.monc.osdmap
        if m is None:
            return
        recs = self._recommendations()
        for pool in m.pools.values():
            if pool.pg_autoscale_mode != "on":
                continue
            pgp = pool.pgp_num or pool.pg_num
            if pgp < pool.pg_num:
                # pgp trailing pg_num is either our own split waiting
                # for its migration step OR an operator's merge
                # two-step in progress.  Finish our own immediately;
                # anything else gets a grace window (the merge shrinks
                # pg_num within it) before we assume an abandoned
                # split and finish the migration — this also survives
                # a mgr restart losing the in-memory intent.
                ours = self._last_cmd.get(
                    (pool.name, "pg_num")) == pool.pg_num
                if self._cluster_busy():
                    # a migration is in flight (possibly the merge's
                    # own fold step): never fight it, and restart the
                    # grace clock so it only burns while settled
                    self._pgp_lag_since[pool.name] = time.time()
                    continue
                first = self._pgp_lag_since.setdefault(
                    pool.name, time.time())
                if ours or time.time() - first > self.MERGE_GRACE_S:
                    await self._apply(pool.name, "pgp_num",
                                      pool.pg_num)
                continue
            self._pgp_lag_since.pop(pool.name, None)
            rec = recs.get(pool.name)
            if rec and rec["kind"] == "few":
                # bounded step: at most 4x per cycle keeps split +
                # migration churn digestible
                await self._apply(pool.name, "pg_num",
                                  min(rec["ideal"], pool.pg_num * 4))

    def _recommendations(self) -> dict[str, dict]:
        m = self.mgr.monc.osdmap
        if m is None:
            return {}
        n_osds = sum(1 for i in m.osds.values()
                     if i.up and i.in_cluster)
        if not n_osds:
            return {}
        out = {}
        for pool in m.pools.values():
            ideal = max(1, n_osds * self.target_per_osd // max(
                pool.size, 1))
            # round down to a power of two
            p2 = 1 << (ideal.bit_length() - 1)
            if pool.pg_num * 4 <= p2:
                out[pool.name] = {
                    "pg_num": pool.pg_num, "ideal": p2, "kind": "few"}
            elif pool.pg_num >= p2 * 8 and pool.pg_num > 32:
                out[pool.name] = {
                    "pg_num": pool.pg_num, "ideal": p2, "kind": "many"}
        return out

    def health_checks(self) -> dict[str, dict]:
        m = self.mgr.monc.osdmap
        modes = ({p.name: p.pg_autoscale_mode
                  for p in m.pools.values()} if m else {})
        recs = {n: r for n, r in self._recommendations().items()
                if modes.get(n, "warn") == "warn"}
        checks = {}
        few = {n: r for n, r in recs.items() if r["kind"] == "few"}
        if few:
            checks["POOL_TOO_FEW_PGS"] = {
                "severity": "HEALTH_WARN",
                "message": f"{len(few)} pools have too few PGs: " + ", ".join(
                    f"{n} ({r['pg_num']} < ideal {r['ideal']})"
                    for n, r in sorted(few.items())),
            }
        many = {n: r for n, r in recs.items() if r["kind"] == "many"}
        if many:
            checks["POOL_TOO_MANY_PGS"] = {
                "severity": "HEALTH_WARN",
                "message": f"{len(many)} pools have too many PGs: "
                + ", ".join(f"{n} ({r['pg_num']} > ideal {r['ideal']})"
                            for n, r in sorted(many.items())),
            }
        return checks

    def digest_contrib(self) -> dict:
        return {"pg_autoscale": self._recommendations()}


class Progress(MgrModule):
    """Recovery progress events (reference src/pybind/mgr/progress):
    when degraded objects appear, an event tracks the fraction healed;
    it completes when the count returns to zero."""

    name = "progress"

    def __init__(self, mgr):
        super().__init__(mgr)
        self._events: dict[str, dict] = {}
        self._peak = 0

    def observe_digest(self, digest: dict) -> None:
        degraded = int(digest.get("degraded_objects", 0))
        ev = self._events.get("recovery")
        if degraded > 0:
            self._peak = max(self._peak, degraded)
            if ev is None or "finished" in ev:
                ev = {"id": "recovery", "started": time.time()}
                self._events["recovery"] = ev
            ev["message"] = (
                f"Recovering degraded objects ({degraded} remaining)"
            )
            ev["progress"] = 1.0 - degraded / max(self._peak, 1)
        elif ev is not None:
            ev["message"] = "Recovery complete"
            ev["progress"] = 1.0
            ev["finished"] = time.time()
            self._peak = 0

    def digest_contrib(self) -> dict:
        return {"progress": sorted(
            self._events.values(), key=lambda e: e["id"]
        )}


class DeviceHealth(MgrModule):
    """Device health tracking (reference src/pybind/mgr/devicehealth at
    -lite scale): without SMART access, the observable failure signal
    is OSD up/down flapping and fullness — each daemon's transitions
    are counted and repeated flappers raise a health check (the
    life-expectancy warning role)."""

    name = "devicehealth"
    FLAP_WARN = 3

    def __init__(self, mgr):
        super().__init__(mgr)
        self._was_up: dict[int, bool] = {}
        self._flaps: dict[int, int] = {}
        self._last_down: dict[int, float] = {}

    async def serve_once(self) -> None:
        osdmap = self.mgr.monc.osdmap
        if osdmap is None:
            return
        for osd, info in sorted(osdmap.osds.items()):
            up = bool(info.up)
            was = self._was_up.get(osd)
            if was is True and not up:
                self._flaps[osd] = self._flaps.get(osd, 0) + 1
                self._last_down[osd] = time.time()
            self._was_up[osd] = up

    def digest_contrib(self) -> dict:
        devices = {}
        for osd in sorted(self._was_up):
            devices[str(osd)] = {
                "daemon": f"osd.{osd}",
                "up": self._was_up.get(osd, False),
                "flaps": self._flaps.get(osd, 0),
                "last_down": self._last_down.get(osd, 0.0),
            }
        return {"device_health": devices}

    def health_checks(self) -> dict[str, dict]:
        bad = sorted(o for o, n in self._flaps.items()
                     if n >= self.FLAP_WARN)
        if not bad:
            return {}
        return {"DEVICE_HEALTH_FLAPPING": {
            "severity": "HEALTH_WARN",
            "message": f"{len(bad)} devices flapping repeatedly",
            "detail": [f"osd.{o} went down "
                       f"{self._flaps[o]} times" for o in bad],
        }}


class Telemetry(MgrModule):
    """Anonymized cluster report (reference src/pybind/mgr/telemetry):
    aggregate counts only — no names, keys, or addresses — surfaced via
    ``telemetry show``.  Nothing is phoned home (zero egress); the
    report is what WOULD be sent."""

    name = "telemetry"

    def __init__(self, mgr):
        super().__init__(mgr)
        self._report: dict = {}

    def observe_digest(self, digest: dict) -> None:
        osdmap = self.mgr.monc.osdmap
        pools = digest.get("pools", {})
        self._report = {
            "report_timestamp": time.time(),
            "num_osds": len(osdmap.osds) if osdmap else 0,
            "num_pools": len(pools),
            "num_pgs": int(digest.get("num_pgs", 0)),
            "num_objects": int(digest.get("num_objects", 0)),
            "total_bytes": int(digest.get("num_bytes", 0)),
            "pool_types": sorted({
                p.pool_type
                for p in (osdmap.pools.values() if osdmap else ())
            }),
            "health_checks": sorted(
                digest.get("health_checks", {})),
        }

    def digest_contrib(self) -> dict:
        return {"telemetry": self._report}


class SnapSchedule(MgrModule):
    """Scheduled CephFS snapshots (reference pybind/mgr/snap_schedule):
    schedules live in the mon config-key store as
    ``snap_sched/<path>`` -> {"period": secs, "retain": n, "fs":
    name}; each report cycle takes due snapshots (``scheduled-<ts>``)
    and prunes beyond the retention count.  The module mounts the
    filesystem itself, as the reference module does through its own
    libcephfs handle."""

    name = "snap_schedule"

    def __init__(self, mgr):
        super().__init__(mgr)
        self._rados = None
        self._fs = None
        self._last: dict[str, float] = {}
        self._status: dict[str, dict] = {}

    async def _mount(self, fs_name: str):
        from ceph_tpu_torch.client.fs import CephFS
        from ceph_tpu_torch.client.rados import Rados

        if self._fs is not None and self._fs.fs_name == fs_name \
                and self._fs._mounted:
            return self._fs
        if self._fs is not None and self._fs._mounted:
            await self._fs.unmount()   # switching fs: no leaked session
        self._fs = None
        if self._rados is None:
            # the mgr's own entity: reuses its auth identity/key
            self._rados = Rados(self.mgr.monc.monmap, self.mgr.conf,
                                name=self.mgr.name)
            await self._rados.connect(timeout=10.0)
        fs = await CephFS.connect(self._rados, fs_name, timeout=5.0)
        try:
            await fs.mount(timeout=10.0)
        except BaseException:
            # connect installed a dispatcher link on the shared rados
            # messenger: unhook it, or failed attempts stack forever
            await fs.unmount()
            raise
        self._fs = fs
        return fs

    async def _drop_mount(self) -> None:
        """Forget the cached mount after an error: the next cycle
        re-discovers the active MDS from the FSMap, so a failover to a
        new address heals instead of erroring forever."""
        if self._fs is not None:
            try:
                await self._fs.unmount()
            except (ConnectionError, OSError):
                pass
            self._fs = None

    async def stop(self) -> None:
        if self._fs is not None and self._fs._mounted:
            await self._fs.unmount()
            self._fs = None
        if self._rados is not None:
            await self._rados.shutdown()
            self._rados = None

    async def serve_once(self) -> None:
        import asyncio
        import json

        from ceph_tpu_torch.client.fs import FSError

        try:
            r = await self.mgr.monc.command("config-key ls")
        except (ConnectionError, asyncio.TimeoutError):
            return
        if r.get("rc") != 0:
            return
        now = time.time()
        active: set[str] = set()
        for key in r["data"]:
            if not key.startswith("snap_sched/"):
                continue
            path = "/" + key[len("snap_sched/"):].lstrip("/")
            active.add(path)
            try:
                g = await self.mgr.monc.command("config-key get",
                                                key=key)
                if g.get("rc") != 0:
                    continue      # removed between ls and get
                spec = json.loads(g["data"])
            except (ConnectionError, asyncio.TimeoutError,
                    ValueError):
                continue
            period = float(spec.get("period", 3600.0))
            retain = int(spec.get("retain", 0))
            if period <= 0:
                self._status[path] = {"error": "non-positive period",
                                      "period": period}
                continue
            if now - self._last.get(path, 0.0) < period:
                continue
            try:
                fs = await self._mount(str(spec.get("fs", "cephfs")))
                await fs.mksnap(path, f"scheduled-{int(now * 1000)}")
                self._last[path] = now
                snaps = sorted(n for n in await fs.listsnaps(path)
                               if n.startswith("scheduled-"))
                if retain > 0:
                    for old in snaps[:-retain]:
                        await fs.rmsnap(path, old)
                    snaps = snaps[-retain:]
                self._status[path] = {
                    "last": now, "period": period, "retain": retain,
                    "scheduled_snaps": len(snaps),
                }
            except (FSError, ConnectionError, OSError,
                    asyncio.TimeoutError) as e:
                self._status[path] = {"error": str(e),
                                      "period": period}
                if not isinstance(e, FSError) or e.rc == -110:
                    # connection-shaped failure: drop the mount so
                    # the next cycle re-discovers the active MDS.  A
                    # plain op error (ENOENT path, EDQUOT, ...) keeps
                    # the healthy session for the remaining paths
                    await self._drop_mount()
        # a removed schedule must vanish from the status report too
        self._status = {p: s for p, s in self._status.items()
                        if p in active}

    def digest_contrib(self) -> dict:
        return {"snap_schedule": self._status}


class Insights(MgrModule):
    """Insights report (reference src/pybind/mgr/insights): accumulate
    health-check HISTORY — not just the instantaneous state — and fold
    a cluster report (health now + transitions seen, unarchived
    crashes, capacity summary) into the digest, so ``ceph insights``
    serves it mon-side like the other module surfaces."""

    name = "insights"
    MAX_HISTORY = 256

    def __init__(self, mgr):
        super().__init__(mgr)
        # check name -> {first_seen, last_seen, count, severity}
        self._history: dict[str, dict] = {}
        self._crashes: list[dict] = []

    async def serve_once(self) -> None:
        import asyncio

        try:
            r = await self.mgr.monc.command("crash ls")
        except (ConnectionError, asyncio.TimeoutError):
            return
        if r.get("rc") == 0:
            self._crashes = [c for c in r["data"]
                             if not c.get("archived")]

    def observe_digest(self, digest: dict) -> None:
        now = time.time()
        for check, info in (digest.get("health_checks")
                            or {}).items():
            h = self._history.setdefault(check, {
                "first_seen": now, "count": 0,
            })
            h["last_seen"] = now
            h["count"] += 1
            h["severity"] = info.get("severity", "HEALTH_WARN")
        while len(self._history) > self.MAX_HISTORY:
            oldest = min(self._history,
                         key=lambda c: self._history[c]["last_seen"])
            del self._history[oldest]

    def digest_contrib(self) -> dict:
        return {"insights": {
            "generated": time.time(),
            "health_history": self._history,
            "unarchived_crashes": [c.get("crash_id")
                                   for c in self._crashes[:20]],
            "crash_count": len(self._crashes),
        }}
