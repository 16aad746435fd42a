"""RGW multisite configuration model: realm / zonegroup / zone / period.

Counterpart of ceph_tpu/services/rgw_zone.py: the same module over the
port's imports.

Reference src/rgw/rgw_zone.h (RGWRealm :918-921, RGWZoneGroup,
RGWZoneParams, RGWPeriod): multisite topology is not ad-hoc zone pairs
but a REALM whose configuration evolves through immutable, epoch-
numbered PERIODS.  Zonegroup/zone verbs stage changes; nothing takes
effect until ``period update --commit`` publishes a new period — the
unit gateways and sync agents reconfigure on, with no restarts.  The
commit bumps the realm epoch, links the new period to its predecessor,
and notifies the realm's control object so running daemons react
immediately (watch/notify; polling remains the fallback).

Storage (the ``.rgw.root`` pool role) in one pool:
- ``rgw.realms``                omap: realm name -> realm record
- ``rgw.realm.periods.<realm>`` omap: period id -> period record
- ``rgw.realm.staging.<realm>`` staged (uncommitted) topology json
- ``rgw.realm.ctl.<realm>``     watch/notify target for period commits

The SyncOrchestrator consumes periods: given gateway handles per zone,
it runs one RGWSyncAgent per secondary zone pulling from the
zonegroup's master, tearing down / spinning up agents as period
commits change the topology (rgw_period_pusher.cc + RGWRealmReloader
role).
"""

from __future__ import annotations

import asyncio
import json
import secrets
import time

from ceph_tpu_torch.client.rados import IoCtx, ObjectOperation, RadosError
from ceph_tpu_torch.common.events import emit_proc
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.services.rgw import RGWError

log = Dout("rgw-sync")

REALMS_OID = "rgw.realms"

# -- zone placement targets (rgw_zone.h RGWZonePlacementInfo) -------------
PLACEMENT_OID = "rgw.zone.placement"
DEFAULT_PLACEMENT = "default-placement"


class ZonePlacement:
    """Zone placement targets + per-class data pools (the reference's
    RGWZonePlacementInfo / rgw_placement_rule pair): a named placement
    maps each STORAGE CLASS to the RADOS pool its object tails live in,
    plus optional per-class inline compression.  STANDARD is implicit
    and resolves to the zone's own (replicated, hot) pool; COLD/
    ARCHIVE-style classes typically name an erasure-coded pool created
    from an EC profile, so every lifecycle transition into them drives
    bulk writes through the Objecter→ECBackend encode path.

    Stored as one omap object in the zone's pool:
    ``rgw.zone.placement``  omap: placement id -> placement record
    {"id", "storage_classes": {class: {"pool", "compression",
    "ec_profile"?}}}.  Administered via ``rgw-admin zone placement
    add/modify/rm/ls``."""

    def __init__(self, ioctx: IoCtx):
        self.ioctx = ioctx

    async def _all(self) -> dict[str, dict]:
        try:
            omap = await self.ioctx.get_omap(PLACEMENT_OID)
        except RadosError as e:
            if e.rc == -2:
                return {}
            raise
        return {k: json.loads(v) for k, v in omap.items()}

    async def get(self, placement_id: str = DEFAULT_PLACEMENT) -> dict:
        recs = await self._all()
        if placement_id not in recs:
            raise RGWError("NoSuchKey",
                           f"no placement {placement_id!r}")
        return recs[placement_id]

    async def ls(self) -> list[dict]:
        return [rec for _, rec in sorted((await self._all()).items())]

    async def _put(self, rec: dict) -> None:
        await self.ioctx.operate(
            PLACEMENT_OID, ObjectOperation().create().omap_set({
                rec["id"]: json.dumps(rec).encode(),
            }))

    @staticmethod
    def _check_class_name(storage_class: str) -> None:
        if not storage_class or not all(
                c.isalnum() or c in "_-" for c in storage_class):
            raise RGWError("InvalidStorageClass",
                           f"bad storage class {storage_class!r}")

    async def _set_class(self, placement_id: str, storage_class: str,
                         data_pool: str, compression: str,
                         ec_profile: str, ec_k: int, ec_m: int,
                         create_pool: bool, pg_num: int,
                         modify: bool) -> dict:
        from ceph_tpu_torch.common.compressor import list_compressors

        self._check_class_name(storage_class)
        if compression and compression not in list_compressors():
            raise RGWError("InvalidArgument",
                           f"unknown compression {compression!r}")
        if storage_class != "STANDARD" and not data_pool and not modify:
            raise RGWError("InvalidArgument",
                           f"storage class {storage_class!r} needs a "
                           "--data-pool (STANDARD alone rides the "
                           "zone's own pool)")
        recs = await self._all()
        rec = recs.get(placement_id) or {"id": placement_id,
                                         "storage_classes": {}}
        have = storage_class in rec["storage_classes"]
        if modify and not have:
            raise RGWError("NoSuchKey",
                           f"{placement_id!r} has no class "
                           f"{storage_class!r}")
        if not modify and have:
            raise RGWError("InvalidArgument",
                           f"class {storage_class!r} exists in "
                           f"{placement_id!r}; use modify")
        cls = dict(rec["storage_classes"].get(storage_class) or {})
        if data_pool or not modify:
            cls["pool"] = data_pool
        if compression or not modify:
            cls["compression"] = compression
        if ec_profile:
            cls["ec_profile"] = ec_profile
        if create_pool and cls.get("pool"):
            await self.ensure_pool(cls["pool"],
                                   ec_profile=cls.get("ec_profile", ""),
                                   ec_k=ec_k, ec_m=ec_m, pg_num=pg_num)
        rec["storage_classes"][storage_class] = cls
        await self._put(rec)
        return rec

    async def add(self, placement_id: str = DEFAULT_PLACEMENT,
                  storage_class: str = "STANDARD",
                  data_pool: str = "", compression: str = "",
                  ec_profile: str = "", ec_k: int = 2, ec_m: int = 1,
                  create_pool: bool = False, pg_num: int = 8) -> dict:
        """Add one storage class to a placement target (creating the
        placement on first use).  ``create_pool``: provision the data
        pool too — erasure-coded from ``ec_profile`` (created with
        k/m when absent) or replicated when no profile is named."""
        return await self._set_class(placement_id, storage_class,
                                     data_pool, compression,
                                     ec_profile, ec_k, ec_m,
                                     create_pool, pg_num, modify=False)

    async def modify(self, placement_id: str = DEFAULT_PLACEMENT,
                     storage_class: str = "STANDARD",
                     data_pool: str = "", compression: str = "",
                     ec_profile: str = "", ec_k: int = 2,
                     ec_m: int = 1, create_pool: bool = False,
                     pg_num: int = 8) -> dict:
        """Update an existing class; empty fields keep their value."""
        return await self._set_class(placement_id, storage_class,
                                     data_pool, compression,
                                     ec_profile, ec_k, ec_m,
                                     create_pool, pg_num, modify=True)

    async def rm(self, placement_id: str = DEFAULT_PLACEMENT,
                 storage_class: str | None = None) -> None:
        """Drop one storage class, or the whole placement target when
        no class is named.  The data pool itself is never deleted —
        objects already placed there must stay readable."""
        recs = await self._all()
        if placement_id not in recs:
            raise RGWError("NoSuchKey",
                           f"no placement {placement_id!r}")
        if storage_class is None:
            await self.ioctx.rm_omap_keys(PLACEMENT_OID,
                                          [placement_id])
            return
        rec = recs[placement_id]
        if storage_class not in rec["storage_classes"]:
            raise RGWError("NoSuchKey",
                           f"{placement_id!r} has no class "
                           f"{storage_class!r}")
        del rec["storage_classes"][storage_class]
        await self._put(rec)

    async def resolve(self, storage_class: str,
                      placement_id: str = DEFAULT_PLACEMENT) -> dict:
        """{"pool", "compression"} for a storage class.  STANDARD
        always resolves (zone pool, no forced compression) even with
        no placement configured; any other class must be registered or
        the caller gets InvalidStorageClass — exactly what a PUT with
        a bogus x-amz-storage-class should see."""
        if storage_class == "STANDARD":
            try:
                rec = await self.get(placement_id)
                cls = rec["storage_classes"].get("STANDARD")
            except RGWError:
                cls = None
            return dict(cls) if cls else {"pool": "", "compression": ""}
        try:
            rec = await self.get(placement_id)
        except RGWError:
            raise RGWError("InvalidStorageClass",
                           f"no placement target defines "
                           f"{storage_class!r}") from None
        cls = rec["storage_classes"].get(storage_class)
        if cls is None:
            raise RGWError("InvalidStorageClass",
                           f"{placement_id!r} does not define "
                           f"{storage_class!r}")
        return dict(cls)

    async def ensure_pool(self, pool: str, ec_profile: str = "",
                          ec_k: int = 2, ec_m: int = 1,
                          pg_num: int = 8) -> None:
        """Provision a class's data pool when absent: erasure-coded
        from ``ec_profile`` (set from k/m if the profile is new) or
        replicated otherwise — the same mon plumbing vstart uses."""
        rados = self.ioctx.rados
        if pool in await rados.list_pools():
            return
        kw: dict = {"pg_num": pg_num}
        if ec_profile:
            r = await rados.mon_command(
                "osd erasure-code-profile set", name=ec_profile,
                profile={"plugin": "jax_rs", "k": str(ec_k),
                         "m": str(ec_m),
                         "crush-failure-domain": "osd"})
            if r["rc"] not in (0, -17):
                raise RGWError("InvalidArgument",
                               f"ec profile {ec_profile!r}: "
                               f"{r.get('outs', r['rc'])}")
            kw.update(pool_type="erasure",
                      erasure_code_profile=ec_profile)
        await rados.pool_create(pool, **kw)


def _empty_topology() -> dict:
    return {"zonegroups": {}}


class RealmStore:
    """Realm/zonegroup/zone/period verbs over one config pool."""

    def __init__(self, ioctx: IoCtx):
        self.ioctx = ioctx

    @staticmethod
    def _periods_oid(realm: str) -> str:
        return f"rgw.realm.periods.{realm}"

    @staticmethod
    def _staging_oid(realm: str) -> str:
        return f"rgw.realm.staging.{realm}"

    @staticmethod
    def ctl_oid(realm: str) -> str:
        return f"rgw.realm.ctl.{realm}"

    # -- realms -----------------------------------------------------------
    async def realm_create(self, name: str) -> dict:
        if not name or "/" in name:
            raise RGWError("InvalidArgument", f"bad realm name {name!r}")
        if name in await self.realm_list():
            raise RGWError("InvalidArgument", f"realm {name!r} exists")
        rec = {
            "id": secrets.token_hex(8), "name": name,
            "current_period": "", "epoch": 0,
        }
        await self.ioctx.operate(REALMS_OID, ObjectOperation()
                                 .create()
                                 .omap_set({name: json.dumps(
                                     rec).encode()}))
        await self.ioctx.operate(self._staging_oid(name),
                                 ObjectOperation().create()
                                 .write_full(json.dumps(
                                     _empty_topology()).encode()))
        await self.ioctx.operate(self.ctl_oid(name),
                                 ObjectOperation().create())
        return rec

    async def realm_list(self) -> list[str]:
        try:
            return sorted(await self.ioctx.get_omap(REALMS_OID))
        except RadosError as e:
            if e.rc == -2:
                return []
            raise

    async def realm_get(self, name: str) -> dict:
        try:
            kv = await self.ioctx.get_omap(REALMS_OID, [name])
        except RadosError as e:
            if e.rc == -2:
                kv = {}
            else:
                raise
        if name not in kv:
            raise RGWError("NoSuchKey", f"no realm {name!r}")
        return json.loads(kv[name])

    async def _realm_put(self, rec: dict) -> None:
        await self.ioctx.set_omap(REALMS_OID, {
            rec["name"]: json.dumps(rec).encode(),
        })

    # -- staged topology --------------------------------------------------
    async def _staging(self, realm: str) -> dict:
        await self.realm_get(realm)
        try:
            raw = await self.ioctx.read(self._staging_oid(realm))
        except RadosError as e:
            if e.rc != -2:
                raise
            return _empty_topology()
        return json.loads(raw) if raw else _empty_topology()

    async def _stage(self, realm: str, topo: dict) -> None:
        await self.ioctx.operate(
            self._staging_oid(realm),
            ObjectOperation().write_full(json.dumps(topo).encode()),
        )

    async def zonegroup_create(self, realm: str, name: str,
                               master: bool = False) -> dict:
        topo = await self._staging(realm)
        if name in topo["zonegroups"]:
            raise RGWError("InvalidArgument",
                           f"zonegroup {name!r} exists")
        zg = {"name": name, "master": bool(master),
              "master_zone": "", "zones": {}}
        if master:
            for other in topo["zonegroups"].values():
                other["master"] = False
        topo["zonegroups"][name] = zg
        await self._stage(realm, topo)
        return zg

    async def zonegroup_list(self, realm: str) -> list[str]:
        return sorted((await self._staging(realm))["zonegroups"])

    async def zone_create(self, realm: str, zonegroup: str, name: str,
                          endpoint: str = "",
                          master: bool = False) -> dict:
        topo = await self._staging(realm)
        zg = topo["zonegroups"].get(zonegroup)
        if zg is None:
            raise RGWError("NoSuchKey",
                           f"no zonegroup {zonegroup!r}")
        for other in topo["zonegroups"].values():
            if name in other["zones"]:
                raise RGWError("InvalidArgument",
                               f"zone {name!r} exists")
        zone = {"name": name, "endpoint": endpoint}
        zg["zones"][name] = zone
        if master or not zg["master_zone"]:
            zg["master_zone"] = name
        await self._stage(realm, topo)
        return zone

    async def zone_modify(self, realm: str, zonegroup: str, name: str,
                          endpoint: str | None = None,
                          master: bool | None = None) -> dict:
        topo = await self._staging(realm)
        zg = topo["zonegroups"].get(zonegroup)
        if zg is None or name not in zg["zones"]:
            raise RGWError("NoSuchKey", f"no zone {name!r}")
        if endpoint is not None:
            zg["zones"][name]["endpoint"] = endpoint
        if master:
            zg["master_zone"] = name
        await self._stage(realm, topo)
        return zg["zones"][name]

    async def zone_rm(self, realm: str, zonegroup: str,
                      name: str) -> None:
        topo = await self._staging(realm)
        zg = topo["zonegroups"].get(zonegroup)
        if zg is None or name not in zg["zones"]:
            raise RGWError("NoSuchKey", f"no zone {name!r}")
        if zg["master_zone"] == name:
            raise RGWError("InvalidArgument",
                           "cannot remove the master zone; promote "
                           "another first")
        del zg["zones"][name]
        await self._stage(realm, topo)

    # -- periods ----------------------------------------------------------
    async def period_update(self, realm: str,
                            commit: bool = False) -> dict:
        """Staged topology -> a NEW period; with ``commit`` it becomes
        the realm's current period (epoch += 1) and the realm control
        object is notified so live daemons reconfigure (the reference's
        period commit + RGWRealmNotify)."""
        rec = await self.realm_get(realm)
        topo = await self._staging(realm)
        masters = [zg for zg in topo["zonegroups"].values()
                   if zg["zones"]]
        if commit and not masters:
            raise RGWError("InvalidArgument",
                           "cannot commit an empty period")
        period = {
            "id": secrets.token_hex(8),
            "realm": realm,
            "epoch": rec["epoch"] + 1,
            "predecessor": rec["current_period"],
            "staged_at": time.time(),
            "committed": bool(commit),
            "topology": topo,
        }
        await self.ioctx.operate(
            self._periods_oid(realm),
            ObjectOperation().create().omap_set({
                period["id"]: json.dumps(period).encode(),
            }),
        )
        if commit:
            rec["current_period"] = period["id"]
            rec["epoch"] = period["epoch"]
            await self._realm_put(rec)
            try:
                await self.ioctx.notify(
                    self.ctl_oid(realm),
                    json.dumps({"period": period["id"],
                                "epoch": period["epoch"]}).encode(),
                    timeout=2.0)
            except RadosError:
                pass        # no watchers yet: polling catches up
        return period

    async def period_get(self, realm: str,
                         period_id: str | None = None) -> dict:
        """A period by id, or the realm's CURRENT committed period."""
        if period_id is None:
            rec = await self.realm_get(realm)
            period_id = rec["current_period"]
            if not period_id:
                raise RGWError("NoSuchKey",
                               f"realm {realm!r} has no committed "
                               "period")
        try:
            kv = await self.ioctx.get_omap(self._periods_oid(realm),
                                           [period_id])
        except RadosError as e:
            if e.rc == -2:
                kv = {}
            else:
                raise
        if period_id not in kv:
            raise RGWError("NoSuchKey", f"no period {period_id!r}")
        return json.loads(kv[period_id])

    async def period_list(self, realm: str) -> list[dict]:
        try:
            omap = await self.ioctx.get_omap(self._periods_oid(realm))
        except RadosError as e:
            if e.rc == -2:
                return []
            raise
        return sorted((json.loads(v) for v in omap.values()),
                      key=lambda p: p["epoch"])


class SyncOrchestrator:
    """Runs the sync topology a committed period describes.

    ``gateways`` maps zone name -> RGWLite handle (each zone is a
    pool/cluster of its own; the handle is its data plane).  For every
    zonegroup, each non-master zone gets one RGWSyncAgent pulling from
    the master zone.  A period commit (watch/notify on the realm ctl
    object, or the poll fallback) atomically re-plans: agents for
    removed zones stop, new zones start, unchanged pairs keep their
    markers (sync positions live on the secondary, so replans lose
    nothing).

    ``local_zone`` scopes the orchestrator to one zone's point of
    view: only agents PULLING INTO that zone are run (each zone's own
    orchestrator replicates into itself, so a two-zone realm runs one
    agent per side instead of every side running both).  ``None``
    keeps the omniscient single-process behavior.  ``agent_kwargs``
    pass through to every spawned RGWSyncAgent (poll_interval, trim,
    seed)."""

    def __init__(self, store: RealmStore, realm: str,
                 gateways: dict, poll_interval: float = 0.5,
                 local_zone: str | None = None,
                 agent_kwargs: dict | None = None):
        from ceph_tpu_torch.services.rgw_sync import RGWSyncAgent

        self._agent_cls = RGWSyncAgent
        self.store = store
        self.realm = realm
        self.gateways = dict(gateways)
        self.poll_interval = poll_interval
        self.local_zone = local_zone
        self.agent_kwargs = dict(agent_kwargs or {})
        self.period_id: str | None = None
        self.agents: dict[tuple[str, str], object] = {}
        self._masters: dict[str, str] = {}
        self._task: asyncio.Task | None = None
        self._watch = None
        self._kick = asyncio.Event()
        self._stopped = False

    async def start(self) -> None:
        try:
            self._watch = await self.store.ioctx.watch(
                self.store.ctl_oid(self.realm), self._notified)
        except RadosError:
            self._watch = None           # polling only
        self._task = asyncio.get_running_loop().create_task(
            self._run())

    async def _notified(self, payload: bytes) -> bytes | None:
        self._kick.set()
        return b"ack"

    async def _run(self) -> None:
        while not self._stopped:
            try:
                await self._maybe_replan()
            except (RGWError, RadosError, ConnectionError) as e:
                log.derr("orchestrator replan failed: %s", e)
            try:
                await asyncio.wait_for(self._kick.wait(),
                                       self.poll_interval)
            except asyncio.TimeoutError:
                pass
            except asyncio.CancelledError:
                return
            self._kick.clear()

    async def _maybe_replan(self) -> None:
        try:
            period = await self.store.period_get(self.realm)
        except RGWError:
            return                       # nothing committed yet
        if period["id"] == self.period_id:
            return
        await self._apply(period)

    async def _apply(self, period: dict) -> None:
        want: dict[tuple[str, str], tuple] = {}
        for zgname, zg in period["topology"]["zonegroups"].items():
            master = zg.get("master_zone")
            old = self._masters.get(zgname)
            if master:
                if old and old != master:
                    # promotion: the period commit just moved the
                    # write master — the RTO clock's visible edge
                    emit_proc("sync.failover", realm=self.realm,
                              zonegroup=zgname, old_master=old,
                              new_master=master, period=period["id"])
                self._masters[zgname] = master
            if not master or master not in self.gateways:
                continue
            for zname in zg["zones"]:
                if zname == master or zname not in self.gateways:
                    continue
                if (self.local_zone is not None
                        and zname != self.local_zone):
                    continue
                want[(master, zname)] = (self.gateways[master],
                                        self.gateways[zname])
        # stop agents the new period no longer wants
        for pair in [p for p in self.agents if p not in want]:
            await self.agents.pop(pair).stop()
        # start the new ones
        for pair, (src, dst) in want.items():
            if pair not in self.agents:
                agent = self._agent_cls(src, dst,
                                        src_zone=pair[0],
                                        dst_zone=pair[1],
                                        **self.agent_kwargs)
                agent.start()
                self.agents[pair] = agent
        self.period_id = period["id"]
        log.dout(1, "realm %s now at period %s (%d sync agents)",
                 self.realm, period["id"], len(self.agents))

    async def set_gateway(self, zone: str, gw) -> None:
        """Swap the handle for a (re)started zone: every agent touching
        the zone stops, the next replan respawns it against the new
        handle, and the persisted markers resume it where it left off
        (a revived zone rejoins sync without operator surgery)."""
        stop = [p for p in self.agents if zone in p]
        for pair in stop:
            await self.agents.pop(pair).stop()
        self.gateways[zone] = gw
        self.period_id = None          # force re-apply on next cycle
        self._kick.set()

    def status(self) -> dict:
        """Per-agent sync status keyed "src->dst" (the mgr multisite
        module and ``rgw-admin sync status`` both serve this)."""
        return {
            "realm": self.realm,
            "period": self.period_id,
            "local_zone": self.local_zone,
            "agents": {f"{s}->{d}": a.status()
                       for (s, d), a in sorted(self.agents.items())
                       if hasattr(a, "status")},
        }

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        for agent in self.agents.values():
            await agent.stop()
        self.agents = {}
        if self._watch is not None:
            try:
                await self.store.ioctx.unwatch(self._watch)
            except RadosError:
                pass
