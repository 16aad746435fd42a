"""DevCluster: the in-process vstart.

Counterpart of ceph_tpu/vstart.py: the same module over the
port's imports.  Its one departure: ``DevCluster(device=)``, handed to
every OSD daemon it starts (None means CUDA, raising when there is none).
The MDS, manager and gateway starters keep their lazy imports of modules
the port has not yet (ROADMAP A12).

The reference's src/vstart.sh (1,554 LoC of shell) spins a dev cluster of
real daemons in a temp dir. Here one object boots monitors + OSDs inside
the current event loop — over ``local://`` queue transports by default or
real TCP sockets — hands out connected clients, and can kill/revive
daemons (the hooks the Thrasher drives). ``write_conf`` emits the
cluster-connection file the CLI reads.
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.client.rados import Rados
from ceph_tpu_torch.common.config import ConfigProxy
from ceph_tpu_torch.mon.monitor import Monitor
from ceph_tpu_torch.osd.daemon import OSDDaemon
from ceph_tpu_torch.store import FileStore, MemStore, ObjectStore, WalStore

FAST_TEST_OVERRIDES = {
    "mon_lease": 0.4, "mon_lease_interval": 0.1,
    "mon_election_timeout": 0.3, "mon_tick_interval": 0.1,
    "mon_accept_timeout": 0.5,
    # grace must tolerate a first-time XLA compile stalling the shared
    # in-process event loop; failure-detection tests override it
    "osd_heartbeat_interval": 0.2, "osd_heartbeat_grace": 3.0,
}

# Lightweight-OSD profile for hundreds of daemons in one process.
# Heartbeats are all-to-all (every OSD pings every up peer each
# interval, O(n²) messages): at 200 OSDs the fast-test 0.2 s interval
# would push ~200k pings/s through the shared event loop, so the scale
# profile stretches liveness timers instead of shrinking them, and
# turns off per-OSD background loops that add nothing to a control-
# plane drill (tiering agent; scrub is already opt-in).
SCALE_TEST_OVERRIDES = {
    "mon_lease": 2.0, "mon_lease_interval": 0.5,
    "mon_election_timeout": 1.0, "mon_tick_interval": 0.5,
    "mon_accept_timeout": 2.0,
    # fold each boot/failure burst into one map epoch instead of one
    # paxos round + full subscription fan-out per daemon
    "paxos_propose_interval": 0.25,
    "osd_heartbeat_interval": 5.0, "osd_heartbeat_grace": 60.0,
    # ring-subset heartbeats: the all-to-all mesh at 200 OSDs means
    # 40k connections (80k reader/writer tasks) in one event loop
    "osd_heartbeat_peer_limit": 8,
    "osd_agent_interval": 0.0,
    "osd_ec_resident": False,
    "osd_pg_log_max_entries": 32,
}


class DevCluster:
    def __init__(self, n_mons: int = 1, n_osds: int = 3,
                 overrides: dict | None = None, tcp: bool = False,
                 base_port: int = 21000, store_dir: str | None = None,
                 store_kind: str = "wal",
                 cephx: bool = False, ns: str = "",
                 monmap: dict[str, str] | None = None,
                 osds_per_host: int = 1,
                 scale: bool = False, boot_batch: int | None = None,
                 device=None):
        """``ns``: local:// address namespace prefix so several
        DevClusters (zones) can coexist in one process (the multi-zone
        / geo-replication test topology).  ``monmap``: explicit
        name->addr map overriding the generated one — the DR restart
        path boots a rebuilt cluster against a monmaptool-authored
        quorum this way.  ``osds_per_host``: pack that many OSDs onto
        each CRUSH host (host{id // osds_per_host}) so failure-domain
        host rules and whole-host failure drills have real topology.
        ``scale``: apply SCALE_TEST_OVERRIDES (lightweight-OSD profile
        for 200+ daemons) and boot OSDs in concurrent batches.
        ``boot_batch``: OSDs booted concurrently per wave in start();
        defaults to 16 under the scale profile, else 1 (sequential)."""
        self.n_mons = n_mons
        self.n_osds = n_osds
        self.device = device
        self.scale = scale
        self.boot_batch = (boot_batch if boot_batch is not None
                           else (32 if scale else 1))
        self.overrides = dict(FAST_TEST_OVERRIDES)
        if scale:
            self.overrides.update(SCALE_TEST_OVERRIDES)
        self.overrides.update(overrides or {})
        self.cephx = cephx
        if cephx:
            self.overrides.setdefault("auth_cluster_required", "cephx")
            self.overrides.setdefault("auth_admin_key",
                                      "devcluster-admin-secret")
        self._entity_keys: dict[str, str] = {}
        self.tcp = tcp
        self.base_port = base_port
        self.store_dir = store_dir
        self.store_kind = store_kind
        mon_names = [chr(ord("a") + i) for i in range(n_mons)]
        if tcp:
            self.monmap = {
                n: f"tcp://127.0.0.1:{base_port + i}"
                for i, n in enumerate(mon_names)
            }
        else:
            self.monmap = {n: f"local://{ns}mon.{n}" for n in mon_names}
        if monmap is not None:
            self.monmap = dict(monmap)
        self.ns = ns
        self.osds_per_host = max(1, int(osds_per_host))
        self.mons: dict[str, Monitor] = {}
        self.osds: dict[int, OSDDaemon] = {}
        self.mdss: dict[str, "object"] = {}
        self.mgrs: dict[str, "object"] = {}
        self.rgws: list["object"] = []
        self._osd_stores: dict[int, ObjectStore] = {}
        self._host_override: dict[int, str] = {}

    def conf(self) -> ConfigProxy:
        return ConfigProxy(overrides=dict(self.overrides))

    def conf_for(self, entity: str) -> ConfigProxy:
        """Per-entity config: under cephx, each daemon/client carries its
        own secret key (the keyring file role)."""
        o = dict(self.overrides)
        if self.cephx:
            if entity == "client.admin":
                o["auth_key"] = o["auth_admin_key"]
            elif entity in self._entity_keys:
                o["auth_key"] = self._entity_keys[entity]
        return ConfigProxy(overrides=o)

    def _osd_addr(self, osd_id: int) -> str | None:
        if self.tcp:
            return f"tcp://127.0.0.1:{self.base_port + 100 + osd_id}"
        return f"local://{self.ns}osd.{osd_id}" if self.ns else None

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        for name in self.monmap:
            await self.start_mon(name)
        if self.cephx:
            # bootstrap the keyring: admin mints each OSD's entity key
            # before its daemon boots (the ceph-authtool/cephadm role)
            admin = await self.client()
            for i in range(self.n_osds):
                r = await admin.mon_command(
                    "auth get-or-create", entity=f"osd.{i}",
                    caps={"mon": "allow r", "osd": "allow *"},
                )
                assert r["rc"] == 0, r
                self._entity_keys[f"osd.{i}"] = r["data"]["key"]
            await admin.shutdown()
        batch = max(1, self.boot_batch)
        for lo in range(0, self.n_osds, batch):
            ids = range(lo, min(lo + batch, self.n_osds))
            if batch == 1:
                await self.start_osd(lo)
            else:
                # concurrent boots coalesce into few map epochs: the
                # mon folds every boot that lands in one paxos round
                # into a single pending incremental
                await asyncio.gather(*(self.start_osd(i) for i in ids))

    def _make_osd_store(self, osd_id: int) -> ObjectStore:
        """With a store_dir, OSD data is durable and a revived OSD
        serves its pre-kill objects from disk; without one it is
        RAM-only (the MemStore dev default).  ``store_kind`` picks the
        durable tier: "wal" (RAM image + WAL/checkpoints) or "file"
        (fully disk-resident; capacity bounded by disk)."""
        if self.store_dir:
            base = f"{self.store_dir}/osd.{osd_id}"
            comp = str(self.conf()["store_compression_algorithm"]) \
                or None
            if self.store_kind == "file":
                return FileStore(base, compression=comp)
            return WalStore(base, compression=comp)
        return MemStore()

    async def start_osd(self, osd_id: int) -> OSDDaemon:
        entity = f"osd.{osd_id}"
        if self.cephx and entity not in self._entity_keys:
            # an OSD created after bootstrap (orchestrator scale-up,
            # tests adding daemons) mints its key on demand like
            # start_mds/start_mgr do
            admin = await self.client()
            try:
                r = await admin.mon_command(
                    "auth get-or-create", entity=entity,
                    caps={"mon": "allow r", "osd": "allow *"},
                )
                assert r["rc"] == 0, r
                self._entity_keys[entity] = r["data"]["key"]
            finally:
                await admin.shutdown()
        store = self._osd_stores.setdefault(
            osd_id, self._make_osd_store(osd_id)
        )
        osd = OSDDaemon(
            osd_id, self.monmap, self.conf_for(f"osd.{osd_id}"),
            store=store,
            addr=self._osd_addr(osd_id), host=self.host_of(osd_id),
            device=self.device,
        )
        await osd.start()
        self.osds[osd_id] = osd
        return osd

    async def start_mon(self, name: str) -> Monitor:
        """(Re)start one monitor over whatever its store directory
        holds — after a ``monstore_tool rebuild`` this is the DR
        restart path."""
        path = (f"{self.store_dir}/mon.{name}"
                if self.store_dir else None)
        mon = Monitor(name, self.monmap, self.conf(), store_path=path)
        await mon.start()
        self.mons[name] = mon
        return mon

    async def kill_mon(self, name: str) -> None:
        """Hard-stop one monitor; its store directory survives on disk
        for offline surgery (the kill-all-mons DR scenario driver)."""
        mon = self.mons.pop(name, None)
        if mon is not None:
            await mon.shutdown()

    async def kill_osd(self, osd_id: int) -> None:
        """Hard-stop a daemon; its store survives for revive (the
        Thrasher kill_osd hook, qa/tasks/ceph_manager.py:248). With a
        store_dir the in-RAM image is dropped too, so revive proves the
        on-disk WAL/checkpoint serves the data, not a lingering cache."""
        osd = self.osds.pop(osd_id, None)
        if osd is not None:
            await osd.shutdown()
        if self.store_dir:
            self._osd_stores.pop(osd_id, None)

    async def revive_osd(self, osd_id: int) -> OSDDaemon:
        """Restart with the surviving store (revive_osd :480)."""
        return await self.start_osd(osd_id)

    async def add_osd(self, host: str | None = None) -> int:
        """Expansion: provision and boot a brand-new OSD id, optionally
        on a brand-new CRUSH host (``prepare_boot`` auto-creates the
        host bucket from the boot host name, so growing the failure
        domain is just booting with a new host name).  Returns the new
        OSD id; the resulting map epoch remaps PGs and the backfill
        engine drains the planned motion."""
        osd_id = self.n_osds
        self.n_osds += 1
        if host is not None:
            self._host_override[osd_id] = host
        await self.start_osd(osd_id)
        return osd_id

    # -- host topology -----------------------------------------------------
    def host_of(self, osd_id: int) -> str:
        """CRUSH host name an OSD registers under."""
        return (self._host_override.get(osd_id)
                or f"host{osd_id // self.osds_per_host}")

    def osds_on_host(self, host: str) -> list[int]:
        """OSD ids placed on ``host`` (running or not)."""
        return [i for i in range(self.n_osds) if self.host_of(i) == host]

    async def kill_host(self, host: str) -> list[int]:
        """Hard-stop every OSD on one CRUSH host at once — the full-
        host-failure drill (rack power pull).  Returns the killed OSD
        ids so the driver can later revive them individually."""
        killed = []
        for osd_id in self.osds_on_host(host):
            if osd_id in self.osds:
                await self.kill_osd(osd_id)
                killed.append(osd_id)
        return killed

    async def start_mds(self, name: str = "a",
                        meta_pool: str = "cephfs_meta",
                        data_pool: str = "cephfs_data",
                        block_size: int = 1 << 22,
                        fs_name: str = "cephfs"):
        """Boot an MDS over existing pools (fs-new + mds boot). The
        pools must already exist; the filesystem is registered in the
        monitor's FSMap when not already present."""
        from ceph_tpu_torch.mds.daemon import MDSDaemon
        entity = f"client.mds.{name}"
        admin = await self.client()
        try:
            r = await admin.mon_command("fs new", fs_name=fs_name,
                                        metadata=meta_pool,
                                        data=data_pool)
            assert r["rc"] in (0, -17), r   # EEXIST on restart is fine
            if self.cephx and entity not in self._entity_keys:
                r = await admin.mon_command(
                    "auth get-or-create", entity=entity,
                    caps={"mon": "allow r", "osd": "allow *"},
                )
                assert r["rc"] == 0, r
                self._entity_keys[entity] = r["data"]["key"]
        finally:
            await admin.shutdown()
        addr = None
        if self.tcp:
            addr = (f"tcp://127.0.0.1:"
                    f"{self.base_port + 200 + len(self.mdss)}")
        mds = MDSDaemon(name, self.monmap, self.conf_for(entity),
                        addr=addr,
                        meta_pool=meta_pool, data_pool=data_pool,
                        block_size=block_size, fs_name=fs_name)
        await mds.start()
        self.mdss[name] = mds
        return mds

    async def start_mgr(self, name: str = "x",
                        report_interval: float = 0.2,
                        dashboard: bool = False,
                        dashboard_port: int = 0,
                        dashboard_token: str | None = None,
                        orchestrate: bool = False):
        """Boot a manager that aggregates OSD pg stats into the PGMap
        digest and pushes it to the mon (the mgr daemon role).
        ``dashboard``: also serve the read-only HTTP status page +
        /api/status + /metrics (mgr.dashboard holds (host, port)).
        ``orchestrate``: attach this DevCluster as the orchestrator
        backend (the cephadm role — ``ceph orch apply`` then really
        creates/removes daemons in this cluster)."""
        import asyncio

        from ceph_tpu_torch.services.mgr import Mgr
        entity = f"mgr.{name}"
        if self.cephx and entity not in self._entity_keys:
            admin = await self.client()
            r = await admin.mon_command(
                "auth get-or-create", entity=entity,
                caps={"mon": "allow *", "osd": "allow *"},
            )
            assert r["rc"] == 0, r
            self._entity_keys[entity] = r["data"]["key"]
            await admin.shutdown()
        mgr = Mgr(self.monmap, self.conf_for(entity), name=entity)
        if orchestrate:
            from ceph_tpu_torch.services.orchestrator import DevClusterBackend

            mgr.modules["orchestrator"].backend = \
                DevClusterBackend(self)
        await mgr.start()
        mgr._report_task = asyncio.get_running_loop().create_task(
            mgr.report_loop(report_interval)
        )
        if dashboard:
            from ceph_tpu_torch.services.dashboard import Dashboard

            dash = Dashboard(mgr, port=dashboard_port,
                             api_token=dashboard_token)
            mgr.dashboard = dash
            await dash.start()
        self.mgrs[name] = mgr
        return mgr

    async def start_rgw(self, pool: str = "rgw", port: int = 0,
                        host: str = "127.0.0.1",
                        cold_pool: str | None = None,
                        cold_class: str = "COLD",
                        cold_compression: str = "",
                        ec_k: int = 2, ec_m: int = 1):
        """Boot an S3 HTTP endpoint over ``pool`` (the radosgw daemon
        role): returns (frontend, users) — callers mint users
        through ``users`` and point any SigV4 client at the port.

        ``cold_pool``: also provision an ERASURE-CODED pool (profile
        jax_rs k/m over osd failure domains) and register it as
        storage class ``cold_class`` in the default placement target —
        the hot(replicated)/cold(EC) tiering layout lifecycle
        transitions move data across.  ``cold_compression``: inline
        compression for the cold class ("zlib"/"zstd"/...)."""
        from ceph_tpu_torch.services.rgw import RGWError, RGWLite, RGWUsers
        from ceph_tpu_torch.services.rgw_http import S3Frontend
        from ceph_tpu_torch.services.rgw_zone import ZonePlacement

        rados = await self.client()
        m = rados.monc.osdmap
        if pool not in [p.name for p in
                        (m.pools.values() if m else ())]:
            r = await rados.mon_command("osd pool create", pool=pool,
                                        pg_num=8)
            assert r["rc"] == 0, r
        ioctx = await rados.open_ioctx(pool)
        users = RGWUsers(ioctx)
        gw = RGWLite(ioctx, users=users,
                     gc_min_wait=float(
                         rados.conf["rgw_gc_obj_min_wait"]),
                     datalog_shards=int(
                         rados.conf["rgw_datalog_shards"]))
        if cold_pool:
            zp = ZonePlacement(ioctx)
            await zp.ensure_pool(cold_pool,
                                 ec_profile=f"rgw_{cold_pool}",
                                 ec_k=ec_k, ec_m=ec_m)
            try:
                await zp.add(storage_class=cold_class,
                             data_pool=cold_pool,
                             compression=cold_compression)
            except RGWError as e:
                # a restart re-registering the same class is fine
                if e.code != "InvalidArgument":
                    raise
        # restart recovery: spawn push workers for topics with queued
        # events so delivery never waits for new traffic
        await gw.start_push()
        fe = S3Frontend(gw, users=users, host=host, port=port)
        await fe.start()
        fe._rados = rados
        # stable daemon identity: list positions shift on removal, so
        # the orchestrator names rgw daemons by this monotonic id
        self._rgw_seq = getattr(self, "_rgw_seq", -1) + 1
        fe._orch_id = self._rgw_seq
        self.rgws.append(fe)
        # surface placement/lifecycle panels on any running dashboard
        for mgr in self.mgrs.values():
            dash = getattr(mgr, "dashboard", None)
            if dash is not None:
                dash.attach_rgw(gw)
        return fe, users

    async def stop(self) -> None:
        for fe in self.rgws:
            await fe.stop()
            await fe._rados.shutdown()
        self.rgws.clear()
        for mgr in list(self.mgrs.values()):
            task = getattr(mgr, "_report_task", None)
            if task is not None:
                task.cancel()
            await mgr.shutdown()
        self.mgrs.clear()
        for mds in list(self.mdss.values()):
            await mds.shutdown()
        self.mdss.clear()
        for osd in list(self.osds.values()):
            await osd.shutdown()
        self.osds.clear()
        for mon in self.mons.values():
            await mon.shutdown()
        self.mons.clear()

    # -- clients -----------------------------------------------------------
    async def client(self, name: str = "client.admin",
                     key: str | None = None) -> Rados:
        conf = self.conf_for(name)
        if key is not None:
            conf = ConfigProxy(overrides={
                **self.overrides, "auth_key": key,
            })
        rados = Rados(self.monmap, conf, name=name)
        await rados.connect()
        return rados

    async def wait_health_ok(self, timeout: float = 20.0) -> None:
        import asyncio
        # client.admin: the only entity guaranteed a key under cephx
        rados = await self.client()
        try:
            deadline = asyncio.get_running_loop().time() + timeout
            while True:
                r = await rados.mon_command("health")
                if r["rc"] == 0 and r["data"]["status"] == "HEALTH_OK":
                    return
                if asyncio.get_running_loop().time() > deadline:
                    raise TimeoutError(f"health never OK: {r['data']}")
                await asyncio.sleep(0.1)
        finally:
            await rados.shutdown()

    # -- CLI handoff -------------------------------------------------------
    def write_conf(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "monmap": self.monmap,
                "overrides": self.overrides,
            }, f, indent=2)


class MultisiteRealm:
    """N independent DevClusters as zones of one realm (the two-site
    production layout: each zone is its own failure domain with its own
    mons/OSDs/gateway, in one process under distinct ``local://``
    namespaces).

    Each zone keeps its OWN copy of the realm configuration (committed
    through its own RealmStore — reference multisite pulls realm config
    from the master, here the staging verbs run against every zone so a
    zone loss never loses the topology) and runs its OWN
    SyncOrchestrator scoped by ``local_zone``: every zone pulls only
    into itself, so a two-zone realm runs exactly one agent per side
    and a failover commit on any surviving store re-plans that side
    alone.  With ``with_mgr`` each zone also gets a mgr whose
    ``multisite`` module measures (lag ledger, ceph_rgw_sync_* gauges)
    and paces (replication QoS class) its zone's agents."""

    def __init__(self, zone_names=("a", "b"), realm: str = "earth",
                 zonegroup: str = "geo", n_mons: int = 1,
                 n_osds: int = 3, overrides: dict | None = None,
                 zone_overrides: dict | None = None,
                 store_dirs: dict | None = None,
                 with_mgr: bool = False,
                 mgr_report_interval: float = 0.2,
                 agent_kwargs: dict | None = None):
        self.zone_names = list(zone_names)
        assert self.zone_names, "a realm needs at least one zone"
        self.realm = realm
        self.zonegroup = zonegroup
        self.master = self.zone_names[0]
        self.n_mons = n_mons
        self.n_osds = n_osds
        self.overrides = dict(overrides or {})
        self.zone_overrides = dict(zone_overrides or {})
        self.store_dirs = dict(store_dirs or {})
        self.with_mgr = with_mgr
        self.mgr_report_interval = mgr_report_interval
        self.agent_kwargs = dict(agent_kwargs or {})
        # zone name -> {"cluster", "fe", "users", "gw", "rados",
        #               "store", "orch", "mgr"}
        self.zones: dict[str, dict] = {}

    async def start(self) -> "MultisiteRealm":
        from ceph_tpu_torch.services.rgw_zone import SyncOrchestrator

        for name in self.zone_names:
            await self._boot_zone(name)
        # the same staged topology, committed on EVERY zone's store
        for name in self.zone_names:
            store = self.zones[name]["store"]
            await store.realm_create(self.realm)
            await store.zonegroup_create(self.realm, self.zonegroup,
                                         master=True)
            for zname in self.zone_names:
                await store.zone_create(self.realm, self.zonegroup,
                                        zname,
                                        master=zname == self.master)
            await store.period_update(self.realm, commit=True)
        gateways = {n: z["gw"] for n, z in self.zones.items()}
        for name in self.zone_names:
            z = self.zones[name]
            orch = SyncOrchestrator(
                z["store"], self.realm, gateways,
                poll_interval=0.2, local_zone=name,
                agent_kwargs=self.agent_kwargs)
            await orch.start()
            z["orch"] = orch
            if z["mgr"] is not None:
                z["mgr"].modules["multisite"].attach(orch)
        return self

    async def _boot_zone(self, name: str,
                         monmap: dict | None = None) -> dict:
        from ceph_tpu_torch.services.rgw_zone import RealmStore

        cluster = DevCluster(
            n_mons=self.n_mons, n_osds=self.n_osds,
            ns=f"{name}-",
            overrides={**self.overrides,
                       **self.zone_overrides.get(name, {})},
            store_dir=self.store_dirs.get(name),
            monmap=monmap)
        await cluster.start()
        mgr = None
        if self.with_mgr:
            mgr = await cluster.start_mgr(
                report_interval=self.mgr_report_interval)
        fe, users = await cluster.start_rgw()
        z = {"cluster": cluster, "fe": fe, "users": users,
             "gw": fe.rgw, "rados": fe._rados,
             "store": RealmStore(fe.rgw.ioctx), "orch": None,
             "mgr": mgr}
        self.zones[name] = z
        return z

    async def revive_zone(self, name: str,
                          monmap: dict | None = None) -> dict:
        """Re-boot a dead zone over its durable store_dir and splice
        the fresh gateway handle into every survivor's orchestrator —
        persisted sync markers resume replication where it stopped.
        ``monmap``: override for DR restarts whose mon stores were
        rebuilt (monstore_tool + monmaptool recipe)."""
        from ceph_tpu_torch.services.rgw_zone import SyncOrchestrator

        z = await self._boot_zone(name, monmap=monmap)
        for other, oz in self.zones.items():
            if other != name and oz["orch"] is not None:
                await oz["orch"].set_gateway(name, z["gw"])
        # the revived zone's own realm copy predates any failover that
        # happened while it was down: re-commit the CURRENT topology
        # (a fresh MemStore zone needs the whole realm re-created)
        store = z["store"]
        if self.realm not in await store.realm_list():
            await store.realm_create(self.realm)
            await store.zonegroup_create(self.realm, self.zonegroup,
                                        master=True)
            for zname in self.zone_names:
                await store.zone_create(self.realm, self.zonegroup,
                                        zname)
        await store.zone_modify(self.realm, self.zonegroup,
                                self.master, master=True)
        await store.period_update(self.realm, commit=True)
        gateways = {n: zz["gw"] for n, zz in self.zones.items()}
        orch = SyncOrchestrator(
            store, self.realm, gateways, poll_interval=0.2,
            local_zone=name, agent_kwargs=self.agent_kwargs)
        await orch.start()
        z["orch"] = orch
        if z["mgr"] is not None:
            z["mgr"].modules["multisite"].attach(orch)
        # survivors' orchestrators plan pulls FROM the revived zone
        # against the fresh handle; the revived side pulls the backlog
        return z

    async def failover(self, to_zone: str,
                       survivors: list[str] | None = None) -> None:
        """Promote ``to_zone`` to master by staging + committing a new
        period on every surviving zone's own store (the dead zone's
        copy is unreachable and irrelevant — it re-learns on revive)."""
        names = survivors if survivors is not None else [
            n for n, z in self.zones.items() if z["orch"] is not None]
        for name in names:
            store = self.zones[name]["store"]
            await store.zone_modify(self.realm, self.zonegroup,
                                    to_zone, master=True)
            await store.period_update(self.realm, commit=True)
        self.master = to_zone

    async def lag(self) -> dict:
        """Replication backlog per zone: {zone: {"entries", "bytes"}}
        summed over the agents pulling INTO that zone."""
        out: dict[str, dict] = {}
        for name, z in self.zones.items():
            tot = {"entries": 0, "bytes": 0}
            orch = z["orch"]
            for agent in (orch.agents.values() if orch else ()):
                led = await agent.lag()
                tot["entries"] += led["entries"]
                tot["bytes"] += led["bytes"]
            out[name] = tot
        return out

    async def stop_zone(self, name: str) -> None:
        """Hard-stop one zone (the zone-loss event): its orchestrator
        and cluster die; survivors keep their agents (which now error
        against the dead source and back off)."""
        z = self.zones.get(name)
        if z is None:
            return
        if z["orch"] is not None:
            await z["orch"].stop()
            z["orch"] = None
        await z["cluster"].stop()

    async def stop(self) -> None:
        for name in list(self.zones):
            await self.stop_zone(name)
        self.zones.clear()
