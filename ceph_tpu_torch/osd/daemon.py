"""OSD daemon: boot, heartbeats, op dispatch, peering, recovery.

Counterpart of ceph_tpu/osd/daemon.py: the same module over the
port's imports, on a torch device.  Its departures: ``OSDDaemon(device=)``
names the device of every primary PG's codec and of the resident shard
cache (None means CUDA, raising when there is none; ``"cpu"`` only when
asked for); the encode variant is set through ``ec.cuda_kernels``; and the
multi-device data planes (``osd_ec_mesh_cs``, ``osd_ec_mesh_coalesce``, a
sharded resident cache) take the device pool from
``parallel.mesh.local_devices(device)`` in place of ``jax.devices()``.

The role of reference src/osd/OSD.{h,cc} + PrimaryLogPG.cc in one async
daemon: boot registers with the monitor (OSD::init, OSD.cc:3283 ->
MOSDBoot), map subscriptions drive PG intervals, peer heartbeats feed
failure reports (handle_osd_ping OSD.cc:5236 -> MOSDFailure), client ops
dispatch to the primary's op interpreter (do_osd_ops, PrimaryLogPG.cc:5652)
and fan out to replicas/shards as sub-ops (MOSDRepOp / MOSDECSubOpWrite),
and recovery rebuilds stale shards after peering.

TPU-native shape: the EC hot path is ONE batched device encode per write
via ECBackend (ceph_tpu.osd.ec_backend); the daemon is pure host-side
orchestration around it.
"""

from __future__ import annotations

import asyncio
import bisect
import json
import random
import time
from collections import deque
from typing import Mapping

import hashlib
import hmac as hmac_mod
import secrets as secrets_mod

from ceph_tpu_torch.common import failpoint as fp
from ceph_tpu_torch.common.events import EventJournal
from ceph_tpu_torch.common.lockdep import DLock
from ceph_tpu_torch.common.config import ConfigProxy
from ceph_tpu_torch.common.crc32c import crc32c
from ceph_tpu_torch.mon.auth_monitor import canonical, cap_allows, verify_ticket
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.common.perf import CounterType, PerfCounters
from ceph_tpu_torch.common.tracing import (
    SpanCtx,
    Tracer,
    current_span,
    reply_trace,
    use_span,
)
from ceph_tpu_torch.ec.engine import resolve_device
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.msg.codec import encode
from ceph_tpu_torch.msg.message import PRIO_HIGH, Message
from ceph_tpu_torch.msg.messenger import Connection, Messenger, Policy
from ceph_tpu_torch.osd.ec_backend import (
    HINFO_ATTR,
    VERSION_ATTR,
    ECBackend,
    ECWriteDegraded,
    LocalShard,
    ShardReadError,
)
from ceph_tpu_torch.osd.codes import (
    EAGAIN_RC,
    EPERM_RC,
    EINVAL_RC,
    EIO_RC,
    ENOENT_RC,
    ENOTSUP_RC,
    ESTALE_RC,
    EBLOCKLISTED_RC,
    EDQUOT_RC,
    MISDIRECTED_RC,
    OK,
    READ_CLASS_OPS,
    READ_OPS,
)
from ceph_tpu_torch.osd.osd_map import NO_OSD, OSDMap
from ceph_tpu_torch.osd import pg_log, snaps
from ceph_tpu_torch.osd.op_tracker import OpTracker
from ceph_tpu_torch.osd.scheduler import MClockScheduler
from ceph_tpu_torch.osd.pg import (
    STATE_ACTIVE,
    STATE_INCOMPLETE,
    STATE_PEERING,
    STATE_RECOVERING,
    MissingSet,
    PG,
    PGId,
    PeerInfo,
    object_to_ps,
    split_parent,
)
from ceph_tpu_torch.osd.pg_log import (
    OP_DELETE,
    OP_MODIFY,
    LogEntry,
    latest_per_object,
)
from ceph_tpu_torch.services.cls import ClassRegistry, ClsContext, ClsError
from ceph_tpu_torch.store import CollectionId, GHObject, MemStore, ObjectStore
from ceph_tpu_torch.store import Transaction as StoreTx
from ceph_tpu_torch.store.txcodec import (
    dec_cid as _dec_cid,
    decode_tx,
    enc_cid as _enc_cid,
    encode_tx,
)

log = Dout("osd")

# process-wide EC data-plane meshes (cs -> jax Mesh): jax devices are a
# process resource, so every OSD in one test process shares the mesh
_EC_MESH_CACHE: dict[int, object] = {}

# the active trace span of the op being executed on this task lives in
# common.tracing's shared contextvar (current_span/use_span): sub-op
# fan-out, the EC coalescer, and the messenger all read it there

XATTR_PREFIX = "_u_"          # user xattrs, kept clear of internal attrs

# read-class client ops (no mutation): ONE definition for the dedup
# cache policy, the replay path, perf counters, and caps enforcement
_CAPS_READ_OPS = READ_CLASS_OPS
# space-reclaiming ops stay allowed on a FULL_QUOTA pool: blocking
# deletes would make a full pool unrecoverable (the reference exempts
# delete-class ops the same way).  Ops carrying the "full_try" wire
# flag (CEPH_OSD_FLAG_FULL_TRY — RGW delete flows whose sideband
# writes net-reclaim space) bypass the quota check entirely.
_QUOTA_EXEMPT_OPS = frozenset({"remove", "delete", "omap_rm",
                               "rmxattr"})

# message types the embedded MonClient owns
_MON_TYPES = {
    "auth_challenge", "auth_reply", "auth_bad", "mon_command_reply",
    "osd_map", "config", "mon_map",
}


class DeadShard:
    """ShardIO for an acting-set hole (NO_OSD): every IO fails so the
    EC backend reconstructs around it."""

    is_dead = True          # an acting hole, not a live-member failure

    def __init__(self, shard: int):
        self.shard = shard

    async def _fail(self, *a, **kw):
        raise ShardReadError(f"shard {self.shard} has no osd")

    write_shard = read_shard = get_attr = remove_shard = stat_shard = _fail


class NetworkShard:
    """ShardIO over sub-ops to a peer OSD (the MOSDECSubOpWrite/Read fan-
    out, reference ECBackend.cc:2090/1010)."""

    def __init__(self, daemon: "OSDDaemon", osd: int, cid: CollectionId):
        self.daemon = daemon
        self.osd = osd
        self.cid = cid

    async def _sub(self, kind: str, **args):
        return await self.daemon.send_sub_op(
            self.osd, kind, cid=_enc_cid(self.cid), **args
        )

    async def write_shard(self, oid, offset, data, attrs, log=None):
        await self._sub("write", oid=oid, off=offset, data=bytes(data),
                        attrs={k: bytes(v) for k, v in attrs.items()},
                        log=log.to_wire() if log is not None else None)

    async def read_shard(self, oid, offset=0, length=None):
        return await self._sub("read", oid=oid, off=offset, len=length)

    async def get_attr(self, oid, name):
        return await self._sub("getattr", oid=oid, name=name)

    async def get_attrs(self, oid):
        return await self._sub("getattrs", oid=oid)

    async def remove_shard(self, oid, log=None):
        await self._sub("remove", oid=oid,
                        log=log.to_wire() if log is not None else None)

    async def stat_shard(self, oid):
        return await self._sub("stat", oid=oid)


class OSDDaemon:
    def __init__(self, osd_id: int, monmap: dict[str, str],
                 conf: ConfigProxy | None = None,
                 store: ObjectStore | None = None,
                 addr: str | None = None, host: str = "",
                 device=None):
        self.osd_id = osd_id
        self.device = resolve_device(device)
        self.entity = f"osd.{osd_id}"
        self.conf = conf or ConfigProxy()
        self.store = store or MemStore()
        self.addr = addr or f"local://{self.entity}"
        self.host = host or f"host-{osd_id}"
        self.msgr = Messenger(self.entity, self.conf)
        self.msgr.set_policy("mon", Policy.lossy_client())
        self.msgr.set_policy("client", Policy.stateless_server())
        self.msgr.set_dispatcher(self)
        self.monc = MonClient(self.entity, monmap, self.conf,
                              msgr=self.msgr)
        self.monc.on_osdmap = self._on_map
        self.osdmap: OSDMap | None = None
        self.pgs: dict[PGId, PG] = {}
        self._sub_tid = 0
        # sub-op tid -> (reply future, target osd); the target lets a
        # new map fail the wait the moment it marks that osd down
        self._sub_futures: dict[int, tuple[asyncio.Future, int]] = {}
        # cache-tier client state (this OSD as a client of base pools)
        self._tier_tid = 0
        self._tier_seq = 0
        self._tier_futs: dict[int, asyncio.Future] = {}
        self._tier_promoting: dict[tuple, asyncio.Future] = {}
        self._tier_authed: set[int] = set()
        self._ungate_tasks: set[asyncio.Task] = set()
        self._tier_auth_state: dict[int, dict] = {}
        self.tracer = Tracer(self.entity)
        # flight recorder: always-on bounded ring of structured events
        # (map installs, PG transitions, queue-depth samples, ...) —
        # the forensic substrate every capture snapshots from
        self.journal = EventJournal(
            self.entity, size=int(self.conf["event_journal_size"]))
        # op-LIFETIME memory bound on client payloads (the reference's
        # osd_client_message_size_cap throttle): held from op arrival to
        # completion, so a flood backpressures instead of ballooning RAM
        from ceph_tpu_torch.common.throttle import Throttle

        self.client_throttle = Throttle(
            "osd-client-bytes", self.conf["osd_client_message_size_cap"]
        )
        # heartbeat state: peer -> last reply time
        self._hb_last_rx: dict[int, float] = {}
        self._hb_first_tx: dict[int, float] = {}
        self._tasks: list[asyncio.Task] = []
        self._stopped = False
        # merge deferral retry (one in flight; _scan_pgs serialized)
        self._merge_retry_pending = False
        self._scan_lock = asyncio.Lock()
        # pool_id -> PoolTables snapshot from the last COMPLETED scan:
        # the next scan diffs the current tables against these (one
        # array compare per pool) instead of walking every PG
        self._scan_tables: dict[int, object] = {}
        self._booted = False
        self._reboot_epoch = 0
        self._map_lock = DLock("osd-map")
        # pool -> pg_num as of the last map we fully processed, so a
        # growth is detected exactly once.  PERSISTED in the store's
        # superblock (the reference's OSDSuperblock role): an OSD that
        # was down across a pg_num increase must still split on boot,
        # or parent-stranded objects read ENOENT forever.
        self._pool_pg_num: dict[int, int] = {}
        self._superblock_loaded = False
        # perf counters (the l_osd_* set, reference OSD.cc:9659 region)
        self.perf = PerfCounters(self.entity)
        for key in ("op", "op_r", "op_w", "op_in_bytes", "op_out_bytes",
                    "subop", "recovery_ops", "peer_inventory_scans",
                    "peer_backfills", "scrub_errors", "op_error"):
            self.perf.add(key)
        self.perf.add("op_latency", CounterType.TIME)
        # log2 latency distributions (perf_histogram role): the tail
        # the averages above cannot show; microseconds.  Reads and
        # writes also record separately — the SLO engine's put_p99 /
        # get_p999 objectives window each side on its own (a write-amp
        # tail must not hide inside the read distribution)
        self.perf.add("op_latency_us", CounterType.HISTOGRAM)
        self.perf.add("op_r_latency_us", CounterType.HISTOGRAM)
        self.perf.add("op_w_latency_us", CounterType.HISTOGRAM)
        # per-tenant-class latency attribution: clients stamp a
        # "qclass" on each op (loadgen --class / RGW access-key map)
        # and the op records into op_class_<label>_latency_us too, so
        # the mgr's per-class multiwindow burn pairs can name the
        # burning tenant class.  Histograms pre-register for exactly
        # the conf-declared labels; unknown stamps are ignored (a
        # misbehaving client must not grow the counter set).
        self._class_labels = tuple(
            lbl.strip() for lbl in
            str(self.conf["slo_class_labels"] or "").split(",")
            if lbl.strip())
        for lbl in self._class_labels:
            self.perf.add(f"op_class_{lbl}_latency_us",
                          CounterType.HISTOGRAM)
        # delta-encoded perf collection (perf_dump_delta wire cmd):
        # baseline + epoch live here, one per collector stream
        from ceph_tpu_torch.common.perf_collect import DeltaCollectEncoder
        self._delta_encoder = DeltaCollectEncoder()
        # QoS op scheduler (mClockScheduler role) + op observability
        # (OpRequest/OpTracker role)
        from ceph_tpu_torch.osd.scheduler import ClassProfile
        self.op_scheduler = MClockScheduler({
            clazz: ClassProfile(
                reservation=self.conf[f"osd_mclock_{clazz}_res"],
                weight=self.conf[f"osd_mclock_{clazz}_wgt"],
                limit=self.conf[f"osd_mclock_{clazz}_lim"],
            )
            for clazz in ("client", "recovery", "backfill", "scrub")
        }, journal=self.journal)
        # QoS defense plane override: when the mgr controller pushes a
        # hedge timeout (qos_set), it supersedes the static conf value
        # for every existing and future EC backend on this daemon
        self._qos_hedge_override: float | None = None
        self.op_tracker = OpTracker(
            slow_op_seconds=float(self.conf["osd_op_complaint_time"]),
            slow_history_size=int(self.conf["osd_slow_op_history"]),
        )
        self._use_mclock = (self.conf["osd_op_queue"]
                            == "mclock_scheduler")
        # batched locality-aware repair engine: drains PG missing sets
        # through shared decode launches, paced by the mClock recovery
        # class at batch cost (osd/repair.py)
        from ceph_tpu_torch.osd.repair import RepairScheduler
        self.repair = RepairScheduler(
            self.perf, tracer=self.tracer,
            journal=self.journal,
            op_scheduler=self.op_scheduler,
            use_mclock=self._use_mclock,
            max_batch_objects=int(
                self.conf["osd_ec_repair_batch_objects"]),
        )
        # planned-motion twin of the repair engine: topology-change
        # (backfill) drains reuse the same batched machinery but pace
        # as the mClock "backfill" class, checkpoint a persisted
        # cursor, and gate on per-OSD reservation slots.  Local slots
        # cover PGs this daemon primaries, remote slots PGs
        # backfilling INTO this daemon — separate pools (the
        # local_reserver/remote_reserver split) so two mutually-
        # backfilling primaries cannot deadlock.
        from ceph_tpu_torch.osd.backfill import BackfillEngine, BackfillSlots
        self.backfill_local = BackfillSlots(
            int(self.conf["osd_max_backfills"]))
        self.backfill_remote = BackfillSlots(
            int(self.conf["osd_max_backfills"]))
        self.backfill_engine = BackfillEngine(
            self.repair, self.perf, store=self.store,
            journal=self.journal)
        # third sibling: batched device scrub.  Sweeps PG object sets
        # through ECBackend.scrub_batch in cursor-resumable chunks,
        # paced as the mClock "scrub" class, pausing while the QoS
        # plane reports the cluster burning SLO (osd/scrub.py)
        from ceph_tpu_torch.osd.scrub import ScrubEngine
        self.scrub_engine = ScrubEngine(
            self.repair, self.perf, store=self.store,
            journal=self.journal, op_scheduler=self.op_scheduler,
            use_mclock=self._use_mclock)
        # completed-op cache keyed by client reqid (the osd_reqid_t dedup
        # the reference keeps in the PG log): a client resend whose first
        # attempt executed but lost the reply gets the cached result
        # instead of a second execution of a non-idempotent batch
        self._reqid_replies: dict[str, dict] = {}
        self._reqid_order: deque[str] = deque()
        self._reqid_cap = 4096
        # reqid -> future of the attempt currently executing: resends
        # attach instead of double-executing
        self._inflight_ops: dict[str, asyncio.Future] = {}
        # dynamic perf queries (OSDPerfMetricQuery role): qid -> spec,
        # and qid -> {group key -> counters} accumulated per client op
        self._perf_queries: dict[int, dict] = {}
        self._pq_counters: dict[int, dict[str, dict]] = {}
        # cephx: rotating service secrets (fetched from the mon) and
        # per-connection client-session auth state
        self._service_secrets: dict[int, str] = {}
        self._conn_auth: dict[int, dict] = {}
        # watch/notify state:
        #   (pool, ps, oid) -> {(client entity, cookie): conn}
        self._watchers: dict[
            tuple, dict[tuple[str, int], Connection]
        ] = {}
        self._notify_id = 0
        self._notify_waiters: dict[tuple, asyncio.Future] = {}

    # -- lifecycle ---------------------------------------------------------
    async def start(self, timeout: float = 20.0) -> None:
        fp.apply_conf(self.conf)
        await self.store.mount()
        await self.msgr.bind(self.addr)
        await self.monc.start(timeout)
        if int(self.conf["osd_ec_mesh_cs"]) > 0:
            # build the EC data-plane mesh OFF the event loop before
            # any PG needs it: first-time jax runtime init blocks for
            # seconds and would stall heartbeats/leases mid-peering
            await asyncio.to_thread(self._ec_mesh)
        if bool(self.conf["osd_ec_mesh_coalesce"]):
            # same off-loop warmup for the host mesh coalescer's
            # device pool (first OSD up pays it; later ones find the
            # singleton warm)
            co = self._host_coalescer()
            if co is not None:
                await asyncio.to_thread(co.warm)
        if self.cephx:
            # BEFORE the map subscription: a revived OSD's first map
            # triggers peering immediately, and unsigned pg_queries
            # (no secrets yet) would be dropped by every peer
            await self._refresh_service_secrets()
        self.monc.sub_want("osdmap")
        self.monc.sub_want("config")
        self.monc.renew_subs()
        try:
            await self.monc.send_boot(self.osd_id,
                                      str(self.msgr.my_addr),
                                      host=self.host, timeout=timeout)
            self._booted = True
        except TimeoutError:
            # e.g. the noup flag: keep the daemon alive and keep
            # offering the boot until the mon accepts it (the reference
            # OSD waits in preboot, it does not die)
            log.dout(1, "%s: boot not acknowledged yet (noup?); "
                     "retrying in the background", self.entity)
            self._tasks.append(
                asyncio.create_task(self._boot_retry_loop())
            )
        self._tasks.append(asyncio.create_task(self._heartbeat_loop()))
        if self.conf["osd_scrub_interval"] > 0:
            self._tasks.append(asyncio.create_task(self._scrub_loop()))
        if self.conf["osd_agent_interval"] > 0:
            self._tasks.append(
                asyncio.create_task(self._tier_agent_loop())
            )
        await self._start_admin_socket()
        log.dout(1, "%s: booted at %s", self.entity, self.msgr.my_addr)

    async def _boot_retry_loop(self) -> None:
        while not self._stopped and not self._booted:
            try:
                await self.monc.send_boot(
                    self.osd_id, str(self.msgr.my_addr),
                    host=self.host, timeout=5.0,
                )
                self._booted = True
                log.dout(1, "%s: boot accepted", self.entity)
            except (TimeoutError, ConnectionError, asyncio.TimeoutError):
                await asyncio.sleep(1.0)

    def _perf_dump_all(self) -> dict:
        """perf dump + the messenger's own counters under a ``msgr_``
        prefix, so the dispatch-latency histogram rides the same
        surface the mgr already polls."""
        out = self.perf.dump()
        for k, v in self.msgr.perf.dump().items():
            out[f"msgr_{k}"] = v
        # tracer span-loss visibility (daemon + messenger rings): how
        # many spans fell out of each bounded ring before a collection,
        # and how many surviving spans already lost their parent
        out["tracer_ring_evictions"] = (
            self.tracer.ring_evictions + self.msgr.tracer.ring_evictions)
        out["tracer_orphan_spans"] = (
            self.tracer.orphan_count() + self.msgr.tracer.orphan_count())
        # kernel profiler table (ec/profiler.py): per-codec-signature
        # launch attribution with derived roofline % — nested dict, not
        # a counter; the mgr's tsdb/top surfaces consume it and the
        # Prometheus renderer skips it
        from ceph_tpu_torch.ec.profiler import profiler_for
        kernels = profiler_for(self.perf).dump(
            peak_gibps=float(self.conf["ec_hbm_peak_gibps"] or 0.0))
        if kernels:
            out["ec_kernels"] = kernels
        return out

    def _dump_traces_all(self, trace_id=None) -> list[dict]:
        """Daemon spans + the messenger's dispatch-hop spans: one
        reply covers every ring this process keeps."""
        return (self.tracer.dump(trace_id)
                + self.msgr.tracer.dump(trace_id))

    def _ec_coalesce_stats(self) -> dict:
        """Admin-socket ``ec coalesce stats``: every primary EC PG's
        CoalescedLauncher lifetime counters (per-PG; the perf counters
        aggregate the same signals daemon-wide)."""
        out = {}
        for pgid, pg in self.pgs.items():
            be = getattr(pg, "backend", None)
            if be is None or getattr(be, "coalescer", None) is None:
                continue
            out[str(pgid)] = be.coalescer.stats()
        return out

    def _resident_cache(self):
        """The daemon's ONE DeviceShardCache, shared by every primary
        EC backend (namespaced per PG) so the byte budget is a daemon
        property, not a per-PG one.  With the host mesh coalescer on,
        the cache is sharding-aware: installed streams pre-place with
        the launch batch sharding so resident reads feed sharded
        launches without a host round trip or a launch-time gather."""
        if getattr(self, "_resident_cache_obj", None) is None:
            from ceph_tpu_torch.store.device_cache import DeviceShardCache
            sharding = None
            co = self._host_coalescer()
            if co is not None and co.total > 1:
                from ceph_tpu_torch.parallel.mesh import (NamedSharding,
                                                          PartitionSpec)
                sharding = NamedSharding(
                    co.mesh(), PartitionSpec(("dp", "cs")))
            self._resident_cache_obj = DeviceShardCache(
                max_bytes=int(self.conf["osd_ec_resident_max_bytes"]),
                perf=self.perf,
                sharding=sharding,
                journal=self.journal,
                device=self.device,
            )
        return self._resident_cache_obj

    def _ec_mesh_stats(self) -> dict:
        """Admin-socket ``ec mesh stats``: the host-level mesh
        coalescer (shared across every co-located OSD — the launch,
        occupancy, and per-device stripe split counters prove the
        batch axis really fans out) plus each primary EC PG's view of
        which plane served its batches."""
        out = {}
        co = self._host_coalescer()
        if co is not None:
            out["host"] = co.stats()
        for pgid, pg in self.pgs.items():
            be = getattr(pg, "backend", None)
            if be is None or not hasattr(be, "mesh_stats"):
                continue
            ms = be.mesh_stats
            out[str(pgid)] = {
                "plane": ("mesh-coalesced" if be.mesh_co is not None
                          else "mesh" if be.mesh is not None
                          else "single-device"),
                "sharded_decode": bool(be._mesh_dec_ok),
                "encodes": ms["encodes"],
                "decodes": ms["decodes"],
                "repairs": ms["repairs"],
                "encode_buckets": sorted(ms["encode_buckets"]),
                "decode_buckets": sorted(ms["decode_buckets"]),
            }
        return out

    def _ec_repair_stats(self) -> dict:
        """Admin-socket ``ec repair stats``: the batched repair
        engine's lifetime view — batches, objects, per-strategy split,
        plan-cache hit rate, and the end-to-end byte accounting
        (survivor bytes read, bytes saved vs the whole-chunk
        counterfactual, rebuilt bytes written)."""
        from ceph_tpu_torch.osd.repair import REPAIR_COUNTERS
        return {
            "engine": self.repair.stats(),
            "counters": {k: self.perf.value(k)
                         for k in REPAIR_COUNTERS},
            "mclock": {
                "enabled": self._use_mclock,
                "recovery_dispatched":
                    self.op_scheduler.stats().get("recovery", 0),
            },
        }

    def _backfill_stats(self) -> dict:
        """Admin-socket ``backfill stats``: the planned-motion engine's
        lifetime view — drains, objects, batches, preempts, cursor
        resumes, moved bytes — plus the live reservation tables and
        the backfill mClock class's dispatch count.  Motion is complete
        when both reservation tables are idle and no drain is queued."""
        from ceph_tpu_torch.osd.backfill import BACKFILL_COUNTERS
        return {
            "engine": self.backfill_engine.stats(),
            "reservations": {
                "local": self.backfill_local.stats(),
                "remote": self.backfill_remote.stats(),
            },
            "counters": {k: self.perf.value(k)
                         for k in BACKFILL_COUNTERS},
            "mclock": {
                "enabled": self._use_mclock,
                "backfill_dispatched":
                    self.op_scheduler.stats().get("backfill", 0),
            },
        }

    def _ec_scrub_stats(self) -> dict:
        """Admin-socket ``ec scrub stats``: the batched integrity
        engine's lifetime view — sweeps, objects verified, convictions,
        repairs, cursor resumes, SLO preempts — plus the scrub mClock
        class's dispatch count and the live pause state."""
        from ceph_tpu_torch.osd.scrub import SCRUB_COUNTERS
        return {
            "engine": self.scrub_engine.stats(),
            "counters": {k: self.perf.value(k)
                         for k in SCRUB_COUNTERS},
            "mclock": {
                "enabled": self._use_mclock,
                "scrub_dispatched":
                    self.op_scheduler.stats().get("scrub", 0),
            },
        }

    def _mclock_set(self, clazz: str = "", reservation=None,
                    weight=None, limit=None) -> dict:
        """Admin-socket ``mclock set``: runtime retune of one op
        class's R/W/L (journals ``mclock.retune`` on change)."""
        if not clazz:
            return {"error": "clazz required"}
        change = self.op_scheduler.set_profile(
            str(clazz),
            reservation=None if reservation is None
            else float(reservation),
            weight=None if weight is None else float(weight),
            limit=None if limit is None else float(limit))
        return {"changed": change is not None, "change": change,
                "profiles": self.op_scheduler.profiles_dump()}

    def _mclock_stats(self) -> dict:
        """Admin-socket ``mclock stats``: the live QoS picture — class
        profiles, dispatch counts, backlog, retune count, and the
        controller-pushed hedge override (None = static conf)."""
        return {
            "enabled": self._use_mclock,
            "profiles": self.op_scheduler.profiles_dump(),
            "dispatched": self.op_scheduler.stats(),
            "depths": self.op_scheduler.queue_depths(),
            "retunes": self.op_scheduler.retunes,
            "hedge_override_s": self._qos_hedge_override,
        }

    def _qos_set(self, data: dict) -> dict:
        """Apply one ``qos_set`` wire cmd from the mgr QoS controller:
        per-class mClock retunes and/or an adaptive hedge timeout."""
        out: dict = {}
        for clazz, prof in (data.get("mclock") or {}).items():
            change = self.op_scheduler.set_profile(
                str(clazz),
                reservation=prof.get("reservation"),
                weight=prof.get("weight"),
                limit=prof.get("limit"))
            if change is not None:
                out.setdefault("mclock", {})[str(clazz)] = change
        if "hedge_timeout" in data:
            ht = data["hedge_timeout"]
            out["hedge_timeout"] = self._apply_hedge_timeout(
                float(ht) if ht else None)
        if "slo_burning" in data:
            # the controller's burn verdict doubles as the background-
            # integrity gate: scrub pauses between batches while the
            # cluster is burning SLO and resumes (cursor intact) when
            # the storm passes
            if bool(data["slo_burning"]):
                self.scrub_engine.pause("slo")
            else:
                self.scrub_engine.resume("slo")
            out["slo_burning"] = bool(data["slo_burning"])
        return out

    def _apply_hedge_timeout(self, timeout: float | None) -> float | None:
        """Install the controller-derived EC hedge timeout on every
        existing EC backend and remember it for backends created later
        (peering re-instantiates them).  None reverts to the static
        ``osd_ec_hedge_read_timeout`` conf behavior."""
        prev = self._qos_hedge_override
        self._qos_hedge_override = timeout
        applied = timeout
        if timeout is None:
            applied = float(
                self.conf["osd_ec_hedge_read_timeout"]) or None
        for pg in self.pgs.values():
            be = getattr(pg, "backend", None)
            if be is not None and hasattr(be, "hedge_timeout"):
                be.hedge_timeout = applied
        if timeout != prev:
            self.journal.emit(
                "qos.hedge", epoch=self.osdmap.epoch if self.osdmap
                else 0,
                timeout_ms=round(timeout * 1e3, 3)
                if timeout is not None else 0.0)
        return timeout

    def _ec_resident_stats(self) -> dict:
        """Admin-socket ``ec resident stats``: the shared device-shard
        cache plus each primary EC PG's residency view."""
        out = {}
        cache = getattr(self, "_resident_cache_obj", None)
        if cache is not None:
            out["cache"] = cache.stats()
        for pgid, pg in self.pgs.items():
            be = getattr(pg, "backend", None)
            if be is None or not hasattr(be, "resident_stats"):
                continue
            out[str(pgid)] = be.resident_stats()
        return out

    def _forensics_snapshot(self, window_s=None) -> dict:
        """One daemon's contribution to a forensic bundle: the trailing
        window of the event journal plus the slow-op ring and the
        latency histogram snapshots the SLO engine judges from."""
        if not window_s:
            window_s = float(self.conf["forensics_window_s"])
        dump = self.perf.dump()
        return {
            "entity": self.entity,
            "events": self.journal.snapshot(float(window_s)),
            "journal": self.journal.stats(),
            "slow_ops": self.op_tracker.dump_historic_slow_ops(),
            "hists": {k: dump[k] for k in
                      ("op_latency_us", "op_r_latency_us",
                       "op_w_latency_us") if k in dump},
            "mclock_depths": self.op_scheduler.queue_depths(),
        }

    async def _start_admin_socket(self) -> None:
        """Bind <admin_socket_dir>/<entity>.asok with the reference's
        introspection surface (admin_socket.h:105): perf dump,
        dump_ops_in_flight, config show, ..."""
        run_dir = self.conf["admin_socket_dir"]
        if not run_dir:
            return
        from ceph_tpu_torch.common.admin_socket import AdminSocket
        from ceph_tpu_torch.common.log import recent_lines

        sock = AdminSocket(self.entity)
        sock.register("perf dump", self._perf_dump_all,
                      "dump perf counters")
        sock.register("dump_ops_in_flight",
                      self.op_tracker.dump_ops_in_flight,
                      "in-flight client ops with stage timestamps")
        sock.register("dump_historic_ops",
                      self.op_tracker.dump_historic_ops,
                      "recent slow/completed ops")
        sock.register("dump_historic_slow_ops",
                      self.op_tracker.dump_historic_slow_ops,
                      "slowest ops with event timeline + span tree")
        sock.register("config show", self.conf.show,
                      "live configuration")
        sock.register("dump_throttles", self.msgr.throttle_dump,
                      "messenger dispatch throttles")
        sock.register("dump_scheduler", self.op_scheduler.stats,
                      "op scheduler queue state")
        sock.register("log dump", recent_lines,
                      "recent log ring (crash context)")
        sock.register("dump_traces", self._dump_traces_all,
                      "collected trace spans (zipkin-lite)")
        sock.register("events dump", lambda: {
            "stats": self.journal.stats(),
            "events": self.journal.snapshot(),
        }, "flight-recorder event journal (full ring)")
        sock.register("status", lambda: {
            "entity": self.entity,
            "osdmap_epoch": self.osdmap.epoch if self.osdmap else 0,
            "num_pgs": len(self.pgs),
        }, "daemon status")
        sock.register("ec coalesce stats", self._ec_coalesce_stats,
                      "per-PG EC cross-op coalescer state")
        sock.register("ec resident stats", self._ec_resident_stats,
                      "device-resident EC shard cache state")
        sock.register("ec mesh stats", self._ec_mesh_stats,
                      "host-level mesh coalescer state (cross-OSD "
                      "sharded EC launches)")
        sock.register("ec repair stats", self._ec_repair_stats,
                      "batched repair engine state (strategy split, "
                      "read-byte savings, mClock pacing)")
        sock.register("backfill stats", self._backfill_stats,
                      "planned-motion engine state (drains, cursor "
                      "resumes, reservation tables, mClock pacing)")
        sock.register("ec scrub stats", self._ec_scrub_stats,
                      "batched integrity engine state (sweeps, "
                      "convictions, repairs, SLO preempts, mClock "
                      "pacing)")
        sock.register("mclock set", self._mclock_set,
                      "retune one mClock class at runtime: "
                      "clazz=<name> [reservation=] [weight=] [limit=]")
        sock.register("mclock stats", self._mclock_stats,
                      "mClock profiles, dispatch counts, queue depths, "
                      "retune count, QoS hedge override")
        fp.register_admin_commands(sock)
        await sock.start(run_dir)
        self.admin_socket = sock

    async def shutdown(self) -> None:
        self._stopped = True
        for t in self._tasks:
            t.cancel()
        for pg in self.pgs.values():
            if pg.peering_task is not None:
                pg.peering_task.cancel()
            if pg.snaptrim_task is not None:
                pg.snaptrim_task.cancel()
        self.op_scheduler.shutdown()
        if getattr(self, "admin_socket", None) is not None:
            await self.admin_socket.stop()
            self.admin_socket = None
        await self.monc.shutdown()
        await self.msgr.shutdown()
        # spill any dirty device-resident shard streams BEFORE the
        # store unmounts — device HBM is a cache tier, not durability
        for pg in self.pgs.values():
            be = getattr(pg, "backend", None)
            if be is not None and getattr(be, "resident", None) \
                    is not None:
                try:
                    await be.flush_resident()
                except Exception:
                    log.exception("resident flush failed on shutdown")
        await self.store.umount()

    # -- cephx -------------------------------------------------------------
    @property
    def cephx(self) -> bool:
        return self.conf["auth_cluster_required"] == "cephx"

    async def _refresh_service_secrets(self) -> None:
        """Fetch the rotating service secrets over our authenticated mon
        session (the CephxKeyServer rotating-secrets pull)."""
        try:
            r = await self.monc.command("auth service-secrets")
            if r.get("rc") == 0 and r.get("data"):
                self._service_secrets = {
                    int(e): str(s) for e, s in r["data"].items()
                }
        except (ConnectionError, asyncio.TimeoutError, KeyError,
                ValueError) as e:
            log.derr("%s: service-secret fetch failed: %s",
                     self.entity, e)

    def _sign_peer_payload(self, payload: dict) -> dict:
        """Attach the service-secret MAC to an OSD-peer message payload
        (peering, trims, pings — same integrity story as sub-ops)."""
        if self.cephx:
            sig = self._sub_op_sig(payload)
            if sig is not None:
                payload = dict(payload)
                payload["sepoch"], payload["sig"] = sig
        return payload

    def _sub_op_sig(self, payload: dict) -> tuple[int, str] | None:
        """Peer sub-ops are MACed with the current service secret: an
        endpoint that merely claims an osd.* name in the messenger
        handshake cannot inject replication traffic."""
        if not self._service_secrets:
            return None
        epoch = max(self._service_secrets)
        body = canonical({k: v for k, v in payload.items()
                          if k not in ("sig", "sepoch")})
        return epoch, hmac_mod.new(
            self._service_secrets[epoch].encode(), body, hashlib.sha256
        ).hexdigest()

    async def _sub_op_sig_ok(self, d: dict) -> bool:
        epoch = int(d.get("sepoch", 0))
        if epoch not in self._service_secrets:
            await self._refresh_service_secrets()
        secret = self._service_secrets.get(epoch)
        if secret is None:
            return False
        body = canonical({k: v for k, v in d.items()
                          if k not in ("sig", "sepoch")})
        want = hmac_mod.new(secret.encode(), body,
                            hashlib.sha256).hexdigest()
        return hmac_mod.compare_digest(want, str(d.get("sig", "")))

    async def _handle_osd_auth(self, conn: Connection, d: dict) -> None:
        """Client session auth: verify the mon-issued ticket, then
        challenge for possession of its session key (the CephxAuthorizer
        exchange, reference CephxProtocol.h:165-190)."""
        state = self._conn_auth.setdefault(id(conn), {})
        if "ticket" in d:
            ticket = dict(d["ticket"])
            got = verify_ticket(self._service_secrets, ticket)
            if got is None and int(ticket.get("epoch", -1)) \
                    not in self._service_secrets:
                # a fresher epoch than we hold: pull before rejecting
                # (the client may have authenticated right after a
                # rotation)
                await self._refresh_service_secrets()
                got = verify_ticket(self._service_secrets, ticket)
            if got is None:
                conn.send_message(Message(
                    "osd_auth_reply",
                    {"ok": False, "reason": "bad ticket"},
                ))
                return
            entity, caps, session_key = got
            state.update(entity=entity, caps=caps,
                         session_key=session_key,
                         challenge=secrets_mod.token_hex(16),
                         authed=False)
            conn.send_message(Message(
                "osd_auth_challenge", {"nonce": state["challenge"]}
            ))
            return
        proof = str(d.get("proof", ""))
        want = (hmac_mod.new(
            state.get("session_key", "").encode(),
            state.get("challenge", "").encode(), hashlib.sha256,
        ).hexdigest() if state.get("challenge") else None)
        if want is not None and hmac_mod.compare_digest(want, proof):
            state["authed"] = True
            conn.send_message(Message("osd_auth_reply", {"ok": True}))
        else:
            conn.send_message(Message(
                "osd_auth_reply", {"ok": False, "reason": "bad proof"}
            ))

    def _client_caps_deny(self, conn: Connection, pg: PG,
                          ops: list[dict], oid: str = "") -> bool:
        """OSDCap enforcement on an authenticated client session."""
        if not self.cephx:
            return False
        state = self._conn_auth.get(id(conn))
        if state is None or not state.get("authed"):
            return True
        write = any(op.get("op") not in _CAPS_READ_OPS
                    for op in ops)
        caps = state.get("caps", "")
        pools = [pg.pool.name]
        if pg.pool.tier_of >= 0 and self.osdmap is not None:
            # overlay-redirected clients hold caps scoped to the BASE
            # pool's name; either name authorizes the cache pool
            base = self.osdmap.pools.get(pg.pool.tier_of)
            if base is not None:
                pools.append(base.name)
        # the oid carries its rados namespace as "\x1d<ns>\x1d<name>"
        # (hobject_t nspace role); caps may be namespace-scoped
        ns = oid[1:].split("\x1d", 1)[0] if oid.startswith("\x1d") \
            else ""
        return not any(cap_allows(caps, write=write, pool=p,
                                  namespace=ns)
                       for p in pools)

    # -- dispatch ----------------------------------------------------------
    def ms_handle_connect(self, conn: Connection) -> None:
        pass

    def ms_handle_reset(self, conn: Connection) -> None:
        self.monc.ms_handle_reset(conn)
        self._conn_auth.pop(id(conn), None)
        self._tier_authed.discard(id(conn))
        state = self._tier_auth_state.pop(id(conn), None)
        if state is not None and not state["fut"].done():
            state["fut"].set_exception(
                ConnectionError("tier auth session reset")
            )
            state["fut"].exception()
        # a dead client takes its watches with it (watch timeout role)
        for key, watchers in list(self._watchers.items()):
            for wid, wconn in list(watchers.items()):
                if wconn is conn:
                    del watchers[wid]
            if not watchers:
                del self._watchers[key]
        # ...and in-flight notifies must not wait out the timeout for a
        # watcher that is known dead (PrimaryLogPG completes on reset)
        for (nid, entity, cookie), fut in list(
            self._notify_waiters.items()
        ):
            if entity == conn.peer_name and not fut.done():
                fut.set_exception(ConnectionError("watcher gone"))

    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        t = msg.type
        if t in _MON_TYPES:
            await self.monc.ms_dispatch(conn, msg)
        elif t == "osd_op":
            # client ops can wait on peering/recovery: off the reader loop
            asyncio.get_running_loop().create_task(
                self._handle_osd_op(conn, msg.data)
            )
        elif t == "sub_op":
            self.perf.inc("subop")
            asyncio.get_running_loop().create_task(
                self._handle_sub_op(conn, msg.data)
            )
        elif t == "osd_auth":
            asyncio.get_running_loop().create_task(
                self._handle_osd_auth(conn, msg.data)
            )
        elif t == "pg_scrub":
            asyncio.get_running_loop().create_task(
                self._handle_pg_scrub(conn, msg.data)
            )
        elif t == "dump_ops":
            try:
                conn.send_message(Message("dump_ops_reply", {
                    "tid": msg.data.get("tid", 0),
                    "in_flight": self.op_tracker.dump_ops_in_flight(),
                    "historic": self.op_tracker.dump_historic_ops(),
                    "historic_slow":
                        self.op_tracker.dump_historic_slow_ops(),
                    "scheduler": self.op_scheduler.stats(),
                }))
            except ConnectionError:
                pass
        elif t == "perf_dump":
            # the admin-socket `perf dump` surface, polled by the mgr
            try:
                conn.send_message(Message("perf_dump_reply", {
                    "tid": msg.data.get("tid", 0),
                    "counters": self._perf_dump_all(),
                }))
            except ConnectionError:
                pass
        elif t == "perf_dump_delta":
            # delta-encoded collect: ship only counters changed since
            # the collector's acked epoch (full resync on mismatch) —
            # the sublinear-collect path of common/perf_collect.py
            payload = self._delta_encoder.encode(
                self._perf_dump_all(),
                int(msg.data.get("ack_epoch", 0)))
            try:
                conn.send_message(Message("perf_dump_delta_reply", {
                    "tid": msg.data.get("tid", 0),
                    **payload,
                }))
            except ConnectionError:
                pass
        elif t == "pg_stats":
            # MPGStats: per-primary-PG stats for the mgr's PGMap digest
            try:
                conn.send_message(Message("pg_stats_reply", {
                    "tid": msg.data.get("tid", 0),
                    "pgs": self._pg_stats(),
                }))
            except ConnectionError:
                pass
        elif t == "perf_query_add":
            # dynamic perf query (reference OSDPerfMetricQuery, the
            # mgr osd_perf_query / rbd_support data source): group
            # client ops by the spec's key until removed
            qid = int(msg.data.get("qid", 0))
            self._perf_queries[qid] = dict(msg.data.get("spec", {}))
            self._pq_counters.setdefault(qid, {})
            try:
                conn.send_message(Message("perf_query_reply", {
                    "tid": msg.data.get("tid", 0), "qid": qid,
                }))
            except ConnectionError:
                pass
        elif t == "perf_query_rm":
            qid = int(msg.data.get("qid", 0))
            self._perf_queries.pop(qid, None)
            self._pq_counters.pop(qid, None)
            try:
                conn.send_message(Message("perf_query_reply", {
                    "tid": msg.data.get("tid", 0), "qid": qid,
                }))
            except ConnectionError:
                pass
        elif t == "perf_query_dump":
            qid = int(msg.data.get("qid", 0))
            try:
                conn.send_message(Message("perf_query_dump_reply", {
                    "tid": msg.data.get("tid", 0), "qid": qid,
                    "counters": self._pq_counters.get(qid, {}),
                }))
            except ConnectionError:
                pass
        elif t == "osd_op_reply":
            # replies to OUR tier client ops (promote/flush/propagate)
            fut = self._tier_futs.pop(int(msg.data.get("tid", 0)), None)
            if fut is not None and not fut.done():
                fut.set_result(msg.data)
        elif t == "osd_auth_challenge":
            # our tier-client authorizer exchange with a peer OSD
            state = self._tier_auth_state.get(id(conn))
            if state is not None:
                proof = hmac_mod.new(
                    state["session_key"].encode(),
                    str(msg.data.get("nonce", "")).encode(),
                    hashlib.sha256,
                ).hexdigest()
                try:
                    conn.send_message(Message("osd_auth",
                                              {"proof": proof}))
                except ConnectionError:
                    pass
        elif t == "osd_auth_reply":
            state = self._tier_auth_state.pop(id(conn), None)
            if state is not None and not state["fut"].done():
                state["fut"].set_result(bool(msg.data.get("ok")))
        elif t in ("hit_set_ls", "hit_set_contains"):
            pg = self.pgs.get(PGId(int(msg.data.get("pool", -1)),
                                   int(msg.data.get("ps", 0))))
            if pg is None or not pg.is_primary:
                reply = {"error": "not primary"}
            elif t == "hit_set_ls":
                reply = self._hitset_ls(pg)
            else:
                reply = self._hitset_contains(
                    pg, str(msg.data.get("name", ""))
                )
            try:
                conn.send_message(Message(f"{t}_reply", {
                    "tid": msg.data.get("tid", 0), **reply,
                }))
            except ConnectionError:
                pass
        elif t == "dump_traces":
            try:
                conn.send_message(Message("dump_traces_reply", {
                    "tid": msg.data.get("tid", 0),
                    "spans": self._dump_traces_all(
                        msg.data.get("trace_id")
                    ),
                }))
            except ConnectionError:
                pass
        elif t == "forensics_capture":
            # mgr fan-out on SLO_VIOLATION/SLOW_OPS raise: reply with
            # this daemon's windowed journal + slow-op ring + hists
            try:
                conn.send_message(Message("forensics_capture_reply", {
                    "tid": msg.data.get("tid", 0),
                    **self._forensics_snapshot(
                        msg.data.get("window_s")),
                }))
            except ConnectionError:
                pass
        elif t == "ec_resident_stats":
            # the admin-socket `ec resident stats` surface over the wire
            try:
                conn.send_message(Message("ec_resident_stats_reply", {
                    "tid": msg.data.get("tid", 0),
                    **self._ec_resident_stats(),
                }))
            except ConnectionError:
                pass
        elif t == "ec_mesh_stats":
            # the admin-socket `ec mesh stats` surface over the wire
            try:
                conn.send_message(Message("ec_mesh_stats_reply", {
                    "tid": msg.data.get("tid", 0),
                    **self._ec_mesh_stats(),
                }))
            except ConnectionError:
                pass
        elif t == "ec_repair_stats":
            # the admin-socket `ec repair stats` surface over the wire
            try:
                conn.send_message(Message("ec_repair_stats_reply", {
                    "tid": msg.data.get("tid", 0),
                    **self._ec_repair_stats(),
                }))
            except ConnectionError:
                pass
        elif t == "backfill_stats":
            # the admin-socket `backfill stats` surface over the wire:
            # drills and the elastic smoke poll motion-complete here
            try:
                conn.send_message(Message("backfill_stats_reply", {
                    "tid": msg.data.get("tid", 0),
                    **self._backfill_stats(),
                }))
            except ConnectionError:
                pass
        elif t == "ec_scrub_stats":
            # the admin-socket `ec scrub stats` surface over the wire:
            # drills and the scrub smoke poll sweep progress here
            try:
                conn.send_message(Message("ec_scrub_stats_reply", {
                    "tid": msg.data.get("tid", 0),
                    **self._ec_scrub_stats(),
                }))
            except ConnectionError:
                pass
        elif t == "qos_set":
            # mgr_qos fan-out: apply mClock retunes and/or the adaptive
            # hedge timeout pushed by the cluster-wide QoS controller
            try:
                conn.send_message(Message("qos_set_reply", {
                    "tid": msg.data.get("tid", 0),
                    **self._qos_set(msg.data),
                }))
            except ConnectionError:
                pass
        elif t == "sub_reply":
            asyncio.get_running_loop().create_task(
                self._handle_sub_reply(msg.data)
            )
        elif t in ("pg_query", "pg_notify", "pg_activate", "log_trim",
                   "pg_stray", "pg_purge_stray", "pg_prune_shards",
                   "osd_ping", "osd_ping_reply") and self.cephx \
                and not await self._sub_op_sig_ok(msg.data):
            log.derr("%s: dropping unsigned/forged %s from %s",
                     self.entity, t, conn.peer_name)
        elif t == "pg_query":
            self._handle_pg_query(conn, msg.data)
        elif t == "pg_notify":
            self._handle_pg_notify(msg.data)
        elif t == "pg_activate":
            self._handle_pg_activate(msg.data)
        elif t == "pg_stray":
            self._handle_pg_stray(msg.data)
        elif t == "pg_purge_stray":
            asyncio.get_running_loop().create_task(
                self._handle_pg_purge_stray(msg.data)
            )
        elif t == "pg_prune_shards":
            asyncio.get_running_loop().create_task(
                self._handle_pg_prune_shards(msg.data)
            )
        elif t == "log_trim":
            pgid = PGId(int(msg.data["pgid"][0]), int(msg.data["pgid"][1]))
            asyncio.get_running_loop().create_task(
                self._trim_log(pgid, int(msg.data["limit"]))
            )
        elif t == "notify_ack":
            # entity taken from the connection, not the message: an ack
            # can only satisfy the sender's own watch
            fut = self._notify_waiters.pop(
                (int(msg.data["notify_id"]), conn.peer_name,
                 int(msg.data["cookie"])), None
            )
            if fut is not None and not fut.done():
                fut.set_result(bytes(msg.data.get("reply", b"")))
        elif t == "osd_ping":
            conn.send_message(Message(
                "osd_ping_reply",
                self._sign_peer_payload(
                    {"from": self.osd_id, "ts": msg.data["ts"]}
                ),
                priority=PRIO_HIGH,
            ))
        elif t == "osd_ping_reply":
            self._hb_last_rx[int(msg.data["from"])] = time.monotonic()
            self._hb_first_tx.pop(int(msg.data["from"]), None)
        else:
            log.dout(5, "%s: ignoring %s", self.entity, t)

    # -- map handling --------------------------------------------------------
    async def _on_map(self, osdmap: OSDMap) -> None:
        async with self._map_lock:
            self.osdmap = osdmap
            self.journal.emit(
                "map.install", epoch=osdmap.epoch,
                up=sum(1 for o in osdmap.osds.values() if o.up))
            # stop reconnect churn toward peers the map marks down
            for osd, info in osdmap.osds.items():
                if not info.up and info.addr and osd != self.osd_id:
                    conn = self.msgr._conns.get(info.addr)
                    if conn is not None:
                        conn.mark_down()
            # sub-ops awaiting a reply from a now-down peer will never
            # get one — fail them now instead of letting each burn the
            # full sub-op timeout (the client-side Objecter rescans its
            # inflight set on map change the same way)
            for tid, (fut, osd) in list(self._sub_futures.items()):
                me = osdmap.osds.get(osd)
                if (me is None or not me.up) and not fut.done():
                    del self._sub_futures[tid]
                    fut.set_exception(ConnectionError(
                        f"osd.{osd} marked down (map e{osdmap.epoch})"
                    ))
            await self._scan_pgs()
            try:
                await self._save_map_history(osdmap)
            except Exception as e:  # noqa: BLE001
                # harvest metadata is best-effort; map handling and
                # peering must never stall on it
                log.derr("%s: map-history persist failed: %s",
                         self.entity, e)
        for pg in self.pgs.values():
            if pg.state == STATE_ACTIVE:
                self._kick_snaptrim(pg)
        # wrongly marked down while alive: re-assert ourselves (the
        # reference OSD reboots into the map the same way)
        me = osdmap.osds.get(self.osd_id)
        if (self._booted and me is not None and not me.up
                and osdmap.epoch > self._reboot_epoch):
            self._reboot_epoch = osdmap.epoch
            log.dout(1, "%s: map e%d wrongly marks us down, re-booting",
                     self.entity, osdmap.epoch)

            async def reboot():
                if self._stopped:
                    return
                try:
                    await self.monc.send_boot(
                        self.osd_id, str(self.msgr.my_addr),
                        host=self.host,
                    )
                except (ConnectionError, TimeoutError):
                    pass

            asyncio.get_running_loop().create_task(reboot())

    _SUPER_CID = CollectionId(-1, 0)
    _SUPER_OID = GHObject(-1, "_osd_superblock")
    # DR harvest metadata: a bounded history of full OSDMaps plus the
    # latest rotating-service-secret snapshot, persisted beside the
    # superblock so an offline `monstore_tool rebuild` has map + auth
    # material to read after total monitor loss (the reference's
    # OSD::store_map / ceph-objectstore-tool update-mon-db source)
    _MAPS_OID = GHObject(-1, "_osd_maps")

    async def _save_map_history(self, osdmap: OSDMap) -> None:
        keep = int(self.conf["osd_map_history_keep"])
        if keep <= 0 or osdmap.epoch <= 0:
            return
        try:
            cur = self.store.omap_get(self._SUPER_CID, self._MAPS_OID)
        except KeyError:
            cur = {}
        key = f"full_{osdmap.epoch:010d}"
        if key in cur:
            return
        tx = StoreTx()
        try:
            self.store.list_objects(self._SUPER_CID)
        except KeyError:
            tx.create_collection(self._SUPER_CID)
        tx.touch(self._SUPER_CID, self._MAPS_OID)
        kv = {key: encode(osdmap.to_dict())}
        if self._service_secrets:
            kv["service_secrets"] = json.dumps({
                str(e): s for e, s in self._service_secrets.items()
            }).encode()
        tx.omap_setkeys(self._SUPER_CID, self._MAPS_OID, kv)
        epochs = sorted(k for k in cur if k.startswith("full_"))
        epochs.append(key)
        if len(epochs) > keep:
            tx.omap_rmkeys(self._SUPER_CID, self._MAPS_OID,
                           epochs[:len(epochs) - keep])
        await self.store.queue_transactions(tx)

    def _load_superblock(self) -> None:
        try:
            omap = self.store.omap_get(self._SUPER_CID, self._SUPER_OID)
        except KeyError:
            omap = {}
        self._pool_pg_num = {int(k): int(v) for k, v in omap.items()}
        self._superblock_loaded = True

    async def _save_superblock(self) -> None:
        tx = StoreTx()
        try:
            self.store.list_objects(self._SUPER_CID)
        except KeyError:
            tx.create_collection(self._SUPER_CID)
        tx.touch(self._SUPER_CID, self._SUPER_OID)
        tx.omap_setkeys(self._SUPER_CID, self._SUPER_OID, {
            str(pid): str(n).encode()
            for pid, n in self._pool_pg_num.items()
        })
        await self.store.queue_transactions(tx)

    async def _split_pgs(self) -> None:
        """PG splitting (the reference's PG::split_into +
        OSD::split_pgs): when a pool's pg_num grows, every locally
        held parent collection is partitioned — objects whose
        stable-mod ps moved land in the child collection.  Placement
        follows pgp_num, which still points children at the parent's
        OSDs, so the split is purely local; a later pgp_num increase
        migrates whole children through normal peering/backfill."""
        if not self._superblock_loaded:
            self._load_superblock()
        m = self.osdmap
        changed = False
        for pool in m.pools.values():
            old_n = self._pool_pg_num.get(pool.pool_id, pool.pg_num)
            if self._pool_pg_num.get(pool.pool_id, 0) < pool.pg_num:
                # only ADOPT growth (and first sight): a decrease is
                # the merge edge and _merge_pgs records it only after
                # the fold actually ran — otherwise a deferred merge
                # would lose its trigger forever
                self._pool_pg_num[pool.pool_id] = pool.pg_num
                changed = True
            if pool.pg_num <= old_n:
                continue
            parents = set()
            for cid in list(self.store.list_collections()):
                if cid.pool != pool.pool_id or cid.pg >= old_n \
                        or cid.shard == pg_log.META_SHARD:
                    continue
                parents.add(cid.pg)
                await self._split_collection(cid, old_n, pool.pg_num)
            for ps in sorted(parents):
                await self._split_log(pool.pool_id, ps, old_n,
                                      pool.pg_num)
                await self._split_snapmapper(pool.pool_id, ps,
                                             pool.pg_num)
        if changed:
            await self._save_superblock()

    async def _merge_pgs(self) -> None:
        """PG merging (the reference's PG merge machinery at -lite
        scale): when a pool's pg_num SHRINKS, every locally held child
        collection (ps >= new pg_num) folds into its stable-mod parent.
        The monitor only permits the decrease after pgp_num already
        equals the target, so source and target PGs are COLOCATED on
        the same OSDs (the reference's ready-to-merge precondition) and
        the fold is purely local and deterministic across replicas:
        objects + snap-mapper keys move to the parent, the child's log
        is dropped (all replicas hold identical clean copies, so the
        parents' logs alone stay consistent; client replay dedup for
        the child's recent ops is the documented -lite cost), and the
        child collections disappear."""
        if not self._superblock_loaded:
            self._load_superblock()
        m = self.osdmap
        for pool in m.pools.values():
            old_n = self._pool_pg_num.get(pool.pool_id, pool.pg_num)
            new_n = pool.pg_num
            if new_n >= old_n:
                continue            # superblock edge: set only by us
            if not self._merge_safe_locally(pool.pool_id, new_n):
                # a local PG in the fold set is still peering/
                # recovering (the mon gate is map-level; this is the
                # per-OSD belt and braces): defer and retry — the
                # superblock keeps the edge alive across deferrals
                self._schedule_merge_retry()
                continue
            for cid in list(self.store.list_collections()):
                if cid.pool != pool.pool_id or cid.pg < new_n:
                    continue
                parent_ps = split_parent(cid.pg, new_n)
                if cid.shard == pg_log.META_SHARD:
                    await self._merge_meta(cid, parent_ps)
                else:
                    await self._merge_collection(cid, parent_ps)
                self.pgs.pop(PGId(pool.pool_id, cid.pg), None)
                log.dout(1, "%s: merged %s.%x -> %x", self.entity,
                         cid.pool, cid.pg, parent_ps)
            self._pool_pg_num[pool.pool_id] = new_n
            await self._save_superblock()
            # one more pass shortly: a peer still behind this epoch
            # could have recreated a child while we folded
            self._schedule_merge_retry()

    _MERGE_OK_STATES = ("active", "active+clean", "stray", "initial",
                        "replica")

    def _merge_safe_locally(self, pool_id: int, new_n: int) -> bool:
        """True when every local PG in the FOLD SET (the merging
        children and the parents receiving them) is in a quiescent
        state; unrelated PGs of the pool don't block the fold."""
        relevant = set()
        for pgid in self.pgs:
            if pgid.pool == pool_id and pgid.ps >= new_n:
                relevant.add(pgid.ps)
                relevant.add(split_parent(pgid.ps, new_n))
        for pgid, pg in self.pgs.items():
            if pgid.pool != pool_id or pgid.ps not in relevant:
                continue
            if pg.state not in self._MERGE_OK_STATES:
                return False
        return True

    def _schedule_merge_retry(self) -> None:
        if self._merge_retry_pending:
            return
        self._merge_retry_pending = True

        async def _retry():
            await asyncio.sleep(0.5)
            self._merge_retry_pending = False
            if not self._stopped:
                try:
                    await self._scan_pgs()
                except Exception as e:      # noqa: BLE001
                    log.derr("%s: deferred merge rescan failed: %r",
                             self.entity, e)

        # tracked so shutdown cancels a pending retry cleanly, and
        # self-pruning so repeated deferrals don't accumulate handles
        task = asyncio.get_running_loop().create_task(_retry())
        self._tasks.append(task)
        task.add_done_callback(
            lambda t: self._tasks.remove(t)
            if t in self._tasks else None)

    def _copy_object(self, tx: "StoreTx", src_cid, dst_cid, oid) -> None:
        """Stage a full object copy (data + xattrs + omap) into ``tx``
        — the shared move primitive of split and merge."""
        data = self.store.read(src_cid, oid)
        tx.touch(dst_cid, oid)
        if data:
            tx.write(dst_cid, oid, 0, data)
        else:
            tx.truncate(dst_cid, oid, 0)
        for aname, aval in self.store.getattrs(src_cid, oid).items():
            tx.setattr(dst_cid, oid, aname, aval)
        omap = self.store.omap_get(src_cid, oid)
        if omap:
            tx.omap_setkeys(dst_cid, oid, omap)

    async def _merge_collection(self, cid, parent_ps: int) -> None:
        """Fold a child DATA collection into (pool, parent_ps, shard)."""
        parent = CollectionId(cid.pool, parent_ps, cid.shard)
        tx = StoreTx()
        try:
            self.store.list_objects(parent)
        except KeyError:
            tx.create_collection(parent)
        for oid in list(self.store.list_objects(cid)):
            # a copy already in the parent is NEWER: post-flip client
            # writes land there while a deferred fold waits (behind-
            # peer writes into the child are ESTALE-rejected), so the
            # child's copy must never clobber it
            if not self.store.exists(parent, oid):
                self._copy_object(tx, cid, parent, oid)
            tx.remove(cid, oid)
        tx.remove_collection(cid)
        await self.store.queue_transactions(tx)

    async def _merge_meta(self, cid, parent_ps: int) -> None:
        """Fold a child META collection: snap-mapper keys merge into
        the parent's mapper, every OTHER meta object (hitset archives
        etc.) moves across wholesale; the child's pg_log is dropped
        (the reference's merge_from empties the result log too,
        PGLog.h:791) but its reqid -> obj_version dedup pairs fold
        into the parent's _merged_reqids sidecar so client replays of
        the child's recent ops still answer from history.  Every
        replica folds identical clean child state, so the sidecar is
        bit-identical across the acting set."""
        pcid = pg_log.meta_cid(cid.pool, parent_ps)
        tx = StoreTx()
        try:
            self.store.list_objects(pcid)
        except KeyError:
            tx.create_collection(pcid)
        try:
            mapper = self.store.omap_get(cid,
                                         snaps.mapper_oid(cid.pool))
        except KeyError:
            mapper = {}
        if mapper:
            tx.touch(pcid, snaps.mapper_oid(cid.pool))
            tx.omap_setkeys(pcid, snaps.mapper_oid(cid.pool), mapper)
        merged = pg_log.read_merged_reqids(self.store, cid.pool,
                                           parent_ps)
        merged.update(pg_log.read_merged_reqids(self.store, cid.pool,
                                                cid.pg))
        entries, _ = pg_log.read_log(self.store, cid.pool, cid.pg)
        # fresh child-log pairs get ordinals past everything inherited,
        # in child seq order — the eviction cap then drops oldest-first
        nxt = max((o for o, _ in merged.values()), default=0) + 1
        for s in sorted(entries):          # final entry per reqid wins
            if entries[s].reqid:
                merged[entries[s].reqid] = (nxt, entries[s].obj_version)
                nxt += 1
        if merged:
            if len(merged) > pg_log.MERGED_REQIDS_CAP:
                keep = sorted(merged, key=lambda r: (merged[r], r)
                              )[-pg_log.MERGED_REQIDS_CAP:]
                merged = {r: merged[r] for r in keep}
            moid = pg_log.merged_reqids_oid(cid.pool)
            tx.touch(pcid, moid)
            tx.omap_setkeys(pcid, moid, {
                r: f"{o},{v}".encode()
                for r, (o, v) in merged.items()})
            # the parent usually keeps its interval across the fold
            # (same acting set), so activation won't reload: feed the
            # live index directly too
            ppg = self.pgs.get(PGId(cid.pool, parent_ps))
            if ppg is not None:
                for rid, (_, v) in merged.items():
                    ppg.reqid_index.setdefault(rid, (0, v))
        skip = {pg_log.meta_oid(cid.pool).key(),
                snaps.mapper_oid(cid.pool).key(),
                pg_log.merged_reqids_oid(cid.pool).key()}
        for oid in list(self.store.list_objects(cid)):
            if oid.key() not in skip \
                    and not self.store.exists(pcid, oid):
                self._copy_object(tx, cid, pcid, oid)
            tx.remove(cid, oid)
        tx.remove_collection(cid)
        await self.store.queue_transactions(tx)

    async def _split_collection(self, cid, old_n: int,
                                new_n: int) -> None:
        children: set = set()
        tx = StoreTx()
        for oid in list(self.store.list_objects(cid)):
            new_ps = object_to_ps(oid.name, new_n)
            if new_ps == cid.pg:
                continue
            child = CollectionId(cid.pool, new_ps, cid.shard)
            if child not in children:
                children.add(child)
                try:
                    self.store.list_objects(child)
                except KeyError:
                    tx.create_collection(child)
            self._copy_object(tx, cid, child, oid)
            tx.remove(cid, oid)
        if len(tx):
            await self.store.queue_transactions(tx)
            log.dout(1, "%s: split %s.%x -> %d children (%d ops)",
                     self.entity, cid.pool, cid.pg, len(children),
                     len(tx))

    async def _split_log(self, pool_id: int, ps: int, old_n: int,
                         new_n: int) -> None:
        """Give every child a full COPY of the parent's pg_log (tail
        included) — the reference's PGLog::split_out_child role.
        Without history a remapped child peers over EMPTY logs,
        declares itself clean, and split-off objects become
        unreachable.  A copy (rather than a partition) keeps both logs
        gap-free: trim's contiguous-prefix safety rule stays intact,
        and entries for objects that hashed elsewhere are inert — all
        replicas hold identical copies, so nothing reads as missing,
        client replay dedup keeps working for moved objects, and the
        foreign entries age out with normal trimming."""
        entries, tail = pg_log.read_log(self.store, pool_id, ps)
        try:
            sidecar = self.store.omap_get(
                pg_log.meta_cid(pool_id, ps),
                pg_log.merged_reqids_oid(pool_id))
        except KeyError:
            sidecar = {}
        if not entries and not tail and not sidecar:
            return
        children = [c for c in range(old_n, new_n)
                    if split_parent(c, old_n) == ps]
        tx = StoreTx()
        for child_ps in children:
            ccid = pg_log.meta_cid(pool_id, child_ps)
            try:
                self.store.list_objects(ccid)
            except KeyError:
                tx.create_collection(ccid)
            for e in entries.values():
                pg_log.append_ops(tx, pool_id, child_ps, e)
            tx.setattr(ccid, pg_log.meta_oid(pool_id),
                       pg_log.TAIL_ATTR, str(tail).encode())
            if sidecar:
                # merge-preserved dedup follows the log copy: replays
                # of pre-merge ops keep answering after a re-split
                moid = pg_log.merged_reqids_oid(pool_id)
                tx.touch(ccid, moid)
                tx.omap_setkeys(ccid, moid, dict(sidecar))
        if len(tx):
            await self.store.queue_transactions(tx)

    def _resurrect_strays(self) -> None:
        """A rebooted OSD may hold collections for PGs the current map
        assigns entirely elsewhere; without a pg object they would
        never announce (or be purged) and their data would be
        unreachable forever."""
        m = self.osdmap
        for cid in list(self.store.list_collections()):
            pool = m.pools.get(cid.pool)
            if pool is None or cid.shard == pg_log.META_SHARD \
                    or not 0 <= cid.pg < pool.pg_num:
                continue
            pgid = PGId(cid.pool, cid.pg)
            if pgid in self.pgs:
                continue
            up, up_primary, acting, primary = m.pg_to_up_acting(
                cid.pool, cid.pg)
            if self.osd_id in acting or self.osd_id in up:
                continue              # the ownership loop handles it
            pg = PG(pgid, pool, self.osd_id)
            pg.state = "stray"
            self.pgs[pgid] = pg

    async def _split_snapmapper(self, pool_id: int, ps: int,
                                new_n: int) -> None:
        """Move snap->clone index keys (the SnapMapper role) with
        their objects: a clone whose mapper key stays in the parent
        would never be trimmed after the split (space leak + reads at
        deleted snaps succeeding)."""
        try:
            omap = self.store.omap_get(snaps.mapper_cid(pool_id, ps),
                                       snaps.mapper_oid(pool_id))
        except KeyError:
            return
        moved: dict[int, dict[str, bytes]] = {}
        for key, val in omap.items():
            _, _, name = key.partition("/")
            new_ps = object_to_ps(name, new_n)
            if new_ps != ps:
                moved.setdefault(new_ps, {})[key] = val
        if not moved:
            return
        tx = StoreTx()
        for child_ps, kv in moved.items():
            ccid = snaps.mapper_cid(pool_id, child_ps)
            try:
                self.store.list_objects(ccid)
            except KeyError:
                tx.create_collection(ccid)
            tx.omap_setkeys(ccid, snaps.mapper_oid(pool_id), kv)
        tx.omap_rmkeys(snaps.mapper_cid(pool_id, ps),
                       snaps.mapper_oid(pool_id),
                       [k for kv in moved.values() for k in kv])
        await self.store.queue_transactions(tx)

    async def _scan_pgs(self) -> None:
        """Recompute PG ownership from the current map (the load_pgs /
        advance_pg flow).  Serialized: a deferred-merge retry must not
        interleave with a map-driven scan mid-fold."""
        async with self._scan_lock:
            await self._scan_pgs_locked()

    async def _scan_pgs_locked(self) -> None:
        await self._merge_pgs()     # before _split_pgs persists pg_num
        await self._split_pgs()
        self._resurrect_strays()
        m = self.osdmap
        me = m.osds.get(self.osd_id) if m is not None else None
        if me is not None and not me.up:
            # A map that marks US down predates our own boot (or
            # wrongly marked us down — _on_map is already re-asserting
            # with a new boot).  Taking role changes from it would
            # demote every local PG to stray and announce pg_stray to
            # the primaries, turning a plain revive into an inventory
            # reconcile; the reference OSD likewise waits in preboot
            # until it sees itself up.  The epoch that shows us up
            # triggers the real scan.
            return
        self.journal.emit("pg.rescan", epoch=m.epoch if m else 0,
                          pgs=len(self.pgs))
        new_tables: dict[int, object] = {}
        for pool in m.pools.values():
            # Whole-pool tables from the epoch-cached bulk mapping
            # (placement/mapping.py), then a vectorized candidate set:
            # the scalar loop's body is a no-op for any PG that is
            # neither already held (self.pgs) nor in our up/acting set,
            # so iterating owned ∪ changed (diff vs the last completed
            # scan's tables) — or owned ∪ mine when no prior snapshot
            # exists — visits exactly the PGs the full walk would act
            # on, without O(pg_num) Python CRUSH walks per map change.
            tables = m.mapping().up_acting_tables(pool.pool_id)
            new_tables[pool.pool_id] = tables
            owned = {pgid.ps for pgid in self.pgs
                     if pgid.pool == pool.pool_id}
            prev = self._scan_tables.get(pool.pool_id)
            if prev is not None:
                cand = owned | {int(p) for p in tables.diff(prev)}
            else:
                cand = owned | {int(p) for p in
                                tables.pgs_of(self.osd_id)}
            for ps in sorted(cand):
                if ps >= pool.pg_num:
                    continue
                up, up_primary, acting, primary = tables.lookup(ps)
                pgid = PGId(pool.pool_id, ps)
                mine = self.osd_id in acting or self.osd_id in up
                pg = self.pgs.get(pgid)
                if not mine:
                    if pg is not None and self.osd_id not in acting:
                        if pg.state != "stray":
                            self.journal.emit(
                                "pg.state", epoch=m.epoch,
                                pgid=str(pgid), state="stray",
                                prev=pg.state)
                        pg.state = "stray"
                        pg.primary = NO_OSD     # drop stale primary role
                        pg.acting = []
                        if pg.peering_task is not None:
                            pg.peering_task.cancel()
                            pg.peering_task = None
                    if pg is not None and pg.state == "stray" \
                        and up_primary != NO_OSD \
                            and up_primary != self.osd_id:
                        # a wholesale remap (upmap / pgp_num change)
                        # can hand a PG to a DISJOINT acting set: the
                        # new primary peers over empty members unless
                        # former holders announce themselves
                        # (reference MNotifyRec from strays)
                        self._notify_stray(pg, pgid, up_primary)
                    continue
                if pg is None:
                    pg = PG(pgid, pool, self.osd_id)
                    self.pgs[pgid] = pg
                    await self._ensure_collections(pg, acting)
                pg.pool = pool
                if not pg.same_interval(acting, up, primary):
                    # watches do not survive an interval change here:
                    # clients re-arm their lingers against the new
                    # primary (Objecter.on_map_change)
                    for key in [k for k in self._watchers
                                if k[0] == pgid.pool and k[1] == pgid.ps]:
                        del self._watchers[key]
                    pg.start_interval(m.epoch, acting, up, primary)
                    self.journal.emit(
                        "pg.interval", epoch=m.epoch, pgid=str(pgid),
                        primary=bool(pg.is_primary),
                        acting=list(acting))
                    await self._ensure_collections(pg, acting)
                    self._make_backend(pg)
                    if pg.is_primary:
                        pg.peering_task = asyncio.create_task(
                            self._peer(pg)
                        )
        # snapshot only on completion: a skipped scan (self-down gate)
        # must keep diffing against the last view we actually acted on
        self._scan_tables = new_tables

    async def _ensure_collections(self, pg: PG, acting: list[int]) -> None:
        tx = StoreTx()
        for cid in self._my_cids(pg, acting):
            tx.create_collection(cid)
        # the per-PG meta collection holds this OSD's pg log (one log per
        # OSD per PG, even when it holds several EC shard collections)
        tx.create_collection(pg_log.meta_cid(pg.pgid.pool, pg.pgid.ps))
        await self.store.queue_transactions(tx)

    def _my_cids(self, pg: PG, acting: list[int]) -> list[CollectionId]:
        if pg.is_ec:
            return [
                CollectionId(pg.pgid.pool, pg.pgid.ps, shard)
                for shard, osd in enumerate(acting)
                if osd == self.osd_id
            ]
        return [CollectionId(pg.pgid.pool, pg.pgid.ps)]

    def _ec_mesh(self):
        """Distributed EC data-plane mesh (osd_ec_mesh_cs > 0): one
        ('dp','cs') mesh over all local devices, built once per
        process (OSDs in one process share the devices).  Invalid
        geometry degrades to the single-device plane with a warning —
        a config typo must not keep PGs from going active."""
        cs = int(self.conf["osd_ec_mesh_cs"])
        if cs <= 0:
            return None
        mesh = _EC_MESH_CACHE.get(cs)
        if mesh is None:
            from ceph_tpu_torch.parallel.mesh import local_devices

            from ceph_tpu_torch.parallel.ec_sharding import make_ec_mesh

            devs = local_devices(device=self.device)
            if len(devs) < cs or len(devs) % cs:
                log.derr("osd.%d: osd_ec_mesh_cs=%d does not divide "
                         "the %d local devices; using single-device "
                         "EC", self.osd_id, cs, len(devs))
                return None
            mesh = make_ec_mesh(devs, cs=cs)
            _EC_MESH_CACHE[cs] = mesh
        return mesh

    def _host_coalescer(self):
        """Host-level mesh coalescer (osd_ec_mesh_coalesce): ONE
        launcher per process shared by every co-located OSD's EC
        backends, flushing each micro-window as a single sharded
        launch over all local devices.  Window/stripe caps reuse
        the per-OSD coalescer options (they are host policy here —
        first OSD up wins, which is fine for a vstart host with one
        conf)."""
        if not bool(self.conf["osd_ec_mesh_coalesce"]):
            return None
        from ceph_tpu_torch.osd.mesh_coalesce import host_coalescer

        return host_coalescer(
            window_us=float(self.conf["osd_ec_coalesce_window_us"]),
            max_stripes=int(self.conf["osd_ec_coalesce_max_stripes"]),
            device=self.device,
        )

    def _make_backend(self, pg: PG) -> None:
        if not pg.is_primary:
            pg.backend = None
            return
        if pg.is_ec:
            profile = dict(
                self.osdmap.ec_profiles.get(pg.pool.ec_profile, {})
            ) or {"plugin": "jax_rs", "k": "2", "m": "2"}
            codec = ErasureCodePluginRegistry.instance().factory(
                profile.get("plugin", "jax_rs"), profile,
                device=self.device,
            )
            shards = {}
            for shard, osd in enumerate(pg.acting):
                cid = CollectionId(pg.pgid.pool, pg.pgid.ps, shard)
                if osd == self.osd_id:
                    shards[shard] = LocalShard(
                        self.store, cid, pg.pgid.pool, shard
                    )
                elif osd == NO_OSD:
                    shards[shard] = DeadShard(shard)
                else:
                    shards[shard] = NetworkShard(self, osd, cid)

            def log_hook(oid, op, obj_version, prior_version,
                         reqid="", pg=pg):
                entry = pg.next_entry(pg.epoch, oid, op, obj_version,
                                      prior_version, reqid)
                self._maybe_trim(pg)
                return entry

            hedge = float(self.conf["osd_ec_hedge_read_timeout"])
            if self._qos_hedge_override is not None:
                # the QoS controller's adaptive timeout outlives
                # backend rebuilds (peering re-instantiates them)
                hedge = self._qos_hedge_override
            variant = str(self.conf["ec_pallas_encode_variant"])
            if variant:
                from ceph_tpu_torch.ec import cuda_kernels
                cuda_kernels.set_encode_variant(variant)
            resident = None
            resident_ns = f"{pg.pgid.pool}.{pg.pgid.ps}"
            if bool(self.conf["osd_ec_resident"]):
                resident = self._resident_cache()
                # a rebuilt backend (peering, acting-set change) must
                # not inherit residency decided under the old acting
                # set — log rewind may have rewritten shard data
                resident.drop_ns(resident_ns)
            pg.backend = ECBackend(
                codec, shards, log_hook=log_hook,
                mesh=self._ec_mesh(),
                hedge_timeout=hedge or None,
                perf=self.perf,
                tracer=self.tracer,
                journal=self.journal,
                coalesce=bool(self.conf["osd_ec_coalesce"]),
                coalesce_window_us=float(
                    self.conf["osd_ec_coalesce_window_us"]),
                coalesce_max_stripes=int(
                    self.conf["osd_ec_coalesce_max_stripes"]),
                resident=resident,
                resident_ns=resident_ns,
                resident_writeback=bool(
                    self.conf["osd_ec_resident_writeback"]),
                mesh_coalescer=self._host_coalescer(),
            )
            pg.ec_k = pg.backend.k
        else:
            pg.backend = None       # replicated path works on the store

    # -- peering (primary) ---------------------------------------------------
    def _notify_stray(self, pg: PG, pgid: PGId, primary: int) -> None:
        entries, tail = pg_log.read_log(self.store, pgid.pool, pgid.ps)
        try:
            if not entries and not self.store.list_objects(
                    CollectionId(pgid.pool, pgid.ps)):
                return                    # nothing worth announcing
        except KeyError:
            return
        held = sorted({
            c.shard for c in self.store.list_collections()
            if c.pool == pgid.pool and c.pg == pgid.ps
            and c.shard >= 0
        })
        self._send_osd(primary, Message("pg_stray",
                       self._sign_peer_payload({
                           "pgid": [pgid.pool, pgid.ps],
                           "osd": self.osd_id,
                           "log": {str(seq): e.to_wire()
                                   for seq, e in entries.items()},
                           "tail": tail,
                           "shards": held,
                       }), priority=PRIO_HIGH))

    def _handle_pg_stray(self, d: dict) -> None:
        pgid = PGId(int(d["pgid"][0]), int(d["pgid"][1]))
        pg = self.pgs.get(pgid)
        if pg is None or not pg.is_primary:
            return
        osd = int(d["osd"])
        if osd in pg.acting:
            return
        info = PeerInfo(
            PG.stray_shard(osd), osd,
            log={int(s): LogEntry.from_wire(w)
                 for s, w in d.get("log", {}).items()},
            tail=int(d.get("tail", 0)),
        )
        info.ec_shards = [int(x) for x in d.get("shards", ())]
        known = pg.stray_sources.get(osd)
        pg.stray_sources[osd] = info
        if pg.peering_task is not None and not pg.peering_task.done():
            pg.record_info(info)          # mid-peer arrival counts too
        elif known is None or known.head != info.head:
            # the announcement changes the authoritative picture:
            # re-peer so recovery can pull from this holder
            self._schedule_repeer(pg, pg.epoch, delay=0.0)

    async def _handle_pg_prune_shards(self, d: dict) -> None:
        """The primary reached a CLEAN interval: drop shard collections
        for EC positions we no longer own.  Post-motion hygiene — one
        log per OSD per PG means a stale old-position collection would
        later present as held-with-stale-data if the map ever remaps
        this OSD back to that position."""
        pgid = PGId(int(d["pgid"][0]), int(d["pgid"][1]))
        pg = self.pgs.get(pgid)
        if pg is None or int(d.get("epoch", 0)) != pg.epoch \
                or self.osd_id not in pg.acting:
            return
        owned = {int(x) for x in d.get("owned", ())}
        tx = StoreTx()
        for cid in list(self.store.list_collections()):
            if cid.pool != pgid.pool or cid.pg != pgid.ps:
                continue
            if cid.shard < 0 or cid.shard in owned:
                continue            # meta/replicated cids stay put
            for oid in list(self.store.list_objects(cid)):
                tx.remove(cid, oid)
            tx.remove_collection(cid)
        if len(tx):
            await self.store.queue_transactions(tx)
            log.dout(5, "%s: pg %s: pruned stale shard collections "
                     "(own %s)", self.entity, pgid, sorted(owned))

    async def _handle_pg_purge_stray(self, d: dict) -> None:
        """The primary finished a clean interval with our data merged:
        drop the stray copy (reference PG::purge_strays)."""
        pgid = PGId(int(d["pgid"][0]), int(d["pgid"][1]))
        pg = self.pgs.get(pgid)
        if pg is None or pg.state != "stray" \
                or self.osd_id in pg.acting:
            return
        tx = StoreTx()
        for cid in list(self.store.list_collections()):
            if cid.pool != pgid.pool or cid.pg != pgid.ps:
                continue
            for oid in list(self.store.list_objects(cid)):
                tx.remove(cid, oid)
            tx.remove_collection(cid)
        if len(tx):
            await self.store.queue_transactions(tx)
        self.pgs.pop(pgid, None)
        log.dout(5, "%s: purged stray pg %s", self.entity, pgid)

    async def _peer(self, pg: PG) -> None:
        """GetInfo (log windows) -> authoritative log -> missing sets ->
        recover -> activate+merge (the PeeringMachine Primary path,
        PeeringState.h:556, with PGLog-based missing computation instead
        of full inventories). Queries are re-sent until every acting
        shard answers — a peer that was mid-boot for the first round
        answers a retry."""
        try:
            epoch = pg.epoch
            live = sum(1 for o in pg.acting if o != NO_OSD)
            if pg.ec_k and live < pg.ec_k:
                # below-k interval: the surviving members cannot decode
                # a single stripe, and the absent appliers are DOWN,
                # not divergent — running the log arithmetic here would
                # count every acked entry as applied-by-fewer-than-k,
                # rewind it, and DELETE intact shards.  Park as
                # incomplete; the map change that restores >= k
                # members opens a new interval and re-peers.
                if pg.state != STATE_INCOMPLETE:
                    self.journal.emit("pg.state", epoch=epoch,
                                      pgid=str(pg.pgid),
                                      state=STATE_INCOMPLETE,
                                      prev=pg.state)
                pg.state = STATE_INCOMPLETE
                log.dout(1, "pg %s: %d/%d acting members up (< k=%d): "
                         "incomplete, waiting for a fuller map",
                         pg.pgid, live, len(pg.acting), pg.ec_k)
                return
            pg.peer_infos = {}      # re-peer of the same interval: fresh
            if pg.backend is not None \
                    and getattr(pg.backend, "extent_cache", None):
                # a (re)peer may rewind objects via direct store txs —
                # cached extents from before the round are untrustworthy
                pg.backend.extent_cache.clear()
            local = self._local_info(pg)
            pg.record_info(local)
            for osd, sinfo in list(pg.stray_sources.items()):
                info = (self.osdmap.osds.get(osd)
                        if self.osdmap else None)
                if osd in pg.acting or info is None or not info.up:
                    # promoted since announce, or the stray died: a
                    # dead source would pin the gather loop forever
                    pg.stray_sources.pop(osd, None)
                    continue
                pg.record_info(sinfo)
            # an OSD may hold several EC shard positions of one PG: each
            # position gets an info (same log — one log per OSD per PG)
            for shard, osd in enumerate(pg.acting):
                if osd == self.osd_id and shard != local.shard:
                    pg.record_info(PeerInfo(
                        shard, self.osd_id, log=dict(local.log),
                        tail=local.tail, held=local.held,
                    ))
            await self._gather(pg, epoch, lambda: pg.all_infos_in(),
                               lambda shard: shard not in pg.peer_infos,
                               mode="log")
            if pg.epoch != epoch:
                return
            # new-entry seqs must exceed anything ANY member ever logged
            # (a reused seq would alias a divergent entry) — including
            # our own in-flight allocations from a previous interval of
            # this same PG (never decrease)
            pg.log_seq = max(
                [pg.log_seq]
                + [info.head[1] for info in pg.peer_infos.values()]
                + [max(info.log, default=0)
                   for info in pg.peer_infos.values()]
                + [info.tail for info in pg.peer_infos.values()]
            )
            missing = pg.compute_missing()
            flags = self.osdmap.flags if self.osdmap else set()
            if (missing.total() or missing.backfill) \
                    and ("norecover" in flags
                         or "nobackfill" in flags):
                # recovery administratively gated: the PG stays PARKED
                # (ops queue on waiting_for_active) — activating with
                # holes would serve ENOENT/stale data for durable,
                # acknowledged objects
                log.dout(1, "pg %s: recovery gated by osdmap flags %s",
                         pg.pgid, sorted(flags))
                self._schedule_recovery_ungate(pg, epoch)
                return
            if missing.backfill and not missing.total() \
                    and "norebalance" in flags:
                # pure remap (every object still fully redundant on the
                # old holders; the only work is planned motion to new
                # destinations): norebalance pauses exactly this —
                # degraded PGs above fall through and keep recovering
                log.dout(1, "pg %s: planned motion gated by "
                         "norebalance", pg.pgid)
                self.perf.inc("backfill_gated")
                self.journal.emit("backfill.gated", epoch=epoch,
                                  pgid=str(pg.pgid), flag="norebalance")
                self._schedule_recovery_ungate(
                    pg, epoch, flags=("norebalance",))
                return
            if missing.backfill:
                # log gaps: fall back to inventory comparison for those
                # shards (the backfill path)
                await self._backfill_plan(pg, epoch, missing)
                if pg.epoch != epoch:
                    return
            if pg.stray_sources:
                # a post-remap write makes the NEW interval's log
                # authoritative, hiding everything the strays hold —
                # reconcile object-by-object or the clean-activation
                # purge would delete the only copies
                await self._stray_reconcile(pg, epoch, missing)
                if pg.epoch != epoch:
                    return
            failures = 0
            if missing.total():
                pg.state = STATE_RECOVERING
                self.journal.emit("pg.state", epoch=epoch,
                                  pgid=str(pg.pgid), state="recovering",
                                  missing=missing.total())
                failures = await self._recover(pg, missing)
                if pg.epoch != epoch:
                    return
            if failures:
                # activate DEGRADED without merging logs: merging would
                # advance the stale member's tail over entries it still
                # has not applied, permanently hiding the unrecovered
                # objects. Leaving logs untouched lets the retry round
                # re-detect exactly the same missing set.
                log.derr("pg %s: %d objects failed recovery; degraded "
                         "activate + retry", pg.pgid, failures)
                for shard, osd in pg.acting_peers():
                    self._send_osd(osd, Message("pg_activate", {
                        "pgid": [pg.pgid.pool, pg.pgid.ps],
                        "epoch": epoch,
                    }, priority=PRIO_HIGH))
                pg.state = STATE_ACTIVE
                self.journal.emit("pg.state", epoch=epoch,
                                  pgid=str(pg.pgid), state="active",
                                  degraded=True)
                self._drain_waiters(pg)
                self._schedule_repeer(pg, epoch)
                return
            # activation: every member merges the authoritative log
            # window (now fully recovered; for EC already filtered to
            # reconstructable entries, so rewound entries are REMOVED
            # from the shards that applied them) so trims and the next
            # peering round see one consistent history
            window = {str(s): e.to_wire()
                      for s, e in missing.auth_log.items()}
            merge = {
                "pgid": [pg.pgid.pool, pg.pgid.ps], "epoch": epoch,
                "log": window, "tail": missing.auth_tail,
                "floor": pg.log_seq,
            }
            await self._merge_log(pg, merge)
            entries, _ = pg_log.read_log(self.store, pg.pgid.pool,
                                         pg.pgid.ps)
            pg.rebuild_reqid_index(entries)
            for rid, (_, v) in pg_log.read_merged_reqids(
                    self.store, pg.pgid.pool, pg.pgid.ps).items():
                # merge-preserved dedup: seq 0 so live entries win
                pg.reqid_index.setdefault(rid, (0, v))
            for shard, osd in pg.acting_peers():
                self._send_osd(osd, Message("pg_activate", dict(merge),
                                            priority=PRIO_HIGH))
            pg.state = STATE_ACTIVE
            self.journal.emit("pg.state", epoch=epoch,
                              pgid=str(pg.pgid), state="active")
            # a CLEAN activation has nothing missing: keeping the
            # pre-recovery set would report active+degraded (and a
            # degraded PGMap digest) forever after recovery succeeded
            pg.missing = MissingSet()
            for osd in list(pg.stray_sources):
                self._send_osd(osd, Message(
                    "pg_purge_stray", self._sign_peer_payload({
                        "pgid": [pg.pgid.pool, pg.pgid.ps],
                        "epoch": epoch,
                    }), priority=PRIO_HIGH))
            pg.stray_sources.clear()
            if pg.is_ec:
                # post-motion hygiene: members remapped to a new
                # position still hold the OLD position's collection
                # (it was the decode source during motion) — now that
                # the interval is clean those copies are stale the
                # moment the next write lands, so every acting member
                # prunes down to the positions it owns
                owned_by: dict[int, set[int]] = {}
                for s, osd in enumerate(pg.acting):
                    if osd != NO_OSD:
                        owned_by.setdefault(osd, set()).add(s)
                for osd, owned in owned_by.items():
                    prune = {
                        "pgid": [pg.pgid.pool, pg.pgid.ps],
                        "epoch": epoch, "owned": sorted(owned),
                    }
                    if osd == self.osd_id:
                        asyncio.get_running_loop().create_task(
                            self._handle_pg_prune_shards(prune))
                    else:
                        self._send_osd(osd, Message(
                            "pg_prune_shards",
                            self._sign_peer_payload(prune),
                            priority=PRIO_HIGH))
            self._drain_waiters(pg)
            self._kick_snaptrim(pg)
            log.dout(5, "pg %s: active (recovered %d objects)",
                     pg.pgid, missing.total())
        except asyncio.CancelledError:
            pass

    def _schedule_recovery_ungate(
            self, pg: PG, epoch: int,
            flags: tuple = ("norecover", "nobackfill")) -> None:
        """Wait out a gating osdmap flag WITHOUT re-running the whole
        peer log-query exchange every tick: the flag lives in our own
        osdmap, so poll it locally and only re-peer once every flag in
        ``flags`` cleared (norecover/nobackfill park recovery;
        norebalance parks pure planned motion)."""
        async def wait_clear():
            try:
                while not self._stopped and pg.epoch == epoch:
                    live = self.osdmap.flags if self.osdmap else set()
                    if not any(f in live for f in flags):
                        self._schedule_repeer(pg, epoch, delay=0.0)
                        return
                    await asyncio.sleep(0.5)
            except asyncio.CancelledError:
                pass

        task = asyncio.get_running_loop().create_task(wait_clear())
        self._ungate_tasks.add(task)
        task.add_done_callback(self._ungate_tasks.discard)

    def _schedule_repeer(self, pg: PG, epoch: int,
                         delay: float = 1.0) -> None:
        """Retry peering of the same interval after a recovery failure
        (the reference keeps missing sets and retries recovery; here the
        peering round IS the recovery planner)."""
        async def retry():
            await asyncio.sleep(delay)
            if pg.epoch == epoch and not self._stopped \
                    and pg.is_primary:
                pg.peering_task = asyncio.get_running_loop().create_task(
                    self._peer(pg)
                )
        asyncio.get_running_loop().create_task(retry())

    async def _gather(self, pg: PG, epoch: int, done, want, mode: str
                      ) -> None:
        """Re-send pg_query(mode) to acting peers matching ``want`` until
        ``done()``, respecting interval changes."""
        next_query = 0.0
        while not done():
            if pg.epoch != epoch:
                return
            now = time.monotonic()
            if now >= next_query:
                next_query = now + 1.0
                for shard, osd in pg.query_peers():
                    if not want(shard):
                        continue
                    self._send_osd(osd, Message("pg_query", {
                        "pgid": [pg.pgid.pool, pg.pgid.ps],
                        "epoch": epoch, "mode": mode,
                        "shard": shard, "from": self.osd_id,
                    }, priority=PRIO_HIGH))
            await asyncio.sleep(0.01)

    async def _stray_reconcile(self, pg: PG, epoch: int,
                               missing: MissingSet) -> None:
        """Pull objects that exist ONLY on stray sources into the
        acting set before activation.  An object the acting set
        already holds wins (its state is what clients have been
        served since the interval started); a stray that does not
        answer its inventory query is dropped for this round — and
        must NOT be purged as if consumed."""
        need_inv = [i.shard for o, i in pg.stray_sources.items()
                    if pg.peer_infos.get(i.shard) is not None]
        if not need_inv:
            return

        def infos_in():
            # .get: a concurrent re-peer of the same PG resets
            # peer_infos while this round's gather still polls — a
            # vanished stray entry means "not answered", not a crash
            return all(
                pg.peer_infos.get(s) is not None
                and pg.peer_infos[s].objects is not None
                for s in need_inv
            )

        try:
            await asyncio.wait_for(self._gather(
                pg, epoch, infos_in,
                lambda shard: (shard in need_inv
                               and pg.peer_infos.get(shard) is not None
                               and pg.peer_infos[shard].objects is None),
                mode="inventory",
            ), timeout=10.0)
        except asyncio.TimeoutError:
            # unanswered strays cannot be trusted as consumed: forget
            # them (no purge) and continue with who answered
            for osd, sinfo in list(pg.stray_sources.items()):
                if pg.peer_infos.get(sinfo.shard) is not None \
                        and pg.peer_infos[sinfo.shard].objects is None:
                    pg.stray_sources.pop(osd, None)
                    pg.peer_infos.pop(sinfo.shard, None)
        if pg.epoch != epoch:
            return
        my_shard = (pg.acting.index(self.osd_id)
                    if self.osd_id in pg.acting else 0)
        local_inv = self._inventory(pg, my_shard)
        # an object the authoritative history DELETED must not be
        # resurrected from a stale stray's copy
        latest = latest_per_object(missing.auth_log)
        deleted = {e.oid for e in latest.values()
                   if e.op == OP_DELETE}
        # ... and an object the authoritative history KNOWS is not
        # stray-ONLY: log recovery / the backfill plan already move it
        # where it belongs.  Judging membership by the primary's own
        # collection alone would mark every object missing on EVERY
        # shard when the primary is itself a fresh backfill
        # destination (its collection is empty by definition) —
        # flagging the intact positions as lost leaves decode with no
        # sources at all.
        known = {e.oid for e in latest.values()
                 if e.op != OP_DELETE}
        for osd, sinfo in pg.stray_sources.items():
            sinv = (pg.peer_infos.get(sinfo.shard).objects
                    if pg.peer_infos.get(sinfo.shard) else None) or {}
            for name, ver in sinv.items():
                if name in local_inv or name in known \
                        or name in deleted:
                    continue          # acting state / history wins
                for shard, aosd in enumerate(pg.acting):
                    if aosd == NO_OSD:
                        continue
                    missing.by_shard.setdefault(shard, {}).setdefault(
                        name, LogEntry(0, 0, name, OP_MODIFY,
                                       int(ver)))
                missing.sources.setdefault(name, set()).add(
                    sinfo.shard)

    async def _backfill_plan(self, pg: PG, epoch: int,
                             missing: MissingSet) -> None:
        """Extend the missing sets for backfill shards via full inventory
        comparison against the authoritative shard (O(objects) — only
        for peers whose log no longer connects)."""
        auth_shard, _, _ = pg.authoritative_log()
        # the inventory AUTHORITY must be a shard that actually holds
        # data: under a position permutation the max-head log can
        # belong to a backfill destination whose collection is empty —
        # comparing against its (empty) inventory would plan no motion
        # and silently activate with every object unreadable.  Prefer
        # any acting position that is NOT itself a destination.
        if auth_shard in missing.backfill:
            for s, osd in enumerate(pg.acting):
                if osd != NO_OSD and s not in missing.backfill:
                    auth_shard = s
                    break
        need_inv = set(missing.backfill) | {auth_shard}
        for shard in need_inv:
            # every LOCAL shard position answers synchronously (an OSD
            # can hold several EC shard collections of one PG)
            if (0 <= shard < len(pg.acting)
                    and pg.acting[shard] == self.osd_id
                    and pg.peer_infos.get(shard) is not None):
                pg.peer_infos[shard].objects = self._inventory(pg, shard)

        def infos_in():
            return all(
                pg.peer_infos.get(s) is not None
                and pg.peer_infos[s].objects is not None
                for s in need_inv
            )

        await self._gather(
            pg, epoch, infos_in,
            lambda shard: (shard in need_inv
                           and pg.peer_infos.get(shard) is not None
                           and pg.peer_infos[shard].objects is None),
            mode="inventory",
        )
        if pg.epoch != epoch:
            return
        self.perf.inc("peer_backfills")
        auth_inv = pg.peer_infos[auth_shard].objects or {}
        if not auth_inv and auth_shard in missing.backfill:
            # wholesale permutation: EVERY acting position is a
            # destination, so no live collection can serve as the
            # inventory authority.  The authoritative log still names
            # every surviving object and its version (version attrs
            # are written from the same entries), so synthesize the
            # inventory from it; the old-position collections the
            # acting members still hold are the decode sources.
            auth_inv = {
                e.oid: e.obj_version
                for e in latest_per_object(missing.auth_log).values()
                if e.op != OP_DELETE
                and object_to_ps(e.oid, pg.pool.pg_num) == pg.pgid.ps
            }
        for shard in missing.backfill:
            inv = pg.peer_infos[shard].objects or {}
            need = missing.by_shard.setdefault(shard, {})
            for name, ver in auth_inv.items():
                # ANY version mismatch is repaired — an equal-or-higher
                # version on the backfill peer is divergent (never-acked)
                # data, not a fresher copy
                if inv.get(name, 0) != ver:
                    need[name] = LogEntry(0, 0, name, OP_MODIFY, ver)
                    missing.sources.setdefault(name, set()).add(auth_shard)
            for name in inv:
                if name not in auth_inv:
                    # deleted while this shard was away
                    need[name] = LogEntry(0, 0, name, OP_DELETE, 0)
        # planning rollup for the batched repair engine: objects that
        # share a lost-shard pattern will drain through shared decode
        # launches, so the pattern histogram IS the launch plan
        if pg.is_ec and missing.backfill:
            patterns: dict[tuple[int, ...], int] = {}
            per_obj: dict[str, list[int]] = {}
            for shard in missing.backfill:
                for name, entry in missing.by_shard.get(
                        shard, {}).items():
                    if entry.op != OP_DELETE:
                        per_obj.setdefault(name, []).append(shard)
            for shards in per_obj.values():
                key = tuple(sorted(shards))
                patterns[key] = patterns.get(key, 0) + 1
            if patterns:
                log.dout(10, "pg %s: backfill plan: %d objects in %d "
                         "lost-pattern groups (batched launches): %s",
                         pg.pgid, len(per_obj), len(patterns),
                         {str(k): v for k, v in patterns.items()})

    async def _merge_log(self, pg: PG, d: dict) -> None:
        """Apply an activation merge: adopt authoritative window entries
        we lack, drop divergent entries (seq <= floor, not in window),
        and advance the tail (post-recovery, our data matches the
        window, so claiming its entries is truthful). Serialized against
        trim by pg.log_lock — interleaved read-modify-write cycles could
        otherwise regress the tail over removed entries."""
        async with pg.log_lock:
            pool, ps = pg.pgid.pool, pg.pgid.ps
            entries, tail = pg_log.read_log(self.store, pool, ps)
            window = {int(s): LogEntry.from_wire(w)
                      for s, w in d["log"].items()}
            floor = int(d.get("floor", 0))
            auth_tail = int(d.get("tail", 0))
            add = {s: e for s, e in window.items()
                   if s not in entries or entries[s].epoch != e.epoch}
            divergent = [s for s in entries
                         if s <= floor and s not in window
                         and s > auth_tail]
            new_tail = max(tail, auth_tail)
            if not add and not divergent and new_tail == tail:
                return
            cid = pg_log.meta_cid(pool, ps)
            oid = pg_log.meta_oid(pool)
            tx = StoreTx()
            for e in add.values():
                pg_log.append_ops(tx, pool, ps, e)
            if divergent:
                tx.omap_rmkeys(cid, oid,
                               [pg_log.seq_key(s) for s in divergent])
            tx.setattr(cid, oid, pg_log.TAIL_ATTR,
                       str(new_tail).encode())
            await self.store.queue_transactions(tx)

    async def _trim_log(self, pgid: PGId, limit: int) -> None:
        pg = self.pgs.get(pgid)
        lock = pg.log_lock if pg is not None else asyncio.Lock()
        try:
            async with lock:
                await pg_log.trim(self.store, pgid.pool, pgid.ps, limit)
        except (KeyError, ValueError) as e:
            log.dout(10, "%s: log trim %s failed: %s",
                     self.entity, pgid, e)

    def _held_shards(self, pool: int, ps: int) -> list[int]:
        """EC shard collections this OSD actually holds DATA in for
        one PG — the per-POSITION presence signal peering needs on top
        of the per-OSD log (a member remapped to a new position has a
        complete log but nothing stored there).  Empty collections do
        not count: early-epoch intervals create collections before any
        client write, and an empty position with a non-empty
        authoritative history is precisely a backfill destination."""
        held = []
        for c in self.store.list_collections():
            if c.pool != pool or c.pg != ps or c.shard < 0:
                continue
            try:
                if self.store.list_objects(c):
                    held.append(c.shard)
            except KeyError:
                continue
        return sorted(set(held))

    def _read_full_local(self, cid: CollectionId, name: str) -> dict:
        """The read_full sub-op served against our own store (the
        messenger only dials peers): decode sources may include OLD
        shard collections the primary itself still holds."""
        obj = (GHObject(cid.pool, name, shard=cid.shard)
               if cid.shard >= 0 else GHObject(cid.pool, name))
        return {
            "data": self.store.read(cid, obj),
            "attrs": dict(self.store.getattrs(cid, obj)),
            "omap": dict(self.store.omap_get(cid, obj)),
            "clones": {},
        }

    def _local_info(self, pg: PG) -> PeerInfo:
        shard = (pg.acting.index(self.osd_id)
                 if self.osd_id in pg.acting else NO_OSD)
        entries, tail = pg_log.read_log(self.store, pg.pgid.pool,
                                        pg.pgid.ps)
        # held is an EC-only signal (shard collections do not exist
        # for replicated PGs) and costs a store collection scan —
        # computing it for every replicated PG would stall the event
        # loop during a revive's re-peer storm
        return PeerInfo(shard, self.osd_id, log=entries, tail=tail,
                        held=(self._held_shards(pg.pgid.pool,
                                                pg.pgid.ps)
                              if pg.is_ec else None))

    def _inventory(self, pg: PG, shard: int) -> dict[str, int]:
        """name -> version for our shard of this PG (the MOSDPGNotify
        info payload; versions from object metadata, not pg_log).  A
        STRAY answering with its virtual shard id reports the union of
        whatever shard collections it still holds — the acting-position
        cid would not exist under the virtual id."""
        if pg.is_ec and shard <= PG.STRAY_SHARD_BASE:
            cids = [c for c in self.store.list_collections()
                    if c.pool == pg.pgid.pool and c.pg == pg.pgid.ps
                    and c.shard >= 0]
        elif pg.is_ec:
            cids = [CollectionId(pg.pgid.pool, pg.pgid.ps, shard)]
        else:
            cids = [CollectionId(pg.pgid.pool, pg.pgid.ps)]
        out: dict[str, int] = {}
        for cid in cids:
            try:
                objects = self.store.list_objects(cid)
            except KeyError:
                continue
            for oid in objects:
                if oid.snap != snaps.NOSNAP:
                    continue    # clones recover with their head
                try:
                    raw = self.store.getattr(cid, oid, VERSION_ATTR)
                    ver = int(json.loads(raw)["version"])
                except (KeyError, ValueError, TypeError):
                    ver = 1
                out[oid.name] = max(out.get(oid.name, 0), ver)
        return out

    # -- cache tiering (the PrimaryLogPG tiering agent + promote path:
    # reference src/osd/PrimaryLogPG.cc agent_work/maybe_promote) ---------
    TIER_DIRTY = "tier.dirty"          # user-xattr namespace

    def _tier_cid(self, pg: PG) -> CollectionId:
        return CollectionId(pg.pgid.pool, pg.pgid.ps)

    async def _tier_ensure_auth(self, osd: int, addr: str) -> None:
        """cephx leg of the tier client: this OSD holds the rotating
        service secrets, so it SELF-MINTS a service ticket (exactly
        what the mon would issue it) and runs the same authorizer
        exchange the client Objecter does."""
        if not self.cephx:
            return
        conn = await self.msgr.connect(addr, f"osd.{osd}")
        if id(conn) in self._tier_authed:
            return
        existing = self._tier_auth_state.get(id(conn))
        if existing is not None:
            # single-flight: a concurrent caller's exchange is already
            # running; clobbering its state would orphan its future
            ok = await asyncio.wait_for(
                asyncio.shield(existing["fut"]), 5.0
            )
            if not ok:
                raise ShardReadError(f"tier auth to osd.{osd} failed")
            return
        if not self._service_secrets:
            await self._refresh_service_secrets()
        from ceph_tpu_torch.mon.auth_monitor import seal_ticket

        epoch = max(self._service_secrets)
        ticket, session_key = seal_ticket(
            self._service_secrets[epoch], self.entity, "allow *",
            epoch, self.conf["auth_service_secret_ttl"],
        )
        fut = asyncio.get_running_loop().create_future()
        self._tier_auth_state[id(conn)] = {
            "session_key": session_key, "fut": fut,
        }
        conn.send_message(Message("osd_auth", {"ticket": ticket}))
        ok = await asyncio.wait_for(asyncio.shield(fut), 5.0)
        if not ok:
            raise ShardReadError(f"tier auth to osd.{osd} failed")
        self._tier_authed.add(id(conn))

    async def _tier_base_op(self, pool_id: int, oid: str,
                            ops: list[dict], timeout: float = 10.0):
        """The OSD acting as a client of the base pool (the proxied /
        flush IO of the tiering agent): target the base primary from
        the osdmap, correlate the osd_op_reply, retry across map churn
        with one reqid so the base dedups replays."""
        self._tier_seq += 1
        reqid = f"{self.entity}.tier:{self._tier_seq}"
        deadline = time.monotonic() + timeout
        reauths = 0
        while True:
            m = self.osdmap
            pool = m.pools.get(pool_id) if m is not None else None
            if pool is None:
                raise ShardReadError(f"tier base pool {pool_id} gone")
            ps = object_to_ps(oid, pool.pg_num)
            _, _, _, primary = m.pg_to_up_acting(pool_id, ps)
            if primary >= 0:
                self._tier_tid += 1
                tid = self._tier_tid
                fut = asyncio.get_running_loop().create_future()
                self._tier_futs[tid] = fut
                try:
                    await self._tier_ensure_auth(
                        primary, m.osds[primary].addr
                    )
                    await self.msgr.send_to(
                        m.osds[primary].addr, Message("osd_op", {
                            "tid": tid, "pool": pool_id, "ps": ps,
                            "oid": oid, "epoch": m.epoch, "ops": ops,
                            "reqid": reqid, "tier": True,
                        }), f"osd.{primary}",
                    )
                    reply = await asyncio.wait_for(
                        fut, max(0.5, deadline - time.monotonic())
                    )
                    rc = int(reply.get("rc", 0))
                    if rc == EPERM_RC and reauths < 3:
                        # revive-time auth race: the base primary
                        # rotated its service secrets while our
                        # ticket aged — refresh the secrets, re-run
                        # the authorizer exchange, and retry.  A
                        # PERSISTENT denial is not transient: after a
                        # few attempts surface the real EPERM rather
                        # than spinning mon refreshes into a
                        # misleading timeout
                        reauths += 1
                        self._tier_authed.discard(id(
                            await self.msgr.connect(
                                m.osds[primary].addr,
                                f"osd.{primary}")))
                        await self._refresh_service_secrets()
                    elif rc != MISDIRECTED_RC:
                        return (rc, reply.get("results", []),
                                int(reply.get("version", 0)))
                except (ConnectionError, asyncio.TimeoutError):
                    self._tier_futs.pop(tid, None)
                except ShardReadError:
                    # a failed re-auth exchange (stale ticket bounced)
                    # is part of the same transient window: keep
                    # retrying until the deadline
                    self._tier_futs.pop(tid, None)
            if time.monotonic() > deadline:
                raise ShardReadError(
                    f"tier op on {oid!r} to pool {pool_id} timed out"
                )
            await asyncio.sleep(0.1)

    def _tier_has_object(self, pg: PG, oid: str) -> bool:
        try:
            return self.store.exists(self._tier_cid(pg),
                                     GHObject(pg.pgid.pool, oid))
        except KeyError:
            return False

    async def _tier_promote(self, pg: PG, oid: str) -> None:
        """Pull a missing object up from the base pool through the
        normal backend write path (so replicas get it too); a promoted
        object starts CLEAN — flush has nothing to do until a client
        mutates it."""
        rc, results, _ = await self._tier_base_op(
            pg.pool.tier_of, oid,
            [{"op": "read", "off": 0}, {"op": "getxattrs"},
             {"op": "omap_get", "keys": None}],
        )
        if rc == ENOENT_RC:
            return                   # base miss: op sees ENOENT naturally
        if rc != OK:
            raise ShardReadError(f"promote of {oid!r} failed: rc {rc}")
        data = bytes(results[0].get("data", b""))
        promote_ops = [{"op": "writefull", "data": data}]
        for name, value in (results[1].get("attrs") or {}).items():
            if not str(name).startswith("tier."):
                promote_ops.append({"op": "setxattr", "name": name,
                                    "value": value})
        omap = results[2].get("kv") or {}
        if omap:
            promote_ops.append({"op": "omap_set", "kv": dict(omap)})
        prc, _, _ = await self._do_ops(pg, oid, promote_ops)
        if prc != OK:
            raise ShardReadError(f"promote write of {oid!r}: rc {prc}")
        log.dout(10, "%s: promoted %s from pool %d", self.entity, oid,
                 pg.pool.tier_of)

    async def _tier_prepare(self, pg: PG, oid: str, ops: list[dict],
                            mutating: bool) -> tuple[list[dict], int]:
        """Cache-pool op preamble: promote on miss, tag writeback
        mutations dirty IN THE SAME BATCH (atomic with the data), and
        propagate deletes to the base synchronously so an evicted
        object cannot resurrect from stale base state."""
        pool = pg.pool
        if pool.tier_of < 0 or not pool.cache_mode \
                or not pg.is_primary:
            return ops, 0
        pure_delete = all(op.get("op") == "remove" for op in ops)
        if oid and not pure_delete \
                and not self._tier_has_object(pg, oid):
            # one promote per object at a time: a concurrent op awaits
            # the winner instead of racing a second promote that could
            # clobber a just-committed client write with stale base data
            key = (pg.pgid, oid)
            inflight = self._tier_promoting.get(key)
            if inflight is not None:
                await asyncio.shield(inflight)
            elif not self._tier_has_object(pg, oid):
                fut = asyncio.get_running_loop().create_future()
                self._tier_promoting[key] = fut
                try:
                    await self._tier_promote(pg, oid)
                    fut.set_result(None)
                except BaseException as e:
                    fut.set_exception(e)
                    fut.exception()
                    raise
                finally:
                    self._tier_promoting.pop(key, None)
        if not mutating or pool.cache_mode != "writeback":
            return ops, 0
        if any(op.get("op") == "remove" for op in ops):
            rc, _, _ = await self._tier_base_op(
                pool.tier_of, oid, [{"op": "remove"}]
            )
            if rc not in (OK, ENOENT_RC):
                raise ShardReadError(
                    f"tier delete of {oid!r} in base: rc {rc}"
                )
            return ops, 0
        return ops + [{"op": "setxattr", "name": self.TIER_DIRTY,
                       "value": b"1"}], 1

    async def _tier_agent_loop(self) -> None:
        """Flush/evict agent (PrimaryLogPG agent_work): push dirty
        objects to the base pool, then evict clean cold objects (the
        current hit set is the recency signal) above the pool's
        target_max_objects ceiling."""
        interval = self.conf["osd_agent_interval"]
        while not self._stopped:
            try:
                await asyncio.sleep(interval)
                for pg in list(self.pgs.values()):
                    pool = pg.pool
                    if (not pg.is_primary or pg.state != STATE_ACTIVE
                            or pool.tier_of < 0
                            or pool.cache_mode != "writeback"):
                        continue
                    await self._tier_agent_pg(pg)
            except asyncio.CancelledError:
                return
            except (ShardReadError, KeyError, ValueError,
                    ConnectionError) as e:
                log.dout(5, "%s: tier agent pass failed: %s",
                         self.entity, e)

    async def _tier_agent_pg(self, pg: PG) -> None:
        cid = self._tier_cid(pg)
        try:
            heads = [o.name for o in self.store.list_objects(cid)
                     if o.snap == snaps.NOSNAP]
        except KeyError:
            return
        dirty_attr = XATTR_PREFIX + self.TIER_DIRTY
        clean: list[str] = []
        for name in heads:
            obj = GHObject(pg.pgid.pool, name)
            try:
                self.store.getattr(cid, obj, dirty_attr)
            except KeyError:
                clean.append(name)
                continue
            await self._tier_flush(pg, cid, obj)
            clean.append(name)
        # target_max_objects is POOL-wide; each PG polices its share,
        # remainder spread over the low pg ids so the shares SUM to the
        # ceiling (a floor of 0 everywhere would thrash-evict the whole
        # cache each pass)
        ceiling = pg.pool.target_max_objects
        pg_num = max(pg.pool.pg_num, 1)
        per_pg = ceiling // pg_num + (
            1 if pg.pgid.ps < ceiling % pg_num else 0
        )
        if ceiling and len(heads) > per_pg:
            cache = getattr(self, "_hit_sets", None) or {}
            entry = cache.get(pg.pgid)
            hot = (lambda n: entry[0].contains(n)) if entry \
                else (lambda n: False)
            victims = sorted(clean, key=lambda n: (hot(n), n))
            for name in victims[: len(heads) - per_pg]:
                # dirty re-check + remove under the SAME object lock
                # client writes serialize on: a write landing mid-pass
                # re-dirties and must never be evicted (base only has
                # the older flush). Direct backend call: eviction must
                # NOT propagate the delete to the base.
                async with pg.obj_lock(name):
                    try:
                        self.store.getattr(
                            cid, GHObject(pg.pgid.pool, name),
                            dirty_attr,
                        )
                        continue             # dirty again: keep it
                    except KeyError:
                        pass
                    await self._do_ops_replicated_locked(
                        pg, name, [{"op": "remove"}], "", None, None
                    )
                log.dout(10, "%s: evicted %s", self.entity, name)

    async def _tier_flush(self, pg: PG, cid: CollectionId,
                          obj: GHObject) -> None:
        data = self.store.read(cid, obj)
        flush_ops: list[dict] = [{"op": "writefull",
                                  "data": bytes(data)}]
        for name, value in self.store.getattrs(cid, obj).items():
            if name.startswith(XATTR_PREFIX) and not name.startswith(
                    XATTR_PREFIX + "tier."):
                flush_ops.append({
                    "op": "setxattr",
                    "name": name[len(XATTR_PREFIX):],
                    "value": bytes(value),
                })
        try:
            omap = self.store.omap_get(cid, obj)
        except KeyError:
            omap = {}
        if omap:
            flush_ops.append({"op": "omap_set", "kv": dict(omap)})
        v0 = self._obj_version(cid, obj)
        rc, _, _ = await self._tier_base_op(pg.pool.tier_of, obj.name,
                                            flush_ops)
        if rc != OK:
            raise ShardReadError(
                f"flush of {obj.name!r} to base: rc {rc}"
            )
        try:
            unchanged = self._obj_version(cid, obj) == v0
        except KeyError:
            return                   # deleted mid-flush: nothing to clear
        if unchanged:
            await self._do_ops(pg, obj.name,
                               [{"op": "rmxattr",
                                 "name": self.TIER_DIRTY}])
        # else: re-dirtied mid-flush — stays dirty, next pass reflushes

    # -- hit sets (reference osd/HitSet.cc + pg hit_set_* machinery) ------
    def _hitset_record(self, pg: PG, name: str) -> None:
        """Track an object access in the PG's current bloom set;
        rotate + archive when the period elapses."""
        pool = pg.pool
        if pool.hit_set_type != "bloom" or not pg.is_primary \
                or not name:
            return
        from ceph_tpu_torch.osd.hitset import BloomHitSet

        cache = getattr(self, "_hit_sets", None)
        if cache is None:
            cache = self._hit_sets = {}
        now = time.monotonic()
        entry = cache.get(pg.pgid)
        if entry is None:
            entry = cache[pg.pgid] = [BloomHitSet(seed=hash(pg.pgid)
                                                  & 0xFFFF), now]
        hs, start = entry
        hs.insert(name)
        period = pool.hit_set_period
        if period > 0 and now - start >= period:
            cache[pg.pgid] = [BloomHitSet(seed=hs.seed), now]
            # archive keys are WALL time: monotonic restarts at boot
            # and would sort fresh sets before persisted old ones
            asyncio.get_running_loop().create_task(
                self._hitset_archive(pg, hs, time.time())
            )

    def _hitset_cid(self, pg: PG) -> CollectionId:
        # PG-local stats live in the META collection: the DATA
        # collections must contain only client objects, or splitting
        # would have to guess which names are internal
        return pg_log.meta_cid(pg.pgid.pool, pg.pgid.ps)

    async def _hitset_archive(self, pg: PG, hs, start: float) -> None:
        """Persist a filled set; trim archives beyond hit_set_count."""
        from ceph_tpu_torch.msg.codec import encode as cenc

        cid = self._hitset_cid(pg)
        meta_oid = GHObject(pg.pgid.pool, "hit_set_meta")
        key = f"{start:017.6f}"
        tx = StoreTx()
        tx.write(cid, GHObject(pg.pgid.pool, f"hit_set_{key}"), 0,
                 cenc(hs.to_dict()))
        tx.omap_setkeys(cid, meta_oid, {key: b""})
        try:
            await self.store.queue_transactions(tx)
            archived = sorted(self.store.omap_get(cid, meta_oid))
            excess = archived[:-pg.pool.hit_set_count] \
                if pg.pool.hit_set_count > 0 else archived
            if excess:
                tx2 = StoreTx()
                for old in excess:
                    tx2.remove(cid, GHObject(pg.pgid.pool,
                                             f"hit_set_{old}"))
                tx2.omap_rmkeys(cid, meta_oid, list(excess))
                await self.store.queue_transactions(tx2)
        except (KeyError, ValueError, OSError) as e:
            log.derr("%s: hit_set archive failed: %s", self.entity, e)

    def _hitset_ls(self, pg: PG) -> dict:
        cache = getattr(self, "_hit_sets", None) or {}
        entry = cache.get(pg.pgid)
        cid = self._hitset_cid(pg)
        try:
            archived = sorted(self.store.omap_get(
                cid, GHObject(pg.pgid.pool, "hit_set_meta")
            ))
        except KeyError:
            archived = []
        return {
            "current_inserts": entry[0].count if entry else 0,
            "archived": archived,
        }

    def _hitset_contains(self, pg: PG, name: str) -> dict:
        from ceph_tpu_torch.msg.codec import decode as cdec
        from ceph_tpu_torch.osd.hitset import BloomHitSet

        cache = getattr(self, "_hit_sets", None) or {}
        entry = cache.get(pg.pgid)
        out = {"current": bool(entry and entry[0].contains(name)),
               "archives": {}}
        cid = self._hitset_cid(pg)
        for key in self._hitset_ls(pg)["archived"]:
            try:
                raw = self.store.read(
                    cid, GHObject(pg.pgid.pool, f"hit_set_{key}")
                )
                out["archives"][key] = \
                    BloomHitSet.from_dict(cdec(raw)).contains(name)
            except (KeyError, ValueError):
                out["archives"][key] = False
        return out

    _PG_STAT_TTL = 0.5

    def _perf_query_account(self, pg, conn, oid: str, ops, results,
                            lat: float) -> None:
        """Accumulate one completed client op into every active
        dynamic perf query (OSDPerfMetricCollector role).  Group keys
        per spec type: pool name, proven client entity, rbd image id
        (parsed from rbd_data.<id>.<objno> names — the rbd_support
        image-iostat source), or the first dotted name component."""
        # strip the rados-namespace wire prefix ("\x1d<ns>\x1d<name>")
        name = oid[1:].split("\x1d", 1)[1] if oid.startswith("\x1d") \
            and "\x1d" in oid[1:] else oid
        for qid, spec in self._perf_queries.items():
            t = spec.get("type", "")
            if t == "by_pool":
                key = pg.pool.name
            elif t == "by_client":
                key = str(getattr(conn, "peer_name", "") or "?")
            elif t == "rbd_image":
                if not name.startswith("rbd_data."):
                    continue
                key = name[len("rbd_data."):].rsplit(".", 1)[0]
            elif t == "by_object_prefix":
                key = name.split(".", 1)[0]
            else:
                continue
            c = self._pq_counters.setdefault(qid, {}).setdefault(key, {
                "ops": 0, "read_ops": 0, "write_ops": 0,
                "bytes_in": 0, "bytes_out": 0, "lat_sum": 0.0,
            })
            c["ops"] += 1
            c["lat_sum"] += lat
            for op in ops:
                if op.get("op") in READ_OPS:
                    c["read_ops"] += 1
                else:
                    c["write_ops"] += 1
                if isinstance(op.get("data"), (bytes, bytearray)):
                    c["bytes_in"] += len(op["data"])
            for res in results:
                if isinstance(res.get("data"), (bytes, bytearray)):
                    c["bytes_out"] += len(res["data"])

    def _pg_stats(self) -> list[dict]:
        """Per-primary-PG stats (the MPGStats payload the mgr folds into
        its PGMap digest, reference src/messages/MPGStats.h +
        src/osd/osd_types.h pg_stat_t): reference-style state string,
        object/byte counts from the primary shard, degraded counts from
        the missing sets.  The object/byte scan is O(objects), so per-PG
        results are cached for _PG_STAT_TTL (the reference avoids the
        scan entirely by maintaining pg_stat_t incrementally per op;
        a bounded-staleness cache keeps this poll off the op path)."""
        now = time.monotonic()
        cache = getattr(self, "_pg_stat_cache", None)
        if cache is None:
            cache = self._pg_stat_cache = {}
        out: list[dict] = []
        live = set()
        for pg in self.pgs.values():
            if not pg.is_primary:
                continue
            live.add(pg.pgid)
            hit = cache.get(pg.pgid)
            if hit is not None and now - hit[0] < self._PG_STAT_TTL \
                    and hit[2] == pg.state:
                out.append(hit[1])
                continue
            # degraded vs misplaced (the reference's distinction):
            # a log-derived hole means redundancy is LOST (degraded);
            # a backfill-shard hole means every object is still fully
            # redundant on the old holders and only its planned
            # destination lacks it (misplaced).  A drain/expansion
            # storm must show zero degraded throughout.
            missing = 0
            misplaced = 0
            if pg.missing:
                bf = set(pg.missing.backfill)
                for shard, need in pg.missing.by_shard.items():
                    if shard in bf:
                        misplaced += len(need)
                    else:
                        missing += len(need)
                if not pg.missing.by_shard and pg.missing.backfill:
                    # pre-plan interval: inventory not compared yet,
                    # but the remap already promises motion
                    misplaced = 1
            valid_acting = [o for o in pg.acting if o != NO_OSD]
            state = pg.state
            if state == STATE_ACTIVE:
                state = "active+clean" if not (missing or misplaced) \
                    else ("active+degraded" if missing
                          else "active+misplaced")
            elif state == STATE_RECOVERING:
                state = ("active+recovering+degraded" if missing
                         else "active+recovering+misplaced")
            if len(valid_acting) < pg.pool.size:
                state += "+undersized"
            num_objects = 0
            num_bytes = 0
            cid = (CollectionId(pg.pgid.pool, pg.pgid.ps,
                                pg.acting_shard_of(self.osd_id))
                   if pg.is_ec
                   else CollectionId(pg.pgid.pool, pg.pgid.ps))
            try:
                for oid in self.store.list_objects(cid):
                    if oid.snap != snaps.NOSNAP \
                            or self._is_whiteout(pg, oid.name):
                        continue
                    num_objects += 1
                    try:
                        num_bytes += int(
                            self.store.stat(cid, oid)["size"]
                        )
                    except KeyError:
                        pass
            except KeyError:
                pass
            if pg.is_ec:
                # primary shard bytes -> logical bytes (k data shards)
                num_bytes *= getattr(pg, "ec_k", 1) or 1
            stat = {
                "pgid": str(pg.pgid),
                "pool": pg.pgid.pool,
                "state": state,
                "num_objects": num_objects,
                "num_bytes": num_bytes,
                "degraded": missing,
                "misplaced": misplaced,
                "acting": list(pg.acting),
                "up": list(pg.up),
            }
            cache[pg.pgid] = (now, stat, pg.state)
            out.append(stat)
        for pgid in list(cache):
            if pgid not in live:
                del cache[pgid]
        return out

    # -- snap trimming (reference snap trimmer + SnapMapper) ---------------
    def _kick_snaptrim(self, pg: PG) -> None:
        pool = pg.pool
        if not pg.is_primary or pg.is_ec or not pool.removed_snaps:
            return
        if pg.snaptrim_task is not None:
            # a snap removed while a trim runs must not be skipped: the
            # running task re-checks this flag before exiting
            pg.snaptrim_again = True
            return
        task = asyncio.get_running_loop().create_task(self._snaptrim(pg))
        pg.snaptrim_task = task

        def _done(_t):
            pg.snaptrim_task = None
            if pg.snaptrim_again and not self._stopped:
                # a kick raced the task's exit: run another round
                self._kick_snaptrim(pg)
        task.add_done_callback(_done)

    async def _snaptrim(self, pg: PG) -> None:
        """Purge removed snaps: the SnapMapper index names the affected
        objects (no pool scan); each object's SnapSet drops the snap and
        clones left covering nothing are deleted. Runs as replicated
        transactions so every member trims identically; idempotent, so a
        new primary simply re-runs it."""
        mcid = snaps.mapper_cid(pg.pgid.pool, pg.pgid.ps)
        moid = snaps.mapper_oid(pg.pgid.pool)
        while not self._stopped and pg.state == STATE_ACTIVE:
            pg.snaptrim_again = False
            worked = False
            for snapid in list(pg.pool.removed_snaps):
                try:
                    omap = self.store.omap_get(mcid, moid)
                except KeyError:
                    return
                prefix = snaps.mapper_prefix(snapid)
                keys = [k for k in omap if k.startswith(prefix)]
                for key in keys:
                    if pg.state != STATE_ACTIVE or self._stopped:
                        return
                    worked = True
                    name = key[len(prefix):]
                    try:
                        await self._trim_object_snap(pg, name, snapid,
                                                     key)
                    except (ShardReadError, KeyError, ValueError) as e:
                        log.derr("pg %s: snaptrim %s@%d failed: %s",
                                 pg.pgid, name, snapid, e)
                        return      # retry on the next kick, not a spin
            if not worked and not pg.snaptrim_again:
                return

    async def _trim_object_snap(self, pg: PG, name: str, snapid: int,
                                mapper_key: str) -> None:
        async with pg.obj_lock(name):
            # under the object's op lock: a concurrent client write COWs
            # new clones and rewrites the SnapSet; interleaving would
            # apply a stale pruned copy over it
            await self._trim_object_snap_locked(pg, name, snapid,
                                                mapper_key)

    async def _trim_object_snap_locked(self, pg: PG, name: str,
                                       snapid: int,
                                       mapper_key: str) -> None:
        cid = CollectionId(pg.pgid.pool, pg.pgid.ps)
        head = GHObject(pg.pgid.pool, name)
        tx = StoreTx()
        removed_head = False
        try:
            ss = snaps.SnapSet.from_attr(
                self.store.getattr(cid, head, snaps.SS_ATTR)
            )
        except (KeyError, ValueError):
            ss = None
        if ss is not None:
            for clone in ss.prune_snap(snapid):
                tx.remove(cid, snaps.clone_oid(pg.pgid.pool, name, clone))
            if not ss.clones and not ss.head_exists:
                tx.remove(cid, head)       # whiteout with nothing left
                removed_head = True
            else:
                tx.setattr(cid, head, snaps.SS_ATTR, ss.to_attr())
        tx.omap_rmkeys(snaps.mapper_cid(pg.pgid.pool, pg.pgid.ps),
                       snaps.mapper_oid(pg.pgid.pool), [mapper_key])
        entry = pg.next_entry(
            pg.epoch, name,
            OP_DELETE if removed_head else OP_MODIFY,
            0 if removed_head else self._obj_version(cid, head),
        )
        pg_log.append_ops(tx, pg.pgid.pool, pg.pgid.ps, entry)
        await self._submit_replicated(pg, tx)

    def _obj_version(self, cid: CollectionId, obj: GHObject) -> int:
        try:
            return int(json.loads(
                self.store.getattr(cid, obj, VERSION_ATTR)
            )["version"])
        except (KeyError, ValueError):
            return 1

    # -- scrub (the chunky_scrub / scrub_compare_maps loop, PG.cc:2647,
    # driven here manually via `pg scrub` or periodically) ---------------
    def _digest_one(self, cid: CollectionId, obj: GHObject) -> dict:
        data = self.store.read(cid, obj)
        attrs = self.store.getattrs(cid, obj)
        omap = self.store.omap_get(cid, obj)
        acrc = 0xFFFFFFFF
        for key in sorted(attrs):
            acrc = crc32c(acrc, key.encode() + b"\0" + attrs[key])
        ocrc = 0xFFFFFFFF
        for key in sorted(omap):
            ocrc = crc32c(ocrc, key.encode() + b"\0" + omap[key])
        return {
            "size": len(data),
            "data_crc": crc32c(0xFFFFFFFF, data),
            "attrs_crc": acrc,
            "omap_crc": ocrc,
        }

    def _scrub_digest(self, cid: CollectionId, name: str) -> dict:
        """Per-object scrub-map entry: content digests of the head AND
        every snap clone (reference scrub maps include clones — rot in
        a snapshot must not pass as clean). A missing object digests as
        {"absent": True} so missing-on-one-member IS an inconsistency."""
        try:
            out = {
                "head": self._digest_one(cid, GHObject(cid.pool, name)),
                "clones": {},
            }
        except KeyError:
            return {"absent": True}
        for cand in self._clones_of(cid, name):
            out["clones"][str(cand.snap)] = self._digest_one(cid, cand)
        return out

    async def _handle_pg_scrub(self, conn: Connection, d: dict) -> None:
        tid = d.get("tid", 0)
        pgid = PGId(int(d["pool"]), int(d["ps"]))
        pg = self.pgs.get(pgid)
        if self.cephx:
            state = self._conn_auth.get(id(conn))
            pool_name = pg.pool.name if pg is not None else None
            if (state is None or not state.get("authed")
                    or not cap_allows(state.get("caps", ""), write=True,
                                      pool=pool_name)):
                try:
                    conn.send_message(Message("pg_scrub_reply", {
                        "tid": tid,
                        "report": {"error": "permission denied"},
                    }))
                except ConnectionError:
                    pass
                return
        if pg is None or not pg.is_primary or pg.state != STATE_ACTIVE:
            report = {"error": f"pg {pgid} not active-primary here"}
        else:
            try:
                report = await self._scrub_pg(pg, bool(d.get("repair")))
            except Exception as e:              # noqa: BLE001
                log.derr("pg %s: scrub failed: %s", pgid, e)
                report = {"error": f"scrub failed: {e}"}
        try:
            conn.send_message(Message("pg_scrub_reply",
                                      {"tid": tid, "report": report}))
        except ConnectionError:
            pass

    async def _scrub_pg(self, pg: PG, repair: bool = False) -> dict:
        """Scrub every head object of a PG: EC = device-recompute parity
        and compare (deep scrub is cheap on TPU); replicated = compare
        content digests across the acting set. ``repair`` heals
        inconsistencies from the authoritative copy."""
        names = sorted(await self._scrub_names(pg))
        details = []
        for name in names:
            if self._use_mclock:
                await self.op_scheduler.acquire("scrub")
            # serialize against mutations: a digest taken while a write
            # is mid-replication reads false inconsistency, and a repair
            # push landing after a newer acked write would revert it
            if pg.is_ec:
                async with pg.backend.object_lock(name):
                    rep = await self._scrub_ec_object(pg, name, repair)
            else:
                async with pg.obj_lock(name):
                    rep = await self._scrub_replicated_object(
                        pg, name, repair
                    )
            if not rep.get("clean"):
                details.append(rep)
        self.perf.inc("scrub_errors", len(details))
        report = {
            "pgid": str(pg.pgid), "objects": len(names),
            "errors": len(details), "repaired": repair,
            "inconsistent": details,
        }
        pg.last_scrub = report
        log.dout(5, "pg %s: scrub done, %d/%d inconsistent",
                 pg.pgid, len(details), len(names))
        return report

    async def _scrub_pg_batched(self, pg: PG,
                                repair: bool = True) -> dict:
        """Deep-scrub an EC PG through the ScrubEngine's batched sweep:
        one coalesced re-encode launch per shard-length group with the
        CRC epilogue fused into the verify launch, convictions drained
        through the batched repair path as the scrub mClock class.  The
        background loop uses this; the ``pg_scrub`` wire command keeps
        the per-object path, whose report carries full per-shard
        attribution for operators."""
        names = sorted(await self._scrub_names(pg))

        async def fallback(name: str, shards: list[int]) -> bool:
            # single-object convictions the batched drain demoted:
            # per-object rebuild under the object lock, like pg_scrub
            live = [s for s in shards if pg.acting[s] != NO_OSD]
            if not live:
                return False
            async with pg.backend.object_lock(name):
                await pg.backend.recover_shard(name, live)
            return True

        res = await self.scrub_engine.sweep_pg(
            pg.backend, names,
            epoch=(self.osdmap.epoch
                   if self.osdmap is not None else 0),
            pool=pg.pgid.pool, ps=pg.pgid.ps,
            repair=repair, repair_fallback=fallback,
        )
        self.perf.inc("scrub_errors", res["errors"])
        report = {"pgid": str(pg.pgid), **res}
        pg.last_scrub = report
        log.dout(5, "pg %s: batched scrub done, %d/%d inconsistent",
                 pg.pgid, res["errors"], res["objects"])
        return report

    async def _scrub_names(self, pg: PG) -> set[str]:
        """Union of object names across every acting member: an object
        missing on the primary must still be scrubbed (the reference
        compares scrub maps from ALL members)."""
        names: set[str] = set()
        for shard, osd in enumerate(pg.acting):
            if osd == NO_OSD:
                continue
            if osd == self.osd_id:
                names |= set(self._inventory(pg, shard))
                continue
            cid = (CollectionId(pg.pgid.pool, pg.pgid.ps, shard)
                   if pg.is_ec
                   else CollectionId(pg.pgid.pool, pg.pgid.ps))
            try:
                listed = await self.send_sub_op(
                    osd, "scrub_list", cid=_enc_cid(cid)
                )
                names |= {str(n) for n in listed}
            except (ShardReadError, KeyError, ConnectionError):
                pass            # unreachable peer: digest phase flags it
        return names

    async def _scrub_ec_object(self, pg: PG, name: str,
                               repair: bool) -> dict:
        try:
            rep = await pg.backend.scrub(name)
        except (KeyError, ShardReadError) as e:
            return {"object": name, "clean": False, "error": str(e)}
        if repair and not rep["clean"]:
            # attribution: per-shard hinfo crcs (and stale or missing
            # shard copies) pinpoint the corrupt shard; a parity
            # recompute mismatch alone cannot say WHICH shard rotted —
            # a corrupt data shard makes every parity column disagree.
            # With a crc/stale/missing culprit, rebuild it; otherwise
            # the data shards verified clean, so rebuild the
            # disagreeing parity.
            culprits = (set(rep.get("crc_mismatch", ()))
                        | set(rep.get("stale_version", ()))
                        | set(rep.get("missing_shards", ())))
            if culprits:
                bad = sorted(culprits)
            elif rep.get("hinfo"):
                # data shards verified clean by their crcs: the
                # disagreeing parity is the rot — safe to recompute
                bad = sorted(set(rep.get("parity_inconsistent", ())))
            else:
                # no per-shard crcs (hinfo invalidated by an overwrite):
                # a parity mismatch cannot be attributed — recomputing
                # parity from a possibly-rotten data shard would LAUNDER
                # the corruption into fresh parity. Leave inconsistent.
                rep["repair_error"] = (
                    "unattributable without per-shard crcs (hinfo)"
                )
                bad = []
            live = [s for s in bad
                    if pg.acting[s] != NO_OSD] if bad else []
            if live:
                try:
                    await pg.backend.recover_shard(name, live)
                    verify = await pg.backend.scrub(name)
                    rep["repaired"] = live
                    rep["clean_after_repair"] = verify["clean"]
                except (ShardReadError, KeyError) as e:
                    rep["repair_error"] = str(e)
        return rep

    async def _scrub_replicated_object(self, pg: PG, name: str,
                                       repair: bool) -> dict:
        cid = CollectionId(pg.pgid.pool, pg.pgid.ps)
        mine = self._scrub_digest(cid, name)

        async def peer_digest(osd: int):
            return await self.send_sub_op(osd, "scrub_obj",
                                          cid=_enc_cid(cid), oid=name)

        peers = [osd for osd in pg.acting
                 if osd not in (self.osd_id, NO_OSD)]
        results = await asyncio.gather(
            *(peer_digest(o) for o in peers), return_exceptions=True
        )

        def key(digest) -> str:
            return json.dumps(digest, sort_keys=True)

        # digest MAJORITY picks the authoritative copy — the primary's
        # own copy may be the rotten one, and blindly pushing it would
        # overwrite every good replica (be_select_auth_object role)
        groups: dict[str, list[int]] = {key(mine): [self.osd_id]}
        unreachable: list[int] = []
        for osd, r in zip(peers, results):
            if isinstance(r, KeyError):
                groups.setdefault(key({"absent": True}), []).append(osd)
            elif isinstance(r, BaseException):
                unreachable.append(osd)
            else:
                groups.setdefault(key(r), []).append(osd)
        best = max(groups.values(), key=len)
        ties = [g for g in groups.values() if len(g) == len(best)]
        if len(groups) == 1 and not unreachable:
            return {"object": name, "clean": True}
        rep = {"object": name, "clean": False}
        if len(ties) > 1:
            # no majority: attribution is indeterminate — blaming one
            # side would finger a possibly-healthy copy
            rep["inconsistent_osds"] = sorted(
                osd for g in groups.values() for osd in g
            ) + unreachable
            rep["attribution"] = "indeterminate"
            if repair:
                rep["repair_error"] =                     "no digest majority; refusing repair"
            return rep
        bad = sorted(
            osd for g in groups.values() if g is not best for osd in g
        ) + unreachable
        rep["inconsistent_osds"] = bad
        if not repair:
            return rep
        fixed = []
        auth_absent = best is groups.get(key({"absent": True}))
        try:
            if auth_absent:
                # the authoritative state IS deletion: a stale straggler
                # copy must be purged, not read from
                for osd in bad:
                    if osd == self.osd_id:
                        tx = self._local_rm_tx(pg, cid, name)
                        if tx.ops:
                            await self.store.queue_transactions(tx)
                    else:
                        await self.send_sub_op(osd, "purge",
                                               cid=_enc_cid(cid),
                                               oid=name)
                    fixed.append(osd)
                rep["repaired"] = fixed
                return rep
            if self.osd_id not in best:
                # the primary itself is the outlier: adopt a majority
                # copy before re-pushing
                src_osd = best[0]
                full = await self.send_sub_op(src_osd, "read_full",
                                              cid=_enc_cid(cid),
                                              oid=name)
                await self.store.queue_transactions(
                    self._full_state_tx(pg, cid, name, full)
                )
                fixed.append(self.osd_id)
            for osd in bad:
                if osd == self.osd_id:
                    continue
                await self._push_full_state(pg, cid, name, osd)
                fixed.append(osd)
        except (ShardReadError, KeyError, ConnectionError) as e:
            rep["repair_error"] = str(e)
        rep["repaired"] = fixed
        return rep

    async def _push_full_state(self, pg: PG, cid: CollectionId,
                               name: str, osd: int) -> None:
        """Replace a peer's copy (head + clones + snap index) with ours
        (the scrub-repair push; same shape as recovery push)."""
        obj = GHObject(pg.pgid.pool, name)
        tx = StoreTx()
        data = self.store.read(cid, obj)
        attrs = self.store.getattrs(cid, obj)
        omap = self.store.omap_get(cid, obj)
        tx.remove(cid, obj).write(cid, obj, 0, data)
        for aname, aval in attrs.items():
            tx.setattr(cid, obj, aname, aval)
        if omap:
            tx.omap_setkeys(cid, obj, omap)
        for cand in self._clones_of(cid, name):
            tx.remove(cid, cand)
            tx.write(cid, cand, 0, self.store.read(cid, cand))
            for aname, aval in self.store.getattrs(cid, cand).items():
                tx.setattr(cid, cand, aname, aval)
            comap = self.store.omap_get(cid, cand)
            if comap:
                tx.omap_setkeys(cid, cand, comap)
        self._mapper_keys_from_ss(tx, pg, name, attrs)
        await self.send_sub_op(osd, "tx", cid=_enc_cid(cid),
                               ops=encode_tx(tx))

    async def _scrub_loop(self) -> None:
        """Background scrubbing (osd_scrub_interval > 0): round-robin
        one active primary PG per tick.  Ticks are jittered by a
        per-OSD seeded rng (``osd_scrub_jitter``) so a fleet started
        together does not deep-scrub in lockstep, and the loop sits
        out whole ticks while the ScrubEngine is paused (SLO burning
        per mgr_qos, or admin) — an interrupted sweep's persisted
        cursor holds its place, so waiting loses nothing."""
        interval = self.conf["osd_scrub_interval"]
        jitter = float(self.conf["osd_scrub_jitter"])
        rng = random.Random(f"scrub-jitter:{self.osd_id}")
        cursor = 0
        while not self._stopped:
            try:
                await asyncio.sleep(
                    interval * (1.0 + jitter * rng.random()))
            except asyncio.CancelledError:
                return
            if self.osdmap is not None \
                    and "noscrub" in self.osdmap.flags:
                continue
            if self.scrub_engine.paused:
                continue
            ready = [pg for pg in self.pgs.values()
                     if pg.is_primary and pg.state == STATE_ACTIVE]
            if not ready:
                continue
            pg = ready[cursor % len(ready)]
            cursor += 1
            try:
                if pg.is_ec:
                    await self._scrub_pg_batched(pg)
                else:
                    await self._scrub_pg(pg)
            except asyncio.CancelledError:
                return
            except Exception as e:              # noqa: BLE001
                # anything else (interval change mid-scrub, backend
                # swapped away, ...) must not kill the loop for good
                log.derr("pg %s: background scrub failed: %s",
                         pg.pgid, e)

    def _local_rm_tx(self, pg: PG, cid: CollectionId,
                     name: str) -> StoreTx:
        tx = StoreTx()
        obj = GHObject(pg.pgid.pool, name)
        if self.store.exists(cid, obj):
            tx.remove(cid, obj)
        for cand in self._clones_of(cid, name):
            tx.remove(cid, cand)
        self._rm_mapper_keys(tx, pg, name)
        return tx

    def _full_state_tx(self, pg: PG, cid: CollectionId, name: str,
                       full: dict) -> StoreTx:
        """Replace the local object (head + clones + snap index) with a
        peer's full state (recovery pull / scrub-repair pull)."""
        tx = self._local_rm_tx(pg, cid, name)
        obj = GHObject(pg.pgid.pool, name)
        tx.write(cid, obj, 0, full["data"])
        for aname, aval in full["attrs"].items():
            tx.setattr(cid, obj, aname, aval)
        if full["omap"]:
            tx.omap_setkeys(cid, obj, full["omap"])
        for snapstr, cstate in full.get("clones", {}).items():
            cobj = snaps.clone_oid(pg.pgid.pool, name, int(snapstr))
            tx.write(cid, cobj, 0, cstate["data"])
            for aname, aval in cstate["attrs"].items():
                tx.setattr(cid, cobj, aname, aval)
            if cstate["omap"]:
                tx.omap_setkeys(cid, cobj, cstate["omap"])
        self._mapper_keys_from_ss(tx, pg, name, full["attrs"])
        return tx

    def _mapper_keys_from_ss(self, tx: StoreTx, pg: PG, name: str,
                             attrs: Mapping[str, bytes]) -> None:
        """Recovered objects must re-index their snaps: a clone without
        its SnapMapper keys would never be trimmed on this OSD."""
        raw = attrs.get(snaps.SS_ATTR)
        if not raw:
            return
        try:
            ss = snaps.SnapSet.from_attr(raw)
        except (ValueError, TypeError):
            return
        keys = {
            snaps.mapper_key(sn, name): b""
            for covered in ss.clone_snaps.values() for sn in covered
        }
        if keys:
            tx.omap_setkeys(snaps.mapper_cid(pg.pgid.pool, pg.pgid.ps),
                            snaps.mapper_oid(pg.pgid.pool), keys)

    def _rm_mapper_keys(self, tx: StoreTx, pg: PG, name: str) -> None:
        """Drop every SnapMapper index key naming this object."""
        mcid = snaps.mapper_cid(pg.pgid.pool, pg.pgid.ps)
        moid = snaps.mapper_oid(pg.pgid.pool)
        try:
            omap = self.store.omap_get(mcid, moid)
        except KeyError:
            return
        keys = [k for k in omap if k.endswith(f"/{name}")]
        if keys:
            tx.omap_rmkeys(mcid, moid, keys)

    def _clones_of(self, cid: CollectionId, name: str) -> list[GHObject]:
        """Snap-clone objects of ``name``. The head's SnapSet enumerates
        them in O(clones); the full collection scan survives only for a
        headless leftover (purge of a fully-deleted object)."""
        try:
            ss = snaps.SnapSet.from_attr(self.store.getattr(
                cid, GHObject(cid.pool, name), snaps.SS_ATTR
            ))
        except (KeyError, ValueError):
            return [cand for cand in self.store.list_objects(cid)
                    if cand.name == name and cand.snap != snaps.NOSNAP]
        out = []
        for c in ss.clones:
            cand = snaps.clone_oid(cid.pool, name, c)
            if self.store.exists(cid, cand):
                out.append(cand)
        return out

    def _is_whiteout(self, pg: PG, name: str) -> bool:
        cid = CollectionId(pg.pgid.pool, pg.pgid.ps)
        try:
            ss = snaps.SnapSet.from_attr(self.store.getattr(
                cid, GHObject(pg.pgid.pool, name), snaps.SS_ATTR
            ))
        except (KeyError, ValueError):
            return False
        return not ss.head_exists

    def _handle_pg_query(self, conn: Connection, d: dict) -> None:
        pgid = PGId(int(d["pgid"][0]), int(d["pgid"][1]))
        pg = self.pgs.get(pgid)
        shard = int(d["shard"])
        mode = str(d.get("mode", "log"))
        payload: dict = {
            "pgid": [pgid.pool, pgid.ps], "epoch": d["epoch"],
            "shard": shard, "osd": self.osd_id, "mode": mode,
        }
        if mode == "inventory":
            self.perf.inc("peer_inventory_scans")
            payload["objects"] = (
                self._inventory(pg, shard) if pg is not None else {}
            )
        else:
            entries, tail = pg_log.read_log(self.store, pgid.pool,
                                            pgid.ps)
            payload["log"] = {str(s): e.to_wire()
                              for s, e in entries.items()}
            payload["tail"] = tail
            pool = (self.osdmap.pools.get(pgid.pool)
                    if self.osdmap else None)
            if (pg.is_ec if pg is not None
                    else bool(pool and pool.pool_type == "erasure")):
                # EC-only signal; the collection scan is wasted work
                # (and event-loop latency) for replicated PGs
                payload["held"] = self._held_shards(pgid.pool, pgid.ps)
        conn.send_message(Message("pg_notify",
                                  self._sign_peer_payload(payload),
                                  priority=PRIO_HIGH))

    def _handle_pg_notify(self, d: dict) -> None:
        pgid = PGId(int(d["pgid"][0]), int(d["pgid"][1]))
        pg = self.pgs.get(pgid)
        if pg is None or not pg.is_primary or pg.epoch != int(d["epoch"]):
            return
        shard = int(d["shard"])
        if str(d.get("mode", "log")) == "inventory":
            info = pg.peer_infos.get(shard)
            if info is not None:
                info.objects = {
                    str(k): int(v) for k, v in d["objects"].items()
                }
            return
        pg.record_info(PeerInfo(
            shard, int(d["osd"]),
            log={int(s): LogEntry.from_wire(w)
                 for s, w in d.get("log", {}).items()},
            tail=int(d.get("tail", 0)),
            held=([int(x) for x in d["held"]]
                  if "held" in d else None),
        ))

    def _handle_pg_activate(self, d: dict) -> None:
        pgid = PGId(int(d["pgid"][0]), int(d["pgid"][1]))
        pg = self.pgs.get(pgid)
        # gate on the interval epoch: an activate from a primary of an
        # older interval must not flip a re-peering replica active
        # (require_same_or_newer_map role, reference OSD.cc)
        if (pg is not None and not pg.is_primary
                and int(d.get("epoch", 0)) == pg.epoch):
            pg.state = STATE_ACTIVE
            self.journal.emit("pg.state", epoch=pg.epoch,
                              pgid=str(pgid), state="active",
                              replica=True)
            if "log" in d:
                async def merge():
                    try:
                        await self._merge_log(pg, d)
                    except (KeyError, ValueError, OSError) as e:
                        log.derr("%s: activation merge for %s failed: %s",
                                 self.entity, pg.pgid, e)
                asyncio.get_running_loop().create_task(merge())

    def _maybe_trim(self, pg: PG) -> None:
        """Primary-side trim trigger: after enough appends, every acting
        member trims its own log (PGLog::trim; each OSD only trims its
        contiguous applied prefix, so an unapplied entry is never
        silently claimed)."""
        limit = self.conf["osd_pg_log_max_entries"]
        if pg.appended_since_trim < max(limit // 2, 8):
            return
        pg.appended_since_trim = 0
        asyncio.get_running_loop().create_task(
            self._trim_log(pg.pgid, limit)
        )
        for shard, osd in pg.acting_peers():
            self._send_osd(osd, Message("log_trim", {
                "pgid": [pg.pgid.pool, pg.pgid.ps], "limit": limit,
            }))

    # -- recovery ------------------------------------------------------------
    async def _recover(self, pg: PG, missing: MissingSet) -> int:
        """Rebuild stale shards per the log-derived missing sets
        (RecoveryOp READING->WRITING, ECBackend.h:249; replicated
        push/pull, ReplicatedBackend.cc). Delete entries propagate as
        removals — an object deleted while a member was away must not
        resurrect. Returns the number of FAILED recoveries (the caller
        must not merge/advance logs over unhealed objects)."""
        if fp.ACTIVE:
            try:
                await fp.fire("osd.recovery")
            except fp.FailPointError:
                return 1            # injected: retry on a later pass
        sem = asyncio.Semaphore(self.conf["osd_recovery_max_active"])
        if pg.is_ec:
            return await self._recover_ec(pg, missing, sem)
        return await self._recover_replicated(pg, missing, sem)

    async def _recover_ec(self, pg: PG, missing: MissingSet,
                          sem: asyncio.Semaphore) -> int:
        rebuild: dict[str, list[int]] = {}
        target_version: dict[str, int] = {}
        removals: list[tuple[int, str]] = []
        for shard, need in missing.by_shard.items():
            for name, entry in need.items():
                if entry.op == OP_DELETE:
                    removals.append((shard, name))
                else:
                    rebuild.setdefault(name, []).append(shard)
                    target_version[name] = entry.obj_version

        # EC position -> ALL announcing former holders (MissingLoc is a
        # location SET: a dead/stale first announcer must not mask a
        # usable second source for the same position)
        stray_pos: dict[int, list[int]] = {}
        for sosd, sinfo in pg.stray_sources.items():
            for pos in getattr(sinfo, "ec_shards", ()):
                srcs = stray_pos.setdefault(int(pos), [])
                if sosd not in srcs:
                    srcs.append(sosd)
        # acting members remapped to a NEW position still hold their
        # old-position collections (one store, many shard cids): they
        # are first-class decode sources too.  Without them a position
        # permutation has k intact copies on disk but zero readable
        # through the acting view — the stray machinery only covers
        # osds that LEFT the set.
        for info in pg.peer_infos.values():
            if info.shard <= PG.STRAY_SHARD_BASE:
                continue                 # strays announced above
            for pos in (info.held or ()):
                pos = int(pos)
                if not (0 <= pos < len(pg.acting)) \
                        or pg.acting[pos] == info.osd:
                    continue             # acting read path serves it
                srcs = stray_pos.setdefault(pos, [])
                if info.osd not in srcs:
                    srcs.append(info.osd)

        async def stray_read(pos: int, name: str, version: int,
                             shard_len: int):
            """Extra decode source for positions the acting set cannot
            serve (partial-overlap remap): a version-verified read from
            a former holder, falling through the announcer list.
            Raises ShardReadError so the backend's retry loop treats
            an unusable position like any failed shard."""
            from ceph_tpu_torch.osd.ec_backend import (
                VERSION_ATTR,
                ShardReadError,
            )

            scid = CollectionId(pg.pgid.pool, pg.pgid.ps, int(pos))
            last = f"shard {pos}: no stray source"
            for sosd in stray_pos.get(int(pos), ()):
                try:
                    if sosd == self.osd_id:
                        full = self._read_full_local(scid, name)
                    else:
                        full = await self.send_sub_op(
                            sosd, "read_full", cid=_enc_cid(scid),
                            oid=name,
                        )
                except (KeyError, IOError, ConnectionError) as e:
                    last = f"shard {pos}: stray osd.{sosd}: {e!r}"
                    continue
                try:
                    sver = int(json.loads(
                        full["attrs"][VERSION_ATTR])["version"])
                except (KeyError, ValueError, TypeError):
                    last = (f"shard {pos}: stray osd.{sosd} "
                            "corrupt version attr")
                    continue
                if version is not None and sver != version:
                    last = (f"shard {pos}: stray osd.{sosd} stale "
                            f"version {sver} (want {version})")
                    continue
                data = full["data"]
                if shard_len is not None and len(data) < shard_len:
                    last = (f"shard {pos}: stray short read "
                            f"{len(data)} < {shard_len}")
                    continue
                import numpy as _np

                return (_np.frombuffer(data[:shard_len], _np.uint8),
                        dict(full["attrs"]))
            raise ShardReadError(last)

        async def stray_shard_copy(name: str,
                                   shards: list[int]) -> int:
            """Whole-shard copy from former holders (wholesale remap:
            nothing among the acting set can reconstruct).  Returns
            the bytes copied (0 = failure) so motion accounting can
            reconcile against placement predictions."""
            if not all(t in stray_pos for t in shards):
                log.derr("pg %s: stray copy %s: positions %s not "
                         "all announced (%s)", pg.pgid, name, shards,
                         stray_pos)
                return 0
            copied = 0
            for t in shards:
                scid = CollectionId(pg.pgid.pool, pg.pgid.ps, t)
                full = None
                for sosd in stray_pos[t]:
                    try:
                        if sosd == self.osd_id:
                            full = self._read_full_local(scid, name)
                        else:
                            full = await self.send_sub_op(
                                sosd, "read_full",
                                cid=_enc_cid(scid), oid=name,
                            )
                        break
                    except (KeyError, IOError) as e:
                        log.derr("pg %s: stray copy %s shard %d from "
                                 "osd.%d failed: %r", pg.pgid, name,
                                 t, sosd, e)
                if full is None:
                    return 0
                copied += len(full["data"])
                obj = GHObject(pg.pgid.pool, name, shard=t)
                tx = StoreTx()
                tx.remove(scid, obj).write(scid, obj, 0, full["data"])
                for aname, aval in full["attrs"].items():
                    tx.setattr(scid, obj, aname, aval)
                if full["omap"]:
                    tx.omap_setkeys(scid, obj, full["omap"])
                target = pg.acting[t]
                if target == self.osd_id:
                    await self.store.queue_transactions(tx)
                else:
                    await self.send_sub_op(target, "tx",
                                           cid=_enc_cid(scid),
                                           ops=encode_tx(tx))
            self.perf.inc("recovery_ops")
            return copied

        async def recover_one(name: str, shards: list[int],
                              clazz: str = "recovery") -> bool:
            async with sem:
                if self._use_mclock:
                    await self.op_scheduler.acquire(clazz)
                try:
                    # the log entry names the version to converge to —
                    # a rewound object's stale shards still advertise
                    # the dropped (higher) version in their attrs, so
                    # the internal max-version guess would be wrong
                    nbytes = await pg.backend.recover_shard(
                        name, shards,
                        version=target_version.get(name) or None,
                        stray_read=stray_read if stray_pos else None,
                        stray_positions=sorted(stray_pos),
                    )
                    self.perf.inc("recovery_ops")
                    if clazz == "backfill" and nbytes:
                        self.perf.inc("backfill_bytes", int(nbytes))
                    return True
                except (ShardReadError, IOError, KeyError) as e:
                    copied = await stray_shard_copy(name, shards)
                    if copied:
                        if clazz == "backfill":
                            self.perf.inc("backfill_bytes",
                                          int(copied))
                        return True
                    log.derr("pg %s: recover %s failed: %s",
                             pg.pgid, name, e)
                    return False

        async def remove_one(shard: int, name: str) -> bool:
            async with sem:
                try:
                    await pg.backend.shards[shard].remove_shard(name)
                    return True
                except KeyError:
                    return True
                except (ShardReadError, IOError) as e:
                    log.derr("pg %s: recovery-remove %s/%d failed: %s",
                             pg.pgid, name, shard, e)
                    return False

        # planned motion vs failure repair: an object whose needed
        # shards are ALL backfill destinations (inventory holes on
        # remapped/new members — the data itself is still fully
        # redundant on the old holders) moves as the mClock "backfill"
        # class under a reservation and a resumable cursor.  Anything
        # touched by a log-derived hole is degraded data and repairs
        # as "recovery"; a mixed object decodes once on the recovery
        # side rather than twice.
        bf_shards = set(missing.backfill)
        rebuild_bf = {
            n: shards for n, shards in rebuild.items()
            if bf_shards and all(s in bf_shards for s in shards)
        }
        rebuild_rec = {n: s for n, s in rebuild.items()
                       if n not in rebuild_bf}
        use_engine = bool(self.conf["osd_ec_repair_batch"]) \
            and hasattr(pg.backend, "recover_batch")

        # batched repair engine first: objects sharing a failure
        # pattern drain through shared decode launches (grouped by
        # codec signature + lost-shard set, strategy-planned, paced by
        # the mClock recovery class at batch cost).  Whatever the
        # engine cannot serve — stray-only sources, probe failures,
        # singleton groups — falls through to the classic per-object
        # path below, which retries and mixes stray reads.
        engine_done: set[str] = set()
        if rebuild_rec and use_engine:
            try:
                engine_done = await self.repair.drain(
                    pg.backend, rebuild_rec, target_version)
            except Exception as e:       # noqa: BLE001
                log.derr("pg %s: batched repair drain failed: %r "
                         "(falling back to per-object recovery)",
                         pg.pgid, e)
                engine_done = set()
            if engine_done:
                self.perf.inc("recovery_ops", len(engine_done))
                log.dout(10, "pg %s: repair engine rebuilt %d/%d "
                         "objects in batches", pg.pgid,
                         len(engine_done), len(rebuild_rec))
        bf_failures = 0
        if rebuild_bf:
            bf_failures = await self._backfill_motion(
                pg, bf_shards, rebuild_bf, target_version,
                use_engine, recover_one)
        outcomes = await asyncio.gather(
            *(recover_one(n, s) for n, s in rebuild_rec.items()
              if n not in engine_done),
            *(remove_one(s, n) for s, n in removals),
        )
        return bf_failures + sum(1 for ok in outcomes if not ok)

    async def _backfill_motion(self, pg: PG, bf_shards: set[int],
                               rebuild_bf: dict[str, list[int]],
                               target_version: dict[str, int],
                               use_engine: bool,
                               recover_one) -> int:
        """Reservation-gated planned motion for one PG.

        The primary holds a LOCAL backfill slot plus a REMOTE slot on
        every backfill-target OSD before any object moves (Ceph's
        local_reserver/remote_reserver split: the pools are separate so
        two mutually-backfilling primaries cannot hold-and-wait each
        other into a deadlock — local slots queue, remote slots are
        try-and-retry).  Motion then drains through the BackfillEngine:
        batched coalesced launches, the mClock "backfill" class, and a
        persisted per-PG cursor so preempted motion resumes without
        re-moving objects.  Returns the number of objects NOT moved
        (preemption counts every remaining object as a failure so the
        caller activates degraded and the next peering round replans
        against the new map)."""
        from ceph_tpu_torch.osd.backfill import BackfillPreempted

        epoch = pg.epoch
        key = str(pg.pgid)
        targets = sorted({
            pg.acting[s] for s in bf_shards
            if 0 <= s < len(pg.acting)
            and pg.acting[s] not in (NO_OSD, self.osd_id)
        })
        waited = await self.backfill_local.reserve(key, epoch)
        if waited:
            self.perf.inc("backfill_reserve_waits")
        granted: list[int] = []
        try:
            if pg.epoch != epoch or self._stopped:
                return len(rebuild_bf)
            for osd in targets:
                while True:
                    if pg.epoch != epoch or self._stopped:
                        return len(rebuild_bf)
                    try:
                        rep = await self.send_sub_op(
                            osd, "backfill_reserve",
                            key=key, iepoch=epoch)
                        if rep and rep.get("granted"):
                            granted.append(osd)
                            break
                    except (ShardReadError, IOError, KeyError,
                            ConnectionError):
                        pass
                    self.perf.inc("backfill_reserve_waits")
                    await asyncio.sleep(0.2)
            self.journal.emit("backfill.reserve", epoch=epoch,
                              pgid=key, targets=targets,
                              objects=len(rebuild_bf),
                              queued=bool(waited))
            done: set[str] = set()
            if use_engine:
                try:
                    done = await self.backfill_engine.drain_pg(
                        pg.backend, rebuild_bf,
                        pool=pg.pgid.pool, ps=pg.pgid.ps,
                        epoch=epoch, versions=target_version,
                        current_epoch=lambda: pg.epoch,
                        gate=lambda: self.osdmap is not None
                        and "norebalance" in self.osdmap.flags,
                    )
                except BackfillPreempted:
                    return len(rebuild_bf)
                except Exception as e:       # noqa: BLE001
                    log.derr("pg %s: backfill drain failed: %r "
                             "(falling back to per-object motion)",
                             pg.pgid, e)
            if done:
                self.perf.inc("recovery_ops", len(done))
            left = [n for n in rebuild_bf if n not in done]
            if not left:
                return 0
            outcomes = await asyncio.gather(
                *(recover_one(n, rebuild_bf[n], clazz="backfill")
                  for n in left))
            failures = sum(1 for ok in outcomes if not ok)
            moved = len(left) - failures
            if moved:
                # per-object fallback motion still counts as backfill
                self.perf.inc("backfill_objects", moved)
            return failures
        finally:
            self.backfill_local.release(key)
            for osd in granted:
                task = asyncio.get_running_loop().create_task(
                    self._backfill_release_remote(osd, key))
                self._ungate_tasks.add(task)
                task.add_done_callback(self._ungate_tasks.discard)

    async def _backfill_release_remote(self, osd: int,
                                       key: str) -> None:
        try:
            await self.send_sub_op(osd, "backfill_release",
                                   key=key, iepoch=0)
        except (ShardReadError, IOError, KeyError, ConnectionError,
                asyncio.CancelledError):
            # the holder side also preempts stale reservations on a
            # newer-epoch reserve, so a lost release self-heals
            pass

    async def _recover_replicated(self, pg: PG, missing: MissingSet,
                                  sem: asyncio.Semaphore) -> int:
        cid = CollectionId(pg.pgid.pool, pg.pgid.ps)
        my_shard = (pg.acting.index(self.osd_id)
                    if self.osd_id in pg.acting else NO_OSD)

        def source_osd(name: str) -> int | None:
            for shard in missing.sources.get(name, ()):
                osd = pg.shard_osd(shard)
                if osd not in (self.osd_id, NO_OSD):
                    return osd
            return None

        def _local_rm(name: str) -> StoreTx:
            return self._local_rm_tx(pg, cid, name)

        def _full_state_tx(name: str, full: dict) -> StoreTx:
            return self._full_state_tx(pg, cid, name, full)

        async def pull(name: str, entry: LogEntry):
            if entry.op == OP_DELETE:
                # a delete may have left a whiteout (clones survive):
                # adopt the source's state when one exists
                osd = source_osd(name)
                if osd is not None:
                    try:
                        full = await self.send_sub_op(
                            osd, "read_full", cid=_enc_cid(cid), oid=name
                        )
                        await self.store.queue_transactions(
                            _full_state_tx(name, full)
                        )
                        return
                    except KeyError:
                        pass            # fully gone on the source too
                tx = _local_rm(name)
                if tx.ops:
                    await self.store.queue_transactions(tx)
                return
            osd = source_osd(name)
            if osd is None:
                log.derr("pg %s: no source for %s", pg.pgid, name)
                return
            full = await self.send_sub_op(osd, "read_full",
                                          cid=_enc_cid(cid), oid=name)
            await self.store.queue_transactions(
                _full_state_tx(name, full)
            )

        async def push(name: str, entry: LogEntry, osd: int):
            obj = GHObject(pg.pgid.pool, name)
            if entry.op == OP_DELETE and not self.store.exists(cid, obj):
                # fully gone here (trimmed whiteout included): the peer
                # must drop its head AND any stale clones/mapper keys
                await self.send_sub_op(osd, "purge", cid=_enc_cid(cid),
                                       oid=name)
            else:
                # the full local state — including a whiteout head and
                # any snap clones — replaces whatever the peer holds
                await self._push_full_state(pg, cid, name, osd)
            self.perf.inc("recovery_ops")

        async def run_one(coro) -> bool:
            async with sem:
                if self._use_mclock:
                    await self.op_scheduler.acquire("recovery")
                try:
                    await coro
                    return True
                except (ConnectionError, KeyError, IOError) as e:
                    log.derr("pg %s: recovery error: %s", pg.pgid, e)
                    return False

        # pull our own stale objects first (we push from our copy next)
        mine = missing.by_shard.get(my_shard, {})
        pulls = await asyncio.gather(*(
            run_one(pull(n, e)) for n, e in mine.items()
        ))
        pushes = []
        for shard, need in missing.by_shard.items():
            osd = pg.acting[shard]
            if osd in (self.osd_id, NO_OSD):
                continue
            pushes.extend(run_one(push(n, e, osd))
                          for n, e in need.items())
        outcomes = list(pulls) + list(await asyncio.gather(*pushes))
        return sum(1 for ok in outcomes if not ok)

    async def _settle_attempt(self, pg: PG, reqid: str):
        """Resolve a replayed op whose first attempt was allocated this
        interval but never acked. Returns (rc, version) to reply with,
        or (None, 0) when the first attempt provably wrote nothing and
        plain re-execution is correct."""
        a_oid, a_version = pg.attempted_reqids[reqid]
        if not pg.is_ec or pg.backend is None:
            # replicated: the blocking submit already exhausted its
            # retries; the outcome stays indeterminate until an interval
            # change lets the pg log decide
            return EIO_RC, a_version
        be: ECBackend = pg.backend
        if a_oid in be._dirty:
            if not await be.try_heal(a_oid):
                return MISDIRECTED_RC, 0      # repair still retrying
        # no dirty shards: decide from what the shards actually hold
        if a_version == 0:
            # a delete attempt: re-executing a remove is idempotent
            pg.attempted_reqids.pop(reqid, None)
            return None, 0
        try:
            have = 0
            for r in await be._attr_all(a_oid, VERSION_ATTR):
                if isinstance(r, BaseException):
                    continue
                try:
                    if int(json.loads(r)["version"]) >= a_version:
                        have += 1
                except (ValueError, TypeError, KeyError):
                    continue
        except ShardReadError:
            return EIO_RC, 0
        if have >= be.k:
            # fully readable at the attempted version: committed
            pg.register_reqid(reqid, pg.log_seq, a_version)
            return OK, a_version
        if have == 0:
            pg.attempted_reqids.pop(reqid, None)
            return None, 0                    # nothing landed: re-execute
        return EIO_RC, 0                      # partial beyond repair

    def _drain_waiters(self, pg: PG) -> None:
        waiters, pg.waiting_for_active = pg.waiting_for_active, []
        for conn, data in waiters:
            asyncio.get_running_loop().create_task(
                self._handle_osd_op(conn, data)
            )

    # -- client ops ----------------------------------------------------------
    async def _handle_osd_op(self, conn: Connection, d: dict) -> None:
        # op-lifetime payload budget: acquired before any work, released
        # when the op (including its fan-out and reply) is done
        cost = 256 + sum(
            len(op.get("data") or b"") for op in d.get("ops", ())
            if isinstance(op, dict)
        )
        await self.client_throttle.acquire(cost)
        try:
            await self._handle_osd_op_traced(conn, d)
        finally:
            self.client_throttle.release(cost)

    async def _handle_osd_op_traced(self, conn: Connection,
                                    d: dict) -> None:
        tctx = SpanCtx.from_wire(d.get("tctx"))
        if tctx is not None:
            # sampled op: the span covers the full primary-side life,
            # and the contextvar hands the context to sub-op fan-out
            with self.tracer.span("osd:do_op", parent=tctx,
                                  oid=str(d.get("oid", "?"))) as ctx:
                with use_span(ctx):
                    await self._handle_osd_op_inner(conn, d)
            # the do_op span itself only lands in the ring here; if
            # the op was slow enough to be retained, (re)attach the
            # now-complete span tree to its forensic record
            if self.op_tracker.has_slow_trace(ctx.trace_id):
                self.op_tracker.attach_spans(
                    ctx.trace_id, self.tracer.dump(ctx.trace_id)
                )
            return
        await self._handle_osd_op_inner(conn, d)

    async def _handle_osd_op_inner(self, conn: Connection,
                                   d: dict) -> None:
        tid = d.get("tid", 0)
        op_start = time.monotonic()
        top = None
        try:
            pgid = PGId(int(d["pool"]), int(d["ps"]))
            pg = self.pgs.get(pgid)
            if (pg is None or not pg.is_primary
                    or (self.osdmap is not None
                        and int(d.get("epoch", 0)) > self.osdmap.epoch)):
                self._reply(conn, tid, MISDIRECTED_RC,
                            epoch=self.osdmap.epoch if self.osdmap else 0)
                return
            if self.osdmap is not None and self.osdmap.is_blocklisted(
                    conn.peer_name, conn.peer_nonce, time.time()):
                # fenced client (OSDMap blocklist): hard-refuse, the
                # reference returns EBLOCKLISTED the same way
                self._reply(conn, tid, EBLOCKLISTED_RC,
                            epoch=self.osdmap.epoch)
                return
            pinfo = (self.osdmap.pools.get(pgid.pool)
                     if self.osdmap is not None else None)
            if (pinfo is not None and pinfo.full_quota
                    and "full_try" not in d.get("flags", ())) and any(
                    isinstance(op, dict)
                    and op.get("op") not in READ_CLASS_OPS
                    and op.get("op") not in _QUOTA_EXEMPT_OPS
                    for op in d.get("ops", ())):
                # pool over quota (pg_pool_t FLAG_FULL_QUOTA): writes
                # answer EDQUOT until the mon's sweep clears the flag
                self._reply(conn, tid, EDQUOT_RC,
                            epoch=self.osdmap.epoch)
                return
            if self.osdmap is not None \
                    and "pause" in self.osdmap.flags:
                # paused cluster (CEPH_OSDMAP_PAUSERD/WR): the client's
                # retry loop re-presents the op until unpause publishes
                # a new epoch (or its own timeout expires)
                self._reply(conn, tid, MISDIRECTED_RC,
                            epoch=self.osdmap.epoch)
                return
            if pg.state not in (STATE_ACTIVE,):
                pg.waiting_for_active.append((conn, d))
                return
            ops = list(d["ops"])
            if self._client_caps_deny(conn, pg, ops,
                                      str(d.get("oid", ""))):
                self._reply(conn, tid, EPERM_RC)
                return
            top = self.op_tracker.create(
                "osd_op(%s %s %s)" % (
                    d.get("reqid", "-"), d.get("oid", "?"),
                    "+".join(str(op.get("op")) for op in ops),
                )
            )
            span = current_span()
            if span is not None:
                top.trace_id = span.trace_id
            if self._use_mclock:
                await self.op_scheduler.acquire("client")
            top.mark("dispatched")
            self._hitset_record(pg, str(d.get("oid", "")))
            special = [op for op in ops
                       if op.get("op") in ("watch", "unwatch", "notify",
                                           "pgls")]
            if special:
                if len(ops) > 1:
                    # no silent partial execution: these ops don't compose
                    # into batches here
                    self._reply(conn, tid, EINVAL_RC, results=[],
                                version=0)
                    return
                await self._do_special_op(conn, pg, str(d["oid"]),
                                          ops[0], tid)
                return
            reqid = str(d.get("reqid", ""))
            mutating = any(op.get("op") not in READ_OPS
                           for op in ops)
            cached = self._reqid_replies.get(reqid) if reqid else None
            if cached is not None:
                self._reply(conn, tid, cached["rc"],
                            results=cached["results"],
                            version=cached["version"])
                return
            # a resend of an op still EXECUTING attaches to the original
            # attempt instead of re-executing (the reference parks the
            # replay on the in-progress repop's completion)
            inflight = self._inflight_ops.get(reqid) if reqid else None
            if inflight is not None:
                rc, results, version = await asyncio.shield(inflight)
                self._reply(conn, tid, rc, results=results,
                            version=version)
                return
            # the log-backed replay check: a resend whose mutation is
            # already COMMITTED in the pg log (possibly applied under a
            # previous primary and merged at activation) is answered
            # from history, never re-executed (osd_reqid_t-in-pg_log
            # dedup). Read-class ops in the batch still execute — only
            # mutations are unsafe to replay.
            if reqid and reqid in pg.reqid_index:
                _, obj_version = pg.reqid_index[reqid]
                results = []
                for op in ops:
                    if op.get("op") in READ_OPS:
                        _, sub_results, _ = await self._do_ops(
                            pg, str(d["oid"]), [op],
                            snapid=d.get("snapid"),
                        )
                        results.append(sub_results[0] if sub_results
                                       else {})
                    else:
                        results.append({})
                self._reply(conn, tid, OK, results=results,
                            version=obj_version)
                return
            # a resend of an op ATTEMPTED this interval but never acked:
            # settle the first attempt instead of re-executing (which
            # would double-apply its already-committed shard writes)
            if reqid and mutating and reqid in pg.attempted_reqids:
                rc2, version2 = await self._settle_attempt(pg, reqid)
                if rc2 is not None:
                    self._reply(conn, tid, rc2,
                                results=[{} for _ in ops],
                                version=version2,
                                epoch=self.osdmap.epoch
                                if self.osdmap else 0)
                    return
                # first attempt provably wrote nothing: safe re-execute
            track = bool(reqid) and mutating
            if track:
                # registered BEFORE any await (the tier preamble blocks
                # on network promotes): a resend during that window must
                # attach to this attempt, not double-execute
                fut = asyncio.get_running_loop().create_future()
                self._inflight_ops[reqid] = fut
            try:
                # cache tiering: promote-on-miss from the base pool,
                # mark writeback mutations dirty in the same batch, and
                # push deletes through to the base so an evicted object
                # cannot resurrect from stale base data
                exec_ops, trim_results = await self._tier_prepare(
                    pg, str(d["oid"]), ops, mutating
                )
                rc, results, version = await self._do_ops(
                    pg, str(d["oid"]), exec_ops, reqid,
                    d.get("snapc"), d.get("snapid"),
                )
                if trim_results and rc == OK:
                    results = results[:-trim_results]
            except BaseException:
                if track:
                    self._inflight_ops.pop(reqid, None)
                    if not fut.done():
                        fut.set_exception(
                            ShardReadError("op attempt failed")
                        )
                        fut.exception()     # mark retrieved
                raise
            if track:
                self._inflight_ops.pop(reqid, None)
                if not fut.done():
                    fut.set_result((rc, results, version))
            if track and rc == OK:
                # only a fully-acked commit registers for replay dedup:
                # registering earlier would falsely ack a failed or
                # partially-committed attempt from history
                pg.register_reqid(reqid, pg.log_seq, version)
                self._reqid_replies[reqid] = {
                    "rc": rc, "results": results, "version": version,
                }
                self._reqid_order.append(reqid)
                while len(self._reqid_order) > self._reqid_cap:
                    self._reqid_replies.pop(
                        self._reqid_order.popleft(), None
                    )
            # counted on completion only (misdirected resends, re-queued
            # waiters, and failed batches must not inflate the counters)
            self.perf.inc("op")
            if rc == OK:
                for op in ops:
                    kind = op.get("op", "")
                    if kind in READ_OPS:
                        self.perf.inc("op_r")
                    elif kind in ("write", "writefull", "append",
                                  "truncate", "remove", "create",
                                  "setxattr", "rmxattr", "omap_set",
                                  "omap_rm", "call"):
                        self.perf.inc("op_w")
                    if isinstance(op.get("data"), (bytes, bytearray)):
                        self.perf.inc("op_in_bytes", len(op["data"]))
            for res in results:
                if isinstance(res.get("data"), (bytes, bytearray)):
                    self.perf.inc("op_out_bytes", len(res["data"]))
            self.perf.tinc("op_latency", time.monotonic() - op_start)
            elapsed_us = (time.monotonic() - op_start) * 1e6
            self.perf.hinc("op_latency_us", elapsed_us)
            self.perf.hinc(
                "op_w_latency_us" if mutating else "op_r_latency_us",
                elapsed_us)
            # tenant-class attribution: the client-stamped qclass
            # routes the same sample into the class histogram the
            # per-class burn pairs window (only conf-declared labels
            # have a registered counter — others drop silently)
            qclass = d.get("qclass")
            if qclass in self._class_labels:
                self.perf.hinc(f"op_class_{qclass}_latency_us",
                               elapsed_us)
            if self._perf_queries and rc == OK:
                self._perf_query_account(
                    pg, conn, str(d.get("oid", "")), ops, results,
                    time.monotonic() - op_start)
            self._reply(conn, tid, rc, results=results, version=version)
        except ShardReadError as e:
            log.derr("%s: osd_op IO error: %s", self.entity, e)
            self.perf.inc("op_error")
            self._reply(conn, tid, EIO_RC)
        except (KeyError, ValueError, TypeError) as e:
            log.derr("%s: bad osd_op: %s", self.entity, e)
            self.perf.inc("op_error")
            self._reply(conn, tid, EINVAL_RC)
        finally:
            # every exit path closes the tracked op (replay answers,
            # misdirected replies, errors) so nothing lingers in
            # dump_ops_in_flight forever
            if top is not None and not top.done:
                spans = (self.tracer.dump(top.trace_id)
                         if top.trace_id and top.age
                         >= self.op_tracker.slow_op_seconds else None)
                self.op_tracker.finish(top, "replied", spans=spans)

    # -- watch / notify / pgls (the Watch.h:48 + pgls machinery of
    # PrimaryLogPG, collapsed to a per-PG watcher table) -----------------
    async def _do_special_op(self, conn: Connection, pg: PG, oid: str,
                             op: dict, tid: int) -> None:
        kind = op["op"]
        key = (pg.pgid.pool, pg.pgid.ps, oid)
        if kind == "watch":
            # watchers keyed by (client entity, cookie): cookies are only
            # unique per client (reference watch_info_t/entity pairing)
            wid = (conn.peer_name, int(op["cookie"]))
            self._watchers.setdefault(key, {})[wid] = conn
            self._reply(conn, tid, OK, results=[{}], version=0)
        elif kind == "unwatch":
            wid = (conn.peer_name, int(op["cookie"]))
            watchers = self._watchers.get(key, {})
            watchers.pop(wid, None)
            if not watchers:
                self._watchers.pop(key, None)
            self._reply(conn, tid, OK, results=[{}], version=0)
        elif kind == "notify":
            self._notify_id += 1
            nid = self._notify_id
            payload = bytes(op.get("payload", b""))
            timeout = float(op.get("timeout", 5.0))
            watchers = dict(self._watchers.get(key, {}))
            waiters = {}
            for (entity, cookie), wconn in watchers.items():
                fut = asyncio.get_running_loop().create_future()
                self._notify_waiters[(nid, entity, cookie)] = fut
                waiters[(entity, cookie)] = fut
                try:
                    wconn.send_message(Message("watch_notify", {
                        "notify_id": nid, "cookie": cookie,
                        "pool": pg.pgid.pool, "ps": pg.pgid.ps,
                        "oid": oid, "payload": payload,
                    }))
                except ConnectionError:
                    fut.set_exception(ConnectionError("watcher gone"))
            acks: dict[str, bytes] = {}
            timed_out: list[str] = []
            done = await asyncio.gather(*(
                asyncio.wait_for(f, timeout) for f in waiters.values()
            ), return_exceptions=True)
            for (entity, cookie), result in zip(waiters, done):
                self._notify_waiters.pop((nid, entity, cookie), None)
                if isinstance(result, BaseException):
                    timed_out.append(f"{entity}:{cookie}")
                else:
                    acks[f"{entity}:{cookie}"] = bytes(result)
            self._reply(conn, tid, OK, results=[{
                "acks": acks, "timeouts": timed_out,
            }], version=0)
        elif kind == "pgls":
            shard = (pg.acting.index(self.osd_id)
                     if self.osd_id in pg.acting else 0)
            names = sorted(
                n for n in self._inventory(pg, shard)
                if not self._is_whiteout(pg, n)
            )
            self._reply(conn, tid, OK, results=[{"objects": names}],
                        version=0)

    def _reply(self, conn: Connection, tid: int, rc: int, **extra) -> None:
        try:
            conn.send_message(Message(
                "osd_op_reply", {"tid": tid, "rc": rc, **extra,
                                 **reply_trace()}
            ))
        except ConnectionError:
            pass

    async def _do_ops(self, pg: PG, oid: str, ops: list[dict],
                      reqid: str = "", snapc: dict | None = None,
                      snapid: int | None = None):
        """The op interpreter (do_osd_ops, PrimaryLogPG.cc:5652)."""
        if pg.is_ec:
            if snapc is not None or snapid is not None:
                # EC pools reject snap machinery (reference restriction)
                return ENOTSUP_RC, [], 0
            return await self._do_ops_ec(pg, oid, ops, reqid)
        return await self._do_ops_replicated(pg, oid, ops, reqid,
                                             snapc, snapid)

    # -- EC op path ----------------------------------------------------------
    async def _do_ops_ec(self, pg: PG, oid: str, ops: list[dict],
                         batch_reqid: str = ""):
        be: ECBackend = pg.backend
        results: list[dict] = []
        version = 0
        # EC batches are not atomic across ops (each mutation is its own
        # shard fan-out), so the reqid rides ONLY the LAST mutating op's
        # log entry: its presence in the log proves the whole batch ran
        # to completion — a partial batch must re-execute on replay, not
        # be answered OK from the first op's entry
        mutating_kinds = ("write", "writefull", "append", "truncate",
                          "remove", "create", "setxattr")
        last_mut = max((i for i, op in enumerate(ops)
                        if op.get("op") in mutating_kinds), default=-1)
        try:
            for opi, op in enumerate(ops):
                kind = op["op"]
                reqid = batch_reqid if opi == last_mut else ""
                if kind == "write":
                    meta = await be.write(oid, op["data"],
                                          int(op.get("off", 0)),
                                          reqid=reqid)
                    version = meta.version
                    results.append({})
                elif kind == "writefull":
                    old = await be._read_meta(oid)
                    if old is not None and old.size > len(op["data"]):
                        await be.remove(oid, reqid=reqid)
                    meta = await be.write(oid, op["data"], 0,
                                          reqid=reqid)
                    version = meta.version
                    results.append({})
                elif kind == "append":
                    meta = await be._read_meta(oid)
                    off = meta.size if meta else 0
                    meta = await be.write(oid, op["data"], off,
                                          reqid=reqid)
                    version = meta.version
                    results.append({})
                elif kind == "truncate":
                    # overwrite-capable EC pools support truncate; shrink
                    # is read-back + rewrite (stripe bounds change)
                    nsize = int(op["size"])
                    meta = await be._read_meta(oid)
                    cur = meta.size if meta else 0
                    if nsize < cur:
                        keep = await be.read(oid, 0, nsize)
                        await be.remove(oid)
                        meta = await be.write(oid, keep, 0,
                                              reqid=reqid)
                    elif nsize > cur:
                        meta = await be.write(
                            oid, b"\0" * (nsize - cur), cur,
                            reqid=reqid,
                        )
                    elif meta is None:
                        meta = await be.write(oid, b"", 0, reqid=reqid)
                    version = meta.version
                    results.append({})
                elif kind == "read":
                    data = await be.read(oid, int(op.get("off", 0)),
                                         op.get("len"))
                    results.append({"data": data})
                elif kind == "stat":
                    meta = await be._read_meta(oid)
                    if meta is None:
                        return ENOENT_RC, results, 0
                    results.append({"size": meta.size,
                                    "version": meta.version})
                elif kind == "remove":
                    meta = await be._read_meta(oid)
                    if meta is None:
                        return ENOENT_RC, results, 0
                    await be.remove(oid, reqid=reqid)
                    results.append({})
                elif kind == "create":
                    meta = await be._read_meta(oid)
                    if meta is None:
                        meta = await be.write(oid, b"", 0, reqid=reqid)
                    version = meta.version
                    results.append({})
                elif kind == "setxattr":
                    await be.set_attr(oid, XATTR_PREFIX + op["name"],
                                      op["value"], reqid=reqid)
                    results.append({})
                elif kind == "getxattr":
                    raw = await be._get_attr_any(
                        oid, XATTR_PREFIX + op["name"]
                    )
                    if raw is None:
                        return ENOENT_RC, results, 0
                    results.append({"value": raw})
                elif kind == "getxattrs":
                    if await be._read_meta(oid) is None:
                        return ENOENT_RC, results, 0
                    attrs = await be.get_attrs(oid)
                    results.append({"attrs": {
                        k[len(XATTR_PREFIX):]: v
                        for k, v in attrs.items()
                        if k.startswith(XATTR_PREFIX)
                    }})
                elif kind.startswith("omap_") or kind == "call":
                    # parity with the reference: EC pools support neither
                    # omap nor (here) object classes, which depend on it
                    return ENOTSUP_RC, results, 0
                else:
                    return EINVAL_RC, results, 0
        except KeyError:
            return ENOENT_RC, results, 0
        except ECWriteDegraded as e:
            # a live shard missed the commit: not acked, but recoverable
            # (repair already scheduled). Hold the op until the repair
            # heals it or the interval changes, so a resend arriving
            # after our MISDIRECTED reply is decided by the pg log
            # (committed-and-merged answers OK; rewound re-executes) —
            # never blindly re-executed while the first attempt's shard
            # writes are still settling.
            log.dout(5, "pg %s: EC op degraded, client will retry: %s",
                     pg.pgid, e)
            epoch = pg.epoch
            deadline = time.monotonic() + 5.0
            while pg.epoch == epoch and time.monotonic() < deadline \
                    and not self._stopped:
                await asyncio.sleep(0.1)
            return MISDIRECTED_RC, results, 0
        except ShardReadError as e:
            log.derr("pg %s: EC op failed: %s", pg.pgid, e)
            return EIO_RC, results, 0
        return OK, results, version

    # -- replicated op path ----------------------------------------------------
    async def _do_ops_replicated(self, pg: PG, oid: str, ops: list[dict],
                                 reqid: str = "",
                                 snapc: dict | None = None,
                                 snapid: int | None = None):
        """The replicated-pool op interpreter. All reads go through a
        batch-local overlay of the pending mutations, so every op in the
        batch — including object-class calls — observes the effects of
        the ops before it, exactly as the reference's per-op OpContext
        does; the store itself only changes atomically at submit.

        Snapshots (the make_writeable / find_object_context role of
        PrimaryLogPG): mutations carrying a SnapContext newer than the
        object's SnapSet clone the pre-batch head first (copy-on-first-
        write); ``snapid`` reads resolve through the SnapSet to a clone
        or the head."""
        async with pg.obj_lock(oid):
            return await self._do_ops_replicated_locked(
                pg, oid, ops, reqid, snapc, snapid
            )

    async def _do_ops_replicated_locked(self, pg: PG, oid: str,
                                        ops: list[dict], reqid: str,
                                        snapc: dict | None,
                                        snapid: int | None):
        cid = CollectionId(pg.pgid.pool, pg.pgid.ps)
        head = GHObject(pg.pgid.pool, oid)
        obj = head
        results: list[dict] = []
        tx = StoreTx()
        in_store = self.store.exists(cid, head)
        ss: snaps.SnapSet | None = None
        if in_store:
            try:
                ss = snaps.SnapSet.from_attr(
                    self.store.getattr(cid, head, snaps.SS_ATTR)
                )
            except (KeyError, ValueError):
                ss = None
        ss_dirty = False
        exists = in_store and (ss is None or ss.head_exists)
        if snapid is not None and snapid != snaps.NOSNAP:
            # snapshot read: resolve to the covering clone or the head
            if any(op.get("op") not in READ_OPS for op in ops):
                return EINVAL_RC, results, 0    # snaps are read-only
            base = ss if ss is not None else snaps.SnapSet()
            if not in_store:
                return ENOENT_RC, results, 0
            target = base.resolve_read(snapid)
            if target is None:
                return ENOENT_RC, results, 0
            if target != snaps.NOSNAP:
                obj = snaps.clone_oid(pg.pgid.pool, oid, target)
                exists = self.store.exists(cid, obj)
            # head target: fall through with logical head existence
        version = 0
        if exists:
            try:
                version = int(json.loads(
                    self.store.getattr(cid, obj, VERSION_ATTR)
                )["version"])
            except (KeyError, ValueError):
                version = 1
        prior_version = version
        mutated = False
        cow_done = False

        def maybe_cow() -> None:
            """Clone the pre-batch head before its first mutation when
            snaps were taken since it last changed (make_writeable)."""
            nonlocal cow_done, ss, ss_dirty
            if cow_done:
                return
            cow_done = True
            if snapc is None:
                return
            s = ss if ss is not None else snaps.SnapSet()
            seq = int(snapc.get("seq", 0))
            if exists and s.seq < seq:
                newsnaps = sorted(
                    int(x) for x in snapc.get("snaps", ())
                    if int(x) > s.seq
                )
                if newsnaps:
                    cobj = snaps.clone_oid(pg.pgid.pool, oid, seq)
                    tx.clone(cid, head, cobj)
                    s.clones.append(seq)
                    s.clones.sort()
                    s.clone_snaps[seq] = newsnaps
                    # SnapMapper index: snap -> object, for the trimmer
                    tx.omap_setkeys(
                        snaps.mapper_cid(pg.pgid.pool, pg.pgid.ps),
                        snaps.mapper_oid(pg.pgid.pool),
                        {snaps.mapper_key(sn, oid): b""
                         for sn in newsnaps},
                    )
            if seq > s.seq:
                s.seq = seq
            ss = s
            ss_dirty = True

        # -- batch overlay: lazily materialized object state ------------
        odata: bytearray | None = None          # None = store is current
        oxattrs: dict[str, bytes] = {}
        rm_xattrs: set[str] = set()
        oomap: dict[str, bytes] = {}
        rm_omap: set[str] = set()

        def _in_store() -> bool:
            # an object created by THIS batch (tx.touch) exists logically
            # but is not in the store until submit
            return exists and self.store.exists(cid, obj)

        def cur_data() -> bytearray:
            nonlocal odata
            if odata is None:
                odata = bytearray(
                    self.store.read(cid, obj) if _in_store() else b""
                )
            return odata

        def cur_size() -> int:
            if odata is not None:
                return len(odata)
            return self.store.stat(cid, obj)["size"] if _in_store() else 0

        def read_range(off: int, length: int | None) -> bytes:
            if odata is not None:
                end = len(odata) if length is None else off + length
                return bytes(odata[off:end])
            if not _in_store():
                return b""
            return self.store.read(cid, obj, off, length)

        def get_xattr(key: str) -> bytes | None:
            if key in rm_xattrs:
                return None
            if key in oxattrs:
                return oxattrs[key]
            if wiped or not exists:
                return None     # store xattrs die with a remove/writefull
            try:
                return self.store.getattr(cid, obj, key)
            except KeyError:
                return None

        def all_xattrs() -> dict[str, bytes]:
            base = (dict(self.store.getattrs(cid, obj))
                    if not wiped and _in_store() else {})
            base.update(oxattrs)
            for key in rm_xattrs:
                base.pop(key, None)
            return base

        def get_omap(keys=None) -> dict[str, bytes]:
            base = (dict(self.store.omap_get(cid, obj))
                    if not wiped and _in_store() else {})
            base.update(oomap)
            for k in rm_omap:
                base.pop(k, None)
            if keys is not None:
                base = {k: base[k] for k in keys if k in base}
            return base

        def wipe() -> None:
            """Object replaced/removed: store state no longer shows
            through the overlay."""
            nonlocal odata, wiped
            odata = bytearray()
            oxattrs.clear()
            oomap.clear()
            rm_xattrs.clear()
            rm_omap.clear()
            wiped = True

        wiped = False      # a remove/writefull happened this batch

        def do_write(off: int, data: bytes) -> None:
            nonlocal mutated, exists
            maybe_cow()
            d = cur_data()
            end = off + len(data)
            if len(d) < end:
                d.extend(b"\0" * (end - len(d)))
            d[off:end] = data
            tx.write(cid, obj, off, data)
            mutated = exists = True

        def do_write_full(data: bytes) -> None:
            nonlocal mutated, exists, odata
            maybe_cow()
            wipe()
            odata = bytearray(data)
            tx.remove(cid, obj).write(cid, obj, 0, bytes(data))
            mutated = exists = True

        def do_setxattr(key: str, value: bytes) -> None:
            nonlocal mutated, exists
            maybe_cow()
            oxattrs[key] = bytes(value)
            rm_xattrs.discard(key)
            tx.setattr(cid, obj, key, bytes(value))
            mutated = exists = True

        def do_omap_set(kv: dict[str, bytes]) -> None:
            nonlocal mutated, exists
            maybe_cow()
            kv = {str(k): bytes(v) for k, v in kv.items()}
            oomap.update(kv)
            rm_omap.difference_update(kv)
            tx.omap_setkeys(cid, obj, kv)
            mutated = exists = True

        def do_omap_rm(keys) -> None:
            nonlocal mutated
            maybe_cow()
            keys = [str(k) for k in keys]
            rm_omap.update(keys)
            for k in keys:
                oomap.pop(k, None)
            tx.omap_rmkeys(cid, obj, keys)
            mutated = True

        for op in ops:
            kind = op["op"]
            if kind == "write":
                do_write(int(op.get("off", 0)), op["data"])
                results.append({})
            elif kind == "writefull":
                do_write_full(op["data"])
                results.append({})
            elif kind == "append":
                do_write(cur_size(), op["data"])
                results.append({})
            elif kind == "truncate":
                nsize = int(op["size"])
                maybe_cow()
                d = cur_data()
                if len(d) > nsize:
                    del d[nsize:]
                else:
                    d.extend(b"\0" * (nsize - len(d)))
                tx.truncate(cid, obj, nsize)
                mutated = exists = True
                results.append({})
            elif kind == "create":
                if not exists:
                    maybe_cow()
                    tx.touch(cid, obj)
                    mutated = exists = True
                elif op.get("exclusive"):
                    return EINVAL_RC, results, version
                results.append({})
            elif kind == "read":
                if not exists:
                    return ENOENT_RC, results, 0
                results.append({
                    "data": read_range(int(op.get("off", 0)),
                                       op.get("len")),
                })
            elif kind == "stat":
                if not exists:
                    return ENOENT_RC, results, 0
                results.append({"size": cur_size(), "version": version})
            elif kind == "remove":
                if not exists:
                    return ENOENT_RC, results, 0
                maybe_cow()
                wipe()
                tx.remove(cid, obj)
                if ss is not None and ss.clones:
                    # clones outlive the head: leave a WHITEOUT carrying
                    # the SnapSet (reference head whiteout semantics)
                    tx.touch(cid, obj)
                    ss.head_exists = False
                    ss_dirty = True
                mutated = True
                exists = False
                results.append({})
            elif kind == "setxattr":
                do_setxattr(XATTR_PREFIX + op["name"], op["value"])
                results.append({})
            elif kind == "getxattr":
                raw = get_xattr(XATTR_PREFIX + op["name"])
                if raw is None:
                    return ENOENT_RC, results, version
                results.append({"value": raw})
            elif kind == "getxattrs":
                if not exists:
                    return ENOENT_RC, results, version
                results.append({"attrs": {
                    k[len(XATTR_PREFIX):]: v
                    for k, v in all_xattrs().items()
                    if k.startswith(XATTR_PREFIX)
                }})
            elif kind == "rmxattr":
                key = XATTR_PREFIX + op["name"]
                maybe_cow()
                rm_xattrs.add(key)
                oxattrs.pop(key, None)
                tx.rmattr(cid, obj, key)
                mutated = True
                results.append({})
            elif kind == "omap_set":
                do_omap_set(op["kv"])
                results.append({})
            elif kind == "omap_get":
                if not exists:
                    # reference do_osd_ops: omap reads on a missing
                    # object are -ENOENT, same as read/stat/getxattr
                    return ENOENT_RC, results, 0
                results.append({"kv": get_omap(op.get("keys"))})
            elif kind == "omap_rm":
                do_omap_rm(op["keys"])
                results.append({})
            elif kind == "call":
                # server-side object class method (CEPH_OSD_OP_CALL,
                # do_osd_ops -> ClassHandler); reads/writes go through
                # the same batch overlay, mutations join tx atomically
                def _cls_read():
                    if not exists:
                        raise ClsError(ENOENT_RC, "no object")
                    return bytes(read_range(0, None))

                def _cls_stat():
                    if not exists:
                        raise ClsError(ENOENT_RC, "no object")
                    return {"size": cur_size(), "version": version}

                def _cls_getxattr(name: str):
                    return get_xattr(XATTR_PREFIX + name)

                def _cls_create():
                    nonlocal mutated, exists
                    tx.touch(cid, obj)
                    mutated = exists = True

                ctx = ClsContext(
                    read=_cls_read,
                    write_full=lambda data: do_write_full(data),
                    stat=_cls_stat,
                    getxattr=_cls_getxattr,
                    setxattr=lambda name, value: do_setxattr(
                        XATTR_PREFIX + name, value
                    ),
                    omap_get=get_omap,
                    omap_set=do_omap_set,
                    omap_rm=do_omap_rm,
                    create=_cls_create,
                )
                try:
                    out = ClassRegistry.instance().call(
                        str(op["cls"]), str(op["method"]), ctx,
                        bytes(op.get("in", b"")),
                    )
                except ClsError as e:
                    return e.rc, results, version
                results.append({"out": out})
            else:
                return EINVAL_RC, results, version
        if mutated:
            version += 1
            if ss is not None and exists and not ss.head_exists:
                ss.head_exists = True       # a write revived a whiteout
                ss_dirty = True
            whiteout = (ss is not None and not ss.head_exists
                        and bool(ss.clones))
            if ss_dirty and (exists or whiteout):
                # only onto a live head or whiteout: a plain remove must
                # not be resurrected by its own SnapSet attr write
                tx.setattr(cid, head, snaps.SS_ATTR, ss.to_attr())
            if exists or whiteout:
                tx.setattr(cid, obj, VERSION_ATTR, json.dumps(
                    {"size": cur_size(), "version": version}
                ).encode())
            # the pg log entry commits in the SAME transaction as the
            # mutation on every member (PGLog atomicity contract)
            entry = pg.next_entry(
                pg.epoch, oid,
                OP_MODIFY if exists else OP_DELETE,
                version if exists else 0, prior_version, reqid,
            )
            pg_log.append_ops(tx, pg.pgid.pool, pg.pgid.ps, entry)
            self._maybe_trim(pg)
            rc = await self._submit_replicated(pg, tx)
            if rc != OK:
                return rc, results, version
        return OK, results, version

    async def _submit_replicated(self, pg: PG, tx: StoreTx) -> int:
        """Primary-copy replication: local apply + MOSDRepOp to every
        replica; the ack requires EVERY live acting member to commit
        (the reference semantics — repop completion waits for the whole
        acting set). This is what makes the pg-log rewind rule safe: an
        entry absent from the authoritative log was never acked to any
        client. Degraded operation = acting-set holes (NO_OSD), not
        skipped live members."""
        # interval snapshot BEFORE the fan-out: a replica dying mid-send
        # costs the sub-op timeout, and the map recording it can land
        # during that wait — a snapshot taken after would compare the
        # re-push loop against the NEW interval and never exit
        epoch = pg.epoch
        await self.store.queue_transactions(tx)
        wire = encode_tx(tx)
        replicas = [osd for osd in set(pg.acting)
                    if osd not in (self.osd_id, NO_OSD)]
        results = await asyncio.gather(*(
            self.send_sub_op(osd, "tx",
                             cid=_enc_cid(CollectionId(pg.pgid.pool,
                                                       pg.pgid.ps)),
                             ops=wire)
            for osd in replicas
        ), return_exceptions=True)
        live = 1 + len(replicas)
        if live < min(pg.pool.min_size, len(pg.acting)):
            return EIO_RC
        failed = [osd for osd, r in zip(replicas, results)
                  if isinstance(r, BaseException)]
        if not failed:
            return OK
        # not committed everywhere: BLOCK and keep re-pushing (the
        # reference repop waits for the whole acting set). Resends of
        # this reqid attach to this attempt via _inflight_ops. Exit on
        # interval change (EIO -> the client resends and the pg-log
        # replay check decides: committed-and-merged answers OK, rewound
        # re-executes) or after a deadline. MISDIRECTED tells the client
        # to refresh the map and resend.
        cid_wire = _enc_cid(CollectionId(pg.pgid.pool, pg.pgid.ps))
        deadline = time.monotonic() + 20.0
        log.dout(5, "pg %s: copies missing on %s; blocking re-push",
                 pg.pgid, failed)
        while failed:
            if pg.epoch != epoch or self._stopped:
                return MISDIRECTED_RC
            if time.monotonic() > deadline:
                return EIO_RC
            await asyncio.sleep(0.1)
            retry = await asyncio.gather(*(
                self.send_sub_op(osd, "tx", cid=cid_wire, ops=wire)
                for osd in failed
            ), return_exceptions=True)
            failed = [osd for osd, r in zip(failed, retry)
                      if isinstance(r, BaseException)]
        return OK

    # -- sub ops (shard/replica server side) -----------------------------------
    async def send_sub_op(self, osd: int, kind: str, **args):
        ctx = current_span()
        if ctx is not None and "tctx" not in args:
            with self.tracer.span(f"osd:sub_op:{kind}:send",
                                  parent=ctx, ambient=True,
                                  to=osd) as child:
                return await self._send_sub_op_impl(
                    osd, kind, tctx=child.to_wire(), **args
                )
        return await self._send_sub_op_impl(osd, kind, **args)

    async def _send_sub_op_impl(self, osd: int, kind: str, **args):
        """Send one sub-op and await its reply (tid-correlated). Every
        sub-op carries the sender's PG interval-start epoch so a stale
        primary cannot replicate into a PG whose interval has moved on
        (the require_same_or_newer_map check on MOSDRepOp)."""
        if self.osdmap is None or not self.osdmap.is_up(osd):
            raise ShardReadError(f"osd.{osd} is down")
        if "iepoch" not in args and "cid" in args:
            cid = _dec_cid(args["cid"])
            pg = self.pgs.get(PGId(cid.pool, cid.pg))
            args["iepoch"] = pg.epoch if pg is not None else 0
        addr = self.osdmap.osds[osd].addr
        self._sub_tid += 1
        tid = self._sub_tid
        fut = asyncio.get_running_loop().create_future()
        self._sub_futures[tid] = (fut, osd)
        payload = {
            "tid": tid, "kind": kind, "from": self.osd_id,
            "epoch": self.osdmap.epoch, **args,
        }
        if self.cephx:
            sig = self._sub_op_sig(payload)
            if sig is not None:
                payload["sepoch"], payload["sig"] = sig
        try:
            await self.msgr.send_to(addr,
                                    Message("sub_op", payload,
                                            priority=PRIO_HIGH),
                                    f"osd.{osd}")
            reply = await asyncio.wait_for(fut, 10.0)
        except (ConnectionError, asyncio.TimeoutError) as e:
            self._sub_futures.pop(tid, None)
            raise ShardReadError(f"sub_op {kind} to osd.{osd}: {e}") from e
        rc = int(reply.get("rc", 0))
        if rc == ENOENT_RC:
            raise KeyError(args.get("oid", ""))
        if rc != 0:
            raise ShardReadError(f"sub_op {kind} on osd.{osd}: rc {rc}")
        return reply.get("value")

    async def _handle_sub_reply(self, d: dict) -> None:
        if self.cephx and not await self._sub_op_sig_ok(d):
            log.derr("%s: dropping unsigned/forged sub_reply",
                     self.entity)
            return
        entry = self._sub_futures.pop(int(d.get("tid", 0)), None)
        if entry is not None and not entry[0].done():
            entry[0].set_result(d)

    def _sub_op_stale(self, d: dict) -> bool:
        """True when a sub-op originates from an older PG interval than
        ours: applying it would let a partitioned ex-primary keep writing
        into a PG whose interval (and primary) has moved on (the reference
        drops rep-ops via same_interval_since checks on MOSDRepOp)."""
        if "cid" not in d:
            return False
        cid = _dec_cid(d["cid"])
        pg = self.pgs.get(PGId(cid.pool, cid.pg))
        if pg is None:
            # a write into a ps OUTSIDE our map's range from a sender
            # who is NOT ahead of us is a behind-peer writing into a
            # merged-away PG: applying it would resurrect a folded
            # child collection (an ahead sender — iepoch > our map —
            # is the split-forward case and stays allowed)
            pool = self.osdmap.pools.get(cid.pool)
            if pool is not None and cid.pg >= pool.pg_num \
                    and int(d.get("iepoch", 0)) <= self.osdmap.epoch:
                return True
            return False            # nothing known to protect yet
        return int(d.get("iepoch", 0)) < pg.epoch

    async def _handle_sub_op(self, conn: Connection, d: dict) -> None:
        tctx = SpanCtx.from_wire(d.get("tctx"))
        if tctx is not None:
            with self.tracer.span(
                f"osd:sub_op:{d.get('kind', '?')}", parent=tctx,
                ambient=True,
            ):
                await self._handle_sub_op_inner(conn, d)
            return
        await self._handle_sub_op_inner(conn, d)

    async def _handle_sub_op_inner(self, conn: Connection,
                                   d: dict) -> None:
        tid = d.get("tid", 0)
        if fp.ACTIVE:
            try:
                await fp.fire("osd.sub_op")
            except fp.FailPointError:
                self._sub_reply(conn, tid, EIO_RC)
                return
        if self.cephx and not await self._sub_op_sig_ok(d):
            log.derr("%s: rejecting unsigned/forged sub_op from %s",
                     self.entity, conn.peer_name)
            self._sub_reply(conn, tid, EPERM_RC)
            return
        try:
            kind = d["kind"]
            mutating = kind in ("tx", "write", "remove")
            if mutating and self._sub_op_stale(d):
                log.dout(5, "%s: dropping stale-interval sub_op %s from "
                         "osd.%s (iepoch %s)", self.entity, kind,
                         d.get("from"), d.get("iepoch"))
                self._sub_reply(conn, tid, ESTALE_RC)
                return
            value = None
            if kind == "tx":
                await self.store.queue_transactions(
                    decode_tx(list(d["ops"]))
                )
            elif kind == "backfill_reserve":
                # remote backfill reservation: the requesting primary
                # is about to push shards into this daemon — grant a
                # remote slot or tell it to wait (it retries; queueing
                # here would pin a wire round-trip for minutes)
                value = {"granted": self.backfill_remote.try_reserve(
                    str(d["key"]), int(d.get("iepoch", 0)))}
            elif kind == "backfill_release":
                self.backfill_remote.release(str(d["key"]))
            else:
                cid = _dec_cid(d["cid"])
                oid = GHObject(cid.pool, str(d.get("oid", "")),
                               shard=cid.shard)
                if kind == "write":
                    tx = StoreTx().write(cid, oid, int(d["off"]),
                                         d["data"])
                    for name, val in d.get("attrs", {}).items():
                        tx.setattr(cid, oid, name, val)
                    self._attach_log(tx, cid, d)
                    await self.store.queue_transactions(tx)
                elif kind == "read":
                    value = self.store.read(cid, oid, int(d["off"]),
                                            d.get("len"))
                elif kind == "getattr":
                    value = self.store.getattr(cid, oid, str(d["name"]))
                elif kind == "getattrs":
                    value = dict(self.store.getattrs(cid, oid))
                elif kind == "remove":
                    tx = StoreTx().remove(cid, oid)
                    self._attach_log(tx, cid, d)
                    await self.store.queue_transactions(tx)
                elif kind == "stat":
                    value = self.store.stat(cid, oid)
                elif kind == "scrub_obj":
                    value = self._scrub_digest(cid, str(d["oid"]))
                elif kind == "scrub_list":
                    pgid2 = PGId(cid.pool, cid.pg)
                    pg2 = self.pgs.get(pgid2)
                    value = (sorted(self._inventory(pg2, cid.shard))
                             if pg2 is not None else [])
                elif kind == "purge":
                    # remove head + clones + snap index keys for a name
                    # (recovery of a fully-deleted snapped object)
                    name = str(d["oid"])
                    tx = StoreTx()
                    plain = GHObject(cid.pool, name)
                    if self.store.exists(cid, plain):
                        tx.remove(cid, plain)
                    for cand in self._clones_of(cid, name):
                        tx.remove(cid, cand)
                    pgid2 = PGId(cid.pool, cid.pg)
                    pg2 = self.pgs.get(pgid2)
                    if pg2 is not None:
                        self._rm_mapper_keys(tx, pg2, name)
                    if tx.ops:
                        await self.store.queue_transactions(tx)
                elif kind == "read_full":
                    # a sharded cid (EC) stores shard-decorated oids
                    plain = (GHObject(cid.pool, str(d["oid"]),
                                      shard=cid.shard)
                             if cid.shard >= 0
                             else GHObject(cid.pool, str(d["oid"])))
                    clones = {}
                    for cand in self._clones_of(cid, plain.name):
                        clones[str(cand.snap)] = {
                            "data": self.store.read(cid, cand),
                            "attrs": dict(
                                self.store.getattrs(cid, cand)
                            ),
                            "omap": dict(self.store.omap_get(cid, cand)),
                        }
                    value = {
                        "data": self.store.read(cid, plain),
                        "attrs": dict(self.store.getattrs(cid, plain)),
                        "omap": dict(self.store.omap_get(cid, plain)),
                        "clones": clones,
                    }
                else:
                    self._sub_reply(conn, tid, EINVAL_RC)
                    return
            self._sub_reply(conn, tid, OK, value)
        except KeyError:
            self._sub_reply(conn, tid, ENOENT_RC)
        except Exception as e:               # noqa: BLE001
            log.derr("%s: sub_op failed: %s", self.entity, e)
            self._sub_reply(conn, tid, EIO_RC)

    def _attach_log(self, tx: StoreTx, cid: CollectionId, d: dict) -> None:
        """Ride the sender's pg log entry in the same transaction as the
        shard mutation (per-shard log atomicity, MOSDECSubOpWrite)."""
        if d.get("log"):
            pg_log.append_ops(tx, cid.pool, cid.pg,
                              LogEntry.from_wire(d["log"]))

    def _sub_reply(self, conn: Connection, tid: int, rc: int,
                   value=None) -> None:
        payload = {"tid": tid, "rc": rc, "value": value, **reply_trace()}
        if self.cephx:
            # replies carry the same service-secret MAC as requests:
            # a forged ack would otherwise count as a replica commit
            sig = self._sub_op_sig(payload)
            if sig is not None:
                payload["sepoch"], payload["sig"] = sig
        try:
            conn.send_message(Message("sub_reply", payload,
                                      priority=PRIO_HIGH))
        except ConnectionError:
            pass

    def _send_osd(self, osd: int, msg: Message) -> None:
        if self.osdmap is None or osd not in self.osdmap.osds:
            return
        msg.data.update(self._sign_peer_payload(msg.data))
        addr = self.osdmap.osds[osd].addr

        async def _send():
            try:
                await self.msgr.send_to(addr, msg, f"osd.{osd}")
            except ConnectionError as e:
                log.dout(10, "%s: send to osd.%d failed: %s",
                         self.entity, osd, e)

        asyncio.get_running_loop().create_task(_send())

    # -- heartbeats ------------------------------------------------------------
    def _heartbeat_peers(self) -> set[int]:
        """Up peers this OSD pings (maybe_update_heartbeat_peers role).
        With osd_heartbeat_peer_limit set, only the next ``limit`` up
        OSDs in id order (ring successors) — every OSD is then still
        watched by ``limit`` predecessors, but a 200-daemon cluster
        holds O(n·limit) connections instead of an O(n²) full mesh."""
        up = sorted(o for o, info in self.osdmap.osds.items()
                    if info.up and o != self.osd_id)
        limit = int(self.conf["osd_heartbeat_peer_limit"])
        if limit <= 0 or len(up) <= limit:
            return set(up)
        idx = bisect.bisect_left(up, self.osd_id)
        return {up[(idx + j) % len(up)] for j in range(limit)}

    async def _heartbeat_loop(self) -> None:
        """Peer liveness (handle_osd_ping bookkeeping, OSD.cc:5236)."""
        interval = self.conf["osd_heartbeat_interval"]
        grace = self.conf["osd_heartbeat_grace"]
        last_secret_pull = time.monotonic()
        while not self._stopped:
            try:
                await asyncio.sleep(interval)
            except asyncio.CancelledError:
                return
            if self.cephx:
                ttl = self.conf["auth_service_secret_ttl"]
                if time.monotonic() - last_secret_pull > ttl / 2:
                    last_secret_pull = time.monotonic()
                    await self._refresh_service_secrets()
            if self.osdmap is None:
                continue
            if fp.ACTIVE:
                try:
                    fp.fire_sync("osd.heartbeat")
                except fp.FailPointError:
                    continue        # injected silence: skip this round
            # slow-op beacon (MOSDBeacon role): the LIVE slow count is
            # what raises — and, back at zero, clears — the mon's
            # SLOW_OPS health check.  Re-reading the complaint time
            # each round picks up runtime `config set`.
            self.op_tracker.slow_op_seconds = float(
                self.conf["osd_op_complaint_time"]
            )
            slow_inflight = self.op_tracker.slow_inflight()
            self.monc.send_osd_beacon(
                self.osd_id,
                slow_inflight=slow_inflight,
                slow_total=self.op_tracker.slow_ops,
            )
            # flight recorder: per-beat mClock backlog sample — a
            # forensic timeline shows WHICH class's queue grew before
            # a burn (quiet beats are not recorded)
            depths = self.op_scheduler.queue_depths()
            if depths or slow_inflight:
                self.journal.emit(
                    "mclock.depth",
                    epoch=self.osdmap.epoch if self.osdmap else 0,
                    slow_inflight=slow_inflight, **depths)
            now = time.monotonic()
            peers = self._heartbeat_peers()
            for osd in list(self._hb_last_rx.keys() |
                            self._hb_first_tx.keys()):
                if osd not in peers:
                    self._hb_last_rx.pop(osd, None)
                    self._hb_first_tx.pop(osd, None)
            for osd in peers:
                self._send_osd(osd, Message(
                    "osd_ping", {"from": self.osd_id, "ts": now},
                    priority=PRIO_HIGH,
                ))
                last = self._hb_last_rx.get(osd)
                if last is None:
                    first = self._hb_first_tx.setdefault(osd, now)
                    silence = now - first
                else:
                    silence = now - last
                if silence > grace:
                    self.journal.emit(
                        "hb.miss",
                        epoch=self.osdmap.epoch if self.osdmap else 0,
                        peer=osd, silence_s=round(silence, 3))
                    self.monc.report_failure(osd, silence)
