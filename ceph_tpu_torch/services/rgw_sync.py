"""RGW multisite: asynchronous zone-to-zone data sync, graded.

Counterpart of ceph_tpu/services/rgw_sync.py: the same module over the
port's imports.

The role of reference src/rgw/rgw_data_sync.cc (5,054 LoC of coroutine
machinery) at -lite scale, keeping its defining design: the SOURCE zone
maintains per-bucket data logs (cls_rgw bilog, appended atomically by
the gateway on every mutation), and an independent SYNC AGENT on the
secondary zone tails those logs and replays the mutations — pull-based,
asynchronous, restartable, with the sync position persisted on the
SECONDARY (so a restarted agent resumes where it left off, and the
primary needs no knowledge of its peers). Two phases per bucket, exactly
like the reference:

- FULL SYNC: a new bucket is bootstrapped by snapshotting every shard's
  log position FIRST, then copying every listed object — mutations that
  land mid-copy are past the snapshot, so the incremental phase replays
  them and nothing is trimmed before it has been replayed.
- INCREMENTAL: replay log entries past the stored per-shard marker; a
  put copies the object's CURRENT content (replays converge to the
  newest state), a delete tolerates already-gone keys. Applied entries
  advance the marker; the source shard is trimmed up to the low-water
  mark (radosgw-admin datalog trim role).

Geo-replication extensions over the original agent:

- SHARDED CURSORS: the datalog is sharded by object key
  (``rgw_datalog_shards``); the agent keeps one persisted cursor per
  (bucket, shard) and replays/trims shards independently, with a
  deterministic per-shard exponential backoff on errors.
- LAST-WRITER-WINS: replicated puts stamp the source mtime and zone id
  into object metadata (``rgw-source-mtime`` / ``rgw-source-zone``);
  before overwriting, the agent compares (mtime, zone) pairs and skips
  stale incoming writes.  The pair is a pure function of the original
  client write and totally ordered (zone id breaks mtime ties), so two
  zones that both wrote the same key during a partition converge to the
  same winner no matter the replay order.
- MEASUREMENT: ``rgw-sync`` perf counters (replicated puts/deletes/
  bytes, reconciles, trims, conflicts, paced waits), a :meth:`lag`
  ledger pricing unreplicated entries in entries AND bytes per shard
  (the RPO cursor ledger the zone-loss drill grades against), and
  ``sync.{full,incr,trim}`` flight-recorder events.
- PACING: :meth:`set_rate` installs a token-bucket rate limit on
  replicated ops — the actuation point for the replication QoS class
  (``qos_replication_*``), so a burning client SLO sheds replication
  bandwidth down to a floor instead of letting it trample the tail.

This is the framework's geo/DCN replication analog (SURVEY §2.10
"cross-cluster" row): the data path between zones is ordinary object
IO, asynchronous with respect to client writes on the primary.
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.common.backoff import ExpBackoff
from ceph_tpu_torch.common.events import emit_proc
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.common.perf import CounterType, PerfCounters
from ceph_tpu_torch.common.qos import TokenBucket
from ceph_tpu_torch.services.rgw import RGWError, RGWLite

log = Dout("rgw-sync")

STATUS_OID = "rgw.sync.status"   # secondary-side omap: bucket/shard -> seq

# metadata keys carrying LWW provenance on replicated objects
META_MTIME = "rgw-source-mtime"
META_ZONE = "rgw-source-zone"


def _marker_key(bucket: str, shard: int) -> str:
    # NUL separator: bucket names may legally contain dots/digits, so a
    # dotted suffix would collide with a bucket literally named "b.1"
    return f"{bucket}\x00{shard}"


class RGWSyncAgent:
    def __init__(self, src: RGWLite, dst: RGWLite,
                 poll_interval: float = 0.2, trim: bool = True,
                 src_zone: str = "", dst_zone: str = "",
                 seed: int = 0):
        self.src = src
        self.dst = dst
        self.poll_interval = poll_interval
        self.trim = trim
        self.src_zone = src_zone
        self.dst_zone = dst_zone
        self.shards = max(1, int(getattr(src, "datalog_shards", 1)))
        self._task: asyncio.Task | None = None
        self._stopped = False
        self.synced_ops = 0
        # replication-class pacing (QoS actuation point): 0 = unlimited
        self.rate_ops = 0.0
        self._bucket: TokenBucket | None = None
        # per-(bucket, shard) error backoff: deterministic jitter, and
        # a not-before deadline so one failing shard never stalls the
        # healthy ones
        self._seed = seed
        self._backoff: dict[str, ExpBackoff] = {}
        self._defer_until: dict[str, float] = {}
        self.perf = PerfCounters(
            f"rgw-sync-{dst_zone or 'dst'}" if dst_zone else "rgw-sync")
        for key in ("sync_put_ops", "sync_del_ops",
                    "sync_reconcile_ops", "sync_bytes",
                    "sync_full_passes", "sync_incr_passes",
                    "sync_trims", "sync_retries",
                    "sync_conflict_skips", "sync_paced_waits",
                    "sync_purged", "sync_errors"):
            self.perf.add(key, CounterType.U64)
        for key in ("sync_trim_seq", "sync_lag_entries",
                    "sync_lag_bytes"):
            self.perf.add(key, CounterType.GAUGE)

    # -- pacing (replication QoS class actuation) -------------------------
    def set_rate(self, ops_per_s: float) -> None:
        """Install the replication-class pacing rate the QoS controller
        decided (0 disables pacing).  Burst = 1s of grants so a retune
        takes effect within the next handful of ops."""
        ops_per_s = max(0.0, float(ops_per_s))
        if ops_per_s == self.rate_ops:
            return
        self.rate_ops = ops_per_s
        if ops_per_s <= 0.0:
            self._bucket = None
            return
        now = asyncio.get_event_loop().time()
        self._bucket = TokenBucket(ops_per_s, max(1.0, ops_per_s), now)

    async def _pace(self) -> None:
        b = self._bucket
        if b is None:
            return
        loop = asyncio.get_event_loop()
        while not b.take(loop.time()):
            self.perf.inc("sync_paced_waits")
            await asyncio.sleep(max(b.retry_after(), 0.001))

    # -- sync position (persisted on the secondary) ----------------------
    async def _get_marker(self, bucket: str,
                          shard: int = 0) -> int | None:
        keys = [_marker_key(bucket, shard)]
        if shard == 0:
            keys.append(bucket)     # pre-shard agents stored bare names
        try:
            kv = await self.dst.ioctx.get_omap(STATUS_OID, keys)
        except RadosError as e:
            if e.rc == -2:
                return None
            raise
        for k in keys:
            if k in kv:
                return int(kv[k])
        return None

    async def _set_marker(self, bucket: str, shard: int,
                          seq: int) -> None:
        from ceph_tpu_torch.client.rados import ObjectOperation

        await self.dst.ioctx.operate(STATUS_OID, ObjectOperation()
                                     .create()
                                     .omap_set({
                                         _marker_key(bucket, shard):
                                         str(seq).encode(),
                                     }))

    async def markers(self) -> dict[str, dict[int, int]]:
        """All persisted cursors: bucket -> shard -> seq."""
        try:
            kv = await self.dst.ioctx.get_omap(STATUS_OID)
        except RadosError as e:
            if e.rc == -2:
                return {}
            raise
        out: dict[str, dict[int, int]] = {}
        for k, v in kv.items():
            if "\x00" in k:
                bucket, _, shard = k.rpartition("\x00")
                out.setdefault(bucket, {})[int(shard)] = int(v)
            else:
                out.setdefault(k, {}).setdefault(0, int(v))
        return out

    # -- last-writer-wins ------------------------------------------------
    @staticmethod
    def _lww_pair(got: dict, default_zone: str) -> tuple[float, str]:
        """The (mtime, zone) provenance pair of an object: replicated
        copies carry it in metadata; local client writes fall back to
        the index mtime and the owning zone's id."""
        meta = got.get("meta") or {}
        try:
            mtime = float(meta.get(META_MTIME, ""))
        except (TypeError, ValueError):
            mtime = float(got.get("mtime") or 0.0)
        zone = str(meta.get(META_ZONE) or default_zone)
        return (mtime, zone)

    async def _dst_pair(self, bucket: str,
                        key: str) -> tuple[float, str] | None:
        try:
            got = await self.dst.get_object(bucket, key)
        except (RGWError, RadosError) as e:
            if isinstance(e, RGWError) and e.code in (
                    "NoSuchKey", "NoSuchBucket"):
                return None
            if isinstance(e, RadosError) and e.rc == -2:
                return None
            raise
        return self._lww_pair(got, self.dst_zone)

    # -- object replay ----------------------------------------------------
    async def _replicate_put(self, bucket: str, key: str,
                             force: bool = False) -> None:
        try:
            got = await self.src.get_object(bucket, key)
        except RGWError as e:
            if e.code == "NoSuchKey":
                return          # deleted again since; the del entry follows
            raise
        pair = self._lww_pair(got, self.src_zone)
        if not force:
            local = await self._dst_pair(bucket, key)
            if local is not None and pair < local:
                # the destination already holds a newer write (total
                # order: mtime, then zone id) — applying would
                # un-converge
                self.perf.inc("sync_conflict_skips")
                return
        await self._pace()
        meta = dict(got.get("meta") or {})
        meta.setdefault(META_MTIME, repr(pair[0]))
        meta.setdefault(META_ZONE, pair[1])
        await self.dst.put_object(
            bucket, key, got["data"],
            content_type=got.get("content_type", "binary/octet-stream"),
            metadata=meta,
            tags=got.get("tags") or None,
        )
        self.perf.inc("sync_put_ops")
        self.perf.inc("sync_bytes", len(got.get("data") or b""))

    async def _replicate_del(self, bucket: str, key: str,
                             mtime: float = 0.0) -> None:
        if mtime > 0.0:
            local = await self._dst_pair(bucket, key)
            if local is not None and local > (mtime, self.src_zone):
                # a write newer than the delete landed here; LWW keeps it
                self.perf.inc("sync_conflict_skips")
                return
        await self._pace()
        try:
            await self.dst.delete_object(bucket, key)
            self.perf.inc("sync_del_ops")
        except RGWError as e:
            if e.code != "NoSuchKey":
                raise

    async def _reconcile(self, bucket: str, key: str) -> None:
        """Mirror the key's CURRENT source state.  Version-level ops
        (del-version restores/promotions) change what is current
        without being a plain put/del, so re-read and converge."""
        self.perf.inc("sync_reconcile_ops")
        try:
            got = await self.src.get_object(bucket, key)
        except RGWError as e:
            if e.code != "NoSuchKey":
                raise
            await self._replicate_del(bucket, key)
            return
        await self._pace()
        meta = dict(got.get("meta") or {})
        pair = self._lww_pair(got, self.src_zone)
        meta.setdefault(META_MTIME, repr(pair[0]))
        meta.setdefault(META_ZONE, pair[1])
        await self.dst.put_object(
            bucket, key, got["data"],
            content_type=got.get("content_type", "binary/octet-stream"),
            metadata=meta,
            tags=got.get("tags") or None,
        )

    # -- phases ------------------------------------------------------------
    async def _full_sync(self, bucket: str) -> dict[int, int]:
        """Bootstrap a bucket: EVERY shard's log position first, then
        copy everything (writes racing the copy land past the snapshot,
        so incremental replay covers them and trim — which only runs
        behind the replay cursor — can never discard them unreplayed).

        Full sync treats the source as AUTHORITATIVE: listed keys are
        copied unconditionally (no last-writer-wins skip) and
        destination keys absent from the source listing are PURGED.
        In the active-passive model the only way the destination
        diverges at bootstrap is a previous life of this zone: writes
        it acked before it died that never replicated out — exactly
        the loss the RPO ledger priced — so a revived zone resyncing
        from the promoted master rolls them back to converge
        bit-identically.  A fresh secondary's bucket is empty, so both
        rules are no-ops on normal bootstrap; LWW still governs the
        incremental phase, where both sides are live."""
        positions: dict[int, int] = {}
        for shard in range(self.shards):
            positions[shard] = int(
                (await self.src.log_list(bucket, after=0,
                                         max_entries=1, shard=shard))
                .get("max_seq", 0))
        if bucket not in await self.dst.list_buckets():
            await self.dst.create_bucket(bucket)
        marker = ""
        copied = 0
        src_keys: set[str] = set()
        while True:
            listing = await self.src.list_objects(bucket, marker=marker)
            for entry in listing["contents"]:
                src_keys.add(entry["key"])
                await self._replicate_put(bucket, entry["key"],
                                          force=True)
                self.synced_ops += 1
                copied += 1
            if not listing["is_truncated"]:
                break
            marker = listing["next_marker"]
        purged = 0
        marker = ""
        while True:
            listing = await self.dst.list_objects(bucket, marker=marker)
            for entry in listing["contents"]:
                if entry["key"] in src_keys:
                    continue
                await self._pace()
                try:
                    await self.dst.delete_object(bucket, entry["key"])
                except RGWError as e:
                    if e.code != "NoSuchKey":
                        raise
                self.perf.inc("sync_purged")
                purged += 1
            if not listing["is_truncated"]:
                break
            marker = listing["next_marker"]
        for shard, position in positions.items():
            await self._set_marker(bucket, shard, position)
            if self.trim and position > 0:
                # the copy mirrored every mutation at/below the
                # snapshot, so the entries behind it are replayed by
                # construction — trim them or idle shards hold their
                # bootstrap backlog forever
                await self.src.log_trim(bucket, position, shard=shard)
                self.perf.inc("sync_trims")
                emit_proc("sync.trim", bucket=bucket, shard=shard,
                          source=self.src_zone, upto=position)
        self.perf.inc("sync_full_passes")
        emit_proc("sync.full", bucket=bucket, zone=self.dst_zone,
                  source=self.src_zone, objects=copied, purged=purged,
                  positions={str(s): p for s, p in positions.items()})
        log.dout(5, "full sync of %s done at %r (purged %d)",
                 bucket, positions, purged)
        return positions

    async def _incremental(self, bucket: str, shard: int,
                           after: int) -> int:
        listing = await self.src.log_list(bucket, after=after,
                                          shard=shard)
        last = after
        applied = 0
        for entry in listing["entries"]:
            if entry["op"] == "put":
                await self._replicate_put(bucket, entry["key"])
            elif entry["op"] == "del":
                await self._replicate_del(
                    bucket, entry["key"],
                    mtime=float(entry.get("mtime") or 0.0))
            else:
                # del-version &co: converge on current source state
                await self._reconcile(bucket, entry["key"])
            last = int(entry["seq"])
            self.synced_ops += 1
            applied += 1
        if last != after:
            await self._set_marker(bucket, shard, last)
            self.perf.inc("sync_incr_passes")
            emit_proc("sync.incr", bucket=bucket, shard=shard,
                      zone=self.dst_zone, source=self.src_zone,
                      applied=applied, marker=last)
            if self.trim:
                await self.src.log_trim(bucket, last, shard=shard)
                self.perf.inc("sync_trims")
                self.perf.set("sync_trim_seq", last)
                emit_proc("sync.trim", bucket=bucket, shard=shard,
                          source=self.src_zone, upto=last)
        return last

    async def sync_once(self) -> int:
        """One pass over every source bucket and shard; returns the
        number of ops applied.  A failing (bucket, shard) backs off
        deterministically without stalling the others."""
        before = self.synced_ops
        now = asyncio.get_event_loop().time()
        for bucket in await self.src.list_buckets():
            try:
                marker0 = await self._get_marker(bucket, 0)
            except (RadosError, ConnectionError) as e:
                log.derr("marker read for %s failed: %s", bucket, e)
                self.perf.inc("sync_errors")
                continue
            if marker0 is None:
                try:
                    await self._full_sync(bucket)
                except (RGWError, RadosError, ConnectionError) as e:
                    log.derr("full sync of %s failed: %s", bucket, e)
                    self.perf.inc("sync_errors")
                continue
            for shard in range(self.shards):
                name = _marker_key(bucket, shard)
                if self._defer_until.get(name, 0.0) > now:
                    continue
                try:
                    after = marker0 if shard == 0 else \
                        await self._get_marker(bucket, shard)
                    await self._incremental(bucket, shard,
                                            after or 0)
                except (RGWError, RadosError, ConnectionError) as e:
                    log.derr("sync of %s shard %d failed: %s",
                             bucket, shard, e)
                    self.perf.inc("sync_errors")
                    self.perf.inc("sync_retries")
                    bo = self._backoff.setdefault(name, ExpBackoff(
                        seed=self._seed, name=name))
                    self._defer_until[name] = now + bo.next_delay()
                else:
                    if name in self._backoff:
                        self._backoff[name].reset()
                        self._defer_until.pop(name, None)
        return self.synced_ops - before

    # -- RPO ledger --------------------------------------------------------
    async def lag(self) -> dict:
        """Unreplicated backlog per (bucket, shard): entries AND bytes
        acked on the source but not yet replayed here.  This is the
        cursor ledger — in a zone loss, the bytes below are exactly the
        RPO the drill must measure."""
        out: dict = {"entries": 0, "bytes": 0, "buckets": {}}
        for bucket in await self.src.list_buckets():
            bout: dict = {"entries": 0, "bytes": 0, "shards": {}}
            for shard in range(self.shards):
                after = await self._get_marker(bucket, shard) or 0
                entries = 0
                size = 0
                while True:
                    listing = await self.src.log_list(
                        bucket, after=after, shard=shard)
                    got = listing.get("entries", [])
                    if not got:
                        break
                    for e in got:
                        entries += 1
                        size += int(e.get("size") or 0)
                    after = int(got[-1]["seq"])
                bout["shards"][shard] = {"entries": entries,
                                         "bytes": size}
                bout["entries"] += entries
                bout["bytes"] += size
            out["buckets"][bucket] = bout
            out["entries"] += bout["entries"]
            out["bytes"] += bout["bytes"]
        self.perf.set("sync_lag_entries", out["entries"])
        self.perf.set("sync_lag_bytes", out["bytes"])
        return out

    def status(self) -> dict:
        """Telemetry snapshot (radosgw-admin sync status role)."""
        return {
            "source_zone": self.src_zone,
            "dest_zone": self.dst_zone,
            "shards": self.shards,
            "running": self._task is not None and not self._stopped,
            "synced_ops": self.synced_ops,
            "rate_ops": self.rate_ops,
            "counters": self.perf.dump(),
        }

    # -- daemon form -------------------------------------------------------
    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while not self._stopped:
            try:
                await self.sync_once()
            except Exception as e:           # noqa: BLE001
                log.derr("sync pass failed: %s", e)
            try:
                await asyncio.sleep(self.poll_interval)
            except asyncio.CancelledError:
                return

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
