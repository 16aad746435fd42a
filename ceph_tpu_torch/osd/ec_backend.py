"""ECBackend: the erasure-coded object data path.

The write/read/recover pipeline of reference osd/ECBackend.cc re-designed
around batched device encode:

- writes: pad to stripe bounds, ONE batched device encode for all stripes
  (vs the per-stripe loop in ECUtil::encode, reference ECUtil.cc:123), then
  per-shard store transactions fan out concurrently (the in-process analog
  of the MOSDECSubOpWrite fan-out, ECBackend.cc:2090-2106; the networked
  OSD daemon drives the same object through messenger shards).
- partial overwrites: stripe-granular RMW under a per-object lock (the
  ExtentCache role, reference ExtentCache.h — pins the written extent while
  missing stripe fragments are read back).
- reads: data shards preferred; on shard failure/corruption falls back to
  minimum_to_decode + batched reconstruct
  (objects_read_and_reconstruct / get_min_avail_to_read_shards,
  reference ECBackend.cc:2364,1613).
- recovery: rebuild lost shards from survivors (RecoveryOp
  READING->WRITING, reference ECBackend.h:249-295).
- scrub: recompute parity on device and compare shard hashes
  (the deep-scrub compare, reference PG.cc:3053 scrub_compare_maps —
  recompute-and-compare is cheap on the device).

Shard IO goes through the ShardIO protocol so the same backend logic runs
over local stores (tests, single host) or network shards (OSD daemons).

Counterpart of ceph_tpu/osd/ec_backend.py on one torch device: the
backend runs on its codec's device (``codec.device``), and "device data"
is a ``torch.Tensor`` there (a CPU tensor included, so the CPU runs take
the resident path and count the same bytes as the JAX package).  The
multi-device planes (``mesh=``, ``mesh_coalescer=``) run over the port's
mesh (``parallel.mesh``): a ``ShardedApplier`` per matrix, the host
``MeshCoalescer`` (osd/mesh_coalesce.py) and the sharded CLAY/LRC
repairs.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import threading
import time
from dataclasses import dataclass
from typing import Mapping, Protocol, Sequence

import numpy as np
import torch

from ceph_tpu_torch.common import failpoint as fp
from ceph_tpu_torch.common.crc32c import crc32c
from ceph_tpu_torch.common.perf import CounterType, PerfCounters
from ceph_tpu_torch.common.tracing import current_span
from ceph_tpu_torch.ec import checksum as ec_checksum
from ceph_tpu_torch.ec.engine import (pad_batch_pow2, pad_batch_pow2_device,
                                      pow2_bucket, resolve_device)
from ceph_tpu_torch.osd.ec_util import HashInfo, StripeInfo, permute_axes
from ceph_tpu_torch.osd.repair import (RepairPlan, minimum_to_decode_cached,
                                 plan_repair, register_repair_counters)
from ceph_tpu_torch.osd.scrub import register_scrub_counters
from ceph_tpu_torch.store import (CollectionId, GHObject, ObjectStore,
                                  Transaction)
from ceph_tpu_torch.store.device_cache import (DeviceShardCache,
                                         register_resident_counters)

HINFO_ATTR = "hinfo"
VERSION_ATTR = "version"


# -- device time of EC launches ----------------------------------------------
# Every launch runs in a worker thread between two CUDA events on the
# current stream, around the uploads, kernels and download it enqueues
# there.  Nothing waits for them: a launch that downloads has passed its
# end event when it returns, and one whose result stays on the card is
# read at a later launch or download of its backend.  The stream is the
# default stream that every daemon of the process shares, so the
# interval also holds the other daemons' copies and kernels queued
# between the two events: it is the launch's span on the card, not its
# own device time.  ``ec_encode_device_us`` / ``ec_decode_device_us``
# take it; the host-timed ``ec_*_launch_us`` stay as the reference's.

# the card's clock is placed on the host's anew once a second, by an
# event bracketed by two host clock reads; a bracket wider than
# ANCHOR_BRACKET_NS (the loop thread held the interpreter lock, or a
# pageable copy held up the CUDA runtime) is not taken while the anchor
# in use is younger than ANCHOR_KEEP_NS, and is tried again after
# ANCHOR_RETRY_NS
ANCHOR_NS = 1_000_000_000
ANCHOR_BRACKET_NS = 20_000
ANCHOR_KEEP_NS = 5_000_000_000
ANCHOR_RETRY_NS = 100_000_000
_ANCHOR_TRIES = 8
# device index -> (anchor event, its perf_counter_ns, the anchor stream,
# when to take the next)
_ANCHORS: dict[int, tuple] = {}
_ANCHOR_LOCK = threading.Lock()
# the launch timings of the running coalesced flush, for its span
_FLUSH_TIMINGS: contextvars.ContextVar[list | None] = \
    contextvars.ContextVar("ec_flush_timings", default=None)


class LaunchTiming:
    """One launch: the worker thread's CPU and, on a CUDA device once
    ``done``, its device interval (``device_us``) and the interval's
    start on the ``perf_counter_ns`` clock (``dev_t_ns``)."""

    __slots__ = ("thread_ns", "device_us", "dev_t_ns", "_events")

    def __init__(self, thread_ns: int, events: tuple | None = None):
        self.thread_ns = thread_ns
        self.device_us = 0.0
        self.dev_t_ns = 0
        # (anchor event, its perf_counter_ns, start event, end event)
        self._events = events

    def done(self) -> bool:
        """True once the device interval is read: at once off a card,
        else when the end event has passed (no sync)."""
        if self._events is None:
            return True
        anchor, anchor_ns, start, end = self._events
        if not end.query():
            return False
        self.dev_t_ns = anchor_ns + round(anchor.elapsed_time(start) * 1e6)
        self.device_us = start.elapsed_time(end) * 1e3
        self._events = None
        return True


def _anchor(device: torch.device) -> tuple:
    """(event, perf_counter_ns, ...): the card's clock placed on the
    host's.  The event runs on a stream of its own, which holds nothing
    else, and is awaited without giving up the interpreter lock; of a
    few tries, the tightest host bracket wins."""
    now = time.perf_counter_ns()
    a = _ANCHORS.get(device.index)
    if a is not None and now < a[3]:
        return a
    with _ANCHOR_LOCK:
        a = _ANCHORS.get(device.index)
        if a is not None and now < a[3]:
            return a
        stream = a[2] if a is not None else torch.cuda.Stream(device)
        best = None
        for _ in range(_ANCHOR_TRIES):
            ev = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            ev.record(stream)
            while not ev.query():
                pass
            t1 = time.perf_counter_ns()
            if best is None or t1 - t0 < best[0]:
                best = (t1 - t0, ev, (t0 + t1) // 2)
        if a is not None and best[0] > ANCHOR_BRACKET_NS \
                and now - a[1] < ANCHOR_KEEP_NS:
            a = (a[0], a[1], stream, now + ANCHOR_RETRY_NS)
        else:
            a = (best[1], best[2], stream, best[2] + ANCHOR_NS)
        _ANCHORS[device.index] = a
        return a


def _timed_call(device: torch.device, fn, args: tuple):
    """``fn(*args)`` in a worker thread: (its result, LaunchTiming)."""
    th0 = time.thread_time_ns()
    if device.type != "cuda":
        out = fn(*args)
        return out, LaunchTiming(time.thread_time_ns() - th0)
    anchor, anchor_ns = _anchor(device)[:2]
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    out = fn(*args)
    end.record(stream)
    return out, LaunchTiming(time.thread_time_ns() - th0,
                             (anchor, anchor_ns, start, end))


def _launch_clock(t_ns: int, timings: list) -> dict:
    """The fields of an ``osd:ec:launch`` span: its start on the
    ``perf_counter_ns`` clock, the workers' CPU, and where the launch
    ran on a card, its device interval on the same clock."""
    clock = {"t_ns": t_ns,
             "thread_ms": round(sum(t.thread_ns for t in timings) / 1e6,
                                6)}
    dev = [t for t in timings if t.device_us]
    if dev:
        first = min(t.dev_t_ns for t in dev)
        last = max(t.dev_t_ns + round(t.device_us * 1e3) for t in dev)
        clock["dev_t_ns"] = first
        clock["dev_ms"] = round((last - first) / 1e6, 6)
    return clock


class ShardIO(Protocol):
    """One shard's IO endpoint (local store or remote OSD). ``log`` on
    mutations is an optional PG log entry applied atomically with the
    shard write on the owning OSD (the per-shard pg_log ride-along of
    MOSDECSubOpWrite, reference ECBackend.cc:2090)."""

    async def write_shard(self, oid: str, offset: int, data: bytes,
                          attrs: Mapping[str, bytes],
                          log=None) -> None: ...
    async def read_shard(self, oid: str, offset: int = 0,
                         length: int | None = None) -> bytes: ...
    async def get_attr(self, oid: str, name: str) -> bytes: ...
    async def remove_shard(self, oid: str, log=None) -> None: ...
    async def stat_shard(self, oid: str) -> dict: ...


class LocalShard:
    """ShardIO over a local ObjectStore collection."""

    def __init__(self, store: ObjectStore, cid: CollectionId, pool: int,
                 shard: int):
        self.store = store
        self.cid = cid
        self.pool = pool
        self.shard = shard

    def _oid(self, name: str) -> GHObject:
        return GHObject(self.pool, name, shard=self.shard)

    def _log_ops(self, t: Transaction, log) -> Transaction:
        if log is not None:
            from ceph_tpu_torch.osd import pg_log
            pg_log.append_ops(t, self.cid.pool, self.cid.pg, log)
        return t

    async def write_shard(self, oid, offset, data, attrs, log=None):
        if fp.ACTIVE:
            await fp.fire("ec.shard_write")
            await fp.fire(f"ec.shard_write.{self.shard}")
        t = Transaction().write(self.cid, self._oid(oid), offset, data)
        for name, val in attrs.items():
            t.setattr(self.cid, self._oid(oid), name, val)
        await self.store.queue_transactions(self._log_ops(t, log))

    async def read_shard(self, oid, offset=0, length=None):
        return self.store.read(self.cid, self._oid(oid), offset, length)

    async def get_attr(self, oid, name):
        return self.store.getattr(self.cid, self._oid(oid), name)

    async def remove_shard(self, oid, log=None):
        await self.store.queue_transactions(self._log_ops(
            Transaction().remove(self.cid, self._oid(oid)), log
        ))

    async def stat_shard(self, oid):
        return self.store.stat(self.cid, self._oid(oid))

    async def get_attrs(self, oid):
        return self.store.getattrs(self.cid, self._oid(oid))


class ShardReadError(IOError):
    pass


class ECWriteDegraded(ShardReadError):
    """A live shard missed a strict-mode mutation: the op is NOT acked
    (retryable — the data remains reconstructable and repair is already
    scheduled), distinct from an unrecoverable >m failure."""


@dataclass
class ECObjectMeta:
    size: int               # logical object size
    version: int


class ExtentCache:
    """Logical-extent cache for the EC overwrite pipeline (the role of
    reference src/osd/ExtentCache.h: pin recently written extents so a
    sub-stripe overwrite can merge WITHOUT re-reading + decoding k
    shards).  Lives inside one primary's ECBackend — all mutations flow
    through it under the per-object lock, and the backend (with its
    cache) is rebuilt at every peering interval, so coherence holds by
    construction.  Extents are coalesced per object; the whole cache is
    LRU-bounded by bytes."""

    def __init__(self, max_bytes: int = 8 << 20):
        from collections import OrderedDict

        self.max_bytes = max_bytes
        # oid -> sorted list of [start, bytearray] non-overlapping
        self._objs: "OrderedDict[str, list]" = OrderedDict()
        self._bytes = 0              # running total (trim is O(evicted))
        self.hits = 0
        self.misses = 0
        # invalidation generations: a writer captures generation(oid)
        # before its (possibly coalesced, so arbitrarily delayed) encode
        # and passes it to note_write, which drops the note if an
        # invalidate() landed in between — a completed-late write must
        # not resurrect extents that were invalidated while it was in
        # flight.  The per-oid ints are tiny and the backend (with its
        # cache) is rebuilt every peering interval, so growth is bounded
        # by the interval's invalidated-object count.
        self._epoch = 0
        self._gen: dict[str, int] = {}

    def get(self, oid: str, start: int, length: int) -> bytes | None:
        """The extent IFF fully covered; None = caller must read."""
        if length <= 0:
            return b""
        extents = self._objs.get(oid)
        if extents is None:
            self.misses += 1
            return None
        for estart, data in extents:
            if estart <= start and start + length <= estart + len(data):
                self._objs.move_to_end(oid)
                self.hits += 1
                return bytes(data[start - estart:
                                  start - estart + length])
        self.misses += 1
        return None

    def generation(self, oid: str) -> tuple[int, int]:
        """Invalidation generation token for ``oid``; capture before a
        write's encode, hand back to note_write (see __init__)."""
        return (self._epoch, self._gen.get(oid, 0))

    def note_write(self, oid: str, start: int, data: bytes,
                   gen: tuple[int, int] | None = None) -> None:
        """Record the post-write logical content of an aligned region,
        coalescing with overlapping/adjacent extents.  ``gen`` (from
        generation()) suppresses the note when an invalidate()/clear()
        superseded it while the write was in flight."""
        if gen is not None and gen != self.generation(oid):
            return
        if not len(data):
            return
        extents = self._objs.setdefault(oid, [])
        new_start, new_end = start, start + len(data)
        merged = bytearray(data)
        keep = []
        for estart, edata in extents:
            eend = estart + len(edata)
            if eend < new_start or estart > new_end:
                keep.append([estart, edata])
                continue
            # overlap/adjacency: splice the older bytes around the new
            if estart < new_start:
                merged = edata[: new_start - estart] + merged
                new_start = estart
            if eend > new_end:
                merged = merged + edata[len(edata) - (eend - new_end):]
                new_end = eend
        keep.append([new_start, bytearray(merged)])
        keep.sort(key=lambda e: e[0])
        self._bytes -= sum(len(d) for _, d in extents)
        self._bytes += sum(len(d) for _, d in keep)
        self._objs[oid] = keep
        self._objs.move_to_end(oid)
        self._trim()

    def invalidate(self, oid: str) -> None:
        self._gen[oid] = self._gen.get(oid, 0) + 1
        extents = self._objs.pop(oid, None)
        if extents:
            self._bytes -= sum(len(d) for _, d in extents)

    def clear(self) -> None:
        self._epoch += 1
        self._gen.clear()
        self._objs.clear()
        self._bytes = 0

    def _trim(self) -> None:
        while self._bytes > self.max_bytes and len(self._objs) > 1:
            _, extents = self._objs.popitem(last=False)
            self._bytes -= sum(len(d) for _, d in extents)
        # a single giant object must honor the budget too (a sequential
        # writer coalesces into one ever-growing extent): shed lowest-
        # offset bytes — farthest from a streaming tail — keeping the
        # hot tail cached
        while self._bytes > self.max_bytes and self._objs:
            _, extents = next(iter(self._objs.items()))
            if not extents:
                self._objs.popitem(last=False)
                continue
            over = self._bytes - self.max_bytes
            start, data = extents[0]
            if len(data) <= over:
                extents.pop(0)
                self._bytes -= len(data)
            else:
                extents[0] = [start + over, data[over:]]
                self._bytes -= over

    def stats(self) -> dict:
        return {"objects": len(self._objs), "bytes": self._bytes,
                "hits": self.hits, "misses": self.misses}


class _CoalesceItem:
    """One op's parked launch request (payload + result future).
    ``span``: the submitting op's ambient SpanCtx (if the op is
    sampled) — the shared launch is recorded under it at flush."""

    __slots__ = ("payload", "nstripes", "fut", "t0", "span")

    def __init__(self, payload, nstripes, fut, t0, span=None):
        self.payload = payload
        self.nstripes = nstripes
        self.fut = fut
        self.t0 = t0
        self.span = span


class CoalescedLauncher:
    """Cross-op micro-batcher for device EC launches (the tentpole of
    the dynamic-batching fix for per-op dispatch overhead: PERF.md shows
    the kernel is 3-4x faster when a batch amortizes fixed launch/pack
    costs, yet each OSD op used to dispatch its own handful of stripes).

    Concurrent in-flight ops enqueue their stripe blocks keyed by launch
    geometry — ``('enc',)`` for encode, ``('dec', survivors, todo)`` for
    decode, so mixed failure patterns never share a decode matrix — and
    a single flusher task concatenates batchmates along the leading
    stripe axis and runs ONE device launch per key, scattering each op's
    slice back to its waiter.

    Adaptive micro-window: a flush happens at the FIRST of
      - every in-flight backend op is already parked here (idle: no
        batchmate can arrive, so waiting longer only adds latency),
      - ``max_stripes`` pending stripes,
      - ``window_us`` elapsed since the oldest parked op.

    Failure isolation: a batchmate's exception (shape error, codec
    raise, cancelled waiter) fails only that op.  Cancelled waiters are
    dropped at flush time; a failed batched launch falls back to a
    transparent per-op solo retry so batchmates still get results.
    """

    def __init__(self, backend, window_us: float = 200.0,
                 max_stripes: int = 4096):
        self.backend = backend
        self.window_s = max(0.0, float(window_us)) / 1e6
        self.max_stripes = max(1, int(max_stripes))
        self._items: dict[tuple, list[_CoalesceItem]] = {}
        self._npending = 0          # parked ops not yet flushed
        self._nstripes = 0
        self._flusher: asyncio.Task | None = None
        self._wake: asyncio.Event | None = None
        self._loop = None
        # lifetime stats (admin socket `ec coalesce stats`; the perf
        # counters aggregate across backends per daemon)
        self.launches = 0
        self.ops = 0
        self.solo_retries = 0
        self.failed_ops = 0
        self.cancelled_waiters = 0

    def _bind_loop(self, loop) -> None:
        # A backend may be driven through several event loops over its
        # life (tests run one backend under repeated asyncio.run);
        # asyncio primitives are loop-bound, so rebind lazily.  Parked
        # state never survives a loop: every submitter awaits its future
        # inside the old loop, so the queues are empty by construction
        # when a new loop first submits.
        self._loop = loop
        self._wake = asyncio.Event()
        self._flusher = None
        self._items = {}
        self._npending = 0
        self._nstripes = 0

    def notify(self) -> None:
        """Re-evaluate the flush condition (an op completed, so the
        idle test may newly hold)."""
        if self._wake is not None:
            try:
                if asyncio.get_running_loop() is self._loop:
                    self._wake.set()
            except RuntimeError:
                pass

    async def submit(self, key: tuple, payload, nstripes: int):
        """Park one launch request; resolves with this op's slice of
        the coalesced result."""
        loop = asyncio.get_running_loop()
        if loop is not self._loop:
            self._bind_loop(loop)
        item = _CoalesceItem(payload, int(nstripes),
                             loop.create_future(), loop.time(),
                             span=current_span())
        self._items.setdefault(key, []).append(item)
        self._npending += 1
        self._nstripes += item.nstripes
        if self._flusher is None or self._flusher.done():
            self._flusher = loop.create_task(self._run_flusher())
        self._wake.set()
        try:
            return await item.fut
        except asyncio.CancelledError:
            self.cancelled_waiters += 1
            raise

    async def _run_flusher(self) -> None:
        loop = self._loop
        try:
            while self._npending:
                while True:
                    if self._nstripes >= self.max_stripes:
                        break
                    if self._npending >= self.backend._inflight_ops:
                        break       # idle: no batchmate can arrive
                    oldest = min(it.t0 for items in self._items.values()
                                 for it in items)
                    remaining = oldest + self.window_s - loop.time()
                    if remaining <= 0:
                        break
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(self._wake.wait(),
                                               remaining)
                    except asyncio.TimeoutError:
                        break
                batches = self._items
                self._items = {}
                self._npending = 0
                self._nstripes = 0
                for key, items in batches.items():
                    await self._flush_key(key, items)
        finally:
            # flusher teardown (daemon shutdown cancels it): fail any
            # still-parked waiters instead of leaving them hung
            for items in self._items.values():
                for it in items:
                    if not it.fut.done():
                        it.fut.cancel()
            self._items = {}
            self._npending = 0
            self._nstripes = 0

    async def _flush_key(self, key: tuple,
                         items: list[_CoalesceItem]) -> None:
        be = self.backend
        # a waiter cancelled while parked: drop its payload — the
        # remaining batchmates must neither wait for it nor fail
        live = [it for it in items if not it.fut.done()]
        if not live:
            return
        now = self._loop.time()
        for it in live:
            wait_us = (now - it.t0) * 1e6
            be.perf.tinc("ec_coalesce_wait_us", wait_us)
            be.perf.hinc("ec_coalesce_wait_hist_us", wait_us)
        wall0 = time.time()
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        timings: list[LaunchTiming] = []
        tok = _FLUSH_TIMINGS.set(timings)
        try:
            outs = await be._coalesce_launch(
                key, [it.payload for it in live])
        except asyncio.CancelledError:
            raise
        except BaseException as exc:
            if len(live) == 1:
                self.launches += 1
                self.failed_ops += 1
                if not live[0].fut.done():
                    live[0].fut.set_exception(exc)
                return
            # failure isolation: one batchmate poisoned the batch
            # (shape mismatch, codec raise) — transparent solo retry
            # so only the actually-broken op(s) fail
            for it in live:
                if it.fut.done():
                    continue
                self.solo_retries += 1
                self.launches += 1
                try:
                    out = (await be._coalesce_launch(
                        key, [it.payload]))[0]
                except asyncio.CancelledError:
                    raise
                except BaseException as solo_exc:
                    self.failed_ops += 1
                    it.fut.set_exception(solo_exc)
                else:
                    it.fut.set_result(out)
            return
        finally:
            _FLUSH_TIMINGS.reset(tok)
        launch_ms = (time.perf_counter() - t0) * 1e3
        self.launches += 1
        self.ops += len(live)
        be.perf.inc("ec_coalesce_launches")
        be.perf.inc("ec_coalesce_ops", len(live))
        be.perf.tinc("ec_coalesce_occupancy", len(live))
        if be.journal is not None:
            be.journal.emit(
                "coalesce.flush", op=str(key[0]), ops=len(live),
                stripes=sum(it.nstripes for it in live),
                launch_ms=round(launch_ms, 3))
        spans = [it.span for it in live if it.span is not None] \
            if be.tracer is not None else []
        if spans:
            # one measured device launch serves every sampled
            # batchmate: record the same interval once per interested
            # parent so each trace tree shows the shared launch, once
            # its device interval is known
            nstripes = sum(it.nstripes for it in live)

            def record() -> None:
                clock = _launch_clock(t0_ns, timings)
                for span in spans:
                    be.tracer.record(
                        "osd:ec:launch", span, wall0, launch_ms,
                        clock=clock, op=key[0], occupancy=len(live),
                        stripes=nstripes)

            be._when_timed(timings, record)
        for it, out in zip(live, outs):
            if not it.fut.done():
                it.fut.set_result(out)

    def stats(self) -> dict:
        return {
            "window_us": self.window_s * 1e6,
            "max_stripes": self.max_stripes,
            "launches": self.launches,
            "ops": self.ops,
            "occupancy": (self.ops / self.launches
                          if self.launches else 0.0),
            "solo_retries": self.solo_retries,
            "failed_ops": self.failed_ops,
            "cancelled_waiters": self.cancelled_waiters,
            "pending_ops": self._npending,
            "pending_stripes": self._nstripes,
        }


class ECBackend:
    def __init__(
        self,
        codec,
        shards: Mapping[int, ShardIO],
        stripe_unit: int | None = None,
        log_hook=None,
        mesh=None,
        hedge_timeout: float | None = None,
        perf: PerfCounters | None = None,
        tracer=None,
        journal=None,
        coalesce: bool = True,
        coalesce_window_us: float = 200.0,
        coalesce_max_stripes: int = 4096,
        mesh_coalescer=None,
        resident=None,
        resident_ns: str = "",
        resident_writeback: bool = False,
        resident_max_bytes: int = 256 << 20,
    ):
        """``codec``: an initialised ErasureCodeInterface; ``shards``:
        shard id -> ShardIO for all k+m positions. ``log_hook(oid, op,
        obj_version, prior_version)`` (daemon-provided) allocates the PG
        log entry that rides every shard mutation; None = no logging
        (standalone/library use).  ``mesh``: an optional
        ``parallel.mesh.Mesh`` with ('dp', 'cs') axes — when given and the
        codec is a generator-matrix code, encode/decode batches run the
        distributed data plane (parallel/ec_sharding.ShardedApplier)
        instead of the single-device codec path, bit-identically (the
        multi-chip analog of the per-shard sub-op fan-out,
        reference osd/ECBackend.cc:2090-2106,2364).  Every single-device
        launch runs on the codec's device (``codec.device``; a codec
        without one means CUDA, raising when there is none)."""
        self.ec = codec
        self.device = resolve_device(getattr(codec, "device", None))
        self.k = codec.get_data_chunk_count()
        self.n = codec.get_chunk_count()
        self.m = self.n - self.k
        # Physical shard ids holding the LOGICAL data chunks, in logical
        # order (ECUtil chunk_mapping role).  Mapped layouts (LRC
        # "DDD__..." interleaves parity between data groups) place data
        # at chunk_mapping[:k], NOT 0..k-1 — reads must gather from
        # these shards or they would return parity bytes as data.
        cm = getattr(codec, "chunk_mapping", None)
        self.data_shards = ([int(cm[i]) for i in range(self.k)] if cm
                            else list(range(self.k)))
        unit = stripe_unit or codec.get_chunk_size(0)
        align = getattr(codec, "get_alignment", lambda: 1)()
        if unit % align:
            raise ValueError(
                f"stripe_unit {unit} not aligned to codec alignment {align}"
            )
        self.sinfo = StripeInfo(self.k, unit)
        self.log_hook = log_hook
        # logged mode is STRICT: every live shard must commit a mutation
        # before it is acked (acting-set holes stay tolerated up to m).
        # This is what makes log-based rewind safe — an entry absent from
        # the authoritative log was never acked. Standalone (unlogged)
        # use keeps the lenient tolerate-and-eager-repair behavior.
        self.strict = log_hook is not None
        self.shards = dict(shards)
        if set(self.shards) != set(range(self.n)):
            raise ValueError(f"need shards 0..{self.n - 1}")
        self._object_locks: dict[str, tuple[asyncio.Lock, int]] = {}
        self._repair_tasks: set[asyncio.Task] = set()
        self.extent_cache = ExtentCache()
        # oid -> shards known stale from a failed mutation: a subsequent
        # write must heal them FIRST — otherwise its version bump would
        # make the stale shard pass the per-object version check and
        # serve corrupt ranges (version granularity is the object, not
        # the stripe)
        self._dirty: dict[str, set[int]] = {}
        # distributed data plane: generator-matrix codecs only (dense
        # device codecs expose .generator + encode_words_device; the
        # orchestration plugins — lrc/shec/clay — keep their own
        # layered paths)
        gen = getattr(codec, "generator", None)
        self.mesh = mesh if (
            mesh is not None and gen is not None
            and hasattr(codec, "encode_words_device")
        ) else None
        self._mesh_gen = np.asarray(gen, np.uint8) \
            if self.mesh is not None else None
        self._mesh_appliers: dict[tuple, object] = {}
        self._mesh_enc_applier = None   # pinned write-path encoder
        # observability: proves which plane served a batch (tests and
        # perf counters read these).  *_buckets record the DISTINCT
        # padded batch dims launched — the pow2 shape-bucketing bound on
        # launch shapes is asserted against them.
        self.mesh_stats = {"encodes": 0, "decodes": 0, "repairs": 0,
                           "encode_buckets": set(),
                           "decode_buckets": set()}
        # hedged reads: a data-shard read still pending after
        # hedge_timeout seconds is raced against a minimum_to_decode
        # reconstruction from the surviving shards (None/0 = off)
        self.hedge_timeout = hedge_timeout or None
        self.perf = perf if perf is not None else PerfCounters("ec")
        # kernel profiler (ec/profiler.py): every device launch below
        # attributes its wall time / stripes / bytes to this backend's
        # codec signature, recorded at the SAME sites with the SAME
        # values as the ec_*_launch_us and ec_launch_bytes counters —
        # attribution of the counters, never a second measurement
        from ceph_tpu_torch.ec.profiler import profiler_for
        self.codec_sig = (f"{type(codec).__name__.lower()}"
                          f"-k{self.k}-m{self.m}")
        self.profiler = profiler_for(self.perf)
        # shared Tracer (daemon-provided): sampled ops get their
        # coalesced device launch recorded into their trace tree
        self.tracer = tracer
        # flight recorder (daemon-provided EventJournal): coalescer
        # window flushes land as structured events
        self.journal = journal
        # ec_launch_bytes: logical bytes fed into device launches (the
        # numerator of achieved-GiB/s: ec_launch_bytes delta over
        # encode+decode launch-us delta — the utilization telemetry's
        # HBM-roofline-% input)
        for _k in ("hedge_issued", "hedge_won", "hedge_lost",
                   "hedge_meta",
                   "ec_coalesce_launches", "ec_coalesce_ops",
                   "ec_coalesce_pad_waste", "ec_device_launches",
                   "ec_launch_bytes",
                   "ec_mesh_launches", "ec_mesh_ops",
                   "ec_mesh_ici_bytes", "ec_mesh_ici_whole_bytes"):
            self.perf.add(_k, CounterType.U64)
        for _k in ("ec_coalesce_occupancy", "ec_coalesce_wait_us",
                   "ec_mesh_occupancy"):
            self.perf.add(_k, CounterType.LONGRUNAVG)
        for _k in ("ec_encode_launch_us", "ec_decode_launch_us",
                   "ec_encode_device_us", "ec_decode_device_us",
                   "ec_coalesce_wait_hist_us", "ec_mesh_launch_us",
                   # per-shard-read latency as observed by this primary
                   # — the distribution the QoS controller derives each
                   # OSD's adaptive hedge timeout from
                   "ec_shard_read_us"):
            self.perf.add(_k, CounterType.HISTOGRAM)
        # device residency (opt-in): keep shard streams on device in a
        # DeviceShardCache (on the codec's device) so repeated ops feed
        # the kernel without host round-trips.  Requires a codec with
        # device-array entry points and is mutually exclusive with the
        # mesh plane (the sharded applier owns its own placement).  The
        # transfer counters are
        # registered unconditionally — the non-resident paths account
        # their modeled host<->device traffic under the same names, so
        # cfg7's A/B reads one counter pair either way.
        register_resident_counters(self.perf)
        # batched repair engine counters (accrued by recover_batch;
        # the per-object paths share the plan hit/miss pair)
        register_repair_counters(self.perf)
        # batched scrub counters (accrued by scrub/scrub_batch; the
        # per-object oracle and the batched path share the launch
        # counter so cfg14's A/B reads one name for both arms)
        register_scrub_counters(self.perf)
        self.resident: DeviceShardCache | None = None
        self.resident_ns = resident_ns
        self.resident_writeback = False
        if resident is not None and resident is not False \
                and self.mesh is None \
                and hasattr(codec, "encode_chunks_device") \
                and hasattr(codec, "decode_chunks_device"):
            self.resident = resident if isinstance(
                resident, DeviceShardCache
            ) else DeviceShardCache(max_bytes=resident_max_bytes,
                                    perf=self.perf, device=self.device)
            if self.resident.device != self.device:
                raise ValueError(
                    f"resident cache on {self.resident.device}, codec on "
                    f"{self.device}")
            # write-back defers shard-data persistence to evict/flush;
            # strict (logged) mode acks require the store commit, so it
            # stays write-through there
            self.resident_writeback = bool(resident_writeback) \
                and not self.strict
        # cross-op micro-batching of device launches (the tentpole):
        # ops in flight concurrently share one encode/decode launch
        self._inflight_ops = 0
        # launches whose device interval is still to be read, and what
        # to do with it then (_when_timed)
        self._dev_waiting: list[tuple[list, object]] = []
        self.coalescer = CoalescedLauncher(
            self, window_us=coalesce_window_us,
            max_stripes=coalesce_max_stripes,
        ) if coalesce else None
        # host-level mesh coalescer (osd/mesh_coalesce.py): parked ops
        # from EVERY co-located OSD's backend share one sharded launch
        # over the device mesh.  register() refuses 1-device pools and
        # codecs without a dense generator — those keep the per-backend
        # launcher above (graceful degradation).  Decode joins only when
        # the codec exposes decode_selection (shec encodes sharded but
        # decodes per backend).  The host handle is kept even when
        # sharded launches are refused: the clay/lrc sub-chunk repair
        # meshes hang off it.
        self._mesh_host = mesh_coalescer
        self.mesh_co = None
        self._mesh_dec_ok = False
        if mesh_coalescer is not None and mesh_coalescer.register(self):
            self.mesh_co = mesh_coalescer
            self._mesh_dec_ok = mesh_coalescer.supports_decode(self)

    def _lock(self, oid: str):
        """Per-object write lock, refcounted so the table doesn't grow
        with every object name ever written."""
        backend = self

        class _Guard:
            @staticmethod
            def _unref():
                lock, refs = backend._object_locks[oid]
                if refs <= 1:
                    del backend._object_locks[oid]
                else:
                    backend._object_locks[oid] = (lock, refs - 1)

            async def __aenter__(self):
                lock, refs = backend._object_locks.get(
                    oid, (asyncio.Lock(), 0)
                )
                backend._object_locks[oid] = (lock, refs + 1)
                self._lock_obj = lock
                try:
                    await lock.acquire()
                except BaseException:
                    # cancelled while waiting: drop the refcount or the
                    # table entry leaks forever
                    self._unref()
                    raise
                return lock

            async def __aexit__(self, *exc):
                self._lock_obj.release()
                self._unref()
                return False

        return _Guard()

    def object_lock(self, oid: str):
        """Public per-object write-serialization guard (scrub and other
        external coordinators serialize against mutations with this)."""
        return self._lock(oid)

    # -- codec dispatch (single-device vs distributed mesh plane) ---------
    _MESH_APPLIER_CAP = 64

    def _mesh_applier(self, key: tuple, coeff_fn):
        """Bounded applier cache (LRU): each entry pins per-slot kernel
        constants, and survivor/lost combinations are combinatorial in a
        long-lived OSD.  The ``('enc',)`` write-path encoder is PINNED
        outside the bounded table — a burst of 64 distinct decode combos
        (a wide failure) must not evict the encoder into a rebuild on
        every subsequent write.  ``coeff_fn`` builds the coefficient
        matrix only on a miss — steady-state degraded reads are
        matrix-math-free."""
        if key == ("enc",):
            ap = self._mesh_enc_applier
            if ap is None:
                from ceph_tpu_torch.parallel.ec_sharding import \
                    ShardedApplier

                ap = ShardedApplier(self.mesh, coeff_fn())
                self._mesh_enc_applier = ap
            return ap
        ap = self._mesh_appliers.get(key)
        if ap is None:
            from ceph_tpu_torch.parallel.ec_sharding import ShardedApplier

            while len(self._mesh_appliers) >= self._MESH_APPLIER_CAP:
                self._mesh_appliers.pop(
                    next(iter(self._mesh_appliers)))
            ap = ShardedApplier(self.mesh, coeff_fn())
            self._mesh_appliers[key] = ap
        else:
            # LRU, not FIFO: re-insert on hit so the eviction scan's
            # first key is always the least-recently-used entry
            self._mesh_appliers.pop(key)
            self._mesh_appliers[key] = ap
        return ap

    # -- host<->device boundary ------------------------------------------
    #
    # Both data-path flavors account the logical bytes that cross the
    # host<->device boundary under ec_resident_h2d_bytes /
    # ec_resident_d2h_bytes: the resident path counts at its real
    # conversion points (_to_host/_to_device, cache spill), the classic
    # numpy path counts the modeled launch traffic (stripes up, chunks
    # down) in _encode_batch/_decode_batch.  Deterministic on CPU —
    # that's what makes the cfg7 A/B counter-verified without a chip.

    @staticmethod
    def _is_device(arr) -> bool:
        """True for tensors (the resident representation, a CPU tensor
        included); numpy / bytes are the host representation."""
        return isinstance(arr, torch.Tensor)

    def _to_host(self, arr) -> np.ndarray:
        """Materialize on host, counting the transfer when it crosses.
        Every host copy of device data goes through here."""
        if isinstance(arr, np.ndarray):
            return arr
        out = arr.cpu().numpy() if isinstance(arr, torch.Tensor) \
            else np.asarray(arr)
        self.perf.inc("ec_resident_d2h_bytes", out.nbytes)
        if self._dev_waiting:
            self._settle_device_times()
        return out

    def _to_device(self, arr):
        """Upload to the codec's device, counting the transfer when it
        crosses.  The tensor owns its memory (a copy even on the CPU)."""
        if not self._is_device(arr):
            arr = np.ascontiguousarray(np.asarray(arr, np.uint8))
            self.perf.inc("ec_resident_h2d_bytes", arr.nbytes)
            if not arr.flags.writeable:     # e.g. np.frombuffer over bytes
                arr = arr.copy()
            return torch.from_numpy(arr).to(self.device, copy=True)
        return arr

    def _zeros(self, n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.uint8, device=self.device)

    async def _launch(self, fn, *args):
        """One device launch off the event loop: (result,
        LaunchTiming)."""
        return await asyncio.to_thread(_timed_call, self.device, fn, args)

    def _device_time(self, timing: LaunchTiming | None, kind: str
                     ) -> None:
        """Count a launch's device time (none off a card) under its
        ``kind`` of launch ("enc", "dec", "mesh-repair") once it is
        known, and hand its timing to the coalesced flush that runs it,
        if one does."""
        if timing is None:
            return
        flush = _FLUSH_TIMINGS.get()
        if flush is not None:
            flush.append(timing)

        def count() -> None:
            if timing.device_us:
                self.perf.hinc("ec_encode_device_us" if kind == "enc"
                               else "ec_decode_device_us",
                               timing.device_us)
                self.profiler.record_device(f"{self.codec_sig}:{kind}",
                                            timing.device_us)

        self._when_timed([timing], count)

    def _when_timed(self, timings: list, then) -> None:
        """Call ``then()`` once every launch of ``timings`` has its
        device interval: now where its events have passed, else at a
        later launch or download of this backend."""
        self._dev_waiting.append((timings, then))
        self._settle_device_times()

    def _settle_device_times(self) -> None:
        waiting = []
        for timings, then in self._dev_waiting:
            if all(t.done() for t in timings):
                then()
            else:
                waiting.append((timings, then))
        self._dev_waiting = waiting

    async def _encode_batch(self, stripes) -> np.ndarray:
        """(B, k, C) -> (B, k+m, C), through the mesh plane when one is
        configured (parity = sharded generator apply; data rows pass
        through, so the result is bit-identical to the codec path).
        A device-resident batch (tensor in) encodes through the codec's
        device entry point and stays on device.

        The batch dim is shape-bucketed: B pads up to a power of two
        (zero stripes; rows are independent, result sliced back), as the
        JAX backend does, so both launch the same shapes: at most
        ceil(log2(max B)) + 1 distinct encode shapes per codec instead
        of one per stripe count."""
        if self._is_device(stripes):
            in_bytes = int(getattr(stripes, "nbytes", 0))
            self.perf.inc("ec_launch_bytes", in_bytes)
            stripes, b = pad_batch_pow2_device(stripes)
            if stripes.shape[0] != b:
                self.perf.inc("ec_coalesce_pad_waste",
                              stripes.shape[0] - b)
            self.mesh_stats["encode_buckets"].add(int(stripes.shape[0]))
            self.perf.inc("ec_device_launches")
            t0 = time.perf_counter()
            out, timing = await self._launch(
                self.ec.encode_chunks_device, stripes)
            dt_us = (time.perf_counter() - t0) * 1e6
            self.perf.hinc("ec_encode_launch_us", dt_us)
            self.profiler.record(f"{self.codec_sig}:enc", dt_us,
                                 stripes=b, hbm_bytes=in_bytes)
            self._device_time(timing, "enc")
            return out[:b]
        in_bytes = stripes.nbytes if hasattr(stripes, "nbytes") else 0
        stripes, b = pad_batch_pow2(stripes)
        if stripes.shape[0] != b:
            self.perf.inc("ec_coalesce_pad_waste", stripes.shape[0] - b)
        self.mesh_stats["encode_buckets"].add(stripes.shape[0])
        self.perf.inc("ec_device_launches")
        self.perf.inc("ec_launch_bytes", in_bytes)
        self.perf.inc("ec_resident_h2d_bytes", in_bytes)
        t0 = time.perf_counter()
        if self.mesh is not None:
            ap = self._mesh_applier(
                ("enc",), lambda: self._mesh_gen[self.k:])
            parity, timing = await self._launch(ap, stripes)
            self.mesh_stats["encodes"] += 1
            dt_us = (time.perf_counter() - t0) * 1e6
            self.perf.hinc("ec_encode_launch_us", dt_us)
            self.profiler.record(f"{self.codec_sig}:enc", dt_us,
                                 stripes=b, hbm_bytes=in_bytes)
            self._device_time(timing, "enc")
            out = np.concatenate(
                [np.asarray(stripes, np.uint8), parity], axis=1)[:b]
            self.perf.inc("ec_resident_d2h_bytes", out.nbytes)
            return out
        out, timing = await self._launch(
            self.ec.encode_chunks_batch, stripes)
        out = np.asarray(out)[:b]
        dt_us = (time.perf_counter() - t0) * 1e6
        self.perf.hinc("ec_encode_launch_us", dt_us)
        self.profiler.record(f"{self.codec_sig}:enc", dt_us,
                             stripes=b, hbm_bytes=in_bytes)
        self._device_time(timing, "enc")
        self.perf.inc("ec_resident_d2h_bytes", out.nbytes)
        return out

    async def _decode_batch(self, batched: dict, missing: list) -> dict:
        """Batched reconstruct through the mesh plane when configured.
        Survivor selection mirrors the codec's decode_chunks_batch
        (sorted available, first k) so both planes build the same
        decode matrix — bit-identity by construction.  Batch dim
        shape-bucketed like _encode_batch."""
        missing = [int(w) for w in missing]
        if self.resident is not None and any(
                self._is_device(c) for c in batched.values()):
            return await self._decode_batch_device(batched, missing)
        b = next(iter(batched.values())).shape[0] if batched else 0
        in_bytes = sum(c.nbytes for c in batched.values())
        if b:
            bp = pow2_bucket(b)
            if bp != b:
                self.perf.inc("ec_coalesce_pad_waste", bp - b)
                batched = {
                    s: np.concatenate([
                        np.asarray(c, np.uint8),
                        np.zeros((bp - b,) + np.shape(c)[1:], np.uint8),
                    ], axis=0)
                    for s, c in batched.items()
                }
            self.mesh_stats["decode_buckets"].add(bp)
        self.perf.inc("ec_device_launches")
        self.perf.inc("ec_launch_bytes", in_bytes)
        self.perf.inc("ec_resident_h2d_bytes", in_bytes)
        t0 = time.perf_counter()
        if self.mesh is not None:
            avail = {int(i): np.asarray(c, np.uint8)
                     for i, c in batched.items()}
            todo = [w for w in missing if w not in avail]
            out = {w: avail[w][:b] for w in missing if w in avail}
            if todo:
                if len(avail) < self.k:
                    raise IOError(f"cannot decode {todo}")
                # survivor choice + decode matrix come from the ONE
                # shared definition (codec.decode_selection, itself
                # FIFO-cached) so the two planes cannot drift apart
                survivors, D = self.ec.decode_selection(avail, todo)
                ap = self._mesh_applier(
                    ("dec", survivors, tuple(todo)), lambda: D)
                stacked = np.stack([avail[s] for s in survivors],
                                   axis=1)
                rebuilt, timing = await self._launch(ap, stacked)
                for i, w in enumerate(todo):
                    out[w] = np.asarray(rebuilt[:b, i])
                    self.perf.inc("ec_resident_d2h_bytes",
                                  out[w].nbytes)
                self.mesh_stats["decodes"] += 1
            else:
                timing = None
            dt_us = (time.perf_counter() - t0) * 1e6
            self.perf.hinc("ec_decode_launch_us", dt_us)
            self.profiler.record(f"{self.codec_sig}:dec", dt_us,
                                 stripes=b, hbm_bytes=in_bytes)
            self._device_time(timing, "dec")
            return out
        out, timing = await self._launch(
            self.ec.decode_chunks_batch, batched, missing)
        dt_us = (time.perf_counter() - t0) * 1e6
        self.perf.hinc("ec_decode_launch_us", dt_us)
        self.profiler.record(f"{self.codec_sig}:dec", dt_us,
                             stripes=b, hbm_bytes=in_bytes)
        self._device_time(timing, "dec")
        res = {w: np.asarray(c)[:b] for w, c in out.items()}
        # only rebuilt chunks cross back down; available targets are
        # passed through as the same host arrays
        self.perf.inc("ec_resident_d2h_bytes", sum(
            c.nbytes for w, c in res.items() if w not in batched))
        return res

    async def _decode_batch_device(self, batched: dict,
                                   missing: list) -> dict:
        """_decode_batch for a (possibly mixed) device-resident batch:
        host chunks are promoted to device (counted uploads), rebuilt
        targets come back as device arrays, and available targets pass
        through in whatever representation they arrived in."""
        avail = {int(s): self._to_device(c) for s, c in batched.items()}
        b = next(iter(avail.values())).shape[0] if avail else 0
        if b:
            padded = {}
            for s, c in avail.items():
                padded[s], _ = pad_batch_pow2_device(c)
            bp = next(iter(padded.values())).shape[0]
            if bp != b:
                self.perf.inc("ec_coalesce_pad_waste", bp - b)
            self.mesh_stats["decode_buckets"].add(int(bp))
            avail = padded
        self.perf.inc("ec_device_launches")
        in_bytes = sum(
            int(getattr(c, "nbytes", 0)) for c in batched.values())
        self.perf.inc("ec_launch_bytes", in_bytes)
        t0 = time.perf_counter()
        out = {w: batched[w][:b] for w in missing if w in batched}
        todo = [w for w in missing if w not in batched]
        timing = None
        if todo:
            if len(avail) < self.k:
                raise IOError(f"cannot decode {todo}")
            rebuilt, timing = await self._launch(
                self.ec.decode_chunks_device, avail, todo)
            for i, w in enumerate(todo):
                out[w] = rebuilt[:b, i]
        dt_us = (time.perf_counter() - t0) * 1e6
        self.perf.hinc("ec_decode_launch_us", dt_us)
        self.profiler.record(f"{self.codec_sig}:dec", dt_us,
                             stripes=b, hbm_bytes=in_bytes)
        self._device_time(timing, "dec")
        return out

    # -- cross-op coalescing (CoalescedLauncher front ends) ---------------
    async def _coalesced_encode(self, stripes: np.ndarray) -> np.ndarray:
        """Encode entry for in-flight ops: parks the stripe block on the
        per-backend CoalescedLauncher (one device launch shared across
        concurrent batchmates) or falls through to the direct path when
        coalescing is off.  Shape validation happens HERE, before the op
        joins a batch, so a malformed op can only fail itself.  Device
        batches (the resident write path) ride the same launcher and
        stay on device end to end."""
        if not self._is_device(stripes):
            stripes = np.asarray(stripes, np.uint8)
        if self.coalescer is None and self.mesh_co is None:
            return await self._encode_batch(stripes)
        if stripes.ndim != 3 or stripes.shape[1] != self.k \
                or stripes.shape[2] != self.sinfo.chunk_size:
            raise ValueError(
                f"encode batch shape {stripes.shape} != "
                f"(B, {self.k}, {self.sinfo.chunk_size})"
            )
        if self.mesh_co is not None:
            # host-wide launcher: batchmates may come from OTHER OSDs'
            # backends, and the launch shards over the whole mesh
            return await self.mesh_co.submit(
                self, ("enc",), stripes, stripes.shape[0])
        return await self.coalescer.submit(
            ("enc",), stripes, stripes.shape[0])

    async def _coalesced_decode(self, batched: dict,
                                missing: list) -> dict:
        """Decode entry for in-flight ops.  Coalescing groups strictly
        by (available shards, decode targets): only ops with the SAME
        failure pattern share a launch — and hence a decode matrix."""
        missing = [int(w) for w in missing]
        if self.coalescer is None and self._mesh_host is None:
            return await self._decode_batch(batched, missing)
        avail = {
            int(s): c if self._is_device(c) else np.asarray(c, np.uint8)
            for s, c in batched.items()
        }
        bs = {c.shape[0] for c in avail.values()}
        if not avail or len(bs) != 1 or any(
                c.ndim != 2 or c.shape[1] != self.sinfo.chunk_size
                for c in avail.values()):
            raise ValueError(
                f"decode batch shapes "
                f"{ {s: tuple(c.shape) for s, c in avail.items()} } "
                f"not uniform (B, {self.sinfo.chunk_size})"
            )
        b = bs.pop()
        if self._mesh_host is not None:
            # cross-chip sub-chunk repair: a single-chunk degraded read
            # on a clay/lrc codec moves only helper planes / group
            # chunks over the interconnect, not whole survivor chunks
            rep = await self._mesh_subchunk_repair(avail, missing)
            if rep is not None:
                return rep
        key = ("dec", tuple(sorted(avail)), tuple(missing))
        if self.mesh_co is not None and self._mesh_dec_ok:
            return await self.mesh_co.submit(self, key, avail, b)
        if self.coalescer is None:
            return await self._decode_batch(avail, missing)
        return await self.coalescer.submit(key, avail, b)

    async def _coalesce_launch(self, key: tuple, payloads: list):
        """One device launch for a list of batchmate payloads (called
        only by the CoalescedLauncher): concatenate along the leading
        stripe axis, run the direct batch path (which shape-buckets),
        scatter the slices back in order."""
        if key[0] == "enc":
            if len(payloads) == 1:
                return [await self._encode_batch(payloads[0])]
            sizes = [p.shape[0] for p in payloads]
            any_dev = any(self._is_device(p) for p in payloads)
            if any_dev:
                # mixed batch: host batchmates are promoted (counted
                # uploads) so the whole launch stays on device; their
                # slices come back down below
                cat = torch.cat(
                    [self._to_device(p) for p in payloads], dim=0)
            else:
                cat = np.concatenate(payloads, axis=0)
            out = await self._encode_batch(cat)
            res, off = [], 0
            for p, sz in zip(payloads, sizes):
                sl = out[off:off + sz]
                if any_dev and not self._is_device(p):
                    sl = self._to_host(sl)
                res.append(sl)
                off += sz
            return res
        _, shards, todo = key
        if len(payloads) == 1:
            return [await self._decode_batch(payloads[0], list(todo))]
        sizes = [next(iter(p.values())).shape[0] for p in payloads]
        any_dev = any(
            self._is_device(c) for p in payloads for c in p.values())
        if any_dev:
            cat = {
                s: torch.cat(
                    [self._to_device(p[s]) for p in payloads], dim=0)
                for s in shards
            }
        else:
            cat = {
                s: np.concatenate([p[s] for p in payloads], axis=0)
                for s in shards
            }
        out = await self._decode_batch(cat, list(todo))
        res, off = [], 0
        for p, sz in zip(payloads, sizes):
            host_op = not any(self._is_device(c) for c in p.values())
            sl = {w: c[off:off + sz] for w, c in out.items()}
            if any_dev and host_op:
                sl = {w: self._to_host(c) for w, c in sl.items()}
            res.append(sl)
            off += sz
        return res

    async def _mesh_subchunk_repair(self, avail: dict,
                                    missing: list) -> dict | None:
        """Single-chunk degraded read over the mesh, moving sub-chunks.

        CLAY: the regenerating-code repair reads only 1/q of each of the
        d helpers' bytes — parallel/clay_sharding extracts the repair
        planes BEFORE its all_gather, so only those planes ride the
        interconnect.  LRC: the lost chunk's local group repairs with a
        group-local all_gather — other groups' chunks never move.  Both
        operators are bit-identical to the plugin decode (their _check
        probes gate the corpus), so a degraded read through here returns
        the same bytes as the classic whole-chunk path.

        Interconnect savings are counter-verified: ec_mesh_ici_bytes
        accrues the modeled moved bytes, ec_mesh_ici_whole_bytes the
        whole-chunk counterfactual (k full survivor chunks).

        Returns None whenever the geometry doesn't fit — multi-chunk
        loss, helpers unavailable, device-resident payloads, or a pool
        the repair meshes can't tile — and the caller takes the classic
        decode path (the JAX backend's own refusals, kept as they are)."""
        ec = self.ec
        is_clay = hasattr(ec, "sub_chunk_no") and hasattr(ec, "q")
        is_lrc = hasattr(ec, "layers")
        if not (is_clay or is_lrc):
            return None
        todo = [w for w in missing if w not in avail]
        if len(todo) != 1:
            return None
        if any(self._is_device(c) for c in avail.values()):
            return None
        lost = todo[0]
        b = next(iter(avail.values())).shape[0]
        C = self.sinfo.chunk_size
        try:
            if is_clay:
                if C % ec.sub_chunk_no:
                    return None
                mesh = self._mesh_host.clay_repair_mesh(self.n)
                if mesh is None:
                    return None
                from ceph_tpu_torch.ec.repair_operator import \
                    clay_repair_operator
                from ceph_tpu_torch.parallel.clay_sharding import (
                    clay_repair_ici_bytes, sharded_clay_repair)

                _, helpers, _ = clay_repair_operator(ec, lost)
                if any(h not in avail for h in helpers):
                    return None
                moved, whole = clay_repair_ici_bytes(
                    ec, len(helpers), b, C)
                repair = sharded_clay_repair
                dp = mesh.shape["dp"]
            else:
                groups = len(ec.layers) - 1
                mesh = self._mesh_host.lrc_repair_mesh(groups)
                if mesh is None:
                    return None
                from ceph_tpu_torch.ec.repair_operator import \
                    lrc_repair_operator
                from ceph_tpu_torch.parallel.lrc_sharding import (
                    lrc_repair_ici_bytes, sharded_lrc_repair)

                _, minimum = lrc_repair_operator(ec, lost)
                if any(h not in avail for h in minimum):
                    return None
                moved, whole = lrc_repair_ici_bytes(
                    ec, len(minimum), b, C)
                repair = sharded_lrc_repair
                dp = mesh.shape["dp"]
        except Exception:
            # geometry probe failed (profile the operator can't serve
            # locally, etc) — the classic decode path handles it
            return None
        # dp must divide the launched batch; zero stripes pad (rows are
        # independent) and the pad slices off below
        bp = -(-b // dp) * dp
        chunks = np.zeros((bp, self.n, C), np.uint8)
        for s, c in avail.items():
            chunks[:b, int(s)] = np.asarray(c, np.uint8)
        self.perf.inc("ec_device_launches")
        self.perf.inc("ec_mesh_launches")
        self.perf.inc("ec_launch_bytes", chunks.nbytes)
        self.perf.inc("ec_resident_h2d_bytes", chunks.nbytes)
        t0 = time.perf_counter()
        rec, timing = await self._launch(repair, mesh, ec, chunks, lost)
        rec = np.asarray(rec)[:b]
        launch_us = (time.perf_counter() - t0) * 1e6
        self.perf.hinc("ec_decode_launch_us", launch_us)
        self.perf.hinc("ec_mesh_launch_us", launch_us)
        self.profiler.record(f"{self.codec_sig}:mesh-repair",
                             launch_us, stripes=b,
                             hbm_bytes=chunks.nbytes)
        self._device_time(timing, "mesh-repair")
        self.perf.inc("ec_mesh_ici_bytes", moved)
        self.perf.inc("ec_mesh_ici_whole_bytes", whole)
        self.perf.inc("ec_resident_d2h_bytes", rec.nbytes)
        self.mesh_stats["repairs"] += 1
        out = {w: avail[w] for w in missing if w in avail}
        out[lost] = rec
        return out

    def _track_op(self):
        """In-flight op accounting for the coalescer's adaptive window:
        when every tracked op is parked in the launcher, nothing else
        can arrive and the flush happens immediately (the idle case — a
        solo writer never pays the window)."""
        backend = self

        class _Track:
            async def __aenter__(self):
                backend._inflight_ops += 1
                return self

            async def __aexit__(self, *exc):
                backend._inflight_ops -= 1
                if backend.coalescer is not None:
                    backend.coalescer.notify()
                if backend.mesh_co is not None:
                    backend.mesh_co.notify()
                return False

        return _Track()

    # -- metadata --------------------------------------------------------
    async def _attr_all(self, oid: str, name: str,
                        hedged: bool = False) -> list:
        """Fetch one attr from every shard concurrently (metadata is
        replicated per shard; one round-trip worst case instead of k+m
        serial awaits). Each slot is bytes, KeyError (shard affirms the
        object/attr absent), or another exception (shard unreachable).

        ``hedged`` (client IO paths only): with a hedge timeout armed,
        stragglers are cut loose once k shards have answered — a
        committed write lands on at least n-m = k shards, so any k
        answers include a fresh copy (the same bound the write path
        commits with).  Without it, one dead-but-not-yet-marked-down
        peer stalls every meta read for the whole down-detection
        window, which IS the degraded-read tail."""
        tasks = [asyncio.ensure_future(self.shards[i].get_attr(oid,
                                                               name))
                 for i in range(self.n)]
        if hedged and self.hedge_timeout:
            await asyncio.wait(tasks, timeout=self.hedge_timeout)
            pending = [t for t in tasks if not t.done()]
            if pending and len(tasks) - len(pending) >= self.k:
                self.perf.inc("hedge_meta")
                for t in pending:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                return [
                    (ShardReadError(f"shard {i}: hedged (meta)")
                     if t.cancelled()
                     else t.exception() if t.exception() is not None
                     else t.result())
                    for i, t in enumerate(tasks)
                ]
        return await asyncio.gather(*tasks, return_exceptions=True)

    async def _get_attr_any(self, oid: str, name: str) -> bytes | None:
        """Read an attr from any shard that still has the object. Returns
        None only when at least one shard affirmatively reports it absent;
        if every shard errored transiently, raises — 'unreachable' must
        never be mistaken for 'does not exist' (a write would then reset
        version and skip RMW read-back)."""
        results = await self._attr_all(oid, name, hedged=True)
        errors = []
        absent = False
        for i, r in enumerate(results):
            if isinstance(r, KeyError):
                absent = True
            elif isinstance(r, BaseException):
                errors.append((i, r))
            else:
                return r
        if absent:
            return None
        raise ShardReadError(
            f"all shards unreachable reading {name} of {oid}: {errors}"
        )

    async def _read_meta(self, oid: str) -> ECObjectMeta | None:
        """Authoritative object metadata: the MAX version across all
        answering shards. Taking the first reply would let a shard that
        missed a degraded write serve a stale version as authoritative,
        inverting the stale-shard check (fresh shards would then fail
        version verification). The peering-time authoritative-version
        choice, applied per read."""
        results = await self._attr_all(oid, VERSION_ATTR, hedged=True)
        best: ECObjectMeta | None = None
        errors = []
        absent = False
        for i, r in enumerate(results):
            if isinstance(r, KeyError):
                absent = True
            elif isinstance(r, BaseException):
                errors.append((i, r))
            else:
                try:
                    d = json.loads(r)
                    meta = ECObjectMeta(int(d["size"]), int(d["version"]))
                except (ValueError, TypeError, KeyError):
                    continue
                if best is None or meta.version > best.version:
                    best = meta
        if best is not None:
            return best
        if absent:
            return None
        raise ShardReadError(
            f"all shards unreachable reading meta of {oid}: {errors}"
        )

    @staticmethod
    def _meta_attr(meta: ECObjectMeta) -> bytes:
        return json.dumps(
            {"size": meta.size, "version": meta.version}
        ).encode()

    async def _target_meta(self, oid: str,
                           version: int | None) -> ECObjectMeta | None:
        """Metadata at a PINNED version (any shard that matches), or the
        max-version choice when no target is given."""
        if version is None:
            return await self._read_meta(oid)
        for r in await self._attr_all(oid, VERSION_ATTR):
            if isinstance(r, BaseException):
                continue
            try:
                d = json.loads(r)
            except (ValueError, TypeError):
                continue
            if int(d.get("version", -1)) == version:
                return ECObjectMeta(int(d["size"]), version)
        raise ShardReadError(f"no shard holds {oid} at version {version}")

    # -- write -----------------------------------------------------------
    async def write(self, oid: str, data: bytes, offset: int = 0,
                    version: int | None = None,
                    reqid: str = "") -> ECObjectMeta:
        """Write ``data`` at logical ``offset`` (stripe-granular RMW)."""
        async with self._track_op(), self._lock(oid):
            await self._heal_dirty(oid)
            # capture the cache generation BEFORE the RMW read/encode:
            # if a concurrent invalidate() lands while our (possibly
            # coalesced) encode is in flight, note_write below becomes
            # a no-op instead of resurrecting stale extents
            cache_gen = self.extent_cache.generation(oid)
            meta = await self._read_meta(oid)
            old_size = meta.size if meta else 0
            new_version = (
                version if version is not None
                else (meta.version + 1 if meta else 1)
            )
            end = offset + len(data)
            new_size = max(old_size, end)
            sw = self.sinfo.stripe_width
            a_start, a_len = self.sinfo.offset_len_to_stripe_bounds(
                offset, len(data)
            )
            buf = None
            if self.resident is not None:
                # device-resident RMW: the stripe batch is assembled on
                # device (resident shard gather + client-byte upload)
                # and never materializes as host bytes
                stripes = await self._resident_stripes(
                    oid, a_start, a_len, offset, end, data, old_size,
                    meta.version if meta else None,
                )
            else:
                buf = np.zeros(a_len, np.uint8)
                # RMW: read back surviving logical bytes around the
                # write — the extent cache (ExtentCache role) serves
                # back-to-back overwrites without re-reading + decoding
                # k shards
                if old_size > a_start:
                    keep_len = min(old_size, a_start + a_len) - a_start
                    existing = self.extent_cache.get(oid, a_start,
                                                     keep_len)
                    if existing is None:
                        existing = await self._read_logical(
                            oid, a_start, keep_len, old_size,
                            meta.version if meta else None,
                        )
                    buf[:keep_len] = np.frombuffer(existing, np.uint8)
                buf[offset - a_start: end - a_start] = np.frombuffer(
                    bytes(data), np.uint8
                )
                stripes = self.sinfo.split_stripes(buf)
            # device encode off the event loop: a first-time kernel
            # build must not stall heartbeats/leases in this process
            chunks = await self._coalesced_encode(stripes)
            shard_off = self.sinfo.logical_to_prev_chunk_offset(a_start)
            meta_attr = self._meta_attr(ECObjectMeta(new_size, new_version))
            streams = None
            if buf is None:
                streams = self.sinfo.shard_streams(chunks)
                if self.resident_writeback:
                    # shard data stays device-resident; the store gets
                    # an attrs-only commit now and the bytes on
                    # evict/flush.  hinfo is maintained by the fused
                    # device-CRC epilogue over the encoded streams —
                    # no host bytes required (beyond the length gate it
                    # degrades to the old invalidation).
                    data_bytes = [b""] * self.n
                    write_off = 0
                    hattrs = await self._update_hinfo_device(
                        oid, shard_off, streams, old_size
                    )
                else:
                    # write-through: ONE counted download of the
                    # encoded shard streams at the store-persistence
                    # boundary
                    host = self._to_host(streams)
                    shard_bytes = [host[i] for i in range(self.n)]
                    hattrs = await self._update_hinfo(
                        oid, shard_off, shard_bytes, old_size
                    )
                    data_bytes = [c.tobytes() for c in shard_bytes]
                    write_off = shard_off
            else:
                shard_bytes = self.sinfo.shard_bytes(chunks)
                hattrs = await self._update_hinfo(
                    oid, shard_off, shard_bytes, old_size
                )
                data_bytes = [c.tobytes() for c in shard_bytes]
                write_off = shard_off
            entry = (self.log_hook(oid, "modify", new_version,
                                   meta.version if meta else 0, reqid)
                     if self.log_hook else None)
            try:
                results = await asyncio.gather(*(
                    self.shards[i].write_shard(
                        oid, write_off, data_bytes[i],
                        {VERSION_ATTR: meta_attr,
                         HINFO_ATTR: hattrs[i]},
                        log=entry,
                    )
                    for i in range(self.n)
                ), return_exceptions=True)
                failed = [i for i, r in enumerate(results)
                          if isinstance(r, BaseException)]
                await self._settle_write_failures(
                    "write", oid, failed,
                    lambda live: self._heal_shards(oid, live, entry),
                    entry,
                    causes={i: repr(r) for i, r in enumerate(results)
                            if isinstance(r, BaseException)},
                )
            except BaseException:
                # unsettled on-disk outcome (failure OR cancellation
                # mid-gather, when a subset of shards already hold the
                # new bytes): cached extents can no longer be trusted
                self.extent_cache.invalidate(oid)
                if self.resident is not None:
                    self.resident.drop_object(self.resident_ns, oid)
                raise
            if streams is not None:
                await self._resident_install(
                    oid, shard_off, streams, new_version, old_size)
            else:
                self.extent_cache.note_write(oid, a_start,
                                             buf.tobytes(),
                                             gen=cache_gen)
            return ECObjectMeta(new_size, new_version)

    # -- device residency (DeviceShardCache integration) ------------------
    async def _resident_stripes(self, oid: str, a_start: int, a_len: int,
                                offset: int, end: int, data,
                                old_size: int, version):
        """Assemble the write's (B, k, C) stripe batch on device.

        Only the client's new bytes are uploaded; surviving bytes
        around the write come from the resident data-shard entries (a
        pure device gather).  A residency miss falls back to the host
        read path (_read_logical handles reconstruction and hedging)
        with ONE counted upload of the surrounding bytes."""
        new = np.frombuffer(bytes(data), np.uint8)
        keep_len = (min(old_size, a_start + a_len) - a_start
                    if old_size > a_start else 0)
        if keep_len <= 0 and new.size == a_len:
            flat = self._to_device(new)
        else:
            base = None
            if keep_len > 0:
                base = self._resident_logical(
                    oid, a_start, a_len, keep_len, old_size, version)
                if base is None:
                    existing = self.extent_cache.get(oid, a_start,
                                                     keep_len)
                    if existing is None:
                        existing = await self._read_logical(
                            oid, a_start, keep_len, old_size, version)
                    host = np.zeros(a_len, np.uint8)
                    host[:keep_len] = np.frombuffer(existing, np.uint8)
                    base = self._to_device(host)
            if base is None:
                base = self._zeros(a_len)
            # base is this write's own buffer (a fresh gather, upload
            # or zeros), never a resident entry: patch it in place
            flat = base
            flat[offset - a_start: end - a_start] = self._to_device(new)
        return flat.reshape(-1, self.k, self.sinfo.chunk_size)

    def _resident_logical(self, oid: str, a_start: int, a_len: int,
                          keep_len: int, old_size: int, version):
        """Device gather of logical bytes [a_start, a_start + a_len)
        from the resident data-shard entries (bytes past keep_len are
        zeroed, matching the host RMW buffer), or None when any needed
        shard segment is not resident at the object's version."""
        C = self.sinfo.chunk_size
        nstripes = a_len // self.sinfo.stripe_width
        coff = self.sinfo.aligned_logical_offset_to_chunk_offset(a_start)
        clen = nstripes * C
        ssize = self.sinfo.logical_to_next_chunk_offset(old_size)
        need = min(coff + clen, ssize)
        segs = []
        for i in self.data_shards:
            ent = self.resident.get(self.resident_ns, oid, i)
            if ent is None or (version is not None
                               and ent.version != version):
                return None
            arr = ent.arr
            if arr.shape[0] < need:
                return None
            seg = arr[coff: coff + clen]
            if seg.shape[0] < clen:
                seg = torch.cat([seg, self._zeros(clen - seg.shape[0])])
            segs.append(seg)
        flat = self.sinfo.stack_shard_streams(torch.stack(segs), nstripes)
        if keep_len < a_len:
            # zero the RMW buffer past the surviving bytes, as the host
            # path's zero-initialized buf does (in place: flat is this
            # gather's own memory, torch.stack copied the segments)
            flat[keep_len:] = 0
        return flat

    async def _resident_install(self, oid: str, shard_off: int, streams,
                                version: int, old_size: int) -> None:
        """Install the write's encoded shard streams into the resident
        cache (spliced over any prior entry), then enforce the byte
        budget.  Write-back entries are dirty — the cache's spill hook
        persists them on evict/flush."""
        cache = self.resident
        dirty = self.resident_writeback
        clen = int(streams.shape[1])
        old_len = self.sinfo.logical_to_next_chunk_offset(old_size)
        for i in range(self.n):
            seg = streams[i]
            ent = cache.get(self.resident_ns, oid, i, count=False)
            if ent is not None and not (
                    shard_off == 0 and clen >= ent.arr.shape[0]):
                base = ent.arr
                if base.shape[0] < shard_off + clen:
                    arr = torch.cat([
                        base, self._zeros(shard_off + clen - base.shape[0])])
                else:
                    arr = base.clone()    # the entry may be read still
                arr[shard_off: shard_off + clen] = seg
            elif ent is None and not (shard_off == 0
                                      and clen >= old_len):
                if not dirty:
                    # write-through partial write over a non-resident
                    # object: the store stays authoritative; don't
                    # cache a stream we only partially know
                    continue
                # write-back MUST materialize the full stream — the
                # store just got an attrs-only commit, so the cache is
                # about to hold the only complete copy
                try:
                    raw = await self.shards[i].read_shard(oid, 0,
                                                          old_len)
                except Exception:
                    # source unreadable (dead shard): the stream stays
                    # reconstructable from the other entries; mark the
                    # shard for repair instead of failing the ack
                    self._dirty.setdefault(oid, set()).add(i)
                    continue
                host = np.zeros(max(old_len, shard_off + clen),
                                np.uint8)
                host[:len(raw)] = np.frombuffer(raw, np.uint8)
                arr = self._to_device(host)
                arr[shard_off: shard_off + clen] = seg
            else:
                arr = seg
            cache.put(self.resident_ns, oid, i, arr, version,
                      dirty=dirty, spill=self._resident_spill)
        if cache.over_high:
            await cache.evict()

    async def _resident_spill(self, oid: str, shard: int,
                              payload: np.ndarray) -> None:
        """Cache spill hook: persist a dirty entry's full shard stream
        (write-back durability path, also the flush-on-shutdown hook)."""
        await self.shards[shard].write_shard(oid, 0, payload.tobytes(),
                                             {})

    def _resident_read(self, shard: int, oid: str, off: int,
                       length: int, shard_size, version):
        """Serve a shard-range read from the resident cache, or None to
        fall through to the store.  Clean entries serve only when the
        requested version matches (the cached stream then equals the
        store bytes, version-attr check elided); raw reads
        (version=None) go to the store so corruption checks see real
        store bytes.  Deep scrub reads VERSION-MATCHED (scrub_batch
        passes the authoritative version), so warm clean entries serve
        it with zero H2D traffic — the tradeoff being that a warm
        scrub verifies the device-resident copy, and at-rest store rot
        surfaces once the entry is evicted (or on a cold sweep).  Dirty
        entries are the ONLY complete copy — they serve raw reads too,
        and a version mismatch raises rather than falling through to a
        stale store."""
        ent = self.resident.get(self.resident_ns, oid, shard)
        if ent is None:
            return None
        if version is not None and ent.version != version:
            if ent.dirty:
                raise ShardReadError(
                    f"shard {shard}: resident entry superseded "
                    f"(want v{version}, have v{ent.version})")
            return None
        if version is None and not ent.dirty:
            return None
        arr = ent.arr
        expected = length if shard_size is None else max(
            0, min(length, shard_size - off))
        if arr.shape[0] < off + expected:
            return None
        seg = arr[off: off + length]
        if seg.shape[0] < length:
            seg = torch.cat([seg, self._zeros(length - seg.shape[0])])
        return seg

    async def flush_resident(self) -> None:
        """Spill every dirty resident entry to the store (shutdown /
        export hook; a no-op in write-through mode)."""
        if self.resident is not None:
            await self.resident.flush(self.resident_ns)

    def resident_stats(self) -> dict:
        """Residency cache stats for this backend's namespace plus the
        transfer counters (the `ec resident stats` asok payload)."""
        if self.resident is None:
            return {"enabled": False}
        out = {"enabled": True,
               "writeback": self.resident_writeback,
               **self.resident.stats(ns=self.resident_ns)}
        for key in ("ec_resident_h2d_bytes", "ec_resident_d2h_bytes"):
            out[key] = int(self.perf.value(key))
        return out

    async def _settle_write_failures(self, what: str, oid: str,
                                     failed: list[int], heal,
                                     entry=None, causes=None) -> None:
        """Resolve a mutation's shard failures. Strict (logged) mode: a
        live-shard miss is healed SYNCHRONOUSLY (``heal``, e.g. rebuild
        from the shards that did commit) so the op still acks as fully
        committed; if healing fails, ECWriteDegraded marks a retryable
        non-ack. Lenient mode keeps tolerate-and-eager-repair. Beyond m
        failures the data is unrecoverable either way."""
        if not failed:
            return
        live = [i for i in failed
                if not getattr(self.shards[i], "is_dead", False)]
        if len(failed) > self.m:
            raise ShardReadError(
                f"{what} {oid}: shards {failed} failed "
                f"(live: {live}, m={self.m}), beyond recoverability"
                + (f"; causes: {causes}" if causes else "")
            )
        if self.strict and live:
            try:
                await heal(live)
            except (ShardReadError, IOError, KeyError) as e:
                # mark the shards stale (gates later writes on healing
                # them) and keep a background repair retrying
                self._schedule_repair(oid, live, entry)
                raise ECWriteDegraded(
                    f"{what} {oid}: live shards {live} missed the "
                    f"commit and healing failed: {e}"
                ) from e
        elif live:
            # degraded write: reads stay safe (stale shards fail the
            # version check) but heal eagerly so redundancy is restored
            # without waiting for re-peering
            self._schedule_repair(oid, live, entry)

    def _schedule_repair(self, oid: str, shards: list[int],
                         entry=None) -> None:
        self._dirty.setdefault(oid, set()).update(shards)

        async def repair():
            try:
                await self._heal_shards(oid, shards, entry)
            except (ShardReadError, IOError, KeyError):
                return      # shard still down; heal-on-next-write or
                            # peering recovery takes over
            dirty = self._dirty.get(oid)
            if dirty is not None:
                dirty.difference_update(shards)
                if not dirty:
                    del self._dirty[oid]

        task = asyncio.get_running_loop().create_task(repair())
        self._repair_tasks.add(task)
        task.add_done_callback(self._repair_tasks.discard)

    async def _heal_shards(self, oid: str, shards: list[int],
                           entry=None) -> None:
        """Bring stale shards current: rebuild from survivors — or, when
        a quorum of shards affirms the object is GONE (a failed remove
        left a straggler), propagate the removal instead. ``entry``
        (when known) is appended to the healed shards' pg logs so the
        heal commits the HISTORY too: a data-healed shard with a log gap
        would undercount appliers in the EC peering filter and could get
        an acked write rewound."""
        shards = sorted(shards)
        absent = sum(
            1 for r in await self._attr_all(oid, VERSION_ATTR)
            if isinstance(r, KeyError)
        )
        if absent >= self.k:
            for i in shards:
                try:
                    await self.shards[i].remove_shard(oid, log=entry)
                except KeyError:
                    pass
            return
        await self.recover_shard(oid, shards)
        if entry is not None:
            await asyncio.gather(*(
                self.shards[i].write_shard(oid, 0, b"", {}, log=entry)
                for i in shards
            ))

    async def _heal_dirty(self, oid: str) -> None:
        """Called under the object lock before a mutation: stale shards
        from an earlier failed attempt must be rebuilt before a new
        version bump could mask them."""
        dirty = self._dirty.get(oid)
        if not dirty:
            return
        try:
            await self._heal_shards(oid, sorted(dirty))
        except (ShardReadError, IOError, KeyError) as e:
            if self.strict:
                raise ECWriteDegraded(
                    f"{oid}: stale shards {sorted(dirty)} from a prior "
                    f"failed write are unhealed: {e}"
                ) from e
            return          # lenient: the new write fails there again,
                            # keeping the shard detectably stale
        self._dirty.pop(oid, None)

    async def try_heal(self, oid: str) -> bool:
        """Settle a prior attempt's shard gaps (used by the daemon when
        a client replays a not-yet-acked op): True when the object has
        no dirty shards left."""
        async with self._lock(oid):
            try:
                await self._heal_dirty(oid)
            except ShardReadError:
                return False
            return oid not in self._dirty

    async def _update_hinfo(self, oid: str, shard_off: int,
                            shard_bytes: list[np.ndarray],
                            old_size: int) -> list[bytes]:
        """Cumulative shard crcs, maintained for whole-object writes and
        pure appends only; mid-object overwrites invalidate hinfo (the
        reference likewise only maintains hinfo for append-style EC writes;
        overwrite pools drop it — ECTransaction.cc hinfo handling). An
        empty blob marks 'no hinfo'."""
        hinfo: HashInfo | None = None
        if shard_off == 0:
            hinfo = HashInfo(self.n)
            hinfo.append(0, [b.tobytes() for b in shard_bytes])
        elif shard_off == self.sinfo.logical_to_next_chunk_offset(old_size):
            raw = await self._get_attr_any(oid, HINFO_ATTR)
            try:
                if raw:
                    hinfo = HashInfo.from_dict(self.n, json.loads(raw))
            except ValueError:
                hinfo = None
            if hinfo is not None and hinfo.total_chunk_size == shard_off:
                hinfo.append(shard_off, [b.tobytes() for b in shard_bytes])
            else:
                hinfo = None
        blob = b"" if hinfo is None else json.dumps(hinfo.to_dict()).encode()
        return [blob] * self.n

    async def _update_hinfo_device(self, oid: str, shard_off: int,
                                   streams, old_size: int) -> list[bytes]:
        """Fused-checksum variant of :meth:`_update_hinfo` for the
        resident write-back path, where shard bytes exist only as the
        device-resident (n, L) stream batch.  The per-shard CRC32C is
        computed as a kernel epilogue — one extra bitplane contraction
        over the streams the encode just produced (ec/checksum.py) —
        instead of invalidating hinfo for want of host bytes.  The
        affine seed term (previous cumulative hash) folds in on host,
        so the recorded hashes are bit-identical to the host table
        loop.  Falls back to 'no hinfo' (empty blob) exactly where the
        host path would: mid-object overwrites, broken stored hinfo,
        and streams beyond the device-CRC length gate."""
        L = int(streams.shape[1])
        if not ec_checksum.supported_len(L):
            return [b""] * self.n
        if shard_off == 0:
            seeds = [ec_checksum.CRC_SEED] * self.n
        elif shard_off == self.sinfo.logical_to_next_chunk_offset(old_size):
            raw = await self._get_attr_any(oid, HINFO_ATTR)
            hinfo = None
            try:
                if raw:
                    hinfo = HashInfo.from_dict(self.n, json.loads(raw))
            except ValueError:
                hinfo = None
            if hinfo is None or hinfo.total_chunk_size != shard_off:
                return [b""] * self.n
            seeds = list(hinfo.cumulative_shard_hashes)
        else:
            return [b""] * self.n
        bits = ec_checksum.crc_bits_device(streams)
        crcs = ec_checksum.finalize_crcs(
            self._to_host(bits), seeds, L)
        new = HashInfo(self.n, shard_off + L, crcs)
        return [json.dumps(new.to_dict()).encode()] * self.n

    # -- read ------------------------------------------------------------
    async def _read_shard_range(self, shard: int, oid: str, off: int,
                                length: int,
                                shard_size: int | None = None,
                                version: int | None = None) -> np.ndarray:
        """Timing shell around :meth:`_read_shard_range_impl`: every
        completed shard read (success or failure) lands one sample in
        the ``ec_shard_read_us`` histogram — the distribution the QoS
        controller derives this OSD's adaptive hedge timeout from.
        Hedge-cancelled stragglers do NOT record: their observed
        latency is the timeout itself, and feeding it back would let
        the controller's own clamp masquerade as a measurement."""
        t0 = time.monotonic()
        try:
            result = await self._read_shard_range_impl(
                shard, oid, off, length, shard_size, version)
        except asyncio.CancelledError:
            raise
        except BaseException:
            self.perf.hinc("ec_shard_read_us",
                           (time.monotonic() - t0) * 1e6)
            raise
        self.perf.hinc("ec_shard_read_us",
                       (time.monotonic() - t0) * 1e6)
        return result

    async def _read_shard_range_impl(
            self, shard: int, oid: str, off: int, length: int,
            shard_size: int | None = None,
            version: int | None = None) -> np.ndarray:
        """Read [off, off+length) of a shard. A read shorter than the
        region the shard is KNOWN to hold (from object metadata) is a
        shard failure — truncation must trigger reconstruction, not
        zero-padded client data. When ``version`` is given, the shard's
        stored object version must match: a shard that missed a degraded
        write holds full-length but STALE bytes, and must be treated as
        failed, not served (the crc/hinfo-verify role of handle_sub_read,
        reference ECBackend.cc:1010)."""
        try:
            if fp.ACTIVE:
                await fp.fire("ec.shard_read")
                await fp.fire(f"ec.shard_read.{shard}")
            if self.resident is not None:
                hit = self._resident_read(shard, oid, off, length,
                                          shard_size, version)
                if hit is not None:
                    # served from the device-resident stream: no store
                    # round trip, no host materialization (downstream
                    # consumers convert at the client boundary only)
                    return hit
            if version is not None:
                raw_meta = await self.shards[shard].get_attr(
                    oid, VERSION_ATTR
                )
                if int(json.loads(raw_meta)["version"]) != version:
                    raise ShardReadError(
                        f"shard {shard}: stale version "
                        f"(want {version})"
                    )
            raw = await self.shards[shard].read_shard(oid, off, length)
        except ShardReadError:
            raise
        except Exception as e:
            raise ShardReadError(f"shard {shard}: {e}") from e
        expected = length if shard_size is None else max(
            0, min(length, shard_size - off)
        )
        if len(raw) < expected:
            raise ShardReadError(
                f"shard {shard}: short read {len(raw)} < {expected} "
                f"at offset {off} of {oid}"
            )
        if len(raw) < length:
            raw = raw + b"\0" * (length - len(raw))
        return np.frombuffer(raw, np.uint8)

    async def _read_logical(self, oid: str, offset: int, length: int,
                            obj_size: int,
                            version: int | None = None) -> bytes:
        """Read stripe-aligned logical range, reconstructing if needed."""
        if offset % self.sinfo.stripe_width:
            raise ValueError("offset must be stripe aligned")
        nstripes = -(-length // self.sinfo.stripe_width)
        clen = nstripes * self.sinfo.chunk_size
        coff = self.sinfo.aligned_logical_offset_to_chunk_offset(offset)
        ssize = self.sinfo.logical_to_next_chunk_offset(obj_size)

        want = list(self.data_shards)
        if self.hedge_timeout:
            chunks = await self._read_chunks_hedged(
                oid, coff, clen, ssize, version, want
            )
        else:
            results = await asyncio.gather(*(
                self._read_shard_range(i, oid, coff, clen, ssize, version)
                for i in want
            ), return_exceptions=True)
            missing = [s for s, r in zip(want, results)
                       if isinstance(r, BaseException)]
            if missing:
                chunks = await self._reconstruct(
                    oid, coff, clen, missing, results, ssize, version
                )
            else:
                chunks = dict(zip(want, results))
        # the Objecter/client boundary: resident chunks materialize to
        # host HERE (one counted copy of the payload), not per-launch
        stripes = np.stack(
            [self._to_host(chunks[i]).reshape(nstripes,
                                              self.sinfo.chunk_size)
             for i in self.data_shards], axis=1,
        )
        flat = self.sinfo.merge_stripes(stripes)
        return flat[:length].tobytes()

    async def _read_chunks_hedged(
        self, oid: str, coff: int, clen: int, ssize: int | None,
        version: int | None, want: list[int],
    ) -> dict[int, np.ndarray]:
        """Hedged shard fan-in: wait ``hedge_timeout`` for the direct
        data-shard reads; shards still pending are treated as slow and
        raced against a minimum_to_decode reconstruction from the
        surviving shards (the tail-latency hedge of degraded-read
        literature).  Bit-identical to the direct path — the race only
        decides WHERE the bytes come from, the decode math is the same
        GF(2^8) inverse the failure path uses."""
        tasks = {
            i: asyncio.create_task(
                self._read_shard_range(i, oid, coff, clen, ssize,
                                       version))
            for i in want
        }
        await asyncio.wait(tasks.values(), timeout=self.hedge_timeout)
        slow = [i for i in want if not tasks[i].done()]
        results = [
            (tasks[i].exception() if tasks[i].done()
             and tasks[i].exception() is not None
             else tasks[i].result() if tasks[i].done()
             else ShardReadError(f"shard {i}: hedged (slow)"))
            for i in want
        ]
        failed = [i for i in want
                  if tasks[i].done() and tasks[i].exception() is not None]
        if not slow:
            if failed:
                return await self._reconstruct(
                    oid, coff, clen, failed, results, ssize, version)
            return {i: tasks[i].result() for i in want}
        # hedge fires: reconstruct failed+slow positions from survivors
        # while the stragglers keep running; first full answer wins
        self.perf.inc("hedge_issued")
        missing = failed + slow
        rec = asyncio.create_task(self._reconstruct(
            oid, coff, clen, missing, results, ssize, version))
        slow_all = asyncio.ensure_future(asyncio.gather(
            *(tasks[i] for i in slow), return_exceptions=True))
        pending = {rec, slow_all}
        try:
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                if rec in done and rec.exception() is None:
                    self.perf.inc("hedge_won")
                    return rec.result()
                if slow_all in done:
                    sres = slow_all.result()
                    if not failed and not any(
                            isinstance(r, BaseException) for r in sres):
                        self.perf.inc("hedge_lost")
                        return {i: tasks[i].result() for i in want}
                # a path failed (or landed unusable): wait for the other
        finally:
            rec.cancel()
            slow_all.cancel()
            for i in slow:
                tasks[i].cancel()
            # retrieve loser-side results so cancellation doesn't log
            # "exception was never retrieved" for the racing futures
            await asyncio.gather(rec, slow_all, return_exceptions=True)
        # neither path produced a clean answer on its own: re-evaluate
        # with every read that DID land (a slow-but-successful shard can
        # rescue a reconstruction that lacked survivors)
        final: list = []
        for i in want:
            t = tasks[i]
            if t.done() and not t.cancelled() and t.exception() is None:
                final.append(t.result())
            else:
                final.append(ShardReadError(f"shard {i}: unavailable"))
        missing2 = [i for i, r in zip(want, final)
                    if isinstance(r, BaseException)]
        if not missing2:
            return {i: r for i, r in zip(want, final)}
        return await self._reconstruct(
            oid, coff, clen, missing2, final, ssize, version)

    async def _reconstruct(
        self, oid: str, coff: int, clen: int,
        missing: Sequence[int], partial, shard_size: int | None = None,
        version: int | None = None,
    ) -> dict[int, np.ndarray]:
        """minimum_to_decode-driven repair read + batched decode.
        ``partial`` is aligned with the read path's want set (the data
        shards, in logical order)."""
        have = {
            s: r for s, r in zip(self.data_shards, partial)
            if not isinstance(r, BaseException)
        }
        # Availability is discovered, not assumed: shards beyond the initial
        # read set may also be dead. Retry minimum_to_decode against the
        # shrinking available set until a fetch round fully succeeds
        # (get_min_avail_to_read_shards semantics, ECBackend.cc:1613).
        dead = set(missing)
        while True:
            avail = [i for i in range(self.n) if i not in dead]
            try:
                need = minimum_to_decode_cached(
                    self.ec, list(missing), avail, perf=self.perf)
            except IOError:
                raise ShardReadError(
                    f"cannot reconstruct {oid}: "
                    f"only {sorted(set(have))} available"
                ) from None
            extra = [s for s in need if s not in have]
            if not extra:
                break
            fetched = await asyncio.gather(*(
                self._read_shard_range(s, oid, coff, clen, shard_size,
                                       version)
                for s in extra
            ), return_exceptions=True)
            newly_dead = False
            for s, r in zip(extra, fetched):
                if isinstance(r, BaseException):
                    dead.add(s)
                    newly_dead = True
                else:
                    have[s] = r
            if not newly_dead:
                break
        nstripes = clen // self.sinfo.chunk_size
        batched = {
            s: arr.reshape(nstripes, self.sinfo.chunk_size)
            for s, arr in have.items()
        }
        out = await self._coalesced_decode(batched, list(missing))
        chunks = {}
        for i in self.data_shards:
            if i in have:
                chunks[i] = have[i]
            elif self._is_device(out[i]):
                chunks[i] = out[i].reshape(-1)
            else:
                chunks[i] = np.ascontiguousarray(out[i]).reshape(-1)
        return chunks

    async def read(self, oid: str, offset: int = 0,
                   length: int | None = None) -> bytes:
        async with self._track_op():
            meta = await self._read_meta(oid)
            if meta is None:
                raise KeyError(f"no such object {oid}")
            if length is None:
                length = meta.size - offset
            length = max(0, min(length, meta.size - offset))
            if length == 0:
                return b""
            a_start, a_len = self.sinfo.offset_len_to_stripe_bounds(
                offset, length
            )
            data = await self._read_logical(oid, a_start, a_len,
                                            meta.size, meta.version)
            rel = offset - a_start
            return data[rel: rel + length]

    # -- object metadata ops (fan-out; metadata is replicated per shard) --
    async def remove(self, oid: str, reqid: str = "") -> None:
        """Remove every shard object. A shard that lacks it is fine; IO
        failures beyond m mean the removal did not take and must raise
        (a silently-surviving shard would resurrect the object)."""
        async with self._lock(oid):
            # invalidate INSIDE the object lock: outside it, a write
            # already past its gather could note_write AFTER this
            # invalidate and resurrect pre-delete bytes in the cache
            self.extent_cache.invalidate(oid)
            if self.resident is not None:
                self.resident.drop_object(self.resident_ns, oid)
            meta = await self._read_meta(oid) if self.log_hook else None
            entry = (self.log_hook(oid, "delete", 0,
                                   meta.version if meta else 0, reqid)
                     if self.log_hook else None)

            async def rm(i: int):
                try:
                    await self.shards[i].remove_shard(oid, log=entry)
                except KeyError:
                    pass            # already absent on this shard
            results = await asyncio.gather(
                *(rm(i) for i in range(self.n)), return_exceptions=True
            )
            failed = [i for i, r in enumerate(results)
                      if isinstance(r, BaseException)]

            async def heal(live):
                for i in live:
                    try:
                        await self.shards[i].remove_shard(oid,
                                                          log=entry)
                    except KeyError:
                        pass
            await self._settle_write_failures("remove", oid, failed,
                                              heal, entry)
            self._dirty.pop(oid, None)  # nothing left to be stale about

    async def set_attr(self, oid: str, name: str, value: bytes,
                       reqid: str = "") -> None:
        """Set one attr on all shards (zero-length data write carries it);
        tolerates up to m dead shards like a degraded data write. The
        per-object version is bumped and rewritten with the attr so a
        shard that missed the write is distinguishable from a current
        one (stale-version detection, like the degraded data path)."""
        async with self._lock(oid):
            await self._heal_dirty(oid)
            meta = await self._read_meta(oid)
            new_meta = ECObjectMeta(
                meta.size if meta else 0,
                meta.version + 1 if meta else 1,
            )
            attrs = {name: bytes(value),
                     VERSION_ATTR: self._meta_attr(new_meta)}
            entry = (self.log_hook(oid, "modify", new_meta.version,
                                   meta.version if meta else 0, reqid)
                     if self.log_hook else None)
            results = await asyncio.gather(*(
                self.shards[i].write_shard(oid, 0, b"", attrs, log=entry)
                for i in range(self.n)
            ), return_exceptions=True)
            failed = [i for i, r in enumerate(results)
                      if isinstance(r, BaseException)]
            await self._settle_write_failures(
                "set_attr", oid, failed,
                lambda live: self._heal_shards(oid, live, entry),
                entry,
            )
            if self.resident is not None:
                # shard data is untouched; restamp resident entries so
                # version-matched reads keep hitting
                self.resident.bump_version(self.resident_ns, oid,
                                           new_meta.version)

    async def get_attrs(self, oid: str) -> dict[str, bytes]:
        """All attrs, from the answering shard with the HIGHEST stored
        version: attr mutations bump the object version (set_attr), so
        the max-version shard is the one guaranteed current — the first
        responder may have missed a degraded attr write."""
        async def fetch(i: int):
            getattrs = getattr(self.shards[i], "get_attrs", None)
            if getattrs is None:
                raise ShardReadError(f"shard {i}: no get_attrs")
            return dict(await getattrs(oid))

        results = await asyncio.gather(
            *(fetch(i) for i in range(self.n)), return_exceptions=True
        )
        best: dict[str, bytes] | None = None
        best_version = -1
        errors = []
        absent = False
        for i, r in enumerate(results):
            if isinstance(r, KeyError):
                absent = True
            elif isinstance(r, BaseException):
                errors.append((i, r))
            else:
                try:
                    version = int(json.loads(r[VERSION_ATTR])["version"])
                except (KeyError, ValueError, TypeError):
                    version = 0
                if version > best_version:
                    best, best_version = r, version
        if best is not None:
            return best
        if absent:
            return {}
        raise ShardReadError(f"get_attrs {oid}: {errors}")

    # -- recovery --------------------------------------------------------
    async def recover_shard(self, oid: str, lost: Sequence[int],
                            version: int | None = None,
                            stray_read=None,
                            stray_positions: Sequence[int] = ()) -> int:
        async with self._track_op():
            return await self._recover_shard_impl(
                oid, lost, version=version, stray_read=stray_read,
                stray_positions=stray_positions,
            )

    async def _recover_shard_impl(
            self, oid: str, lost: Sequence[int],
            version: int | None = None, stray_read=None,
            stray_positions: Sequence[int] = ()) -> int:
        """Rebuild lost shard objects from survivors (RecoveryOp).
        Source shards are version-verified so a stale survivor (missed
        degraded write) counts as lost, not as a rebuild source.
        ``version`` pins the target explicitly (log-driven recovery,
        incl. REWIND: rebuilding shards that applied a dropped entry
        back to the prior version — their own attrs advertise the
        dropped version, so the max-version guess must not be used).
        ``stray_read(pos, oid, version, shard_len)``: optional extra
        source — when an acting shard cannot serve a position, a
        former holder (stray after a partial remap) is read instead,
        so decode can MIX acting and stray shards (the reference pulls
        from any peer in the missing-loc set, MissingLoc)."""
        try:
            meta = await self._target_meta(oid, version)
        except ShardReadError:
            meta = None
        # probe results (pos -> (arr, attrs, version)) are reused by
        # read_source below — a stray shard is fetched once, not twice
        probe: dict[int, tuple[np.ndarray, dict, int]] = {}
        if meta is None and stray_read is not None:
            # no acting shard even knows the object (total remap):
            # probe the strays for its metadata before deciding.  With
            # no pinned version the MAX across strays wins (the
            # _read_meta rule — a stale stray that missed a degraded
            # write must not pin recovery to its dropped version).
            best = None
            for pos in stray_positions:
                try:
                    arr, attrs = await stray_read(pos, oid, version,
                                                  None)
                    d = json.loads(attrs[VERSION_ATTR])
                    cand = ECObjectMeta(int(d["size"]),
                                        int(d["version"]))
                except (ShardReadError, KeyError, ValueError,
                        TypeError):
                    continue
                probe[pos] = (arr, attrs, cand.version)
                if version is not None:
                    best = cand
                    break
                if best is None or cand.version > best.version:
                    best = cand
            meta = best
        if meta is None:
            raise KeyError(f"no such object {oid}")
        shard_len = self.sinfo.logical_to_next_chunk_offset(meta.size)

        # Positions a stray might serve: still rebuild targets (in
        # ``lost``) but USABLE as decode sources — the partial-overlap
        # case where acting + strays together reach k even though
        # neither alone does.
        stray_avail: set[int] = set(stray_positions or ()) \
            if stray_read is not None else set()

        stray_attrs: dict[int, dict] = {}    # positions served by strays

        async def read_source(s: int) -> np.ndarray:
            try:
                return await self._read_shard_range(
                    s, oid, 0, shard_len, shard_len, meta.version
                )
            except ShardReadError:
                if stray_read is None or s not in stray_avail:
                    raise
                cached = probe.get(s)
                if cached is not None and cached[2] == meta.version \
                        and len(cached[0]) >= shard_len:
                    arr, attrs = cached[0][:shard_len], cached[1]
                else:
                    arr, attrs = await stray_read(
                        s, oid, meta.version, shard_len
                    )
                stray_attrs[s] = attrs
                return arr

        lost = list(lost)
        while True:
            avail = [i for i in range(self.n)
                     if i not in lost or i in stray_avail]
            # memoized: a 1000-object drain with one failure pattern
            # derives the read set once (retry loops shrink avail,
            # which is a new cache key — the fallback stays intact)
            need = minimum_to_decode_cached(
                self.ec, lost, avail, perf=self.perf)
            reads = await asyncio.gather(*(
                read_source(s) for s in need
            ), return_exceptions=True)
            newly_lost = [
                s for s, r in zip(need, reads)
                if isinstance(r, BaseException)
            ]
            if not newly_lost:
                break
            for s in newly_lost:
                stray_avail.discard(s)
                if s not in lost:
                    lost.append(s)
        nstripes = shard_len // self.sinfo.chunk_size
        batched = {
            s: arr.reshape(nstripes, self.sinfo.chunk_size)
            for s, arr in zip(need, reads)
        }
        out = await self._coalesced_decode(batched, lost)
        # copy the FULL attr set from a version-verified survivor — a
        # rebuilt shard missing user xattrs would serve stale attr
        # reads.  Prefer an acting source; when every source was a
        # stray (total remap), its verified attr set serves the role.
        acting_ok = [s for s in need if s not in stray_attrs]
        if acting_ok:
            good = acting_ok[0]
            getattrs = getattr(self.shards[good], "get_attrs", None)
            if getattrs is not None:
                attrs = dict(await getattrs(oid))
            else:
                attrs = {
                    VERSION_ATTR: await self.shards[good].get_attr(
                        oid, VERSION_ATTR
                    ),
                    HINFO_ATTR: await self.shards[good].get_attr(
                        oid, HINFO_ATTR
                    ),
                }
        else:
            attrs = dict(stray_attrs[next(iter(need))])
        await asyncio.gather(*(
            self.shards[s].write_shard(
                oid, 0,
                np.ascontiguousarray(self._to_host(out[s])).tobytes(),
                attrs,
            )
            for s in lost
        ))
        if self.resident is not None:
            # rebuilt store content supersedes whatever the cache held
            # for these positions (a clean entry would be identical,
            # but dropping is unconditionally safe)
            for s in lost:
                self.resident.drop(self.resident_ns, oid, s)
        # bytes actually written (lost may have GROWN on source-read
        # failures): the caller's motion accounting must reconcile
        # against placement predictions, so guessing from the request
        # is not good enough
        return shard_len * len(lost)

    # -- batched recovery (the repair engine's data path) -----------------
    async def recover_batch(self, names: Sequence[str],
                            lost: Sequence[int],
                            versions: Mapping[str, int] | None = None
                            ) -> dict:
        """Rebuild ``lost`` shard positions of MANY objects through
        shared decode launches (the RepairScheduler's entry point).

        All objects must share the failure pattern ``lost``; the repair
        strategy — plain-RS read set, LRC group-local reads, or CLAY
        helper sub-chunk plane reads — is planned once per (codec,
        lost, avail) and applied batch-wide.  Objects the batch cannot
        serve (metadata/read/write failure, zero length) are simply NOT
        in the returned ``recovered`` list; the caller demotes them to
        the per-object ``recover_shard`` path, which retries, shrinks
        read sets, and pulls stray sources.  Returns::

            {"recovered": [names...], "strategy": "rs|lrc|clay",
             "batches": <decode launches issued>}
        """
        async with self._track_op():
            return await self._recover_batch_impl(
                list(names), list(lost), dict(versions or {}))

    async def _recover_batch_impl(self, names: list, lost: list,
                                  versions: dict) -> dict:
        lost = sorted({int(s) for s in lost})
        avail = [i for i in range(self.n) if i not in lost]
        # strategy selection + memoized plan: IOError (loss beyond
        # repair) propagates — the whole batch demotes
        plan = plan_repair(self.ec, lost, avail, perf=self.perf)
        metas: dict[str, ECObjectMeta] = {}
        by_len: dict[int, list[str]] = {}
        for name in names:
            try:
                meta = await self._target_meta(
                    name, versions.get(name) or None)
            except ShardReadError:
                meta = None
            if meta is None or meta.size <= 0:
                continue          # demote: classic path probes strays
            metas[name] = meta
            by_len.setdefault(
                self.sinfo.logical_to_next_chunk_offset(meta.size), []
            ).append(name)
        recovered: list[str] = []
        batches = 0
        rebuilt_bytes = 0
        for shard_len, group in sorted(by_len.items()):
            done = await self._repair_group(
                group, lost, plan, shard_len, metas)
            recovered.extend(done)
            if done:
                batches += 1
                rebuilt_bytes += shard_len * len(lost) * len(done)
        return {"recovered": recovered, "strategy": plan.strategy,
                "batches": batches, "bytes": rebuilt_bytes}

    async def _repair_group(self, group: list, lost: list,
                            plan: RepairPlan, shard_len: int,
                            metas: dict) -> list:
        """One uniform-shard-length batch: bulk survivor fetch, ONE
        decode launch, rebuilt-shard fan-out.  Returns the names that
        completed end to end."""
        import contextlib

        C = self.sinfo.chunk_size
        nstripes = shard_len // C
        read_set = list(plan.read_set)
        span = (self.tracer.span(
            "osd:ec:repair_batch", current_span(),
            objects=len(group), strategy=plan.strategy,
            lost=",".join(str(s) for s in lost), shard_len=shard_len,
        ) if self.tracer is not None else contextlib.nullcontext())
        with span:
            if plan.strategy == "clay":
                ok, payload = await self._repair_fetch_clay(
                    group, plan, shard_len, nstripes, metas)
            else:
                ok, payload = await self._repair_fetch_whole(
                    group, read_set, shard_len, nstripes, metas)
            if not ok:
                return []
            per_obj_read = (
                len(read_set) * shard_len if plan.strategy != "clay"
                else len(read_set) * nstripes
                * len(plan.planes) * (C // plan.sub_chunk_no))
            whole = self.k * shard_len
            self.perf.inc("ec_repair_read_bytes",
                          per_obj_read * len(ok))
            self.perf.inc("ec_repair_read_bytes_saved",
                          max(0, whole - per_obj_read) * len(ok))
            if plan.strategy == "rs":
                out = ("rs", self._repair_batched_rs(
                    ok, payload, read_set, nstripes))
            elif plan.strategy == "lrc":
                out = await self._repair_decode_lrc(
                    ok, payload, plan, nstripes)
            else:
                out = await self._repair_decode_clay(
                    ok, payload, plan, nstripes)
            self.perf.inc("ec_repair_batches")
            done = await self._repair_writeout(
                ok, lost, read_set, out, shard_len, nstripes)
            self.perf.inc("ec_repair_objects", len(done))
            self.perf.inc("ec_repair_rebuild_bytes",
                          shard_len * len(lost) * len(done))
            return done

    async def _repair_fetch_whole(self, group, read_set, shard_len,
                                  nstripes, metas):
        """Vectored survivor pull, whole shards (rs/lrc strategies):
        every (object, survivor) read runs concurrently; an object with
        any failed read drops out of the batch (demoted).  With the
        device-resident cache on, fetched streams install in one
        vectored pass and the decode consumes the SAME device arrays —
        zero re-upload into the launch."""
        async def read_obj(oid):
            reads = await asyncio.gather(*(
                self._read_shard_range(s, oid, 0, shard_len, shard_len,
                                       metas[oid].version)
                for s in read_set
            ), return_exceptions=True)
            if any(isinstance(r, BaseException) for r in reads):
                return None
            return reads

        per_obj = await asyncio.gather(*(read_obj(o) for o in group))
        ok = [o for o, r in zip(group, per_obj) if r is not None]
        payload = {o: r for o, r in zip(group, per_obj)
                   if r is not None}
        if payload and self.resident is not None:
            entries = []
            for oid, reads in payload.items():
                devs = [self._to_device(r) for r in reads]
                payload[oid] = devs
                entries.extend(
                    (oid, s, d, metas[oid].version)
                    for s, d in zip(read_set, devs))
            self.resident.install_batch(self.resident_ns, entries)
        return ok, payload

    async def _repair_fetch_clay(self, group, plan, shard_len,
                                 nstripes, metas):
        """Vectored helper sub-chunk pull (clay strategy): each helper
        contributes only its repair planes — 1/q of its bytes — via
        ranged reads (consecutive planes coalesce into one range)."""
        from ceph_tpu_torch.parallel.clay_sharding import clay_plane_ranges

        C = self.sinfo.chunk_size
        sc = C // plan.sub_chunk_no
        sorted_planes = sorted(plan.planes)
        ranges = clay_plane_ranges(sorted_planes, sc)
        # ranged reads arrive in ascending-plane order; reindex into
        # the operator's plane order (R's input layout)
        order = [sorted_planes.index(p) for p in plan.planes]

        async def read_helper(oid, h):
            meta = metas[oid]
            block = np.empty((nstripes, len(sorted_planes), sc),
                             np.uint8)
            version: int | None = meta.version
            for t in range(nstripes):
                col = 0
                for off, ln in ranges:
                    arr = self._to_host(await self._read_shard_range(
                        h, oid, t * C + off, ln, shard_len, version))
                    version = None    # one version check per shard
                    rows = ln // sc
                    block[t, col:col + rows] = arr.reshape(rows, sc)
                    col += rows
            return block[:, order]

        async def read_obj(oid):
            blocks = await asyncio.gather(*(
                read_helper(oid, h) for h in plan.read_set
            ), return_exceptions=True)
            if any(isinstance(b, BaseException) for b in blocks):
                return None
            # (nstripes, d, P, sc) -> (nstripes, d*P, sc): the helper-
            # major stacking clay_repair_operator probed R against
            flat = np.stack(blocks, axis=1)
            return flat.reshape(nstripes, -1, sc)

        per_obj = await asyncio.gather(*(read_obj(o) for o in group))
        ok = [o for o, r in zip(group, per_obj) if r is not None]
        return ok, {o: r for o, r in zip(group, per_obj)
                    if r is not None}

    def _repair_batched_rs(self, ok, payload, read_set, nstripes):
        """Assemble the rs strategy's batched decode input: every
        object's stripes concatenate along the batch axis, keyed by
        survivor shard id.  The decode itself goes through
        ``_coalesced_decode`` (in writeout), so the launch may merge
        with other in-flight groups in the CoalescedLauncher /
        MeshCoalescer window — the cross-PG coalescing leg."""
        C = self.sinfo.chunk_size
        any_dev = any(self._is_device(c)
                      for oid in ok for c in payload[oid])
        if any_dev:
            return {s: torch.cat(
                [self._to_device(payload[oid][j]).reshape(nstripes, C)
                 for oid in ok], dim=0)
                for j, s in enumerate(read_set)}
        return {s: np.concatenate(
            [payload[oid][j].reshape(nstripes, C) for oid in ok],
            axis=0)
            for j, s in enumerate(read_set)}

    async def _repair_decode_lrc(self, ok, payload, plan, nstripes):
        """LRC group-local decode: one (1, L) GF(2^8) apply recovers
        every stripe of every object in the batch."""
        from ceph_tpu_torch.parallel.lrc_sharding import \
            batched_lrc_group_repair

        C = self.sinfo.chunk_size
        stacked = np.concatenate([
            np.stack([self._to_host(a).reshape(nstripes, C)
                      for a in payload[oid]], axis=1)
            for oid in ok
        ], axis=0)                            # (b, L, C)
        self.perf.inc("ec_device_launches")
        self.perf.inc("ec_launch_bytes", stacked.nbytes)
        self.perf.inc("ec_resident_h2d_bytes", stacked.nbytes)
        t0 = time.perf_counter()
        rec, timing = await self._launch(
            batched_lrc_group_repair, self.ec, plan.matrix, stacked)
        dt_us = (time.perf_counter() - t0) * 1e6
        self.perf.hinc("ec_decode_launch_us", dt_us)
        self.profiler.record(f"{self.codec_sig}:dec", dt_us,
                             stripes=stacked.shape[0],
                             hbm_bytes=stacked.nbytes)
        self._device_time(timing, "dec")
        self.perf.inc("ec_resident_d2h_bytes", rec.nbytes)
        return rec

    async def _repair_decode_clay(self, ok, payload, plan, nstripes):
        """CLAY plane decode: one (sub, d*P) GF(2^8) apply over the
        gathered repair planes recovers the whole batch."""
        from ceph_tpu_torch.parallel.clay_sharding import \
            batched_clay_plane_repair

        flat = np.concatenate([payload[oid] for oid in ok], axis=0)
        self.perf.inc("ec_device_launches")
        self.perf.inc("ec_launch_bytes", flat.nbytes)
        self.perf.inc("ec_resident_h2d_bytes", flat.nbytes)
        t0 = time.perf_counter()
        rec, timing = await self._launch(
            batched_clay_plane_repair, self.ec, plan.matrix, flat)
        dt_us = (time.perf_counter() - t0) * 1e6
        self.perf.hinc("ec_decode_launch_us", dt_us)
        self.profiler.record(f"{self.codec_sig}:dec", dt_us,
                             stripes=flat.shape[0],
                             hbm_bytes=flat.nbytes)
        self._device_time(timing, "dec")
        self.perf.inc("ec_resident_d2h_bytes", rec.nbytes)
        return rec

    async def _repair_writeout(self, ok, lost, read_set, out,
                               shard_len, nstripes):
        """Fan the rebuilt shards out, per object: full attr set copied
        from a version-verified survivor (rebuilt shards missing user
        xattrs would serve stale attr reads), then write_shard to every
        lost position and drop superseded resident entries."""
        decoded = out
        if isinstance(out, tuple):      # rs path: decode HERE so the
            _, batched = out            # strategy paths share writeout
            decoded = await self._coalesced_decode(batched, lost)
        done: list = []

        async def finish(idx, oid):
            try:
                good = read_set[0]
                getattrs = getattr(self.shards[good], "get_attrs",
                                   None)
                if getattrs is not None:
                    attrs = dict(await getattrs(oid))
                else:
                    attrs = {
                        VERSION_ATTR: await self.shards[good].get_attr(
                            oid, VERSION_ATTR),
                        HINFO_ATTR: await self.shards[good].get_attr(
                            oid, HINFO_ATTR),
                    }
                lo, hi = idx * nstripes, (idx + 1) * nstripes

                def shard_bytes(w):
                    if isinstance(decoded, dict):
                        sl = decoded[w][lo:hi]
                    else:
                        sl = decoded[lo:hi]   # single-loss (b, C)
                    return np.ascontiguousarray(
                        self._to_host(sl)).tobytes()

                await asyncio.gather(*(
                    self.shards[s].write_shard(
                        oid, 0, shard_bytes(s), attrs)
                    for s in lost
                ))
            except (ShardReadError, IOError, KeyError):
                return
            if self.resident is not None:
                for s in lost:
                    self.resident.drop(self.resident_ns, oid, s)
            done.append(oid)

        await asyncio.gather(*(
            finish(i, oid) for i, oid in enumerate(ok)))
        return done

    # -- scrub -----------------------------------------------------------
    async def scrub(self, oid: str) -> dict:
        async with self._track_op():
            return await self._scrub_impl(oid)

    async def _scrub_impl(self, oid: str) -> dict:
        """Deep scrub: recompute parity from data shards on device and
        compare against stored parity + hinfo crcs. Returns a report."""
        meta = await self._read_meta(oid)
        if meta is None:
            raise KeyError(f"no such object {oid}")
        shard_len = self.sinfo.logical_to_next_chunk_offset(meta.size)
        reads = await asyncio.gather(*(
            self._read_shard_range(i, oid, 0, shard_len, shard_len)
            for i in range(self.n)
        ), return_exceptions=True)
        # an unreadable shard is convicted as MISSING, zero-filled to
        # keep the math rectangular (same contract as scrub_batch:
        # parity/crc verdicts are void, repair rebuilds, the next
        # sweep verifies)
        read_missing = {i for i, r in enumerate(reads)
                        if isinstance(r, BaseException)}
        # raw (version=None) reads come from the store except for dirty
        # write-back entries; materialize those once for the host-side
        # comparisons below
        reads = [np.zeros(shard_len, np.uint8)
                 if isinstance(r, BaseException) else self._to_host(r)
                 for i, r in enumerate(reads)]
        nstripes = shard_len // self.sinfo.chunk_size
        stripes = np.stack(
            [reads[i].reshape(nstripes, self.sinfo.chunk_size)
             for i in self.data_shards], axis=1,
        )
        recomputed = await self._coalesced_encode(stripes)
        self.perf.inc("ec_scrub_launches")
        inconsistent = []
        for i in range(self.n):
            if i in self.data_shards:
                continue        # parity positions only (mapped layouts
                                # interleave them between data groups)
            stored = reads[i].reshape(nstripes, self.sinfo.chunk_size)
            if not np.array_equal(recomputed[:, i], stored):
                inconsistent.append(i)
        stale, missing = await self._scrub_shard_versions(
            oid, meta.version)
        miss = sorted(read_missing | set(missing))
        if miss:
            self.perf.inc("ec_scrub_objects")
            self.perf.inc("ec_scrub_bytes", shard_len * self.n)
            return self._scrub_report(oid, meta.version, [], [],
                                      stale, miss, False)
        crc_mismatch = []
        raw = await self._get_attr_any(oid, HINFO_ATTR) or b""
        if raw:  # empty blob == hinfo invalidated by overwrite
            hinfo = HashInfo.from_dict(self.n, json.loads(raw))
            for i in range(self.n):
                # slice the array view first, THEN convert: one copy of
                # the crc'd prefix instead of materializing the whole
                # shard stream and slicing the bytes
                shard_view = reads[i][: hinfo.total_chunk_size].tobytes()
                if crc32c(0xFFFFFFFF, shard_view) != \
                        hinfo.get_chunk_hash(i):
                    crc_mismatch.append(i)
        self.perf.inc("ec_scrub_objects")
        self.perf.inc("ec_scrub_bytes", shard_len * self.n)
        return self._scrub_report(oid, meta.version, inconsistent,
                                  crc_mismatch, stale, missing,
                                  bool(raw))

    async def _scrub_shard_versions(
            self, oid: str, version: int) -> tuple[list[int], list[int]]:
        """Per-shard version audit: (stale, missing).

        A shard that answers with a DIFFERENT version (or unparseable
        metadata) is STALE — it missed a degraded write and holds old
        bytes.  A shard that cannot answer at all (object/attr absent,
        shard unreachable) is MISSING — there is nothing there to be
        stale.  The two used to be conflated into 'stale', which
        misattributed wholesale shard loss as a version skew."""
        stale: list[int] = []
        missing: list[int] = []
        for i in range(self.n):
            try:
                raw_meta = await self.shards[i].get_attr(
                    oid, VERSION_ATTR)
            except Exception:                  # noqa: BLE001
                missing.append(i)
                continue
            try:
                if int(json.loads(raw_meta)["version"]) != version:
                    stale.append(i)
            except (ValueError, TypeError, KeyError):
                stale.append(i)
        return stale, missing

    def _scrub_report(self, oid: str, version: int,
                      inconsistent: list[int], crc_mismatch: list[int],
                      stale: list[int], missing: list[int],
                      have_hinfo: bool) -> dict:
        return {
            "object": oid,
            "version": version,
            "parity_inconsistent": inconsistent,
            "crc_mismatch": crc_mismatch,
            "stale_version": stale,
            # shards with nothing to verify at all — routed to repair,
            # never reported as 'stale'
            "missing_shards": missing,
            # whether per-shard crc attribution was available: without
            # it a parity mismatch cannot name the rotten shard
            "hinfo": have_hinfo,
            "clean": not inconsistent and not crc_mismatch
            and not stale and not missing,
        }

    # -- batched scrub (the ScrubEngine data path) ------------------------
    async def scrub_batch(self, names: Sequence[str]) -> dict:
        """Deep-scrub a whole batch of objects in coalesced launches.

        Objects group by shard-stream length (same bucketing as
        recover_batch); each group re-encodes in ONE coalesced device
        launch and verifies parity + per-shard CRC32C in one verify step
        (ec/checksum.py: a device compare and one B2 CRC launch, counted
        as one scrub launch, as the JAX backend's fused launch is) — the
        host sees per-object
        verdicts, never the shard bytes.  Returns ``{"reports": {name:
        report | None}, "groups": int}`` with reports in the exact
        :meth:`scrub` shape (None: object vanished between listing and
        scrub)."""
        async with self._track_op():
            return await self._scrub_batch_impl(list(names))

    async def _scrub_batch_impl(self, names: list[str]) -> dict:
        reports: dict[str, dict | None] = {}
        metas: dict[str, ECObjectMeta] = {}
        for oid in names:
            meta = await self._read_meta(oid)
            if meta is None:
                reports[oid] = None
                continue
            metas[oid] = meta
        by_len: dict[int, list[str]] = {}
        for oid, meta in metas.items():
            by_len.setdefault(
                self.sinfo.logical_to_next_chunk_offset(meta.size), []
            ).append(oid)
        groups = 0
        for shard_len, group in sorted(by_len.items()):
            if shard_len == 0:
                for oid in group:       # zero-length: nothing to rot
                    reports[oid] = self._scrub_report(
                        oid, metas[oid].version, [], [], [], [], False)
                continue
            await self._scrub_group(sorted(group), shard_len, metas,
                                    reports)
            groups += 1
        return {"reports": reports, "groups": groups}

    async def _scrub_group(self, group: list[str], shard_len: int,
                           metas: dict, reports: dict) -> None:
        """Verify one equal-shard-length group in two counted scrub
        launches: a coalesced re-encode of every object's data shards,
        then the parity compare + CRC contraction over the stored
        streams."""
        chunk = self.sinfo.chunk_size
        nstripes = shard_len // chunk
        B, n, k = len(group), self.n, len(self.data_shards)
        missing: dict[str, set[int]] = {oid: set() for oid in group}

        async def fetch(oid: str, i: int):
            # resident first, version-matched: a clean device-resident
            # entry at the object's authoritative version serves the
            # scrub read with zero H2D traffic (the warm-scrub path)
            if self.resident is not None:
                try:
                    hit = self._resident_read(
                        i, oid, 0, shard_len, shard_len,
                        metas[oid].version)
                except ShardReadError:
                    hit = None
                if hit is not None:
                    return hit
            return await self._read_shard_range(
                i, oid, 0, shard_len, shard_len)

        rows: list[list] = []
        for oid in group:
            reads = await asyncio.gather(
                *(fetch(oid, i) for i in range(n)),
                return_exceptions=True)
            row = []
            for i, r in enumerate(reads):
                if isinstance(r, BaseException):
                    # unreadable shard: convicted as missing below;
                    # zero-fill keeps the batch rectangular (its own
                    # parity verdict is void, see report assembly)
                    missing[oid].add(i)
                    row.append(np.zeros(shard_len, np.uint8))
                else:
                    row.append(r)
            rows.append(row)
        if self.resident is not None:
            rows = [[self._to_device(a) for a in row] for row in rows]
            stored = torch.stack([torch.stack(row) for row in rows])
        else:
            stored = np.stack([
                np.stack([np.asarray(a, np.uint8) for a in row])
                for row in rows
            ])
        sd = stored[:, list(self.data_shards), :]
        stripes = permute_axes(sd.reshape(B, k, nstripes, chunk),
                               (0, 2, 1, 3)).reshape(B * nstripes, k, chunk)
        recomputed = await self._coalesced_encode(stripes)
        self.perf.inc("ec_scrub_launches")
        rec = permute_axes(recomputed.reshape(B, nstripes, n, chunk),
                           (0, 2, 1, 3)).reshape(B, n, shard_len)
        # the CRC runs through B2 and the parity compare is a torch op,
        # counted as the JAX package's one fused verify launch
        if ec_checksum.supported_len(shard_len):
            eq, crcs = ec_checksum.verify_batch(rec, stored, self.device)
        else:
            eq = ec_checksum.parity_only_batch(rec, stored, self.device)
            crcs = None
        self.perf.inc("ec_scrub_launches")
        hraws = await asyncio.gather(
            *(self._get_attr_any(oid, HINFO_ATTR) for oid in group),
            return_exceptions=True)
        for b, oid in enumerate(group):
            stale, vmissing = await self._scrub_shard_versions(
                oid, metas[oid].version)
            miss = sorted(missing[oid] | set(vmissing))
            if miss:
                # with unreadable shards the re-encode ran over
                # zero-fill — parity/crc verdicts for this object are
                # void; repair rebuilds the missing shards and the
                # next sweep verifies the result
                reports[oid] = self._scrub_report(
                    oid, metas[oid].version, [], [], stale, miss,
                    False)
                continue
            inconsistent = [
                i for i in range(n)
                if i not in self.data_shards and not bool(eq[b, i])
            ]
            raw = hraws[b]
            if isinstance(raw, BaseException) or not raw:
                raw = b""
            crc_mismatch: list[int] = []
            hinfo = None
            if raw:
                try:
                    hinfo = HashInfo.from_dict(n, json.loads(raw))
                except (ValueError, KeyError, TypeError):
                    hinfo = None
            if hinfo is not None:
                if crcs is not None \
                        and hinfo.total_chunk_size == shard_len:
                    crc_mismatch = [
                        i for i in range(n)
                        if int(crcs[b, i]) != hinfo.get_chunk_hash(i)
                    ]
                else:
                    # stream beyond the device-CRC gate, or hinfo
                    # covering a prefix only: host-oracle fallback for
                    # this object (the parity verdict stays batched)
                    for i in range(n):
                        view = self._to_host(
                            stored[b, i][: hinfo.total_chunk_size]
                        ).tobytes()
                        if crc32c(0xFFFFFFFF, view) != \
                                hinfo.get_chunk_hash(i):
                            crc_mismatch.append(i)
            reports[oid] = self._scrub_report(
                oid, metas[oid].version, inconsistent, crc_mismatch,
                stale, [], hinfo is not None)
        self.perf.inc("ec_scrub_objects", B)
        self.perf.inc("ec_scrub_batches")
        self.perf.inc("ec_scrub_bytes", B * n * shard_len)
