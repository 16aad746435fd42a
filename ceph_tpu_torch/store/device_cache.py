"""DeviceShardCache: on-chip residency tier for EC shard streams.

Device memory is a compute/cache tier, not durability (see the package
docstring): the cache holds each object's per-shard byte streams as
1-D uint8 tensors on one device in kernel shard layout, so the EC
backend can feed the coalesced kernel launches without re-uploading host
bytes on every op.  Keys are ``(ns, oid, shard)`` — ``ns`` namespaces one
shared per-daemon cache across PG backends.

Entries are LRU-tracked with a byte budget: when usage crosses the
high watermark the owner calls :meth:`evict`, which drops clean
entries and spills dirty ones to the store through the per-entry
``spill`` callable captured at install time (write-back mode defers
shard persistence to exactly this path).  :meth:`flush` persists all
dirty entries without dropping them — the shutdown/export hook.

Counters (``ec_resident_hits/_misses/_evictions`` here; the owner
accounts ``_h2d_bytes/_d2h_bytes`` at its conversion points) mirror
into the shared :class:`PerfCounters` so the Prometheus export
picks them up with no extra wiring.

Counterpart of ceph_tpu/store/device_cache.py over torch tensors on an
explicit device (``device=None``: CUDA, raising without it).  Its mesh
placement (``sharding``, a ``parallel.mesh.NamedSharding``) counts an
entry as placed when every slot of the sharding lies on the cache's
device: a launch then splits it into views with no copy.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ceph_tpu_torch.common.perf import CounterType, PerfCounters
from ceph_tpu_torch.ec.engine import resolve_device

RESIDENT_COUNTERS = (
    "ec_resident_hits",
    "ec_resident_misses",
    "ec_resident_h2d_bytes",
    "ec_resident_d2h_bytes",
    "ec_resident_evictions",
)


def register_resident_counters(perf: PerfCounters) -> None:
    """Idempotently register the residency counter set on ``perf``."""
    for key in RESIDENT_COUNTERS:
        perf.add(key, CounterType.U64)


class _Entry:
    __slots__ = ("arr", "version", "dirty", "spill", "nbytes")

    def __init__(self, arr, version, dirty, spill):
        self.arr = arr
        self.version = int(version)
        self.dirty = bool(dirty)
        self.spill = spill
        self.nbytes = int(arr.nbytes)


class DeviceShardCache:
    """LRU byte-budgeted cache of device-resident shard streams."""

    def __init__(self, max_bytes: int = 256 << 20,
                 low_watermark: float = 0.75,
                 perf: PerfCounters | None = None,
                 sharding=None, journal=None, device=None):
        self.device = resolve_device(device)
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be positive, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self.low_bytes = int(max_bytes * low_watermark)
        self.perf = perf if perf is not None else PerfCounters("ec_resident")
        register_resident_counters(self.perf)
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self.bytes = 0
        self.evictions = 0
        self.hits = 0
        self.misses = 0
        # mesh-aware placement: when the host runs the mesh-
        # global EC coalescer, installed streams pre-place with the
        # launch's batch sharding so a resident read feeds a sharded
        # launch with neither a host round trip nor a gather-to-one-
        # device copy at launch time.
        self.sharding = sharding
        self.reshards = 0
        # flight recorder: the owning daemon's event journal (None for
        # standalone caches); evict() emits one watermark event per pass
        self.journal = journal

    def set_sharding(self, sharding) -> None:
        """Adopt (or drop, with None) the placement applied to
        subsequently installed device entries.  Existing entries keep
        their placement — they split lazily if a launch needs it."""
        self.sharding = sharding

    def _place(self, arr):
        """Check a tensor lies on this cache's device (nothing is moved
        behind the caller's back) and place it with the cache sharding
        when its leading axis tiles evenly.  A tensor on the device the
        sharding's slots all share is placed as it lies (a launch takes
        its pieces as views: counted in ``reshards``); with slots on
        other devices it installs as-is and its pieces move device to
        device at launch, never through the host.  Host arrays install
        as-is."""
        if isinstance(arr, torch.Tensor) and arr.device != self.device:
            raise ValueError(
                f"tensor on {arr.device}, cache on {self.device}")
        if self.sharding is None or not isinstance(arr, torch.Tensor):
            return arr
        slots = self.sharding.device_set
        if arr.ndim >= 1 and arr.shape[0] % max(1, len(slots)) == 0 \
                and {s.device for s in slots} == {arr.device}:
            self.reshards += 1
        return arr

    # -- lookup / install -------------------------------------------------

    def get(self, ns, oid, shard, count: bool = True) -> _Entry | None:
        """The entry for (ns, oid, shard), LRU-touched, or None.

        The caller owns version/dirty semantics; ``count=False`` skips
        the hit/miss counters for internal bookkeeping lookups.
        """
        ent = self._entries.get((ns, oid, shard))
        if ent is None:
            if count:
                self.misses += 1
                self.perf.inc("ec_resident_misses")
            return None
        self._entries.move_to_end((ns, oid, shard))
        if count:
            self.hits += 1
            self.perf.inc("ec_resident_hits")
        return ent

    def put(self, ns, oid, shard, arr, version: int,
            dirty: bool = False, spill=None) -> None:
        """Install (replacing any prior entry) the shard stream ``arr``."""
        key = (ns, oid, shard)
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes -= old.nbytes
        ent = _Entry(self._place(arr), version, dirty, spill)
        self._entries[key] = ent
        self.bytes += ent.nbytes

    def install_batch(self, ns, entries) -> int:
        """Vectored install: ``entries`` is an iterable of
        ``(oid, shard, arr, version)`` tuples, installed clean in one
        call.  The repair engine's bulk survivor pull lands here — the
        fetched shard streams become resident in the same pass that
        feeds the batched decode launch, so the decode consumes the
        already-placed device arrays with zero re-upload.  Returns the
        number of entries installed."""
        count = 0
        for oid, shard, arr, version in entries:
            self.put(ns, oid, shard, arr, version)
            count += 1
        return count

    # -- invalidation -----------------------------------------------------

    def drop(self, ns, oid, shard) -> None:
        ent = self._entries.pop((ns, oid, shard), None)
        if ent is not None:
            self.bytes -= ent.nbytes

    def drop_object(self, ns, oid) -> None:
        for key in [k for k in self._entries if k[0] == ns and k[1] == oid]:
            self.bytes -= self._entries.pop(key).nbytes

    def drop_ns(self, ns) -> None:
        """Invalidate a whole namespace (PG backend rebuilt at peering)."""
        for key in [k for k in self._entries if k[0] == ns]:
            self.bytes -= self._entries.pop(key).nbytes

    def clear(self) -> None:
        self._entries.clear()
        self.bytes = 0

    def bump_version(self, ns, oid, version: int) -> None:
        """Stamp all of an object's entries with a new version (attr-only
        writes bump the object version without touching shard data)."""
        for key, ent in self._entries.items():
            if key[0] == ns and key[1] == oid:
                ent.version = int(version)

    # -- eviction / flush -------------------------------------------------

    @property
    def over_high(self) -> bool:
        return self.bytes > self.max_bytes

    async def _spill(self, key, ent) -> None:
        host = ent.arr.cpu().numpy() if isinstance(ent.arr, torch.Tensor) \
            else np.asarray(ent.arr, np.uint8)
        self.perf.inc("ec_resident_d2h_bytes", host.nbytes)
        await ent.spill(key[1], key[2], host)

    async def evict(self, target: int | None = None) -> None:
        """Evict LRU entries until usage <= target (default: low
        watermark).  Clean entries drop; dirty entries spill first.
        A failing spill skips that entry (store degraded) rather than
        losing the only copy of the data."""
        if target is None:
            target = self.low_bytes
        skipped: set[tuple] = set()
        evicted = freed = 0
        while self.bytes > target:
            key = next((k for k in self._entries if k not in skipped), None)
            if key is None:
                break
            ent = self._entries[key]
            if ent.dirty:
                if ent.spill is None:
                    skipped.add(key)
                    continue
                try:
                    await self._spill(key, ent)
                except Exception:
                    skipped.add(key)
                    continue
            self._entries.pop(key, None)
            self.bytes -= ent.nbytes
            self.evictions += 1
            evicted += 1
            freed += ent.nbytes
            self.perf.inc("ec_resident_evictions")
        if evicted and self.journal is not None:
            self.journal.emit("cache.evict", evicted=evicted,
                              freed_bytes=freed, bytes=self.bytes,
                              target=int(target))

    async def flush(self, ns=None) -> None:
        """Spill every dirty entry (optionally one namespace) to the
        store and mark it clean; entries stay resident for reads.
        Raises the first spill failure after attempting all."""
        first_err: Exception | None = None
        for key, ent in list(self._entries.items()):
            if not ent.dirty or (ns is not None and key[0] != ns):
                continue
            if ent.spill is None:
                continue
            try:
                await self._spill(key, ent)
                ent.dirty = False
            except Exception as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    # -- introspection ----------------------------------------------------

    def stats(self, ns=None) -> dict:
        entries = nbytes = dirty = dirty_bytes = 0
        for key, ent in self._entries.items():
            if ns is not None and key[0] != ns:
                continue
            entries += 1
            nbytes += ent.nbytes
            if ent.dirty:
                dirty += 1
                dirty_bytes += ent.nbytes
        return {
            "entries": entries,
            "bytes": nbytes,
            "dirty_entries": dirty,
            "dirty_bytes": dirty_bytes,
            "max_bytes": self.max_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "sharded": self.sharding is not None,
            "reshards": self.reshards,
        }
