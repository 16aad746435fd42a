"""ObjectCacher: client-side write-back object cache.

Counterpart of ceph_tpu/client/object_cacher.py: the same module over the
port's imports.

The role of reference src/osdc/ObjectCacher.{h,cc} (ObjectCacher.h:52,
used by librbd and ceph-fuse): buffer object data client-side, serve
reads from cache, absorb writes as dirty state, and write back lazily —
bounded by a dirty-bytes budget (flush oldest-first when exceeded) and
an object-count budget (LRU-evict clean objects).  Granularity here is
the whole object (rbd blocks are the natural unit); the reference's
finer BufferHead extents collapse to one buffer per object.

The cache sits ABOVE the owner's object IO (librbd's cache sits above
copyup/object-map dispatch): ``fetch(key)`` must return the object's
full current content (including parent COW fallback) and
``writeback(key, data)`` must perform a full-object write with whatever
side effects (object map update) the owner needs.
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.common.lockdep import DLock
from collections import OrderedDict
from typing import Awaitable, Callable


class _CachedObject:
    __slots__ = ("data", "dirty")

    def __init__(self, data: bytearray):
        self.data = data
        self.dirty = False


class ObjectCacher:
    def __init__(
        self,
        fetch: Callable[[object], Awaitable[bytes]],
        writeback: Callable[[object, bytes], Awaitable[None]],
        max_dirty: int = 1 << 24,
        max_objects: int = 64,
    ):
        self._fetch = fetch
        self._writeback = writeback
        self.max_dirty = max_dirty
        self.max_objects = max_objects
        self._objects: "OrderedDict[object, _CachedObject]" = \
            OrderedDict()
        self._lock = DLock("object-cacher")
        # stats (perf-counter shaped)
        self.hits = 0
        self.misses = 0
        self.flushes = 0
        self.evictions = 0

    @property
    def dirty_bytes(self) -> int:
        return sum(len(o.data) for o in self._objects.values()
                   if o.dirty)

    async def _get(self, key) -> _CachedObject:
        obj = self._objects.get(key)
        if obj is not None:
            self.hits += 1
            self._objects.move_to_end(key)
            return obj
        self.misses += 1
        # callers hold self._lock across this await, so fetches are
        # fully serialized — no concurrent insert to re-check for
        data = bytearray(await self._fetch(key))
        obj = _CachedObject(data)
        self._objects[key] = obj
        await self._trim_locked()
        return obj

    async def read(self, key, offset: int, length: int) -> bytes:
        async with self._lock:
            obj = await self._get(key)
            out = bytes(obj.data[offset:offset + length])
        # short object: the tail reads as zeros (sparse semantics)
        if len(out) < length:
            out += b"\x00" * (length - len(out))
        return out

    async def write(self, key, offset: int, data: bytes) -> None:
        async with self._lock:
            obj = await self._get(key)
            end = offset + len(data)
            if len(obj.data) < end:
                obj.data.extend(b"\x00" * (end - len(obj.data)))
            obj.data[offset:end] = data
            obj.dirty = True
            self._objects.move_to_end(key)
            if self.dirty_bytes > self.max_dirty:
                await self._flush_locked(oldest_only=True)

    async def discard(self, key) -> None:
        async with self._lock:
            self._objects.pop(key, None)

    async def flush(self, key=None) -> None:
        async with self._lock:
            await self._flush_locked(only_key=key)

    async def _flush_locked(self, oldest_only: bool = False,
                            only_key=None) -> None:
        for k in list(self._objects):
            obj = self._objects[k]
            if not obj.dirty:
                continue
            if only_key is not None and k != only_key:
                continue
            await self._writeback(k, bytes(obj.data))
            obj.dirty = False
            self.flushes += 1
            if oldest_only and self.dirty_bytes <= self.max_dirty:
                return

    async def _trim_locked(self) -> None:
        """LRU-evict CLEAN objects over the count budget (dirty ones
        stay until flushed)."""
        while len(self._objects) > self.max_objects:
            victim = next(
                (k for k, o in self._objects.items() if not o.dirty),
                None,
            )
            if victim is None:
                return
            del self._objects[victim]
            self.evictions += 1

    def stats(self) -> dict:
        return {
            "objects": len(self._objects),
            "dirty_bytes": self.dirty_bytes,
            "hits": self.hits, "misses": self.misses,
            "flushes": self.flushes, "evictions": self.evictions,
        }
