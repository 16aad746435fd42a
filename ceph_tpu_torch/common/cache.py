"""Small bounded mapping used for decode-matrix / table caches.

Port copy of ceph_tpu/common/cache.py: same numpy code, kept here so the port
imports nothing of the JAX package.

Plays the role of the reference's per-codec table caches
(ErasureCodeIsaTableCache.cc LRU, ErasureCodeShecTableCache): bounded,
insertion-order FIFO eviction (cheap and adequate — hot keys are re-inserted
after eviction at the cost of one rebuild).
"""

from __future__ import annotations

from typing import Generic, Hashable, TypeVar

V = TypeVar("V")


class FIFOCache(Generic[V]):
    def __init__(self, max_entries: int = 512):
        self._max = max_entries
        self._data: dict[Hashable, V] = {}

    def get(self, key: Hashable) -> V | None:
        return self._data.get(key)

    def put(self, key: Hashable, value: V) -> None:
        if key not in self._data and len(self._data) >= self._max:
            self._data.pop(next(iter(self._data)))
        self._data[key] = value

    def clear(self) -> None:
        self._data.clear()

    def __len__(self) -> int:
        return len(self._data)
