"""Store identity types.

GHObject mirrors ghobject_t (hobject + generation + shard id): the shard
id makes per-EC-chunk objects distinct so one OSD can hold multiple chunks
of one logical object during recovery/backfill (reference
doc/dev/osd_internals/erasure_coding/ecbackend.rst:60-76). CollectionId
mirrors coll_t: one collection per PG *shard*.

Port copy of ceph_tpu/store/types.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

NO_SHARD = -1
NO_GEN = 0xFFFFFFFFFFFFFFFF


@dataclass(frozen=True, order=True)
class GHObject:
    pool: int
    name: str
    snap: int = -2          # -2 == HEAD (CEPH_NOSNAP analog)
    gen: int = NO_GEN
    shard: int = NO_SHARD

    def with_shard(self, shard: int) -> "GHObject":
        return GHObject(self.pool, self.name, self.snap, self.gen, shard)

    def key(self) -> tuple:
        return (self.pool, self.name, self.snap, self.gen, self.shard)

    def __str__(self) -> str:
        s = f"{self.pool}:{self.name}"
        if self.snap != -2:
            s += f":snap{self.snap}"
        if self.gen != NO_GEN:
            s += f":gen{self.gen}"
        if self.shard != NO_SHARD:
            s += f":s{self.shard}"
        return s


@dataclass(frozen=True, order=True)
class CollectionId:
    pool: int
    pg: int
    shard: int = NO_SHARD

    def __str__(self) -> str:
        base = f"{self.pool}.{self.pg:x}"
        return base if self.shard == NO_SHARD else f"{base}s{self.shard}"
