"""HitSet: per-PG access tracking (bloom filter).

Counterpart of ceph_tpu/osd/hitset.py: the same module over the
port's imports.

The role of reference src/osd/HitSet.{h,cc} (BloomHitSet): each PG
tracks which objects were touched during the current period in a
compact bloom filter; filled sets are archived per period and trimmed
to ``hit_set_count`` — the access-recency signal cache tiering uses to
decide promotion/eviction.  Pool options ``hit_set_type`` ("bloom"),
``hit_set_period``, ``hit_set_count`` switch it on.

Double hashing over crc32c: bit_i = (h1 + i*h2) mod nbits — the
standard k-probe bloom construction; parameters derive from a target
object count and false-positive rate like the reference's
BloomHitSet::Params.
"""

from __future__ import annotations

import math

from ceph_tpu_torch.common.crc32c import crc32c


class BloomHitSet:
    def __init__(self, target_size: int = 1024, fpp: float = 0.01,
                 seed: int = 0, bits: bytearray | None = None,
                 nbits: int | None = None, k: int | None = None):
        if nbits is None:
            nbits = max(64, int(-target_size * math.log(fpp)
                                / (math.log(2) ** 2)))
            k = max(1, round(nbits / target_size * math.log(2)))
        self.nbits = nbits
        self.k = k
        self.seed = seed
        self.count = 0               # inserts (may double-count)
        self.bits = bits if bits is not None \
            else bytearray(-(-nbits // 8))

    def _probes(self, name: str):
        data = name.encode()
        h1 = crc32c(0xFFFFFFFF, data)
        h2 = crc32c(self.seed ^ 0x9E3779B9, data) | 1
        for i in range(self.k):
            yield (h1 + i * h2) % self.nbits

    def insert(self, name: str) -> None:
        for bit in self._probes(name):
            self.bits[bit >> 3] |= 1 << (bit & 7)
        self.count += 1

    def contains(self, name: str) -> bool:
        return all(self.bits[bit >> 3] & (1 << (bit & 7))
                   for bit in self._probes(name))

    # -- wire/store form ---------------------------------------------------
    def to_dict(self) -> dict:
        return {"nbits": self.nbits, "k": self.k, "seed": self.seed,
                "count": self.count, "bits": bytes(self.bits)}

    @classmethod
    def from_dict(cls, d: dict) -> "BloomHitSet":
        hs = cls(bits=bytearray(d["bits"]), nbits=int(d["nbits"]),
                 k=int(d["k"]), seed=int(d.get("seed", 0)))
        hs.count = int(d.get("count", 0))
        return hs
