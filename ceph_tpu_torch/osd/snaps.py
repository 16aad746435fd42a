"""Self-managed snapshots: SnapSet, clone resolution, and the snap index.

Counterpart of ceph_tpu/osd/snaps.py: the same module over the
port's imports.

The snapshot model of reference src/osd/PrimaryLogPG.cc (make_writeable /
find_object_context) + src/osd/SnapMapper.{h,cc} + src/osd/osd_types.h
SnapSet, reduced to the clone-before-first-write essentials:

- The POOL allocates snap ids (pg_pool_t snap_seq; mon command). Clients
  send a SnapContext (seq + existing snap ids) with every mutation and a
  snap id with snapshot reads.
- A mutation whose SnapContext is newer than the object's SnapSet first
  CLONES the head into a snap-qualified object (GHObject.snap = clone
  id) in the same transaction — copy-on-first-write per snap epoch. The
  clone covers every snap taken since the head last changed.
- A snapshot read resolves through the SnapSet: the first clone whose id
  is >= the requested snap covers it; newer snaps than any clone are
  still on the head.
- Removing a head that has clones leaves a WHITEOUT (the head object
  stays, flagged head_exists=False, so the SnapSet and clones survive).
- Snap deletion is asynchronous: the SnapMapper index (snap id -> object
  names, kept in the PG meta collection) lets the trimmer find affected
  objects without scanning the pool; a clone covering no remaining
  snaps is deleted.

EC pools reject snap ops (parity with the reference's restrictions).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ceph_tpu_torch.store import CollectionId, GHObject

SS_ATTR = "snapset"              # head-object attr holding the SnapSet
NOSNAP = -2                      # GHObject.snap of a head (CEPH_NOSNAP)

# the snap index object lives beside the pg log in the meta collection
MAPPER_NAME = "_snapmapper"


@dataclass
class SnapSet:
    """Per-object snapshot state (reference SnapSet, osd_types.h)."""
    seq: int = 0                          # newest snap this head has seen
    clones: list[int] = field(default_factory=list)   # ascending ids
    clone_snaps: dict[int, list[int]] = field(default_factory=dict)
    head_exists: bool = True

    def to_attr(self) -> bytes:
        return json.dumps({
            "seq": self.seq, "clones": self.clones,
            "clone_snaps": {str(c): s for c, s in self.clone_snaps.items()},
            "head_exists": self.head_exists,
        }).encode()

    @classmethod
    def from_attr(cls, raw: bytes) -> "SnapSet":
        d = json.loads(raw)
        return cls(
            seq=int(d.get("seq", 0)),
            clones=[int(c) for c in d.get("clones", ())],
            clone_snaps={int(c): [int(s) for s in snaps]
                         for c, snaps in d.get("clone_snaps", {}).items()},
            head_exists=bool(d.get("head_exists", True)),
        )

    def resolve_read(self, snapid: int) -> int | None:
        """Which object serves a read at ``snapid``: NOSNAP for the head,
        a clone id, or None (the object did not exist at that snap).
        A clone covers exactly the snaps listed in clone_snaps (taken
        after the previous clone, up to the clone id)."""
        for clone in self.clones:
            if snapid <= clone:
                covered = self.clone_snaps.get(clone, [])
                return clone if snapid in covered else None
        # newer than every clone: still carried by the head — but only
        # STRICTLY newer than the head's seq: a head (re)born under
        # snapc seq=s did not exist when snap s was taken (reference
        # find_object_context snapid > seq)
        if self.head_exists and snapid > self.seq:
            return NOSNAP
        return None

    def prune_snap(self, snapid: int) -> list[int]:
        """Drop ``snapid`` from clone coverage; returns the clone ids
        left covering nothing (to be deleted by the trimmer)."""
        empty = []
        for clone in list(self.clones):
            covered = self.clone_snaps.get(clone, [])
            if snapid in covered:
                covered.remove(snapid)
                if not covered:
                    self.clones.remove(clone)
                    self.clone_snaps.pop(clone, None)
                    empty.append(clone)
        return empty


def clone_oid(pool: int, name: str, clone: int) -> GHObject:
    return GHObject(pool, name, snap=clone)


# -- SnapMapper index (reference SnapMapper.cc: snap -> objects) ----------

def mapper_oid(pool: int) -> GHObject:
    from ceph_tpu_torch.osd.pg_log import META_SHARD
    return GHObject(pool, MAPPER_NAME, shard=META_SHARD)


def mapper_cid(pool: int, ps: int) -> CollectionId:
    from ceph_tpu_torch.osd.pg_log import meta_cid
    return meta_cid(pool, ps)


def mapper_key(snapid: int, name: str) -> str:
    return f"{snapid:016d}/{name}"


def mapper_prefix(snapid: int) -> str:
    return f"{snapid:016d}/"
