"""A MemStore's contents as plain data, and back.

The state that defines what an EC backend computes over a pool is what
its shard stores hold: each shard object's bytes, its attrs (``hinfo``,
``version``) and its omap (the PG log).  ``dump_memstore`` reads it
through the store's public readers into plain data; ``memstore_from_dump``
builds a port ``MemStore`` holding exactly that.  A dump built the same
way from another package's store (the JAX package's MemStore has the
same readers) carries a pool written there into the port, and a port
dump carries it back.

The dump is ``{(pool, pg, shard): {(pool, name, snap, gen, shard):
(data, attrs, omap)}}``: one entry per collection (empty collections
included), one per object, with ``data`` as bytes and ``attrs`` and
``omap`` as ``{str: bytes}``.
"""

from __future__ import annotations

from ceph_tpu_torch.store.memstore import MemStore
from ceph_tpu_torch.store.object_store import Transaction
from ceph_tpu_torch.store.types import CollectionId, GHObject


def dump_memstore(store) -> dict:
    """The contents of ``store`` (any store with MemStore's readers) as
    plain data."""
    out: dict = {}
    for cid in store.list_collections():
        objs = out.setdefault((cid.pool, cid.pg, cid.shard), {})
        for oid in store.list_objects(cid):
            objs[(oid.pool, oid.name, oid.snap, oid.gen, oid.shard)] = (
                bytes(store.read(cid, oid)),
                dict(store.getattrs(cid, oid)),
                dict(store.omap_get(cid, oid)),
            )
    return out


def memstore_from_dump(dump: dict) -> MemStore:
    """A new MemStore holding the contents of ``dump``.  Usable inside or
    outside a running event loop: the store is filled in one atomic
    transaction applied directly."""
    t = Transaction()
    for ckey, objs in dump.items():
        cid = CollectionId(*ckey)
        t.create_collection(cid)
        for okey, (data, attrs, omap) in objs.items():
            oid = GHObject(*okey)
            t.touch(cid, oid)
            if data:
                t.write(cid, oid, 0, bytes(data))
            for name, value in attrs.items():
                t.setattr(cid, oid, name, bytes(value))
            if omap:
                t.omap_setkeys(cid, oid, {k: bytes(v)
                                          for k, v in omap.items()})
    store = MemStore()
    with store._lock:
        store._validate([t])
        for op in t.ops:
            store._apply(op)
    return store
