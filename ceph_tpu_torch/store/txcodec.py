"""Transaction wire/durable form.

The ObjectStore::Transaction encode role (reference
src/os/Transaction.{h,cc} encode/decode): one canonical serialization of
the store op vocabulary, shared by the replication sub-op payloads
(MOSDRepOp analog) and the write-ahead log of the durable store — the
bytes a replica applies and the bytes replayed after a restart are the
same format.

Port copy of ceph_tpu/store/txcodec.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from ceph_tpu_torch.store.object_store import Transaction
from ceph_tpu_torch.store.types import CollectionId, GHObject


def enc_cid(cid: CollectionId) -> list:
    return [cid.pool, cid.pg, cid.shard]


def dec_cid(v: list) -> CollectionId:
    return CollectionId(int(v[0]), int(v[1]), int(v[2]))


def enc_oid(o: GHObject) -> list:
    return [o.pool, o.name, o.snap, o.gen, o.shard]


def dec_oid(v: list) -> GHObject:
    return GHObject(int(v[0]), str(v[1]), int(v[2]), int(v[3]), int(v[4]))


def encode_tx(tx: Transaction) -> list:
    """Store transaction -> wire form (nested codec-friendly values)."""
    out = []
    for op in tx.ops:
        wire = [op[0]]
        for arg in op[1:]:
            if isinstance(arg, CollectionId):
                wire.append({"_c": enc_cid(arg)})
            elif isinstance(arg, GHObject):
                wire.append({"_o": enc_oid(arg)})
            else:
                wire.append(arg)
        out.append(wire)
    return out


def decode_tx(wire: list) -> Transaction:
    tx = Transaction()
    for wop in wire:
        args = []
        for arg in wop[1:]:
            if isinstance(arg, dict) and "_c" in arg:
                args.append(dec_cid(arg["_c"]))
            elif isinstance(arg, dict) and "_o" in arg:
                args.append(dec_oid(arg["_o"]))
            else:
                args.append(arg)
        tx.ops.append(tuple([wop[0], *args]))
    return tx
