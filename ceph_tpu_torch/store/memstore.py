"""MemStore: in-RAM ObjectStore (reference src/os/memstore/MemStore.h:30).

The test/development backend: every op of the Transaction vocabulary,
atomic per transaction under one lock, with optional fsync-style artificial
latency and failure injection for pipeline tests.

Port copy of ceph_tpu/store/memstore.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import asyncio
import threading
from dataclasses import dataclass, field

from ceph_tpu_torch.common import failpoint as fp
from ceph_tpu_torch.store.object_store import ObjectStore, Transaction
from ceph_tpu_torch.store.types import CollectionId, GHObject


@dataclass
class _Obj:
    data: bytearray = field(default_factory=bytearray)
    attrs: dict[str, bytes] = field(default_factory=dict)
    omap: dict[str, bytes] = field(default_factory=dict)


class MemStore(ObjectStore):
    def __init__(self, commit_delay: float = 0.0):
        self._lock = threading.Lock()
        self._colls: dict[CollectionId, dict[tuple, _Obj]] = {}
        self._objs: dict[tuple, GHObject] = {}
        self.commit_delay = commit_delay
        self.fail_next: Exception | None = None  # failure injection

    # -- commit ----------------------------------------------------------
    async def _commit(self, txns: list[Transaction]) -> None:
        if self.commit_delay:
            await asyncio.sleep(self.commit_delay)
        if self.fail_next is not None:
            exc, self.fail_next = self.fail_next, None
            raise exc
        with self._lock:
            self._validate(txns)  # all-or-nothing: reject before mutating
            for t in txns:
                for op in t.ops:
                    self._apply(op)

    def _validate(self, txns: list[Transaction]) -> None:
        """Dry-run existence simulation so a failing op cannot leave a
        transaction half-applied (the atomic contract of
        ObjectStore::Transaction)."""
        colls: dict[CollectionId, set] = {
            cid: set(objs) for cid, objs in self._colls.items()
        }

        def coll(cid):
            if cid not in colls:
                raise KeyError(f"no collection {cid}")
            return colls[cid]

        for t in txns:
            for op in t.ops:
                name = op[0]
                if name == "mkcoll":
                    colls.setdefault(op[1], set())
                elif name == "rmcoll":
                    if colls.get(op[1]):
                        raise ValueError(f"collection {op[1]} not empty")
                    colls.pop(op[1], None)
                elif name in ("touch", "write", "zero", "truncate",
                              "setattr", "omap_set"):
                    coll(op[1]).add(op[2].key())
                elif name == "remove":
                    coll(op[1]).discard(op[2].key())
                elif name in ("rmattr", "omap_rm"):
                    if op[2].key() not in coll(op[1]):
                        raise KeyError(f"no object {op[2]} in {op[1]}")
                elif name == "clone":
                    if op[2].key() not in coll(op[1]):
                        raise KeyError(f"no object {op[2]} in {op[1]}")
                    colls[op[1]].add(op[3].key())
                elif name == "rename":
                    if op[2].key() not in coll(op[1]):
                        raise KeyError(f"no object {op[2]} in {op[1]}")
                    c = colls[op[1]]
                    c.discard(op[2].key())
                    c.add(op[3].key())
                else:
                    raise ValueError(f"unknown op {name!r}")

    def _coll(self, cid: CollectionId) -> dict:
        try:
            return self._colls[cid]
        except KeyError:
            raise KeyError(f"no collection {cid}") from None

    def _get(self, cid: CollectionId, oid: GHObject, create=False) -> _Obj:
        coll = self._coll(cid)
        key = oid.key()
        obj = coll.get(key)
        if obj is None:
            if not create:
                raise KeyError(f"no object {oid} in {cid}")
            obj = coll[key] = _Obj()
            self._objs[key] = oid
        return obj

    def _apply(self, op: tuple) -> None:
        name = op[0]
        if name == "mkcoll":
            self._colls.setdefault(op[1], {})
        elif name == "rmcoll":
            if self._colls.get(op[1]):
                raise ValueError(f"collection {op[1]} not empty")
            self._colls.pop(op[1], None)
        elif name == "touch":
            self._get(op[1], op[2], create=True)
        elif name == "write":
            _, cid, oid, off, data = op
            obj = self._get(cid, oid, create=True)
            end = off + len(data)
            if len(obj.data) < end:
                obj.data.extend(b"\0" * (end - len(obj.data)))
            obj.data[off:end] = data
        elif name == "zero":
            _, cid, oid, off, length = op
            obj = self._get(cid, oid, create=True)
            end = off + length
            if len(obj.data) < end:
                obj.data.extend(b"\0" * (end - len(obj.data)))
            obj.data[off:end] = b"\0" * length
        elif name == "truncate":
            _, cid, oid, size = op
            obj = self._get(cid, oid, create=True)
            if len(obj.data) > size:
                del obj.data[size:]
            else:
                obj.data.extend(b"\0" * (size - len(obj.data)))
        elif name == "remove":
            _, cid, oid = op
            self._coll(cid).pop(oid.key(), None)
        elif name == "setattr":
            _, cid, oid, aname, value = op
            self._get(cid, oid, create=True).attrs[aname] = value
        elif name == "rmattr":
            _, cid, oid, aname = op
            self._get(cid, oid).attrs.pop(aname, None)
        elif name == "omap_set":
            _, cid, oid, kv = op
            self._get(cid, oid, create=True).omap.update(kv)
        elif name == "omap_rm":
            _, cid, oid, keys = op
            omap = self._get(cid, oid).omap
            for k in keys:
                omap.pop(k, None)
        elif name == "clone":
            _, cid, src, dst = op
            obj = self._get(cid, src)
            coll = self._coll(cid)
            coll[dst.key()] = _Obj(
                bytearray(obj.data), dict(obj.attrs), dict(obj.omap)
            )
            self._objs[dst.key()] = dst
        elif name == "rename":
            _, cid, src, dst = op
            coll = self._coll(cid)
            coll[dst.key()] = coll.pop(src.key())
            self._objs[dst.key()] = dst
        else:
            raise ValueError(f"unknown op {name!r}")

    # -- fault injection -------------------------------------------------
    def corrupt_shard(self, cid: CollectionId, oid: GHObject,
                      offset: int | None = None,
                      mask: int | None = None) -> dict | None:
        """Flip one bit of the stored object bytes AT REST — silent
        corruption below every checksum and version check, visible only
        to deep scrub.  Gated on the ``store.corrupt_shard`` failpoint:
        returns None while the point is not armed, so chaos drills can
        bound injections with ``count=`` and keep production paths
        inert.  Offset/mask default to the failpoint's seeded rng
        (deterministic under failpoint.set_seed), so the same drill
        seed rots the same bit.  Returns the flip detail for the
        drill's ledger."""
        if not fp.ACTIVE:
            return None
        try:
            fp.fire_sync("store.corrupt_shard")
        except fp.FailPointError:
            pass          # armed (error/prob mode): this call injects
        else:
            return None   # point off / delay-only: leave bytes alone
        with self._lock:
            obj = self._get(cid, oid)
            if not obj.data:
                return None
            rng = fp.fp_get("store.corrupt_shard").rng
            off = rng.randrange(len(obj.data)) if offset is None \
                else int(offset) % len(obj.data)
            bit = mask if mask is not None else (1 << rng.randrange(8))
            obj.data[off] ^= bit
        return {"oid": oid.name, "cid": str(cid), "offset": off,
                "mask": int(bit)}

    # -- reads -----------------------------------------------------------
    def read(self, cid, oid, offset=0, length=None) -> bytes:
        with self._lock:
            obj = self._get(cid, oid)
            if length is None:
                return bytes(obj.data[offset:])
            return bytes(obj.data[offset:offset + length])

    def stat(self, cid, oid) -> dict:
        with self._lock:
            obj = self._get(cid, oid)
            return {"size": len(obj.data), "attrs": len(obj.attrs)}

    def exists(self, cid, oid) -> bool:
        with self._lock:
            try:
                return oid.key() in self._coll(cid)
            except KeyError:
                return False

    def getattr(self, cid, oid, name) -> bytes:
        with self._lock:
            return self._get(cid, oid).attrs[name]

    def getattrs(self, cid, oid) -> dict[str, bytes]:
        with self._lock:
            return dict(self._get(cid, oid).attrs)

    def omap_get(self, cid, oid) -> dict[str, bytes]:
        with self._lock:
            return dict(self._get(cid, oid).omap)

    def list_objects(self, cid) -> list[GHObject]:
        with self._lock:
            return sorted(
                (self._objs[k] for k in self._coll(cid)),
                key=lambda o: o.key(),
            )

    def list_collections(self) -> list[CollectionId]:
        with self._lock:
            return sorted(self._colls)
