"""ObjectStore interface + Transaction.

The transactional contract of reference src/os/ObjectStore.h /
Transaction.h: a Transaction is an ordered op list applied atomically;
queue_transactions is async with completion on durability. Op set covers
what the EC/replication backends and PG metadata need (write/zero/truncate/
remove/attrs/omap/clone/rename/collections).

Port copy of ceph_tpu/store/object_store.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Iterable

from ceph_tpu_torch.store.types import CollectionId, GHObject


@dataclass
class Transaction:
    """Ordered op list; build with the fluent helpers, apply atomically."""

    ops: list[tuple] = field(default_factory=list)

    # -- collection ops --------------------------------------------------
    def create_collection(self, cid: CollectionId) -> "Transaction":
        self.ops.append(("mkcoll", cid))
        return self

    def remove_collection(self, cid: CollectionId) -> "Transaction":
        self.ops.append(("rmcoll", cid))
        return self

    # -- object ops ------------------------------------------------------
    def touch(self, cid: CollectionId, oid: GHObject) -> "Transaction":
        self.ops.append(("touch", cid, oid))
        return self

    def write(self, cid: CollectionId, oid: GHObject, offset: int,
              data: bytes) -> "Transaction":
        self.ops.append(("write", cid, oid, offset, bytes(data)))
        return self

    def zero(self, cid: CollectionId, oid: GHObject, offset: int,
             length: int) -> "Transaction":
        self.ops.append(("zero", cid, oid, offset, length))
        return self

    def truncate(self, cid: CollectionId, oid: GHObject,
                 size: int) -> "Transaction":
        self.ops.append(("truncate", cid, oid, size))
        return self

    def remove(self, cid: CollectionId, oid: GHObject) -> "Transaction":
        self.ops.append(("remove", cid, oid))
        return self

    def setattr(self, cid: CollectionId, oid: GHObject, name: str,
                value: bytes) -> "Transaction":
        self.ops.append(("setattr", cid, oid, name, bytes(value)))
        return self

    def rmattr(self, cid: CollectionId, oid: GHObject,
               name: str) -> "Transaction":
        self.ops.append(("rmattr", cid, oid, name))
        return self

    def omap_setkeys(self, cid: CollectionId, oid: GHObject,
                     kv: dict[str, bytes]) -> "Transaction":
        self.ops.append(("omap_set", cid, oid, dict(kv)))
        return self

    def omap_rmkeys(self, cid: CollectionId, oid: GHObject,
                    keys: Iterable[str]) -> "Transaction":
        self.ops.append(("omap_rm", cid, oid, list(keys)))
        return self

    def clone(self, cid: CollectionId, src: GHObject,
              dst: GHObject) -> "Transaction":
        self.ops.append(("clone", cid, src, dst))
        return self

    def rename(self, cid: CollectionId, src: GHObject,
               dst: GHObject) -> "Transaction":
        self.ops.append(("rename", cid, src, dst))
        return self

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        return self

    def __len__(self) -> int:
        return len(self.ops)


class ObjectStore:
    """Abstract store. Reads are direct; mutations go through
    queue_transactions (async, atomic per transaction)."""

    async def mount(self) -> None: ...
    async def umount(self) -> None: ...

    async def queue_transactions(
        self, txns: list[Transaction] | Transaction
    ) -> None:
        if isinstance(txns, Transaction):
            txns = [txns]
        await self._commit(txns)

    async def _commit(self, txns: list[Transaction]) -> None:
        raise NotImplementedError

    def apply_transactions(self, txns: list[Transaction] | Transaction):
        """Synchronous convenience wrapper for tests/tools."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return asyncio.run(self.queue_transactions(txns))
        raise RuntimeError(
            "apply_transactions inside a running loop; await "
            "queue_transactions instead"
        )

    # -- reads -----------------------------------------------------------
    def read(self, cid: CollectionId, oid: GHObject, offset: int = 0,
             length: int | None = None) -> bytes:
        raise NotImplementedError

    def stat(self, cid: CollectionId, oid: GHObject) -> dict:
        raise NotImplementedError

    def exists(self, cid: CollectionId, oid: GHObject) -> bool:
        raise NotImplementedError

    def getattr(self, cid: CollectionId, oid: GHObject, name: str) -> bytes:
        raise NotImplementedError

    def getattrs(self, cid: CollectionId, oid: GHObject) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, cid: CollectionId, oid: GHObject) -> dict[str, bytes]:
        raise NotImplementedError

    def list_objects(self, cid: CollectionId) -> list[GHObject]:
        raise NotImplementedError

    def list_collections(self) -> list[CollectionId]:
        raise NotImplementedError
