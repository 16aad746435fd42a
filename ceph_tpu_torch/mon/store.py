"""MonitorDBStore: transactional prefixed KV store with a write-ahead log.

Counterpart of ceph_tpu/mon/store.py: the same module over the
port's imports.

The reference persists all monitor state — paxos versions, each service's
maps — through one RocksDB-backed transactional store
(src/mon/MonitorDBStore.h:37). Same shape here: (prefix, key) -> bytes with
atomic multi-op transactions; durability via an append-only WAL file
replayed on open (the RocksDB role; a C++ store can slot in behind the same
interface later).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

from ceph_tpu_torch.msg.codec import decode, encode

_LEN = struct.Struct("<I")


class StoreTransaction:
    """Atomic batch of put/erase ops (MonitorDBStore::Transaction)."""

    def __init__(self):
        self.ops: list[tuple] = []

    def put(self, prefix: str, key: str, value: bytes | int
            ) -> "StoreTransaction":
        if isinstance(value, int):
            value = str(value).encode()
        self.ops.append(("put", prefix, key, bytes(value)))
        return self

    def erase(self, prefix: str, key: str) -> "StoreTransaction":
        self.ops.append(("erase", prefix, key))
        return self

    def erase_prefix(self, prefix: str) -> "StoreTransaction":
        self.ops.append(("erase_prefix", prefix))
        return self

    def append(self, other: "StoreTransaction") -> "StoreTransaction":
        self.ops.extend(other.ops)
        return self

    def empty(self) -> bool:
        return not self.ops

    def encode(self) -> bytes:
        return encode([list(op) for op in self.ops])

    @classmethod
    def decode(cls, raw: bytes) -> "StoreTransaction":
        tx = cls()
        tx.ops = [tuple(op) for op in decode(raw)]
        return tx


COMPACT_BYTES = 16 * 1024 * 1024      # WAL rewrite threshold


class MonitorDBStore:
    def __init__(self, path: str | None = None):
        """``path``: directory for the WAL (None = memory only)."""
        self._data: dict[str, dict[str, bytes]] = {}
        self._wal = None
        self._wal_path: str | None = None
        self._wal_bytes = 0
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._wal_path = os.path.join(path, "store.wal")
            if os.path.exists(self._wal_path):
                self._replay(self._wal_path)
                self._wal_bytes = os.path.getsize(self._wal_path)
            self._wal = open(self._wal_path, "ab")

    def _replay(self, wal_path: str) -> None:
        with open(wal_path, "rb") as f:
            while True:
                hdr = f.read(_LEN.size)
                if len(hdr) < _LEN.size:
                    break
                (n,) = _LEN.unpack(hdr)
                raw = f.read(n)
                if len(raw) < n:
                    break           # torn tail write: stop at last good tx
                self._apply(StoreTransaction.decode(raw))

    def _apply(self, tx: StoreTransaction) -> None:
        for op in tx.ops:
            if op[0] == "put":
                self._data.setdefault(op[1], {})[op[2]] = op[3]
            elif op[0] == "erase":
                self._data.get(op[1], {}).pop(op[2], None)
            elif op[0] == "erase_prefix":
                self._data.pop(op[1], None)
            else:
                raise ValueError(f"bad store op {op[0]!r}")

    def apply_transaction(self, tx: StoreTransaction) -> None:
        if tx.empty():
            return
        if self._wal is not None:
            raw = tx.encode()
            self._wal.write(_LEN.pack(len(raw)) + raw)
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._wal_bytes += _LEN.size + len(raw)
        self._apply(tx)
        if self._wal is not None and self._wal_bytes > COMPACT_BYTES:
            self._compact()

    def snapshot_tx(self) -> StoreTransaction:
        """The whole store as one transaction (compaction and the
        offline rebuild tool's install payload share this shape)."""
        snap = StoreTransaction()
        for prefix, kv in self._data.items():
            for key, value in kv.items():
                snap.put(prefix, key, value)
        return snap

    def _compact(self) -> None:
        """Rewrite the WAL as one snapshot transaction (the RocksDB
        compaction role): erased/overwritten history is dropped."""
        raw = self.snapshot_tx().encode()
        tmp = self._wal_path + ".compact"
        with open(tmp, "wb") as f:
            f.write(_LEN.pack(len(raw)) + raw)
            f.flush()
            os.fsync(f.fileno())
        self._wal.close()
        os.replace(tmp, self._wal_path)
        self._wal = open(self._wal_path, "ab")
        self._wal_bytes = os.path.getsize(self._wal_path)

    # -- offline access (monstore_tool) ----------------------------------
    @classmethod
    def open_readonly(cls, path: str) -> "MonitorDBStore":
        """Replay an existing store WAL WITHOUT opening it for append:
        the offline dump/inspect path of monstore_tool — a live monitor
        (or a second tool invocation) keeps exclusive write ownership.
        Raises FileNotFoundError when no store exists at ``path``."""
        wal = os.path.join(path, "store.wal")
        if not os.path.exists(wal):
            raise FileNotFoundError(f"no monitor store at {path}")
        st = cls(None)
        st._replay(wal)
        return st

    @staticmethod
    def install(path: str, tx: StoreTransaction) -> str:
        """Two-phase atomic store swap (the rebuild commit): phase 1
        writes the complete new store as one snapshot frame to a
        sidecar file and makes it durable; phase 2 publishes it with a
        single atomic rename.  A crash between the phases leaves the
        old store untouched; a pre-existing store is preserved as
        ``store.wal.old`` for forensics.  Returns the WAL path."""
        os.makedirs(path, exist_ok=True)
        wal = os.path.join(path, "store.wal")
        raw = tx.encode()
        tmp = wal + ".new"
        with open(tmp, "wb") as f:                 # phase 1: prepare
            f.write(_LEN.pack(len(raw)) + raw)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(wal):                    # keep the corpse
            os.replace(wal, wal + ".old")
        os.replace(tmp, wal)                       # phase 2: commit
        dfd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        return wal

    # -- reads -----------------------------------------------------------
    def get(self, prefix: str, key: str) -> bytes | None:
        return self._data.get(prefix, {}).get(key)

    def get_int(self, prefix: str, key: str, default: int = 0) -> int:
        raw = self.get(prefix, key)
        return default if raw is None else int(raw)

    def exists(self, prefix: str, key: str) -> bool:
        return key in self._data.get(prefix, {})

    def keys(self, prefix: str) -> Iterator[str]:
        return iter(sorted(self._data.get(prefix, {})))

    def prefixes(self) -> list[str]:
        return sorted(self._data)

    def iter_all(self) -> Iterator[tuple[str, str, bytes]]:
        """Every (prefix, key, value) — the store-sync provider's
        snapshot iteration (MonitorDBStore::get_iterator role)."""
        for prefix in sorted(self._data):
            for key in sorted(self._data[prefix]):
                yield prefix, key, self._data[prefix][key]

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None
