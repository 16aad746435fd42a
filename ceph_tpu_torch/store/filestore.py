"""FileStore: disk-resident ObjectStore (reference src/os/filestore).

Counterpart of ceph_tpu/store/filestore.py: the same module over the
port's imports.

The capacity tier WalStore cannot be: WalStore keeps the whole image in
RAM (MemStore + WAL/checkpoint durability), so capacity is bounded by
memory.  FileStore keeps NOTHING resident — object data lives in one
file per object, attrs/omap in an encoded sidecar, and reads go to the
filesystem — so capacity is bounded by disk, the FileStore+FileJournal
role of the reference (data on the FS, a write-ahead journal for
transaction atomicity).

Layout under ``root``::

    wal.log                        crc-framed WAL (same format/tiers as
                                   WalStore: the native C++ engine when
                                   built, pure Python otherwise)
    colls/<cid-hex>/               one directory per collection
        <oid-hex>.d                object data
        <oid-hex>.m                encoded [enc_oid, attrs, omap]

    wal.applied                    applied WAL offset (the FileJournal
                                   committed_seq role)

Commit path: frame + append the transaction batch to the WAL first,
then apply to the filesystem, then advance the ``wal.applied`` marker.
Mount replays ONLY frames past the marker — replaying the whole log
over an already-applied filesystem would re-run state-reading ops
(clone, rename) against post-state and corrupt it; the marker bounds
re-application to the single crash-window frame, whose ops are
absolute-state.  The WAL truncates at runtime once it exceeds
``wal_max`` (everything below the marker is applied), so process-crash
consistency holds without a checkpoint image — the filesystem IS the
image.  ``sync=True`` fsyncs data, sidecars and WAL appends for
power-loss durability.
"""

from __future__ import annotations

import asyncio
import os
import struct
from pathlib import Path

from ceph_tpu_torch.common import failpoint as fp
from ceph_tpu_torch.common.crc32c import crc32c
from ceph_tpu_torch.common.compressor import envelope_pack, envelope_unpack, get_compressor
from ceph_tpu_torch.common.lockdep import DLock
from ceph_tpu_torch.msg.codec import decode, encode
from ceph_tpu_torch.store.object_store import ObjectStore, Transaction
from ceph_tpu_torch.store.txcodec import (
    dec_cid,
    dec_oid,
    decode_tx,
    enc_cid,
    enc_oid,
    encode_tx,
)
from ceph_tpu_torch.store.types import CollectionId, GHObject

_FRAME = struct.Struct("<II")
_WAL_MAGIC = b"ceph-tpu-wal-1\n"


class FileStore(ObjectStore):
    def __init__(self, path: str, wal_max: int = 64 << 20,
                 sync: bool = False, native: bool | None = None,
                 compression: str | None = None):
        """``compression``: inline at-rest compression of WAL records
        (common/compressor envelope: per-record alg + raw len + raw
        crc32c).  Object data/meta files stay raw — they are random-
        access range files; the durable transaction stream is the
        tier this option covers (WalStore compresses its checkpoint
        segments too, making it the full BlueStore-analog)."""
        if compression:
            get_compressor(compression)
        self.compression = compression or None
        self.path = Path(path)
        self.wal_path = self.path / "wal.log"
        self.applied_path = self.path / "wal.applied"
        self.coll_root = self.path / "colls"
        self.wal_max = wal_max
        self.sync = sync
        if native is None:
            from ceph_tpu_torch.store import native_wal

            native = native_wal.available()
        self.native = bool(native)
        self._wal_file = None
        self._nwal = None
        self._commit_lock = DLock("filestore-commit")
        # readers vs the apply thread: a read must never observe a
        # torn, partially-applied transaction (the MemStore contract)
        import threading

        self._lock = threading.Lock()
        self._epoch = 0             # WAL turnover count (stamp prefix)
        self.commit_delay = 0.0
        self.fail_next: Exception | None = None

    # -- paths ------------------------------------------------------------
    def _coll_dir(self, cid: CollectionId) -> Path:
        return self.coll_root / encode(enc_cid(cid)).hex()

    @staticmethod
    def _okey(oid: GHObject) -> str:
        return encode(enc_oid(oid)).hex()

    def _dpath(self, cid: CollectionId, oid: GHObject) -> Path:
        return self._coll_dir(cid) / (self._okey(oid) + ".d")

    def _mpath(self, cid: CollectionId, oid: GHObject) -> Path:
        return self._coll_dir(cid) / (self._okey(oid) + ".m")

    # -- mount / umount ----------------------------------------------------
    async def mount(self) -> None:
        self.path.mkdir(parents=True, exist_ok=True)
        self.coll_root.mkdir(exist_ok=True)
        self._epoch = self._get_applied()[0]
        self._replay_wal()
        self._open_wal()
        self._reset_wal()           # replayed == applied: start clean

    async def umount(self) -> None:
        async with self._commit_lock:
            if self._wal_file is not None:
                self._wal_file.close()
                self._wal_file = None
            if self._nwal is not None:
                self._nwal.close()
                self._nwal = None

    def _open_wal(self) -> None:
        if self.native:
            from ceph_tpu_torch.store.native_wal import NativeWal

            self._nwal = NativeWal(str(self.wal_path), self.sync)
        else:
            self._wal_file = open(self.wal_path, "ab")
            if self._wal_file.tell() == 0:
                self._wal_file.write(_WAL_MAGIC)
                self._wal_file.flush()

    def _reset_wal(self) -> None:
        if self._nwal is not None:
            self._nwal.reset()
        else:
            self._wal_file.close()
            self._wal_file = open(self.wal_path, "wb")
            self._wal_file.write(_WAL_MAGIC)
            self._wal_file.flush()
            if self.sync:
                os.fsync(self._wal_file.fileno())
        self._epoch += 1
        self._set_applied(len(_WAL_MAGIC))

    def _set_applied(self, offset: int) -> None:
        """Advance the committed-position marker (FileJournal
        committed_seq): frames at or below it never replay.  The file
        holds "epoch offset"; the epoch bumps on every WAL turnover so
        frame STAMPS (epoch << 48 | offset) stay monotonic across
        resets."""
        tmp = self.applied_path.with_suffix(".applied.tmp")
        with open(tmp, "wb") as f:
            f.write(f"{self._epoch} {int(offset)}".encode())
            if self.sync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, self.applied_path)
        if self.sync:
            # a regressed marker after power loss would re-replay
            # already-applied frames (the corruption the marker
            # prevents): make the rename itself durable
            dfd = os.open(self.path, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    def _get_applied(self) -> tuple[int, int]:
        try:
            epoch_s, off_s = self.applied_path.read_bytes().split()
            return int(epoch_s), int(off_s)
        except (FileNotFoundError, ValueError):
            return 0, len(_WAL_MAGIC)

    def _stamp(self, offset: int) -> int:
        return (self._epoch << 48) | offset

    # -- commit ------------------------------------------------------------
    async def _commit(self, txns: list[Transaction]) -> None:
        if self._wal_file is None and self._nwal is None:
            raise RuntimeError("FileStore not mounted")
        if self.commit_delay:
            await asyncio.sleep(self.commit_delay)
        if self.fail_next is not None:
            exc, self.fail_next = self.fail_next, None
            raise exc
        if fp.ACTIVE:
            await fp.fire("store.wal_commit")
        payload = encode([encode_tx(t) for t in txns])
        async with self._commit_lock:
            self._validate(txns)
            size = await asyncio.to_thread(self._append, payload)
            await asyncio.to_thread(self._apply_txns, txns,
                                    self._stamp(size))
            self._set_applied(size)
            if size >= self.wal_max:
                # everything below is applied to the FS: safe turnover
                if fp.ACTIVE:
                    fp.fire_sync("store.checkpoint")
                self._reset_wal()

    def _append(self, payload: bytes) -> int:
        payload = envelope_pack(payload, self.compression)
        if self._nwal is not None:
            return self._nwal.append(payload)
        frame = _FRAME.pack(len(payload), crc32c(0xFFFFFFFF, payload))
        self._wal_file.write(frame + payload)
        self._wal_file.flush()
        if self.sync:
            os.fsync(self._wal_file.fileno())
        return self._wal_file.tell()

    def _apply_txns(self, txns, stamp: int) -> None:
        with self._lock:
            for t in txns:
                for op in t.ops:
                    self._apply(op, stamp)

    def _validate(self, txns: list[Transaction]) -> None:
        """All-or-nothing dry run against the filesystem (the MemStore
        _validate contract): reject before the WAL sees the batch.
        Existence is checked per REFERENCED key (O(ops), never a
        directory enumeration) through an overlay tracking the batch's
        own effects; a removed collection stays removed (a later op on
        it must fail, not resurrect it)."""
        # collection overlay: True = exists, False = removed
        cstate: dict[CollectionId, bool] = {}
        # (cid, okey) overlay: True = exists, False = removed
        ostate: dict[tuple, bool] = {}

        def coll_ok(cid) -> None:
            known = cstate.get(cid)
            if known is None:
                known = self._coll_dir(cid).is_dir()
                cstate[cid] = known
            if not known:
                raise KeyError(f"no collection {cid}")

        def obj_exists(cid, oid) -> bool:
            key = (cid, self._okey(oid))
            known = ostate.get(key)
            if known is None:
                known = self._mpath(cid, oid).exists()
                ostate[key] = known
            return known

        def put(cid, oid) -> None:
            coll_ok(cid)
            ostate[(cid, self._okey(oid))] = True

        for t in txns:
            for op in t.ops:
                name = op[0]
                if name == "mkcoll":
                    cstate[op[1]] = True
                elif name == "rmcoll":
                    d = self._coll_dir(op[1])
                    # empty = no sidecars beyond the batch's removals
                    if cstate.get(op[1], d.is_dir()):
                        live = any(
                            ostate.get((op[1], p.name[:-2]), True)
                            for p in d.glob("*.m")
                        ) if d.is_dir() else False
                        live = live or any(
                            v for (c, _), v in ostate.items()
                            if c == op[1] and v
                        )
                        if live:
                            raise ValueError(
                                f"collection {op[1]} not empty")
                    cstate[op[1]] = False
                elif name in ("touch", "write", "zero", "truncate",
                              "setattr", "omap_set"):
                    put(op[1], op[2])
                elif name == "remove":
                    coll_ok(op[1])
                    ostate[(op[1], self._okey(op[2]))] = False
                elif name in ("rmattr", "omap_rm", "clone", "rename"):
                    coll_ok(op[1])
                    if not obj_exists(op[1], op[2]):
                        raise KeyError(f"no object {op[2]} in {op[1]}")
                    if name in ("clone", "rename"):
                        if name == "rename":
                            ostate[(op[1], self._okey(op[2]))] = False
                        ostate[(op[1], self._okey(op[3]))] = True
                else:
                    raise ValueError(f"unknown op {name!r}")

    # -- sidecar helpers ---------------------------------------------------
    def _read_meta(self, cid, oid) -> tuple[dict, dict]:
        try:
            raw = self._mpath(cid, oid).read_bytes()
        except FileNotFoundError:
            raise KeyError(f"no object {oid} in {cid}") from None
        rec = decode(raw)
        return dict(rec[1]), dict(rec[2])

    def _read_sidecar_stamp(self, cid, oid) -> int:
        """The frame stamp that last CREATED this sidecar via a
        state-reading op (clone/rename destination); 0 otherwise."""
        try:
            raw = self._mpath(cid, oid).read_bytes()
        except FileNotFoundError:
            return 0
        rec = decode(raw)
        return int(rec[3]) if len(rec) > 3 else 0

    def _write_meta(self, cid, oid, attrs: dict, omap: dict,
                    stamp: int = 0) -> None:
        p = self._mpath(cid, oid)
        tmp = p.with_suffix(".m.tmp")
        blob = encode([enc_oid(oid), attrs, omap, int(stamp)])
        with open(tmp, "wb") as f:
            f.write(blob)
            if self.sync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, p)

    def _ensure(self, cid, oid) -> None:
        """touch semantics: object exists with empty data/meta."""
        if not self._mpath(cid, oid).exists():
            self._write_meta(cid, oid, {}, {})
        d = self._dpath(cid, oid)
        if not d.exists():
            d.touch()

    def _require_dir(self, cid) -> Path:
        d = self._coll_dir(cid)
        if not d.is_dir():
            raise KeyError(f"no collection {cid}")
        return d

    def _write_range(self, cid, oid, off: int, data: bytes) -> None:
        self._require_dir(cid)
        self._ensure(cid, oid)
        with open(self._dpath(cid, oid), "r+b") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < off:
                f.write(b"\0" * (off - size))
            f.seek(off)
            f.write(data)
            if self.sync:
                f.flush()
                os.fsync(f.fileno())

    # -- mutation application (idempotent for WAL replay) ------------------
    def _apply(self, op: tuple, stamp: int = 0) -> None:
        name = op[0]
        if name == "mkcoll":
            self._coll_dir(op[1]).mkdir(parents=True, exist_ok=True)
        elif name == "rmcoll":
            d = self._coll_dir(op[1])
            if d.is_dir():
                if any(d.iterdir()):
                    raise ValueError(f"collection {op[1]} not empty")
                d.rmdir()
        elif name == "touch":
            self._require_dir(op[1])
            self._ensure(op[1], op[2])
        elif name == "write":
            _, cid, oid, off, data = op
            self._write_range(cid, oid, off, data)
        elif name == "zero":
            _, cid, oid, off, length = op
            self._write_range(cid, oid, off, b"\0" * length)
        elif name == "truncate":
            _, cid, oid, size = op
            self._require_dir(cid)
            self._ensure(cid, oid)
            with open(self._dpath(cid, oid), "r+b") as f:
                f.truncate(size)
        elif name == "remove":
            _, cid, oid = op
            self._dpath(cid, oid).unlink(missing_ok=True)
            self._mpath(cid, oid).unlink(missing_ok=True)
        elif name == "setattr":
            _, cid, oid, aname, value = op
            self._require_dir(cid)
            self._ensure(cid, oid)
            attrs, omap = self._read_meta(cid, oid)
            attrs[aname] = value
            self._write_meta(cid, oid, attrs, omap)
        elif name == "rmattr":
            _, cid, oid, aname = op
            try:
                attrs, omap = self._read_meta(cid, oid)
            except KeyError:
                return              # replay over a later remove
            attrs.pop(aname, None)
            self._write_meta(cid, oid, attrs, omap)
        elif name == "omap_set":
            _, cid, oid, kv = op
            self._require_dir(cid)
            self._ensure(cid, oid)
            attrs, omap = self._read_meta(cid, oid)
            omap.update(kv)
            self._write_meta(cid, oid, attrs, omap)
        elif name == "omap_rm":
            _, cid, oid, keys = op
            try:
                attrs, omap = self._read_meta(cid, oid)
            except KeyError:
                return
            for k in keys:
                omap.pop(k, None)
            self._write_meta(cid, oid, attrs, omap)
        elif name == "clone":
            _, cid, src, dst = op
            if stamp and self._read_sidecar_stamp(cid, dst) >= stamp:
                # replay of a frame whose clone ALREADY landed: a
                # re-copy would read the source's post-frame state (a
                # later write in the same frame) into the clone
                return
            try:
                attrs, omap = self._read_meta(cid, src)
            except KeyError:
                return              # replay: source already gone
            import shutil

            shutil.copyfile(self._dpath(cid, src),
                            self._dpath(cid, dst))
            self._write_meta(cid, dst, attrs, omap, stamp=stamp)
        elif name == "rename":
            _, cid, src, dst = op
            if stamp and self._read_sidecar_stamp(cid, dst) >= stamp:
                return              # replay: this rename already landed
            if not self._mpath(cid, src).exists():
                return              # replay: already moved
            # crash-idempotent ordering: destination sidecar first (the
            # oid is embedded, so it is rewritten, not moved), then the
            # data file, then retire the source name — a replay resumed
            # from ANY point re-runs the remaining steps safely
            attrs, omap = self._read_meta(cid, src)
            self._write_meta(cid, dst, attrs, omap, stamp=stamp)
            if self._dpath(cid, src).exists():
                os.replace(self._dpath(cid, src), self._dpath(cid, dst))
            elif not self._dpath(cid, dst).exists():
                self._dpath(cid, dst).touch()
            self._mpath(cid, src).unlink(missing_ok=True)
        else:
            raise ValueError(f"unknown op {name!r}")

    # -- WAL replay --------------------------------------------------------
    def _replay_wal(self) -> None:
        if self.native:
            from ceph_tpu_torch.store import native_wal

            payloads = native_wal.replay(str(self.wal_path))
        else:
            payloads = self._python_replay()
        _, applied = self._get_applied()
        pos = len(_WAL_MAGIC)
        for payload in payloads:
            pos += _FRAME.size + len(payload)
            if pos <= applied:
                continue            # already on the filesystem
            try:
                txns = [decode_tx(w) for w in decode(
                    envelope_unpack(payload))]
            except (ValueError, TypeError, KeyError, struct.error):
                break               # undecodable record ends the log
            stamp = self._stamp(pos)
            for t in txns:
                for op in t.ops:
                    try:
                        self._apply(op, stamp)
                    except (KeyError, ValueError, OSError):
                        pass        # tolerated like WalStore replay

    def _python_replay(self) -> list[bytes]:
        if not self.wal_path.exists():
            return []
        raw = self.wal_path.read_bytes()
        pos = len(_WAL_MAGIC) if raw.startswith(_WAL_MAGIC) else 0
        out = []
        while pos + _FRAME.size <= len(raw):
            length, crc = _FRAME.unpack_from(raw, pos)
            start = pos + _FRAME.size
            end = start + length
            if end > len(raw):
                break
            payload = raw[start:end]
            if crc32c(0xFFFFFFFF, payload) != crc:
                break
            out.append(payload)
            pos = end
        return out

    # -- reads (straight off the filesystem) -------------------------------
    def read(self, cid, oid, offset=0, length=None) -> bytes:
        with self._lock:
            self._require_dir(cid)
            try:
                with open(self._dpath(cid, oid), "rb") as f:
                    f.seek(offset)
                    return f.read() if length is None \
                        else f.read(length)
            except FileNotFoundError:
                raise KeyError(f"no object {oid} in {cid}") from None

    def stat(self, cid, oid) -> dict:
        with self._lock:
            attrs, _ = self._read_meta(cid, oid)
            try:
                size = self._dpath(cid, oid).stat().st_size
            except FileNotFoundError:
                size = 0
            return {"size": size, "attrs": len(attrs)}

    def exists(self, cid, oid) -> bool:
        with self._lock:
            return self._mpath(cid, oid).exists()

    def getattr(self, cid, oid, name) -> bytes:
        with self._lock:
            return self._read_meta(cid, oid)[0][name]

    def getattrs(self, cid, oid) -> dict[str, bytes]:
        with self._lock:
            return self._read_meta(cid, oid)[0]

    def omap_get(self, cid, oid) -> dict[str, bytes]:
        with self._lock:
            return self._read_meta(cid, oid)[1]

    def list_objects(self, cid) -> list[GHObject]:
        with self._lock:
            out = []
            for p in self._require_dir(cid).glob("*.m"):
                out.append(dec_oid(decode(p.read_bytes())[0]))
            return sorted(out, key=lambda o: o.key())

    def list_collections(self) -> list[CollectionId]:
        if not self.coll_root.is_dir():
            return []
        out = []
        for d in self.coll_root.iterdir():
            if d.is_dir():
                try:
                    out.append(dec_cid(decode(bytes.fromhex(d.name))))
                except (ValueError, TypeError):
                    continue
        return sorted(out)
