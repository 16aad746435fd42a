"""WalStore: a durable ObjectStore (write-ahead log + checkpoint).

Counterpart of ceph_tpu/store/walstore.py, with the same on-disk format:
a store directory written by either package mounts in the other.

The durability role of reference src/os/bluestore/BlueStore.cc
(queue_transactions :12332 -> deferred WAL -> kv commit) collapsed to the
shape that fits a host-side framework around an accelerator: the live
image is the MemStore
structure in RAM (reads never touch disk), every committed transaction
batch is framed + crc'd and appended to ``wal.log`` BEFORE it mutates the
image, and the image is periodically checkpointed so the log stays short
(the kv-compaction role). Mount = load checkpoint, replay WAL, serve.
An OSD restart therefore comes back with its data — recovery only has to
fill the delta, not rebuild the world (the "log + epoch maps" checkpoint
model, SURVEY §5).

Checkpoints are INCREMENTAL and mostly out-of-line (the O(txn)-commit
property of BlueStore's kv_sync batching, BlueStore.cc:12332, vs a
stop-the-world dump): one segment file per collection under ``ckpt/``,
and only collections dirtied since the last checkpoint are rewritten.
At the trigger the commit path only rolls ``wal.log`` to ``wal.old``
and byte-copies the dirty collections (O(dirty), not O(store)); a
background task encodes the segments and publishes them with a
TWO-PHASE commit: write every new segment to ``*.seg.new`` + a
manifest (the commit record), then rename into place, drop ``wal.old``
and the manifest.  Mount rolls an existing manifest FORWARD (phase 1
was complete) or discards ``*.seg.new`` strays (phase 1 incomplete)
BEFORE loading, so a log is only ever replayed over segments that do
NOT yet contain its effects — ops that read current state (clone,
rename) are never re-applied to post-checkpoint state.  Compacting
manifests (mount migration, clean umount) additionally reset
``wal.log`` and drop the legacy whole-image checkpoint in the same
publish step.

Torn tails: a crash mid-append leaves a frame with a bad length/crc; replay
stops at the first bad frame and truncates there — exactly the committed
prefix survives, matching the transaction contract (a transaction either
fully applied and was acked, or it never happened).
"""

from __future__ import annotations

import asyncio
import os
import struct
from pathlib import Path

from ceph_tpu_torch.common import failpoint as fp
from ceph_tpu_torch.common.lockdep import DLock
from ceph_tpu_torch.common.compressor import envelope_pack, envelope_unpack, \
    get_compressor
from ceph_tpu_torch.common.crc32c import crc32c
from ceph_tpu_torch.msg.codec import decode, encode
from ceph_tpu_torch.store.memstore import MemStore, _Obj
from ceph_tpu_torch.store.txcodec import (
    dec_cid,
    dec_oid,
    decode_tx,
    enc_cid,
    enc_oid,
    encode_tx,
)

_FRAME = struct.Struct("<II")          # payload_len, payload_crc
_CKPT_MAGIC = b"ceph-tpu-ckpt-1\n"
_WAL_MAGIC = b"ceph-tpu-wal-1\n"


class WalStore(MemStore):
    def __init__(self, path: str, checkpoint_bytes: int = 16 << 20,
                 sync: bool = False, native: bool | None = None,
                 compression: str | None = None):
        """``sync``: os.fsync every append (power-loss durability); off by
        default — process-crash durability (the DevCluster/test contract)
        needs only the flush.  ``native``: use the C++ wal engine
        (wal_engine.cc) for the append/replay/checkpoint file tier; None
        = auto (native when the .so builds).  Both tiers share one
        on-disk format, so files migrate freely between them.
        ``compression``: inline at-rest compression of WAL records and
        checkpoint segments (the BlueStore compress-on-write role,
        reference os/bluestore/BlueStore.cc) — every stored extent
        carries the algorithm name plus the raw length and crc32c of
        the uncompressed bytes (common/compressor envelope), so reads
        verify per-extent integrity and files written under any
        algorithm (or none) stay readable."""
        super().__init__()
        if compression:
            get_compressor(compression)    # unknown alg fails at mount
        self.compression = compression or None
        self.path = Path(path)
        self.wal_path = self.path / "wal.log"
        self.wal_old_path = self.path / "wal.old"
        self.ckpt_path = self.path / "checkpoint.bin"   # legacy format
        self.seg_dir = self.path / "ckpt"
        self.manifest_path = self.path / "ckpt.manifest"
        self.checkpoint_bytes = checkpoint_bytes
        self.sync = sync
        if native is None:
            from ceph_tpu_torch.store import native_wal

            native = native_wal.available()
        self.native = bool(native)
        self._wal_file = None          # python tier file handle
        self._nwal = None              # native tier NativeWal handle
        self._commit_lock = DLock("store-commit")
        self._dirty: set = set()       # cids touched since last checkpoint
        self._ckpt_task: asyncio.Task | None = None

    # -- mount / umount ---------------------------------------------------
    async def mount(self) -> None:
        self.path.mkdir(parents=True, exist_ok=True)
        self.seg_dir.mkdir(exist_ok=True)
        self._recover_manifest()
        legacy = self._load_checkpoint()      # pre-segment checkpoint.bin
        self._load_segments()
        # An interrupted checkpoint that had not reached its commit
        # record leaves wal.old; the segments on disk predate the roll,
        # so replaying it (then wal.log) over them is exact.
        had_old = self.wal_old_path.exists()
        if had_old:
            self._replay_wal(self.wal_old_path)
        self._replay_wal(self.wal_path)
        self._open_wal()
        if legacy or had_old:
            # compact: fold everything into segments with a compacting
            # two-phase commit (its publish step resets the logs and
            # drops the legacy file, so no crash can replay them against
            # segments they are already folded into).  _dirty is cleared
            # only on success — a failed compaction keeps the delta
            # tracked while the logs/legacy file still hold it.
            snap = self._snapshot_dirty()
            await asyncio.to_thread(
                self._commit_segments, snap, True)
            with self._lock:
                self._dirty -= set(snap)

    def _open_wal(self) -> None:
        if self.native:
            from ceph_tpu_torch.store.native_wal import NativeWal

            self._nwal = NativeWal(str(self.wal_path), self.sync)
        else:
            self._wal_file = open(self.wal_path, "ab")
            if self._wal_file.tell() == 0:
                self._wal_file.write(_WAL_MAGIC)
                self._wal_file.flush()

    @property
    def _mounted(self) -> bool:
        return self._wal_file is not None or self._nwal is not None

    async def umount(self) -> None:
        # _commit_lock first: no commit can start a NEW checkpoint while
        # we drain the running one (the background task itself never
        # takes _commit_lock, so awaiting it under the lock is safe)
        async with self._commit_lock:
            task, self._ckpt_task = self._ckpt_task, None
            if task is not None:
                try:
                    await asyncio.shield(task)
                except OSError:
                    # failed background write: the delta is still durable
                    # in wal.old + wal.log; mount recovers and compacts
                    pass
            if self._mounted and not self.wal_old_path.exists():
                # clean shutdown: flush dirty segments (compacting
                # publish resets the WAL) so the next mount replays
                # nothing.  With a wal.old left by a failed checkpoint we
                # must NOT flush: untracked collections' delta lives only
                # in that log — leave both logs for mount to recover.
                snap = self._snapshot_dirty()
                try:
                    await asyncio.to_thread(
                        self._commit_segments, snap, True)
                except OSError:
                    # flush failed before its commit record: wal.log
                    # still holds the delta and _dirty is intact (a
                    # retried umount or the next mount recovers it)
                    pass
                else:
                    with self._lock:
                        self._dirty -= set(snap)
            if self._wal_file is not None:
                self._wal_file.close()
                self._wal_file = None
            if self._nwal is not None:
                self._nwal.close()
                self._nwal = None

    # -- commit path ------------------------------------------------------
    async def _commit(self, txns) -> None:
        if not self._mounted:
            raise RuntimeError("WalStore not mounted")
        if self.commit_delay:
            await asyncio.sleep(self.commit_delay)
        if self.fail_next is not None:
            exc, self.fail_next = self.fail_next, None
            raise exc
        if fp.ACTIVE:
            await fp.fire("store.wal_commit")
        payload = encode([encode_tx(t) for t in txns])
        async with self._commit_lock:
            # validate first: an invalid transaction must raise without
            # reaching the log (replay applies the log unconditionally)
            with self._lock:
                self._validate(txns)
            size = await asyncio.to_thread(self._append, payload)
            with self._lock:
                for t in txns:
                    for op in t.ops:
                        self._apply(op)
                        self._dirty.add(op[1])
            if size >= self.checkpoint_bytes:
                self._start_checkpoint()

    def _append(self, payload: bytes) -> int:
        """Framed append; returns WAL size after the write."""
        payload = envelope_pack(payload, self.compression)
        if self._nwal is not None:
            return self._nwal.append(payload)
        frame = _FRAME.pack(len(payload), crc32c(0xFFFFFFFF, payload))
        self._wal_file.write(frame + payload)
        self._wal_file.flush()
        if self.sync:
            os.fsync(self._wal_file.fileno())
        return self._wal_file.tell()

    # -- checkpoint (incremental, per-collection segments) ----------------
    def _seg_path(self, cid) -> Path:
        return self.seg_dir / (encode(enc_cid(cid)).hex() + ".seg")

    def _snapshot_dirty(self) -> dict:
        """Byte-copy the dirty collections under the data lock (O(dirty
        bytes) memcpy — the only part of a checkpoint the commit path
        ever waits for).  Returns {cid: entries | None}; None marks a
        collection removed since the last checkpoint."""
        snap: dict = {}
        with self._lock:
            for cid in self._dirty:
                objs = self._colls.get(cid)
                if objs is None:
                    snap[cid] = None
                    continue
                entries = []
                for key, obj in objs.items():
                    oid = self._objs[key]
                    entries.append([
                        enc_oid(oid), bytes(obj.data),
                        dict(obj.attrs), dict(obj.omap),
                    ])
                snap[cid] = entries
        return snap

    def _write_framed(self, path: Path, blob: bytes) -> None:
        """Atomic framed file write (tmp + fsync + rename), either tier."""
        blob = envelope_pack(blob, self.compression)
        if self.native:
            from ceph_tpu_torch.store import native_wal

            native_wal.write_checkpoint(str(path), blob)
            return
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as f:
            f.write(_CKPT_MAGIC)
            f.write(_FRAME.pack(len(blob), crc32c(0xFFFFFFFF, blob)))
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _commit_segments(self, snap: dict, compact: bool) -> None:
        """Two-phase segment publish (runs OUTSIDE both locks for the
        expensive phase; commits proceed against the copied snapshot).

        Phase 1: every new segment lands as ``<cid>.seg.new``, then the
        manifest (the commit record) is fsynced.  Phase 2 (_publish):
        rename the .new files over the live segments, apply deletions,
        drop wal.old (its effects are now fully in the segments) and the
        manifest.  A crash before the manifest leaves the OLD segments +
        logs (exact replay); after it, mount rolls phase 2 forward
        before any load, so a log is never replayed over segments that
        already contain its effects."""
        entries: dict[str, str] = {}
        for cid, ents in snap.items():
            hexname = encode(enc_cid(cid)).hex()
            if ents is None:
                entries[hexname] = "del"
                continue
            blob = encode([enc_cid(cid), ents])
            self._write_framed(self.seg_dir / (hexname + ".seg.new"),
                               blob)
            entries[hexname] = "new"
        self._write_framed(self.manifest_path,
                           encode([bool(compact), entries]))
        self._publish_manifest(compact, entries)

    def _publish_manifest(self, compact: bool,
                          entries: dict[str, str]) -> None:
        """Phase 2 — idempotent: safe to roll forward at mount after a
        crash anywhere inside it."""
        for hexname, action in sorted(entries.items()):
            seg = self.seg_dir / (hexname + ".seg")
            if action == "del":
                seg.unlink(missing_ok=True)
                continue
            new = self.seg_dir / (hexname + ".seg.new")
            if new.exists():            # already renamed on a re-run
                os.replace(new, seg)
        self.wal_old_path.unlink(missing_ok=True)
        if compact:
            # the segments now hold everything: reset wal.log and drop
            # the legacy whole-image checkpoint in the same publish
            if self._mounted:
                self._roll_wal(reset_only=True)
            else:
                with open(self.wal_path, "wb") as f:
                    f.write(_WAL_MAGIC)
                    f.flush()
                    os.fsync(f.fileno())
            self.ckpt_path.unlink(missing_ok=True)
        self.manifest_path.unlink(missing_ok=True)

    def _recover_manifest(self) -> None:
        """Mount-time crash recovery for the two-phase publish: a valid
        manifest means phase 1 completed — roll phase 2 forward; no (or
        torn) manifest means phase 1 was cut short — discard strays so
        the old segments + logs replay exactly."""
        blob = self._read_ckpt_file(self.manifest_path)
        if blob is not None:
            compact, entries = decode(blob)
            self._publish_manifest(bool(compact), dict(entries))
        else:
            self.manifest_path.unlink(missing_ok=True)
        for stray in self.seg_dir.glob("*.seg.new"):
            stray.unlink(missing_ok=True)
        for stray in self.seg_dir.glob("*.tmp"):
            stray.unlink(missing_ok=True)

    def _roll_wal(self, reset_only: bool = False) -> None:
        """O(1) log turnover under _commit_lock: close, rename wal.log to
        wal.old (or just truncate when reset_only), reopen fresh."""
        if self._nwal is not None:
            if reset_only:
                self._nwal.reset()
                return
            self._nwal.close()
            self._nwal = None
            os.replace(self.wal_path, self.wal_old_path)
            from ceph_tpu_torch.store.native_wal import NativeWal

            self._nwal = NativeWal(str(self.wal_path), self.sync)
            return
        if self._wal_file is not None:
            self._wal_file.close()
        if not reset_only:
            os.replace(self.wal_path, self.wal_old_path)
        self._wal_file = open(self.wal_path, "wb")
        self._wal_file.write(_WAL_MAGIC)
        self._wal_file.flush()
        if self.sync:
            os.fsync(self._wal_file.fileno())

    def _start_checkpoint(self) -> None:
        """Checkpoint trigger (commit path, _commit_lock held): roll the
        WAL, snapshot dirty collections, and hand serialization + IO to a
        background task.  The commit path never blocks on encode/write/
        fsync of the image (BlueStore's O(txn) commit property,
        BlueStore.cc:12332)."""
        if self._ckpt_task is not None and not self._ckpt_task.done():
            return                  # one in flight at a time
        if self.wal_old_path.exists():
            # previous background write failed: keep appending (the
            # wal.old + wal.log chain stays durable); mount compacts
            return
        self._roll_wal()
        snap = self._snapshot_dirty()
        with self._lock:
            self._dirty.clear()

        async def _bg():
            if fp.ACTIVE:
                # failing here leaves wal.old + wal in place: mount-time
                # compaction recovers, exactly like a torn background write
                await fp.fire("store.checkpoint")
            await asyncio.to_thread(self._commit_segments, snap, False)

        self._ckpt_task = asyncio.get_running_loop().create_task(_bg())

    def _load_segments(self) -> None:
        if not self.seg_dir.is_dir():
            return
        for seg in sorted(self.seg_dir.glob("*.seg")):
            blob = self._read_ckpt_file(seg)
            if blob is None:
                continue            # torn segment: old state + WAL win
            enc_c, entries = decode(blob)
            cid = dec_cid(enc_c)
            with self._lock:
                coll = self._colls.setdefault(cid, {})
                coll.clear()
                for enc_o, data, attrs, omap in entries:
                    oid = dec_oid(enc_o)
                    coll[oid.key()] = _Obj(
                        bytearray(data), dict(attrs), dict(omap)
                    )
                    self._objs[oid.key()] = oid

    def _load_checkpoint(self) -> bool:
        """Legacy whole-image checkpoint.bin (pre-segment format): load
        and mark everything dirty so mount converts it to segments."""
        blob = self._read_checkpoint_blob()
        if blob is None:
            return False
        with self._lock:
            self._colls.clear()
            self._objs.clear()
            for enc_c, entries in decode(blob):
                cid = dec_cid(enc_c)
                coll = self._colls.setdefault(cid, {})
                for enc_o, data, attrs, omap in entries:
                    oid = dec_oid(enc_o)
                    coll[oid.key()] = _Obj(
                        bytearray(data), dict(attrs), dict(omap)
                    )
                    self._objs[oid.key()] = oid
            self._dirty.update(self._colls)
        return True

    def _read_checkpoint_blob(self) -> bytes | None:
        return self._read_ckpt_file(self.ckpt_path)

    def _read_ckpt_file(self, path: Path) -> bytes | None:
        if self.native:
            from ceph_tpu_torch.store import native_wal

            blob = native_wal.read_checkpoint(str(path))
            if blob is None:
                return None
            try:
                return envelope_unpack(blob)
            except ValueError:
                return None
        if not path.exists():
            return None
        raw = path.read_bytes()
        if not raw.startswith(_CKPT_MAGIC):
            return None
        body = raw[len(_CKPT_MAGIC):]
        if len(body) < _FRAME.size:
            return None
        length, crc = _FRAME.unpack_from(body)
        blob = body[_FRAME.size:_FRAME.size + length]
        if len(blob) != length or crc32c(0xFFFFFFFF, blob) != crc:
            return None                 # torn checkpoint: fall back to WAL
        try:
            return envelope_unpack(blob)
        except ValueError:
            return None        # failed extent integrity: treat as torn

    # -- replay -----------------------------------------------------------
    def _apply_payload(self, payload: bytes) -> bool:
        """Decode + apply one WAL record; False stops the replay."""
        try:
            txns = [decode_tx(w) for w in decode(
                envelope_unpack(payload))]
        except (ValueError, TypeError, KeyError, IndexError,
                struct.error):
            return False
        with self._lock:
            for t in txns:
                for op in t.ops:
                    try:
                        self._apply(op)
                    except (KeyError, ValueError):
                        # an op the image rejects on replay (e.g. the
                        # pre-crash validate allowed it against state
                        # we no longer reconstruct identically) must
                        # not abort recovery of later transactions
                        pass
                    self._dirty.add(op[1])
        return True

    def _replay_wal(self, wal_path: Path) -> None:
        if self.native:
            from ceph_tpu_torch.store import native_wal

            # The engine validates frames and truncates any crc-torn
            # tail.  A crc-valid but UNDECODABLE record must also end
            # the log (the Python tier's truncate-at-good invariant):
            # leaving it would poison every replay after future appends,
            # silently losing all post-poison transactions on crash.
            payloads = native_wal.replay(str(wal_path))
            good = len(_WAL_MAGIC)
            for payload in payloads:
                if not self._apply_payload(payload):
                    try:
                        with open(wal_path, "r+b") as f:
                            f.truncate(good)
                    except OSError:
                        pass
                    break
                good += _FRAME.size + len(payload)
            return
        if not wal_path.exists():
            return
        raw = wal_path.read_bytes()
        pos = len(_WAL_MAGIC) if raw.startswith(_WAL_MAGIC) else 0
        good = pos
        while pos + _FRAME.size <= len(raw):
            length, crc = _FRAME.unpack_from(raw, pos)
            start = pos + _FRAME.size
            end = start + length
            if end > len(raw):
                break                   # torn tail
            payload = raw[start:end]
            if crc32c(0xFFFFFFFF, payload) != crc:
                break
            if not self._apply_payload(payload):
                break
            good = end
            pos = end
        if good < len(raw):
            with open(wal_path, "r+b") as f:
                f.truncate(good)
