"""Persistent write-back log for rbd images (the pwl/RWL role).

Counterpart of ceph_tpu/services/rbd_pwl.py: the same module over the
port's imports.

Reference src/librbd/cache/ReplicatedWriteLog.cc (+ cache/pwl/*): a
client-local persistent log in front of an image.  Writes persist to
the log and ack immediately (crash-consistent at local-storage
latency); a flusher retires entries to the cluster strictly in log
order; after a client crash, reopening the cache replays unretired
entries, so acked writes are never lost and the cluster image only
ever reflects a prefix of the acked write stream (the pwl ordering
guarantee).

Divergences from the reference, TPU-host-first: the log is a plain
crc-framed append file (no PMEM/DAX; frame format shared with nothing
else — torn tails truncate at the first bad frame like store/walstore),
and the in-memory overlay is a seq-ordered list merged at read time
(at DevCluster scale a linear merge beats the reference's AVL extent
trees).  Journaling (rbd_journal.py) and pwl are alternative write
paths — layering both would double-log, as in the reference.
"""

from __future__ import annotations

import os
import struct
import zlib

_MAGIC = 0x52574C31            # "RWL1"
_HDR = struct.Struct("<IIQQI")  # magic, len, seq, offset, crc
_CRC_HDR = struct.Struct("<IIQQ")   # the crc-covered header prefix


def _frame_crc(ln: int, seq: int, off: int, data: bytes) -> int:
    """CRC covers the header fields AND the payload: a bit-flip in the
    offset must fail validation, not replay good data at the wrong
    image location."""
    return zlib.crc32(data, zlib.crc32(
        _CRC_HDR.pack(_MAGIC, ln, seq, off)))


class PersistentWriteLog:
    """Wraps an open Image with a file-backed write-back log."""

    def __init__(self, image, path: str,
                 capacity: int = 64 << 20):
        self.image = image
        self.path = path
        self.capacity = capacity
        self._f = None
        self._seq = 0
        # pending entries in log order: (seq, offset, bytes)
        self._pending: list[tuple[int, int, bytes]] = []
        self._log_bytes = 0
        import asyncio

        self._flush_lock = asyncio.Lock()

    # -- log file ----------------------------------------------------------
    async def open(self) -> None:
        """Open (or create) the log; replay any unretired entries left
        by a crash into the overlay so acked writes stay visible."""
        replayed = self._read_log() if os.path.exists(self.path) else []
        self._f = open(self.path, "ab")
        for seq, off, data in replayed:
            self._pending.append((seq, off, data))
            self._seq = max(self._seq, seq)
        self._log_bytes = self._f.tell()

    def _read_log(self) -> list[tuple[int, int, bytes]]:
        """Parse frames; stop at the first torn/corrupt frame and
        truncate there (prefix semantics — a torn ack was never
        returned to the caller)."""
        entries = []
        with open(self.path, "rb") as f:
            raw = f.read()
        pos = 0
        good = 0
        while pos + _HDR.size <= len(raw):
            magic, ln, seq, off, crc = _HDR.unpack_from(raw, pos)
            end = pos + _HDR.size + ln
            if magic != _MAGIC or end > len(raw):
                break
            data = raw[pos + _HDR.size:end]
            if _frame_crc(ln, seq, off, data) != crc:
                break
            entries.append((seq, off, data))
            pos = good = end
        if good < len(raw):
            with open(self.path, "r+b") as f:
                f.truncate(good)
        return entries

    def _append_frame(self, seq: int, off: int, data: bytes) -> None:
        frame = _HDR.pack(_MAGIC, len(data), seq, off,
                          _frame_crc(len(data), seq, off, data)) + data
        self._f.write(frame)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._log_bytes += len(frame)

    # -- data path ---------------------------------------------------------
    async def write(self, offset: int, data: bytes) -> None:
        """Persist to the log and ack; the cluster write happens at
        flush/retire time.  Over-capacity applies backpressure by
        flushing synchronously (the reference's dirty high-water)."""
        if self._f is None:
            raise IOError("pwl not open")
        if offset + len(data) > self.image.size:
            raise IOError("write past end of image")
        data = bytes(data)
        self._seq += 1
        self._append_frame(self._seq, offset, data)
        self._pending.append((self._seq, offset, data))
        if self._log_bytes > self.capacity:
            await self.flush()

    async def read(self, offset: int, length: int) -> bytes:
        """Image data with the pending overlay merged in log order
        (newest write wins per byte)."""
        if self._f is None:
            raise IOError("pwl not open")
        base = bytearray(await self.image.read(offset, length))
        length = len(base)
        for _seq, off, data in self._pending:
            lo = max(off, offset)
            hi = min(off + len(data), offset + length)
            if lo < hi:
                base[lo - offset:hi - offset] = \
                    data[lo - off:hi - off]
        return bytes(base)

    async def flush(self) -> None:
        """Retire pending entries to the cluster IN LOG ORDER, then
        roll the log.  Only the snapshot taken at entry is retired and
        dropped — writes acked while the flush awaited stay pending
        and keep their log frames (the rewrite below), so a concurrent
        ack is never lost.  A crash mid-flush re-applies a prefix on
        replay — full-data writes make that idempotent."""
        if self._f is None:
            raise IOError("pwl not open")
        async with self._flush_lock:
            n = len(self._pending)
            for _seq, off, data in self._pending[:n]:
                await self.image.write(off, data)
            await self.image.flush()
            del self._pending[:n]
            # roll the file AFTER the cluster flush completed; frames
            # for still-pending (concurrently acked) writes are
            # rewritten synchronously — no await between truncate and
            # rewrite, so no ack can slip in between
            self._f.truncate(0)
            self._f.seek(0)
            self._log_bytes = 0
            for seq, off, data in self._pending:
                self._append_frame(seq, off, data)
            self._f.flush()
            os.fsync(self._f.fileno())

    @property
    def dirty_bytes(self) -> int:
        return sum(len(d) for _, _, d in self._pending)

    async def invalidate(self) -> None:
        """Drop pending writes WITHOUT retiring them (the
        rbd_cache-invalidate escape hatch for a discarded client)."""
        self._pending.clear()
        if self._f is not None:
            self._f.truncate(0)
            self._f.flush()
            os.fsync(self._f.fileno())
            self._log_bytes = 0

    async def close(self) -> None:
        if self._f is None:
            return
        await self.flush()
        self._f.close()
        self._f = None
