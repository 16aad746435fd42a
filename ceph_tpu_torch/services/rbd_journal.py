"""Object-backed image journal: the src/journal Journaler role for RBD.

Counterpart of ceph_tpu/services/rbd_journal.py: the same module over the
port's imports.

The reference journals every image mutation before applying it
(librbd/Journal.cc over src/journal/Journaler.h:32): entries land in
journal data objects, registered clients (the image itself, each
rbd-mirror peer) persist their commit positions in the journal header,
and objects every client has consumed are trimmed.  This gives (a)
crash consistency — an image reopened after a crash replays entries
newer than its own commit position — and (b) journal-based mirroring —
a peer tails the SAME entry stream and applies it remotely, converging
mid-write-stream without snapshots.

Layout (-lite, same roles):
- ``journal.<image_id>``          header; omap ``client.<id>`` -> last
  committed tid (8-byte BE), ``trimmed`` -> first live object number.
- ``journal_data.<image_id>.<N>`` entry objects: consecutive tids in
  segments of ``per_obj`` entries (the reference splays the active set
  across ``splay_width`` objects for parallel appends; segmentation
  keeps the same trim granularity with strictly ordered replay, which
  is the property the correctness story rests on).

Entries are length-prefixed codec frames appended atomically (a RADOS
append is one transaction — no torn entries); tids are dense from 0, so
``tid // per_obj`` names the object and replay needs no index.
"""

from __future__ import annotations

import struct

from ceph_tpu_torch.client.rados import IoCtx, ObjectOperation, RadosError
from ceph_tpu_torch.msg.codec import decode, encode

_LEN = struct.Struct("<I")
_TID = struct.Struct(">Q")

PER_OBJ = 128            # entries per journal data object (trim unit)

# event types (librbd journal/Types.h EventEntry)
EV_WRITE = 1
EV_RESIZE = 3
EV_SNAP_CREATE = 4
EV_SNAP_REMOVE = 5
EV_SNAP_ROLLBACK = 6


class ImageJournal:
    """One image's journal handle (Journaler.h:32 role)."""

    def __init__(self, ioctx: IoCtx, image_id: str,
                 client_id: str = "master", per_obj: int = PER_OBJ):
        self.ioctx = ioctx
        self.image_id = image_id
        self.client_id = client_id
        self.per_obj = per_obj
        self.header_oid = f"journal.{image_id}"
        self._next_tid: int | None = None

    def _data_oid(self, objno: int) -> str:
        return f"journal_data.{self.image_id}.{objno}"

    # -- client registry / commit positions ---------------------------
    async def register(self) -> int:
        """Register this client (idempotent); returns its last committed
        tid (-1 when fresh)."""
        kv = await self._header()
        key = f"client.{self.client_id}"
        if key not in kv:
            await self.ioctx.operate(
                self.header_oid,
                ObjectOperation().create()
                .omap_set({key: _TID.pack(0)}),
            )
            return -1
        return _TID.unpack(kv[key])[0] - 1

    async def _header(self) -> dict[str, bytes]:
        try:
            return await self.ioctx.get_omap(self.header_oid)
        except RadosError as e:
            if e.rc == -2:
                return {}
            raise

    async def committed(self, client_id: str | None = None) -> int:
        kv = await self._header()
        raw = kv.get(f"client.{client_id or self.client_id}")
        return (_TID.unpack(raw)[0] - 1) if raw else -1

    async def commit(self, tid: int) -> None:
        """Persist this client's commit position (monotonic)."""
        cur = await self.committed()
        if tid <= cur:
            return
        await self.ioctx.operate(
            self.header_oid,
            ObjectOperation().omap_set(
                {f"client.{self.client_id}": _TID.pack(tid + 1)}
            ),
        )

    # -- append -------------------------------------------------------
    async def _discover_tail(self) -> int:
        """Next tid, counted from the last populated object.  Commit
        positions floor the scan: a trim that crashed after deleting an
        object but before persisting ``trimmed`` must not make a missing
        object look like the tail (tids must never be reused — entries
        below a client's commit position are invisible to it forever)."""
        kv = await self._header()
        floor = max(
            [_TID.unpack(v)[0]
             for k, v in kv.items() if k.startswith("client.")] or [0]
        )
        objno = max(int(kv.get("trimmed", b"0")),
                    floor // self.per_obj)
        last = None
        while True:
            try:
                raw = await self.ioctx.read(self._data_oid(objno))
            except RadosError as e:
                if e.rc == -2:
                    break
                raise
            last = (objno, raw)
            objno += 1
        if last is None:
            return max(int(kv.get("trimmed", b"0")) * self.per_obj,
                       floor)
        objno, raw = last
        return max(objno * self.per_obj + len(_split_frames(raw)), floor)

    async def append(self, event: int, args: dict) -> int:
        """Durably append one event; returns its tid.  The append IS the
        commit point of the mutation (librbd acks writes at
        journal-safe)."""
        if self._next_tid is None:
            self._next_tid = await self._discover_tail()
        tid = self._next_tid
        payload = encode([tid, event, args])
        await self.ioctx.append(
            self._data_oid(tid // self.per_obj),
            _LEN.pack(len(payload)) + payload,
        )
        self._next_tid = tid + 1
        return tid

    # -- replay / tail ------------------------------------------------
    async def trim_horizon(self) -> int:
        """First tid that can still be read (everything below was
        trimmed).  A client whose position is older than this cannot
        catch up from the journal alone (it needs a full image sync —
        the reference ImageReplayer bootstrap)."""
        kv = await self._header()
        return int(kv.get("trimmed", b"0")) * self.per_obj

    async def entries_after(self, tid: int):
        """Yield (tid, event, args) for every entry with tid > ``tid``
        in order (the Journaler replay/tail read path).  A missing
        object BELOW the committed floor is a crash-trimmed gap and is
        skipped; the first missing object at or past the floor is the
        tail."""
        kv = await self._header()
        floor = max(
            [_TID.unpack(v)[0]
             for k, v in kv.items() if k.startswith("client.")] or [0]
        )
        objno = max(int(kv.get("trimmed", b"0")),
                    (tid + 1) // self.per_obj)
        while True:
            try:
                raw = await self.ioctx.read(self._data_oid(objno))
            except RadosError as e:
                if e.rc != -2:
                    raise
                if (objno + 1) * self.per_obj <= floor:
                    objno += 1          # crash-trimmed gap: keep going
                    continue
                return
            for payload in _split_frames(raw):
                etid, event, args = decode(payload)
                if etid > tid:
                    yield int(etid), int(event), args
            objno += 1

    # -- trim ---------------------------------------------------------
    async def trim(self) -> int:
        """Delete whole objects every registered client has committed
        past (minimum commit position, Journaler trim role); returns the
        number of objects removed."""
        kv = await self._header()
        commits = [
            _TID.unpack(v)[0] - 1
            for k, v in kv.items() if k.startswith("client.")
        ]
        if not commits:
            return 0
        safe_obj = (min(commits) + 1) // self.per_obj
        objno = int(kv.get("trimmed", b"0"))
        removed = 0
        while objno < safe_obj:
            try:
                await self.ioctx.remove(self._data_oid(objno))
            except RadosError as e:
                if e.rc != -2:
                    raise
            objno += 1
            removed += 1
        if removed:
            await self.ioctx.operate(
                self.header_oid,
                ObjectOperation().omap_set(
                    {"trimmed": str(objno).encode()}
                ),
            )
        return removed

    async def destroy(self) -> None:
        kv = await self._header()
        objno = int(kv.get("trimmed", b"0"))
        while True:
            try:
                await self.ioctx.remove(self._data_oid(objno))
            except RadosError as e:
                if e.rc == -2:
                    break
                raise
            objno += 1
        try:
            await self.ioctx.remove(self.header_oid)
        except RadosError as e:
            if e.rc != -2:
                raise


def _split_frames(raw: bytes) -> list[bytes]:
    out = []
    pos = 0
    while pos + _LEN.size <= len(raw):
        (n,) = _LEN.unpack_from(raw, pos)
        pos += _LEN.size
        if pos + n > len(raw):
            break
        out.append(raw[pos:pos + n])
        pos += n
    return out


def coalesce_writes(extents: list[tuple[int, bytes]]
                    ) -> list[tuple[int, bytes]]:
    """Merge a run of write extents into their final overlay (later
    writes win) — the replay-side extent coalescing of the reference's
    journal batching: N overlapping small writes hit the image once,
    not N times.  Returns sorted, disjoint (offset, data) extents."""
    merged: list[tuple[int, bytearray]] = []
    for off, data in extents:
        end = off + len(data)
        keep: list[tuple[int, bytearray]] = []
        for moff, mdata in merged:
            mend = moff + len(mdata)
            if mend <= off or moff >= end:
                keep.append((moff, mdata))      # disjoint: untouched
                continue
            # overlap: the new write overlays; keep the old extent's
            # non-overlapped head/tail
            if moff < off:
                keep.append((moff, mdata[:off - moff]))
            if mend > end:
                keep.append((end, mdata[end - moff:]))
        keep.append((off, bytearray(data)))
        merged = keep
    merged.sort(key=lambda e: e[0])
    # join adjacent extents so replay issues the fewest image writes
    out: list[tuple[int, bytes]] = []
    for off, data in merged:
        if out and out[-1][0] + len(out[-1][1]) == off:
            out[-1] = (out[-1][0], out[-1][1] + bytes(data))
        else:
            out.append((off, bytes(data)))
    return out


async def replay_to_image(img, journal: ImageJournal,
                          from_tid: int | None = None) -> int:
    """Apply every journal entry newer than the commit position (or
    ``from_tid``) to the image (librbd Journal replay on open / the
    ImageReplayer apply loop); returns the count applied.  Entries are
    absolute-state ops, safe to re-apply.  Runs of consecutive WRITE
    events coalesce into their final overlay before touching the image
    (non-write events are barriers — a resize or snap between writes
    keeps its ordering).  The commit position only advances after the
    applied data is durable (cache flushed)."""
    pos = await journal.committed() if from_tid is None else from_tid
    applied = 0
    last = pos
    pending: list[tuple[int, bytes]] = []

    async def flush_writes() -> None:
        for off, data in coalesce_writes(pending):
            if off + len(data) > img.size:
                await img.resize(off + len(data), _journal=False)
            await img.write(off, data, _journal=False)
        pending.clear()

    async for tid, event, args in journal.entries_after(pos):
        if event == EV_WRITE:
            pending.append((int(args["off"]), bytes(args["data"])))
        else:
            await flush_writes()
            await apply_event(img, event, args)
        last = tid
        applied += 1
    await flush_writes()
    if applied:
        if getattr(img, "_cache", None) is not None:
            await img._cache.flush()
        await journal.commit(last)
    return applied


async def apply_event(img, event: int, args: dict) -> None:
    if event == EV_WRITE:
        off, data = int(args["off"]), bytes(args["data"])
        if off + len(data) > img.size:
            # the image was at least this big when the write was
            # journaled; grow to accept it — any later shrink/grow is
            # its own journal entry and restores the final geometry,
            # so replay converges for primaries and mirrors alike
            await img.resize(off + len(data), _journal=False)
        await img.write(off, data, _journal=False)
    elif event == EV_RESIZE:
        await img.resize(int(args["size"]), _journal=False)
    elif event == EV_SNAP_CREATE:
        if args["name"] not in img.snaps:
            await img.snap_create(str(args["name"]), _journal=False)
    elif event == EV_SNAP_REMOVE:
        if args["name"] in img.snaps:
            await img.snap_remove(str(args["name"]), _journal=False)
    elif event == EV_SNAP_ROLLBACK:
        if args["name"] in img.snaps:
            await img.snap_rollback(str(args["name"]), _journal=False)
    else:
        raise ValueError(f"unknown journal event {event}")
