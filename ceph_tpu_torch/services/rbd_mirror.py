"""rbd-mirror-lite: cross-cluster image replication, both modes.

Counterpart of ceph_tpu/services/rbd_mirror.py: the same module over the
port's imports.

The role of reference src/tools/rbd_mirror (ImageReplayer.cc):

SNAPSHOT mode (RBDMirror): the daemon periodically takes a mirror
snapshot on the primary image, ships the delta since the last mirrored
snapshot to the secondary cluster, and marks the same snapshot there —
the secondary is a crash-consistent point-in-time copy that advances
snapshot by snapshot.  Resumability falls out of the snapshot names
themselves: the newest mirror snapshot present on BOTH sides is the
sync base, so a restarted daemon needs no extra state.

JOURNAL mode (JournalReplayer): the daemon registers as a client of
the primary image's journal (services/rbd_journal.py, the
src/journal/Journaler.h:32 role) and TAILS the entry stream, applying
each event to the secondary image and persisting its commit position
in the journal header (ImageReplayer.cc replay path).  Because the
journal — not the image — is the source of truth, the secondary
converges even on entries the crashed primary appended but never
applied, and a restarted replayer resumes exactly at its commit
position.  Consumed objects are trimmed once every registered client
has passed them.

Delta computation in snapshot mode reads the image at the new and base
snapshots and ships only changed blocks (the diff-iterate role; the
-lite tradeoff is reading both versions instead of consulting an
object map).
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.services.rbd import RBD, Image, RBDError

log = Dout("rbd")

SNAP_PREFIX = ".mirror."


def _mirror_snaps(img: Image) -> list[int]:
    out = []
    for name in img.snaps:
        if name.startswith(SNAP_PREFIX):
            try:
                out.append(int(name[len(SNAP_PREFIX):]))
            except ValueError:
                continue
    return sorted(out)


class RBDMirror:
    def __init__(self, src: RBD, dst: RBD, poll_interval: float = 0.5):
        self.src = src
        self.dst = dst
        self.poll_interval = poll_interval
        self._task: asyncio.Task | None = None
        self._stopped = False
        self.bytes_shipped = 0

    # -- one image ---------------------------------------------------------
    async def mirror_image(self, name: str) -> int:
        """Advance the secondary to a fresh primary snapshot; returns
        bytes shipped (0 when nothing changed since the base)."""
        src_img = await self.src.open(name)
        # sync base = newest mirror snap present on both sides
        try:
            dst_img = await self.dst.open(name)
        except RBDError:
            await self.dst.create(name, size=src_img.size,
                                  order=src_img.order)
            dst_img = await self.dst.open(name)
        src_marks = set(_mirror_snaps(src_img))
        dst_marks = set(_mirror_snaps(dst_img))
        common = sorted(src_marks & dst_marks)
        base = common[-1] if common else None

        # new mirror point on the primary
        new_mark = (max(src_marks | dst_marks) + 1
                    if (src_marks | dst_marks) else 1)
        new_snap = f"{SNAP_PREFIX}{new_mark}"
        await src_img.snap_create(new_snap)
        new_size = int(src_img.snaps[new_snap]["size"])
        if dst_img.size != new_size:
            await dst_img.resize(new_size)

        base_snap = f"{SNAP_PREFIX}{base}" if base is not None else None
        shipped = 0
        bs = src_img.obj_size
        for off in range(0, new_size, bs):
            want = min(bs, new_size - off)
            cur = await src_img.read_at_snap(new_snap, off, want)
            if base_snap is not None and base_snap in src_img.snaps:
                prev = await src_img.read_at_snap(base_snap, off, want)
                if cur == prev:
                    continue            # unchanged block: skip
            await dst_img.write(off, cur)
            shipped += len(cur)
        # mark the same point on the secondary, then retire older marks
        # (one base is enough; the reference keeps a bounded trail)
        await dst_img.snap_create(new_snap)
        for mark in sorted(src_marks):
            if mark != new_mark:
                try:
                    await src_img.snap_remove(f"{SNAP_PREFIX}{mark}")
                except RBDError:
                    pass
        for mark in sorted(dst_marks):
            if mark != new_mark:
                try:
                    await dst_img.snap_remove(f"{SNAP_PREFIX}{mark}")
                except RBDError:
                    pass
        self.bytes_shipped += shipped
        log.dout(5, "mirrored %s to mark %d (%d bytes)", name, new_mark,
                 shipped)
        return shipped

    async def sync_once(self) -> int:
        total = 0
        for name in await self.src.list():
            try:
                total += await self.mirror_image(name)
            except (RBDError, IOError) as e:
                log.derr("mirror of %s failed: %s", name, e)
        return total

    # -- daemon form -------------------------------------------------------
    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while not self._stopped:
            try:
                await self.sync_once()
            except Exception as e:           # noqa: BLE001
                log.derr("mirror pass failed: %s", e)
            try:
                await asyncio.sleep(self.poll_interval)
            except asyncio.CancelledError:
                return

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass


class JournalReplayer:
    """Journal-mode mirroring (ImageReplayer.cc): tail the primary
    image's journal and apply its entries to the secondary image."""

    def __init__(self, src: RBD, dst: RBD, client_id: str = "mirror",
                 poll_interval: float = 0.2):
        self.src = src
        self.dst = dst
        self.client_id = client_id
        self.poll_interval = poll_interval
        self._task: asyncio.Task | None = None
        self._stopped = False
        self.entries_applied = 0
        self.images_bootstrapped = 0
        self._journals: dict[str, object] = {}   # name -> ImageJournal

    async def _src_image_meta(self, name: str) -> tuple[str, dict]:
        image_id = await self.src.image_id(name)
        return image_id, await self.src.image_header(image_id)

    async def _bootstrap(self, name: str, dst_img) -> None:
        """Full image sync (ImageReplayer bootstrap): the journal was
        trimmed past this client's position, so the entry stream alone
        cannot reconstruct the secondary.  Copy the primary's current
        blocks — SPARSELY: the object map answers which blocks exist,
        so an almost-empty image syncs in a handful of reads, not
        size/obj_size of them (the reference's object-map-aware sync)."""
        src_img = await self.src.open(name)
        if dst_img.size != src_img.size:
            await dst_img.resize(src_img.size)
        bs = src_img.obj_size
        copied = 0
        for objno in range(-(-src_img.size // bs)):
            off = objno * bs
            want = min(bs, src_img.size - off)
            if not await src_img._obj_exists(objno):
                if await dst_img._obj_exists(objno):
                    # divergent secondary block with no primary
                    # counterpart: zero it, or it survives the sync
                    await dst_img.write(off, b"\0" * want)
                continue
            await dst_img.write(off, await src_img.read(off, want))
            copied += want
        self.images_bootstrapped += 1
        log.dout(5, "journal mirror bootstrapped %s (%d of %d bytes)",
                 name, copied, src_img.size)

    async def replay_image(self, name: str) -> int:
        """Apply every journal entry newer than this replayer's commit
        position to the secondary; returns entries applied.  Reads ONLY
        the journal and the primary header — the primary image handle
        may be dead (the crash-consistency property journal mode buys
        over snapshot mode).  A journal trimmed past our position
        triggers a full-image bootstrap first."""
        from ceph_tpu_torch.services.rbd_journal import (
            ImageJournal,
            replay_to_image,
        )

        journal = self._journals.get(name)
        if journal is None:
            image_id, _ = await self._src_image_meta(name)
            journal = ImageJournal(self.src.ioctx, image_id,
                                   client_id=self.client_id)
            await journal.register()
            self._journals[name] = journal
        try:
            dst_img = await self.dst.open(name)
        except RBDError:
            _, header = await self._src_image_meta(name)
            await self.dst.create(name, size=int(header["size"]),
                                  order=int(header["order"]))
            dst_img = await self.dst.open(name)
        pos = await journal.committed()
        horizon = await journal.trim_horizon()
        from_tid = None
        if pos + 1 < horizon:
            await self._bootstrap(name, dst_img)
            # the copy subsumes every trimmed entry; surviving entries
            # re-apply idempotently on top of it
            from_tid = horizon - 1
        applied = await replay_to_image(dst_img, journal,
                                        from_tid=from_tid)
        if from_tid is not None and applied == 0:
            # bootstrap with an empty surviving stream: persist the
            # position or every pass would re-bootstrap
            await journal.commit(from_tid)
        if applied:
            await journal.trim()
        await dst_img.close()
        self.entries_applied += applied
        return applied

    async def sync_once(self) -> int:
        total = 0
        for name in await self.src.list():
            try:
                total += await self.replay_image(name)
            except (RBDError, IOError) as e:
                log.derr("journal replay of %s failed: %s", name, e)
        return total

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while not self._stopped:
            try:
                await self.sync_once()
            except Exception as e:           # noqa: BLE001
                log.derr("journal replay pass failed: %s", e)
            try:
                await asyncio.sleep(self.poll_interval)
            except asyncio.CancelledError:
                return

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
