"""RBD-lite: block images over RADOS objects.

Counterpart of ceph_tpu/services/rbd.py: the same module over the
port's imports.

The reference's librbd v2 on-disk model (src/librbd; ImageCtx.h:70):
``rbd_id.<name>`` maps name -> image id, ``rbd_header.<id>`` carries the
image metadata (managed here by the ``rbd`` object class, the cls_rbd
role), ``rbd_directory`` lists images, and data lives in
``rbd_data.<id>.<objectno:%016x>`` objects of ``2^order`` bytes. IO maps
block extents onto data objects (the io/ImageRequest -> ObjectRequest
pipeline collapsed to direct extent math).

Round-2 feature depth:
- snapshot-based COW clones (librbd clone/flatten, cls_rbd parent
  links): a child reads through to its protected parent snap for
  unwritten extents (clipped to the overlap) and copies the parent
  block up on first write (the io/CopyupRequest role); ``rbd_children``
  tracks clones so unprotect refuses while children exist.
- object map (src/librbd/ObjectMap.h): a per-image existence bitmap in
  ``rbd_object_map.<id>``; reads skip the OSD round-trip for known-
  absent objects, rebuildable by scanning.
- optional write-back cache (client/object_cacher.py, the osdc
  ObjectCacher role) layered ABOVE copyup/object-map dispatch.
"""

from __future__ import annotations

import asyncio
import json
import secrets
import time

from ceph_tpu_torch.client.rados import IoCtx, ObjectOperation, RadosError
from ceph_tpu_torch.services.rbd_journal import (
    EV_RESIZE,
    EV_SNAP_CREATE,
    EV_SNAP_REMOVE,
    EV_SNAP_ROLLBACK,
    EV_WRITE,
    ImageJournal,
    replay_to_image,
)

DIRECTORY_OID = "rbd_directory"
CHILDREN_OID = "rbd_children"
TRASH_OID = "rbd_trash"
NAMESPACES_OID = "rbd_namespaces"   # default-ns omap: name -> meta
DEFAULT_ORDER = 22          # 4 MiB objects


class RBDError(IOError):
    pass


class RBD:
    """Image management (librbd rbd_create/rbd_remove/rbd_list).

    Namespaces (reference src/librbd/api/Namespace.cc): a handle whose
    IoCtx carries a rados namespace (``ioctx.set_namespace``) scopes
    every image object — directory, headers, data — to it, so listings
    and lookups are isolated per namespace and namespace-scoped OSD
    caps (``allow rw pool=p namespace=ns``) fence clients off at the
    OSD.  The namespace registry itself lives in the pool's DEFAULT
    namespace (the rbd_namespace object role)."""

    def __init__(self, ioctx: IoCtx):
        self.ioctx = ioctx

    def _default_io(self) -> IoCtx:
        """A default-namespace view of the same pool (the namespace
        registry must be visible from every namespace handle)."""
        if not self.ioctx.namespace:
            return self.ioctx
        return IoCtx(self.ioctx.rados, self.ioctx.pool_id,
                     self.ioctx.pool_name)

    # -- namespaces (librbd/api/Namespace.cc) ------------------------------
    async def namespace_create(self, name: str) -> None:
        if not name or "/" in name or "\x1d" in name:
            raise RBDError(f"bad namespace name {name!r}")
        io = self._default_io()
        existing = await self.namespace_list()
        if name in existing:
            raise RBDError(f"namespace {name!r} exists")
        await io.operate(NAMESPACES_OID, ObjectOperation()
                         .create()
                         .omap_set({name: json.dumps(
                             {"created_at": time.time()}).encode()}))

    async def namespace_list(self) -> list[str]:
        io = self._default_io()
        try:
            return sorted(await io.get_omap(NAMESPACES_OID))
        except RadosError as e:
            if e.rc == -2:
                return []
            raise

    async def namespace_exists(self, name: str) -> bool:
        return name in await self.namespace_list()

    async def namespace_remove(self, name: str) -> None:
        """Refuse while the namespace still holds images (reference
        Namespace::remove returns -EBUSY)."""
        io = self._default_io()
        if name not in await self.namespace_list():
            raise RBDError(f"no namespace {name!r}")
        ns_io = IoCtx(self.ioctx.rados, self.ioctx.pool_id,
                      self.ioctx.pool_name)
        ns_io.set_namespace(name)
        if await RBD(ns_io).list():
            raise RBDError(f"namespace {name!r} still has images")
        await io.rm_omap_keys(NAMESPACES_OID, [name])

    async def _check_namespace(self) -> None:
        if self.ioctx.namespace and not await self.namespace_exists(
                self.ioctx.namespace):
            raise RBDError(
                f"namespace {self.ioctx.namespace!r} does not exist"
            )

    async def create(self, name: str, size: int,
                     order: int = DEFAULT_ORDER,
                     object_map: bool = True) -> str:
        if not 12 <= order <= 26:
            raise RBDError(f"order {order} out of range")
        await self._check_namespace()
        image_id = secrets.token_hex(8)
        id_oid = f"rbd_id.{name}"
        try:
            await self.ioctx.get_xattr(id_oid, "id")
            raise RBDError(f"image {name!r} exists")
        except RadosError as e:
            if e.rc != -2:
                raise
        await self.ioctx.operate(id_oid, ObjectOperation()
                                 .create().set_xattr("id",
                                                     image_id.encode()))
        await self.ioctx.exec(
            f"rbd_header.{image_id}", "rbd", "create",
            json.dumps({
                "size": size, "order": order,
                "object_prefix": f"rbd_data.{image_id}",
            }).encode(),
        )
        if object_map:
            nbits = -(-size // (1 << order))
            await self.ioctx.operate(
                f"rbd_object_map.{image_id}",
                ObjectOperation().write_full(bytes(-(-nbits // 8))),
            )
        await self.ioctx.operate(DIRECTORY_OID, ObjectOperation()
                                 .create()
                                 .omap_set({name: image_id.encode()}))
        return image_id

    async def clone(self, parent_name: str, snap_name: str,
                    child_name: str, object_map: bool = True,
                    dest: "RBD | None" = None) -> None:
        """Snapshot-based COW clone (librbd rbd_clone): the child starts
        as a read-through view of parent@snap and diverges on write.
        ``dest`` places the child in another pool (cross-pool clone);
        the parent link records the parent's pool so reads route there.
        """
        dest = dest or self
        parent = await self.open(parent_name)
        info = parent.snaps.get(snap_name)
        if info is None:
            raise RBDError(f"no snap {snap_name!r}")
        if not info.get("protected"):
            raise RBDError(
                f"snap {snap_name!r} must be protected before cloning"
            )
        child_id = await dest.create(
            child_name, int(info["size"]), parent.order,
            object_map=object_map,
        )
        await dest.ioctx.exec(
            f"rbd_header.{child_id}", "rbd", "set_parent",
            json.dumps({
                "pool": self.ioctx.pool_name,
                "image_id": parent.image_id,
                "snap_id": int(info["id"]),
                "snap_name": snap_name,
                "overlap": int(info["size"]),
            }).encode(),
        )
        # the registry lives in the PARENT's pool: unprotect checks it
        label = (child_name if dest is self or
                 dest.ioctx.pool_name == self.ioctx.pool_name
                 else f"{dest.ioctx.pool_name}/{child_name}")
        await self.ioctx.operate(CHILDREN_OID, ObjectOperation()
                                 .create().omap_set({
                                     _child_key(parent.image_id,
                                                int(info["id"]),
                                                child_id):
                                     label.encode(),
                                 }))

    async def children(self, parent_name: str,
                       snap_name: str) -> list[str]:
        """Clone names hanging off parent@snap (rbd children)."""
        parent = await self.open(parent_name)
        info = parent.snaps.get(snap_name)
        if info is None:
            raise RBDError(f"no snap {snap_name!r}")
        return await _children_of(self.ioctx, parent.image_id,
                                  int(info["id"]))

    async def list(self) -> list[str]:
        try:
            return sorted(await self.ioctx.get_omap(DIRECTORY_OID))
        except RadosError as e:
            if e.rc == -2:
                return []
            raise

    async def remove(self, name: str) -> None:
        img = await self.open(name)
        try:
            await self.ioctx.get_xattr(f"rbd_header.{img.image_id}",
                                       "group")
            raise RBDError(
                f"image {name!r} belongs to a group; remove it from "
                "the group first"
            )
        except RadosError as e:
            if e.rc != -2:
                raise
        if img.snaps:
            raise RBDError(
                f"image {name!r} has snapshots; remove them first"
            )
        data_objs = [
            o for o in await self.ioctx.list_objects()
            if o.startswith(img.object_prefix + ".")
        ]
        for oid in data_objs:
            await self.ioctx.remove(oid)
        if img.parent is not None:
            # unlink from the registry in the PARENT's pool
            ppool = img.parent.get("pool", self.ioctx.pool_name)
            pio = (self.ioctx if ppool == self.ioctx.pool_name
                   else await self.ioctx.rados.open_ioctx(ppool))
            try:
                await pio.rm_omap_keys(CHILDREN_OID, [
                    _child_key(img.parent["image_id"],
                               int(img.parent["snap_id"]),
                               img.image_id),
                ])
            except RadosError as e:
                if e.rc != -2:
                    raise
        try:
            await self.ioctx.remove(f"rbd_object_map.{img.image_id}")
        except RadosError as e:
            if e.rc != -2:
                raise
        await self.ioctx.remove(f"rbd_header.{img.image_id}")
        await self.ioctx.remove(f"rbd_id.{name}")
        await self.ioctx.rm_omap_keys(DIRECTORY_OID, [name])

    # -- trash (librbd trash_move/restore/remove, cls_rbd trash) -----------
    async def trash_move(self, name: str, delay: float = 0.0) -> str:
        """Move an image to the trash (rbd trash mv): the name is
        freed immediately, the data survives until trash_remove —
        refused before ``delay`` seconds pass (--expires-at role).
        Images with clone children cannot leave the namespace."""
        img = await self.open(name)
        for snap_name, info in img.snaps.items():
            if info.get("protected") and await _children_of(
                    self.ioctx, img.image_id, int(info["id"])):
                raise RBDError(
                    f"image {name!r} has cloned children under "
                    f"snap {snap_name!r}")
        await self.ioctx.operate(TRASH_OID, ObjectOperation()
                                 .create().omap_set({
                                     img.image_id: json.dumps({
                                         "name": name,
                                         "deleted_at": time.time(),
                                         "deferment_end":
                                         time.time() + delay,
                                     }).encode()}))
        await self.ioctx.remove(f"rbd_id.{name}")
        await self.ioctx.rm_omap_keys(DIRECTORY_OID, [name])
        return img.image_id

    async def trash_list(self) -> list[dict]:
        try:
            omap = await self.ioctx.get_omap(TRASH_OID)
        except RadosError as e:
            if e.rc == -2:
                return []
            raise
        return sorted(({"id": k, **json.loads(v)}
                       for k, v in omap.items()),
                      key=lambda e: e["deleted_at"])

    async def _trash_entry(self, image_id: str) -> dict:
        try:
            kv = await self.ioctx.get_omap(TRASH_OID, [image_id])
        except RadosError as e:
            if e.rc == -2:
                kv = {}
            else:
                raise
        if image_id not in kv:
            raise RBDError(f"no trashed image {image_id!r}")
        return json.loads(kv[image_id])

    async def trash_restore(self, image_id: str,
                            new_name: str | None = None) -> str:
        """Bring a trashed image back (rbd trash restore), under its
        old name or a new one."""
        ent = await self._trash_entry(image_id)
        name = new_name or str(ent["name"])
        try:
            await self.ioctx.get_xattr(f"rbd_id.{name}", "id")
            raise RBDError(f"image {name!r} exists")
        except RadosError as e:
            if e.rc != -2:
                raise
        await self.ioctx.operate(
            f"rbd_id.{name}", ObjectOperation().create()
            .set_xattr("id", image_id.encode()))
        await self.ioctx.operate(DIRECTORY_OID, ObjectOperation()
                                 .create()
                                 .omap_set({name:
                                            image_id.encode()}))
        await self.ioctx.rm_omap_keys(TRASH_OID, [image_id])
        return name

    async def trash_remove(self, image_id: str,
                           force: bool = False) -> None:
        """Purge a trashed image's data for good; refused while the
        deferment window holds (unless forced).  The purge works on
        the image id directly — the image NEVER reappears in the live
        namespace, and a failure partway leaves it listed in the
        trash (header ops are name-independent, and the trash entry
        is removed last)."""
        ent = await self._trash_entry(image_id)
        if not force and time.time() < float(ent["deferment_end"]):
            raise RBDError(
                f"deferment expires in "
                f"{float(ent['deferment_end']) - time.time():.0f}s "
                f"(use force)")
        img = Image(self.ioctx, f"<trash:{image_id}>", image_id)
        await img.refresh()
        for snap_name in list(img.snaps):
            if img.snaps[snap_name].get("protected"):
                await img.snap_unprotect(snap_name)
            await img.snap_remove(snap_name)
        for oid in [o for o in await self.ioctx.list_objects()
                    if o.startswith(img.object_prefix + ".")]:
            await self.ioctx.remove(oid)
        if img.parent is not None:
            ppool = img.parent.get("pool", self.ioctx.pool_name)
            pio = (self.ioctx if ppool == self.ioctx.pool_name
                   else await self.ioctx.rados.open_ioctx(ppool))
            try:
                await pio.rm_omap_keys(CHILDREN_OID, [
                    _child_key(img.parent["image_id"],
                               int(img.parent["snap_id"]),
                               image_id),
                ])
            except RadosError as e:
                if e.rc != -2:
                    raise
        try:
            await self.ioctx.remove(f"rbd_object_map.{image_id}")
        except RadosError as e:
            if e.rc != -2:
                raise
        await self.ioctx.remove(img.header_oid)
        await self.ioctx.rm_omap_keys(TRASH_OID, [image_id])

    async def deep_copy(self, src_name: str, dst_name: str,
                        dest: "RBD | None" = None) -> None:
        """Full image copy INCLUDING the snapshot history (librbd
        deep-copy, src/librbd/deep_copy/): each source snapshot is
        replayed onto the destination in id order — copy the data as
        of the snap, snapshot the destination — then the head follows.
        The result is standalone (parent links are flattened away) and
        sparse regions stay sparse (all-zero object-size chunks are
        skipped)."""
        dest = dest or self
        src = await self.open(src_name)
        try:
            await dest.create(dst_name, src.size, src.order,
                              object_map=src._om is not None)
            dst = await dest.open(dst_name)
            zero = bytes(src.obj_size)
            import hashlib

            # objectno -> digest of the dst content as of the LAST
            # copied state: unchanged objects are skipped, so each
            # state writes only its delta (reference deep_copy's
            # snap-delta behavior) instead of re-COWing everything
            state: dict[int, bytes] = {}

            async def copy_state(size: int, reader) -> None:
                if dst.size != size:
                    await dst.resize(size)
                    nobj = -(-size // src.obj_size)
                    for k in [k for k in state if k >= nobj]:
                        del state[k]
                for objectno in range(-(-size // src.obj_size)):
                    off = objectno * src.obj_size
                    chunk = await reader(off,
                                         min(src.obj_size,
                                             size - off))
                    if not chunk or chunk == zero[:len(chunk)]:
                        if objectno in state:
                            # zeroed since an earlier state: the dst
                            # must not carry the stale bytes forward
                            # (COW keeps them in the prior snap)
                            await dst.write(off, zero[:len(chunk)])
                            del state[objectno]
                        continue
                    digest = hashlib.md5(chunk).digest()
                    if state.get(objectno) == digest:
                        continue            # unchanged since last state
                    await dst.write(off, chunk)
                    state[objectno] = digest

            for snap_name, info in sorted(
                    src.snaps.items(), key=lambda kv: int(kv[1]["id"])):
                await copy_state(
                    int(info["size"]),
                    lambda off, ln, s=snap_name:
                        src.read_at_snap(s, off, ln))
                await dst.snap_create(snap_name)
                if info.get("protected"):
                    await dst.snap_protect(snap_name)
            await copy_state(src.size, src.read)
            await dst.close()
        finally:
            await src.close()

    async def migrate(self, src_name: str, dst_name: str,
                      dest: "RBD | None" = None) -> None:
        """Move an image (rbd migration prepare/execute/commit run
        back to back, without the live-IO window): deep-copy, verify
        the destination opens, then remove the source — snapshots must
        be unprotected first, as for any remove."""
        dest = dest or self
        src = await self.open(src_name)
        protected = [n for n, i in src.snaps.items()
                     if i.get("protected")]
        await src.close()
        if protected:
            raise RBDError(
                f"unprotect snaps {protected} before migrating "
                f"(clones would lose their parent)")
        await self.deep_copy(src_name, dst_name, dest=dest)
        await (await dest.open(dst_name)).close()   # sanity
        img = await self.open(src_name)
        for snap_name in list(img.snaps):
            await img.snap_remove(snap_name)
        await img.close()
        await self.remove(src_name)

    async def image_id(self, name: str) -> str:
        """name -> image id (the rbd_id.<name> lookup); RBDError when
        absent.  Needs no open Image handle (journal-mode mirroring
        reads a dead primary's journal by id alone)."""
        try:
            return (await self.ioctx.get_xattr(
                f"rbd_id.{name}", "id"
            )).decode()
        except RadosError as e:
            if e.rc == -2:
                raise RBDError(f"no image {name!r}") from e
            raise

    async def image_header(self, image_id: str) -> dict:
        """Decoded rbd_header metadata for an image id."""
        return json.loads(await self.ioctx.exec(
            f"rbd_header.{image_id}", "rbd", "get_header"
        ))

    async def open(self, name: str, cache: bool = False,
                   journaled: bool = False,
                   exclusive: bool = False,
                   lock_duration: float = 30.0) -> "Image":
        """``journaled``: mutations append to the image journal before
        applying (librbd feature JOURNALING), and opening replays any
        entries a crashed writer appended but never applied.
        ``exclusive``: single-writer coordination (EXCLUSIVE_LOCK
        feature) — the first mutation acquires the image lock,
        contenders request a cooperative handoff, and a dead owner's
        lease expires after ``lock_duration``."""
        image_id = await self.image_id(name)
        img = Image(self.ioctx, name, image_id, cache=cache,
                    exclusive=exclusive, lock_duration=lock_duration)
        await img.refresh()
        if journaled:
            img._journal = ImageJournal(self.ioctx, image_id)
            await img._journal.register()
            await replay_to_image(img, img._journal)
        return img


def _child_key(parent_id: str, snap_id: int, child_id: str) -> str:
    return f"{parent_id}@{snap_id}/{child_id}"


async def _children_of(ioctx: IoCtx, parent_id: str,
                       snap_id: int) -> list[str]:
    """Clone names registered under parent@snap in rbd_children."""
    prefix = _child_key(parent_id, snap_id, "")
    try:
        omap = await ioctx.get_omap(CHILDREN_OID)
    except RadosError as e:
        if e.rc == -2:
            return []
        raise
    return sorted(v.decode() for k, v in omap.items()
                  if k.startswith(prefix))


class Image:
    """An open image handle (librbd rbd_image_t)."""

    def __init__(self, ioctx: IoCtx, name: str, image_id: str,
                 cache: bool = False, exclusive: bool = False,
                 lock_duration: float = 30.0):
        # a PRIVATE io context: the image's snap context (set at refresh)
        # must not clobber the caller's ioctx or other open images
        # (librbd likewise keeps per-image state in ImageCtx)
        self.ioctx = IoCtx(ioctx.rados, ioctx.pool_id, ioctx.pool_name)
        self.ioctx.set_namespace(ioctx.namespace)
        self.name = name
        self.image_id = image_id
        self.size = 0
        self.order = DEFAULT_ORDER
        self.object_prefix = f"rbd_data.{image_id}"
        self.snaps: dict[str, dict] = {}
        self.parent: dict | None = None
        self._parent_img: "Image | None" = None
        self._om: bytearray | None = None      # object map bitmap
        # The map's ABSENT answer is only trustworthy for the handle
        # that maintains it (the reference gates the object map behind
        # the exclusive lock; a non-owner's copy can go stale the moment
        # another client writes).  A handle becomes authoritative once
        # it mutates the map itself (write/rebuild).
        self._om_auth = False
        self._cache = None
        # image journal (librbd Journal.cc): set by RBD.open(journaled=)
        self._journal = None
        self._j_last = -1           # newest appended-and-applied tid
        self._j_uncommitted = 0
        # exclusive lock (librbd ExclusiveLock.cc / ManagedLock.cc
        # over cls_lock): single-writer coordination on the header.
        # -lite fencing is the LEASE — the owner renews at D/3 and
        # refuses local writes once its lease lapses, so a paused
        # owner cannot race whoever acquired after expiry (the
        # reference fences harder, via osd blocklisting).
        self._excl = exclusive
        self._lock_duration = lock_duration
        # instance id first so `rbd lock break --blocklist` can
        # fence the owner: "entity:nonce@img.<id>.<uniq>"
        self._locker_id = (f"{ioctx.rados.instance_id}@"
                           f"img.{image_id}.{secrets.token_hex(4)}")
        self._lock_owner = False
        self._lock_until = 0.0            # monotonic lease horizon
        self._lock_renew_task = None
        self._lock_watch = None
        self._releasing = False
        if cache:
            from ceph_tpu_torch.client.object_cacher import ObjectCacher

            self._cache = ObjectCacher(self._cache_fetch,
                                       self._cache_writeback)

    @property
    def header_oid(self) -> str:
        return f"rbd_header.{self.image_id}"

    @property
    def obj_size(self) -> int:
        return 1 << self.order

    async def refresh(self) -> None:
        h = json.loads(await self.ioctx.exec(
            self.header_oid, "rbd", "get_header"
        ))
        self.size = h["size"]
        self.order = h["order"]
        self.object_prefix = h["object_prefix"]
        self.snaps = h["snaps"]
        self.parent = h.get("parent") or None
        self._parent_img = None
        # image writes carry the image's snap context so data objects
        # COW-clone on the first write after each snapshot
        ids = sorted(int(i["id"]) for i in self.snaps.values())
        if ids:
            self.ioctx.set_snap_context(max(ids), ids)
        try:
            self._om = bytearray(await self.ioctx.read(self._om_oid))
        except RadosError as e:
            if e.rc != -2:
                raise
            self._om = None         # object-map feature off

    async def close(self) -> None:
        if self._cache is not None:
            await self._cache.flush()
        await self._j_commit()
        if self._journal is not None:
            await self._journal.trim()
        if self._lock_renew_task is not None:
            self._lock_renew_task.cancel()
            self._lock_renew_task = None
        if self._lock_owner:
            await self.release_exclusive_lock()
        if self._lock_watch is not None:
            await self.ioctx.unwatch(self._lock_watch)
            self._lock_watch = None

    # -- object map (src/librbd/ObjectMap.h bitmap) -----------------------
    @property
    def _om_oid(self) -> str:
        return f"rbd_object_map.{self.image_id}"

    def _om_test(self, objectno: int) -> bool:
        """True = object may exist; False = definitely absent."""
        if self._om is None:
            return True
        byte = objectno >> 3
        if byte >= len(self._om):
            return False
        return bool(self._om[byte] & (1 << (objectno & 7)))

    async def _om_set(self, objectno: int) -> None:
        if self._om is None:
            return
        self._om_auth = True
        if self._om_test(objectno):
            return
        byte = objectno >> 3
        if byte >= len(self._om):
            self._om.extend(bytes(byte + 1 - len(self._om)))
        self._om[byte] |= 1 << (objectno & 7)
        # Persisted BEFORE the data write lands (may-exist is safe;
        # definitely-absent with data present would corrupt reads).
        # The merge happens SERVER-SIDE in one atomic class op
        # (cls bitmap.or), so two writer handles can never lose each
        # other's bits to a read-modify-write race; the reply is the
        # merged map, refreshing our view for free.
        import base64 as _b64

        merged = await self.ioctx.exec(
            self._om_oid, "bitmap", "or",
            json.dumps({
                "bits_b64": _b64.b64encode(bytes(self._om)).decode(),
            }).encode(),
        )
        self._om = bytearray(_b64.b64decode(merged))

    async def object_map_rebuild(self) -> None:
        """Rescan data objects into a fresh bitmap (rbd object-map
        rebuild)."""
        nobjs = -(-self.size // self.obj_size)
        om = bytearray(-(-nobjs // 8) or 1)
        for objectno in range(nobjs):
            try:
                await self.ioctx.stat(self._data_oid(objectno))
            except RadosError as e:
                if e.rc != -2:
                    raise
                continue
            om[objectno >> 3] |= 1 << (objectno & 7)
        self._om = om
        self._om_auth = True
        await self.ioctx.operate(
            self._om_oid, ObjectOperation().write_full(bytes(om))
        )

    # -- parent COW (librbd clone read-through + CopyupRequest) -----------
    async def _parent_image(self) -> "Image | None":
        if self.parent is None:
            return None
        if self._parent_img is None:
            pool = self.parent["pool"]
            pio = (self.ioctx if pool == self.ioctx.pool_name
                   else await self.ioctx.rados.open_ioctx(pool))
            img = Image(pio, "", self.parent["image_id"])
            await img.refresh()
            self._parent_img = img
        return self._parent_img

    async def _parent_range(self, img_off: int, want: int) -> bytes:
        """Parent bytes for [img_off, img_off+want), clipped to the
        overlap; shorter/empty result means zeros."""
        if self.parent is None or img_off >= self.parent["overlap"]:
            return b""
        want = min(want, self.parent["overlap"] - img_off)
        parent = await self._parent_image()
        return await parent._read_extents(
            img_off, want, snapid=int(self.parent["snap_id"])
        )

    def stat(self) -> dict:
        return {
            "size": self.size, "order": self.order,
            "object_size": self.obj_size,
            "num_objs": -(-self.size // self.obj_size),
            "id": self.image_id,
        }

    def _data_oid(self, objectno: int) -> str:
        return f"{self.object_prefix}.{objectno:016x}"

    def _extents(self, offset: int, length: int):
        pos = offset
        end = offset + length
        while pos < end:
            objectno = pos // self.obj_size
            obj_off = pos % self.obj_size
            run = min(self.obj_size - obj_off, end - pos)
            yield objectno, obj_off, run
            pos += run

    # -- object IO dispatch (the io/ObjectRequest layer: object map ->
    # parent COW -> OSD; the optional cache sits above all of it) ---------
    async def _obj_exists(self, objectno: int) -> bool:
        if self._om is not None and self._om_auth:
            return self._om_test(objectno)
        try:
            await self.ioctx.stat(self._data_oid(objectno))
            return True
        except RadosError as e:
            if e.rc != -2:
                raise
            return False

    async def _obj_read_direct(self, objectno: int, obj_off: int,
                               run: int, snapid: int | None = None
                               ) -> bytes:
        """One object's bytes with parent fallback; short = zeros."""
        frag = None
        if snapid is None and self._om is not None and self._om_auth \
                and not self._om_test(objectno):
            frag = b""              # known-absent: skip the round trip
        else:
            if snapid is not None:
                self.ioctx.snap_set_read(snapid)
            try:
                frag = await self.ioctx.read(
                    self._data_oid(objectno), run, obj_off
                )
                return frag
            except RadosError as e:
                if e.rc != -2:
                    raise
                frag = b""
            finally:
                if snapid is not None:
                    self.ioctx.snap_set_read(None)
        # absent from this image: a clone reads through to the parent
        if self.parent is not None:
            return await self._parent_range(
                objectno * self.obj_size + obj_off, run
            )
        return frag

    async def _obj_write(self, objectno: int, obj_off: int,
                         data: bytes) -> None:
        oid = self._data_oid(objectno)
        if self.parent is not None and \
                not await self._obj_exists(objectno):
            # copyup (io/CopyupRequest): materialize the parent block in
            # the child before the first write so reads never see a
            # half-diverged object
            base = bytearray(
                await self._parent_range(objectno * self.obj_size,
                                         self.obj_size)
            )
            end = obj_off + len(data)
            if len(base) < end:
                base.extend(bytes(end - len(base)))
            base[obj_off:end] = data
            await self._om_set(objectno)
            await self.ioctx.operate(
                oid, ObjectOperation().write_full(bytes(base))
            )
            return
        await self._om_set(objectno)
        await self.ioctx.write(oid, data, obj_off)

    # cache plumbing: fetch/writeback close over the dispatch above
    async def _cache_fetch(self, objectno: int) -> bytes:
        return await self._obj_read_direct(objectno, 0, self.obj_size)

    async def _cache_writeback(self, objectno: int,
                               data: bytes) -> None:
        await self._om_set(objectno)
        await self.ioctx.operate(
            self._data_oid(objectno),
            ObjectOperation().write_full(data),
        )

    async def _read_extents(self, offset: int, length: int,
                            snapid: int | None = None) -> bytes:
        out = bytearray(length)
        pos = 0
        for objectno, obj_off, run in self._extents(offset, length):
            if snapid is None and self._cache is not None:
                frag = await self._cache.read(objectno, obj_off, run)
            else:
                frag = await self._obj_read_direct(objectno, obj_off,
                                                   run, snapid)
            out[pos:pos + len(frag)] = frag
            pos += run
        return bytes(out)

    _COMMIT_BATCH = 16      # journal commit-position update cadence

    async def _j_append(self, event: int, args: dict) -> None:
        """Journal-first mutation ordering: the entry is durable before
        the image changes (the write is acked at journal-safe; a crash
        in between is covered by open-time replay)."""
        self._j_last = await self._journal.append(event, args)

    async def _j_applied(self) -> None:
        """Lazily advance the commit position (batched like the
        reference's commit interval, flushed on flush/close)."""
        self._j_uncommitted += 1
        if self._j_uncommitted >= self._COMMIT_BATCH:
            await self._j_commit()

    async def _j_commit(self) -> None:
        if self._journal is not None and self._j_uncommitted:
            if self._cache is not None:
                # an entry is only "applied" once its data is durable:
                # committing past writes still in the volatile cache
                # would make replay skip exactly the crash window the
                # journal exists to cover
                await self._cache.flush()
            await self._journal.commit(self._j_last)
            self._j_uncommitted = 0

    # -- image metadata (librbd metadata_set/get/list, cls_rbd) ------------
    _META_PREFIX = "meta."

    async def meta_set(self, key: str, value: str) -> None:
        """rbd image-meta set: free-form key/value on the header
        (the conf_* override namespace included)."""
        if not key:
            raise RBDError("empty metadata key")
        await self.ioctx.set_omap(
            self.header_oid,
            {self._META_PREFIX + key: str(value).encode()})

    async def meta_get(self, key: str) -> str:
        kv = await self.ioctx.get_omap(self.header_oid,
                                       [self._META_PREFIX + key])
        if self._META_PREFIX + key not in kv:
            raise RBDError(f"no metadata key {key!r}")
        return kv[self._META_PREFIX + key].decode()

    async def meta_list(self) -> dict[str, str]:
        omap = await self.ioctx.get_omap(self.header_oid)
        return {k[len(self._META_PREFIX):]: v.decode()
                for k, v in sorted(omap.items())
                if k.startswith(self._META_PREFIX)}

    async def meta_remove(self, key: str) -> None:
        kv = await self.ioctx.get_omap(self.header_oid,
                                       [self._META_PREFIX + key])
        if self._META_PREFIX + key not in kv:
            raise RBDError(f"no metadata key {key!r}")
        await self.ioctx.rm_omap_keys(self.header_oid,
                                      [self._META_PREFIX + key])

    # -- exclusive lock (ExclusiveLock.cc over cls_lock) -------------------
    RBD_LOCK_NAME = "rbd_lock"

    async def lock_info(self) -> dict:
        return json.loads(await self.ioctx.exec(
            self.header_oid, "lock", "get_info", b"{}"))

    async def _lock_try(self) -> bool:
        try:
            await self.ioctx.exec(
                self.header_oid, "lock", "lock",
                json.dumps({"name": self.RBD_LOCK_NAME,
                             "locker": self._locker_id,
                             "type": "exclusive",
                             "duration": self._lock_duration}).encode())
            return True
        except RadosError as e:
            if e.rc == -16:
                return False
            raise

    async def acquire_exclusive_lock(self,
                                     timeout: float = 10.0) -> None:
        """Become the image's single writer.  A live owner is asked to
        release (cooperative transition via a header notify); a dead
        owner's lease simply expires."""
        if self._lock_owner and time.monotonic() < self._lock_until:
            return
        deadline = time.monotonic() + timeout
        while True:
            before = time.monotonic()
            if await self._lock_try():
                self._lock_owner = True
                self._lock_until = before + self._lock_duration
                self._releasing = False
                if self._lock_watch is None:
                    self._lock_watch = await self.ioctx.watch(
                        self.header_oid, self._lock_notify)
                if self._lock_renew_task is None:
                    self._lock_renew_task = asyncio.create_task(
                        self._lock_renew_loop())
                # the image may have changed hands while we were not
                # the owner: adopt the current header — especially the
                # snap context, or our next write would overwrite a
                # snapshot another owner just took instead of COWing
                # (librbd refreshes after the lock acquires too)
                await self.refresh()
                return
            try:
                await self.ioctx.notify(
                    self.header_oid,
                    json.dumps({"op": "request_lock"}).encode(),
                    timeout=2.0)
            except RadosError:
                pass
            if time.monotonic() > deadline:
                info = await self.lock_info()
                raise RBDError(
                    f"image {self.name!r} is exclusively locked by "
                    f"{sorted(info.get('lockers', {}))}")
            await asyncio.sleep(0.1)

    async def _lock_notify(self, payload: bytes) -> bytes | None:
        try:
            msg = json.loads(payload or b"{}")
        except ValueError:
            return None
        if msg.get("op") == "request_lock" and self._lock_owner \
                and not self._releasing:
            # hand off at a quiescent point, not mid-notify-callback
            self._releasing = True
            asyncio.get_running_loop().create_task(
                self.release_exclusive_lock())
        return b"ack"

    async def _lock_renew_loop(self) -> None:
        while True:
            await asyncio.sleep(self._lock_duration / 3)
            if not self._lock_owner:
                continue
            before = time.monotonic()
            try:
                renewed = await self._lock_try()
            except RadosError:
                continue      # transient (PG unavailable): next tick
            if renewed:
                self._lock_until = before + self._lock_duration
            else:
                # lease lapsed and someone else owns the image now
                await self._fence_lost_lock()

    async def release_exclusive_lock(self) -> None:
        """Flush and give the lock up (the cooperative handoff)."""
        if not self._lock_owner:
            self._releasing = False
            return
        await self.flush()
        self._lock_owner = False
        self._releasing = False
        try:
            await self.ioctx.exec(
                self.header_oid, "lock", "unlock",
                json.dumps({"locker": self._locker_id}).encode())
        except RadosError:
            pass                 # already expired / broken: same end

    async def break_lock(self, locker: str,
                         blocklist: bool = False) -> None:
        """Force-remove another client's lock (rbd lock break): for
        owners that died without a lease (or an operator who cannot
        wait one out).  ``blocklist`` additionally fences the former
        owner's client instance at the OSDs FIRST — the reference's
        default for break: without it, the dead owner's in-flight
        writes can land after the new owner takes over.  The locker
        cookie carries the instance id ("entity:nonce") when the
        lock was taken by this stack's acquire_exclusive_lock."""
        if blocklist:
            if "@" not in locker:
                # nothing to fence: blocklisting the raw cookie would
                # report success while the dead owner's in-flight
                # writes still land — the exact window the flag
                # exists to close
                raise RBDError(
                    f"locker {locker!r} carries no instance id; "
                    f"break without --blocklist or fence manually")
            ent = locker.split("@", 1)[0]
            try:
                r = await self.ioctx.rados.mon_command(
                    "osd blocklist", action="add", entity=ent)
                if r.get("rc") != 0:
                    raise RBDError(
                        f"blocklist of {ent!r} refused: {r}")
            except RadosError as e:
                raise RBDError(f"blocklist of {ent!r} failed: "
                               f"{e}") from e
        try:
            await self.ioctx.exec(
                self.header_oid, "lock", "unlock",
                json.dumps({"locker": locker}).encode())
        except RadosError as e:
            if e.rc != -2:
                raise

    async def _fence_lost_lock(self) -> None:
        """The lease lapsed while we may hold dirty state: DISCARD the
        write-back cache rather than let a later flush overwrite
        whatever the next owner wrote in between (the reference fences
        via osd blocklisting; -lite drops the stale dirty blocks)."""
        self._lock_owner = False
        if self._cache is not None:
            for key in list(self._cache._objects):
                await self._cache.discard(key)
        self._om_auth = False      # the map may be stale too

    async def _ensure_lock(self) -> None:
        if not self._excl:
            return
        if not self._lock_owner:
            await self.acquire_exclusive_lock()
        elif time.monotonic() >= self._lock_until:
            await self._fence_lost_lock()
            await self.acquire_exclusive_lock()

    async def write(self, offset: int, data: bytes,
                    _journal: bool = True) -> None:
        await self._ensure_lock()
        if offset + len(data) > self.size:
            raise RBDError("write past end of image")
        if self._journal is not None and _journal:
            await self._j_append(EV_WRITE, {"off": offset, "data": data})
        pos = 0
        for objectno, obj_off, run in self._extents(offset, len(data)):
            chunk = data[pos:pos + run]
            if self._cache is not None:
                await self._cache.write(objectno, obj_off, chunk)
            else:
                await self._obj_write(objectno, obj_off, chunk)
            pos += run
        if self._journal is not None and _journal:
            await self._j_applied()

    async def read(self, offset: int, length: int) -> bytes:
        length = max(0, min(length, self.size - offset))
        return await self._read_extents(offset, length)

    async def flush(self) -> None:
        if self._cache is not None:
            await self._cache.flush()
        await self._j_commit()

    async def flatten(self) -> None:
        """Copy every still-inherited parent block into the child and
        sever the parent link (librbd flatten)."""
        await self._ensure_lock()
        if self.parent is None:
            raise RBDError("image has no parent")
        if self._cache is not None:
            await self._cache.flush()
        nobjs = -(-self.size // self.obj_size)
        for objectno in range(nobjs):
            if await self._obj_exists(objectno):
                continue
            block = await self._parent_range(
                objectno * self.obj_size, self.obj_size
            )
            if not block.rstrip(b"\x00"):
                continue            # all-zero: absent reads the same
            await self._om_set(objectno)
            await self.ioctx.operate(
                self._data_oid(objectno),
                ObjectOperation().write_full(block),
            )
        await self.ioctx.exec(self.header_oid, "rbd", "remove_parent",
                              b"{}")
        ppool = self.parent.get("pool", self.ioctx.pool_name)
        pio = (self.ioctx if ppool == self.ioctx.pool_name
               else await self.ioctx.rados.open_ioctx(ppool))
        try:
            await pio.rm_omap_keys(CHILDREN_OID, [
                _child_key(self.parent["image_id"],
                           int(self.parent["snap_id"]), self.image_id),
            ])
        except RadosError as e:
            if e.rc != -2:
                raise
        self.parent = None
        self._parent_img = None
        # cached blocks that hold parent-fallback data remain
        # byte-correct after the flatten copied those bytes up

    async def resize(self, new_size: int, _journal: bool = True) -> None:
        await self._ensure_lock()
        if self._cache is not None:
            await self._cache.flush()
        if self._journal is not None and _journal:
            await self._j_append(EV_RESIZE, {"size": new_size})
        await self.ioctx.exec(
            self.header_oid, "rbd", "set_size",
            json.dumps({"size": new_size}).encode(),
        )
        if new_size < self.size:
            first_dead = -(-new_size // self.obj_size)
            last = -(-self.size // self.obj_size)
            for objectno in range(first_dead, last):
                try:
                    await self.ioctx.remove(self._data_oid(objectno))
                except RadosError as e:
                    if e.rc != -2:
                        raise
                if self._om is not None \
                        and objectno >> 3 < len(self._om):
                    self._om[objectno >> 3] &= ~(1 << (objectno & 7))
                if self._cache is not None:
                    await self._cache.discard(objectno)
            boundary = new_size % self.obj_size
            if boundary:
                try:
                    await self.ioctx.truncate(
                        self._data_oid(new_size // self.obj_size), boundary
                    )
                except RadosError as e:
                    if e.rc != -2:
                        raise
                if self._cache is not None:
                    await self._cache.discard(new_size // self.obj_size)
            if self._om is not None:
                await self.ioctx.operate(
                    self._om_oid,
                    ObjectOperation().write_full(bytes(self._om)),
                )
            # a shrunk clone inherits less of its parent — persisted,
            # or a reopen/regrow would resurrect truncated parent data
            if self.parent is not None \
                    and self.parent["overlap"] > new_size:
                await self.ioctx.exec(
                    self.header_oid, "rbd", "set_parent_overlap",
                    json.dumps({"overlap": new_size}).encode(),
                )
                self.parent["overlap"] = new_size
        self.size = new_size
        if self._journal is not None and _journal:
            await self._j_applied()

    # -- snapshots (self-managed snaps + object COW clones; the librbd
    # snap_create/snap_rollback model over the OSD snapshot machinery) --
    async def snap_create(self, snap_name: str,
                          _journal: bool = True) -> int:
        await self._ensure_lock()
        if self._cache is not None:
            # the snapshot must capture every acked write (librbd
            # flushes its cache before snap_create)
            await self._cache.flush()
        if self._journal is not None and _journal:
            await self._j_append(EV_SNAP_CREATE, {"name": snap_name})
        snapid = await self.ioctx.selfmanaged_snap_create()
        await self.ioctx.exec(
            self.header_oid, "rbd", "snap_add",
            json.dumps({"name": snap_name, "id": snapid}).encode(),
        )
        await self.refresh()
        if self._journal is not None and _journal:
            await self._j_applied()
        return snapid

    async def snap_protect(self, snap_name: str) -> None:
        """Required before cloning (librbd snap_protect)."""
        if snap_name not in self.snaps:
            raise RBDError(f"no snap {snap_name!r}")
        await self.ioctx.exec(
            self.header_oid, "rbd", "snap_protect",
            json.dumps({"name": snap_name}).encode(),
        )
        await self.refresh()

    async def snap_unprotect(self, snap_name: str) -> None:
        """Refuses while clones exist (the reference walks every pool's
        rbd_children; ours is pool-local)."""
        info = self.snaps.get(snap_name)
        if info is None:
            raise RBDError(f"no snap {snap_name!r}")
        kids = await _children_of(self.ioctx, self.image_id,
                                  int(info["id"]))
        if kids:
            raise RBDError(
                f"snap {snap_name!r} has children: {kids}"
            )
        await self.ioctx.exec(
            self.header_oid, "rbd", "snap_unprotect",
            json.dumps({"name": snap_name}).encode(),
        )
        await self.refresh()

    async def snap_remove(self, snap_name: str,
                          _journal: bool = True) -> None:
        await self._ensure_lock()
        info = self.snaps.get(snap_name)
        if info is None:
            raise RBDError(f"no snap {snap_name!r}")
        if self._journal is not None and _journal:
            await self._j_append(EV_SNAP_REMOVE, {"name": snap_name})
        await self.ioctx.exec(
            self.header_oid, "rbd", "snap_rm",
            json.dumps({"name": snap_name}).encode(),
        )
        await self.ioctx.selfmanaged_snap_remove(int(info["id"]))
        await self.refresh()
        if self._journal is not None and _journal:
            await self._j_applied()

    def snap_list(self) -> list[dict]:
        return [
            {"name": name, **info}
            for name, info in sorted(self.snaps.items())
        ]

    async def read_at_snap(self, snap_name: str, offset: int,
                           length: int) -> bytes:
        """Read the image as of a snapshot (librbd snap_set + read).
        Clone objects not yet copied up at snap time read through to
        the parent, like head reads."""
        info = self.snaps.get(snap_name)
        if info is None:
            raise RBDError(f"no snap {snap_name!r}")
        if self._cache is not None:
            await self._cache.flush()
        snap_size = int(info["size"])
        length = max(0, min(length, snap_size - offset))
        return await self._read_extents(offset, length,
                                        snapid=int(info["id"]))

    async def snap_rollback(self, snap_name: str,
                            _journal: bool = True) -> None:
        """Restore the head image to a snapshot's content (librbd
        snap_rollback: copy the snap state over the head)."""
        await self._ensure_lock()
        info = self.snaps.get(snap_name)
        if info is None:
            raise RBDError(f"no snap {snap_name!r}")
        if self._journal is not None and _journal:
            await self._j_append(EV_SNAP_ROLLBACK, {"name": snap_name})
        snap_size = int(info["size"])
        if self.size != snap_size:
            await self.resize(snap_size, _journal=False)
        nobjs = -(-snap_size // self.obj_size)
        for objectno in range(nobjs):
            want = min(self.obj_size, snap_size - objectno * self.obj_size)
            frag = await self.read_at_snap(
                snap_name, objectno * self.obj_size, want
            )
            await self._om_set(objectno)
            await self.ioctx.operate(
                self._data_oid(objectno),
                ObjectOperation().write_full(frag),
            )
            if self._cache is not None:
                await self._cache.discard(objectno)
        if self._journal is not None and _journal:
            await self._j_applied()
