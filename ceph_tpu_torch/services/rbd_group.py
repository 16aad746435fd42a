"""RBD consistency groups (reference src/librbd/api/Group.cc).

Counterpart of ceph_tpu/services/rbd_group.py: the same module over the
port's imports.

A group names a set of images whose snapshots must be MUTUALLY
consistent: ``group snap create`` quiesces every member (exclusive
lock on each, taken in sorted order so two concurrent group snaps
cannot deadlock), snapshots them all at that frozen point, then
releases.  On-disk model mirrors cls_rbd's group support:

- ``rbd_group_directory``      omap: group name -> group id
- ``rbd_group_header.<id>``    omap: ``image.<image_id>`` member
  records and ``snap.<snap_id>`` group-snapshot records
- each member's ``rbd_header.<image_id>`` carries a ``group`` xattr
  (one group per image — cls_rbd image_group_add semantics); image
  removal refuses while it is set.

Group snapshots are written as a PENDING record first and flipped to
``complete`` only after every member snap exists, so a crash mid-snap
leaves an identifiable partial record (``group snap list`` shows its
state; remove cleans it up) — never a silently inconsistent "complete"
snapshot.
"""

from __future__ import annotations

import json
import secrets
import time

from ceph_tpu_torch.client.rados import ObjectOperation, RadosError
from ceph_tpu_torch.services.rbd import RBD, RBDError

GROUP_DIR_OID = "rbd_group_directory"


class RBDGroups:
    """Group verbs over one pool/namespace handle."""

    def __init__(self, rbd: RBD):
        self.rbd = rbd
        self.ioctx = rbd.ioctx

    @staticmethod
    def _hdr(gid: str) -> str:
        return f"rbd_group_header.{gid}"

    # -- group directory --------------------------------------------------
    async def create(self, name: str) -> str:
        if not name or "/" in name or "@" in name:
            raise RBDError(f"bad group name {name!r}")
        try:
            existing = await self.ioctx.get_omap(GROUP_DIR_OID, [name])
        except RadosError as e:
            if e.rc != -2:
                raise
            existing = {}
        if name in existing:
            raise RBDError(f"group {name!r} exists")
        gid = secrets.token_hex(8)
        await self.ioctx.operate(
            self._hdr(gid), ObjectOperation().create()
        )
        await self.ioctx.operate(
            GROUP_DIR_OID,
            ObjectOperation().create().omap_set({name: gid.encode()}),
        )
        return gid

    async def list(self) -> list[str]:
        try:
            return sorted(await self.ioctx.get_omap(GROUP_DIR_OID))
        except RadosError as e:
            if e.rc == -2:
                return []
            raise

    async def _gid(self, name: str) -> str:
        try:
            kv = await self.ioctx.get_omap(GROUP_DIR_OID, [name])
        except RadosError as e:
            if e.rc == -2:
                kv = {}
            else:
                raise
        if name not in kv:
            raise RBDError(f"no group {name!r}")
        return kv[name].decode()

    async def rename(self, old: str, new: str) -> None:
        if not new or "/" in new or "@" in new:
            raise RBDError(f"bad group name {new!r}")
        gid = await self._gid(old)
        names = await self.list()
        if new in names:
            raise RBDError(f"group {new!r} exists")
        await self.ioctx.operate(
            GROUP_DIR_OID,
            ObjectOperation().omap_set({new: gid.encode()})
            .omap_rm([old]),
        )

    async def remove(self, name: str) -> None:
        """Remove the group: member images are unlinked (their data is
        untouched), group snapshot records die with the header — the
        per-image snaps they reference are removed too (Group.cc
        remove cleans member snaps)."""
        gid = await self._gid(name)
        hdr = await self._header(gid)
        for rec in hdr["snaps"].values():
            await self._remove_member_snaps(rec)
        for image_id in hdr["images"]:
            await self._clear_image_group(image_id)
        try:
            await self.ioctx.remove(self._hdr(gid))
        except RadosError as e:
            if e.rc != -2:
                raise
        await self.ioctx.rm_omap_keys(GROUP_DIR_OID, [name])

    async def _header(self, gid: str) -> dict:
        """Decoded header: {"images": {image_id: rec},
        "snaps": {snap_id: rec}}."""
        try:
            omap = await self.ioctx.get_omap(self._hdr(gid))
        except RadosError as e:
            if e.rc != -2:
                raise
            omap = {}
        out: dict = {"images": {}, "snaps": {}}
        for k, v in omap.items():
            kind, _, rest = k.partition(".")
            if kind == "image":
                out["images"][rest] = json.loads(v)
            elif kind == "snap":
                out["snaps"][rest] = json.loads(v)
        return out

    # -- membership -------------------------------------------------------
    async def image_add(self, group: str, image_name: str) -> None:
        gid = await self._gid(group)
        image_id = await self.rbd.image_id(image_name)
        hdr_oid = f"rbd_header.{image_id}"
        try:
            cur = await self.ioctx.get_xattr(hdr_oid, "group")
        except RadosError as e:
            if e.rc != -2:
                raise
            cur = None
        if cur is not None:
            if cur.decode() == gid:
                raise RBDError(f"image {image_name!r} already in group")
            raise RBDError(
                f"image {image_name!r} belongs to another group"
            )
        await self.ioctx.set_xattr(hdr_oid, "group", gid.encode())
        await self.ioctx.set_omap(self._hdr(gid), {
            f"image.{image_id}": json.dumps(
                {"name": image_name}).encode(),
        })

    async def image_remove(self, group: str, image_name: str) -> None:
        gid = await self._gid(group)
        image_id = await self.rbd.image_id(image_name)
        hdr = await self._header(gid)
        if image_id not in hdr["images"]:
            raise RBDError(f"image {image_name!r} not in {group!r}")
        await self._clear_image_group(image_id)
        await self.ioctx.rm_omap_keys(self._hdr(gid),
                                      [f"image.{image_id}"])

    async def _clear_image_group(self, image_id: str) -> None:
        try:
            await self.ioctx.rm_xattr(f"rbd_header.{image_id}", "group")
        except RadosError as e:
            if e.rc != -2:
                raise

    async def image_list(self, group: str) -> list[str]:
        gid = await self._gid(group)
        hdr = await self._header(gid)
        return sorted(rec["name"] for rec in hdr["images"].values())

    # -- group snapshots --------------------------------------------------
    async def snap_create(self, group: str, snap_name: str) -> str:
        """Crash-consistent snapshot of every member at one point.

        Quiesce: every member image is opened and exclusively locked
        (sorted by image id — a global order, so two concurrent group
        snaps over overlapping groups cannot deadlock); in-flight
        writers lose their lease/get fenced exactly as single-image
        exclusive lock transitions do.  Only when ALL locks are held
        are the snaps taken."""
        gid = await self._gid(group)
        hdr = await self._header(gid)
        if any(r.get("name") == snap_name
               for r in hdr["snaps"].values()):
            raise RBDError(f"group snap {snap_name!r} exists")
        if not hdr["images"]:
            raise RBDError(f"group {group!r} has no images")
        sid = secrets.token_hex(6)
        member_snap = f".group.{gid}.{sid}"
        members = sorted(
            (image_id, rec["name"])
            for image_id, rec in hdr["images"].items()
        )
        # pending record first: a crash below leaves a visibly
        # incomplete snapshot, never a fake-complete one
        rec = {
            "name": snap_name, "state": "pending",
            "created_at": time.time(), "member_snap": member_snap,
            "images": [{"id": i, "name": n} for i, n in members],
        }
        await self.ioctx.set_omap(self._hdr(gid), {
            f"snap.{sid}": json.dumps(rec).encode(),
        })
        images = []
        try:
            for _, name in members:
                img = await self.rbd.open(name, exclusive=True)
                images.append(img)
                await img.acquire_exclusive_lock()
            for img in images:
                await img.snap_create(member_snap)
        finally:
            for img in images:
                try:
                    await img.close()
                except (RBDError, RadosError):
                    pass
        rec["state"] = "complete"
        await self.ioctx.set_omap(self._hdr(gid), {
            f"snap.{sid}": json.dumps(rec).encode(),
        })
        return sid

    async def snap_list(self, group: str) -> list[dict]:
        gid = await self._gid(group)
        hdr = await self._header(gid)
        return sorted(
            ({"id": sid, **rec} for sid, rec in hdr["snaps"].items()),
            key=lambda r: r["created_at"],
        )

    async def _snap_rec(self, gid: str, snap_name: str
                        ) -> tuple[str, dict]:
        hdr = await self._header(gid)
        for sid, rec in hdr["snaps"].items():
            if rec.get("name") == snap_name:
                return sid, rec
        raise RBDError(f"no group snap {snap_name!r}")

    async def _remove_member_snaps(self, rec: dict) -> None:
        for m in rec.get("images", ()):
            try:
                img = await self.rbd.open(m["name"])
            except RBDError:
                continue            # member image is gone
            try:
                if rec["member_snap"] in img.snaps:
                    await img.snap_remove(rec["member_snap"])
            finally:
                await img.close()

    async def snap_remove(self, group: str, snap_name: str) -> None:
        gid = await self._gid(group)
        sid, rec = await self._snap_rec(gid, snap_name)
        await self._remove_member_snaps(rec)
        await self.ioctx.rm_omap_keys(self._hdr(gid), [f"snap.{sid}"])

    async def snap_rollback(self, group: str, snap_name: str) -> None:
        """Restore every member to the group snapshot's point — the
        mutually consistent state ``snap_create`` froze.  All members
        are locked first (same global order) so the restored set is
        itself consistent."""
        gid = await self._gid(group)
        sid, rec = await self._snap_rec(gid, snap_name)
        if rec.get("state") != "complete":
            raise RBDError(
                f"group snap {snap_name!r} is {rec.get('state')}"
            )
        images = []
        try:
            for m in sorted(rec["images"], key=lambda m: m["id"]):
                img = await self.rbd.open(m["name"], exclusive=True)
                images.append(img)
                await img.acquire_exclusive_lock()
            for img in images:
                await img.snap_rollback(rec["member_snap"])
        finally:
            for img in images:
                try:
                    await img.close()
                except (RBDError, RadosError):
                    pass
