"""Volumes: CephFS subvolume management (mgr volumes module role).

Counterpart of ceph_tpu/services/volumes.py: the same module over the
port's imports.

Reference src/pybind/mgr/volumes: subvolumes are operator-managed
directory trees under ``/volumes/<group>/<name>`` with a ``.meta``
sidecar (the reference stores the same under a uuid indirection and a
``.meta`` config file), created/removed/listed through ``ceph fs
subvolume`` verbs.  Subvolume snapshots ride the MDS snap realms
(``.snap`` of the subvolume root).

-lite divergence: no uuid indirection layer and no async purge queue —
removal walks the tree inline (trees are operator-scale here).  A
subvolume's size IS enforced: it becomes a max_bytes directory quota
on the subvolume root (the ceph.quota vxattr wiring), adjustable with
``fs subvolume resize``.
"""

from __future__ import annotations

import json
import time

from ceph_tpu_torch.client.fs import CephFS, FSError

NO_GROUP = "_nogroup"
META = ".meta"
ENOENT = -2
EEXIST = -17
ENOTEMPTY = -39
EINVAL = -22


class VolumeManager:
    def __init__(self, fs: CephFS):
        self.fs = fs

    # -- paths -------------------------------------------------------------
    @staticmethod
    def _group_path(group: str | None) -> str:
        # Same validation as group_create: the FS client collapses ".."
        # lexically, so an unvalidated group like "../.." would aim every
        # subvolume verb (including rm --force) outside /volumes.
        if group is not None and (
            "/" in group or group.startswith((".", "_")) or not group
        ):
            raise FSError(EINVAL, f"bad group name {group!r}")
        return f"/volumes/{group or NO_GROUP}"

    @classmethod
    def _subvol_path(cls, name: str, group: str | None) -> str:
        if not name or "/" in name or name.startswith("."):
            raise FSError(EINVAL, f"bad subvolume name {name!r}")
        return f"{cls._group_path(group)}/{name}"

    # -- groups ------------------------------------------------------------
    async def group_create(self, group: str, mode: int = 0o755) -> None:
        if "/" in group or group.startswith((".", "_")):
            raise FSError(EINVAL, f"bad group name {group!r}")
        await self.fs.mkdirs(self._group_path(group), mode)

    async def group_ls(self) -> list[str]:
        try:
            names = await self.fs.readdir("/volumes")
        except FSError as e:
            if e.rc != ENOENT:
                raise
            return []
        return sorted(n for n in names if n != NO_GROUP)

    async def group_rm(self, group: str) -> None:
        path = self._group_path(group)
        if await self.fs.readdir(path):
            raise FSError(ENOTEMPTY,
                          f"group {group!r} still has subvolumes")
        await self.fs.rmdir(path)

    # -- subvolumes ---------------------------------------------------------
    async def create(self, name: str, group: str | None = None,
                     mode: int = 0o755, size: int = 0) -> str:
        """Create the subvolume directory + meta sidecar; returns the
        data path handed to mounters (``fs subvolume getpath``).
        ``size`` > 0 becomes an ENFORCED max_bytes quota on the
        subvolume root (the reference wires subvolume size to the
        quota vxattr the same way)."""
        path = self._subvol_path(name, group)
        try:
            await self.fs.stat(path)
            raise FSError(EEXIST, f"subvolume {name!r} exists")
        except FSError as e:
            if e.rc != ENOENT:
                raise
        await self.fs.mkdirs(path, mode)
        await self.fs.write_file(f"{path}/{META}", json.dumps({
            "name": name, "group": group or NO_GROUP,
            "created": time.time(), "mode": mode, "size": size,
            "state": "complete",
        }).encode())
        if size > 0:
            await self.fs.setquota(path, max_bytes=size)
        return path

    async def resize(self, name: str, new_size: int,
                     group: str | None = None,
                     no_shrink: bool = False) -> dict:
        """fs subvolume resize: adjust the max_bytes quota (0 =
        infinite).  ``no_shrink`` refuses a target below current
        usage, like the reference's --no_shrink."""
        path = await self.getpath(name, group)
        if new_size < 0:
            raise FSError(EINVAL, "size must be >= 0")
        got = await self.fs.getquota(path)
        if no_shrink and new_size > 0:
            used = (got.get("usage") or {}).get("bytes", 0)
            if new_size < used:
                raise FSError(EINVAL,
                              f"target {new_size} < used {used}")
        # clear -> sidecar write -> apply: the META rewrite lives
        # INSIDE the realm, so writing it under either the old or the
        # new limit could EDQUOT a legal resize.  A failure mid-window
        # re-applies the OLD limit — an error must not leave the
        # subvolume silently unlimited (a process crash in the window
        # still can; the next resize heals it).
        old_limit = int(got["quota"].get("max_bytes", 0))
        await self.fs.setquota(path)
        applied = False
        try:
            meta = json.loads(
                await self.fs.read_file(f"{path}/{META}"))
            meta["size"] = new_size
            await self.fs.write_file(f"{path}/{META}",
                                     json.dumps(meta).encode())
            if new_size > 0:
                await self.fs.setquota(path, max_bytes=new_size)
            applied = True
        finally:
            if not applied and old_limit > 0:
                try:
                    await self.fs.setquota(path,
                                           max_bytes=old_limit)
                except FSError:
                    pass
        return {"path": path, "size": new_size}

    async def ls(self, group: str | None = None) -> list[str]:
        try:
            names = await self.fs.readdir(self._group_path(group))
        except FSError as e:
            if e.rc != ENOENT:
                raise
            return []
        return sorted(names)

    async def getpath(self, name: str, group: str | None = None) -> str:
        path = self._subvol_path(name, group)
        await self.fs.stat(path)           # ENOENT surfaces here
        return path

    async def info(self, name: str, group: str | None = None) -> dict:
        path = await self.getpath(name, group)
        meta = json.loads(await self.fs.read_file(f"{path}/{META}"))
        entries = await self.fs.readdir(path)
        meta["path"] = path
        meta["entries"] = sum(1 for n in entries if n != META)
        meta["snapshots"] = sorted(await self.snapshot_ls(name, group))
        q = await self.fs.getquota(path)
        meta["quota"] = q["quota"]
        meta["bytes_used"] = (q.get("usage") or {}).get("bytes", 0)
        return meta

    async def rm(self, name: str, group: str | None = None,
                 force: bool = False) -> None:
        """Remove the subvolume tree.  Refuses while snapshots cover
        it (matching the reference's snapshot-retention refusal)
        unless ``force`` also removes the snapshots first."""
        path = await self.getpath(name, group)
        snaps = await self.snapshot_ls(name, group)
        if snaps:
            if not force:
                raise FSError(ENOTEMPTY,
                              f"subvolume {name!r} has snapshots "
                              f"{snaps}; use force")
            for s in snaps:
                await self.fs.rmsnap(path, s)
        await self._rmtree(path)     # rmdir drops the quota record

    async def _rmtree(self, path: str) -> None:
        """Depth-first removal (the reference defers this to an async
        purge-queue thread; inline at -lite scale)."""
        for name, d in sorted((await self.fs.readdir(path)).items()):
            child = f"{path}/{name}"
            if d.get("type") == "dir":
                await self._rmtree(child)
            else:
                await self.fs.unlink(child)
        await self.fs.rmdir(path)

    # -- snapshots (subvolume .snap realms) ---------------------------------
    async def snapshot_create(self, name: str, snap: str,
                              group: str | None = None) -> int:
        path = await self.getpath(name, group)
        return await self.fs.mksnap(path, snap)

    async def snapshot_ls(self, name: str,
                          group: str | None = None) -> list[str]:
        path = await self.getpath(name, group)
        return sorted(await self.fs.listsnaps(path))

    async def snapshot_rm(self, name: str, snap: str,
                          group: str | None = None) -> None:
        path = await self.getpath(name, group)
        await self.fs.rmsnap(path, snap)

    async def snapshot_clone(self, name: str, snap: str,
                             target: str,
                             group: str | None = None,
                             target_group: str | None = None) -> str:
        """Clone a subvolume snapshot into a NEW subvolume (the
        volumes module's `subvolume snapshot clone`; synchronous here
        — the reference runs it through an async cloner thread)."""
        if not target:
            raise FSError(EINVAL, "clone needs a target name")
        src = await self.getpath(name, group)
        if snap not in await self.fs.listsnaps(src):
            raise FSError(ENOENT, f"no snapshot {snap!r}")
        src_meta = json.loads(
            await self.fs.read_file(f"{src}/{META}"))
        dst = await self.create(target, target_group,
                                mode=int(src_meta.get("mode",
                                                      0o755)),
                                size=int(src_meta.get("size", 0)))
        # in-progress marker (the reference's clone state tracking):
        # a half-copied target must never read as a good clone
        await self._set_state(dst, "cloning")
        try:
            await self._copy_tree(f"{src}/.snap/{snap}", dst,
                                  root=True)
        except BaseException:
            try:
                await self.rm(target, target_group, force=True)
            except FSError:
                pass               # partial target survives as
                                   # state='cloning', visibly broken
            raise
        await self._set_state(dst, "complete")
        return dst

    async def _set_state(self, path: str, state: str) -> None:
        meta = json.loads(await self.fs.read_file(f"{path}/{META}"))
        meta["state"] = state
        await self.fs.write_file(f"{path}/{META}",
                                 json.dumps(meta).encode())

    async def _copy_tree(self, src: str, dst: str,
                         root: bool = False) -> None:
        for entry, d in sorted((await self.fs.readdir(src)).items()):
            if root and entry == META:
                continue   # ONLY the root sidecar is server-owned;
                           # a nested user file named .meta must copy
            s, t = f"{src}/{entry}", f"{dst}/{entry}"
            if d.get("type") == "dir":
                await self.fs.mkdir(t)
                await self._copy_tree(s, t)
            elif d.get("type") == "symlink":
                await self.fs.symlink(await self.fs.readlink(s), t)
            else:
                await self.fs.write_file(t, await self.fs.read_file(s))
