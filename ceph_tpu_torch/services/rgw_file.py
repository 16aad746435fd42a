"""NFS-style file facade over RGW buckets.

Counterpart of ceph_tpu/services/rgw_file.py: the same module over the
port's imports.

The rgw_file.cc role (reference src/rgw/rgw_file.cc, 2,440 LoC: the
librgw RGWFileHandle surface that nfs-ganesha's FSAL_RGW exports):
a POSIX-ish namespace where the root's children are BUCKETS, deeper
paths are object keys with '/' separators, and directories exist
either implicitly (a key prefix with members) or explicitly (a
zero-length "<prefix>/" marker object — the S3-console convention the
reference follows, rgw_file.cc create directory path).

Semantics mirrored from the reference:
- readdir merges the delimiter listing's common prefixes (dirs) and
  keys (files); the marker object itself never lists.
- unlink refuses directories; rmdir refuses non-empty ones (members
  OR implicit children).
- rename is copy+unlink (the reference does the same over RGW — S3
  has no server-side move).
- write is whole-file or offset append/overwrite via read-modify-
  write at the object level (the reference's rgw_write buffers and
  flushes the object too; RGW objects are immutable per PUT).
- open handles hand out stateless fh dicts (RGWFileHandle analog):
  {type, bucket, key, size, mtime}.

Every call takes the acting user from the wrapped RGWLite handle, so
ACL/quota/policy enforcement rides the normal gateway checks.
"""

from __future__ import annotations

import time

from ceph_tpu_torch.services.rgw import RGWError, RGWLite

EROOT = {"type": "dir", "bucket": None, "key": "", "size": 0}


class FSError(Exception):
    def __init__(self, errno: int, msg: str = ""):
        super().__init__(f"errno={errno} {msg}")
        self.errno = errno


ENOENT, EEXIST, ENOTDIR, EISDIR, ENOTEMPTY, EINVAL = \
    -2, -17, -20, -21, -39, -22


def _split(path: str) -> tuple[str | None, str]:
    """'/bucket/a/b' -> ('bucket', 'a/b'); '/' -> (None, '')."""
    parts = [p for p in path.split("/") if p]
    if not parts:
        return None, ""
    return parts[0], "/".join(parts[1:])


class RGWFileSystem:
    """One mounted export over an RGWLite handle (librgw mount)."""

    def __init__(self, gw: RGWLite):
        self.gw = gw

    # -- attrs / lookup ---------------------------------------------------
    async def getattr(self, path: str) -> dict:
        bucket, key = _split(path)
        if bucket is None:
            return dict(EROOT)
        try:
            await self.gw.head_bucket(bucket)
        except RGWError:
            raise FSError(ENOENT, f"no bucket {bucket!r}")
        if not key:
            return {"type": "dir", "bucket": bucket, "key": "",
                    "size": 0}
        # a file is an exact key; a dir is a marker object or an
        # implicit prefix with members (rgw_file lookup order)
        try:
            entry = await self.gw.head_object(bucket, key)
            return {"type": "file", "bucket": bucket, "key": key,
                    "size": int(entry["size"]),
                    "mtime": float(entry.get("mtime", 0))}
        except RGWError:
            pass
        if await self._dir_exists(bucket, key):
            return {"type": "dir", "bucket": bucket, "key": key,
                    "size": 0}
        raise FSError(ENOENT, path)

    async def _dir_exists(self, bucket: str, key: str) -> bool:
        try:
            await self.gw.head_object(bucket, key + "/")
            return True
        except RGWError:
            pass
        try:
            out = await self.gw.list_objects(bucket, prefix=key + "/",
                                             max_keys=1)
        except RGWError:
            return False
        return bool(out["contents"] or out.get("common_prefixes"))

    # -- directories ------------------------------------------------------
    async def mkdir(self, path: str) -> None:
        bucket, key = _split(path)
        if bucket is None:
            raise FSError(EEXIST, "/")
        if not key:
            try:
                await self.gw.create_bucket(bucket)
            except RGWError as e:
                raise FSError(EEXIST if e.code == "BucketAlreadyExists"
                              else EINVAL, str(e))
            return
        try:
            await self.gw.head_object(bucket, key)
        except RGWError:
            pass
        else:
            raise FSError(EEXIST, path)
        if await self._dir_exists(bucket, key):
            raise FSError(EEXIST, path)
        # parent must be a directory (or the bucket root)
        parent = key.rsplit("/", 1)[0] if "/" in key else ""
        if parent and not await self._dir_exists(bucket, parent):
            raise FSError(ENOENT, f"parent of {path!r}")
        try:
            await self.gw.put_object(bucket, key + "/", b"")
        except RGWError as e:
            raise FSError(EINVAL, str(e))

    async def rmdir(self, path: str) -> None:
        bucket, key = _split(path)
        if bucket is None:
            raise FSError(EINVAL, "cannot remove /")
        if not key:
            try:
                await self.gw.delete_bucket(bucket)
            except RGWError as e:
                raise FSError(
                    ENOTEMPTY if e.code == "BucketNotEmpty"
                    else ENOENT, str(e))
            return
        st = await self.getattr(path)
        if st["type"] != "dir":
            raise FSError(ENOTDIR, path)
        out = await self.gw.list_objects(bucket, prefix=key + "/",
                                         max_keys=2)
        members = [k for k in (c["key"] for c in out["contents"])
                   if k != key + "/"] + list(
                       out.get("common_prefixes", ()))
        if members:
            raise FSError(ENOTEMPTY, path)
        try:
            await self.gw.delete_object(bucket, key + "/")
        except RGWError:
            pass                    # implicit dir: nothing to remove

    async def readdir(self, path: str = "/") -> dict[str, dict]:
        bucket, key = _split(path)
        out: dict[str, dict] = {}
        if bucket is None:
            for b in await self.gw.list_buckets():
                out[b] = {"type": "dir"}
            return out
        st = await self.getattr(path)
        if st["type"] != "dir":
            raise FSError(ENOTDIR, path)
        prefix = key + "/" if key else ""
        marker = ""
        while True:
            page = await self.gw.list_objects(
                bucket, prefix=prefix, delimiter="/", marker=marker)
            for cp in page.get("common_prefixes", ()):
                out[cp[len(prefix):].rstrip("/")] = {"type": "dir"}
            for c in page["contents"]:
                name = c["key"][len(prefix):]
                if not name:
                    continue        # the marker object itself
                out[name] = {"type": "file",
                             "size": int(c["size"]),
                             "mtime": float(c.get("mtime", 0))}
            if not page.get("is_truncated"):
                return out
            marker = page.get("next_marker") or (
                page["contents"][-1]["key"] if page["contents"]
                else "")

    # -- files ------------------------------------------------------------
    async def write(self, path: str, data: bytes,
                    offset: int | None = None) -> dict:
        """Whole-file PUT (offset None) or offset write via object-
        level RMW (rgw_file buffers + flushes whole objects too)."""
        bucket, key = _split(path)
        if bucket is None or not key:
            raise FSError(EISDIR, path)
        if await self._dir_exists(bucket, key):
            raise FSError(EISDIR, path)
        parent = key.rsplit("/", 1)[0] if "/" in key else ""
        if parent and not await self._dir_exists(bucket, parent):
            raise FSError(ENOENT, f"parent of {path!r}")
        if offset is not None:
            try:
                cur = (await self.gw.get_object(bucket, key))["data"]
            except RGWError:
                cur = b""
            buf = bytearray(max(len(cur), offset + len(data)))
            buf[:len(cur)] = cur
            buf[offset:offset + len(data)] = data
            data = bytes(buf)
        try:
            out = await self.gw.put_object(bucket, key, data)
        except RGWError as e:
            raise FSError(EINVAL, str(e))
        return {"size": int(out["size"]), "mtime": time.time()}

    async def read(self, path: str, offset: int = 0,
                   length: int | None = None) -> bytes:
        bucket, key = _split(path)
        if bucket is None or not key:
            raise FSError(EISDIR, path)
        try:
            if length is None:
                got = await self.gw.get_object(bucket, key)
                return got["data"][offset:]
            if length == 0:
                return b""
            got = await self.gw.get_object(
                bucket, key, range_=(offset, offset + length - 1))
            return got["data"]
        except RGWError as e:
            raise FSError(ENOENT, str(e))

    async def unlink(self, path: str) -> None:
        bucket, key = _split(path)
        if bucket is None or not key:
            raise FSError(EISDIR, path)
        st = await self.getattr(path)
        if st["type"] == "dir":
            raise FSError(EISDIR, path)
        try:
            await self.gw.delete_object(bucket, key)
        except RGWError as e:
            raise FSError(ENOENT, str(e))

    async def rename(self, src: str, dst: str) -> None:
        """Copy + unlink (the reference's rgw_rename over immutable
        S3 objects).  Directory renames copy every member key."""
        sb, sk = _split(src)
        db, dk = _split(dst)
        if sb is None or db is None:
            raise FSError(EINVAL, "cannot rename /")
        st = await self.getattr(src)
        await self.getattr(f"/{db}")     # dst bucket must exist
        try:
            if st["type"] == "file":
                if not dk:
                    raise FSError(EISDIR, dst)
                try:
                    dstat = await self.getattr(dst)
                    if dstat["type"] == "dir":
                        raise FSError(EISDIR, dst)
                except FSError as e:
                    if e.errno != ENOENT:
                        raise
                await self.gw.copy_object(sb, sk, db, dk)
                await self.gw.delete_object(sb, sk)
                return
            if not sk:
                raise FSError(EINVAL, "cannot rename a bucket")
            if db == sb and dk == sk:
                return     # POSIX: rename to itself is a no-op (the
                           # copy+delete loop would destroy the tree)
            if db == sb and dk.startswith(sk + "/"):
                # POSIX EINVAL: a directory cannot become a
                # descendant of itself — the member copy loop would
                # chase keys it is creating and leave a half-moved
                # tree on both sides of the prefix
                raise FSError(EINVAL,
                              f"cannot move {src} into its own "
                              f"subtree {dst}")
            # directory: move every member, paginated — a truncated
            # listing would silently split the tree across src and dst
            dprefix = (dk + "/") if dk else ""
            members: list[str] = []
            marker = ""
            while True:
                page = await self.gw.list_objects(
                    sb, prefix=sk + "/", marker=marker)
                members.extend(c["key"] for c in page["contents"])
                if not page.get("is_truncated"):
                    break
                marker = page.get("next_marker") or members[-1]
            for k in members:
                rest = k[len(sk) + 1:]
                if not rest and not dk:
                    continue   # bucket-root destination needs no
                               # marker (an empty key would be
                               # unaddressable orphaned storage)
                await self.gw.copy_object(sb, k, db,
                                          dprefix + rest
                                          if rest else dprefix)
            for k in members:
                await self.gw.delete_object(sb, k)
        except RGWError as e:
            # keep the module's FSError contract for FSAL callers
            raise FSError(
                ENOENT if e.code in ("NoSuchBucket", "NoSuchKey")
                else EINVAL, str(e))

    async def statfs(self) -> dict:
        """Aggregate usage across visible buckets (rgw_statfs)."""
        files = bytes_ = 0
        for b in await self.gw.list_buckets():
            marker = ""
            while True:
                page = await self.gw.list_objects(b, marker=marker)
                for c in page["contents"]:
                    files += 1
                    bytes_ += int(c["size"])
                if not page.get("is_truncated"):
                    break
                marker = page["contents"][-1]["key"]
        return {"files": files, "bytes": bytes_}
