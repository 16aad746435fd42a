"""CephFS-lite client: the libcephfs role.

Counterpart of ceph_tpu/client/fs.py: the same module over the
port's imports.

Reference src/client/Client.cc + include/cephfs/libcephfs.h reduced to
the -lite essentials: path resolution walks dentries via MDS lookups
with client-side lease caching (the read side of the caps model);
metadata mutations are MDS round-trips; FILE DATA is read/written
directly against the data pool (``<ino:x>.<blockno:08x>`` objects) —
the MDS never touches data. Open files buffer size/mtime and flush them
to the MDS on close/fsync (the Fc/Fw cap-flush reduced to
setattr-on-close).
"""

from __future__ import annotations

import asyncio
import time

from ceph_tpu_torch.client.rados import IoCtx, ObjectOperation, Rados, RadosError
from ceph_tpu_torch.mds.daemon import (
    EEXIST,
    EINVAL,
    EISDIR,
    ELOOP,
    ENOENT,
    ENOTDIR,
    EROFS,
    block_oid,
)
from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.msg.messenger import Connection


class FSError(IOError):
    def __init__(self, rc: int, msg: str = ""):
        super().__init__(f"rc={rc} {msg}")
        self.rc = rc


class FileHandle:
    """An open file (Fh): direct data IO + deferred attr flush.

    With the exclusive write cap (``capped``, the Fw/Fb slice of the
    reference cap model) writes BUFFER client-side per block and flush
    on fsync/close/recall — the MDS recalls the cap when any other
    client opens the file, so readers see flushed bytes.  Without it,
    writes go straight to RADOS (write-through)."""

    def __init__(self, fs: "CephFS", parent: int, name: str,
                 dentry: dict, snapid: int = 0,
                 capped: bool = False):
        self.fs = fs
        self.parent = parent
        self.name = name
        self.ino = int(dentry["ino"])
        self.size = int(dentry.get("size", 0))
        self.snapid = snapid        # >0: read-only snapshot view
        self._dirty = False
        self._closed = False
        self._cap = capped
        self._buf: dict[int, bytearray] = {}   # blockno -> content
        # serializes buffer mutation against recall-driven flushes: a
        # write suspended in a block load must not slip its insert in
        # after the recall already flushed-and-cleared
        self._buf_lock = asyncio.Lock()

    # -- data path (never touches the MDS) -----------------------------
    def _extents(self, offset: int, length: int):
        bs = self.fs.block_size
        pos = offset
        end = offset + length
        while pos < end:
            blockno = pos // bs
            off = pos % bs
            run = min(bs - off, end - pos)
            yield blockno, off, run
            pos += run

    async def write(self, data: bytes, offset: int | None = None) -> int:
        if self._closed:
            raise FSError(EINVAL, "closed")
        if self.snapid:
            raise FSError(EROFS, "snapshots are read-only")
        if offset is None:
            offset = self.size
        buffered = False
        if self._cap:
            async with self._buf_lock:
                if self._cap:     # re-check: a recall may have won
                    buffered = True
                    pos = 0
                    for blockno, off, run in self._extents(
                            offset, len(data)):
                        blk = await self._load_block(blockno)
                        if len(blk) < off + run:
                            blk.extend(b"\x00" * (off + run
                                                  - len(blk)))
                        blk[off:off + run] = data[pos:pos + run]
                        pos += run
        if not buffered:
            pos = 0
            for blockno, off, run in self._extents(offset, len(data)):
                await self.fs.data.write(block_oid(self.ino, blockno),
                                         data[pos:pos + run], off)
                pos += run
        self.size = max(self.size, offset + len(data))
        self._dirty = True
        return len(data)

    async def _load_block(self, blockno: int) -> bytearray:
        blk = self._buf.get(blockno)
        if blk is None:
            try:
                blk = bytearray(await self.fs.data.read(
                    block_oid(self.ino, blockno)))
            except RadosError as e:
                if e.rc != ENOENT:
                    raise
                blk = bytearray()
            self._buf[blockno] = blk
        return blk

    async def _flush_buffer(self) -> None:
        async with self._buf_lock:
            for blockno in sorted(self._buf):
                await self.fs.data.write_full(
                    block_oid(self.ino, blockno),
                    bytes(self._buf[blockno]))
            self._buf.clear()

    async def read(self, length: int | None = None,
                   offset: int = 0) -> bytes:
        if length is None:
            length = self.size - offset
        length = max(0, min(length, self.size - offset))
        out = bytearray(length)
        pos = 0
        data_io = (await self.fs._snap_data(self.snapid)
                   if self.snapid else self.fs.data)
        for blockno, off, run in self._extents(offset, length):
            if blockno in self._buf:
                frag = bytes(self._buf[blockno][off:off + run])
            else:
                try:
                    frag = await data_io.read(
                        block_oid(self.ino, blockno), run, off
                    )
                except RadosError as e:
                    if e.rc != ENOENT:
                        raise
                    frag = b""          # sparse block reads as zeros
            out[pos:pos + len(frag)] = frag
            pos += run
        return bytes(out)

    async def truncate(self, size: int) -> None:
        if self.snapid:
            raise FSError(EROFS, "snapshots are read-only")
        await self._flush_buffer()      # buffered blocks first
        bs = self.fs.block_size
        if size < self.size:
            first_dead = -(-size // bs)
            last = -(-self.size // bs)
            for blockno in range(first_dead, last):
                try:
                    await self.fs.data.remove(block_oid(self.ino,
                                                        blockno))
                except RadosError as e:
                    if e.rc != ENOENT:
                        raise
            boundary = size % bs
            if boundary:
                try:
                    await self.fs.data.truncate(
                        block_oid(self.ino, size // bs), boundary
                    )
                except RadosError as e:
                    if e.rc != ENOENT:
                        raise
        self.size = size
        self._dirty = True

    async def fsync(self) -> None:
        """Flush buffered blocks, then buffered attrs (cap flush)."""
        await self._flush_buffer()
        if self._dirty:
            await self.fs._request("setattr", parent=self.parent,
                                   name=self.name, size=self.size,
                                   mtime=time.time())
            self._dirty = False
            self.fs._invalidate_ino(self.ino)
            self.fs._invalidate(self.parent, self.name)

    async def close(self) -> None:
        if not self._closed:
            await self.fsync()
            self._closed = True
            if self._cap:
                self._cap = False
                siblings = self.fs._open_caps.get(self.ino)
                if siblings is not None:
                    siblings.discard(self)
                    if siblings:
                        return    # another handle still uses the cap
                    self.fs._open_caps.pop(self.ino, None)
                try:
                    await self.fs._request("release_cap",
                                           parent=self.parent,
                                           name=self.name,
                                           ino=self.ino)
                except FSError:
                    pass          # MDS revoked/restarted: same end


class CephFS:
    """A mounted filesystem (ceph_mount)."""

    @classmethod
    async def connect(cls, rados: Rados, fs_name: str = "cephfs",
                   timeout: float = 10.0) -> "CephFS":
        """Discover the active MDS from the monitor's FSMap (``mds
        stat``) instead of a hardcoded address (the reference client's
        mdsmap subscription role)."""
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            r = await rados.mon_command("mds stat")
            if r["rc"] not in (0, -11):
                # only EAGAIN (no quorum yet) is transient; a cap
                # denial or unknown command must surface, not time out
                raise FSError(r["rc"], r["outs"])
            active = None
            if r["rc"] == 0:
                active = (r["data"]["filesystems"]
                          .get(fs_name, {}).get("active"))
            if active is not None:
                return cls(rados, active["addr"], fs_name=fs_name)
            if asyncio.get_running_loop().time() > deadline:
                raise FSError(
                    -110, f"no active mds for fs {fs_name!r}"
                )
            await asyncio.sleep(0.1)

    def __init__(self, rados: Rados, mds_addr: str,
                 fs_name: str = "cephfs"):
        self.rados = rados
        self.mds_addr = mds_addr
        self.fs_name = fs_name
        # rank -> address (multi-active; refreshed from mds stat on a
        # redirect to a rank we do not know yet)
        self._rank_addrs: dict[int, str] = {0: mds_addr}
        # rank -> snapids from that rank's last reply: each rank only
        # knows its own realms, so the data-pool snap context is the
        # UNION — a snap-unaware rank's reply must not regress it and
        # un-COW another rank's live snapshot
        self._snapc_by_rank: dict[int, set[int]] = {}
        self.root = 1
        self.block_size = 1 << 22
        self.data: IoCtx | None = None
        self.lease_ttl = 2.0
        self._futs: dict[int, asyncio.Future] = {}
        # (parent_ino, name) -> (dentry, lease expiry): the dentry lease
        # cache (Client::Dentry + lease_ttl role)
        self._dcache: dict[tuple[int, str], tuple[dict, float]] = {}
        self._snap_ioctx: dict[int, IoCtx] = {}
        # ino -> set of local FileHandles sharing the conn's exclusive
        # write cap (the MDS grant is per-session; the cap releases
        # only when the LAST handle closes)
        self._open_caps: dict[int, set] = {}
        self._mounted = False
        # session-unique tid space: two mounts sharing one rados
        # messenger must never mistake each other's replies
        import secrets as _secrets

        self._tid = _secrets.randbits(40) << 20
        # ride the rados client's messenger: register our reply hook,
        # CHAINING to whatever dispatcher is already installed (an
        # earlier CephFS mount or the rados client itself) so stacked
        # mounts on one handle all keep receiving their traffic
        self._prev_dispatcher = getattr(rados.msgr, "dispatcher",
                                        None) or rados
        self._orig_dispatch = self._prev_dispatcher.ms_dispatch
        rados.msgr.set_dispatcher(self)

    # -- dispatcher chaining ----------------------------------------------
    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        if msg.type == "cap_recall":
            asyncio.get_running_loop().create_task(
                self._handle_cap_recall(conn,
                                        int(msg.data.get("ino", 0))))
            return
        if msg.type == "mds_reply":
            tid = int(msg.data.get("tid", 0))
            fut = self._futs.pop(tid, None)
            if fut is not None and not fut.done():
                fut.set_result(msg.data)
                return
            if fut is None and isinstance(self._prev_dispatcher,
                                          CephFS):
                # not ours: a stacked earlier mount may own this tid
                await self._orig_dispatch(conn, msg)
            return
        await self._orig_dispatch(conn, msg)

    async def _handle_cap_recall(self, conn: Connection,
                                 ino: int) -> None:
        """The MDS wants the write cap back: degrade every local
        handle to write-through FIRST (so racing writes stop
        buffering), then flush blocks and attrs, then ack."""
        for fh in self._open_caps.pop(ino, ()):
            fh._cap = False
            try:
                await fh.fsync()
            except (FSError, RadosError):
                pass              # revocation proceeds regardless
        try:
            conn.send_message(Message("cap_release", {"ino": ino}))
        except ConnectionError:
            pass

    def ms_handle_reset(self, conn: Connection) -> None:
        self.rados.ms_handle_reset(conn)

    def ms_handle_connect(self, conn: Connection) -> None:
        pass

    # -- mount / requests --------------------------------------------------
    async def mount(self, timeout: float = 20.0) -> None:
        reply = await self._request("session", timeout=timeout)
        self.root = int(reply["root"])
        self.block_size = int(reply["block_size"])
        self.lease_ttl = float(reply.get("lease", 2.0))
        self.data = await self.rados.open_ioctx(reply["data_pool"])
        self._mounted = True

    async def unmount(self) -> None:
        self._mounted = False
        if getattr(self.rados.msgr, "dispatcher", None) is self:
            # restore the dispatcher BELOW us; an unmount out of stack
            # order leaves our (inert, forwarding) hook in place
            # rather than cutting a still-live mount out of the chain
            self.rados.msgr.set_dispatcher(self._prev_dispatcher)

    async def _addr_for_rank(self, rank: int) -> str:
        addr = self._rank_addrs.get(rank)
        if addr is not None:
            return addr
        r = await self.rados.mon_command("mds stat")
        if r["rc"] == 0:
            for a in (r["data"]["filesystems"]
                      .get(self.fs_name, {}).get("actives", ())):
                self._rank_addrs[int(a["rank"])] = str(a["addr"])
        addr = self._rank_addrs.get(rank)
        if addr is None:
            raise FSError(-110, f"no active mds for rank {rank}")
        return addr

    async def _request(self, op: str, timeout: float = 30.0,
                       _addr: str | None = None, **args) -> dict:
        rank = 0
        for _hop in range(6):
            self._tid += 1
            tid = self._tid
            fut = asyncio.get_running_loop().create_future()
            self._futs[tid] = fut
            payload = {"tid": tid, "op": op, **args}
            if _hop >= 2:
                # ping-ponging between ranks: tell the server to skip
                # its subtree-map refresh throttle (a fresh export is
                # still propagating)
                payload["refresh_subtrees"] = True
            try:
                await self.rados.msgr.send_to(
                    _addr or self.mds_addr,
                    Message("mds_request", payload),
                    "mds.x",
                )
                reply = await asyncio.wait_for(fut, timeout)
            except (ConnectionError, asyncio.TimeoutError) as e:
                self._futs.pop(tid, None)
                if rank != 0 and _hop < 3:
                    # the redirected-to rank may have failed over to a
                    # new address: drop the cached addr and re-resolve
                    # from the fsmap before giving up
                    stale = self._rank_addrs.pop(rank, None)
                    try:
                        _addr = await self._addr_for_rank(rank)
                    except FSError:
                        raise FSError(-110,
                                      f"mds request {op}: {e}") from e
                    if _addr != stale:
                        continue
                raise FSError(-110, f"mds request {op}: {e}") from e
            if "redirect_rank" in reply:
                # the directory lives in another rank's subtree: retry
                # there (Client follows the mdsmap the same way)
                rank = int(reply["redirect_rank"])
                if _hop >= 2:
                    # ping-pong: either our cached addr is stale
                    # (failover) or the MDSs' subtree maps are still
                    # propagating a fresh export — refresh the addr and
                    # give their refresh throttles a beat
                    self._rank_addrs.pop(rank, None)
                    await asyncio.sleep(0.4)
                _addr = await self._addr_for_rank(rank)
                continue
            break
        if reply["rc"] != 0:
            raise FSError(reply["rc"], reply.get("err", op))
        snapc = reply.get("snapc")
        if snapc and self.data is not None:
            self._snapc_by_rank[rank] = {
                int(x) for x in snapc.get("snaps", ())}
            union = sorted(set().union(*self._snapc_by_rank.values()))
            self.data.set_snap_context(max(union, default=0), union)
        return reply

    # -- path walking ------------------------------------------------------
    def _invalidate(self, parent: int, name: str) -> None:
        self._dcache.pop((parent, name, 0), None)

    def _invalidate_ino(self, ino: int) -> None:
        """Drop every cached dentry of this inode: hard links give one
        inode several (parent, name) cache slots, and an attr flush
        through one name must not leave the others serving stale size."""
        for key in [k for k, v in self._dcache.items()
                    if int(v[0].get("ino", 0)) == ino]:
            self._dcache.pop(key, None)

    async def _lookup(self, parent: int, name: str,
                      snapid: int = 0) -> dict:
        cached = self._dcache.get((parent, name, snapid))
        if cached is not None and cached[1] > time.monotonic():
            return cached[0]
        reply = await self._request("lookup", parent=parent, name=name,
                                    snapid=snapid)
        dentry = reply["dentry"]
        self._dcache[(parent, name, snapid)] = (
            dentry, time.monotonic() + float(reply.get("lease", 0)),
        )
        return dentry

    @staticmethod
    def _split(path: str) -> list[str]:
        return [p for p in path.strip("/").split("/") if p]

    _MAX_SYMLINKS = 10             # ELOOP bound (SYMLOOP_MAX role)

    @staticmethod
    def _normalize(parts: list[str]) -> list[str]:
        """Lexical '.'/'..' collapse ('..' above root stays at root) —
        the MDS stores no dot dentries, so joins must resolve them."""
        out: list[str] = []
        for p in parts:
            if p == "." or not p:
                continue
            if p == "..":
                if out:
                    out.pop()
                continue
            out.append(p)
        return out

    @classmethod
    def _join_link(cls, base_parts: list[str], target: str,
                   rest: list[str]) -> str:
        """New path after substituting a symlink target: absolute
        targets restart at root, relative ones join the link's own
        directory; '.'/'..' collapse lexically."""
        if target.startswith("/"):
            parts = target.split("/") + rest
        else:
            parts = list(base_parts) + target.split("/") + rest
        return "/" + "/".join(cls._normalize(parts))

    async def _resolve_parent(self, path: str) -> tuple[int, str]:
        """Walk to the parent of ``path``; returns (parent_ino, name).
        Symlinks in intermediate components are followed."""
        parts = self._split(path)
        if not parts:
            raise FSError(EINVAL, "root has no parent")
        if len(parts) == 1:
            return self.root, parts[0]
        dirent = await self._resolve("/" + "/".join(parts[:-1]))
        if dirent["type"] != "dir":
            raise FSError(ENOTDIR, f"{path!r}: not a directory")
        return int(dirent["ino"]), parts[-1]

    async def _resolve(self, path: str, follow: bool = True,
                       _depth: int | None = None) -> dict:
        """Path walk with symlink traversal (Client::path_walk role):
        intermediate symlinks always follow; the FINAL component
        follows only when ``follow`` (stat vs lstat semantics)."""
        depth = self._MAX_SYMLINKS if _depth is None else _depth
        parts = self._split(path)
        if not parts:
            return {"ino": self.root, "type": "dir", "mode": 0o755,
                    "size": 0, "mtime": 0.0}
        ino = self.root
        snapid = 0
        i = 0
        while i < len(parts):
            part = parts[i]
            if part == ".snap":
                # entering the snapshot namespace of the CURRENT dir
                # (the CephFS .snap pseudo-directory): the next
                # component names the snapshot; everything after
                # resolves against the frozen dirfrags
                if snapid:
                    raise FSError(EINVAL, ".snap inside a snapshot")
                if i + 1 >= len(parts):
                    return {"ino": ino, "type": "dir", "mode": 0o555,
                            "size": 0, "mtime": 0.0, "snapdir": True,
                            "snap_of": ino}
                reply = await self._request("lssnap", ino=ino)
                info = reply["snaps"].get(parts[i + 1])
                if info is None:
                    raise FSError(ENOENT,
                                  f"no snapshot {parts[i + 1]!r}")
                snapid = int(info["snapid"])
                if i + 1 == len(parts) - 1:
                    return {"ino": ino, "type": "dir", "mode": 0o555,
                            "size": 0,
                            "mtime": float(info["created"]),
                            "snapid": snapid}
                i += 2
                continue
            dentry = await self._lookup(ino, part, snapid)
            last = i == len(parts) - 1
            if dentry["type"] == "symlink" and (follow or not last):
                if depth <= 0:
                    raise FSError(ELOOP, f"{path!r}: symlink loop")
                newpath = self._join_link(
                    parts[:i], str(dentry.get("target", "")),
                    parts[i + 1:],
                )
                return await self._resolve(newpath, follow,
                                           depth - 1)
            if not last:
                if dentry["type"] != "dir":
                    raise FSError(ENOTDIR,
                                  f"{part!r} is not a directory")
                ino = int(dentry["ino"])
            if snapid:
                dentry = {**dentry, "snapid": snapid}
            i += 1
        return dentry

    async def _snap_data(self, snapid: int) -> IoCtx:
        """A data-pool handle whose reads resolve at ``snapid``."""
        io = self._snap_ioctx.get(snapid)
        if io is None:
            io = await self.rados.open_ioctx(self.data.pool_name)
            io.snap_set_read(snapid)
            self._snap_ioctx[snapid] = io
        return io

    async def mksnap(self, path: str, name: str) -> int:
        """ceph_mksnap: snapshot the subtree at ``path`` (readable as
        ``path/.snap/name/...``)."""
        dentry = await self._resolve(path)
        if dentry["type"] != "dir":
            raise FSError(ENOTDIR, path)
        reply = await self._request("mksnap", ino=int(dentry["ino"]),
                                    name=name)
        return int(reply["snapid"])

    async def setquota(self, path: str, max_bytes: int = 0,
                       max_files: int = 0) -> dict:
        """Directory quota (the setfattr ceph.quota.max_bytes/
        max_files surface); both zero clears it."""
        dentry = await self._resolve(path)
        if dentry.get("type") != "dir":
            raise FSError(ENOTDIR, path)
        reply = await self._request("setquota",
                                    ino=int(dentry["ino"]),
                                    parent=int(dentry["ino"]),
                                    max_bytes=max_bytes,
                                    max_files=max_files)
        return reply["quota"]

    async def getquota(self, path: str) -> dict:
        dentry = await self._resolve(path)
        reply = await self._request("getquota",
                                    ino=int(dentry["ino"]),
                                    parent=int(dentry["ino"]))
        return {"quota": reply["quota"], "usage": reply.get("usage")}

    async def export_dir(self, path: str, rank: int) -> None:
        """Delegate the subtree at ``path`` to another active MDS rank
        (the ``ceph mds export dir`` / Migrator role; operator API)."""
        dentry = await self._resolve(path)
        if dentry["type"] != "dir":
            raise FSError(ENOTDIR, path)
        await self._request("export_dir", ino=int(dentry["ino"]),
                            rank=int(rank))
        self._dcache.clear()

    async def rmsnap(self, path: str, name: str) -> None:
        dentry = await self._resolve(path)
        await self._request("rmsnap", ino=int(dentry["ino"]),
                            name=name)

    async def listsnaps(self, path: str) -> dict[str, dict]:
        dentry = await self._resolve(path)
        reply = await self._request("lssnap", ino=int(dentry["ino"]))
        return reply["snaps"]

    # -- the libcephfs-shaped surface --------------------------------------
    async def mkdir(self, path: str, mode: int = 0o755) -> None:
        parent, name = await self._resolve_parent(path)
        await self._request("mkdir", parent=parent, name=name, mode=mode)
        self._invalidate(parent, name)

    async def mkdirs(self, path: str, mode: int = 0o755) -> None:
        built = ""
        for part in self._split(path):
            built += "/" + part
            try:
                await self.mkdir(built, mode)
            except FSError as e:
                if e.rc != EEXIST:
                    raise

    async def rmdir(self, path: str) -> None:
        parent, name = await self._resolve_parent(path)
        await self._request("rmdir", parent=parent, name=name)
        self._invalidate(parent, name)

    async def readdir(self, path: str = "/") -> dict[str, dict]:
        dentry = await self._resolve(path)
        if dentry["type"] != "dir":
            raise FSError(ENOTDIR, path)
        if dentry.get("snapdir"):
            reply = await self._request("lssnap",
                                        ino=int(dentry["snap_of"]))
            return {name: {"ino": dentry["snap_of"], "type": "dir",
                           "mode": 0o555, "size": 0,
                           "mtime": float(info["created"])}
                    for name, info in reply["snaps"].items()}
        reply = await self._request("readdir", ino=int(dentry["ino"]),
                                    snapid=int(dentry.get("snapid",
                                                          0)))
        return reply["entries"]

    async def stat(self, path: str) -> dict:
        return dict(await self._resolve(path))

    async def lstat(self, path: str) -> dict:
        """Like stat but does not follow a final-component symlink."""
        return dict(await self._resolve(path, follow=False))

    async def symlink(self, target: str, linkpath: str) -> None:
        """ceph_symlink: create a symbolic link at ``linkpath``."""
        parent, name = await self._resolve_parent(linkpath)
        await self._request("symlink", parent=parent, name=name,
                            target=target)
        self._invalidate(parent, name)

    async def readlink(self, path: str) -> str:
        dentry = await self._resolve(path, follow=False)
        if dentry["type"] != "symlink":
            raise FSError(EINVAL, f"{path!r} is not a symlink")
        return str(dentry.get("target", ""))

    async def open(self, path: str, flags: str = "r",
                   mode: int = 0o644) -> FileHandle:
        """flags: 'r' read, 'w' create+truncate, 'a' create+append,
        'x' exclusive create."""
        if ".snap" in self._split(path):
            dentry = await self._resolve(path)
            if not dentry.get("snapid"):
                raise FSError(EISDIR, path)
            if flags != "r":
                raise FSError(EROFS, "snapshots are read-only")
            if dentry["type"] == "dir":
                raise FSError(EISDIR, path)
            return FileHandle(self, 0, "", dentry,
                              snapid=int(dentry["snapid"]))
        parent, name = await self._resolve_parent(path)
        if flags in ("w", "a"):
            # POSIX open(O_CREAT) follows an existing final symlink:
            # the create/truncate lands on the TARGET, never on the
            # link's own inode ('x' keeps EEXIST via the MDS)
            try:
                existing = await self._lookup(parent, name)
            except FSError as e:
                if e.rc != ENOENT:
                    raise
                existing = None
            cpath = path
            if existing is not None \
                    and existing["type"] == "symlink":
                cpath, parent, name, _ = await self._follow_link_path(
                    path, existing
                )
        if flags in ("w", "a", "x"):
            for _ in range(3):
                try:
                    reply = await self._request(
                        "create", parent=parent, name=name, mode=mode,
                        exclusive=flags == "x", want_cap=True,
                    )
                    break
                except FSError as e:
                    # ELOOP: a symlink appeared at the name between our
                    # lookup and the create (the MDS refuses to hand a
                    # link dentry out as a file) — re-resolve + retry
                    if e.rc != ELOOP:
                        raise
                    self._invalidate(parent, name)
                    dentry = await self._lookup(parent, name)
                    # the retry's relative-target base is the path we
                    # FOLLOWED to, not the original user path
                    cpath, parent, name, _ = \
                        await self._follow_link_path(cpath, dentry)
            else:
                raise FSError(ELOOP, f"{path!r}: create/symlink race")
            self._invalidate(parent, name)
            capped = reply.get("cap") == "w"    # piggybacked grant
            dentry = reply["dentry"]
            if not capped:
                # contended (another session holds the cap): the
                # explicit open_file can wait for the recall
                try:
                    cap = await self._request(
                        "open_file", parent=parent, name=name,
                        write=True)
                    capped = cap.get("cap") == "w"
                    # post-recall attrs: the evicted holder's flush
                    # may have grown the file past the create reply
                    dentry = dict(cap.get("dentry", dentry))
                except FSError:
                    pass          # cap-less open still works
            fh = FileHandle(self, parent, name, dentry,
                            capped=capped)
            if capped:
                ino = fh.ino
                # register BEFORE the sibling awaits: a recall landing
                # mid-flush then clears this handle's cap too, instead
                # of leaving it buffering against a revoked grant
                siblings = self._open_caps.setdefault(ino, set())
                others = [s for s in siblings if s is not fh]
                siblings.add(fh)
                for sib in others:
                    # share the grant's view: the new handle must see
                    # the siblings' buffered bytes
                    await sib.fsync()
                    fh.size = max(fh.size, sib.size)
                if fh not in self._open_caps.get(ino, ()):
                    fh._cap = False   # recalled while we flushed
            if flags == "w" and fh.size:
                await fh.truncate(0)
            return fh
        dentry = await self._lookup(parent, name)
        if dentry["type"] == "symlink":
            # read-open follows the link chain; the REAL file's
            # (parent, name) is kept so attr flushes (fsync/close)
            # land on the target dentry, not the link's
            resolved, parent, name, dentry = \
                await self._follow_link_path(path, dentry)
            if dentry is None:
                raise FSError(ENOENT, resolved)
        if dentry["type"] == "dir":
            raise FSError(EISDIR, path)
        ino = int(dentry["ino"])
        if ino in self._open_caps:
            # OUR session holds the cap: flush locally (no recall —
            # the MDS skips holders' own connections) so this read
            # handle sees the buffered bytes and true size
            for sib in list(self._open_caps[ino]):
                await sib.fsync()
                dentry = {**dentry,
                          "size": max(int(dentry.get("size", 0)),
                                      sib.size)}
        elif dentry.get("cap_held"):
            # another session may hold a write cap (flag rides the
            # cached dentry): pay the recall round-trip; uncapped
            # files skip it entirely
            try:
                cap = await self._request("open_file", parent=parent,
                                          name=name, write=False)
                dentry = dict(cap.get("dentry", dentry))
                self._invalidate(parent, name)
            except FSError:
                pass
        return FileHandle(self, parent, name, dentry)

    async def _follow_link_path(
        self, path: str, dentry: dict
    ) -> tuple[str, int, str, dict | None]:
        """Resolve a symlink dentry at ``path`` to its FINAL non-link
        location (chains bounded like _resolve).  Returns (path,
        parent_ino, name, dentry-or-None); a None dentry means the
        final target is dangling — creating through it creates the
        TARGET (POSIX O_CREAT-through-symlink)."""
        hops = self._MAX_SYMLINKS
        cur_path = path
        parent, name = await self._resolve_parent(path)
        while dentry["type"] == "symlink":
            if hops <= 0:
                raise FSError(ELOOP, f"{path!r}: symlink loop")
            hops -= 1
            cur_path = self._join_link(
                self._split(cur_path)[:-1],
                str(dentry.get("target", "")), [],
            )
            parent, name = await self._resolve_parent(cur_path)
            try:
                dentry = await self._lookup(parent, name)
            except FSError as e:
                if e.rc == ENOENT:
                    return cur_path, parent, name, None
                raise
        return cur_path, parent, name, dentry

    async def link(self, src: str, dst: str) -> None:
        """ceph_link: hard link — ``dst`` becomes another name for
        ``src``'s inode (symlinks in ``src`` are followed)."""
        sparent, sname = await self._resolve_parent(src)
        sdentry = await self._lookup(sparent, sname)
        if sdentry["type"] == "symlink":
            _, sparent, sname, sdentry = await self._follow_link_path(
                src, sdentry)
            if sdentry is None:
                raise FSError(ENOENT, src)
        dparent, dname = await self._resolve_parent(dst)
        await self._request("link", src_parent=sparent, src_name=sname,
                            parent=dparent, name=dname)
        self._invalidate_ino(int(sdentry["ino"]))
        self._invalidate(sparent, sname)
        self._invalidate(dparent, dname)

    async def unlink(self, path: str) -> None:
        parent, name = await self._resolve_parent(path)
        reply = await self._request("unlink", parent=parent, name=name)
        self._invalidate_ino(int(reply.get("ino", 0)))
        self._invalidate(parent, name)

    async def rename(self, src: str, dst: str) -> None:
        sp, sn = await self._resolve_parent(src)
        dp, dn = await self._resolve_parent(dst)
        reply = await self._request("rename", src_parent=sp,
                                    src_name=sn, dst_parent=dp,
                                    dst_name=dn)
        # a clobbered hardlinked dst changed its inode's nlink: drop
        # every cached name of that inode, not just the two renamed
        self._invalidate_ino(int(reply.get("unlinked_ino", 0) or 0))
        self._invalidate(sp, sn)
        self._invalidate(dp, dn)

    # -- convenience (ceph_write_file-style helpers) -----------------------
    async def write_file(self, path: str, data: bytes) -> None:
        fh = await self.open(path, "w")
        await fh.write(data, 0)
        await fh.close()

    async def read_file(self, path: str) -> bytes:
        fh = await self.open(path, "r")
        try:
            return await fh.read()
        finally:
            await fh.close()
