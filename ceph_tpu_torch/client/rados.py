"""Rados / IoCtx: the librados-shaped client API.

Counterpart of ceph_tpu/client/rados.py: the same module over the
port's imports.

Mirrors the reference's librados surface (src/include/rados/librados.h C
API names; src/librados/librados_cxx.cc semantics) as asyncio-native
methods: a ``Rados`` cluster handle (connect/shutdown/commands/pools) and
per-pool ``IoCtx`` IO contexts (write/read/append/stat/remove, xattrs,
omap, multi-op ObjectOperation batches, watch/notify, object listing).
Cited reference paths: rados_write librados_c.cc:1174; IoCtx::write
librados_cxx.cc:1238; IoCtxImpl::operate IoCtxImpl.cc:645 ->
objecter->op_submit :672.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
from typing import Awaitable, Callable

from ceph_tpu_torch.common.config import ConfigProxy
from ceph_tpu_torch.client.objecter import LingerOp, Objecter, ObjecterError
from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.msg.messenger import Connection, Messenger, Policy


class RadosError(IOError):
    def __init__(self, rc: int, msg: str = ""):
        super().__init__(f"rc={rc} {msg}")
        self.rc = rc


def _check(reply: dict, what: str) -> dict:
    if reply["rc"] != 0:
        raise RadosError(reply["rc"], f"{what}: {reply.get('outs', '')}")
    return reply


# CEPH_OSD_FLAG_FULL_TRY analog: ops issued while this is set carry a
# "full_try" wire flag and the OSD lets them through a FULL_QUOTA pool
# (the reference flags delete-flow ops the same way so a full pool can
# still be emptied).  A contextvar, so one `with full_try():` covers an
# entire async delete flow — every nested await inherits it.
_FULL_TRY: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "rados_full_try", default=False
)


@contextlib.contextmanager
def full_try():
    """All ops issued inside carry CEPH_OSD_FLAG_FULL_TRY semantics."""
    tok = _FULL_TRY.set(True)
    try:
        yield
    finally:
        _FULL_TRY.reset(tok)


# tenant/QoS class stamp: ops issued inside `with op_class("gold"):`
# carry a "qclass" field the OSD routes into per-class latency
# histograms (op_class_<label>_latency_us) — the attribution the
# mgr's per-class SLO burn pairs are computed from.  Same contextvar
# shape as full_try: one `with` covers an entire async flow.
_OP_CLASS: contextvars.ContextVar[str] = contextvars.ContextVar(
    "rados_op_class", default=""
)


@contextlib.contextmanager
def op_class(label: str):
    """All ops issued inside are stamped with tenant class ``label``."""
    tok = _OP_CLASS.set(str(label))
    try:
        yield
    finally:
        _OP_CLASS.reset(tok)


class ObjectOperation:
    """Batched multi-op (librados ObjectWriteOperation/ReadOperation)."""

    def __init__(self):
        self.ops: list[dict] = []

    def write(self, data: bytes, offset: int = 0) -> "ObjectOperation":
        self.ops.append({"op": "write", "off": offset,
                         "data": bytes(data)})
        return self

    def write_full(self, data: bytes) -> "ObjectOperation":
        self.ops.append({"op": "writefull", "data": bytes(data)})
        return self

    def append(self, data: bytes) -> "ObjectOperation":
        self.ops.append({"op": "append", "data": bytes(data)})
        return self

    def truncate(self, size: int) -> "ObjectOperation":
        self.ops.append({"op": "truncate", "size": size})
        return self

    def create(self, exclusive: bool = False) -> "ObjectOperation":
        self.ops.append({"op": "create", "exclusive": exclusive})
        return self

    def remove(self) -> "ObjectOperation":
        self.ops.append({"op": "remove"})
        return self

    def read(self, offset: int = 0,
             length: int | None = None) -> "ObjectOperation":
        self.ops.append({"op": "read", "off": offset, "len": length})
        return self

    def stat(self) -> "ObjectOperation":
        self.ops.append({"op": "stat"})
        return self

    def set_xattr(self, name: str, value: bytes) -> "ObjectOperation":
        self.ops.append({"op": "setxattr", "name": name,
                         "value": bytes(value)})
        return self

    def get_xattr(self, name: str) -> "ObjectOperation":
        self.ops.append({"op": "getxattr", "name": name})
        return self

    def get_xattrs(self) -> "ObjectOperation":
        self.ops.append({"op": "getxattrs"})
        return self

    def rm_xattr(self, name: str) -> "ObjectOperation":
        self.ops.append({"op": "rmxattr", "name": name})
        return self

    def omap_set(self, kv: dict[str, bytes]) -> "ObjectOperation":
        self.ops.append({"op": "omap_set",
                         "kv": {k: bytes(v) for k, v in kv.items()}})
        return self

    def omap_get(self, keys: list[str] | None = None) -> "ObjectOperation":
        self.ops.append({"op": "omap_get", "keys": keys})
        return self

    def omap_rm(self, keys: list[str]) -> "ObjectOperation":
        self.ops.append({"op": "omap_rm", "keys": list(keys)})
        return self

    def call(self, cls: str, method: str,
             indata: bytes = b"") -> "ObjectOperation":
        self.ops.append({"op": "call", "cls": cls, "method": method,
                         "in": bytes(indata)})
        return self


class Rados:
    """Cluster handle (librados rados_t / Rados)."""

    def __init__(self, monmap: dict[str, str],
                 conf: ConfigProxy | None = None,
                 name: str = "client.admin"):
        self.conf = conf or ConfigProxy()
        self.name = name
        self.msgr = Messenger(name, self.conf)
        # "entity:nonce" — the OSDMap blocklist key for THIS instance
        self.instance_id = f"{name}:{self.msgr.nonce}"
        self.msgr.set_policy("mon", Policy.lossy_client())
        self.msgr.set_policy("osd", Policy.lossy_client())
        self.msgr.set_dispatcher(self)
        self.monc = MonClient(name, monmap, self.conf, msgr=self.msgr)
        self.objecter = Objecter(self.monc, self.msgr)
        self.monc.on_osdmap = self.objecter.on_map_change
        self._connected = False
        self._daemon_tid = 0
        self._daemon_futs: dict[int, asyncio.Future] = {}

    # -- dispatcher demux --------------------------------------------------
    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        if msg.type in ("perf_dump_reply", "dump_ops_reply",
                        "pg_scrub_reply", "dump_traces_reply",
                        "hit_set_ls_reply", "hit_set_contains_reply",
                        "ec_resident_stats_reply",
                        "ec_mesh_stats_reply",
                        "ec_repair_stats_reply",
                        "backfill_stats_reply",
                        "ec_scrub_stats_reply"):
            fut = self._daemon_futs.pop(int(msg.data.get("tid", 0)), None)
            if fut is not None and not fut.done():
                fut.set_result(msg.data)
            return
        if await self.objecter.handle_message(conn, msg):
            return
        await self.monc.ms_dispatch(conn, msg)

    def ms_handle_reset(self, conn: Connection) -> None:
        self.objecter.handle_reset(conn)
        self.monc.ms_handle_reset(conn)

    def ms_handle_connect(self, conn: Connection) -> None:
        pass

    # -- lifecycle ---------------------------------------------------------
    async def connect(self, timeout: float = 20.0) -> None:
        """rados_connect: mon session + map subscription."""
        await self.monc.start(timeout)
        self.monc.sub_want("osdmap")
        self.monc.sub_want("config")
        self.monc.renew_subs()
        await self.monc.wait_for_map(1, timeout)
        self._connected = True

    async def shutdown(self) -> None:
        self.objecter.shutdown()
        await self.monc.shutdown()
        await self.msgr.shutdown()
        self._connected = False

    # -- cluster ops -------------------------------------------------------
    async def mon_command(self, prefix: str, **args) -> dict:
        return await self.monc.command(prefix, **args)

    async def osd_daemon_command(self, osd_id: int, msg_type: str,
                                 timeout: float = 10.0,
                                 **args) -> dict:
        """Send an admin-socket-style request straight to an OSD (the
        `ceph daemon osd.N <cmd>` path): ``perf_dump``, ``dump_ops``,
        ``pg_scrub``."""
        m = self.monc.osdmap
        info = m.osds.get(osd_id) if m is not None else None
        if info is None or not info.up or not info.addr:
            raise RadosError(-2, f"osd.{osd_id} is not up")
        self._daemon_tid += 1
        tid = self._daemon_tid
        fut = asyncio.get_running_loop().create_future()
        self._daemon_futs[tid] = fut
        try:
            await self.msgr.send_to(
                info.addr, Message(msg_type, {"tid": tid, **args}),
                f"osd.{osd_id}",
            )
            return await asyncio.wait_for(fut, timeout)
        except (ConnectionError, asyncio.TimeoutError) as e:
            self._daemon_futs.pop(tid, None)
            raise RadosError(-110, f"daemon command: {e}") from e

    async def pg_scrub(self, pool_id: int, ps: int,
                       repair: bool = False,
                       timeout: float = 60.0) -> dict:
        """Scrub (or repair) one PG on its primary (`ceph pg scrub` /
        `ceph pg repair`)."""
        m = self.monc.osdmap
        if m is None or pool_id not in m.pools:
            raise RadosError(-2, f"no pool {pool_id}")
        primary = self.objecter._pg_primary(m, pool_id, ps)
        if primary < 0:
            raise RadosError(-11, f"pg {pool_id}.{ps} has no primary")
        reply = await self.osd_daemon_command(
            primary, "pg_scrub", timeout=timeout,
            pool=pool_id, ps=ps, repair=repair,
        )
        return reply["report"]

    async def get_cluster_stats(self) -> dict:
        return _check(await self.monc.command("status"), "status")["data"]

    async def list_pools(self) -> list[str]:
        r = _check(await self.monc.command("osd pool ls"), "pool ls")
        return list(r["data"])

    async def pool_create(self, name: str, **kw) -> int:
        r = _check(
            await self.monc.command("osd pool create", pool=name, **kw),
            "pool create",
        )
        await self._wait_pool(name)
        return r["data"]["pool_id"] if r.get("data") else 0

    async def pool_delete(self, name: str) -> None:
        _check(await self.monc.command("osd pool delete", pool=name),
               "pool delete")

    async def _wait_pool(self, name: str, timeout: float = 10.0) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            m = self.monc.osdmap
            if m is not None and any(
                p.name == name for p in m.pools.values()
            ):
                return
            if loop.time() > deadline:
                raise RadosError(-110, f"pool {name!r} never appeared")
            try:
                await self.monc.wait_for_map(
                    (m.epoch if m else 0) + 1, timeout=0.5
                )
            except asyncio.TimeoutError:
                pass

    async def open_ioctx(self, pool_name: str) -> "IoCtx":
        m = self.monc.osdmap
        pool = next(
            (p for p in m.pools.values() if p.name == pool_name), None
        ) if m is not None else None
        if pool is None:
            raise RadosError(-2, f"no pool {pool_name!r}")
        return IoCtx(self, pool.pool_id, pool_name)


# Wire oid of a namespaced object: "\x1d<ns>\x1d<name>".  The leading
# group-separator marker cannot collide with ordinary oids (RGW index
# shards legitimately embed NULs, so "<ns>\x00<name>" would be
# ambiguous); default-namespace oids ride unchanged.
NS_SEP = "\x1d"


class IoCtx:
    """Per-pool IO context (librados rados_ioctx_t / IoCtx)."""

    def __init__(self, rados: Rados, pool_id: int, pool_name: str):
        self.rados = rados
        self.pool_id = pool_id
        self.pool_name = pool_name
        # rados_ioctx_set_namespace: "" = the default namespace.  The
        # namespace rides the wire INSIDE the oid (see NS_SEP) so
        # placement, replication, recovery and scrub treat namespaced
        # objects like any other; the OSD splits it back out for cap
        # enforcement (the hobject_t nspace role).
        self.namespace = ""
        # write SnapContext (rados_ioctx_selfmanaged_snap_set_write_ctx)
        self.snap_seq = 0
        self.snaps: list[int] = []
        # read snap (rados_ioctx_snap_set_read); None = head
        self.read_snap: int | None = None

    def set_namespace(self, namespace: str) -> None:
        """rados_ioctx_set_namespace ('' = default)."""
        if NS_SEP in namespace:
            raise ValueError("namespace may not contain \\x1d")
        self.namespace = str(namespace)

    def _noid(self, oid: str) -> str:
        if oid.startswith(NS_SEP):
            raise ValueError("object name may not start with \\x1d")
        if self.namespace:
            return f"{NS_SEP}{self.namespace}{NS_SEP}{oid}"
        return oid

    def set_snap_context(self, seq: int, snaps: list[int]) -> None:
        """Mutations carry this SnapContext; the OSD clones the head
        before its first write under a newer context (COW)."""
        self.snap_seq = int(seq)
        self.snaps = sorted(int(s) for s in snaps)

    def snap_set_read(self, snapid: int | None) -> None:
        """Reads resolve at this snap (None restores head reads)."""
        self.read_snap = None if snapid is None else int(snapid)

    async def selfmanaged_snap_create(self) -> int:
        """Allocate a pool snap id and adopt it into the write context."""
        r = _check(await self.rados.mon_command(
            "osd pool selfmanaged-snap create", pool=self.pool_name,
        ), "snap create")
        snapid = int(r["data"]["snapid"])
        self.set_snap_context(snapid, [*self.snaps, snapid])
        return snapid

    async def selfmanaged_snap_remove(self, snapid: int) -> None:
        _check(await self.rados.mon_command(
            "osd pool selfmanaged-snap rm", pool=self.pool_name,
            snapid=int(snapid),
        ), "snap rm")
        self.snaps = [s for s in self.snaps if s != snapid]

    async def operate(self, oid: str, op: ObjectOperation,
                      timeout: float = 30.0) -> dict:
        """Submit a batched op (IoCtxImpl::operate)."""
        extra: dict = {}
        if self.snap_seq:
            extra["snapc"] = {"seq": self.snap_seq,
                              "snaps": sorted(self.snaps, reverse=True)}
        if self.read_snap is not None:
            extra["snapid"] = self.read_snap
        if _FULL_TRY.get():
            extra["flags"] = ["full_try"]
        if _OP_CLASS.get():
            extra["qclass"] = _OP_CLASS.get()
        reply = await self.rados.objecter.op_submit(
            self.pool_id, self._noid(oid), op.ops, timeout,
            extra=extra or None
        )
        if reply["rc"] != 0:
            raise RadosError(reply["rc"], f"operate on {oid!r}")
        return reply

    # -- data --------------------------------------------------------------
    async def write(self, oid: str, data: bytes, offset: int = 0) -> None:
        await self.operate(oid, ObjectOperation().write(data, offset))

    async def write_full(self, oid: str, data: bytes) -> None:
        await self.operate(oid, ObjectOperation().write_full(data))

    async def append(self, oid: str, data: bytes) -> None:
        await self.operate(oid, ObjectOperation().append(data))

    async def read(self, oid: str, length: int | None = None,
                   offset: int = 0) -> bytes:
        r = await self.operate(
            oid, ObjectOperation().read(offset, length)
        )
        return r["results"][0]["data"]

    async def stat(self, oid: str) -> dict:
        r = await self.operate(oid, ObjectOperation().stat())
        return r["results"][0]

    async def remove(self, oid: str) -> None:
        await self.operate(oid, ObjectOperation().remove())

    async def truncate(self, oid: str, size: int) -> None:
        await self.operate(oid, ObjectOperation().truncate(size))

    # -- xattr / omap ------------------------------------------------------
    async def set_xattr(self, oid: str, name: str, value: bytes) -> None:
        await self.operate(oid, ObjectOperation().set_xattr(name, value))

    async def get_xattr(self, oid: str, name: str) -> bytes:
        r = await self.operate(oid, ObjectOperation().get_xattr(name))
        return r["results"][0]["value"]

    async def rm_xattr(self, oid: str, name: str) -> None:
        await self.operate(oid, ObjectOperation().rm_xattr(name))

    async def get_xattrs(self, oid: str) -> dict[str, bytes]:
        r = await self.operate(oid, ObjectOperation().get_xattrs())
        return r["results"][0]["attrs"]

    async def get_omap(self, oid: str,
                       keys: list[str] | None = None) -> dict[str, bytes]:
        r = await self.operate(oid, ObjectOperation().omap_get(keys))
        return r["results"][0]["kv"]

    async def set_omap(self, oid: str, kv: dict[str, bytes]) -> None:
        await self.operate(oid, ObjectOperation().omap_set(kv))

    async def rm_omap_keys(self, oid: str, keys: list[str]) -> None:
        await self.operate(oid, ObjectOperation().omap_rm(keys))

    async def exec(self, oid: str, cls: str, method: str,
                   indata: bytes = b"") -> bytes:
        """rados_exec: run a server-side object-class method."""
        r = await self.operate(
            oid, ObjectOperation().call(cls, method, indata)
        )
        return r["results"][0]["out"]

    # -- listing -----------------------------------------------------------
    async def list_objects(self) -> list[str]:
        """Enumerate pool objects (rados_nobjects_list: per-PG pgls,
        targeting each PG directly rather than hashing an object name)."""
        m = self.rados.monc.osdmap
        pool = m.pools[self.pool_id]
        names: set[str] = set()
        for ps in range(pool.pg_num):
            names.update(await self._pgls(ps))
        if self.namespace:
            pre = NS_SEP + self.namespace + NS_SEP
            return sorted(n[len(pre):] for n in names
                          if n.startswith(pre))
        return sorted(n for n in names if not n.startswith(NS_SEP))

    async def _pgls(self, ps: int) -> list[str]:
        objecter = self.rados.objecter
        monc = self.rados.monc
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 10.0
        while True:
            m = monc.osdmap
            primary = objecter._pg_primary(m, self.pool_id, ps)
            if primary < 0:
                await asyncio.sleep(0.05)
                if loop.time() > deadline:
                    raise RadosError(-110, f"pgls {ps}: no primary")
                continue
            objecter._tid += 1
            tid = objecter._tid
            fut = loop.create_future()
            objecter._inflight[tid] = (fut, primary)
            try:
                await objecter.msgr.send_to(
                    m.osds[primary].addr,
                    Message("osd_op", {
                        "tid": tid, "pool": self.pool_id, "ps": ps,
                        "oid": "", "epoch": m.epoch,
                        "ops": [{"op": "pgls"}],
                    }), f"osd.{primary}",
                )
                reply = await asyncio.wait_for(
                    fut, max(0.05, deadline - loop.time())
                )
            except (ConnectionError, ObjecterError, asyncio.TimeoutError):
                objecter._inflight.pop(tid, None)
                if loop.time() > deadline:
                    raise RadosError(-110, f"pgls {ps} timed out") from None
                await asyncio.sleep(0.05)
                continue
            if reply["rc"] == -1000:        # misdirected
                await asyncio.sleep(0.05)
                continue
            if reply["rc"] != 0:
                raise RadosError(reply["rc"], f"pgls {ps}")
            return reply["results"][0]["objects"]

    # -- watch / notify ----------------------------------------------------
    async def watch(self, oid: str,
                    callback: Callable[[bytes], Awaitable[bytes | None]],
                    ) -> LingerOp:
        """Register a watch; callback receives each notify payload and may
        return a reply blob (rados_watch3 semantics)."""
        return await self.rados.objecter.linger_watch(
            self.pool_id, self._noid(oid), callback
        )

    async def unwatch(self, handle: LingerOp) -> None:
        await self.rados.objecter.linger_cancel(handle)

    async def notify(self, oid: str, payload: bytes = b"",
                     timeout: float = 5.0) -> dict:
        """rados_notify2: returns {"acks": {cookie: reply}, "timeouts"}."""
        r = await self.operate(oid, _NotifyOp(payload, timeout),
                               timeout=timeout + 10.0)
        return r["results"][0]


class _NotifyOp(ObjectOperation):
    def __init__(self, payload: bytes, timeout: float):
        super().__init__()
        self.ops = [{"op": "notify", "payload": bytes(payload),
                     "timeout": timeout}]
