"""MonClient: every daemon's and client's monitor session.

Counterpart of ceph_tpu/mon/client.py: the same module over the
port's imports.

Reference src/mon/MonClient.{h,cc}: hunt for a reachable monitor,
authenticate, subscribe to maps (osdmap/config/monmap), receive pushed
epochs (handle_config MonClient.cc:432), send commands and failure/boot
reports. The mon session is lossy (stateless server policy): on reset the
client re-hunts, re-authenticates, and re-subscribes.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable

from ceph_tpu_torch.common.backoff import ExpBackoff
from ceph_tpu_torch.common.lockdep import DLock
from ceph_tpu_torch.common.config import ConfigProxy
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.common.perf import CounterType, PerfCounters
from ceph_tpu_torch.mon.monitor import auth_proof
from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.msg.messenger import Connection, Messenger, Policy

log = Dout("mon")


class MonClient:
    def __init__(self, entity: str, monmap: dict[str, str],
                 conf: ConfigProxy | None = None,
                 msgr: Messenger | None = None):
        """``entity``: full name, e.g. "osd.0" / "client.4123"."""
        self.entity = entity
        self.monmap = dict(monmap)
        self.conf = conf or ConfigProxy()
        self.msgr = msgr or Messenger(entity, self.conf)
        self.perf = PerfCounters(f"monc.{entity}")
        for _k in ("hunt_retries", "hunt_timeouts"):
            self.perf.add(_k, CounterType.U64)
        self._own_msgr = msgr is None
        self.msgr.set_policy("mon", Policy.lossy_client())
        if self.msgr.dispatcher is None:
            self.msgr.set_dispatcher(self)
        self.cur_mon: str | None = None
        self.conn: Connection | None = None
        self._authed = asyncio.Event()
        self._renew_lock = DLock("monc-renew")
        # cephx grants (the CephxServiceTicket the monitor issues)
        self.caps: dict[str, str] = {}
        self.osd_ticket: dict | None = None
        self.osd_session_key: str = ""
        self._tid = 0
        self._command_futures: dict[int, asyncio.Future] = {}
        self.sub_have: dict[str, int] = {}
        self.osdmap = None                      # latest OSDMap
        self._map_waiters: list[tuple[int, asyncio.Future]] = []
        self.on_osdmap: Callable[[object], Awaitable[None]] | None = None
        self._stopped = False
        self._hunt_task: asyncio.Task | None = None

    # -- lifecycle --------------------------------------------------------
    async def start(self, timeout: float = 10.0) -> None:
        await self._hunt(timeout)

    async def shutdown(self) -> None:
        self._stopped = True
        if self._hunt_task is not None:
            self._hunt_task.cancel()
        if self._own_msgr:
            await self.msgr.shutdown()
        elif self.conn is not None and not self.conn.is_closed:
            self.conn.mark_down()

    async def _hunt(self, timeout: float = 10.0) -> None:
        """Try monitors (rank order) until one authenticates us,
        backing off exponentially (capped, deterministic jitter) between
        full sweeps so a mon outage doesn't see lock-step re-dials."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        backoff = ExpBackoff(
            base=float(self.conf["client_backoff_base"]),
            cap=float(self.conf["client_backoff_max"]),
            seed=self.entity, name="hunt",
        )
        last_err: Exception | None = None
        while not self._stopped:
            for name in sorted(self.monmap):
                try:
                    await self._open_session(name)
                    return
                except (ConnectionError, OSError, TimeoutError) as e:
                    last_err = e
            if loop.time() > deadline:
                self.perf.inc("hunt_timeouts")
                raise ConnectionError(
                    f"{self.entity}: no monitor reachable: {last_err}"
                )
            self.perf.inc("hunt_retries")
            await asyncio.sleep(min(backoff.next_delay(),
                                    max(0.0, deadline - loop.time())))

    async def _open_session(self, name: str) -> None:
        self._authed.clear()
        conn = await self.msgr.connect(self.monmap[name], f"mon.{name}")
        self.cur_mon, self.conn = name, conn
        conn.send_message(Message("auth", {"entity": self.entity}))
        await asyncio.wait_for(self._authed.wait(), 5.0)
        if self.sub_have:
            self._send_subscribe()

    async def renew_ticket(self) -> None:
        """Re-run the auth exchange on the live mon session to refresh
        the OSD service ticket (ticket renewal before expiry — the
        CephxClientHandler build_request path). Serialized: interleaved
        exchanges would cross challenges and tear the session down."""
        async with self._renew_lock:
            import time as _time

            t = self.osd_ticket
            if (t is not None
                    and float(t.get("expires", 0)) > _time.time() + 2.0):
                return          # a concurrent renewal already refreshed
            conn = self.conn
            if conn is None:
                raise ConnectionError("no mon session")
            self._authed.clear()
            conn.send_message(Message("auth", {"entity": self.entity}))
            await asyncio.wait_for(self._authed.wait(), 5.0)

    # -- dispatcher -------------------------------------------------------
    def ms_handle_connect(self, conn: Connection) -> None:
        pass

    def ms_handle_reset(self, conn: Connection) -> None:
        if conn is not self.conn or self._stopped:
            return
        self.conn = None
        for fut in self._command_futures.values():
            if not fut.done():
                fut.set_exception(ConnectionError("mon session reset"))
        self._command_futures.clear()
        self._hunt_task = asyncio.get_running_loop().create_task(
            self._rehunt()
        )

    async def _rehunt(self) -> None:
        try:
            await self._hunt(timeout=60.0)
        except (ConnectionError, asyncio.CancelledError):
            pass

    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        t = msg.type
        if t == "auth_challenge":
            # cephx: prove possession of OUR entity key; legacy: the
            # cluster shared key
            key = (self.conf["auth_key"]
                   if self.conf["auth_cluster_required"] == "cephx"
                   else self.conf["auth_shared_key"])
            conn.send_message(Message("auth", {
                "entity": self.entity,
                "proof": auth_proof(key, self.entity, msg.data["nonce"]),
            }))
        elif t == "auth_reply":
            if msg.data.get("ok"):
                self.caps = {str(s): str(c) for s, c in
                             (msg.data.get("caps") or {}).items()}
                if msg.data.get("osd_ticket") is not None:
                    self.osd_ticket = dict(msg.data["osd_ticket"])
                    self.osd_session_key = str(
                        msg.data.get("osd_session_key", "")
                    )
                self._authed.set()
            else:
                conn.mark_down()
        elif t == "auth_bad":
            conn.send_message(Message("auth", {"entity": self.entity}))
        elif t == "mon_command_reply":
            fut = self._command_futures.pop(int(msg.data.get("tid", 0)),
                                            None)
            if fut is not None and not fut.done():
                fut.set_result(msg.data)
        elif t == "osd_map":
            self._handle_osd_map(msg.data)
            if self.on_osdmap is not None:
                await self.on_osdmap(self.osdmap)
        elif t == "config":
            self.conf.apply_central(msg.data.get("values", {}))
        elif t == "mon_map":
            self.monmap = dict(msg.data.get("mons", self.monmap))

    # -- maps -------------------------------------------------------------
    def _handle_osd_map(self, data: dict) -> None:
        from ceph_tpu_torch.osd.osd_map import Incremental, OSDMap
        if "full" in data and data["full"] is not None:
            self.osdmap = OSDMap.from_dict(data["full"])
        for inc_dict in data.get("incrementals", ()):
            inc = Incremental.from_dict(inc_dict)
            if self.osdmap is None and inc.epoch == 1:
                self.osdmap = OSDMap()      # genesis inc carries the crush
            if self.osdmap is None or inc.epoch != self.osdmap.epoch + 1:
                continue
            self.osdmap.apply_incremental(inc)
        if self.osdmap is not None:
            self.sub_have["osdmap"] = self.osdmap.epoch
            waiters, self._map_waiters = self._map_waiters, []
            for epoch, fut in waiters:
                if self.osdmap.epoch >= epoch:
                    if not fut.done():
                        fut.set_result(self.osdmap)
                else:
                    self._map_waiters.append((epoch, fut))

    def sub_want(self, what: str, have: int = 0) -> None:
        self.sub_have.setdefault(what, have)

    def renew_subs(self) -> None:
        self._send_subscribe()

    def _send_subscribe(self) -> None:
        if self.conn is None or self.conn.is_closed:
            return
        try:
            self.conn.send_message(Message(
                "mon_subscribe", {"what": dict(self.sub_have)}
            ))
        except ConnectionError:
            pass

    async def wait_for_map(self, epoch: int = 1, timeout: float = 10.0):
        """Block until an osdmap with epoch >= ``epoch`` arrives."""
        if self.osdmap is not None and self.osdmap.epoch >= epoch:
            return self.osdmap
        fut = asyncio.get_running_loop().create_future()
        self._map_waiters.append((epoch, fut))
        return await asyncio.wait_for(fut, timeout)

    # -- commands / reports ------------------------------------------------
    def _live_conn(self):
        """Drop a dead cached session so retry loops re-hunt instead of
        spinning on a closed connection."""
        if self.conn is not None and self.conn.is_closed:
            self.conn = None
        return self.conn

    async def command(self, prefix: str, timeout: float = 10.0,
                      **args) -> dict:
        """Returns {"rc", "outs", "data"}; raises on session loss."""
        cmd = {"prefix": prefix, **args}
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            if self._stopped:
                raise ConnectionError(f"{self.entity}: client stopped")
            if self._live_conn() is None:
                await self._wait_for_session(deadline)
            self._tid += 1
            tid = self._tid
            fut = asyncio.get_running_loop().create_future()
            self._command_futures[tid] = fut
            try:
                self.conn.send_message(Message(
                    "mon_command", {"tid": tid, "cmd": cmd}
                ))
                reply = await asyncio.wait_for(
                    fut, max(0.1, deadline -
                             asyncio.get_running_loop().time())
                )
            except ConnectionError:
                self._command_futures.pop(tid, None)
                await asyncio.sleep(0.05)   # yield; session reset re-hunts
                continue
            except asyncio.TimeoutError:
                self._command_futures.pop(tid, None)
                raise
            if reply.get("rc") == -11:      # EAGAIN: electing / not leader
                await asyncio.sleep(0.1)
                if asyncio.get_running_loop().time() > deadline:
                    return reply
                continue
            return reply

    async def _wait_for_session(self, deadline: float) -> None:
        while self._live_conn() is None:
            if self._stopped:
                raise ConnectionError(f"{self.entity}: client stopped")
            if asyncio.get_running_loop().time() > deadline:
                raise ConnectionError(f"{self.entity}: no mon session")
            await asyncio.sleep(0.05)

    async def send_boot(self, osd_id: int, addr: str, host: str = "",
                        timeout: float = 10.0) -> None:
        """MOSDBoot: register as up; resolves when the map shows it."""
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            if self._stopped:
                raise ConnectionError(f"{self.entity}: client stopped")
            if self._live_conn() is None:
                await self._wait_for_session(deadline)
            try:
                self.conn.send_message(Message("osd_boot", {
                    "id": osd_id, "addr": addr, "host": host,
                }))
            except ConnectionError:
                await asyncio.sleep(0.05)
                continue
            await asyncio.sleep(0.05)
            try:
                m = await self.wait_for_map(timeout=1.0)
                if m.is_up(osd_id) and m.osds[osd_id].addr == addr:
                    return
            except asyncio.TimeoutError:
                pass
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(f"osd.{osd_id} boot not acknowledged")

    def report_failure(self, target: int, failed_for: float) -> None:
        """MOSDFailure (fire-and-forget; mon aggregates reporters)."""
        if self.conn is None or self.conn.is_closed:
            return
        try:
            self.conn.send_message(Message("osd_failure", {
                "target": target, "reporter": self.entity,
                "failed_for": failed_for,
            }))
        except ConnectionError:
            pass

    def send_osd_beacon(self, osd_id: int, slow_inflight: int = 0,
                        slow_total: int = 0) -> None:
        """MOSDBeacon (fire-and-forget): periodic daemon health digest
        feeding the mon's SLOW_OPS check."""
        if self.conn is None or self.conn.is_closed:
            return
        try:
            self.conn.send_message(Message("osd_beacon", {
                "id": osd_id,
                "slow_inflight": int(slow_inflight),
                "slow_total": int(slow_total),
            }))
        except ConnectionError:
            pass
