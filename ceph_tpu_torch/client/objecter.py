"""Objecter: the client-side op engine.

Counterpart of ceph_tpu/client/objecter.py: the same module over the
port's imports.

Reference src/osdc/Objecter.{h,cc}: computes the target from the osdmap
(_calc_target :2759 — CRUSH runs HERE, on the client), submits to the
primary OSD (_op_submit :2369), tracks inflight ops and resends on map
change or connection reset, and maintains linger (watch) registrations
that re-arm whenever the target moves (linger_submit / _linger_ops).
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Awaitable, Callable

import hashlib
import hmac

from ceph_tpu_torch.common.backoff import ExpBackoff
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.common.perf import CounterType, PerfCounters
from ceph_tpu_torch.common.tracing import Tracer, current_span
from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.msg.messenger import Connection, Messenger
from ceph_tpu_torch.osd.codes import MISDIRECTED_RC, READ_CLASS_OPS
from ceph_tpu_torch.osd.pg import object_to_ps

log = Dout("objecter")

_READ_OP_NAMES = READ_CLASS_OPS

EAGAIN_RC = -11


class ObjecterError(IOError):
    pass


class LingerOp:
    """A persistent watch registration (reference LingerOp)."""

    def __init__(self, linger_id: int, pool_id: int, oid: str, cookie: int,
                 callback: Callable[[bytes], Awaitable[bytes | None]]):
        self.linger_id = linger_id
        self.pool_id = pool_id
        self.oid = oid
        self.cookie = cookie
        self.callback = callback
        self.registered_osd: int | None = None


class Objecter:
    def __init__(self, monc, msgr: Messenger):
        self.monc = monc
        self.msgr = msgr
        self._tid = 0
        # tid -> (future, osd)
        self._inflight: dict[int, tuple[asyncio.Future, int]] = {}
        self._lingers: dict[int, LingerOp] = {}
        self._next_linger = 0
        self._stopped = False
        # client-unique reqid base (osd_reqid_t role): lets the OSD dedup
        # a resubmitted op that already executed with only the reply lost
        self._reqid_name = f"{msgr.name}.{msgr.nonce:08x}"
        self._reqid_seq = 0
        self.tracer = Tracer(msgr.name)
        # resend/timeout observability (l_osdc_* role), plus the
        # CLIENT-side latency histogram: end-to-end submit latency as
        # the application saw it (queueing + resends + map waits
        # included — the view the OSD-side histograms cannot have)
        self.perf = PerfCounters(f"objecter.{msgr.name}")
        for _k in ("op_resend", "op_timeout", "map_waits", "op_remap",
                   "op_error"):
            self.perf.add(_k, CounterType.U64)
        self.perf.add("op_latency_us", CounterType.HISTOGRAM)
        # primary-lookup memo off the bulk-mapping table: (map object,
        # epoch, {(pool, ps) -> acting_primary}).  Keyed by map identity
        # AND epoch so any new/replayed map drops it wholesale; entries
        # are filled from pg_to_up_acting (itself a cached-table lookup)
        self._primary_memo: tuple = (None, -1, {})
        # cephx: OSD sessions we have presented our service ticket on
        self._osd_authed: set[int] = set()
        self._osd_auth_futs: dict[int, asyncio.Future] = {}
        self._osd_auth_locks: dict[int, asyncio.Lock] = {}

    # -- dispatch hooks (driven by the owning client) ---------------------
    async def handle_message(self, conn: Connection, msg: Message) -> bool:
        """Returns True when the message was ours."""
        if msg.type == "osd_auth_challenge":
            proof = hmac.new(
                self.monc.osd_session_key.encode(),
                str(msg.data.get("nonce", "")).encode(), hashlib.sha256,
            ).hexdigest()
            try:
                conn.send_message(Message("osd_auth", {"proof": proof}))
            except ConnectionError:
                pass
            return True
        if msg.type == "osd_auth_reply":
            fut = self._osd_auth_futs.pop(id(conn), None)
            if fut is not None and not fut.done():
                fut.set_result(bool(msg.data.get("ok")))
            return True
        if msg.type == "osd_op_reply":
            fut_osd = self._inflight.pop(int(msg.data.get("tid", 0)), None)
            if fut_osd is not None and not fut_osd[0].done():
                fut_osd[0].set_result(msg.data)
            return True
        if msg.type == "watch_notify":
            asyncio.get_running_loop().create_task(
                self._handle_watch_notify(conn, msg.data)
            )
            return True
        return False

    def handle_reset(self, conn: Connection) -> None:
        """An OSD session died: fail its inflight ops (the callers'
        retry loops resubmit) and re-arm lingers bound to it."""
        self._osd_authed.discard(id(conn))
        fut = self._osd_auth_futs.pop(id(conn), None)
        if fut is not None and not fut.done():
            fut.set_exception(ObjecterError("osd session reset"))
        for tid, (fut, osd) in list(self._inflight.items()):
            if f"osd.{osd}" == conn.peer_name and not fut.done():
                del self._inflight[tid]
                fut.set_exception(ObjecterError("osd session reset"))
        for linger in self._lingers.values():
            if (linger.registered_osd is not None
                    and f"osd.{linger.registered_osd}" == conn.peer_name):
                linger.registered_osd = None
                asyncio.get_running_loop().create_task(
                    self._rearm_linger(linger)
                )

    async def on_map_change(self, osdmap) -> None:
        """_scan_requests role, run on every new osdmap: fail the
        in-flight ops whose session OSD the new map marks down — their
        reply will never come (the daemon is gone; an in-process
        transport surfaces no reset for a message sent into the gap
        between death and the map recording it), so without this rescan
        they would sit out the whole op deadline. The submit loop
        recomputes the target from the new map and resends; reqid dedup
        on the OSD makes a replay of an executed mutation safe. Lingers
        whose primary moved re-arm on the new one."""
        for tid, (fut, osd) in list(self._inflight.items()):
            if fut.done() or osdmap.is_up(osd):
                continue
            del self._inflight[tid]
            self.perf.inc("op_remap")
            fut.set_exception(ObjecterError(
                f"osd.{osd} went down (map e{osdmap.epoch})"
            ))
        for linger in self._lingers.values():
            target = self._target_for(linger.pool_id, linger.oid)
            if target is not None and target != linger.registered_osd:
                await self._rearm_linger(linger)

    # -- targeting --------------------------------------------------------
    def _pg_primary(self, m, pool_id: int, ps: int) -> int:
        """Memoized acting-primary for one PG on map ``m`` — hot on
        every submit retry, so repeated lookups within an epoch are a
        dict hit instead of even the (cheap) table walk."""
        memo_map, memo_epoch, memo = self._primary_memo
        if memo_map is not m or memo_epoch != m.epoch:
            memo = {}
            self._primary_memo = (m, m.epoch, memo)
        key = (pool_id, ps)
        primary = memo.get(key)
        if primary is None:
            _, _, _, primary = m.pg_to_up_acting(pool_id, ps)
            memo[key] = primary
        return primary

    def _target_for(self, pool_id: int, oid: str) -> int | None:
        m = self.monc.osdmap
        if m is None:
            return None
        pool = m.pools.get(pool_id)
        if pool is None:
            return None
        ps = object_to_ps(oid, pool.pg_num)
        primary = self._pg_primary(m, pool_id, ps)
        return primary if primary >= 0 else None

    # -- submission -------------------------------------------------------
    async def op_submit(self, pool_id: int, oid: str, ops: list[dict],
                        timeout: float | None = None,
                        extra: dict | None = None) -> dict:
        """Submit one op batch; retries across map changes, misdirected
        replies, and session resets until ``timeout``.  A sampled op
        (trace_probability) opens the root span and carries the trace
        context to the OSD (OpRequest/zipkin_trace analog).  When an
        ambient span is already active (an RGW request opened one),
        the submit traces unconditionally UNDER it — downstream of a
        sampled root, everything traces, so a trace is complete."""
        if timeout is None:
            timeout = float(self.monc.conf["client_op_deadline"])
        parent = current_span()
        prob = float(self.monc.conf["trace_probability"] or 0.0)
        t0 = time.monotonic()
        try:
            if parent is not None or (prob and random.random() < prob):
                with self.tracer.span("objecter:op_submit",
                                      parent=parent, ambient=True,
                                      oid=oid, pool=pool_id) as tctx:
                    ret = await self._op_submit_impl(
                        pool_id, oid, ops, timeout, extra, tctx
                    )
            else:
                ret = await self._op_submit_impl(pool_id, oid, ops,
                                                 timeout, extra, None)
        except Exception:
            # cancellation is the caller's doing, not an op failure
            self.perf.inc("op_error")
            raise
        self.perf.hinc("op_latency_us",
                       (time.monotonic() - t0) * 1e6)
        return ret

    async def _op_submit_impl(self, pool_id: int, oid: str,
                              ops: list[dict], timeout: float,
                              extra: dict | None, tctx) -> dict:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        # one reqid for the whole retry loop: a resend after a session
        # reset is the SAME logical op, so the OSD can answer from its
        # completed-op cache instead of re-executing (reference replays
        # are deduped via osd_reqid_t in the PG log)
        self._reqid_seq += 1
        reqid = f"{self._reqid_name}:{self._reqid_seq}"
        # capped exponential backoff between resends, jitter seeded from
        # the reqid so a run replays the exact sleep schedule
        backoff = ExpBackoff(
            base=float(self.monc.conf["client_backoff_base"]),
            cap=float(self.monc.conf["client_backoff_max"]),
            seed=reqid, name="resend",
        )
        while True:
            if self._stopped:
                raise ObjecterError("objecter stopped")
            m = self.monc.osdmap
            pool = m.pools.get(pool_id) if m is not None else None
            if pool is None:
                raise ObjecterError(f"no pool {pool_id}")
            # cache-tier overlay redirect (Objecter::_calc_target's
            # read_tier/write_tier handling): ops targeting the base
            # pool are sent to the cache pool instead; re-evaluated
            # every retry so an overlay change mid-op takes effect
            mutating = any(op.get("op") not in _READ_OP_NAMES
                           for op in ops)
            tier_id = pool.write_tier if mutating else pool.read_tier
            target_pool_id = pool_id
            if tier_id >= 0 and tier_id in m.pools:
                target_pool_id = tier_id
                pool = m.pools[tier_id]
            ps = object_to_ps(oid, pool.pg_num)
            primary = self._pg_primary(m, target_pool_id, ps)
            if primary < 0:
                await self._await_newer_map(m.epoch, deadline)
                continue
            try:
                await self._ensure_osd_auth(primary, m.osds[primary].addr)
            except (ConnectionError, ObjecterError,
                    asyncio.TimeoutError):
                if loop.time() > deadline:
                    self.perf.inc("op_timeout")
                    raise ObjecterError(
                        f"osd.{primary} auth failed"
                    ) from None
                self.perf.inc("op_resend")
                await asyncio.sleep(min(backoff.next_delay(),
                                        max(0.0, deadline - loop.time())))
                continue
            self._tid += 1
            tid = self._tid
            fut = loop.create_future()
            self._inflight[tid] = (fut, primary)
            try:
                await self.msgr.send_to(
                    m.osds[primary].addr,
                    Message("osd_op", {
                        "tid": tid, "pool": target_pool_id, "ps": ps,
                        "oid": oid,
                        "epoch": m.epoch, "ops": ops, "reqid": reqid,
                        **({"tctx": tctx.to_wire()} if tctx else {}),
                        **(extra or {}),
                    }), f"osd.{primary}",
                )
                reply = await asyncio.wait_for(
                    fut, max(0.05, deadline - loop.time())
                )
            except (ConnectionError, ObjecterError):
                self._inflight.pop(tid, None)
                if loop.time() > deadline:
                    self.perf.inc("op_timeout")
                    raise ObjecterError(
                        f"op on {oid} timed out (osd.{primary} unreachable)"
                    ) from None
                self.perf.inc("op_resend")
                await asyncio.sleep(min(backoff.next_delay(),
                                        max(0.0, deadline - loop.time())))
                continue
            except asyncio.TimeoutError:
                self._inflight.pop(tid, None)
                self.perf.inc("op_timeout")
                raise ObjecterError(f"op on {oid} timed out") from None
            if reply["rc"] == MISDIRECTED_RC:
                await self._await_newer_map(
                    max(m.epoch, int(reply.get("epoch", 0))) , deadline,
                    strict=False,
                )
                continue
            return reply

    async def _ensure_osd_auth(self, osd: int, addr: str) -> None:
        """cephx: present our mon-issued service ticket on this OSD
        session and prove the session key before the first op (the
        CephxAuthorizer handshake). No-op when auth is off."""
        conf = getattr(self.monc, "conf", None)
        if conf is None or conf["auth_cluster_required"] != "cephx":
            return
        conn = await self.msgr.connect(addr, f"osd.{osd}")
        if id(conn) in self._osd_authed:
            return
        lock = self._osd_auth_locks.setdefault(id(conn), asyncio.Lock())
        try:
            await self._osd_auth_locked(conn, lock, osd)
        finally:
            self._osd_auth_futs.pop(id(conn), None)
            if not lock.locked():
                self._osd_auth_locks.pop(id(conn), None)

    async def _osd_auth_locked(self, conn, lock, osd: int) -> None:
        async with lock:
            if id(conn) in self._osd_authed:
                return
            for attempt in range(2):
                ticket = self.monc.osd_ticket
                if (ticket is None
                        or float(ticket.get("expires", 0))
                        < time.time() + 1.0):
                    # expired or missing: renew over the mon session
                    # BEFORE presenting (tickets outlive neither the
                    # secret rotation window nor their own TTL)
                    await self.monc.renew_ticket()
                    ticket = self.monc.osd_ticket
                if ticket is None:
                    raise ObjecterError("no osd service ticket")
                fut = asyncio.get_running_loop().create_future()
                self._osd_auth_futs[id(conn)] = fut
                conn.send_message(Message("osd_auth",
                                          {"ticket": ticket}))
                ok = await asyncio.wait_for(fut, 5.0)
                if ok:
                    self._osd_authed.add(id(conn))
                    break
                if attempt == 0:
                    # possibly a just-rotated secret: one renewed retry
                    await self.monc.renew_ticket()
                    continue
                raise ObjecterError(f"osd.{osd} rejected our ticket")

    async def _await_newer_map(self, epoch: int, deadline: float,
                               strict: bool = True) -> None:
        loop = asyncio.get_running_loop()
        if loop.time() > deadline:
            self.perf.inc("op_timeout")
            raise ObjecterError("timed out waiting for a usable osdmap")
        self.perf.inc("map_waits")
        try:
            await self.monc.wait_for_map(
                epoch + 1, timeout=min(1.0, max(0.05,
                                                deadline - loop.time()))
            )
        except asyncio.TimeoutError:
            if strict:
                pass        # keep retrying until the op deadline
        await asyncio.sleep(0.02)

    # -- watch / notify ---------------------------------------------------
    async def linger_watch(
        self, pool_id: int, oid: str,
        callback: Callable[[bytes], Awaitable[bytes | None]],
    ) -> LingerOp:
        self._next_linger += 1
        linger = LingerOp(self._next_linger, pool_id, oid,
                          cookie=self._next_linger, callback=callback)
        self._lingers[linger.linger_id] = linger
        reply = await self.op_submit(pool_id, oid, [
            {"op": "watch", "cookie": linger.cookie},
        ])
        if reply["rc"] != 0:
            del self._lingers[linger.linger_id]
            raise ObjecterError(f"watch failed: rc {reply['rc']}")
        linger.registered_osd = self._target_for(pool_id, oid)
        return linger

    async def linger_cancel(self, linger: LingerOp) -> None:
        self._lingers.pop(linger.linger_id, None)
        try:
            await self.op_submit(linger.pool_id, linger.oid, [
                {"op": "unwatch", "cookie": linger.cookie},
            ], timeout=5.0)
        except ObjecterError:
            pass

    async def _rearm_linger(self, linger: LingerOp) -> None:
        if linger.linger_id not in self._lingers or self._stopped:
            return
        try:
            reply = await self.op_submit(linger.pool_id, linger.oid, [
                {"op": "watch", "cookie": linger.cookie},
            ], timeout=10.0)
            if reply["rc"] == 0:
                linger.registered_osd = self._target_for(
                    linger.pool_id, linger.oid
                )
        except ObjecterError as e:
            log.dout(5, "linger re-arm for %s failed: %s", linger.oid, e)

    async def _handle_watch_notify(self, conn: Connection,
                                   data: dict) -> None:
        cookie = int(data["cookie"])
        linger = next(
            (lg for lg in self._lingers.values() if lg.cookie == cookie),
            None,
        )
        reply = b""
        if linger is not None:
            try:
                out = await linger.callback(bytes(data.get("payload", b"")))
                reply = out if isinstance(out, (bytes, bytearray)) else b""
            except Exception:                  # noqa: BLE001
                log.derr("watch callback for %s raised", data.get("oid"))
        try:
            conn.send_message(Message("notify_ack", {
                "notify_id": data["notify_id"], "cookie": cookie,
                "reply": bytes(reply),
            }))
        except ConnectionError:
            pass

    def shutdown(self) -> None:
        self._stopped = True
        for tid, (fut, _) in self._inflight.items():
            if not fut.done():
                fut.set_exception(ObjecterError("shutdown"))
        self._inflight.clear()
