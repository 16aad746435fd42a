"""Paxos: single-decree-per-version replicated transaction log.

Counterpart of ceph_tpu/mon/paxos.py: the same module over the
port's imports.

Reference src/mon/Paxos.{h,cc}: the leader drives phases — collect
(Paxos.cc:154 / handle_collect :223) after each election to converge
last_committed and recover uncommitted values, then begin/accept/commit
(:613/:847) per proposed value. Values are encoded MonitorDBStore
transactions; commit == apply to the local store. Every version is kept
under the "paxos" prefix so lagging peons catch up from peers. Leases
double as quorum liveness (lease loss -> new election), as in
Paxos::extend_lease / lease_ack_timeout.
"""

from __future__ import annotations

import asyncio
from contextlib import nullcontext
from typing import Awaitable, Callable

from ceph_tpu_torch.common import failpoint as fp
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.common.tracing import current_span
from ceph_tpu_torch.msg.message import PRIO_HIGHEST, Message
from ceph_tpu_torch.mon.store import MonitorDBStore, StoreTransaction

log = Dout("mon")

PREFIX = "paxos"
KEEP_VERSIONS = 500     # trim window (Paxos::trim / paxos_max_join_drift)


class Paxos:
    def __init__(self, mon, store: MonitorDBStore):
        self.mon = mon
        self.store = store
        self.last_committed = store.get_int(PREFIX, "last_committed")
        self.accepted_pn = store.get_int(PREFIX, "accepted_pn")
        # leader state
        self.collecting = False
        self._collect_acks: dict[str, dict] = {}
        self._uncommitted: dict | None = None      # {"v","pn","value"}
        self._accepts: set[str] = set()
        self._inflight: dict | None = None         # value being committed
        self._queue: list[tuple[StoreTransaction, asyncio.Future]] = []
        self._accept_timer: asyncio.Task | None = None
        self.ready = False       # collect finished; proposals allowed
        self.on_commit: Callable[[], Awaitable[None]] | None = None
        # span collector (Monitor-provided): each commit records a
        # "mon:paxos_commit" span so a traced mutation shows its
        # consensus step in the reassembled tree
        self.tracer = None
        # restore any locally accepted-but-uncommitted value
        raw = store.get(PREFIX, "pending_v")
        if raw is not None:
            v = int(raw)
            if v > self.last_committed:
                self._uncommitted = {
                    "v": v,
                    "pn": store.get_int(PREFIX, "pending_pn"),
                    "value": store.get(PREFIX, str(v)) or b"",
                }

    # -- helpers ---------------------------------------------------------
    @property
    def quorum(self) -> list[str]:
        return self.mon.elector.quorum

    def _peons(self) -> list[str]:
        return [m for m in self.quorum if m != self.mon.name]

    def _send(self, peer: str, mtype: str, data: dict) -> None:
        data["from"] = self.mon.name
        self.mon.send_mon(peer, Message(mtype, data, priority=PRIO_HIGHEST))

    def _new_pn(self) -> int:
        pn = (max(self.accepted_pn, 0) // 100 + 1) * 100 + self.mon.rank
        self.accepted_pn = pn
        self.store.apply_transaction(
            StoreTransaction().put(PREFIX, "accepted_pn", pn)
        )
        return pn

    def version_value(self, v: int) -> bytes | None:
        return self.store.get(PREFIX, str(v))

    def reload_from_store(self) -> None:
        """Adopt a store that was just replaced wholesale (full-store
        sync): all in-memory paxos state restarts from the new store's
        truth; any queued proposals are stale by definition."""
        self.last_committed = self.store.get_int(PREFIX, "last_committed")
        self.accepted_pn = self.store.get_int(PREFIX, "accepted_pn")
        self._uncommitted = None
        self._inflight = None
        self._collect_acks = {}
        self.collecting = False
        self.ready = False
        self._queue, queue = [], self._queue
        for _, fut in queue:
            if not fut.done():
                fut.set_exception(ConnectionError("store sync"))

    def _reset_proposals(self) -> None:
        """Role changed mid-proposal: fail waiters, recover our own
        durably-accepted value so collect can re-propose it."""
        if self._accept_timer is not None:
            self._accept_timer.cancel()
            self._accept_timer = None
        if self._inflight is not None:
            for fut in self._inflight.get("futs", ()):
                if not fut.done():
                    fut.set_exception(ConnectionError("lost quorum"))
            self._inflight = None
        raw = self.store.get(PREFIX, "pending_v")
        if raw is not None:
            v = int(raw)
            if v > self.last_committed and self._uncommitted is None:
                self._uncommitted = {
                    "v": v,
                    "pn": self.store.get_int(PREFIX, "pending_pn"),
                    "value": self.store.get(PREFIX, str(v)) or b"",
                }

    # -- collect phase (leader, post-election) ----------------------------
    async def leader_init(self) -> None:
        self.ready = False
        self._reset_proposals()
        self.collecting = True
        self._collect_acks = {}
        pn = self._new_pn()
        log.dout(5, "%s: paxos collect pn %d lc %d",
                 self.mon.name, pn, self.last_committed)
        if not self._peons():
            await self._collect_done()
            return
        for peer in self._peons():
            self._send(peer, "paxos_collect", {
                "pn": pn, "last_committed": self.last_committed,
            })

    async def peon_init(self) -> None:
        self.ready = False
        self.collecting = False
        self._reset_proposals()
        self._queue, queue = [], self._queue
        for _, fut in queue:
            if not fut.done():
                fut.set_exception(ConnectionError("lost leadership"))

    async def handle_collect(self, msg: Message) -> None:
        """Peon: acknowledge a higher pn, report state (handle_collect).
        A stale pn is answered too — the reply carries OUR accepted_pn so
        the leader can restart collect above it (OLD_ROUND semantics,
        reference Paxos::handle_collect / handle_last)."""
        peer = msg.data["from"]
        pn = int(msg.data["pn"])
        leader_lc = int(msg.data["last_committed"])
        if pn > self.accepted_pn:
            self.accepted_pn = pn
            self.store.apply_transaction(
                StoreTransaction().put(PREFIX, "accepted_pn", pn)
            )
        # share commits the leader is missing
        commits = {}
        for v in range(leader_lc + 1, self.last_committed + 1):
            raw = self.version_value(v)
            if raw is not None:
                commits[str(v)] = raw
        un = self._uncommitted
        self._send(peer, "paxos_last", {
            "pn": min(pn, self.accepted_pn),
            "accepted_pn": self.accepted_pn,
            "last_committed": self.last_committed,
            "commits": commits,
            "uncommitted": dict(un) if un else None,
        })

    async def handle_last(self, msg: Message) -> None:
        """Leader: absorb peon state; done when all quorum replied. A peon
        reporting a higher accepted_pn forces a collect restart above it."""
        if not self.collecting:
            return
        peer = msg.data["from"]
        peon_pn = int(msg.data.get("accepted_pn", msg.data["pn"]))
        if peon_pn > self.accepted_pn:
            self.accepted_pn = peon_pn        # _new_pn picks above this
            await self.leader_init()
            return
        if int(msg.data["pn"]) != self.accepted_pn:
            return
        self._collect_acks[peer] = msg.data
        for v_str, raw in sorted(
            msg.data.get("commits", {}).items(), key=lambda kv: int(kv[0])
        ):
            self._learn_commit(int(v_str), raw)
        un = msg.data.get("uncommitted")
        if un and (self._uncommitted is None
                   or int(un["pn"]) > int(self._uncommitted["pn"])):
            self._uncommitted = {
                "v": int(un["v"]), "pn": int(un["pn"]), "value": un["value"],
            }
        if set(self._collect_acks) >= set(self._peons()):
            await self._collect_done()

    async def _collect_done(self) -> None:
        self.collecting = False
        # catch lagging peons up
        for peer, ack in self._collect_acks.items():
            peon_lc = int(ack["last_committed"])
            if (peon_lc < self.last_committed
                    and self.version_value(peon_lc + 1) is None):
                # the peon is beyond the trim window: incremental
                # catch-up is impossible — advise a full-store sync
                # (Monitor::sync_start role, Monitor.cc:1442)
                self._send(peer, "mon_sync_advise",
                           {"lc": self.last_committed})
                continue
            for v in range(peon_lc + 1, self.last_committed + 1):
                raw = self.version_value(v)
                if raw is not None:
                    self._send(peer, "paxos_commit",
                               {"v": v, "value": raw})
        un = self._uncommitted
        self._uncommitted = None
        self.ready = True
        if un and int(un["v"]) == self.last_committed + 1:
            # re-propose ahead of the queue; ready is already set so the
            # queue drains right after this value commits
            log.dout(5, "%s: re-proposing uncommitted v %d",
                     self.mon.name, un["v"])
            await self._begin(StoreTransaction.decode(un["value"]))
            return
        if self.on_commit is not None:
            await self.on_commit()
        await self._maybe_propose()

    # -- propose / begin / accept / commit -------------------------------
    async def propose(self, tx: StoreTransaction) -> None:
        """Queue a transaction; resolves once committed (leader only)."""
        fut = asyncio.get_running_loop().create_future()
        self._queue.append((tx, fut))
        await self._maybe_propose()
        await fut

    async def _maybe_propose(self) -> None:
        if (not self.ready or self._inflight is not None
                or not self._queue):
            return
        # coalesce everything queued into one value (Paxos proposal batch)
        batch = StoreTransaction()
        futs = []
        for tx, fut in self._queue:
            batch.append(tx)
            futs.append(fut)
        self._queue = []
        self._inflight = {"futs": futs}
        await self._begin(batch)

    async def _begin(self, tx: StoreTransaction) -> None:
        v = self.last_committed + 1
        raw = tx.encode()
        if self._inflight is None:
            self._inflight = {"futs": []}
        self._inflight.update({"v": v, "value": raw})
        self._accepts = {self.mon.name}
        # leader stores its accept durably before asking peons (begin :613)
        self.store.apply_transaction(
            StoreTransaction()
            .put(PREFIX, str(v), raw)
            .put(PREFIX, "pending_v", v)
            .put(PREFIX, "pending_pn", self.accepted_pn)
        )
        for peer in self._peons():
            self._send(peer, "paxos_begin", {
                "pn": self.accepted_pn, "v": v, "value": raw,
            })
        if self._accept_timer is not None:
            self._accept_timer.cancel()
        self._accept_timer = asyncio.create_task(self._accept_timeout())
        await self._check_accepted()

    async def _accept_timeout(self) -> None:
        try:
            await asyncio.sleep(self.mon.conf["mon_accept_timeout"])
        except asyncio.CancelledError:
            return
        if self._inflight is not None:
            log.derr("%s: paxos accept timeout at v %s",
                     self.mon.name, self._inflight.get("v"))
            self.mon.bootstrap()

    async def handle_begin(self, msg: Message) -> None:
        """Peon: durably accept the proposal (handle_begin); nak a stale
        pn so the leader re-collects instead of waiting out the timeout."""
        peer = msg.data["from"]
        pn = int(msg.data["pn"])
        if pn < self.accepted_pn:
            self._send(peer, "paxos_nak", {"pn": self.accepted_pn})
            return
        v = int(msg.data["v"])
        value = msg.data["value"]
        self._uncommitted = {"v": v, "pn": pn, "value": value}
        self.store.apply_transaction(
            StoreTransaction()
            .put(PREFIX, str(v), value)
            .put(PREFIX, "pending_v", v)
            .put(PREFIX, "pending_pn", pn)
        )
        self._send(peer, "paxos_accept", {"pn": pn, "v": v})

    async def handle_accept(self, msg: Message) -> None:
        if self._inflight is None or int(msg.data["pn"]) != self.accepted_pn:
            return
        self._accepts.add(msg.data["from"])
        await self._check_accepted()

    async def handle_nak(self, msg: Message) -> None:
        """A peon accepted a higher pn: restart collect above it (the
        queued/inflight value survives durably and is re-proposed)."""
        pn = int(msg.data["pn"])
        if not self.mon.is_leader or pn <= self.accepted_pn:
            return
        self.accepted_pn = pn
        await self.leader_init()

    async def _check_accepted(self) -> None:
        """Commit once ALL quorum members accepted (the reference waits
        for the full quorum — the quorum is already a monmap majority)."""
        if self._inflight is None or "v" not in self._inflight:
            return
        if not self._accepts >= set(self.quorum):
            return
        if self._accept_timer is not None:
            self._accept_timer.cancel()
            self._accept_timer = None
        v, raw = self._inflight["v"], self._inflight["value"]
        futs = self._inflight["futs"]
        self._inflight = None
        self._commit(v, raw)
        for peer in self._peons():
            self._send(peer, "paxos_commit", {"v": v, "value": raw})
        if self.on_commit is not None:
            await self.on_commit()
        for fut in futs:
            if not fut.done():
                fut.set_result(v)
        await self._maybe_propose()

    def _commit(self, v: int, raw: bytes) -> None:
        span = (self.tracer.span("mon:paxos_commit",
                                 parent=current_span(), v=v,
                                 bytes=len(raw))
                if self.tracer is not None else nullcontext())
        with span:
            if fp.ACTIVE:
                # injected commit failure: the value stays durably
                # accepted (pending_v/pending_pn), so recovery
                # re-proposes it
                fp.fire_sync("mon.paxos_commit")
            tx = StoreTransaction.decode(raw)
            tx.put(PREFIX, str(v), raw)
            tx.put(PREFIX, "last_committed", v)
            tx.erase(PREFIX, "pending_v")
            tx.erase(PREFIX, "pending_pn")
            if v > KEEP_VERSIONS:
                tx.erase(PREFIX, str(v - KEEP_VERSIONS))  # Paxos::trim
            self.store.apply_transaction(tx)
            self.last_committed = v
            self._uncommitted = None

    def _learn_commit(self, v: int, raw: bytes) -> None:
        if v == self.last_committed + 1:
            self._commit(v, raw)
        elif v > self.last_committed:
            log.derr("%s: paxos gap learning v %d (lc %d)",
                     self.mon.name, v, self.last_committed)

    async def handle_commit(self, msg: Message) -> None:
        self._learn_commit(int(msg.data["v"]), msg.data["value"])
        if self.on_commit is not None:
            await self.on_commit()
