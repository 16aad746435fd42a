"""Monitor full-store sync (Monitor::sync_start role).

Counterpart of ceph_tpu/mon/sync.py: the same module over the
port's imports.

A monitor that is brand new, or that was down longer than the paxos trim
window (paxos.KEEP_VERSIONS), has no incremental catch-up path: the
quorum has already erased the versions it needs.  The reference solves
this by copying the entire MonitorDBStore from a quorum peer before the
laggard participates again (reference src/mon/Monitor.cc:1442
``Monitor::sync_start``; chunked provider iteration in
``Monitor::handle_sync_get_chunk``).  Same design here, asyncio-native:

- Detection is two-sided: the leader notices an un-catch-up-able peon at
  collect time and sends ``mon_sync_advise``; an up-to-date peer refuses
  to defer in elections to a candidate whose proposal carries a paxos
  ``lc`` beyond the trim window and advises it instead (the probe-phase
  role — a stale mon must never win leadership and roll history back).
- The requester streams the provider's snapshot in acked chunks into
  RAM, then swaps its local store in ONE atomic transaction (wipe +
  puts).  A crash mid-sync leaves the old store intact — consistent,
  still stale — and the next advise simply restarts the sync; no
  half-written store can ever serve.
- While syncing, the mon drops paxos traffic, defers every election,
  and suppresses bootstrap churn; on completion it reloads paxos state
  from the new store, refreshes every service, and calls an election.
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.msg.message import Message

log = Dout("mon")

CHUNK_ENTRIES = 512            # entries per mon_sync_chunk
PROVIDER_IDLE_S = 60.0         # provider drops un-acked sync state


class MonSync:
    """Both halves of the store-sync protocol for one monitor."""

    def __init__(self, mon):
        self.mon = mon
        # requester state
        self.syncing = False
        self._provider: str | None = None
        self._staged: list[tuple] = []
        self._next_seq = 0
        self._timer: asyncio.Task | None = None
        self._tried: list[str] = []
        # provider state: requester name -> {"entries", "pos", "seq", "ts"}
        self._out: dict[str, dict] = {}

    # -- requester --------------------------------------------------------
    def maybe_start(self, provider: str, provider_lc: int) -> None:
        """Begin a sync if the advisor really is ahead of us and no sync
        is already running."""
        if self.syncing or self.mon._stopped:
            return
        if provider_lc <= self.mon.paxos.last_committed:
            return
        self._tried = []
        self._start(provider)

    def _start(self, provider: str) -> None:
        self.syncing = True
        self._provider = provider
        self._tried.append(provider)
        self._staged = []
        self._next_seq = 0
        log.dout(1, "%s: store sync from mon.%s (lc %d)",
                 self.mon.name, provider, self.mon.paxos.last_committed)
        self.mon.send_mon(provider, Message("mon_sync_start", {}))
        self._arm_timer()

    def _arm_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
        self._timer = asyncio.get_running_loop().create_task(
            self._chunk_timeout()
        )

    async def _chunk_timeout(self) -> None:
        try:
            await asyncio.sleep(self.mon.conf["mon_sync_timeout"])
        except asyncio.CancelledError:
            return
        if not self.syncing:
            return
        # provider died mid-sync (e.g. the leader was killed): restart
        # from another monmap peer; state so far is discarded — chunks
        # are snapshot-consistent only within one provider session
        others = [m for m in self.mon.monmap
                  if m != self.mon.name and m not in self._tried]
        if not others:
            self._tried = []
            others = [m for m in self.mon.monmap if m != self.mon.name]
        if not others:
            self.syncing = False
            return
        nxt = (self.mon.elector.leader
               if self.mon.elector.leader in others else others[0])
        log.dout(1, "%s: sync provider mon.%s timed out, retrying via "
                 "mon.%s", self.mon.name, self._provider, nxt)
        self._start(nxt)

    async def handle_chunk(self, msg: Message) -> None:
        if not self.syncing or msg.data["from"] != self._provider:
            return
        if int(msg.data["seq"]) != self._next_seq:
            return                       # dup/reorder: ignore, timer covers
        self._next_seq += 1
        self._staged.extend(tuple(e) for e in msg.data["entries"])
        self._arm_timer()
        self.mon.send_mon(self._provider, Message(
            "mon_sync_chunk_ack", {"seq": msg.data["seq"]}
        ))
        if msg.data.get("done"):
            self._finish()

    def _finish(self) -> None:
        from ceph_tpu_torch.mon.store import StoreTransaction

        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        tx = StoreTransaction()
        for prefix in list(self.mon.store.prefixes()):
            tx.erase_prefix(prefix)
        for prefix, key, value in self._staged:
            tx.put(prefix, key, value)
        # one atomic transaction: the WAL either replays the whole swap
        # or (torn tail) none of it — never a half store
        self.mon.store.apply_transaction(tx)
        n = len(self._staged)
        self._staged = []
        self.syncing = False
        self._provider = None
        self.mon.paxos.reload_from_store()
        for svc in self.mon.services.values():
            svc.refresh()
        log.dout(1, "%s: store sync complete (%d entries, lc %d)",
                 self.mon.name, n, self.mon.paxos.last_committed)
        self.mon.bootstrap()

    # -- provider ---------------------------------------------------------
    async def handle_start(self, msg: Message) -> None:
        peer = msg.data["from"]
        self._gc_out()
        # snapshot the whole store now; chunks stream from this frozen
        # view so the requester sees one consistent point in time
        entries = [
            (prefix, key, value)
            for prefix, key, value in self.mon.store.iter_all()
        ]
        self._out[peer] = {
            "entries": entries, "pos": 0, "seq": 0,
            "ts": asyncio.get_running_loop().time(),
        }
        log.dout(1, "%s: providing store sync to mon.%s (%d entries)",
                 self.mon.name, peer, len(entries))
        self._send_next(peer)

    async def handle_ack(self, msg: Message) -> None:
        peer = msg.data["from"]
        st = self._out.get(peer)
        if st is None or int(msg.data["seq"]) != st["seq"]:
            return
        st["seq"] += 1
        st["ts"] = asyncio.get_running_loop().time()
        if st["pos"] >= len(st["entries"]):
            del self._out[peer]          # done chunk was acked
            return
        self._send_next(peer)

    def _send_next(self, peer: str) -> None:
        st = self._out[peer]
        chunk = st["entries"][st["pos"]:st["pos"] + CHUNK_ENTRIES]
        st["pos"] += len(chunk)
        self.mon.send_mon(peer, Message("mon_sync_chunk", {
            "seq": st["seq"],
            "entries": [list(e) for e in chunk],
            "done": st["pos"] >= len(st["entries"]),
        }))

    def _gc_out(self) -> None:
        now = asyncio.get_running_loop().time()
        for peer in [p for p, st in self._out.items()
                     if now - st["ts"] > PROVIDER_IDLE_S]:
            del self._out[peer]

    # -- shutdown ---------------------------------------------------------
    def stop(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
