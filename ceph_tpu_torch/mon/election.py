"""Elector: leader election among monitors.

Counterpart of ceph_tpu/mon/election.py: the same module over the
port's imports.

Reference src/mon/Elector.{h,cc}: lowest-ranked reachable monitor wins.
Epochs are odd during an election and even once stable (Elector.h bump
convention). A monitor proposes itself; peers with lower rank counter-
propose, peers with higher rank defer. A proposer holding defers from a
majority of the monmap declares victory, fixing the quorum.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable

from ceph_tpu_torch.common import failpoint as fp
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.msg.message import PRIO_HIGHEST, Message

log = Dout("mon")


class Elector:
    def __init__(self, mon) -> None:
        self.mon = mon                       # Monitor (owns monmap + msgr)
        self.epoch = 0                       # odd = electing, even = stable
        self.electing = False
        self.deferred: set[str] = set()      # who deferred to us this epoch
        self.leader: str | None = None
        self.quorum: list[str] = []
        self._timeout_task: asyncio.Task | None = None
        self.on_win: Callable[[], Awaitable[None]] | None = None
        self.on_lose: Callable[[], Awaitable[None]] | None = None

    # -- helpers ---------------------------------------------------------
    @property
    def rank(self) -> int:
        return self.mon.rank

    def _majority(self) -> int:
        return len(self.mon.monmap) // 2 + 1

    def in_quorum(self) -> bool:
        return not self.electing and self.mon.name in self.quorum

    # -- start -----------------------------------------------------------
    def start(self) -> None:
        """Call an election (Elector::start)."""
        if self.epoch % 2 == 0:
            self.epoch += 1
        self.electing = True
        self.leader = None
        self.quorum = []
        self.deferred = {self.mon.name}
        log.dout(5, "%s: starting election epoch %d",
                 self.mon.name, self.epoch)
        if fp.ACTIVE:
            try:
                fp.fire_sync("mon.election")
            except fp.FailPointError as e:
                # injected disruption: propose nothing; the armed
                # timeout retries the election (Elector::expire path)
                log.derr("%s: election suppressed: %s", self.mon.name, e)
                self._arm_timeout()
                return
        for peer in self.mon.peer_names():
            # the candidacy carries our paxos position: peers refuse to
            # defer to a candidate beyond their trim window (it could
            # never catch up as leader and would roll history back)
            self.mon.send_mon(peer, Message(
                "election_propose", {
                    "epoch": self.epoch,
                    "lc": self.mon.paxos.last_committed,
                },
                priority=PRIO_HIGHEST,
            ))
        self._arm_timeout()
        self._check_victory()

    def _arm_timeout(self) -> None:
        if self._timeout_task is not None:
            self._timeout_task.cancel()
        self._timeout_task = asyncio.create_task(self._timeout())

    async def _timeout(self) -> None:
        try:
            await asyncio.sleep(self.mon.conf["mon_election_timeout"])
        except asyncio.CancelledError:
            return
        if self.electing:
            # nobody won: bump and retry (Elector::expire)
            self.epoch += 2
            self.start()

    def stop(self) -> None:
        if self._timeout_task is not None:
            self._timeout_task.cancel()
            self._timeout_task = None

    # -- message handlers ------------------------------------------------
    async def handle(self, msg: Message) -> None:
        peer = msg.data.get("from", "")
        epoch = int(msg.data["epoch"])
        if msg.type == "election_propose":
            await self._handle_propose(peer, epoch,
                                       msg.data.get("lc"))
        elif msg.type == "election_defer":
            await self._handle_defer(peer, epoch)
        elif msg.type == "election_victory":
            await self._handle_victory(peer, epoch,
                                       list(msg.data["quorum"]))

    async def _handle_propose(self, peer: str, epoch: int,
                              peer_lc: int | None = None) -> None:
        if epoch > self.epoch:
            self.epoch = epoch if epoch % 2 == 1 else epoch + 1
        sync = getattr(self.mon, "sync", None)
        if sync is not None and sync.syncing:
            # mid-store-sync we sit elections out ENTIRELY (no defer):
            # deferring would put us in the winner's quorum, whose
            # paxos accepts we cannot answer with a half-built store —
            # the quorum must form from the remaining majority
            return
        from ceph_tpu_torch.mon.paxos import KEEP_VERSIONS

        if (peer_lc is not None
                and int(peer_lc) + KEEP_VERSIONS
                <= self.mon.paxos.last_committed):
            # candidate is beyond the trim window: it must sync, not
            # lead — advise and push our own candidacy regardless of
            # rank (probe-phase protection, Monitor.cc:1442)
            self.mon.send_mon(peer, Message(
                "mon_sync_advise",
                {"lc": self.mon.paxos.last_committed},
            ))
            if not self.electing:
                self.start()
            return
        peer_rank = self.mon.rank_of(peer)
        if peer_rank < self.rank:
            # peer outranks us: defer and ABANDON our own candidacy —
            # keeping accumulated defers here lets two mons win the same
            # epoch (Elector::defer resets exactly this state)
            self.electing = True
            self.deferred = set()
            self.mon.send_mon(peer, Message(
                "election_defer", {"epoch": self.epoch},
                priority=PRIO_HIGHEST,
            ))
            self._arm_timeout()
        else:
            # we outrank the proposer: push our own candidacy
            if not self.electing:
                self.start()
            else:
                self.mon.send_mon(peer, Message(
                    "election_propose", {"epoch": self.epoch},
                    priority=PRIO_HIGHEST,
                ))

    async def _handle_defer(self, peer: str, epoch: int) -> None:
        if not self.electing or epoch < self.epoch:
            return
        self.deferred.add(peer)
        self._check_victory()

    def _check_victory(self) -> None:
        if not self.electing or len(self.deferred) < self._majority():
            return
        asyncio.get_running_loop().create_task(self._declare_victory())

    async def _declare_victory(self) -> None:
        if not self.electing:
            return
        self.epoch += 1                       # to even: stable
        self.electing = False
        self.leader = self.mon.name
        self.quorum = sorted(
            self.deferred, key=self.mon.rank_of
        )
        self.stop()
        log.dout(1, "%s: won election epoch %d, quorum %s",
                 self.mon.name, self.epoch, self.quorum)
        for peer in self.quorum:
            if peer != self.mon.name:
                self.mon.send_mon(peer, Message(
                    "election_victory",
                    {"epoch": self.epoch, "quorum": self.quorum},
                    priority=PRIO_HIGHEST,
                ))
        if self.on_win is not None:
            await self.on_win()

    async def _handle_victory(self, peer: str, epoch: int,
                              quorum: list[str]) -> None:
        if epoch < self.epoch:
            return
        if (epoch == self.epoch and not self.electing
                and self.leader is not None
                and self.mon.rank_of(peer) > self.mon.rank_of(self.leader)):
            # stale same-epoch victory from a claimant our leader outranks
            # (race: two mons both reached majority defers); lowest rank
            # wins, ignore the loser's claim
            return
        if self.mon.rank_of(peer) > self.rank:
            # a lower-priority mon claims victory over us: contest it
            self.start()
            return
        self.epoch = epoch
        self.electing = False
        self.leader = peer
        self.quorum = quorum
        self.stop()
        log.dout(1, "%s: lost election epoch %d to %s",
                 self.mon.name, epoch, peer)
        if self.on_lose is not None:
            await self.on_lose()
