"""Thrasher: continuous OSD kill/revive chaos.

Counterpart of ceph_tpu/testing/thrasher.py: the same module over the
port's imports.

The qa/tasks/ceph_manager.py Thrasher (kill_osd :248, revive_osd :480)
against a DevCluster: a background loop repeatedly downs a random OSD,
waits, and revives it, always keeping enough OSDs up for writes to
proceed (min_live). Socket-failure injection rides the cluster conf
(ms_inject_socket_failures) independently.
"""

from __future__ import annotations

import asyncio
import random

from ceph_tpu_torch.common.log import Dout

log = Dout("osd")


class Thrasher:
    def __init__(self, cluster, min_live: int = 2,
                 down_interval: float = 0.5, revive_delay: float = 0.8,
                 seed: int | None = None):
        self.cluster = cluster
        self.min_live = min_live
        self.down_interval = down_interval
        self.revive_delay = revive_delay
        self.rng = random.Random(seed)
        self.dead: set[int] = set()
        self.kills = 0
        self.revives = 0
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()

    def start(self) -> None:
        self._stopped.clear()
        self._task = asyncio.create_task(self._loop())

    async def stop(self, revive_all: bool = True) -> None:
        """Halt thrashing; by default revive everything and wait for the
        cluster to see the OSDs up again."""
        self._stopped.set()
        if self._task is not None:
            await self._task
            self._task = None
        if revive_all:
            for osd_id in sorted(self.dead):
                await self.cluster.revive_osd(osd_id)
                self.revives += 1
            self.dead.clear()

    # -- single deterministic decisions (chaos-harness composition) -----
    async def kill_one(self) -> int | None:
        """Down one random live OSD (respecting min_live); returns its
        id, or None when no kill is allowed.  Drawing the victim from
        the seeded rng keeps a scheduled chaos run replayable."""
        live = sorted(self.cluster.osds)
        if len(live) <= self.min_live:
            return None
        victim = self.rng.choice(live)
        log.dout(1, "thrasher: killing osd.%d", victim)
        await self.cluster.kill_osd(victim)
        self.dead.add(victim)
        self.kills += 1
        return victim

    async def revive_oldest(self) -> int | None:
        """Revive the longest-dead OSD; returns its id or None."""
        if not self.dead:
            return None
        osd_id = sorted(self.dead)[0]
        log.dout(1, "thrasher: reviving osd.%d", osd_id)
        try:
            await self.cluster.revive_osd(osd_id)
        except (ConnectionError, TimeoutError) as e:
            log.derr("thrasher: revive osd.%d failed: %s", osd_id, e)
            return None
        self.dead.discard(osd_id)
        self.revives += 1
        return osd_id

    async def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                await asyncio.wait_for(
                    self._stopped.wait(), self.down_interval
                )
                return
            except asyncio.TimeoutError:
                pass
            await self.kill_one()
            # revive the longest-dead osd after a delay
            if self.dead:
                try:
                    await asyncio.wait_for(
                        self._stopped.wait(), self.revive_delay
                    )
                    return
                except asyncio.TimeoutError:
                    pass
                await self.revive_oldest()
