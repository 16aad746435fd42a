"""mClock op scheduler: reservation / weight / limit QoS across op
classes.

Counterpart of ceph_tpu/osd/scheduler.py: the same module over the
port's imports.

The role of reference src/osd/scheduler/mClockScheduler.{h,cc} (dmClock,
src/dmclock submodule) in asyncio form: every op class (client,
recovery, backfill, scrub — the reference's client /
background_recovery / background_best_effort) gets a reservation R
(guaranteed ops/s), a
weight W (share of spare capacity), and a limit L (ops/s cap). Each
submission is stamped with dmClock tags:

    r_tag = max(now, prev_r + 1/R)      reservation clock
    l_tag = max(now, prev_l + 1/L)      limit clock
    p_tag = max(now, prev_p + 1/W)      proportional-share clock

Dispatch prefers any op whose reservation tag is due (reservations are
met first, so a recovery storm cannot push client ops past their
guaranteed rate), then shares the remainder by weight among ops under
their limit — the two-phase pull of the dmClock server loop.

Within one class tags are monotonic, so a per-class FIFO keeps every
queue head the class's next candidate and each grant costs O(classes)
(no heap scans — the structure dmClock's ClientRec queues use).

Ops are admitted (started), not time-sliced: the scheduler paces op
STARTS, matching the reference's queue semantics.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass


@dataclass
class ClassProfile:
    reservation: float       # guaranteed ops/s (0 = none)
    weight: float            # share of spare capacity
    limit: float             # ops/s cap (0 = unlimited)


DEFAULT_PROFILES = {
    # the mclock_scheduler built-in "balanced"-style profile shape.
    # Default limits are 0 (uncapped): the asyncio runtime is not
    # thread-contended, so out of the box QoS only ORDERS dispatch
    # (client first via reservation + weight) without pacing anything;
    # operators enable hard caps per class via configuration, exactly
    # like tuning osd_mclock_* in the reference.
    "client": ClassProfile(reservation=100.0, weight=10.0, limit=0.0),
    "recovery": ClassProfile(reservation=10.0, weight=1.0, limit=0.0),
    "backfill": ClassProfile(reservation=5.0, weight=1.0, limit=0.0),
    "scrub": ClassProfile(reservation=5.0, weight=1.0, limit=0.0),
}

_INF = float("inf")


@dataclass
class _Req:
    r_tag: float
    l_tag: float
    p_tag: float
    fut: asyncio.Future
    cost: int = 1


class MClockScheduler:
    def __init__(self, profiles: dict[str, ClassProfile] | None = None,
                 clock=time.monotonic, journal=None):
        self.profiles = dict(profiles or DEFAULT_PROFILES)
        self.clock = clock
        self.journal = journal      # flight recorder; retunes land here
        self.retunes = 0
        self._prev: dict[str, tuple[float, float, float]] = {}
        self._queues: dict[str, deque[_Req]] = {}
        self._dispatched: dict[str, int] = {}
        self._task: asyncio.Task | None = None
        self._wake = asyncio.Event()
        self._stopped = False

    # -- runtime retuning --------------------------------------------------
    def set_profile(self, clazz: str, reservation: float | None = None,
                    weight: float | None = None,
                    limit: float | None = None) -> dict | None:
        """Retune one class's R/W/L at runtime (the QoS controller's
        mClock actuator; also reachable via the ``mclock set`` asok).
        Omitted fields keep their current value; an unknown class needs
        all three.  Already-stamped tags keep the rates they were
        issued under — only ops submitted after the change pace at the
        new profile.  Returns a change record (journaled as
        ``mclock.retune``) or None when nothing moved."""
        prof = self.profiles.get(clazz)
        if prof is None and None in (reservation, weight, limit):
            return None
        new = ClassProfile(
            reservation=float(prof.reservation if reservation is None
                              else reservation),
            weight=float(prof.weight if weight is None else weight),
            limit=float(prof.limit if limit is None else limit),
        ) if prof is not None else ClassProfile(
            float(reservation), float(weight), float(limit))
        if prof is not None and new == prof:
            return None
        self.profiles[clazz] = new
        self.retunes += 1
        change = {
            "clazz": clazz,
            "reservation": new.reservation,
            "weight": new.weight,
            "limit": new.limit,
            "prev": None if prof is None else {
                "reservation": prof.reservation,
                "weight": prof.weight,
                "limit": prof.limit,
            },
        }
        if self.journal is not None:
            self.journal.emit(
                "mclock.retune", clazz=clazz,
                reservation=round(new.reservation, 3),
                weight=round(new.weight, 3),
                limit=round(new.limit, 3),
                prev_limit=round(prof.limit, 3) if prof else -1.0)
        # re-evaluate queued heads: a raised limit may make one due now
        self._wake.set()
        return change

    def profiles_dump(self) -> dict[str, dict]:
        return {c: {"reservation": p.reservation, "weight": p.weight,
                    "limit": p.limit}
                for c, p in sorted(self.profiles.items())}

    # -- submission --------------------------------------------------------
    async def acquire(self, clazz: str, cost: int = 1) -> None:
        """Wait for this op's dispatch slot. Ops of an unknown class run
        immediately (fail-open: QoS must never wedge the data path).

        ``cost`` charges one submission as that many class-ops against
        the R/W/L clocks — a batched request (the repair engine drains
        dozens of objects per launch) advances the tags as if each
        member had queued individually, so batching cannot be used to
        sneak recovery work past the class's configured rates."""
        prof = self.profiles.get(clazz)
        if prof is None or self._stopped:
            return
        cost = max(1, int(cost))
        now = self.clock()
        pr, pl, pp = self._prev.get(clazz, (0.0, 0.0, 0.0))
        r_tag = (max(now, pr + cost / prof.reservation)
                 if prof.reservation > 0 else _INF)
        l_tag = (max(now, pl + cost / prof.limit)
                 if prof.limit > 0 else now)
        p_tag = (max(now, pp + cost / prof.weight)
                 if prof.weight > 0 else _INF)
        self._prev[clazz] = (
            r_tag if r_tag != _INF else pr,
            l_tag,
            p_tag if p_tag != _INF else pp,
        )
        fut = asyncio.get_running_loop().create_future()
        self._queues.setdefault(clazz, deque()).append(
            _Req(r_tag, l_tag, p_tag, fut, cost)
        )
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._dispatch_loop()
            )
        self._wake.set()
        await fut

    def stats(self) -> dict[str, int]:
        return dict(self._dispatched)

    def queue_depths(self) -> dict[str, int]:
        """Current per-class backlog (ops waiting in acquire) — the
        flight recorder samples this each heartbeat so a forensic
        timeline shows WHICH class's queue grew before an SLO burn."""
        return {c: len(q) for c, q in self._queues.items() if q}

    def shutdown(self) -> None:
        """Cancel everything queued: an op blocked in acquire() at
        daemon teardown must NOT be released to execute against a
        half-shutdown store/messenger."""
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
        for q in self._queues.values():
            for req in q:
                if not req.fut.done():
                    req.fut.cancel()
            q.clear()

    # -- dispatch ----------------------------------------------------------
    def _grant(self, clazz: str) -> None:
        req = self._queues[clazz].popleft()
        if not req.fut.done():
            req.fut.set_result(None)
            self._dispatched[clazz] = (
                self._dispatched.get(clazz, 0) + req.cost
            )

    async def _dispatch_loop(self) -> None:
        while not self._stopped:
            now = self.clock()
            # drop cancelled heads
            for q in self._queues.values():
                while q and q[0].fut.done():
                    q.popleft()
            heads = {c: q[0] for c, q in self._queues.items() if q}
            if not heads:
                self._wake.clear()
                await self._wake.wait()
                continue
            # phase 1: due reservations, earliest r_tag first
            res_due = [(req.r_tag, c) for c, req in heads.items()
                       if req.r_tag <= now]
            if res_due:
                self._grant(min(res_due)[1])
                await asyncio.sleep(0)       # let the op start
                continue
            # phase 2: weight shares among classes under their limit
            prop_due = [(req.p_tag, c) for c, req in heads.items()
                        if req.l_tag <= now]
            if prop_due:
                self._grant(min(prop_due)[1])
                await asyncio.sleep(0)
                continue
            # nothing eligible: sleep to the earliest future tag
            horizon = min(
                min((req.r_tag for req in heads.values()), default=_INF),
                min((req.l_tag for req in heads.values()), default=_INF),
            )
            delay = max(0.0, horizon - now)
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(),
                                       min(delay, 0.05) + 1e-4)
            except asyncio.TimeoutError:
                pass
