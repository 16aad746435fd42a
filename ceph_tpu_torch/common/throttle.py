"""Byte/count throttles with backpressure and perf accounting.

Counterpart of ceph_tpu/common/throttle.py: the same module over the
port's imports.

The role of reference src/common/Throttle.{h,cc}: a counted resource
budget that ingress paths acquire before proceeding; when the budget is
exhausted the caller waits (backpressure propagates to the socket),
FIFO-fair so a large request cannot be starved by a stream of small
ones.  Used by the messenger's dispatch throttle (Policy throttlers)
and the OSD's client-message cap.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque


class Throttle:
    def __init__(self, name: str, max_units: int, perf=None):
        self.name = name
        self.max = int(max_units)          # 0 = unlimited
        self.current = 0
        self._waiters: deque[tuple[int, asyncio.Future]] = deque()
        self.takes = 0
        self.puts = 0
        self.waits = 0
        self.wait_seconds = 0.0

    def _grantable(self, units: int) -> bool:
        # a request larger than max must not deadlock: it proceeds alone
        # once the throttle drains (reference Throttle::_should_wait)
        return (self.current == 0 or
                self.current + units <= self.max)

    async def acquire(self, units: int = 1) -> None:
        self.takes += 1
        if not self.max:
            self.current += units
            return
        if not self._waiters and self._grantable(units):
            self.current += units
            return
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append((units, fut))
        self.waits += 1
        t0 = time.perf_counter()
        try:
            await fut
        except asyncio.CancelledError:
            # release() may have granted us (current += units) before
            # the cancellation landed; give the units back or the
            # shared budget shrinks forever
            if fut.cancelled() is False and fut.done():
                self.release(units)
            raise
        finally:
            self.wait_seconds += time.perf_counter() - t0

    def try_acquire(self, units: int = 1) -> bool:
        if self.max and (self._waiters or not self._grantable(units)):
            return False
        self.takes += 1
        self.current += units
        return True

    def release(self, units: int = 1) -> None:
        self.puts += 1
        self.current = max(0, self.current - units)
        # FIFO grant: wake in order while budget lasts
        while self._waiters:
            units_w, fut = self._waiters[0]
            if fut.cancelled():
                self._waiters.popleft()
                continue
            if not self._grantable(units_w):
                break
            self._waiters.popleft()
            self.current += units_w
            fut.set_result(None)

    def dump(self) -> dict:
        return {
            "val": self.current, "max": self.max,
            "get": self.takes, "put": self.puts,
            "wait": self.waits,
            "wait_sec": round(self.wait_seconds, 6),
            "waiters": len(self._waiters),
        }
