"""Capped exponential backoff with deterministic jitter.

Counterpart of ceph_tpu/common/backoff.py: the same module over the
port's imports.

The reference's Objecter/MonClient reconnect discipline (exponential with
a cap, jittered so a thundering herd of clients desynchronises) — but the
jitter stream is seeded from a (seed, name) pair, so a test or chaos run
replays the exact same sleep schedule.
"""

from __future__ import annotations

import asyncio
import random


class ExpBackoff:
    """delay(n) = min(cap, base * factor**n) * jitter, jitter in [0.5, 1).

    ``reset()`` after a success; ``next_delay()`` returns the next delay
    and advances; ``sleep()`` awaits it.
    """

    def __init__(self, base: float = 0.05, cap: float = 1.0,
                 factor: float = 2.0, seed: int | str | None = None,
                 name: str = ""):
        self.base = base
        self.cap = cap
        self.factor = factor
        self.attempt = 0
        self.rng = random.Random(f"{seed}:{name}"
                                 if seed is not None else None)

    def reset(self) -> None:
        self.attempt = 0

    def next_delay(self) -> float:
        raw = min(self.cap, self.base * (self.factor ** self.attempt))
        self.attempt += 1
        return raw * (0.5 + 0.5 * self.rng.random())

    async def sleep(self) -> float:
        d = self.next_delay()
        await asyncio.sleep(d)
        return d
