"""Object bodies from the seed.  Every body is distinct (a 16-byte
header of the seed and the write's id) and the rest is a window into one
random buffer made once per run, so a body costs a copy, not a random
draw, on the event loop that also runs the daemons."""

from __future__ import annotations

import struct

import numpy as np

BASE_BYTES = 64 << 20
HEADER = struct.Struct("<QQ")
# a multiplier odd and large, so consecutive ids land far apart
STEP = 0x9E3779B97F4A7C15


def seed64(seed: int) -> int:
    return seed % (1 << 64)


class Payloads:
    def __init__(self, seed: int, size: int):
        if size < HEADER.size:
            raise ValueError(f"objects of {size} B: at least "
                             f"{HEADER.size} B")
        self.seed = seed64(seed)
        self.size = size
        rng = np.random.default_rng([self.seed, 0xB0D1])
        self.base = rng.bytes(max(BASE_BYTES, 2 * size))

    def get(self, op_id: int) -> bytes:
        n = self.size - HEADER.size
        span = len(self.base) - n + 1
        off = ((op_id + 1) * STEP % (1 << 64)) % span
        return HEADER.pack(self.seed, op_id % (1 << 64)) + \
            self.base[off:off + n]
