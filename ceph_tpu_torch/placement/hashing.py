"""rjenkins1 32-bit mix hashes, vectorized over numpy uint32 arrays.

Counterpart of ceph_tpu/placement/hashing.py: the same module over the
port's imports.

Semantic mirror of reference src/crush/hash.c (crush_hashmix macro +
crush_hash32_rjenkins1{,_2,_3,_4,_5}); the mix schedules and the
1315423911 seed are wire-compatibility constants of CRUSH. The C
crush_hashmix macro MUTATES its first two operands in the caller, and
later mixes reuse those mutated locals — the x/y threading below
reproduces that exactly. All math is mod-2^32 (numpy uint32 wraparound).
"""

from __future__ import annotations

import numpy as np

CRUSH_HASH_SEED = np.uint32(1315423911)
_X = np.uint32(231232)
_Y = np.uint32(1232)


def _mix(a, b, c):
    """One crush_hashmix round; returns updated (a, b, c)."""
    with np.errstate(over="ignore"):
        a = a - b
        a = a - c
        a = a ^ (c >> np.uint32(13))
        b = b - c
        b = b - a
        b = b ^ (a << np.uint32(8))
        c = c - a
        c = c - b
        c = c ^ (b >> np.uint32(13))
        a = a - b
        a = a - c
        a = a ^ (c >> np.uint32(12))
        b = b - c
        b = b - a
        b = b ^ (a << np.uint32(16))
        c = c - a
        c = c - b
        c = c ^ (b >> np.uint32(5))
        a = a - b
        a = a - c
        a = a ^ (c >> np.uint32(3))
        b = b - c
        b = b - a
        b = b ^ (a << np.uint32(10))
        c = c - a
        c = c - b
        c = c ^ (b >> np.uint32(15))
    return a, b, c


def _u32(v) -> np.ndarray:
    return np.asarray(v).astype(np.uint32)


def crush_hash32(a):
    a = _u32(a)
    hash_ = CRUSH_HASH_SEED ^ a
    b, x, y = a, _X, _Y
    b, x, hash_ = _mix(b, x, hash_)
    y, a, hash_ = _mix(y, a, hash_)
    return hash_


def crush_hash32_2(a, b):
    a, b = _u32(a), _u32(b)
    hash_ = CRUSH_HASH_SEED ^ a ^ b
    x, y = _X, _Y
    a, b, hash_ = _mix(a, b, hash_)
    x, a, hash_ = _mix(x, a, hash_)
    b, y, hash_ = _mix(b, y, hash_)
    return hash_


def crush_hash32_3(a, b, c):
    a, b, c = _u32(a), _u32(b), _u32(c)
    hash_ = CRUSH_HASH_SEED ^ a ^ b ^ c
    x, y = _X, _Y
    a, b, hash_ = _mix(a, b, hash_)
    c, x, hash_ = _mix(c, x, hash_)
    y, a, hash_ = _mix(y, a, hash_)
    b, x, hash_ = _mix(b, x, hash_)
    y, c, hash_ = _mix(y, c, hash_)
    return hash_


def crush_hash32_4(a, b, c, d):
    a, b, c, d = _u32(a), _u32(b), _u32(c), _u32(d)
    hash_ = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x, y = _X, _Y
    a, b, hash_ = _mix(a, b, hash_)
    c, d, hash_ = _mix(c, d, hash_)
    a, x, hash_ = _mix(a, x, hash_)
    y, b, hash_ = _mix(y, b, hash_)
    c, x, hash_ = _mix(c, x, hash_)
    y, d, hash_ = _mix(y, d, hash_)
    return hash_


def ceph_str_hash_rjenkins(s: str | bytes) -> int:
    """Object-name hash (reference src/common/ceph_hash.cc
    ceph_str_hash_rjenkins): maps an object name to its placement seed
    ``ps = hash % pg_num`` (pg_pool_t::hash semantics)."""
    k = s.encode() if isinstance(s, str) else bytes(s)
    length = len(k)
    a = np.uint32(0x9E3779B9)
    b = np.uint32(0x9E3779B9)
    c = np.uint32(0)
    pos = 0
    rem = length
    with np.errstate(over="ignore"):
        while rem >= 12:
            a = a + np.uint32(int.from_bytes(k[pos:pos + 4], "little"))
            b = b + np.uint32(int.from_bytes(k[pos + 4:pos + 8], "little"))
            c = c + np.uint32(int.from_bytes(k[pos + 8:pos + 12], "little"))
            a, b, c = _mix(a, b, c)
            pos += 12
            rem -= 12
        c = c + np.uint32(length)
        # trailing bytes; c's low byte is reserved for the length
        t = k[pos:]
        if rem >= 11:
            c = c + (np.uint32(t[10]) << np.uint32(24))
        if rem >= 10:
            c = c + (np.uint32(t[9]) << np.uint32(16))
        if rem >= 9:
            c = c + (np.uint32(t[8]) << np.uint32(8))
        if rem >= 8:
            b = b + (np.uint32(t[7]) << np.uint32(24))
        if rem >= 7:
            b = b + (np.uint32(t[6]) << np.uint32(16))
        if rem >= 6:
            b = b + (np.uint32(t[5]) << np.uint32(8))
        if rem >= 5:
            b = b + np.uint32(t[4])
        if rem >= 4:
            a = a + (np.uint32(t[3]) << np.uint32(24))
        if rem >= 3:
            a = a + (np.uint32(t[2]) << np.uint32(16))
        if rem >= 2:
            a = a + (np.uint32(t[1]) << np.uint32(8))
        if rem >= 1:
            a = a + np.uint32(t[0])
        a, b, c = _mix(a, b, c)
    return int(c)


def crush_hash32_5(a, b, c, d, e):
    a, b, c, d, e = _u32(a), _u32(b), _u32(c), _u32(d), _u32(e)
    hash_ = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d ^ e
    x, y = _X, _Y
    a, b, hash_ = _mix(a, b, hash_)
    c, d, hash_ = _mix(c, d, hash_)
    e, x, hash_ = _mix(e, x, hash_)
    y, a, hash_ = _mix(y, a, hash_)
    b, x, hash_ = _mix(b, x, hash_)
    y, c, hash_ = _mix(y, c, hash_)
    d, x, hash_ = _mix(d, x, hash_)
    y, e, hash_ = _mix(y, e, hash_)
    return hash_
