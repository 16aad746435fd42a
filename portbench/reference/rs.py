"""Reed-Solomon over GF(2^8) in plain NumPy: the code the ``jax_rs``
plugin's ``reed_sol_van`` technique names, for checking what the port
stores and reads back.

The field is GF(2^8) with the polynomial x^8 + x^4 + x^3 + x^2 + 1
(0x11d, jerasure's w = 8).  The generator is the systematic Vandermonde
matrix: rows i = 0 .. k+m-1 of V[i][j] = i^j (0^0 = 1), brought to an
identity on its first k rows by elementary column operations, which keep
every k rows independent.  The port's stored shards follow this matrix
(the repository's corpus file for k=8 m=4 pins its chunk digests).
Jerasure goes on to scale rows and columns so that the first parity row
is all ones; this matrix does not, so its parity bytes differ from
upstream Ceph's.

A stripe is k chunks of ``chunk`` bytes; an object of S bytes is padded
with zeros to whole stripes, and shard i holds chunk i of every stripe,
in stripe order.  Parity is linear per byte column, so encoding whole
shard streams equals encoding stripe by stripe.
"""

from __future__ import annotations

import numpy as np

POLY = 0x11D


def _tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    return exp, log


EXP, LOG = _tables()
#: MUL[a, b] = a * b in GF(2^8)
MUL = np.zeros((256, 256), np.uint8)
_nz = np.arange(1, 256)
MUL[1:, 1:] = EXP[LOG[_nz][:, None] + LOG[_nz][None, :]]


def mul(a: int, b: int) -> int:
    return int(MUL[a, b])


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(EXP[255 - LOG[a]])


def power(a: int, n: int) -> int:
    out = 1
    for _ in range(n):
        out = mul(out, a)
    return out


def generator(k: int, m: int) -> np.ndarray:
    """The (k+m, k) systematic generator: identity over the m x k
    coding rows."""
    if k + m > 256:
        raise ValueError("k+m must be at most 256 in GF(2^8)")
    g = np.array([[power(i, j) for j in range(k)] for i in range(k + m)],
                 np.uint8)
    for i in range(k):
        if g[i, i] == 0:
            j = next(j for j in range(i + 1, k) if g[i, j])
            g[:, [i, j]] = g[:, [j, i]]
        g[:, i] = MUL[inv(int(g[i, i])), g[:, i]]
        for j in range(k):
            if j != i and g[i, j]:
                g[:, j] ^= MUL[int(g[i, j]), g[:, i]]
    return g


def apply(matrix: np.ndarray, streams: np.ndarray) -> np.ndarray:
    """out[r] = XOR_c matrix[r, c] * streams[c] over GF(2^8), for
    (rows, cols) coefficients and (cols, L) uint8 streams."""
    out = np.zeros((matrix.shape[0], streams.shape[1]), np.uint8)
    for r in range(matrix.shape[0]):
        for c in range(matrix.shape[1]):
            coef = int(matrix[r, c])
            if coef:
                out[r] ^= MUL[coef][streams[c]]
    return out


def invert(a: np.ndarray) -> np.ndarray:
    """The inverse of a square matrix over GF(2^8) (Gauss-Jordan)."""
    n = a.shape[0]
    work = np.concatenate([a.astype(np.uint8), np.eye(n, dtype=np.uint8)],
                          axis=1)
    for col in range(n):
        piv = next((r for r in range(col, n) if work[r, col]), None)
        if piv is None:
            raise ValueError("singular matrix")
        work[[col, piv]] = work[[piv, col]]
        work[col] = MUL[inv(int(work[col, col])), work[col]]
        for r in range(n):
            if r != col and work[r, col]:
                work[r] ^= MUL[int(work[r, col]), work[col]]
    return work[:, n:]


class Code:
    """One k+m code over chunks of ``chunk`` bytes."""

    def __init__(self, k: int, m: int, chunk: int):
        self.k, self.m, self.chunk = k, m, chunk
        self.gen = generator(k, m)

    @property
    def stripe_width(self) -> int:
        return self.k * self.chunk

    def data_shards(self, payload: bytes) -> np.ndarray:
        """(k, L) shard streams of an object's bytes, zero-padded to
        whole stripes (at least one)."""
        w = self.stripe_width
        size = max(w, -(-len(payload) // w) * w)
        buf = np.zeros(size, np.uint8)
        buf[:len(payload)] = np.frombuffer(payload, np.uint8)
        stripes = buf.reshape(-1, self.k, self.chunk)
        return np.ascontiguousarray(stripes.transpose(1, 0, 2)).reshape(
            self.k, -1)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """(k, L) data streams -> (m, L) parity streams."""
        return apply(self.gen[self.k:], data)

    def shards(self, payload: bytes) -> np.ndarray:
        """All k+m shard streams of an object."""
        data = self.data_shards(payload)
        return np.concatenate([data, self.encode(data)])

    def decode(self, have: dict[int, np.ndarray]) -> np.ndarray:
        """(k, L) data streams from any k of the k+m shard positions."""
        pos = sorted(have)[:self.k]
        if len(pos) < self.k:
            raise ValueError(f"need {self.k} shards, have {len(pos)}")
        sub = self.gen[pos]
        return apply(invert(sub), np.stack([have[p] for p in pos]))

    def object_bytes(self, data: np.ndarray, size: int) -> bytes:
        """The first ``size`` logical bytes of (k, L) data streams."""
        stripes = data.reshape(self.k, -1, self.chunk).transpose(1, 0, 2)
        return stripes.tobytes()[:size]
