r"""Device CRC32C: chunk checksums as a GF(2) bitmatrix contraction.

Counterpart of ceph_tpu/ec/checksum.py, with the same names, length gate
and results.

CRC32C (Castagnoli) is GF(2)-linear in its input once the pre/post
inversions are factored out.  Writing the table-loop register step
(common/crc32c.py)::

    r' = T[(r ^ b) & 0xFF] ^ (r >> 8)
       = A(r) ^ T[b]          with A(r) = (r >> 8) ^ T[r & 0xFF]

(the table is linear: T[i ^ j] = T[i] ^ T[j]) shows that the register
after L bytes splits into an affine seed part and a data part that is a
pure GF(2) linear map::

    r_L = A^L(r_0) ^ sum_j A^{L-1-j}(T[b_j])
              \--- seed ---/   \------ Lmap(data) ------/

``Lmap`` is a (32 x 8L) 0/1 bitmatrix.  The seed part never touches
the device: ``crc32c(seed, zeros(L))`` IS ``~A^L(~seed)``, so::

    crc32c(seed, data) == Lmap(data) ^ crc32c(seed, b"\\x00" * L)

computed with the native host CRC over a cached zero buffer.

The JAX package contracts Lmap with an XLA einsum (its engine's
``_apply_bitmatrix``) and fuses the scrub's parity compare into the same
launch.  Here the contraction is a chain of launches of the byte kernel
B2 (``cuda_kernels.gf2_apply_u8``), built by :class:`CrcPlan`, and the
compare a torch op.  Lmap is linear, so a stream is cut into S segments
of P bytes (front-padded with zero bytes to S * P, which leaves Lmap
unchanged because it is indexed from the stream's end) and each segment
into 16 lanes (byte j = 16 g + k of a segment is row g of lane k)::

    Lmap(data) = sum_k A^{15-k} sum_s A^{P (S-1-s)} u_{s,k}
    u_{s,k}    = sum_g A^{16 (P/16-1-g)} T[b_{s P + 16 g + k}]

Step 1 computes every u: one B2 apply with kin = P/16 rows and mout = 4
over (B*S, P/16, 16), the streams as they lie (a thread's 16 bytes are
one row of one segment's 16 lanes).  The S segment partials of each lane
are then folded by B2 applies of kin = 4F over (rows of F partials, 4,
16) in place, each a map sum_i A^{unit (F-1-i)} r_i of consecutive
partials (unit = the bytes each partial covers), until one partial per
stream and lane is left; the (B, 4, 16) lanes are transposed to (16, 4,
B) (64 bytes per stream, the one copy) and folded the same way with unit
1.  Every step is a contiguous reshape of the last output: no launch
walks more than P/16 or 4F rows, where the single (4 x L) contraction
walked all L rows in one thread block.  The fold stays on the device;
the host receives the 4-byte registers.

``supported_len`` gates the device path exactly as the JAX package does
(streams up to ``CRC_DEVICE_MAX_LEN`` bytes), so both send the same
lengths to the device; callers fall back to the host CRC beyond the
gate.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ceph_tpu_torch.common.crc32c import crc32c, table as crc_table
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec.engine import default_engine

# Device-path length gate (the JAX package's): 64 KiB shard streams.
CRC_DEVICE_MAX_LEN = 1 << 16

CRC_SEED = 0xFFFFFFFF          # HashInfo's initial per-shard seed


def supported_len(length: int, max_len: int | None = None) -> bool:
    """True when ``length``-byte streams may take the device CRC path."""
    cap = CRC_DEVICE_MAX_LEN if max_len is None else int(max_len)
    return 0 < int(length) <= min(cap, (1 << 21) - 1)


@functools.lru_cache(maxsize=8)
def crc_bitmatrix(length: int) -> np.ndarray:
    """(32, 8*length) uint8 0/1 matrix M with M @ bits(data) = Lmap(data).

    Column q = 8*j + s holds the 32 register bits contributed by bit s of
    byte j, i.e. A^{L-1-j}(T[1 << s]); row p is register bit p (output
    byte p//8, bit p%8 — little-endian uint32 across the 4 output
    bytes).
    """
    L = int(length)
    tbl = np.array(crc_table(), dtype=np.uint32)
    cols = np.empty((L, 8), np.uint32)
    r = tbl[np.array([1 << s for s in range(8)], np.int64)]
    cols[L - 1] = r
    for m in range(1, L):
        r = (r >> np.uint32(8)) ^ tbl[r & np.uint32(0xFF)]
        cols[L - 1 - m] = r
    bits = ((cols[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1)
    return bits.astype(np.uint8).transpose(2, 0, 1).reshape(32, 8 * L)


# The split-L form's shape (CrcPlan): P bytes per segment, at most
# SEG_FAN segment partials folded per launch, and the 16 lanes folded
# LANE_FANS at a time.  Chosen on the card by testing.crc_builds: every
# plan of the sweep is bound by its launches' enqueue (about 40 us each on
# an NVIDIA H100 80GB HBM3, 700.00 W), so the fewest launches win: 3 at
# 64 KiB streams (PERF.md).
SEG_BYTES = 4096
SEG_FAN = 16
LANE_FANS = (16,)
LANES = 16              # bytes of a segment row: one 16-byte unit of B2


def _shift_matrix() -> np.ndarray:
    """(32, 32) 0/1 matrix of A(r) = (r >> 8) ^ T[r & 0xFF]: column p is
    A(1 << p), row q is register bit q."""
    tbl = np.array(crc_table(), dtype=np.uint32)
    r = np.uint32(1) << np.arange(32, dtype=np.uint32)
    cols = (r >> np.uint32(8)) ^ tbl[r & np.uint32(0xFF)]
    return ((cols[None, :] >> np.arange(32, dtype=np.uint32)[:, None])
            & 1).astype(np.uint8)


def shift_power(n: int) -> np.ndarray:
    """A^n as a (32, 32) 0/1 matrix (square and multiply over GF(2))."""
    out = np.eye(32, dtype=np.int64)
    base = _shift_matrix().astype(np.int64)
    n = int(n)
    while n:
        if n & 1:
            out = (base @ out) & 1
        base = (base @ base) & 1
        n >>= 1
    return out.astype(np.uint8)


def fold_bitmatrix(fan: int, unit: int) -> np.ndarray:
    """(32, 32 * fan) bitmatrix folding ``fan`` consecutive partial
    registers r_0..r_{fan-1}, each over ``unit`` bytes, into
    sum_i A^{unit (fan-1-i)} r_i.  Input row 4 i + q is byte q of r_i, so
    column 8 (4 i + q) + t is register bit 8 q + t of partial i."""
    return np.concatenate([shift_power(unit * (fan - 1 - i))
                           for i in range(fan)], axis=1)


def _fans(count: int, fan: int) -> tuple[int, ...]:
    """Factors of the power of two ``count``, each at most ``fan``,
    largest first."""
    out = []
    while count > 1:
        f = min(fan, count)
        out.append(f)
        count //= f
    return tuple(out)


class CrcPlan:
    """The B2 launches of Lmap for ``length``-byte streams (module
    docstring): step 1 over segments of ``seg_bytes`` (at most; a shorter
    stream is one segment of its length rounded up to 16), segment folds
    of at most ``seg_fan`` partials, lane folds by ``lane_fans``
    (product 16; ``seg_fan`` a power of two).  The segment count is a
    power of two; the stream is
    front-padded with zero bytes to ``padded = segments * seg``."""

    def __init__(self, length: int, seg_bytes: int = SEG_BYTES,
                 seg_fan: int = SEG_FAN,
                 lane_fans: tuple[int, ...] = LANE_FANS):
        L = int(length)
        if L <= 0 or seg_bytes % LANES or seg_bytes <= 0:
            raise ValueError(f"length {L}, segment {seg_bytes}")
        if (int(np.prod(lane_fans)) != LANES or seg_fan < 2
                or seg_fan & (seg_fan - 1)):
            raise ValueError(f"lane fans {lane_fans}, segment fan {seg_fan}")
        self.length = L
        self.seg = min(int(seg_bytes), -(-L // LANES) * LANES)
        segs = -(-L // self.seg)
        self.segments = 1 << (segs - 1).bit_length()
        self.padded = self.segments * self.seg
        self.pad = self.padded - L
        rows = self.seg // LANES
        # step 1: row g of a segment's lanes, A^{16 (rows-1-g)} T[.] (the
        # columns of Lmap_seg at bytes 16 g + 15)
        step1 = crc_bitmatrix(self.seg).reshape(32, rows, LANES, 8)
        self.step1 = ck.GF2Constants(np.ascontiguousarray(
            step1[:, :, LANES - 1, :]).reshape(32, 8 * rows))
        self.seg_folds = []
        unit = self.seg
        for f in _fans(self.segments, int(seg_fan)):
            self.seg_folds.append((f, ck.GF2Constants(
                fold_bitmatrix(f, unit))))
            unit *= f
        self.lane_folds = []
        unit = 1
        for f in lane_fans:
            self.lane_folds.append((f, ck.GF2Constants(
                fold_bitmatrix(f, unit))))
            unit *= f

    @property
    def launches(self) -> int:
        """B2 launches per call, whatever the batch."""
        return 1 + len(self.seg_folds) + len(self.lane_folds)

    def __call__(self, streams: torch.Tensor) -> torch.Tensor:
        """(B, length) uint8 -> (B, 4) uint8 register bytes of Lmap, on
        the streams' device."""
        B = int(streams.shape[0])
        if self.pad:
            x = streams.new_zeros((B, self.padded))
            x[:, self.pad:] = streams
        else:
            x = streams.contiguous()
        y = ck.gf2_apply_u8(self.step1, x.view(
            B * self.segments, self.seg // LANES, LANES))
        for f, consts in self.seg_folds:          # -> (B, 4, 16)
            y = ck.gf2_apply_u8(consts, y.view(-1, 4 * f, LANES))
        z = y.view(B, 4, LANES).permute(2, 1, 0).contiguous()
        for f, consts in self.lane_folds:         # -> (1, 4, B)
            z = ck.gf2_apply_u8(consts, z.view(-1, 4 * f, B))
        return z.view(4, B).t()


@functools.lru_cache(maxsize=8)
def crc_constants(length: int, seg_bytes: int = SEG_BYTES) -> CrcPlan:
    """The split-L plan of Lmap for ``length``-byte streams, its B2
    constants built once per (length, segment), as the JAX package caches
    its bf16 matrix per length."""
    return CrcPlan(length, seg_bytes)


def crc_bits_plain(streams: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`crc_bits_device`: the whole (32, 8L) Lmap
    as one contraction by B2's plain version over the (L, B) transpose.
    (B, 4) uint8 on the streams' device."""
    L = int(streams.shape[1])
    bmat = torch.from_numpy(crc_bitmatrix(L).astype(np.float32)).to(
        streams.device)
    return ck.gf2_apply_u8_plain(bmat, streams.t().contiguous()).t()


@functools.lru_cache(maxsize=64)
def _zeros(length: int) -> bytes:
    return bytes(length)


def zero_crc(seed: int, length: int) -> int:
    """crc32c(seed, b"\\x00" * length) — the affine seed term."""
    return crc32c(seed & 0xFFFFFFFF, _zeros(int(length)))


def _tensor(x, device=None) -> torch.Tensor:
    """A uint8 tensor: a tensor as it is, numpy copied to ``device``
    (None: CUDA, raising without it)."""
    if isinstance(x, torch.Tensor):
        return x
    return default_engine(device).tensor(x)


def crc_bits_device(streams, device=None) -> torch.Tensor:
    """Linear CRC part of a (B, L) uint8 stream batch, on the device.

    Returns a (B, 4) uint8 tensor: the little-endian register bits of
    Lmap(stream) per row.  Finalize with :func:`finalize_crcs`.  A tensor
    stays on its device; a numpy batch is copied to ``device``.  The B2
    launches of ``crc_constants(L)`` (``CrcPlan.launches``, whatever B)."""
    streams = _tensor(streams, device)
    B, L = int(streams.shape[0]), int(streams.shape[1])
    return crc_constants(L)(streams.reshape(B, L))


def finalize_crcs(bits_host: np.ndarray, seeds, length: int) -> list[int]:
    """Combine device register bits with per-stream seeds on host.

    ``bits_host``: (B, 4) uint8 (host copy of :func:`crc_bits_device`).
    ``seeds``: iterable of B seed values (previous cumulative hashes).
    """
    b = np.asarray(bits_host, np.uint32)
    lin = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return [int(lin[i]) ^ zero_crc(s, length)
            for i, s in enumerate(seeds)]


def device_crc32c(streams, seeds=None, device=None) -> list[int]:
    """crc32c over each row of a (B, L) uint8 batch, device-computed.

    Bit-identical to ``crc32c(seed, row.tobytes())`` for every row.
    ``seeds`` defaults to CRC_SEED (0xFFFFFFFF) for all rows.
    """
    B, L = int(streams.shape[0]), int(streams.shape[1])
    if seeds is None:
        seeds = [CRC_SEED] * B
    bits = crc_bits_device(streams, device).cpu().numpy()
    return finalize_crcs(bits, seeds, L)


def verify_batch(recomputed, stored, device=None):
    """Scrub verdict: (B, n) shard-equality bools + (B, n) crcs.

    Compares re-encoded shards against stored shards elementwise (a
    torch op) AND computes each stored stream's CRC register through B2
    (one plan over all B*n streams).  Returns host ``(eq (B, n) bool
    ndarray, crc_regs (B, n) uint32 ndarray)`` where ``crc_regs`` are
    finalized with the standard seed (callers compare against HashInfo
    cumulative hashes, which chain from CRC_SEED).  Numpy inputs are
    copied to ``device``.
    """
    stored = _tensor(stored, device)
    recomputed = _tensor(recomputed, stored.device)
    B, n, L = (int(stored.shape[0]), int(stored.shape[1]),
               int(stored.shape[2]))
    eq = (recomputed == stored).all(dim=-1)
    bits = crc_bits_device(stored.reshape(B * n, L))
    eq = eq.cpu().numpy()
    b = bits.cpu().numpy().astype(np.uint32).reshape(B, n, 4)
    lin = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    crcs = lin ^ np.uint32(zero_crc(CRC_SEED, L) & 0xFFFFFFFF)
    return eq, crcs


def parity_only_batch(recomputed, stored, device=None):
    """Device parity verdict without the CRC epilogue (stream length
    beyond the device-CRC gate).  Returns host (B, n) bool ndarray."""
    stored = _tensor(stored, device)
    recomputed = _tensor(recomputed, stored.device)
    return (recomputed == stored).all(dim=-1).cpu().numpy()
