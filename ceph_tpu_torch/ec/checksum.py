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

``Lmap`` is a (32 x 8L) 0/1 bitmatrix: a (4 x L) block matrix of 8x8
blocks, i.e. a contraction with L input rows and 4 output rows.  A batch
of B streams of L bytes, laid out as an (L, B) byte matrix (row j = byte
j of every stream), goes through the byte kernel B2
(``cuda_kernels.gf2_apply_u8``), the kernel that carries every other
byte-layout apply of the port, and comes out as (4, B): the register's
four little-endian bytes per stream.  The seed part never touches the
device: ``crc32c(seed, zeros(L))`` IS ``~A^L(~seed)``, so::

    crc32c(seed, data) == Lmap(data) ^ crc32c(seed, b"\\x00" * L)

computed with the native host CRC over a cached zero buffer.

The JAX package contracts Lmap with an XLA einsum (its engine's
``_apply_bitmatrix``) and fuses the scrub's parity compare into the same
launch; here the compare is a torch op and the contraction one B2
launch.  ``supported_len`` gates the device path exactly as the JAX
package does (streams up to ``CRC_DEVICE_MAX_LEN`` bytes), so both send
the same lengths to the device; callers fall back to the host CRC beyond
the gate.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ceph_tpu_torch.common.crc32c import crc32c, table as crc_table
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec.engine import default_engine

# Device-path length gate (the JAX package's): 64 KiB shard streams,
# whose B2 field tables are (4, 65536, 5) uint32 = 5 MiB per length.
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


@functools.lru_cache(maxsize=8)
def crc_constants(length: int) -> ck.GF2Constants:
    """B2's constants of Lmap for ``length``-byte streams (mout = 4, kin =
    length), cached per length as the JAX package caches its bf16
    matrix."""
    return ck.GF2Constants(crc_bitmatrix(length))


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
    stays on its device; a numpy batch is copied to ``device``.  One B2
    launch over the (L, B) transpose of the batch."""
    streams = _tensor(streams, device)
    B, L = int(streams.shape[0]), int(streams.shape[1])
    columns = streams.reshape(B, L).t().contiguous()        # (L, B)
    out = ck.gf2_apply_u8(crc_constants(L), columns)        # (4, B)
    return out.t()


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
    (one launch over all B*n streams).  Returns host ``(eq (B, n) bool
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
