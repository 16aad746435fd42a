"""GF(2^8) coefficient matrix -> GF(2) bitmatrix expansion.

Port copy of ceph_tpu/ec/bitmatrix.py: same numpy code, kept here so the port
imports nothing of the JAX package.

The core trick behind the device engine: a multiply-by-constant
in GF(2^8) is a linear map over GF(2)^8, so an (m, k) byte matrix expands to
an (8m, 8k) 0/1 matrix, and region encode becomes

    parity_bits = (bitmatrix @ data_bits) mod 2

— a small-by-huge integer matmul that runs as a matmul with exact f32
accumulation (sums <= 8k << 2^24). This mirrors what jerasure's bitmatrix
schedules do with CPU XORs (reference ErasureCodeJerasure.cc:265 schedule
encode), but maps the XOR-accumulate onto wide device arithmetic instead of a
sequential XOR schedule.

Bit order is LSB-first: bit i of byte b is (b >> i) & 1.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ec.gf import gf_mul


def gf_matrix_to_bitmatrix(A: np.ndarray) -> np.ndarray:
    """Expand (m, k) GF(2^8) matrix to (8m, 8k) GF(2) matrix.

    Entry [r*8+i, c*8+j] = bit i of (A[r,c] * 2^j), so that for data bit
    planes d[c*8+j] the parity bit planes are p = (M @ d) mod 2.
    """
    A = np.asarray(A, np.uint8)
    m, k = A.shape
    # prods[r, c, j] = A[r,c] * 2^j
    shifts = (1 << np.arange(8, dtype=np.uint8))
    prods = gf_mul(A[:, :, None], shifts[None, None, :])  # (m, k, 8)
    # bits[r, c, j, i] = bit i of prods[r, c, j]
    bits = (prods[..., None] >> np.arange(8, dtype=np.uint8)) & 1  # (m,k,8,8)
    # target[r*8+i, c*8+j] -> transpose to (m, i, k, j)
    out = bits.transpose(0, 3, 1, 2).reshape(8 * m, 8 * k)
    return np.ascontiguousarray(out.astype(np.uint8))


def expand_bitmatrix_lanes(BM: np.ndarray, lane_bytes: int = 4) -> np.ndarray:
    """(8m, 8k) bitmatrix -> (8L*m, 8L*k) block matrix for L-byte int lanes.

    When chunk bytes ride packed L-to-a-lane in integer registers (uint8
    buffers viewed as int32 words), bit p of byte b of chunk i lives at bit
    8b+p of lane word i.  Byte positions never mix, so the lane-level GF(2)
    matrix is block-diagonal over b:

        out[8L*j + 8b + q, 8L*i + 8b + p] = BM[8j+q, 8i+p]

    This is what turns the (8m x 8k) bitmatrix into a (32m x 32k) matmul
    whose contraction dim fills the 128-wide MXU for k=8 (the utilization
    fix for the small-matrix problem of per-byte bitplanes).
    """
    BM = np.asarray(BM, np.uint8)
    m8, k8 = BM.shape
    B4 = BM.reshape(m8 // 8, 8, k8 // 8, 8)  # (j, q, i, p)
    eye = np.eye(lane_bytes, dtype=np.uint8)  # (b, b')
    # out[j, b, q, i, b', p]
    out = np.einsum("jqip,bc->jbqicp", B4, eye)
    L8 = 8 * lane_bytes
    return np.ascontiguousarray(
        out.reshape(m8 // 8 * L8, k8 // 8 * L8).astype(np.uint8)
    )


def bytes_to_bitplanes(data: np.ndarray) -> np.ndarray:
    """(..., k, C) uint8 -> (..., 8k, C) 0/1 uint8, rows ordered c*8+j."""
    data = np.asarray(data, np.uint8)
    bits = (data[..., :, None, :] >> np.arange(8, dtype=np.uint8)[:, None]) & 1
    shape = data.shape[:-2] + (data.shape[-2] * 8, data.shape[-1])
    return bits.reshape(shape)


def bitplanes_to_bytes(bits: np.ndarray) -> np.ndarray:
    """(..., 8m, C) 0/1 -> (..., m, C) uint8, inverse of bytes_to_bitplanes."""
    bits = np.asarray(bits, np.uint8)
    m8, C = bits.shape[-2], bits.shape[-1]
    grouped = bits.reshape(bits.shape[:-2] + (m8 // 8, 8, C))
    weights = (1 << np.arange(8, dtype=np.uint16))[:, None]
    return (grouped.astype(np.uint16) * weights).sum(axis=-2).astype(np.uint8)
