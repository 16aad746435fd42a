"""Exact GF(2^8) arithmetic (numpy, host-side).

Port copy of ceph_tpu/ec/gf.py: same numpy code, kept here so the port
imports nothing of the JAX package.

This replaces the *function* of the reference's vendored native GF libraries
(gf-complete / isa-l, both empty submodules in the checkout — see SURVEY.md
§2.9): log/antilog tables, constant-by-region multiply, matrix inversion.

Polynomial: 0x11D (x^8+x^4+x^3+x^2+1) — the polynomial used by both isa-l
and gf-complete's default w=8 GF, so matrix constructions here match the
semantics of `gf_gen_rs_matrix` / `gf_gen_cauchy1_matrix`
(reference src/erasure-code/isa/ErasureCodeIsa.cc:385-387).

Everything here is exact integer math; it is both the host-side matrix
factory for the device engine and the CPU reference oracle's scalar core.
"""

from __future__ import annotations

import numpy as np

GF_POLY = 0x11D
GF_ORDER = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()

# Full 256x256 product table — used by the numpy reference encoder so that
# region multiply is a single fancy-index, and by bitmatrix construction.
_a = np.arange(256, dtype=np.int32)
_nz = (_a[:, None] != 0) & (_a[None, :] != 0)
GF_MUL_TABLE = np.where(
    _nz, GF_EXP[(GF_LOG[_a][:, None] + GF_LOG[_a][None, :]) % 255], 0
).astype(np.uint8)
del _a, _nz

GF_INV_TABLE = np.zeros(256, dtype=np.uint8)
GF_INV_TABLE[1:] = GF_EXP[255 - GF_LOG[np.arange(1, 256)]]


def gf_mul(a, b):
    """Elementwise GF(2^8) multiply of scalars or arrays."""
    return GF_MUL_TABLE[np.asarray(a, np.uint8), np.asarray(b, np.uint8)]


def gf_inv(a):
    a = np.asarray(a, np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return GF_INV_TABLE[a]


def gf_div(a, b):
    return gf_mul(a, gf_inv(b))


def gf_pow(a: int, n: int) -> int:
    """a**n in GF(2^8); 0**0 == 1."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


def gf_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product: (m,k) @ (k,n) -> (m,n), XOR-accumulated."""
    A = np.asarray(A, np.uint8)
    B = np.asarray(B, np.uint8)
    # products[m, k, n] then XOR-reduce over k
    prods = GF_MUL_TABLE[A[:, :, None], B[None, :, :]]
    return np.bitwise_xor.reduce(prods, axis=1)


def gf_matvec_region(A: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Region multiply: coeff matrix (m,k) applied to chunk data (k,C) bytes.

    The numpy analog of isa-l ``ec_encode_data`` / jerasure
    ``jerasure_matrix_encode`` (reference ErasureCodeJerasure.cc:162): output
    row i = XOR_j ( A[i,j] * data[j,:] ).
    """
    return gf_matmul(A, data)


def gf_det(A: np.ndarray) -> int:
    """Determinant of a square GF(2^8) matrix by Gaussian elimination.

    The singularity test SHEC's recoverability search runs per candidate
    submatrix (analog of determinant.c / calc_determinant in the reference
    shec plugin, ErasureCodeShec.cc:666)."""
    A = np.array(A, dtype=np.uint8)
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError("matrix must be square")
    det = 1
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if A[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            return 0
        if pivot != col:
            A[[col, pivot]] = A[[pivot, col]]
        det = int(GF_MUL_TABLE[det, A[col, col]])
        inv_p = GF_INV_TABLE[A[col, col]]
        A[col] = GF_MUL_TABLE[inv_p, A[col]]
        for row in range(col + 1, n):
            if A[row, col] != 0:
                A[row] ^= GF_MUL_TABLE[A[row, col], A[col]]
    return det


def gf_inv_matrix(A: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination.

    Raises ValueError if singular. Exact; used to build decode matrices
    (the analog of jerasure_matrix_decode's inversion, ErasureCodeJerasure.cc:170).
    """
    A = np.array(A, dtype=np.uint8)
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError("matrix must be square")
    aug = np.concatenate([A, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise ValueError("singular GF(2^8) matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = GF_INV_TABLE[aug[col, col]]
        aug[col] = GF_MUL_TABLE[inv_p, aug[col]]
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] ^= GF_MUL_TABLE[aug[row, col], aug[col]]
    return aug[:, n:].copy()
