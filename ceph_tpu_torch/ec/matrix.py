"""Coefficient-matrix generators for the RS/Cauchy code family.

Port copy of ceph_tpu/ec/matrix.py: same numpy code, kept here so the port
imports nothing of the JAX package.

Replicates the *semantics* of the reference's generator constructions
(the native code itself lives in empty submodules — SURVEY.md §2.9):

- ``vandermonde_rs``      — isa-l ``gf_gen_rs_matrix`` semantics
  (reference src/erasure-code/isa/ErasureCodeIsa.cc:385): identity on top,
  parity row t has entries (2^t)^j. NOT MDS for all (k,m); the reference
  caps Vandermonde at m<=4, k<=21@m=4 (ErasureCodeIsa.cc:330-360) and we
  enforce the same caps in the isa-flavoured plugin.
- ``cauchy_rs``           — isa-l ``gf_gen_cauchy1_matrix`` semantics
  (ErasureCodeIsa.cc:387): parity[i][j] = 1/(i ^ j) with i >= k. Always MDS.
- ``reed_sol_van``        — jerasure reed_sol_van semantics
  (reference src/erasure-code/jerasure/ErasureCodeJerasure.h:81): systematic
  Vandermonde distribution matrix derived by column elimination.
- ``reed_sol_r6``         — RAID-6 optimised (ErasureCodeJerasure.h:111):
  P = XOR of data, Q = XOR of 2^j * d_j.
- ``cauchy_orig``         — jerasure cauchy_orig (ErasureCodeJerasure.h:174):
  parity[i][j] = 1/(i ^ (m+j)).
- ``cauchy_good``         — cauchy_orig with row/column scaling chosen to
  minimise ones in the GF(2) bitmatrix (ErasureCodeJerasure.h:183), which
  minimises XOR work in bit-sliced execution.

All matrices returned are full (k+m, k) generator matrices with an identity
top block (systematic — ErasureCodeInterface.h:365 requires systematic codes).
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ec.gf import (
    GF_INV_TABLE,
    GF_MUL_TABLE,
    gf_inv,
    gf_mul,
    gf_pow,
)


def _with_identity(parity: np.ndarray, k: int) -> np.ndarray:
    m = parity.shape[0]
    full = np.zeros((k + m, k), dtype=np.uint8)
    full[:k] = np.eye(k, dtype=np.uint8)
    full[k:] = parity
    return full


def vandermonde_rs(k: int, m: int) -> np.ndarray:
    """isa-l gf_gen_rs_matrix semantics: parity row t = [(2^t)^j for j<k]."""
    parity = np.zeros((m, k), dtype=np.uint8)
    gen = 1
    for t in range(m):
        p = 1
        for j in range(k):
            parity[t, j] = p
            p = int(gf_mul(p, gen))
        gen = int(gf_mul(gen, 2))
    return _with_identity(parity, k)


def cauchy_rs(k: int, m: int) -> np.ndarray:
    """isa-l gf_gen_cauchy1_matrix semantics: parity[i][j] = 1/((k+i) ^ j)."""
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for GF(2^8) Cauchy")
    i = np.arange(k, k + m, dtype=np.int32)[:, None]
    j = np.arange(k, dtype=np.int32)[None, :]
    parity = gf_inv((i ^ j).astype(np.uint8))
    return _with_identity(parity, k)


def reed_sol_van(k: int, m: int) -> np.ndarray:
    """Systematic Vandermonde via column elimination (jerasure semantics).

    Build V[i][j] = i**j over (k+m, k), then use elementary column operations
    (which preserve the code's MDS property) to reduce the top k rows to the
    identity; the bottom m rows are the coding matrix.
    """
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for GF(2^8) Vandermonde")
    V = np.zeros((k + m, k), dtype=np.uint8)
    for i in range(k + m):
        for j in range(k):
            V[i, j] = gf_pow(i, j)
    for i in range(k):
        if V[i, i] == 0:
            for j in range(i + 1, k):
                if V[i, j] != 0:
                    V[:, [i, j]] = V[:, [j, i]]
                    break
            else:
                raise ValueError("vandermonde elimination failed (singular)")
        piv = int(V[i, i])
        if piv != 1:
            V[:, i] = GF_MUL_TABLE[GF_INV_TABLE[piv], V[:, i]]
        for j in range(k):
            if j != i and V[i, j] != 0:
                V[:, j] ^= GF_MUL_TABLE[int(V[i, j]), V[:, i]]
    return V


def reed_sol_r6(k: int, m: int) -> np.ndarray:
    """RAID-6: P = XOR(d_j), Q = XOR(2^j * d_j). Requires m == 2."""
    if m != 2:
        raise ValueError("reed_sol_r6_op requires m=2")
    parity = np.zeros((2, k), dtype=np.uint8)
    parity[0] = 1
    for j in range(k):
        parity[1, j] = gf_pow(2, j)
    return _with_identity(parity, k)


def cauchy_orig(k: int, m: int) -> np.ndarray:
    """jerasure cauchy_original_coding_matrix: parity[i][j] = 1/(i ^ (m+j))."""
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for GF(2^8) Cauchy")
    i = np.arange(m, dtype=np.int32)[:, None]
    j = np.arange(m, m + k, dtype=np.int32)[None, :]
    parity = gf_inv((i ^ j).astype(np.uint8))
    return _with_identity(parity, k)


def _bitmatrix_ones(row: np.ndarray) -> int:
    """Number of ones in the GF(2) bitmatrix expansion of a coefficient row.

    For coefficient c, the 8x8 bitmatrix has one column per bit j holding
    c*2^j; total ones = sum of popcounts. This is the XOR cost the
    cauchy_good optimisation minimises.
    """
    shifts = (1 << np.arange(8, dtype=np.uint8))
    prods = GF_MUL_TABLE[np.asarray(row, np.uint8)[:, None], shifts[None, :]]
    return int(np.unpackbits(prods).sum())


def cauchy_good(k: int, m: int) -> np.ndarray:
    """cauchy_orig improved by deterministic row/column scaling.

    First each column is divided by its row-0 element (making row 0 all
    ones — pure XOR), then each later row is divided by whichever of its
    elements minimises the bitmatrix ones count (ties -> first). This is the
    published Cauchy-optimisation strategy jerasure's cauchy_good follows.
    """
    full = cauchy_orig(k, m)
    parity = full[k:].copy()
    # Column scaling: make row 0 all ones.
    for j in range(k):
        d = int(parity[0, j])
        if d != 1:
            parity[:, j] = GF_MUL_TABLE[GF_INV_TABLE[d], parity[:, j]]
    # Row scaling: minimise bitmatrix ones per row.
    for i in range(1, m):
        best_row, best_ones = parity[i], _bitmatrix_ones(parity[i])
        for d in parity[i]:
            d = int(d)
            if d in (0, 1):
                continue
            cand = GF_MUL_TABLE[GF_INV_TABLE[d], parity[i]]
            ones = _bitmatrix_ones(cand)
            if ones < best_ones:
                best_row, best_ones = cand, ones
        parity[i] = best_row
    return _with_identity(parity, k)


GENERATORS = {
    "reed_sol_van": reed_sol_van,
    "reed_sol_r6_op": reed_sol_r6,
    "cauchy_orig": cauchy_orig,
    "cauchy_good": cauchy_good,
    "isa_vandermonde": vandermonde_rs,
    "isa_cauchy": cauchy_rs,
}


def generator_matrix(technique: str, k: int, m: int) -> np.ndarray:
    try:
        gen = GENERATORS[technique]
    except KeyError:
        raise ValueError(
            f"unknown technique {technique!r}; have {sorted(GENERATORS)}"
        ) from None
    return gen(k, m)
