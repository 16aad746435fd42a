"""Bit-schedule codes: Blaum-Roth, Liberation-class, Liber8tion-class,

Port copy of ceph_tpu/ec/bitsched.py: same numpy code, kept here so the port
imports nothing of the JAX package.
and GF(2^w) bitmatrix expansion for w in {16, 32}.

The technique family of reference
src/erasure-code/jerasure/ErasureCodeJerasure.h:192-240
(ErasureCodeJerasureLiberation / BlaumRoth / Liber8tion) — pure GF(2)
bitmatrix RAID-6 codes executed as packet XOR schedules. Layout: each
chunk is divided into ``w`` equal PACKETS; output packet r of coding
chunk i is the XOR of the input packets selected by bitmatrix row
(i*w + r) — jerasure's packetized bitmatrix coding
(jerasure_schedule_encode semantics), which the device engine executes as
one GF(2) matmul over bit planes.

Constructions:

- ``blaum_roth_bitmatrix`` — EXACT Blaum-Roth: arithmetic in the ring
  R_p = GF(2)[x] / M_p(x) with p = w+1 prime, M_p = 1 + x + ... + x^w;
  coding block for data device i is the multiply-by-x^i matrix in R_p
  (the published construction is fully determined by this algebra).
- ``liberation_bitmatrix`` / ``liber8tion_bitmatrix`` — minimum-density
  RAID-6 codes with the Liberation parameters (w prime >= k, resp.
  w = 8, k <= 8). The published matrices live in the EMPTY jerasure
  submodule, so they are RE-DERIVED here: liberation by deterministic
  search over the papers' design space — Q_i = (rotated identity) + one
  extra bit — under the exact MDS conditions (every Q_i invertible,
  every Q_i ^ Q_j sum invertible); liber8tion (w=8, where rotation
  bases are provably infeasible) as density-minimised companion-matrix
  powers, MDS by construction. Same parameters, same low density, same
  recoverability; bit-layout pinned by the non-regression corpus rather
  than by upstream tables (which are not available to compare against —
  SURVEY.md §2.9).
- ``matrix_to_bitmatrix`` — jerasure_matrix_to_bitmatrix semantics for
  GF(2^w), w in {8, 16, 32}: coefficient c expands to the w x w matrix
  whose column t is the bit-decomposition of c * x^t in GF(2^w).

GF(2^16)/GF(2^32) use jerasure's primitive polynomials (0x1100B,
0x400007) so reed_sol_van generator coefficients match the reference
construction at those widths.
"""

from __future__ import annotations

import functools

import numpy as np

from ceph_tpu_torch.ec.gf import gf_mul

# primitive polynomials (sans the leading x^w term), jerasure defaults
_POLY = {8: 0x11D, 16: 0x1100B, 32: 0x400007}


def gfw_mul(a: int, b: int, w: int) -> int:
    """Russian-peasant multiply in GF(2^w) (matrix construction only —
    the data path never multiplies symbols)."""
    if w == 8:
        return int(gf_mul(a, b))
    poly = _POLY[w]
    mask = (1 << w) - 1
    top = 1 << (w - 1)
    r = 0
    while b:
        if b & 1:
            r ^= a
        carry = a & top
        a = (a << 1) & mask
        if carry:
            a ^= poly & mask
        b >>= 1
    return r


def gfw_pow(a: int, n: int, w: int) -> int:
    r = 1
    while n:
        if n & 1:
            r = gfw_mul(r, a, w)
        a = gfw_mul(a, a, w)
        n >>= 1
    return r


def gfw_inv(a: int, w: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF inverse of 0")
    return gfw_pow(a, (1 << w) - 2, w)


def reed_sol_van_w(k: int, m: int, w: int) -> np.ndarray:
    """jerasure reed_sol_van at width w: systematic Vandermonde via
    column elimination over GF(2^w) (coefficients as int64)."""
    n = k + m
    if n > (1 << w):
        raise ValueError(f"k+m must be <= 2^{w}")
    V = np.zeros((n, k), dtype=np.int64)
    for i in range(n):
        for j in range(k):
            V[i, j] = gfw_pow(i, j, w)
    for i in range(k):
        if V[i, i] == 0:
            for j in range(i + 1, k):
                if V[i, j] != 0:
                    V[:, [i, j]] = V[:, [j, i]]
                    break
            else:
                raise ValueError("vandermonde elimination failed")
        piv = int(V[i, i])
        if piv != 1:
            inv = gfw_inv(piv, w)
            for r in range(n):
                V[r, i] = gfw_mul(int(V[r, i]), inv, w)
        for j in range(k):
            if j != i and V[i, j] != 0:
                c = int(V[i, j])
                for r in range(n):
                    V[r, j] ^= gfw_mul(c, int(V[r, i]), w)
    return V


def matrix_to_bitmatrix(mat: np.ndarray, w: int) -> np.ndarray:
    """(rows, k) GF(2^w) coefficients -> (rows*w, k*w) GF(2) bitmatrix
    (jerasure_matrix_to_bitmatrix): block column t for coefficient c is
    the bit pattern of c * x^t."""
    rows, k = mat.shape
    out = np.zeros((rows * w, k * w), dtype=np.uint8)
    for i in range(rows):
        for j in range(k):
            c = int(mat[i, j])
            v = c
            for t in range(w):
                for s in range(w):
                    out[i * w + s, j * w + t] = (v >> s) & 1
                v = gfw_mul(v, 2, w)
    return out


# -- GF(2) linear algebra ---------------------------------------------------

def gf2_inv(M: np.ndarray) -> np.ndarray:
    """Invert a square GF(2) matrix (Gauss-Jordan); raises on singular."""
    n = M.shape[0]
    A = np.concatenate([M.astype(np.uint8) & 1,
                        np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if A[r, col]:
                piv = r
                break
        if piv is None:
            raise np.linalg.LinAlgError("singular GF(2) matrix")
        if piv != col:
            A[[col, piv]] = A[[piv, col]]
        hits = np.nonzero(A[:, col])[0]
        for r in hits:
            if r != col:
                A[r] ^= A[col]
    return A[:, n:]


def gf2_nonsingular(M: np.ndarray) -> bool:
    try:
        gf2_inv(M)
        return True
    except np.linalg.LinAlgError:
        return False


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for d in range(2, int(n ** 0.5) + 1):
        if n % d == 0:
            return False
    return True


# -- Blaum-Roth (exact) -----------------------------------------------------

def _mult_by_x_matrix(w: int) -> np.ndarray:
    """Multiplication-by-x in R_p = GF(2)[x]/M_p(x), p = w+1:
    x^w == 1 + x + ... + x^(w-1) (since M_p(x) = 0 in the ring)."""
    X = np.zeros((w, w), dtype=np.uint8)
    for s in range(w - 1):
        X[s + 1, s] = 1                 # x * x^s = x^(s+1)
    X[:, w - 1] = 1                      # x * x^(w-1) = sum_{t<w} x^t
    return X


def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """Blaum-Roth RAID-6 bitmatrix (m=2): P block = identities, Q block
    for device i = multiply-by-x^i in R_{w+1} (w+1 must be prime)."""
    if not _is_prime(w + 1):
        raise ValueError(f"blaum_roth requires w+1 prime (w={w})")
    if k > w:
        raise ValueError(f"blaum_roth requires k <= w (k={k}, w={w})")
    X = _mult_by_x_matrix(w)
    out = np.zeros((2 * w, k * w), dtype=np.uint8)
    Q = np.eye(w, dtype=np.uint8)
    for i in range(k):
        out[:w, i * w:(i + 1) * w] = np.eye(w, dtype=np.uint8)
        out[w:, i * w:(i + 1) * w] = Q
        Q = (X @ Q) & 1
    return out


# -- Liberation-class minimum-density search --------------------------------

def _int_rows_nonsingular(rows) -> bool:
    """Rank check over GF(2) with rows as int bitmasks (fast inner loop
    of the search)."""
    piv: dict[int, int] = {}
    for r in rows:
        while r:
            h = r.bit_length() - 1
            p = piv.get(h)
            if p is None:
                piv[h] = r
                break
            r ^= p
        else:
            return False
    return True


@functools.lru_cache(maxsize=64)
def _min_density_q_blocks(k: int, w: int) -> tuple:
    """Deterministic backtracking search for Q_0..Q_{k-1} with Q_0 = I
    and Q_i = rot(i) + a minimal number of extra bits (1 for prime w,
    the Liberation density; escalating when 1 is infeasible — the
    non-prime-w Liber8tion case), satisfying the RAID-6 MDS conditions:
    every Q_i invertible and every pairwise sum Q_i ^ Q_j invertible.
    Candidates are tried in (extra-bit count, lexicographic) order per
    device, so the first solution minimises density greedily and is
    deterministic (the corpus pins it). Rows are int bitmasks for
    speed."""
    ident = tuple(1 << s for s in range(w))
    blocks: list[tuple] = [ident]

    def ok(cand: tuple) -> bool:
        if not _int_rows_nonsingular(cand):
            return False
        return all(
            _int_rows_nonsingular(tuple(a ^ b for a, b in zip(cand, blk)))
            for blk in blocks
        )

    def candidates(i: int):
        base = tuple(1 << ((s + i) % w) for s in range(w))
        free = [(r, c) for r in range(w) for c in range(w)
                if not (base[r] >> c) & 1]
        for r, c in free:
            cand = list(base)
            cand[r] |= 1 << c
            yield tuple(cand)

    def extend(i: int) -> bool:
        if i == k:
            return True
        for cand in candidates(i):
            if ok(cand):
                blocks.append(cand)
                if extend(i + 1):
                    return True
                blocks.pop()
        return False

    if not extend(1):
        raise ValueError(f"no minimum-density code found for k={k} w={w}")
    out = []
    for blk in blocks:
        M = np.zeros((w, w), dtype=np.uint8)
        for r, bits in enumerate(blk):
            for c in range(w):
                M[r, c] = (bits >> c) & 1
        out.append(M)
    return tuple(out)


def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """Liberation-class minimum-density RAID-6 bitmatrix: w prime >= k,
    column blocks carry w+1 ones (w for the rotated identity + 1)."""
    if not _is_prime(w):
        raise ValueError(f"liberation requires w prime (w={w})")
    if k > w:
        raise ValueError(f"liberation requires k <= w (k={k}, w={w})")
    qs = _min_density_q_blocks(k, w)
    out = np.zeros((2 * w, k * w), dtype=np.uint8)
    for i in range(k):
        out[:w, i * w:(i + 1) * w] = np.eye(w, dtype=np.uint8)
        out[w:, i * w:(i + 1) * w] = qs[i]
    return out


def _companion_matrix(w: int) -> np.ndarray:
    """Companion matrix of the GF(2^w) primitive polynomial: the
    multiply-by-x bitmatrix."""
    poly = _POLY[w]
    C = np.zeros((w, w), dtype=np.uint8)
    for s in range(w - 1):
        C[s + 1, s] = 1
    for s in range(w):
        C[s, w - 1] = (poly >> s) & 1
    return C


@functools.lru_cache(maxsize=16)
def _liber8tion_q_blocks(k: int) -> tuple:
    """RAID-6 Q blocks at w=8: rotation bases are infeasible here (even
    rotation differences have nullity >= 2 over GF(2), which is why the
    published Liber8tion code is not rotation-structured), so the
    blocks are COMPANION-MATRIX powers C^a (multiplication by x^a in
    GF(2^8)): C^a + C^b = C^a (I + C^(b-a)) is multiplication by a
    nonzero field element, hence every pairwise sum is invertible — MDS
    by construction. The k exponents are chosen deterministically to
    minimise total bitmatrix density (greedy by ones count, ties to the
    smaller exponent), the Liber8tion design goal."""
    w = 8
    C = _companion_matrix(w)
    powers = []
    P = np.eye(w, dtype=np.uint8)
    for a in range(255):
        powers.append((int(P.sum()), a, P.copy()))
        P = (C @ P) & 1
    chosen = [powers[0]]                 # identity first (pure XOR)
    rest = sorted(powers[1:])
    chosen.extend(rest[: k - 1])
    chosen.sort(key=lambda t: t[1])      # stable device order by exponent
    return tuple(p for _, _, p in chosen)


def liber8tion_bitmatrix(k: int) -> np.ndarray:
    """Liber8tion-class low-density RAID-6 at w=8 (k <= 8)."""
    if k > 8:
        raise ValueError(f"liber8tion requires k <= 8 (k={k})")
    qs = _liber8tion_q_blocks(k)
    w = 8
    out = np.zeros((2 * w, k * w), dtype=np.uint8)
    for i in range(k):
        out[:w, i * w:(i + 1) * w] = np.eye(w, dtype=np.uint8)
        out[w:, i * w:(i + 1) * w] = qs[i]
    return out


def full_bitmatrix(parity_bm: np.ndarray, k: int, w: int) -> np.ndarray:
    """Prepend the identity rows: (m*w, k*w) parity -> ((k+m)*w, k*w)."""
    mw = parity_bm.shape[0]
    out = np.zeros((k * w + mw, k * w), dtype=np.uint8)
    out[:k * w] = np.eye(k * w, dtype=np.uint8)
    out[k * w:] = parity_bm
    return out


def decode_bitmatrix(full_bm: np.ndarray, k: int, w: int,
                     survivors: list[int],
                     wanted: list[int]) -> np.ndarray:
    """GF(2) decode matrix: invert the survivors' row blocks, compose
    with the wanted chunks' rows (the bitmatrix analog of
    jerasure_matrix_decode)."""
    rows = np.concatenate([
        full_bm[s * w:(s + 1) * w] for s in survivors
    ])
    inv = gf2_inv(rows)
    want_rows = np.concatenate([
        full_bm[t * w:(t + 1) * w] for t in wanted
    ])
    return (want_rows.astype(np.int64) @ inv.astype(np.int64) % 2) \
        .astype(np.uint8)


def verify_mds(full_bm: np.ndarray, k: int, m: int, w: int) -> bool:
    """Every k-subset of chunks decodes every other chunk (the
    exhaustive-erasure check of the reference test suite)."""
    import itertools

    n = k + m
    for survivors in itertools.combinations(range(n), k):
        rows = np.concatenate([
            full_bm[s * w:(s + 1) * w] for s in survivors
        ])
        if not gf2_nonsingular(rows):
            return False
    return True
