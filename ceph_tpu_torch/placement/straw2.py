"""Straw2 weighted draws via fixed-point log (vectorized).

Counterpart of ceph_tpu/placement/straw2.py: the same module over the
port's imports.

Mirrors reference src/crush/mapper.c: crush_ln (:248, "compute
2^44*log2(input+1)") and the straw2 draw (generate_exponential_distribution:
u = hash(x, id, r) & 0xffff; ln = crush_ln(u) - 2^48; draw = ln / weight_16.16
with C truncating division).

Table derivation (crush_ln_table.h:23-25,95). The RH/LH tables are
BIT-IDENTICAL to the reference's shipped __RH_LH_tbl: exact-precision
analysis of the shipped values shows the upstream generator used
RH[k] = ceil(2^48/(1+k/128)) and LH[k] = floor(2^48*log2(1+k/128)),
which we recompute here with exact rational/60-digit-decimal arithmetic
(float64 rounds ~50 of the 129 entries differently); the single shipped
outlier LH[128] = 2^48 - 2^32 (a generator truncation artifact, hit only
for xin = 0xffff) is reproduced as a pinned quirk constant. The ceil-RH
rule also guarantees (x*RH)>>48 >= 2^15, making the C code's
``index2 = xl64 & 0xff`` exact — no clamp needed.

The __LL_tbl is the one REMAINING deviation: the shipped values scatter
up to ~0.45 table-steps away from the header's own documented formula
LL[j] = 2^48*log2(1+j/2^15) with no reproducible rule (non-deterministic
generator noise), so we follow the documented formula (nearest
rounding). Consequence: crush_ln differs from upstream by at most one
LL quantum; test_straw2_compat quantifies the resulting placement
distribution equivalence (both are correct weighted draws; only
near-tie selections within that quantum can differ).

All math vectorizes over numpy int64; the whole-bucket, whole-batch draw
matrix is one expression, replacing the per-item C loop.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.placement.hashing import crush_hash32_3

S64_MIN = np.int64(-(2**63))


def _build_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact-arithmetic table generation (import-time, ~1 ms)."""
    from decimal import Decimal, getcontext

    ctx = getcontext().copy()
    ctx.prec = 60
    ln2 = ctx.ln(Decimal(2))
    two48 = Decimal(2) ** 48

    def log2d(x: Decimal) -> Decimal:
        return ctx.divide(ctx.ln(x), ln2)

    rh = np.zeros(129, np.uint64)
    lh = np.zeros(129, np.uint64)
    for k in range(129):
        # RH: ceil of an exact rational — pure integer arithmetic
        num, den = (1 << 48) * 128, 128 + k
        rh[k] = -(-num // den)
        val = two48 * log2d(1 + Decimal(k) / 128) if k else Decimal(0)
        lh[k] = int(val.to_integral_value(rounding="ROUND_FLOOR"))
    lh[128] = (1 << 48) - (1 << 32)     # shipped LH[128] quirk (see above)
    ll = np.zeros(256, np.uint64)
    for j in range(1, 256):
        val = two48 * log2d(1 + Decimal(j) / Decimal(2) ** 15)
        ll[j] = int((val + Decimal("0.5"))
                    .to_integral_value(rounding="ROUND_FLOOR"))
    return rh, lh, ll


_RH, _LH, _LL = _build_tables()


def crush_ln(xin) -> np.ndarray:
    """Vectorized fixed-point 2^44*log2(x+1) over inputs in [0, 0xffff]."""
    x = np.asarray(xin, np.uint32).astype(np.uint64) + 1
    # Normalise to [0x8000, 0x10000]: shift left until bit 15 (or 16) set.
    need = (x & 0x18000) == 0
    xm = np.maximum(x & 0x1FFFF, 1)
    top = np.floor(np.log2(xm.astype(np.float64))).astype(np.int64)
    nbits = np.where(need, 15 - top, 0)
    x = x << nbits.astype(np.uint64)
    iexpon = 15 - nbits

    k = (x >> 8).astype(np.int64) - 128  # [0, 128]
    RH = _RH[k]
    LH = _LH[k]
    xl64 = (x * RH) >> 48
    # ceil-RH guarantees xl64 >= 2^15, so the C code's masked index is
    # exact (mapper.c crush_ln: index2 = xl64 & 0xff)
    index2 = (xl64 & 0xFF).astype(np.int64)
    frac = (LH + _LL[index2]) >> (48 - 12 - 32)
    return (iexpon << 44) + frac.astype(np.int64)


def _div_trunc(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """C-style truncating int64 division (toward zero)."""
    num = np.asarray(num, np.int64)
    den = np.asarray(den, np.int64)
    q = np.abs(num) // np.abs(den)
    return np.where((num < 0) ^ (den < 0), -q, q).astype(np.int64)


def straw2_draws(x, item_ids, weights_fp, r) -> np.ndarray:
    """Draw values for every (x, item) pair.

    x: scalar or (X,) int array of placement inputs; item_ids: (N,) int;
    weights_fp: (N,) 16.16 fixed-point weights; r: replica rank scalar or
    (X,) array. Returns (X, N) (or (N,) for scalar x) int64 draws;
    zero-weight items draw S64_MIN (mapper.c:376-379).
    """
    x = np.asarray(x)
    scalar = x.ndim == 0
    x2 = np.atleast_1d(x).astype(np.int64)
    r2 = np.broadcast_to(np.asarray(r, np.int64), x2.shape)
    ids = np.asarray(item_ids, np.int64)
    w = np.asarray(weights_fp, np.int64)
    u = crush_hash32_3(
        x2[:, None].astype(np.uint32),
        ids[None, :].astype(np.uint32),
        r2[:, None].astype(np.uint32),
    ) & np.uint32(0xFFFF)
    ln = crush_ln(u) - np.int64(0x1000000000000)
    draws = np.where(
        w[None, :] > 0, _div_trunc(ln, np.maximum(w[None, :], 1)), S64_MIN
    )
    return draws[0] if scalar else draws


def straw2_choose(x, item_ids, weights_fp, r) -> np.ndarray:
    """argmax draw -> chosen item id(s). Ties resolve to the first item,
    matching the reference's strict '>' comparison (mapper.c:373-383)."""
    draws = straw2_draws(x, item_ids, weights_fp, r)
    ids = np.asarray(item_ids)
    return ids[np.argmax(draws, axis=-1)]
