"""shec — shingled erasure code (k, m, c profile).

Counterpart of ceph_tpu/ec/plugins/shec.py, under the same plugin and
profile name; the parity matrix, the recovery-efficiency search and the
recoverability search are the JAX module's numpy code, and encode and
decode go through the port engine (the dense GF(2) kernels).

Behavioral mirror of reference src/erasure-code/shec/ErasureCodeShec.{h,cc}:

- The parity matrix starts as the jerasure reed_sol_van coding matrix and
  has a "shingle" window zeroed per parity row, so each parity covers only
  a contiguous (wrapping) band of ~c*k/m data chunks
  (shec_reedsolomon_coding_matrix, ErasureCodeShec.cc:461-528).
- ``technique=single`` uses one shingle family (m2=m, c2=c); the default
  ``technique=multiple`` splits (m, c) into (m1, c1)+(m2, c2) chosen to
  minimise the recovery-efficiency metric r_e1
  (shec_calc_recovery_efficiency1, ErasureCodeShec.cc:420-459).
- ``minimum_to_decode`` exhaustively searches parity subsets (2^m), keeping
  the smallest nonsingular recovery submatrix — the determinant test of
  shec_make_decoding_matrix (ErasureCodeShec.cc:531-728); because shingles
  are sparse, local failures recover from fewer than k chunks.
- decode solves the selected submatrix (GF inverse, applied by the
  engine) then re-encodes any wanted missing parity (shec_matrix_decode,
  ErasureCodeShec.cc:761-810).

Profile caps mirror the reference parse: c in (0, m], k <= 12, k+m <= 20.

The codec runs on one torch device (CUDA unless ``device="cpu"``).  Host
entries take and return numpy; the ``*_device`` entries take and return
tensors on the codec's device.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ceph_tpu_torch.common.cache import FIFOCache
from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ec.base import ErasureCode
from ceph_tpu_torch.ec.engine import default_engine
from ceph_tpu_torch.ec.interface import SubChunkRanges
from ceph_tpu_torch.ec.matrix import reed_sol_van
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

DEFAULT_K = 4
DEFAULT_M = 3
DEFAULT_C = 2

_UNREACHABLE = 100_000_000  # r_eff_k sentinel (ErasureCodeShec.cc:429)
_UNRECOVERABLE = object()  # negative-result cache sentinel


def _shingle_windows(k: int, m_rows: int, c_rows: int, row0: int):
    """(row, kept_start, kept_end) per parity row of one shingle family.

    Kept (non-zero) columns run from (rr*k)//m_rows to ((rr+c_rows)*k)//m_rows
    mod k, wrapping; the complement is zeroed
    (ErasureCodeShec.cc:512-527 zeroes start..end, keeping end..start)."""
    out = []
    for rr in range(m_rows):
        keep_from = ((rr * k) // m_rows) % k
        keep_to = (((rr + c_rows) * k) // m_rows) % k
        out.append((row0 + rr, keep_from, keep_to))
    return out


def _recovery_efficiency(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """r_e1 metric (ErasureCodeShec.cc:420-459): mean over chunks of the
    cheapest covering-shingle width, plus total parity coverage."""
    r_eff_k = [_UNREACHABLE] * k
    r_e1 = 0.0
    for m_rows, c_rows in ((m1, c1), (m2, c2)):
        for rr in range(m_rows):
            width = ((rr + c_rows) * k) // m_rows - (rr * k) // m_rows
            cc = ((rr * k) // m_rows) % k
            end = (((rr + c_rows) * k) // m_rows) % k
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc], width)
                cc = (cc + 1) % k
            r_e1 += width
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_parity_matrix(k: int, m: int, c: int, single: bool) -> np.ndarray:
    """Build the (m, k) shingled parity matrix."""
    parity = reed_sol_van(k, m)[k:].copy()
    if single:
        m1, c1 = 0, 0
    else:
        # Choose the (m1, c1) split minimising r_e1
        # (ErasureCodeShec.cc:468-501: strict improvement, first wins ties).
        best = None
        min_r = 100.0
        for c1 in range(c // 2 + 1):
            for m1 in range(m + 1):
                c2, m2 = c - c1, m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0) != (c1 == 0) or (m2 == 0) != (c2 == 0):
                    continue
                r = _recovery_efficiency(k, m1, m2, c1, c2)
                if min_r - r > np.finfo(float).eps and r < min_r:
                    min_r = r
                    best = (m1, c1)
        if best is None:
            raise ValueError(f"no valid shingle split for k={k} m={m} c={c}")
        m1, c1 = best
    m2, c2 = m - m1, c - c1
    for row, keep_from, keep_to in _shingle_windows(k, m1, c1, 0) + \
            _shingle_windows(k, m2, c2, m1):
        cc = keep_to  # zero the complement: keep_to .. keep_from (wrapping)
        while cc != keep_from:
            parity[row, cc] = 0
            cc = (cc + 1) % k
    return parity


class ErasureCodeShec(ErasureCode):
    def __init__(self, profile: Mapping[str, str] | None = None,
                 device=None):
        super().__init__()
        self.k = DEFAULT_K
        self.m = DEFAULT_M
        self.c = DEFAULT_C
        self.single = False
        self.parity: np.ndarray | None = None
        self.generator: np.ndarray | None = None
        self._engine = default_engine(device)
        self.device = self._engine.device
        # (want, avail) -> (rows, cols, minimum) — the role of
        # ErasureCodeShecTableCache (decoding tables per request shape).
        self._select_cache: FIFOCache = FIFOCache(512)
        if profile is not None:
            self.init(profile)

    # -- profile ---------------------------------------------------------
    def parse(self, profile: Mapping[str, str]) -> None:
        self.k = self.to_int(profile, "k", DEFAULT_K)
        self.m = self.to_int(profile, "m", DEFAULT_M)
        self.c = self.to_int(profile, "c", DEFAULT_C)
        technique = str(profile.get("technique", "multiple"))
        w = self.to_int(profile, "w", 8)
        if w != 8:
            raise ValueError(f"shec supports w=8 only, got w={w}")
        if technique not in ("single", "multiple"):
            raise ValueError(f"shec technique must be single|multiple, "
                             f"got {technique!r}")
        self.single = technique == "single"
        if self.k < 1 or self.m < 1:
            raise ValueError(f"k={self.k} m={self.m} must be >= 1")
        if self.c < 1 or self.c > self.m:
            raise ValueError(f"c={self.c} must satisfy 0 < c <= m={self.m}")
        if self.k > 12:
            raise ValueError(f"shec requires k <= 12, got k={self.k}")
        if self.k + self.m > 20:
            raise ValueError(f"shec requires k+m <= 20, got {self.k + self.m}")
        self.parity = shec_parity_matrix(self.k, self.m, self.c, self.single)
        self.generator = np.concatenate(
            [np.eye(self.k, dtype=np.uint8), self.parity], axis=0
        )
        self._select_cache.clear()

    # -- geometry --------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    # -- recoverability search ------------------------------------------
    def _select_recovery(
        self, want: frozenset[int], avail: frozenset[int]
    ) -> tuple[list[int], list[int], set[int]]:
        """Pick the minimal recovery submatrix.

        Returns (rows, cols, minimum): ``rows`` = chunk ids read as equation
        rows (available data + chosen parities), ``cols`` = data chunk ids
        solved for, ``minimum`` = full chunk set to read. Raises IOError when
        no nonsingular submatrix exists — mirror of
        shec_make_decoding_matrix's exhaustive 2^m search
        (ErasureCodeShec.cc:560-698)."""
        key = (want, avail)
        hit = self._select_cache.get(key)
        if hit is not None:
            if hit is _UNRECOVERABLE:
                raise IOError(
                    f"shec cannot recover want={sorted(want)} from "
                    f"avail={sorted(avail)} (no nonsingular submatrix)"
                )
            return hit
        k, m, M = self.k, self.m, self.parity
        want_data = [False] * k
        for i in range(k):
            if i in want and i not in avail:
                want_data[i] = True
        # A wanted missing parity forces ALL its covered data chunks into
        # the want set — available ones must be read for the re-encode,
        # missing ones solved for (ErasureCodeShec.cc:538-546).
        for p in range(m):
            if (k + p) in want and (k + p) not in avail:
                for j in range(k):
                    if M[p, j]:
                        want_data[j] = True
        best: tuple[list[int], list[int]] | None = None
        mindup, minp = k + 1, k + 1
        for pp in range(1 << m):
            parities = [i for i in range(m) if pp & (1 << i)]
            if len(parities) > minp:
                continue
            if any((k + p) not in avail for p in parities):
                continue
            rows = [False] * (k + m)
            cols = [False] * k
            for j in range(k):
                if want_data[j] and j not in avail:
                    cols[j] = True
            for p in parities:
                rows[k + p] = True
                for j in range(k):
                    if M[p, j]:
                        cols[j] = True
                        if j in avail:
                            rows[j] = True
            dup_rows = sum(rows)
            dup_cols = sum(cols)
            if dup_rows != dup_cols:
                continue
            if dup_rows == 0:
                best, mindup, minp = ([], []), 0, len(parities)
                break
            if dup_rows >= mindup:
                continue
            row_ids = [i for i in range(k + m) if rows[i]]
            col_ids = [j for j in range(k) if cols[j]]
            sub = self._submatrix(row_ids, col_ids)
            if gf.gf_det(sub) != 0:
                best = (row_ids, col_ids)
                mindup, minp = dup_rows, len(parities)
        if best is None:
            # Negative results are cached too — repair loops retry
            # unrecoverable patterns and must not re-pay the 2^m scan.
            self._select_cache.put(key, _UNRECOVERABLE)
            raise IOError(
                f"shec cannot recover want={sorted(want)} from "
                f"avail={sorted(avail)} (no nonsingular submatrix)"
            )
        row_ids, col_ids = best
        minimum = set(row_ids)
        for i in range(k):
            if want_data[i] and i in avail:
                minimum.add(i)
        for p in range(m):
            cid = k + p
            if cid in want and cid in avail and cid not in minimum:
                # An available wanted parity is read directly when its
                # shingle touches data outside the want set
                # (ErasureCodeShec.cc:712-721).
                if any(M[p, j] and j not in want for j in range(k)):
                    minimum.add(cid)
        result = (row_ids, col_ids, minimum)
        self._select_cache.put(key, result)
        return result

    def _submatrix(self, row_ids: list[int], col_ids: list[int]) -> np.ndarray:
        k = self.k
        sub = np.zeros((len(row_ids), len(col_ids)), dtype=np.uint8)
        for r, i in enumerate(row_ids):
            for cidx, j in enumerate(col_ids):
                sub[r, cidx] = 1 if i == j else (
                    self.parity[i - k, j] if i >= k else 0
                )
        return sub

    def minimum_to_decode(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> dict[int, SubChunkRanges]:
        want = frozenset(int(w) for w in want_to_read)
        avail = frozenset(int(a) for a in available)
        bad = [c for c in want | avail if c < 0 or c >= self.k + self.m]
        if bad:
            raise ValueError(f"chunk ids out of range: {bad}")
        if want <= avail:
            return self._default_ranges(sorted(want))
        _, _, minimum = self._select_recovery(want, avail)
        return self._default_ranges(sorted(minimum))

    # -- encode ----------------------------------------------------------
    def encode_chunks(self, data_chunks) -> np.ndarray:
        return self.encode_chunks_batch(data_chunks)

    def encode_chunks_device(self, data) -> torch.Tensor:
        """Tensor in/out hot path ((B, k, C) -> (B, k+m, C), or (k, C) ->
        (k+m, C))."""
        return self._engine.encode(self.generator, data)

    def encode_chunks_batch(self, data) -> np.ndarray:
        """(B, k, C) -> (B, k+m, C) numpy; the stripe-batched hot path."""
        return self.encode_chunks_device(np.asarray(data)).cpu().numpy()

    # -- decode ----------------------------------------------------------
    def decode_chunks(
        self, available: Mapping[int, np.ndarray], want_to_read: Sequence[int]
    ) -> dict[int, np.ndarray]:
        batched = {
            int(i): np.asarray(c, np.uint8)[None]
            for i, c in available.items()
        }
        out = self.decode_chunks_batch(batched, want_to_read)
        return {w: chunk[0] for w, chunk in out.items()}

    def decode_chunks_batch(
        self, available: Mapping[int, np.ndarray], want_to_read: Sequence[int]
    ) -> dict[int, np.ndarray]:
        """Batched reconstruct: available chunks are (B, C) arrays — the
        shape CLAY's per-round plane batches and ECBackend use."""
        avail = {int(i): np.asarray(c, np.uint8) for i, c in available.items()}
        want = [int(w) for w in want_to_read]
        out: dict[int, np.ndarray] = {w: avail[w] for w in want if w in avail}
        missing = [w for w in want if w not in avail]
        if missing:
            rebuilt = self.decode_chunks_device(
                {i: self._engine.tensor(c) for i, c in avail.items()},
                missing).cpu().numpy()
            for slot, w in enumerate(missing):
                out[w] = rebuilt[:, slot]
        return out

    def decode_chunks_device(self, available, want_to_read) -> torch.Tensor:
        """Batched device reconstruct: available maps chunk id -> (B, C)
        tensors on the codec's device; returns a (B, len(want), C) tensor.
        The recovery choice and arithmetic are decode_chunks_batch's
        (ErasureCodeShec.cc:761-810)."""
        k = self.k
        avail = {int(i): self._engine.tensor(c) for i, c in available.items()}
        want = [int(w) for w in want_to_read]
        missing = [w for w in want if w not in avail]
        data: dict[int, torch.Tensor] = {
            i: avail[i] for i in range(k) if i in avail
        }
        rebuilt: dict[int, torch.Tensor] = {}
        if missing:
            rows, cols, _ = self._select_recovery(
                frozenset(want), frozenset(avail)
            )
            if cols:
                absent = [r for r in rows if r not in avail]
                if absent:
                    raise IOError(f"shec decode: chunks {absent} not supplied")
                solve = gf.gf_inv_matrix(self._submatrix(rows, cols))
                stacked = torch.stack([avail[r] for r in rows], dim=1)
                solved = self._engine.apply(solve, stacked)
                for i, j in enumerate(cols):
                    data[j] = solved[:, i]
            parity_missing = [w for w in missing if w >= k]
            for w in parity_missing:
                gap = [j for j in range(k)
                       if self.parity[w - k, j] and j not in data]
                if gap:
                    raise IOError(
                        f"shec decode: parity {w} needs data chunks {gap}"
                    )
            if parity_missing:
                ref = next(iter(avail.values()))
                full = torch.zeros((ref.shape[0], k, ref.shape[1]),
                                   dtype=torch.uint8, device=self.device)
                for j, chunk in data.items():
                    full[:, j] = chunk
                par = self._engine.apply(
                    self.parity[[w - k for w in parity_missing]], full)
                for i, w in enumerate(parity_missing):
                    rebuilt[w] = par[:, i]
        known = {**data, **rebuilt, **avail}
        return torch.stack([known[w] for w in want], dim=1)


def __erasure_code_init__(registry: ErasureCodePluginRegistry) -> None:
    registry.add("shec", ErasureCodeShec)
