"""clay — coupled-layer MSR regenerating code (k, m, d profile).

Counterpart of ceph_tpu/ec/plugins/clay.py, under the same plugin and
profile name, with the same geometry, helper order, plane order and
arithmetic, on torch tensors:

- Chunks are one uint8 tensor (B, q*t, sub_chunk_no, sc) on the codec's
  device.  The pairwise transforms are lookups into a device copy of the
  256 x 256 GF(2^8) product table (plain PyTorch, as the JAX package does
  them in numpy outside any kernel).
- Each round's per-plane MDS decodes batch into one ``decode_chunks_device``
  of the inner codec (jax_rs, or shec for ``scalar_mds=shec``), i.e. one
  dense kernel launch.
- Single-chunk repair reads only sub_chunk_no/q sub-chunks from each of d
  helpers.  ``_repair`` runs the coupling schedule itself (on the device);
  the batched repair path (``parallel.clay_sharding``) applies the probed
  repair operator R (``ec.repair_operator``) in one grouped-kernel launch.

Behavioral mirror of reference src/erasure-code/clay/ErasureCodeClay.{h,cc}:

- Array code over a q x t node grid (q = d-k+1, t = (k+m+nu)/q, nu pads
  k+m to a multiple of q); every chunk is split into sub_chunk_no = q^t
  sub-chunks ("planes"), one per base-q digit vector
  (ErasureCodeClay.cc:271-296 parse, :886-893 get_plane_vector).
- Encode/decode run ``decode_layered`` (ErasureCodeClay.cc:648): planes are
  processed in increasing intersection score; each plane couples/uncouples
  chunk pairs via a 2x2 pairwise transform (the reference's k=2,m=2 "pft"
  inner code) and MDS-decodes the uncoupled values with the scalar inner
  code (profile ``scalar_mds`` in {jerasure, isa, shec}).
- Single-chunk repair (repair_one_lost_chunk ErasureCodeClay.cc:462-646;
  get_repair_subchunks :366-380) — the regenerating-code bandwidth saving.

Host entries (``encode_chunks``, ``encode_chunks_batch``,
``decode_chunks_batch``, ``decode``) take and return numpy or bytes and
convert at the boundary; the ``*_device`` entries take and return tensors.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ceph_tpu_torch.ec.base import ErasureCode
from ceph_tpu_torch.ec.engine import default_engine
from ceph_tpu_torch.ec.gf import GF_INV_TABLE, GF_MUL_TABLE, gf_inv_matrix
from ceph_tpu_torch.ec.interface import SubChunkRanges
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

DEFAULT_K = 4
DEFAULT_M = 2

# Sub-chunk byte alignment (role of the scalar code's get_chunk_size(1) in
# reference get_chunk_size, ErasureCodeClay.cc:90-96).
SC_ALIGN = 16

_SCALAR_MDS = ("jerasure", "isa", "shec")
_PLUGIN_ALIASES = {"jerasure": "jax_rs", "isa": "jax_rs", "shec": "shec"}
_JERASURE_TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
                        "cauchy_good", "liber8tion")
_ISA_TECHNIQUES = {"reed_sol_van": "isa_vandermonde", "cauchy": "isa_cauchy"}


class _PairwiseTransform:
    """The 2x2 coupling transform between coupled (C) and uncoupled (U)
    pair values: (U_hi, U_lo) = P @ (C_hi, C_lo), where P is the parity
    block of the reference's k=2,m=2 "pft" inner code
    (ErasureCodeClay.cc pft usage in get_uncoupled_from_coupled :817,
    get_coupled_from_uncoupled :790, recover_type1_erasure :763).
    Exact GF table lookups on uint8 tensors of any shape: a constant
    multiply is row ``coeff`` of the device product table indexed by the
    data as ``long``."""

    def __init__(self, P: np.ndarray, device: torch.device):
        P = np.asarray(P, np.uint8)
        if P.shape != (2, 2) or np.any(P == 0):
            raise ValueError(f"pairwise transform must be 2x2 nonzero, got {P}")
        self.P = P
        self.Pinv = gf_inv_matrix(P)
        self._table = torch.from_numpy(GF_MUL_TABLE).to(device)

    def _mul(self, coeff: int, data: torch.Tensor) -> torch.Tensor:
        """Constant-by-region GF(2^8) multiply (table row lookup)."""
        return self._table[int(coeff)][data.long()]

    def uncouple(self, c_hi, c_lo):
        """(C_hi, C_lo) -> (U_hi, U_lo)."""
        P = self.P
        return (self._mul(P[0, 0], c_hi) ^ self._mul(P[0, 1], c_lo),
                self._mul(P[1, 0], c_hi) ^ self._mul(P[1, 1], c_lo))

    def couple(self, u_hi, u_lo):
        """(U_hi, U_lo) -> (C_hi, C_lo) (both pair members erased)."""
        Q = self.Pinv
        return (self._mul(Q[0, 0], u_hi) ^ self._mul(Q[0, 1], u_lo),
                self._mul(Q[1, 0], u_hi) ^ self._mul(Q[1, 1], u_lo))

    def solve_c_hi_from_u_hi(self, u_hi, c_lo):
        """recover_type1, hi member erased: C_hi from own U and partner C."""
        P = self.P
        return self._mul(GF_INV_TABLE[P[0, 0]],
                         u_hi ^ self._mul(P[0, 1], c_lo))

    def solve_c_lo_from_u_lo(self, u_lo, c_hi):
        """recover_type1, lo member erased."""
        P = self.P
        return self._mul(GF_INV_TABLE[P[1, 1]],
                         u_lo ^ self._mul(P[1, 0], c_hi))

    def solve_c_lo_from_u_hi(self, u_hi, c_hi):
        """repair: partner (lo) C at the swapped plane from own C and U."""
        P = self.P
        return self._mul(GF_INV_TABLE[P[0, 1]],
                         u_hi ^ self._mul(P[0, 0], c_hi))

    def solve_c_hi_from_u_lo(self, u_lo, c_lo):
        """repair: partner (hi) C at the swapped plane from own C and U."""
        P = self.P
        return self._mul(GF_INV_TABLE[P[1, 0]],
                         u_lo ^ self._mul(P[1, 1], c_lo))

    def u_hi_after_solving_c_lo(self, c_hi, u_lo):
        """aloof partner, self hi: C_lo from U_lo, then U_hi."""
        c_lo = self.solve_c_lo_from_u_lo(u_lo, c_hi)
        return self.uncouple(c_hi, c_lo)[0]

    def u_lo_after_solving_c_hi(self, c_lo, u_hi):
        """aloof partner, self lo: C_hi from U_hi, then U_lo."""
        c_hi = self.solve_c_hi_from_u_hi(u_hi, c_lo)
        return self.uncouple(c_hi, c_lo)[1]


class ErasureCodeClay(ErasureCode):
    def __init__(self, profile: Mapping[str, str] | None = None,
                 device=None):
        super().__init__()
        self.k = DEFAULT_K
        self.m = DEFAULT_M
        self.d = 0
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 0
        self.mds = None  # inner scalar MDS codec over k+nu data chunks
        self.pair: _PairwiseTransform | None = None
        self._engine = default_engine(device)
        self.device = self._engine.device
        if profile is not None:
            self.init(profile)

    # -- profile ---------------------------------------------------------
    def parse(self, profile: Mapping[str, str]) -> None:
        self.k = self.to_int(profile, "k", DEFAULT_K)
        self.m = self.to_int(profile, "m", DEFAULT_M)
        self.d = self.to_int(profile, "d", self.k + self.m - 1)
        if self.k < 1 or self.m < 1:
            raise ValueError(f"k={self.k} m={self.m} must be >= 1")
        if not (self.k <= self.d <= self.k + self.m - 1):
            raise ValueError(
                f"d={self.d} must be within [{self.k}, {self.k + self.m - 1}]"
            )
        scalar_mds = str(profile.get("scalar_mds", "jerasure")) or "jerasure"
        if scalar_mds not in _SCALAR_MDS:
            raise ValueError(
                f"scalar_mds {scalar_mds!r} not supported, use one of "
                f"{_SCALAR_MDS}"
            )
        technique = str(profile.get("technique", ""))
        if not technique:
            technique = ("reed_sol_van" if scalar_mds in ("jerasure", "isa")
                         else "single")
        # Per-plugin technique whitelists (ErasureCodeClay.cc:222-262).
        if scalar_mds == "jerasure":
            if technique not in _JERASURE_TECHNIQUES:
                raise ValueError(
                    f"technique {technique!r} not supported for jerasure; "
                    f"use one of {_JERASURE_TECHNIQUES}"
                )
        elif scalar_mds == "isa":
            if technique not in _ISA_TECHNIQUES:
                raise ValueError(
                    f"technique {technique!r} not supported for isa; use "
                    f"one of {tuple(_ISA_TECHNIQUES)}"
                )
        elif technique not in ("single", "multiple"):
            raise ValueError(
                f"technique {technique!r} not supported for shec; use "
                "'single' or 'multiple'"
            )
        self.q = self.d - self.k + 1
        self.nu = (self.q - (self.k + self.m) % self.q) % self.q
        if self.k + self.m + self.nu > 254:
            raise ValueError(
                f"k+m+nu={self.k + self.m + self.nu} exceeds 254"
            )
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t

        registry = ErasureCodePluginRegistry.instance()
        inner_plugin = _PLUGIN_ALIASES[scalar_mds]
        inner_technique = (_ISA_TECHNIQUES[technique] if scalar_mds == "isa"
                          else technique)
        mds_profile = {
            "k": str(self.k + self.nu), "m": str(self.m), "w": "8",
            "technique": inner_technique,
        }
        pft_profile = {"k": "2", "m": "2", "w": "8",
                       "technique": inner_technique}
        if scalar_mds == "shec":
            mds_profile["c"] = pft_profile["c"] = "2"
        # liber8tion is bitmatrix-only in jerasure; the engine runs every
        # technique through one kernel, so alias it to cauchy_good (same
        # Cauchy-derived construction family), as the JAX package does.
        if inner_technique == "liber8tion":
            mds_profile["technique"] = pft_profile["technique"] = "cauchy_good"
        self.mds = registry.factory(inner_plugin, mds_profile,
                                    device=self.device)
        pft_code = registry.factory(inner_plugin, pft_profile,
                                    device=self.device)
        self.pair = _PairwiseTransform(pft_code.generator[2:], self.device)

    # -- geometry --------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_alignment(self) -> int:
        return self.sub_chunk_no * SC_ALIGN

    # -- node/plane geometry helpers -------------------------------------
    def _node_of(self, chunk_id: int) -> int:
        """Chunk id -> q*t grid node id (parity shifts past the nu
        shortened nodes, ErasureCodeClay.cc:137-143)."""
        return chunk_id if chunk_id < self.k else chunk_id + self.nu

    def _chunk_of(self, node: int) -> int | None:
        if node < self.k:
            return node
        if node < self.k + self.nu:
            return None  # shortened virtual node
        return node - self.nu

    def _plane_vector(self, z: int) -> list[int]:
        vec = [0] * self.t
        for i in range(self.t):
            vec[self.t - 1 - i] = z % self.q
            z //= self.q
        return vec

    def _swap_plane(self, z: int, y: int, new_digit: int, old_digit: int) -> int:
        return z + (new_digit - old_digit) * self.q ** (self.t - 1 - y)

    def get_repair_subchunks(self, lost_node: int) -> list[tuple[int, int]]:
        """Sub-chunk (offset, count) ranges read from each helper: the
        planes whose y_lost digit equals x_lost
        (ErasureCodeClay.cc:366-380)."""
        y_lost, x_lost = divmod(lost_node, self.q)
        seq = self.q ** (self.t - 1 - y_lost)
        return [
            (x_lost * seq + i * self.q * seq, seq)
            for i in range(self.q ** y_lost)
        ]

    def _repair_planes(self, lost_node: int) -> list[int]:
        planes: list[int] = []
        for off, count in self.get_repair_subchunks(lost_node):
            planes.extend(range(off, off + count))
        return planes

    def is_repair(self, want_to_read, available) -> bool:
        """Repair path applies to a single lost chunk when the whole
        coupling group (the q-column of the lost node) minus the lost node
        plus >= d total chunks are available (ErasureCodeClay.cc:306-325)."""
        want = set(int(w) for w in want_to_read)
        avail = set(int(a) for a in available)
        if want <= avail or len(want) != 1:
            return False
        i = next(iter(want))
        lost_node = self._node_of(i)
        for x in range(self.q):
            node = (lost_node // self.q) * self.q + x
            chunk = self._chunk_of(node)
            if chunk is not None and chunk != i and chunk not in avail:
                return False
        return len(avail) >= self.d

    # -- minimum_to_decode -----------------------------------------------
    def minimum_to_decode(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> dict[int, SubChunkRanges]:
        if self.is_repair(want_to_read, available):
            return self._minimum_to_repair(want_to_read, available)
        return super().minimum_to_decode(want_to_read, available)

    def _minimum_to_repair(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> dict[int, SubChunkRanges]:
        i = int(next(iter(want_to_read)))
        lost_node = self._node_of(i)
        ranges = self.get_repair_subchunks(lost_node)
        minimum: dict[int, SubChunkRanges] = {}
        # All real nodes in the lost node's coupling column first
        # (ErasureCodeClay.cc:336-349), then fill to d from available.
        for j in range(self.q):
            node = (lost_node // self.q) * self.q + j
            if j == lost_node % self.q:
                continue
            chunk = self._chunk_of(node)
            if chunk is not None:
                minimum[chunk] = list(ranges)
        for chunk in sorted(int(a) for a in available):
            if len(minimum) >= self.d:
                break
            minimum.setdefault(chunk, list(ranges))
        if len(minimum) != self.d:
            raise IOError(
                f"clay repair needs d={self.d} helpers, found {len(minimum)}"
            )
        return minimum

    # -- host <-> device -------------------------------------------------
    def _to_device(self, arr) -> torch.Tensor:
        return self._engine.tensor(arr)

    # -- encode -----------------------------------------------------------
    def encode_chunks(self, data_chunks) -> np.ndarray:
        """(k, C) or (B, k, C) numpy -> (k+m, C) / (B, k+m, C) numpy."""
        data = self._to_device(data_chunks)
        if data.ndim == 2:
            return self.encode_chunks_device(data[None])[0].cpu().numpy()
        return self.encode_chunks_device(data).cpu().numpy()

    def encode_chunks_batch(self, data) -> np.ndarray:
        """(B, k, C) numpy -> (B, k+m, C) numpy."""
        return self.encode_chunks_device(self._to_device(data)).cpu().numpy()

    def encode_chunks_device(self, data) -> torch.Tensor:
        """(B, k, C) tensor -> (B, k+m, C) tensor on the codec's device:
        the parity nodes recovered by the layered decode."""
        data = self._to_device(data)
        B, k, C = data.shape
        if k != self.k:
            raise ValueError(f"expected k={self.k} data chunks, got {k}")
        if C % self.sub_chunk_no:
            raise ValueError(
                f"chunk size {C} not a multiple of sub_chunk_no="
                f"{self.sub_chunk_no}"
            )
        N = self.q * self.t
        sc = C // self.sub_chunk_no
        chunks = torch.zeros((B, N, self.sub_chunk_no, sc), dtype=torch.uint8,
                             device=self.device)
        chunks[:, : self.k] = data.reshape(B, k, self.sub_chunk_no, sc)
        erased = set(range(self.k + self.nu, N))
        self._decode_layered(erased, chunks)
        out = torch.cat(
            [chunks[:, : self.k], chunks[:, self.k + self.nu:]], dim=1
        )
        return out.reshape(B, self.k + self.m, C)

    # -- decode -----------------------------------------------------------
    def decode(
        self,
        want_to_read: Sequence[int],
        chunks: Mapping[int, bytes],
        chunk_size: int | None = None,
    ) -> dict[int, bytes]:
        sizes = {len(bytes(c)) for c in chunks.values()}
        if (chunk_size is not None and sizes
                and self.is_repair(want_to_read, chunks.keys())
                and chunk_size > next(iter(sizes))):
            return self._repair(want_to_read, chunks, chunk_size)
        return super().decode(want_to_read, chunks, chunk_size=chunk_size)

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
        """Batched full decode: available chunks are (B, C) arrays (the
        shape ECBackend's stripe-batched reconstruct path supplies)."""
        avail = {int(i): np.asarray(c, np.uint8) for i, c in available.items()}
        want = [int(w) for w in want_to_read]
        missing = [w for w in want if w not in avail]
        out = {w: avail[w] for w in want if w in avail}
        if missing:
            rebuilt = self.decode_chunks_device(avail, missing).cpu().numpy()
            for slot, w in enumerate(missing):
                out[w] = rebuilt[:, slot]
        return out

    def decode_chunks_device(self, available, want_to_read) -> torch.Tensor:
        """Batched full decode on the device: available maps chunk id ->
        (B, C) tensors; returns a (B, len(want), C) tensor."""
        avail = {int(i): self._to_device(c) for i, c in available.items()}
        want = [int(w) for w in want_to_read]
        N = self.q * self.t
        first = next(iter(avail.values()))
        B, C = first.shape
        if C % self.sub_chunk_no:
            raise ValueError(
                f"chunk size {C} not a multiple of sub_chunk_no="
                f"{self.sub_chunk_no}"
            )
        sc = C // self.sub_chunk_no
        chunks = torch.zeros((B, N, self.sub_chunk_no, sc), dtype=torch.uint8,
                             device=self.device)
        erased = set()
        for i in range(self.k + self.m):
            node = self._node_of(i)
            if i in avail:
                chunks[:, node] = avail[i].reshape(B, self.sub_chunk_no, sc)
            else:
                erased.add(node)
        if any(w not in avail for w in want):
            self._decode_layered(erased, chunks)
        return torch.stack(
            [avail[w] if w in avail else
             chunks[:, self._node_of(w)].reshape(B, C) for w in want], dim=1)

    # -- layered decode (the coupling machine) ----------------------------
    def _decode_layered(self, erased: set[int], chunks: torch.Tensor) -> None:
        """In-place recovery of ``erased`` nodes.

        ``chunks`` is (B, q*t, sub_chunk_no, sc); mirrors decode_layered
        (ErasureCodeClay.cc:648-712) with planes of equal intersection
        score batched through one MDS decode."""
        N = self.q * self.t
        # Pad the erasure set to exactly m with virtual/parity nodes
        # (ErasureCodeClay.cc:659-666).
        if len(erased) > self.m:
            raise IOError(
                f"clay cannot decode {len(erased)} erasures with m={self.m}"
            )
        erased = set(erased)
        for i in range(self.k + self.nu, N):
            if len(erased) >= self.m:
                break
            erased.add(i)
        U = torch.zeros_like(chunks)
        plane_vecs = [self._plane_vector(z) for z in range(self.sub_chunk_no)]
        order = [
            sum(1 for i in erased if i % self.q == vec[i // self.q])
            for vec in plane_vecs
        ]
        max_score = len({i // self.q for i in erased})
        for score in range(max_score + 1):
            planes = [z for z in range(self.sub_chunk_no)
                      if order[z] == score]
            if not planes:
                continue
            # Phase A: uncouple known nodes plane by plane, then batch-MDS
            # decode the erased nodes' U across the whole round.
            for z in planes:
                self._uncouple_plane(erased, chunks, U, z, plane_vecs[z])
            self._mds_decode_planes(erased, U, planes)
            # Phase B: recover erased nodes' coupled values.
            for z in planes:
                vec = plane_vecs[z]
                for node in sorted(erased):
                    y, x = divmod(node, self.q)
                    partner = y * self.q + vec[y]
                    if vec[y] == x:  # hole-dot pair: C = U
                        chunks[:, node, z] = U[:, node, z]
                        continue
                    z_sw = self._swap_plane(z, y, x, vec[y])
                    if partner not in erased:
                        # type-1: solve own C from partner C + own U
                        # (recover_type1_erasure ErasureCodeClay.cc:763).
                        if vec[y] < x:  # self is the hi member
                            chunks[:, node, z] = self.pair.solve_c_hi_from_u_hi(
                                U[:, node, z], chunks[:, partner, z_sw]
                            )
                        else:
                            chunks[:, node, z] = self.pair.solve_c_lo_from_u_lo(
                                U[:, node, z], chunks[:, partner, z_sw]
                            )
                    elif vec[y] < x:
                        # both erased: invert the pair once, at the hi
                        # member (get_coupled_from_uncoupled :790).
                        c_hi, c_lo = self.pair.couple(
                            U[:, node, z], U[:, partner, z_sw]
                        )
                        chunks[:, node, z] = c_hi
                        chunks[:, partner, z_sw] = c_lo

    def _uncouple_plane(
        self, erased: set[int], chunks: torch.Tensor, U: torch.Tensor,
        z: int, vec: list[int],
    ) -> None:
        """Fill U for non-erased nodes of plane z (decode_erasures,
        ErasureCodeClay.cc:714-754)."""
        for node in range(self.q * self.t):
            if node in erased:
                continue
            y, x = divmod(node, self.q)
            if vec[y] == x:
                U[:, node, z] = chunks[:, node, z]
                continue
            partner = y * self.q + vec[y]
            z_sw = self._swap_plane(z, y, x, vec[y])
            if vec[y] < x:
                # hi member computes the pair's U values once.
                u_hi, u_lo = self.pair.uncouple(
                    chunks[:, node, z], chunks[:, partner, z_sw]
                )
                U[:, node, z] = u_hi
                U[:, partner, z_sw] = u_lo
            elif partner in erased:
                # lo member with erased partner: partner C at the swapped
                # plane was recovered in an earlier round.
                u_hi, u_lo = self.pair.uncouple(
                    chunks[:, partner, z_sw], chunks[:, node, z]
                )
                U[:, partner, z_sw] = u_hi
                U[:, node, z] = u_lo

    def _mds_decode_planes(
        self, erased: set[int], U: torch.Tensor, planes: list[int]
    ) -> None:
        """Batch the per-plane scalar MDS decode (decode_uncoupled,
        ErasureCodeClay.cc:756) over all planes of a round: one erasure
        pattern -> one decode matrix -> one engine launch."""
        B = U.shape[0]
        sc = U.shape[-1]
        N = self.q * self.t
        flat = {
            node: U[:, node, planes].reshape(B * len(planes), sc)
            for node in range(N) if node not in erased
        }
        want = sorted(erased)
        out = self.mds.decode_chunks_device(flat, want)
        for slot, node in enumerate(want):
            U[:, node, planes] = out[:, slot].reshape(B, len(planes), sc)

    # -- repair (regenerating-code path) ----------------------------------
    def _repair(
        self,
        want_to_read: Sequence[int],
        chunks: Mapping[int, bytes],
        chunk_size: int,
    ) -> dict[int, bytes]:
        """Single-chunk repair from d helpers' repair sub-chunks
        (repair + repair_one_lost_chunk, ErasureCodeClay.cc:404-646), on
        the codec's device."""
        lost = int(next(iter(want_to_read)))
        lost_node = self._node_of(lost)
        if len(chunks) != self.d:
            raise IOError(
                f"clay repair needs exactly d={self.d} helpers, got "
                f"{len(chunks)}"
            )
        planes = self._repair_planes(lost_node)
        plane_pos = {z: i for i, z in enumerate(planes)}
        repair_blocksize = len(bytes(next(iter(chunks.values()))))
        if repair_blocksize % len(planes):
            raise ValueError(
                f"repair block {repair_blocksize} not divisible by "
                f"{len(planes)} repair planes"
            )
        sc = repair_blocksize // len(planes)
        if chunk_size != sc * self.sub_chunk_no:
            raise ValueError(
                f"chunk_size {chunk_size} != sub_chunk_no*sc "
                f"{sc * self.sub_chunk_no}"
            )
        N = self.q * self.t
        # Helper sub-chunks: (node, repair-plane-position, sc).
        # (shortened nodes keep zero helper data)
        helper_np = np.zeros((N, len(planes), sc), np.uint8)
        aloof = set()
        for i in range(self.k + self.m):
            node = self._node_of(i)
            if i in chunks:
                helper_np[node] = np.frombuffer(
                    bytes(chunks[i]), np.uint8
                ).reshape(len(planes), sc)
            elif i != lost:
                aloof.add(node)
        helper = self._to_device(helper_np)
        y_lost, x_lost = divmod(lost_node, self.q)
        column = {y_lost * self.q + x for x in range(self.q)}
        erased = column | aloof
        recovered = torch.zeros((self.sub_chunk_no, sc), dtype=torch.uint8,
                                device=self.device)
        U = torch.zeros((N, self.sub_chunk_no, sc), dtype=torch.uint8,
                        device=self.device)
        vecs = {z: self._plane_vector(z) for z in planes}
        order = {
            z: sum(1 for i in erased if i % self.q == vecs[z][i // self.q])
            for z in planes
        }
        pair = self.pair
        for score in sorted(set(order.values())):
            round_planes = [z for z in planes if order[z] == score]
            for z in round_planes:
                vec = vecs[z]
                for node in range(N):
                    if node in erased:
                        continue
                    y, x = divmod(node, self.q)
                    if vec[y] == x:
                        U[node, z] = helper[node, plane_pos[z]]
                        continue
                    partner = y * self.q + vec[y]
                    z_sw = self._swap_plane(z, y, x, vec[y])
                    own_c = helper[node, plane_pos[z]]
                    if partner in aloof:
                        # partner U known from an earlier round's MDS
                        # decode (ErasureCodeClay.cc:556-569).
                        if vec[y] < x:
                            U[node, z] = pair.u_hi_after_solving_c_lo(
                                own_c, U[partner, z_sw]
                            )
                        else:
                            U[node, z] = pair.u_lo_after_solving_c_hi(
                                own_c, U[partner, z_sw]
                            )
                    else:
                        partner_c = helper[partner, plane_pos[z_sw]]
                        if vec[y] < x:
                            U[node, z] = pair.uncouple(own_c, partner_c)[0]
                        else:
                            U[node, z] = pair.uncouple(partner_c, own_c)[1]
            # Batched MDS decode of this round's planes.
            flat = {
                node: U[node, round_planes]
                for node in range(N) if node not in erased
            }
            want = sorted(erased)
            out = self.mds.decode_chunks_device(flat, want)
            for slot, node in enumerate(want):
                U[node, round_planes] = out[:, slot]
            # Recover the lost chunk's values (ErasureCodeClay.cc:598-640).
            for z in round_planes:
                vec = vecs[z]
                for node in sorted(column):
                    y, x = divmod(node, self.q)
                    if x == vec[y]:  # the lost node itself (dot)
                        recovered[z] = U[node, z]
                    elif node not in aloof and node != lost_node:
                        # helper column member: solve the lost node's C at
                        # the swapped plane from own C + own U.
                        z_sw = self._swap_plane(z, y, x, vec[y])
                        own_c = helper[node, plane_pos[z]]
                        if vec[y] < x:  # self hi, lost partner is lo
                            recovered[z_sw] = pair.solve_c_lo_from_u_hi(
                                U[node, z], own_c
                            )
                        else:
                            recovered[z_sw] = pair.solve_c_hi_from_u_lo(
                                U[node, z], own_c
                            )
        return {lost: recovered.reshape(chunk_size).cpu().numpy().tobytes()}


def __erasure_code_init__(registry: ErasureCodePluginRegistry) -> None:
    registry.add("clay", ErasureCodeClay)
