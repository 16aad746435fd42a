"""jax_rs — the flagship RS/Cauchy codec on the port's GF(2) kernels.

Counterpart of ceph_tpu/ec/plugins/jax_rs.py, under the same plugin and
profile name, so profiles and the ``corpus/jax_rs_*.json`` archives carry
over.  Covers the jerasure techniques (reed_sol_van, reed_sol_r6_op,
cauchy_orig, cauchy_good), the isa-l constructions (isa_vandermonde,
isa_cauchy, with the reference's MDS-safety caps), the bit-schedule codes
(liberation, blaum_roth, liber8tion) and wide-symbol reed_sol_van w=16/32,
all through one engine (engine.BitplaneEngine).

The codec runs on one torch device (CUDA unless ``device="cpu"`` is
given).  Host entries (``encode_chunks``, ``decode_chunks``...) take and
return numpy; the ``*_device`` entries take and return tensors on the
codec's device.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch

from ceph_tpu_torch.common.cache import FIFOCache
from ceph_tpu_torch.ec import bitsched, reference
from ceph_tpu_torch.ec.base import ErasureCode
from ceph_tpu_torch.ec.engine import default_engine
from ceph_tpu_torch.ec.matrix import generator_matrix
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

TECHNIQUES = (
    "reed_sol_van",
    "reed_sol_r6_op",
    "cauchy_orig",
    "cauchy_good",
    "isa_vandermonde",
    "isa_cauchy",
    # bit-schedule techniques (reference ErasureCodeJerasure.h:192-240)
    "liberation",
    "blaum_roth",
    "liber8tion",
)

# techniques that run as raw GF(2) bitmatrices in packet layout
BITSCHED_TECHNIQUES = ("liberation", "blaum_roth", "liber8tion")

DEFAULT_K = 2
DEFAULT_M = 2
DEFAULT_TECHNIQUE = "reed_sol_van"


class ErasureCodeJaxRS(ErasureCode):
    def __init__(self, profile: Mapping[str, str] | None = None,
                 device=None):
        super().__init__()
        self.k = DEFAULT_K
        self.m = DEFAULT_M
        self.w = 8
        self.technique = DEFAULT_TECHNIQUE
        self.generator: np.ndarray | None = None
        self.full_bm: np.ndarray | None = None
        self._engine = default_engine(device)
        self.device = self._engine.device
        self._decode_matrix_cache: FIFOCache = FIFOCache(512)
        if profile is not None:
            self.init(profile)

    # -- profile ---------------------------------------------------------
    def parse(self, profile: Mapping[str, str]) -> None:
        self.k = self.to_int(profile, "k", DEFAULT_K)
        self.m = self.to_int(profile, "m", DEFAULT_M)
        self.technique = str(profile.get("technique", DEFAULT_TECHNIQUE))
        if self.k < 1 or self.m < 1:
            raise ValueError(f"k={self.k} m={self.m} must be >= 1")
        if self.technique not in TECHNIQUES:
            raise ValueError(
                f"unknown technique {self.technique!r}; have {TECHNIQUES}"
            )
        default_w = {"liberation": 7, "blaum_roth": 6,
                     "liber8tion": 8}.get(self.technique, 8)
        self.w = self.to_int(profile, "w", default_w)
        self.full_bm = None            # raw-GF(2) bitmatrix mode if set
        if self.technique in BITSCHED_TECHNIQUES:
            # bit-schedule RAID-6 family: m=2 fixed, per-technique w
            if self.m != 2:
                raise ValueError(f"{self.technique} requires m=2")
            if self.technique == "liberation":
                parity = bitsched.liberation_bitmatrix(self.k, self.w)
            elif self.technique == "blaum_roth":
                parity = bitsched.blaum_roth_bitmatrix(self.k, self.w)
            else:
                if self.w != 8:
                    raise ValueError("liber8tion requires w=8")
                parity = bitsched.liber8tion_bitmatrix(self.k)
            self.full_bm = bitsched.full_bitmatrix(parity, self.k, self.w)
            self.generator = None
        elif self.w in (16, 32):
            # wide-symbol RS: GF(2^w) generator expanded to a bitmatrix
            # run in packet layout (jerasure w=16/32 semantics)
            if self.technique != "reed_sol_van":
                raise ValueError(
                    f"w={self.w} is supported for reed_sol_van only"
                )
            if self.k + self.m > (1 << self.w):
                raise ValueError(f"k+m must be <= 2^{self.w}")
            gen = bitsched.reed_sol_van_w(self.k, self.m, self.w)
            self.full_bm = bitsched.matrix_to_bitmatrix(gen, self.w)
            self.generator = None
        else:
            if self.w != 8:
                raise ValueError(
                    f"w={self.w} unsupported for {self.technique} "
                    f"(w in {{8,16,32}} for reed_sol_van; technique "
                    f"defaults otherwise)"
                )
            if self.k + self.m > 256:
                raise ValueError("k+m must be <= 256 in GF(2^8)")
            if self.technique == "isa_vandermonde":
                # Matrix-safety caps (ErasureCodeIsa.cc:330-360).
                if self.m > 4:
                    raise ValueError("isa_vandermonde requires m <= 4")
                if self.m == 4 and self.k > 21:
                    raise ValueError("isa_vandermonde m=4 requires k <= 21")
            if self.technique == "reed_sol_r6_op" and self.m != 2:
                raise ValueError("reed_sol_r6_op requires m=2")
            self.generator = generator_matrix(self.technique, self.k,
                                              self.m)
        self._decode_matrix_cache.clear()

    def get_alignment(self) -> int:
        base = super().get_alignment()
        if self.full_bm is None:
            return base
        return math.lcm(base, self.w)  # chunks must split into w packets

    # -- geometry --------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    # -- host <-> device -------------------------------------------------
    def _to_device(self, arr) -> torch.Tensor:
        return self._engine.tensor(arr)

    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    # -- encode ----------------------------------------------------------
    def encode_chunks(self, data_chunks) -> np.ndarray:
        return self.encode_chunks_batch(data_chunks)

    def encode_chunks_batch(self, data) -> np.ndarray:
        """(B, k, C) or (k, C) numpy -> (B, k+m, C) / (k+m, C) numpy."""
        return self._to_host(self.encode_chunks_device(self._to_device(data)))

    def _require_gf8(self, what: str) -> None:
        if self.full_bm is not None:
            raise NotImplementedError(
                f"{what}: device word/shard paths serve the GF(2^8) "
                f"techniques; bit-schedule codes use the packet path"
            )

    def encode_chunks_device(self, data) -> torch.Tensor:
        """Tensor in, tensor out on the codec's device — no host round
        trip.  (B, k, C) -> (B, k+m, C), or (k, C) -> (k+m, C)."""
        data = self._to_device(data)
        if self.full_bm is not None:
            parity = self._engine.apply_packets(
                self.full_bm[self.k * self.w:], data, self.w
            )
            return torch.cat([data, parity], dim=-2)
        return self._engine.encode(self.generator, data)

    def encode_shards_device(self, data) -> torch.Tensor:
        """Shard-stream encode: (k, N) uint8 tensor -> (k+m, N)."""
        self._require_gf8("encode_shards_device")
        return self._engine.encode_shards(self.generator, data)

    def encode_words_device(self, words) -> torch.Tensor:
        """Word-typed hot path: (k, N4) int32 shard lanes -> (m, N4) parity
        lanes, no uint8 relayout (cuda_kernels.bytes_to_words view)."""
        self._require_gf8("encode_words_device")
        return self._engine.apply_words(self.generator[self.k:], words)

    def decode_words_device(self, available, want_to_read) -> torch.Tensor:
        """Word-typed reconstruct: available maps chunk id -> (N4,) int32
        lane tensors; returns (len(want), N4) int32."""
        self._require_gf8("decode_words_device")
        want = [int(w) for w in want_to_read]
        avail_ids = sorted(int(i) for i in available)
        if len(avail_ids) < self.k:
            raise IOError(f"cannot decode {want}")
        survivors = tuple(avail_ids[: self.k])
        D = self._decode_matrix(survivors, tuple(want))
        stacked = torch.stack([available[s] for s in survivors], dim=0)
        return self._engine.apply_words(D, stacked)

    def decode_chunks_device(self, available, want_to_read) -> torch.Tensor:
        """Batched device-resident reconstruct: available maps chunk id ->
        (B, C) tensors; returns a (B, len(want), C) tensor."""
        want = [int(w) for w in want_to_read]
        avail_ids = sorted(int(i) for i in available)
        if len(avail_ids) < self.k:
            raise IOError(f"cannot decode {want}")
        survivors = tuple(avail_ids[: self.k])
        D = self._decode_matrix(survivors, tuple(want))
        stacked = torch.stack([available[s] for s in survivors], dim=1)
        return self._apply_decode(D, stacked)

    # -- decode ----------------------------------------------------------
    def decode_selection(
        self, available_ids, missing
    ) -> tuple[tuple[int, ...], np.ndarray]:
        """Deterministic survivor choice + decode matrix (the first k
        available ids in order), one definition for every decode path."""
        survivors = tuple(sorted(int(i) for i in available_ids)[: self.k])
        return survivors, self._decode_matrix(survivors,
                                              tuple(int(m)
                                                    for m in missing))

    def _decode_matrix(
        self, survivors: tuple[int, ...], wanted: tuple[int, ...]
    ) -> np.ndarray:
        key = (survivors, wanted)
        hit = self._decode_matrix_cache.get(key)
        if hit is None:
            if self.full_bm is not None:
                hit = bitsched.decode_bitmatrix(
                    self.full_bm, self.k, self.w,
                    list(survivors), list(wanted),
                )
            else:
                hit = reference.decode_matrix(
                    self.generator, list(survivors), list(wanted)
                )
            self._decode_matrix_cache.put(key, hit)
        return hit

    def _apply_decode(self, D: np.ndarray, stacked) -> torch.Tensor:
        if self.full_bm is not None:
            return self._engine.apply_packets(D, stacked, self.w)
        return self._engine.apply(D, stacked)

    def decode_chunks(
        self, available: Mapping[int, np.ndarray], want_to_read: Sequence[int]
    ) -> dict[int, np.ndarray]:
        avail = {int(i): np.asarray(c, np.uint8) for i, c in available.items()}
        want = [int(w) for w in want_to_read]
        out: dict[int, np.ndarray] = {}
        missing = [w for w in want if w not in avail]
        if missing:
            if len(avail) < self.k:
                raise IOError(
                    f"cannot decode {missing}: only {len(avail)} of "
                    f"k={self.k} chunks available"
                )
            survivors = tuple(sorted(avail)[: self.k])
            D = self._decode_matrix(survivors, tuple(missing))
            stacked = np.stack([avail[s] for s in survivors])
            rebuilt = self._to_host(
                self._apply_decode(D, self._to_device(stacked)))
            for i, w in enumerate(missing):
                out[w] = rebuilt[i]
        for w in want:
            if w in avail:
                out[w] = avail[w]
        return out

    def decode_chunks_batch(
        self, available: Mapping[int, np.ndarray], want_to_read: Sequence[int]
    ) -> dict[int, np.ndarray]:
        """Batched reconstruct: available chunks are (B, C) arrays."""
        avail = {int(i): np.asarray(c, np.uint8) for i, c in available.items()}
        want = [int(w) for w in want_to_read]
        missing = [w for w in want if w not in avail]
        out: dict[int, np.ndarray] = {w: avail[w] for w in want if w in avail}
        if missing:
            if len(avail) < self.k:
                raise IOError(f"cannot decode {missing}")
            survivors, D = self.decode_selection(avail, missing)
            stacked = np.stack(
                [avail[s] for s in survivors], axis=1
            )  # (B, k, C)
            rebuilt = self._to_host(
                self._apply_decode(D, self._to_device(stacked)))
            for i, w in enumerate(missing):
                out[w] = rebuilt[:, i]
        return out


def __erasure_code_init__(registry: ErasureCodePluginRegistry) -> None:
    registry.add("jax_rs", ErasureCodeJaxRS)
