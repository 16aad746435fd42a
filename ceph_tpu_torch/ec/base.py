"""ErasureCode — shared base implementation over the abstract interface.

Port copy of ceph_tpu/ec/base.py: same numpy code, kept here so the port
imports nothing of the JAX package.

Mirrors reference src/erasure-code/ErasureCode.cc: encode_prepare padding
(:151 — pad input to k equal chunks, zero-fill the tail), the greedy default
``_minimum_to_decode`` (:103 — data chunks if all present, else first k
available), chunk_index remapping (:98), and encode driving encode_chunks.

Chunk alignment is per-plugin via ``get_alignment()``; the default is
128 bytes (one lane row) so device layouts tile cleanly, vs jerasure's
SIMD/packetsize-driven per-technique alignment
(reference ErasureCodeJerasure.cc:82-101).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from ceph_tpu_torch.ec.interface import ErasureCodeInterface, SubChunkRanges

DEFAULT_ALIGNMENT = 128


class ErasureCode(ErasureCodeInterface):
    def __init__(self) -> None:
        self._profile: dict[str, str] = {}
        self.chunk_mapping: list[int] = []

    # -- profile ---------------------------------------------------------
    def init(self, profile: Mapping[str, str]) -> None:
        self._profile = {str(k): str(v) for k, v in profile.items()}
        self.parse(self._profile)

    def parse(self, profile: Mapping[str, str]) -> None:
        """Plugin-specific profile parsing; override."""

    def get_profile(self) -> dict[str, str]:
        return dict(self._profile)

    @staticmethod
    def to_int(profile: Mapping[str, str], key: str, default: int) -> int:
        v = profile.get(key, default)
        try:
            return int(v)
        except (TypeError, ValueError):
            raise ValueError(f"profile {key}={v!r} is not an integer") from None

    # -- geometry --------------------------------------------------------
    def get_alignment(self) -> int:
        return DEFAULT_ALIGNMENT

    def get_chunk_size(self, object_size: int) -> int:
        k = self.get_data_chunk_count()
        align = self.get_alignment()
        width = k * align
        padded = -(-object_size // width) * width if object_size else width
        return padded // k

    def get_chunk_mapping(self) -> list[int]:
        return list(self.chunk_mapping)

    def chunk_index(self, i: int) -> int:
        """Logical chunk -> stored position (ErasureCode.cc:98)."""
        return self.chunk_mapping[i] if self.chunk_mapping else i

    # -- minimum_to_decode ----------------------------------------------
    def _default_ranges(self, chunks: Sequence[int]) -> dict[int, SubChunkRanges]:
        return {int(c): [(0, self.get_sub_chunk_count())] for c in chunks}

    def minimum_to_decode(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> dict[int, SubChunkRanges]:
        avail = set(available)
        want = list(dict.fromkeys(want_to_read))
        if set(want) <= avail:
            return self._default_ranges(want)
        k = self.get_data_chunk_count()
        if len(avail) < k:
            raise IOError(
                f"cannot decode: want {want}, only {sorted(avail)} available"
            )
        # Greedy: first k available chunks in the order offered — callers
        # express preference (e.g. cost order) by ordering ``available``
        # (ErasureCode.cc:103 greedy pick).
        picked = list(dict.fromkeys(int(c) for c in available))[:k]
        return self._default_ranges(picked)

    # -- encode ----------------------------------------------------------
    def encode_prepare(self, data: bytes) -> np.ndarray:
        """Pad ``data`` to k equal aligned chunks, zero-filling the tail
        (ErasureCode.cc:151). Returns a (k, chunk_size) uint8 array."""
        k = self.get_data_chunk_count()
        chunk = self.get_chunk_size(len(data))
        buf = np.zeros(k * chunk, dtype=np.uint8)
        buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
        return buf.reshape(k, chunk)

    def encode(
        self, want_to_encode: Sequence[int], data: bytes
    ) -> dict[int, bytes]:
        chunks = self.encode_chunks(self.encode_prepare(data))
        chunks = np.asarray(chunks)
        return {
            int(i): chunks[self.chunk_index(int(i))].tobytes()
            for i in want_to_encode
        }

    # -- decode ----------------------------------------------------------
    def decode(
        self,
        want_to_read: Sequence[int],
        chunks: Mapping[int, bytes],
        chunk_size: int | None = None,
    ) -> dict[int, bytes]:
        avail = {
            int(i): np.frombuffer(bytes(c), dtype=np.uint8)
            for i, c in chunks.items()
        }
        sizes = {a.shape[0] for a in avail.values()}
        if len(sizes) > 1:
            raise ValueError(f"chunks have mismatched sizes {sorted(sizes)}")
        if chunk_size is not None and sizes and sizes != {chunk_size}:
            raise ValueError(
                f"chunks are {sizes.pop()} bytes, expected chunk_size={chunk_size}"
            )
        want = [int(w) for w in want_to_read]
        out = self.decode_chunks(avail, want)
        return {w: np.asarray(out[w]).tobytes() for w in want}
