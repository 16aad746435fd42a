"""ErasureCodeInterface — the abstract plugin API.

Port copy of ceph_tpu/ec/interface.py: same numpy code, kept here so the port
imports nothing of the JAX package.

Mirrors reference src/erasure-code/ErasureCodeInterface.h:170-462 member for
member (init :188, get_chunk_count :227, get_data_chunk_count :237,
get_sub_chunk_count :259, get_chunk_size :278, minimum_to_decode :297,
minimum_to_decode_with_cost :326, encode :365, encode_chunks :370,
decode :407, decode_chunks :411, get_chunk_mapping :448, decode_concat :460),
with Python/array idioms: chunks are ``bytes``/numpy arrays instead of
bufferlists, and profiles are plain dicts.

All codes are systematic: chunk i < k holds data, chunk >= k holds parity.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Mapping, Sequence

# Sub-chunk range: (offset, count) pairs within a chunk, in sub-chunk units.
# For scalar codes this is always [(0, 1)]; CLAY returns sparse ranges
# (reference ErasureCodeInterface.h:297-325).
SubChunkRanges = list[tuple[int, int]]


class ErasureCodeInterface(ABC):
    """Abstract erasure code. Instances are configured once via init()."""

    @abstractmethod
    def init(self, profile: Mapping[str, str]) -> None:
        """Initialise from a profile (k, m, technique, ...).

        Raises ValueError on an invalid profile. Mirror of
        ErasureCodeInterface.h:188 (init; profile parse errors there return
        -EINVAL and fill *ss*)."""

    @abstractmethod
    def get_profile(self) -> dict[str, str]:
        """The profile that was used to initialise this instance."""

    @abstractmethod
    def get_chunk_count(self) -> int:
        """Total chunks per stripe (k+m). ErasureCodeInterface.h:227."""

    @abstractmethod
    def get_data_chunk_count(self) -> int:
        """Data chunks per stripe (k). ErasureCodeInterface.h:237."""

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        """Sub-chunks per chunk; >1 only for array codes (CLAY).
        ErasureCodeInterface.h:259."""
        return 1

    @abstractmethod
    def get_chunk_size(self, object_size: int) -> int:
        """Chunk size for an object of ``object_size`` bytes, padded so the
        object splits into k equal aligned chunks. ErasureCodeInterface.h:278."""

    @abstractmethod
    def minimum_to_decode(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> dict[int, SubChunkRanges]:
        """Smallest set of chunks (with sub-chunk ranges) that must be read
        to reconstruct ``want_to_read`` given ``available``.
        Raises IOError if impossible. ErasureCodeInterface.h:297."""

    def minimum_to_decode_with_cost(
        self, want_to_read: Sequence[int], available: Mapping[int, int]
    ) -> dict[int, SubChunkRanges]:
        """Like minimum_to_decode but chunks have read costs; default picks
        the cheapest available chunks first. ErasureCodeInterface.h:326."""
        ordered = sorted(available, key=lambda c: (available[c], c))
        return self.minimum_to_decode(want_to_read, ordered)

    @abstractmethod
    def encode(
        self, want_to_encode: Sequence[int], data: bytes
    ) -> dict[int, bytes]:
        """Split+pad ``data`` into k chunks, compute parity, return the
        requested chunk ids. ErasureCodeInterface.h:365."""

    @abstractmethod
    def encode_chunks(self, data_chunks) -> "object":
        """Raw chunk-level encode: (k, chunk_size) -> (k+m, chunk_size).
        ErasureCodeInterface.h:370."""

    @abstractmethod
    def decode(
        self,
        want_to_read: Sequence[int],
        chunks: Mapping[int, bytes],
        chunk_size: int | None = None,
    ) -> dict[int, bytes]:
        """Reconstruct ``want_to_read`` chunk ids from available ``chunks``.
        ErasureCodeInterface.h:407."""

    @abstractmethod
    def decode_chunks(self, available: Mapping[int, "object"], want_to_read):
        """Raw chunk-level decode. ErasureCodeInterface.h:411."""

    def get_chunk_mapping(self) -> list[int]:
        """Chunk remap vector; empty means identity.
        ErasureCodeInterface.h:448."""
        return []

    def decode_concat(self, chunks: Mapping[int, bytes]) -> bytes:
        """Reconstruct and concatenate the data chunks (the read path of
        ErasureCodeInterface.h:460)."""
        k = self.get_data_chunk_count()
        mapping = self.get_chunk_mapping()
        physical = [mapping[i] if mapping else i for i in range(k)]
        out = self.decode(physical, chunks)
        return b"".join(out[p] for p in physical)

    def create_rule(self, name: str, crush) -> int:
        """Create a placement rule spreading chunks over failure domains
        (ErasureCodeInterface.h:212). Implemented once placement exists;
        plugins override to add layer-specific steps (LRC)."""
        profile = self.get_profile()
        return crush.create_ec_rule(
            name,
            chunk_count=self.get_chunk_count(),
            failure_domain=profile.get("crush-failure-domain", "host"),
            root=profile.get("crush-root", "default"),
            device_class=profile.get("crush-device-class", ""),
        )
