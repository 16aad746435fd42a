"""Pluggable compressor framework.

Counterpart of ceph_tpu/common/compressor.py: the same module over the
port's imports.

The role of reference src/compressor/Compressor.h:33 (Compressor base +
per-algorithm plugins loaded by name) with the algorithms this image
ships natively: zlib, zstd (python-zstandard), lzma (xz), bz2.  The
same registry serves both consumers the reference has:

- RGW at-rest compression (rgw_compression.cc role —
  services/rgw.py routes per-bucket algs through here), and
- store-tier inline compression (the BlueStore compress-on-write role
  — store/walstore.py wraps WAL records and checkpoint segments in
  the envelope below).

``envelope_pack``/``envelope_unpack`` give storage tiers one shared
at-rest format: a small header naming the algorithm plus the RAW
length and crc32c of the uncompressed bytes, so every stored extent
carries its own integrity check (the BlueStore per-blob csum role) and
files stay readable when the configured algorithm changes.
"""

from __future__ import annotations

import bz2
import lzma
import struct
import zlib

from ceph_tpu_torch.common.crc32c import crc32c


class Compressor:
    """One algorithm; subclasses define name/compress/decompress
    (ErasureCode-style plugin shape, Compressor.h:33)."""

    name = "none"

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes) -> bytes:
        return data


class ZlibCompressor(Compressor):
    name = "zlib"

    def __init__(self, level: int = 6):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)


class ZstdCompressor(Compressor):
    name = "zstd"

    def __init__(self, level: int = 3):
        import zstandard            # noqa: F401 — probe at registration

        self.level = level

    def compress(self, data: bytes) -> bytes:
        # per-call context: zstandard compressor objects share one
        # ZSTD_CCtx and are NOT safe for concurrent use — WalStore
        # compresses from the commit thread and the background
        # checkpoint thread at once
        import zstandard

        return zstandard.ZstdCompressor(level=self.level).compress(data)

    def decompress(self, data: bytes) -> bytes:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(data)


class LzmaCompressor(Compressor):
    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data, preset=1)

    def decompress(self, data: bytes) -> bytes:
        return lzma.decompress(data)


class Bz2Compressor(Compressor):
    name = "bz2"

    def compress(self, data: bytes) -> bytes:
        return bz2.compress(data, 1)

    def decompress(self, data: bytes) -> bytes:
        return bz2.decompress(data)


def _build_factories() -> dict:
    """Probe availability at registration (the plugin-load step of
    Compressor.h): an algorithm whose backing module is missing must
    not be offered — a bucket configured with it would then 500 on
    every PUT, and an unreadable extent would masquerade as torn."""
    out = {"zlib": ZlibCompressor, "lzma": LzmaCompressor,
           "bz2": Bz2Compressor}
    try:
        import zstandard            # noqa: F401

        out["zstd"] = ZstdCompressor
    except ImportError:
        pass
    return out


_FACTORIES = _build_factories()
_instances: dict[str, Compressor] = {}


def list_compressors() -> list[str]:
    return sorted(_FACTORIES)


def get_compressor(name: str) -> Compressor:
    """Compressor by algorithm name (raises ValueError for unknown or
    unavailable — the create() failure path of Compressor.h)."""
    c = _instances.get(name)
    if c is None:
        factory = _FACTORIES.get(name)
        if factory is None:
            raise ValueError(
                f"unknown compressor {name!r}; have {list_compressors()}")
        c = _instances[name] = factory()
    return c


# -- shared at-rest envelope (per-extent alg + raw len + raw crc) --------
_MAGIC = b"\x01CZ1"
_RAW_MAGIC = b"\x00RAW"
_HDR = struct.Struct("<BII")     # alg name len, raw_len, raw_crc32c


def envelope_pack(data: bytes, alg: str | None) -> bytes:
    """Wrap one extent for storage.  With an algorithm: header + the
    compressed bytes (kept even when bigger — the caller's framing has
    already committed to this record).  Without: pass through, escaping
    a payload that would masquerade as an envelope."""
    if alg:
        comp = get_compressor(alg)
        name = alg.encode()
        return (_MAGIC + _HDR.pack(len(name), len(data),
                                   crc32c(0xFFFFFFFF, data))
                + name + comp.compress(data))
    if data.startswith((_MAGIC, _RAW_MAGIC)):
        return _RAW_MAGIC + data
    return data


def envelope_unpack(stored: bytes) -> bytes:
    """Inverse of envelope_pack; verifies the raw-byte checksum (the
    per-extent csum check — corruption inside a compressed extent is
    detected even when the outer framing's crc of the STORED bytes
    still matches a torn decompression)."""
    if stored.startswith(_RAW_MAGIC):
        return stored[len(_RAW_MAGIC):]
    if not stored.startswith(_MAGIC):
        return stored
    off = len(_MAGIC)
    try:
        name_len, raw_len, raw_crc = _HDR.unpack_from(stored, off)
        off += _HDR.size
        alg = stored[off:off + name_len].decode()
        raw = get_compressor(alg).decompress(stored[off + name_len:])
    except ValueError:
        raise
    except Exception as e:   # torn header / codec-specific error class
        raise ValueError(f"undecodable compressed extent: {e}") from e
    if len(raw) != raw_len or crc32c(0xFFFFFFFF, raw) != raw_crc:
        raise ValueError(
            f"compressed extent failed {alg} integrity check "
            f"(len {len(raw)} vs {raw_len})")
    return raw
