"""crc32c (Castagnoli) with a native C fast path.

Counterpart of ceph_tpu/common/crc32c.py.  Loads the port's own copy of
the slice-by-8 C source (``ceph_tpu_torch/native/crc32c.c``) through
ctypes, built at first use with

    gcc -O3 -fPIC -shared -o _build/crc32c-<hash>.so native/crc32c.c

into ``ceph_tpu_torch/_build/`` (gitignored, named by a hash of the source
and the flags, published with an atomic rename so concurrent first uses
never load a half-written file).  Without a C compiler it falls back to
the pure-Python table loop.  ``backend()`` says which one serves.

Semantics match ceph_crc32c(seed, buf, len) (reference
src/common/crc32c.h): callers chain seeds; ECUtil HashInfo uses the
previous cumulative crc as the seed for each appended shard extent.
This is host code; the device CRC is ``ceph_tpu_torch.ec.checksum``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "crc32c.c"
BUILD_DIR = PACKAGE_DIR / "_build"
CFLAGS = ("-O3", "-fPIC", "-shared")

_lock = threading.Lock()
_native = None          # None: not tried yet; False: unavailable


def library_path() -> pathlib.Path:
    """Where native/crc32c.c builds to (content-addressed)."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()
    return BUILD_DIR / f"crc32c-{digest[:16]}.so"


def _build(target: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["gcc", *CFLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_native():
    global _native
    if _native is not None:
        return _native
    with _lock:
        if _native is not None:
            return _native
        try:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            lib.ceph_tpu_crc32c.restype = ctypes.c_uint32
            lib.ceph_tpu_crc32c.argtypes = (
                ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t,
            )
            _native = lib
        except (OSError, subprocess.SubprocessError):
            _native = False
    return _native


def backend() -> str:
    """"native" when the C library serves crc32c, else "python"."""
    return "native" if _load_native() else "python"


_TABLE = None


def table() -> list[int]:
    """The reflected CRC32C byte table (polynomial 0x82F63B78), 256
    entries; the Python loop's and ``ec.checksum.crc_bitmatrix``'s."""
    global _TABLE
    if _TABLE is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            tbl.append(c)
        _TABLE = tbl
    return _TABLE


def crc32c(crc: int, data: bytes | bytearray | memoryview) -> int:
    """Castagnoli CRC over ``data`` seeded with ``crc``."""
    if not isinstance(data, bytes):
        data = bytes(data)  # bytes pass to ctypes zero-copy
    lib = _load_native()
    if lib:
        return int(lib.ceph_tpu_crc32c(crc & 0xFFFFFFFF, data, len(data)))
    tbl = table()
    c = (~crc) & 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return (~c) & 0xFFFFFFFF
