"""crc32c (Castagnoli) with a native C fast path.

Counterpart of ceph_tpu/common/crc32c.py.  Loads the port's own native
library through ctypes: its copy of the C source
(``ceph_tpu_torch/native/crc32c.c``: the CPU's CRC32 instruction where it
has one, else a slice-by-8 table loop) and of the WAL engine
(``native/wal_engine.cc``, which calls ``ceph_tpu_crc32c``; bound by
``store/native_wal.py``) linked into one shared object, built at first use
with

    gcc -O3 -fPIC -c native/crc32c.c
    g++ -O3 -fPIC -std=c++17 -c native/wal_engine.cc
    g++ -shared -o _build/native-<hash>.so crc32c.o wal_engine.o

into ``ceph_tpu_torch/_build/`` (gitignored, named by a hash of the
sources and the flags, published with an atomic rename so concurrent
first uses never load a half-written file).  Without a C compiler it falls
back to the pure-Python table loop.  ``backend()`` says which one
serves, ``native_path()`` which path of the C source, and ``stats()`` how
many calls and bytes each served.

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
WAL_SOURCE = PACKAGE_DIR / "native" / "wal_engine.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CFLAGS = ("-O3", "-fPIC")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_native = None          # None: not tried yet; False: unavailable


def library_path() -> pathlib.Path:
    """Where native/crc32c.c and native/wal_engine.cc build to
    (content-addressed)."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + WAL_SOURCE.read_bytes()
        + " ".join(CFLAGS + CXXFLAGS).encode()).hexdigest()
    return BUILD_DIR / f"native-{digest[:16]}.so"


def _build(target: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        crc_o = os.path.join(tmp, "crc32c.o")
        wal_o = os.path.join(tmp, "wal_engine.o")
        lib = os.path.join(tmp, target.name)
        for cmd in (["gcc", *CFLAGS, "-c", "-o", crc_o, str(SOURCE)],
                    ["g++", *CXXFLAGS, "-c", "-o", wal_o, str(WAL_SOURCE)],
                    ["g++", "-shared", "-o", lib, crc_o, wal_o]):
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(lib, target)


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
            lib.ceph_tpu_crc32c_path.restype = ctypes.c_char_p
            lib.ceph_tpu_crc32c_stats.argtypes = (
                ctypes.POINTER(ctypes.c_uint64),)
            _native = lib
        except (OSError, subprocess.SubprocessError):
            _native = False
    return _native


def backend() -> str:
    """"native" when the C library serves crc32c, else "python"."""
    return "native" if _load_native() else "python"


def native_path() -> str:
    """The C source's path chosen for this CPU: "sse4.2-3way",
    "armv8-crc" or "table"; "python" without the native library."""
    lib = _load_native()
    return lib.ceph_tpu_crc32c_path().decode() if lib else "python"


def stats() -> dict:
    """Calls through the native crc32c since the library loaded, and the
    bytes that the hardware path and the table loop served."""
    out = (ctypes.c_uint64 * 3)()
    lib = _load_native()
    if lib:
        lib.ceph_tpu_crc32c_stats(out)
    return {"path": native_path(), "hw_bytes": out[0],
            "table_bytes": out[1], "calls": out[2]}


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
