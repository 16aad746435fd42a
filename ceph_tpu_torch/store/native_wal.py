"""ctypes bindings for the native WAL engine (native/wal_engine.cc).

Counterpart of ceph_tpu/store/native_wal.py.  Loads the port's native
library, the one shared object that ``common/crc32c.py`` builds from the
port's ``native/crc32c.c`` and ``native/wal_engine.cc``; absent or
unbuildable native code degrades to the pure-Python file path in
walstore.py (identical on-disk format, so the two interoperate on the
same files, and with the JAX package's).
"""

from __future__ import annotations

import ctypes
import struct

from ceph_tpu_torch.common import crc32c as _crc_mod

_LEN = struct.Struct("<I")


def _lib():
    lib = _crc_mod._load_native()
    if not lib:
        return None
    if getattr(lib, "_wal_ready", False):
        return lib
    try:
        lib.we_open.restype = ctypes.c_void_p
        lib.we_open.argtypes = (ctypes.c_char_p, ctypes.c_int)
        lib.we_append.restype = ctypes.c_long
        lib.we_append.argtypes = (ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_size_t)
        lib.we_reset.restype = ctypes.c_int
        lib.we_reset.argtypes = (ctypes.c_void_p,)
        lib.we_close.restype = ctypes.c_int
        lib.we_close.argtypes = (ctypes.c_void_p,)
        lib.we_replay.restype = ctypes.c_int
        lib.we_replay.argtypes = (
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t),
        )
        lib.we_write_checkpoint.restype = ctypes.c_int
        lib.we_write_checkpoint.argtypes = (
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
        )
        lib.we_read_checkpoint.restype = ctypes.c_int
        lib.we_read_checkpoint.argtypes = (
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t),
        )
        lib.we_free.restype = None
        lib.we_free.argtypes = (ctypes.c_void_p,)
    except AttributeError:
        return None                 # stale .so without the wal symbols
    lib._wal_ready = True
    return lib


def available() -> bool:
    return _lib() is not None


class NativeWal:
    """One open WAL append handle."""

    def __init__(self, path: str, sync: bool):
        lib = _lib()
        if lib is None:
            raise OSError("native wal engine unavailable")
        self._lib = lib
        self._h = lib.we_open(str(path).encode(), 1 if sync else 0)
        if not self._h:
            raise OSError(f"we_open({path}) failed")

    def append(self, payload: bytes) -> int:
        """Framed append; returns WAL size after, raises on IO error."""
        size = self._lib.we_append(self._h, payload, len(payload))
        if size < 0:
            raise OSError("we_append failed")
        return size

    def reset(self) -> None:
        if self._lib.we_reset(self._h) != 0:
            raise OSError("we_reset failed")

    def close(self) -> None:
        if self._h:
            self._lib.we_close(self._h)
            self._h = None


def replay(path: str) -> list[bytes]:
    """Validated WAL payloads; truncates a torn tail in place."""
    lib = _lib()
    if lib is None:
        raise OSError("native wal engine unavailable")
    out = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    if lib.we_replay(str(path).encode(), ctypes.byref(out),
                     ctypes.byref(out_len)) != 0:
        raise OSError(f"we_replay({path}) failed")
    if not out or not out_len.value:
        return []
    try:
        buf = ctypes.string_at(out, out_len.value)
    finally:
        lib.we_free(out)
    payloads = []
    pos = 0
    while pos + _LEN.size <= len(buf):
        (n,) = _LEN.unpack_from(buf, pos)
        pos += _LEN.size
        payloads.append(buf[pos:pos + n])
        pos += n
    return payloads


def write_checkpoint(path: str, blob: bytes) -> None:
    lib = _lib()
    if lib is None:
        raise OSError("native wal engine unavailable")
    if lib.we_write_checkpoint(str(path).encode(), blob,
                               len(blob)) != 0:
        raise OSError(f"we_write_checkpoint({path}) failed")


def read_checkpoint(path: str) -> bytes | None:
    """Validated checkpoint blob, or None (absent/torn: WAL-only)."""
    lib = _lib()
    if lib is None:
        raise OSError("native wal engine unavailable")
    out = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    rc = lib.we_read_checkpoint(str(path).encode(), ctypes.byref(out),
                                ctypes.byref(out_len))
    if rc == 1:
        return None
    if rc != 0:
        raise OSError(f"we_read_checkpoint({path}) failed")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.we_free(out)
