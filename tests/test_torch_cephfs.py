"""The port's CephFS against the JAX package's.

The scenarios of tests/test_cephfs.py (the namespace, files across block
boundaries, hard and symbolic links, snapshots, the MDS's restart and
journal replay) run on both packages, the port's daemons on
``device="cpu"``, each with its transcript (see tests/test_torch_rgw.py)
equal across them: every call into ``CephFS``, its ``FileHandle``s and
``VolumeManager`` with its result or error, and at teardown every RADOS
object of every pool.  The MDS keeps its dentries, journal frames, tables
and backtraces as encoded records whose inodes carry the wall clock's
times, so the dump keeps each such record decoded (``fs_norm``), its times
by shape; file data stays byte for byte.

This file also holds the machinery the other CephFS files share.
"""

import importlib
import re
import struct
import time

import pytest

import test_torch_rgw
from ceph_tpu_torch.msg.codec import decode
from test_torch_rgw import (ROOTS, norm, norm_text, run_twin_scenario,
                            scenarios)

_FRAME = struct.Struct("<I")


def _records(raw: bytes):
    """``raw`` as the MDS's records: one encoded dict or list (a dentry, a
    table, a backtrace), or a journal of length-framed ones; None when it
    is neither (file data, plain text)."""
    if raw[:1] in (b"d", b"l"):
        try:
            return "record", decode(raw)
        except Exception:
            pass
    out, pos = [], 0
    while pos + _FRAME.size <= len(raw):
        (n,) = _FRAME.unpack_from(raw, pos)
        end = pos + _FRAME.size + n
        if end > len(raw):
            return None
        try:
            out.append(decode(raw[pos + _FRAME.size:end]))
        except Exception:
            return None
        pos = end
    return ("frames", out) if out and pos == len(raw) else None


def fs_norm(v):
    """A dumped value as ``norm`` keeps it, but an encoded MDS record
    decoded first and a short line of printable text (a rename marker's
    ``str(time.time())``, an ino watermark) kept as text, so that their
    times compare by shape."""
    if isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        rec = _records(b)
        if rec is not None:
            return rec[0], fs_norm(rec[1])
        if 0 < len(b) <= 64 and b.isascii() and b.decode().isprintable():
            return "text", norm_text(b.decode())
        return norm(b)
    if isinstance(v, dict):
        return [(norm(k), fs_norm(x)) for k, x in v.items()]
    if isinstance(v, (list, tuple)):
        return [fs_norm(x) for x in v]
    return norm(v)


# Epoch milliseconds: a scheduled snapshot's name.
_MS = (re.compile(r"(?<![0-9])1[5-9]\d{11}(?![0-9])"), "<ms>")


class _FixedWidthClock:
    """``time`` for the volumes module: ``time()`` to the millisecond with
    a 5 after it, so that the ``created`` stamp a subvolume's JSON sidecar
    holds always prints with as many digits (its length is the sidecar's
    size, which the dentry, the quota's usage and ``info`` report)."""

    def time(self):
        return float(f"{time.time():.3f}5")

    def __getattr__(self, name):
        return getattr(time, name)


def run_fs_twin(ref, name, monkeypatch, **kw):
    """``run_twin_scenario`` with the pools' MDS records decoded, epoch
    milliseconds kept by shape and the volumes module on the fixed-width
    clock."""
    with pytest.MonkeyPatch.context() as mp:
        for root in ROOTS:
            mp.setattr(importlib.import_module(f"{root}.services.volumes"),
                       "time", _FixedWidthClock())
        mp.setattr(test_torch_rgw, "_TIME_PATTERNS",
                   [_MS, *test_torch_rgw._TIME_PATTERNS])
        return run_twin_scenario(ref, name, monkeypatch, keep=fs_norm, **kw)


def test_fs_norm_decodes_records_and_frames_only():
    from ceph_tpu_torch.msg.codec import encode

    dentry = {"ino": 5, "mtime": 1.7e9, "name": "f"}
    frames = b"".join(_FRAME.pack(len(encode(e))) + encode(e)
                      for e in (dentry, {"op": "unlink"}))
    assert fs_norm(encode(dentry)) == (
        "record", [("ino", 5), ("mtime", "<t>"), ("name", "f")])
    assert fs_norm(frames)[0] == "frames"
    assert fs_norm(b"d" + bytes(range(40)))[0] == "bytes"
    assert fs_norm(b"12345") == ("text", "12345")
    assert fs_norm(b"1792345678.25") == ("text", "<t>")
    assert fs_norm(b"\x01\x02") == norm(b"\x01\x02")
    assert fs_norm({"backtrace": encode(["a", 1])}) == [
        ("backtrace", ("record", ["a", 1]))]


CEPHFS = scenarios("test_cephfs")


@pytest.mark.parametrize("ref,name", CEPHFS)
def test_cephfs_scenario_equal_across_packages(ref, name, monkeypatch):
    run_fs_twin(ref, name, monkeypatch)
