"""The port's durable stores against the JAX package's, on the CPU.

``WalStore``, ``FileStore``, the native WAL engine, the compressor and
lockdep: every scenario of tests/test_walstore.py, test_filestore.py,
test_native_wal.py, test_compressor.py and test_lockdep.py that stays
inside the store (the cluster scenarios wait for the daemon slice) runs
once per package, each with its own types.  Then the packages against each
other: a store directory written by one mounts in the other with the same
objects, attrs and omap; the same transactions give the same WAL frame
bytes, checkpoint segments and compressed envelopes; a torn tail is cut at
the same frame; and the port's native library is built from its own
sources.
"""

import asyncio
import importlib
import os
import struct
import time

import pytest

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


class Pkg:
    """One package's store surface."""

    def __init__(self, root: str):
        self.root = root
        store = importlib.import_module(f"{root}.store")
        for name in ("WalStore", "FileStore", "Transaction", "CollectionId",
                     "GHObject"):
            setattr(self, name, getattr(store, name))
        self.native_wal = importlib.import_module(f"{root}.store.native_wal")
        self.compressor = importlib.import_module(f"{root}.common.compressor")
        self.lockdep = importlib.import_module(f"{root}.common.lockdep")
        self.crc_mod = importlib.import_module(f"{root}.common.crc32c")
        self.codec = importlib.import_module(f"{root}.msg.codec")
        self.txcodec = importlib.import_module(f"{root}.store.txcodec")
        self.CID = self.CollectionId(1, 0, shard=0)
        self.CID2 = self.CollectionId(2, 0, shard=0)
        self.OID = self.GHObject(1, "obj", shard=0)

    def oid(self, name: str, pool: int = 1, shard: int = 0):
        return self.GHObject(pool, name, shard=shard)


PKGS = {name: Pkg(name) for name in PKG_NAMES}


@pytest.fixture(params=PKG_NAMES)
def pkg(request):
    return PKGS[request.param]


def _run(coro):
    return asyncio.run(coro)


def _hard_crash(s):
    """Drop a store's WAL handles without umount (a process crash)."""
    if s._nwal is not None:
        s._nwal.close()
        s._nwal = None
    if s._wal_file is not None:
        s._wal_file.close()
        s._wal_file = None


async def _mounted(cls, path, **kw):
    s = cls(str(path), **kw)
    await s.mount()
    return s


# -- WalStore (tests/test_walstore.py) ----------------------------------------

def test_wal_replay_after_crash(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.WalStore, tmp_path)
        cid, oid = pkg.CID, pkg.OID
        await s.queue_transactions(
            pkg.Transaction().create_collection(cid)
            .write(cid, oid, 0, b"hello").setattr(cid, oid, "a", b"1")
            .omap_setkeys(cid, oid, {"k": b"v"}))
        await s.queue_transactions(
            pkg.Transaction().write(cid, oid, 5, b" world"))
        s2 = await _mounted(pkg.WalStore, tmp_path)
        assert s2.read(cid, oid) == b"hello world"
        assert s2.getattr(cid, oid, "a") == b"1"
        assert s2.omap_get(cid, oid) == {"k": b"v"}
    _run(run())


def test_clean_umount_checkpoints(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.WalStore, tmp_path)
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID).write(pkg.CID, pkg.OID, 0, b"data"))
        await s.umount()
        assert list((tmp_path / "ckpt").glob("*.seg"))
        s2 = await _mounted(pkg.WalStore, tmp_path)
        assert s2.read(pkg.CID, pkg.OID) == b"data"
    _run(run())


def test_checkpoint_then_wal_delta(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.WalStore, tmp_path, checkpoint_bytes=1)
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID).write(pkg.CID, pkg.OID, 0, b"base"))
        s.checkpoint_bytes = 1 << 30
        await s.queue_transactions(
            pkg.Transaction().write(pkg.CID, pkg.OID, 4, b"+tail"))
        if s._ckpt_task is not None:
            await s._ckpt_task
        s2 = await _mounted(pkg.WalStore, tmp_path)
        assert s2.read(pkg.CID, pkg.OID) == b"base+tail"
    _run(run())


def test_torn_tail_truncated(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.WalStore, tmp_path)
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID).write(pkg.CID, pkg.OID, 0, b"good"))
        with open(tmp_path / "wal.log", "ab") as f:
            f.write(b"\xff\xff\xff\xff\x00torn")
        s2 = await _mounted(pkg.WalStore, tmp_path)
        assert s2.read(pkg.CID, pkg.OID) == b"good"
        await s2.queue_transactions(
            pkg.Transaction().write(pkg.CID, pkg.OID, 4, b"-more"))
        s3 = await _mounted(pkg.WalStore, tmp_path)
        assert s3.read(pkg.CID, pkg.OID) == b"good-more"
    _run(run())


def test_failed_transaction_not_logged(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.WalStore, tmp_path)
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID))
        with pytest.raises(KeyError):
            await s.queue_transactions(pkg.Transaction().rmattr(
                pkg.CID, pkg.oid("ghost"), "x"))
        s2 = await _mounted(pkg.WalStore, tmp_path)
        assert not s2.exists(pkg.CID, pkg.oid("ghost"))
        assert s2.list_objects(pkg.CID) == []
    _run(run())


def test_checkpoint_rewrites_only_dirty_segments(pkg, tmp_path):
    async def run():
        cid, cid2 = pkg.CID, pkg.CID2
        oid2 = pkg.GHObject(2, "obj2", shard=0)
        s = await _mounted(pkg.WalStore, tmp_path, checkpoint_bytes=1 << 30)
        await s.queue_transactions(pkg.Transaction().create_collection(cid)
                                   .write(cid, pkg.OID, 0, b"cold data"))
        await s.queue_transactions(pkg.Transaction().create_collection(cid2)
                                   .write(cid2, oid2, 0, b"hot"))
        await s.umount()
        seg_a, seg_b = s._seg_path(cid), s._seg_path(cid2)
        assert seg_a.exists() and seg_b.exists()
        stat_a = seg_a.stat()
        s2 = await _mounted(pkg.WalStore, tmp_path, checkpoint_bytes=1)
        await s2.queue_transactions(
            pkg.Transaction().write(cid2, oid2, 0, b"hot2"))
        if s2._ckpt_task is not None:
            await s2._ckpt_task
        st_a2 = seg_a.stat()
        assert (st_a2.st_mtime_ns, st_a2.st_ino) == \
            (stat_a.st_mtime_ns, stat_a.st_ino), "clean segment rewritten"
        await s2.umount()
        s3 = await _mounted(pkg.WalStore, tmp_path)
        assert s3.read(cid, pkg.OID) == b"cold data"
        assert s3.read(cid2, oid2) == b"hot2"
        await s3.umount()
    _run(run())


def test_commit_does_not_wait_for_segment_io(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.WalStore, tmp_path, checkpoint_bytes=1)
        real_write = s._commit_segments

        def slow_write(snap, compact):
            time.sleep(0.5)
            real_write(snap, compact)

        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID).write(pkg.CID, pkg.OID, 0, b"x"))
        if s._ckpt_task is not None:
            await s._ckpt_task
        s._commit_segments = slow_write
        t0 = time.perf_counter()
        await s.queue_transactions(
            pkg.Transaction().write(pkg.CID, pkg.OID, 0, b"y"))
        await s.queue_transactions(
            pkg.Transaction().write(pkg.CID, pkg.OID, 1, b"z"))
        elapsed = time.perf_counter() - t0
        assert elapsed < 0.4, f"commit stalled {elapsed:.2f}s on IO"
        assert s._ckpt_task is not None and not s._ckpt_task.done()
        await s._ckpt_task
        await s.umount()
        s2 = await _mounted(pkg.WalStore, tmp_path)
        assert s2.read(pkg.CID, pkg.OID) == b"yz"
        await s2.umount()
    _run(run())


def test_interrupted_checkpoint_wal_old_recovers(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.WalStore, tmp_path, checkpoint_bytes=1)

        def fail_write(snap, compact):
            raise OSError("disk full")

        s._commit_segments = fail_write
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID).write(pkg.CID, pkg.OID, 0, b"AB"))
        task = s._ckpt_task
        assert task is not None
        with pytest.raises(OSError):
            await task
        assert (tmp_path / "wal.old").exists()
        s._commit_segments = lambda snap, compact: None
        await s.queue_transactions(
            pkg.Transaction().write(pkg.CID, pkg.OID, 2, b"CD"))
        _hard_crash(s)
        s2 = await _mounted(pkg.WalStore, tmp_path)
        assert s2.read(pkg.CID, pkg.OID) == b"ABCD"
        assert not (tmp_path / "wal.old").exists()
        await s2.umount()
    _run(run())


def test_legacy_checkpoint_bin_migrates(pkg, tmp_path):
    blob = pkg.codec.encode([[pkg.txcodec.enc_cid(pkg.CID), [[
        pkg.txcodec.enc_oid(pkg.OID), b"legacy!", {}, {}]]]])
    raw = b"ceph-tpu-ckpt-1\n" + struct.pack(
        "<II", len(blob), pkg.crc_mod.crc32c(0xFFFFFFFF, blob)) + blob
    (tmp_path / "checkpoint.bin").write_bytes(raw)

    async def run():
        s = await _mounted(pkg.WalStore, tmp_path)
        assert s.read(pkg.CID, pkg.OID) == b"legacy!"
        assert not (tmp_path / "checkpoint.bin").exists()
        assert s._seg_path(pkg.CID).exists()
        await s.umount()
        s2 = await _mounted(pkg.WalStore, tmp_path)
        assert s2.read(pkg.CID, pkg.OID) == b"legacy!"
        await s2.umount()
    _run(run())


def test_collection_removal_drops_segment(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.WalStore, tmp_path, checkpoint_bytes=1 << 30)
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID).write(pkg.CID, pkg.OID, 0, b"x"))
        await s.umount()
        assert s._seg_path(pkg.CID).exists()
        s2 = await _mounted(pkg.WalStore, tmp_path)
        await s2.queue_transactions(pkg.Transaction().remove(
            pkg.CID, pkg.OID).remove_collection(pkg.CID))
        await s2.umount()
        assert not s2._seg_path(pkg.CID).exists()
        s3 = await _mounted(pkg.WalStore, tmp_path)
        with pytest.raises(Exception):
            s3.read(pkg.CID, pkg.OID)
        await s3.umount()
    _run(run())


def test_manifest_roll_forward_no_clone_reapply(pkg, tmp_path):
    async def run():
        cid, oid, oidb = pkg.CID, pkg.OID, pkg.oid("objB")
        s = await _mounted(pkg.WalStore, tmp_path, checkpoint_bytes=1 << 30)
        await s.queue_transactions(pkg.Transaction().create_collection(cid)
                                   .write(cid, oid, 0, b"orig"))
        await s.queue_transactions(pkg.Transaction().clone(cid, oid, oidb))
        await s.queue_transactions(
            pkg.Transaction().write(cid, oid, 0, b"new!"))
        s._publish_manifest = lambda compact, entries: None
        s.checkpoint_bytes = 1
        await s.queue_transactions(
            pkg.Transaction().write(cid, oid, 0, b"NEW2"))
        if s._ckpt_task is not None:
            await s._ckpt_task
        assert (tmp_path / "ckpt.manifest").exists()
        assert (tmp_path / "wal.old").exists()
        _hard_crash(s)
        s2 = await _mounted(pkg.WalStore, tmp_path)
        assert s2.read(cid, oidb) == b"orig"
        assert s2.read(cid, oid) == b"NEW2"
        assert not (tmp_path / "ckpt.manifest").exists()
        assert not (tmp_path / "wal.old").exists()
        await s2.umount()
    _run(run())


def test_manifest_phase1_crash_discards_strays(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.WalStore, tmp_path, checkpoint_bytes=1 << 30)
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID).write(pkg.CID, pkg.OID, 0, b"AB"))
        real = s._write_framed

        def fail_manifest(path, blob):
            if path == s.manifest_path:
                raise OSError("crash before commit record")
            real(path, blob)

        s._write_framed = fail_manifest
        s.checkpoint_bytes = 1
        await s.queue_transactions(
            pkg.Transaction().write(pkg.CID, pkg.OID, 2, b"CD"))
        with pytest.raises(OSError):
            await s._ckpt_task
        assert list((tmp_path / "ckpt").glob("*.seg.new"))
        assert (tmp_path / "wal.old").exists()
        _hard_crash(s)
        for _ in range(2):
            s2 = await _mounted(pkg.WalStore, tmp_path)
            assert s2.read(pkg.CID, pkg.OID) == b"ABCD"
            assert not list((tmp_path / "ckpt").glob("*.seg.new"))
            await s2.umount()
    _run(run())


@pytest.mark.parametrize("checkpoint_bytes", [1, 1 << 30],
                         ids=["failed_checkpoint", "failed_flush"])
def test_umount_after_failed_segment_write_keeps_logs(pkg, tmp_path,
                                                      checkpoint_bytes):
    """A background checkpoint (every commit) or the clean-shutdown
    flush fails writing segments: umount does not raise, and the next
    mount recovers every committed transaction from the logs."""
    async def run():
        s = await _mounted(pkg.WalStore, tmp_path,
                           checkpoint_bytes=checkpoint_bytes)

        def fail(snap, compact):
            raise OSError("disk full")

        if checkpoint_bytes == 1:
            s._commit_segments = fail
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID).write(pkg.CID, pkg.OID, 0, b"keep"))
        s._commit_segments = fail
        await s.umount()
        if checkpoint_bytes == 1:
            assert (tmp_path / "wal.old").exists()
        s2 = await _mounted(pkg.WalStore, tmp_path)
        assert s2.read(pkg.CID, pkg.OID) == b"keep"
        assert not (tmp_path / "wal.old").exists()
        await s2.umount()
    _run(run())


# -- FileStore (tests/test_filestore.py) --------------------------------------

def test_filestore_op_vocabulary(pkg, tmp_path):
    async def run():
        cid, oid, oid2 = pkg.CID, pkg.OID, pkg.oid("other")
        s = await _mounted(pkg.FileStore, tmp_path)
        await s.queue_transactions(
            pkg.Transaction().create_collection(cid)
            .write(cid, oid, 0, b"hello").write(cid, oid, 5, b" world")
            .setattr(cid, oid, "a", b"1")
            .omap_setkeys(cid, oid, {"k1": b"v1", "k2": b"v2"}))
        assert s.read(cid, oid) == b"hello world"
        assert s.read(cid, oid, 6, 5) == b"world"
        assert s.getattr(cid, oid, "a") == b"1"
        assert s.omap_get(cid, oid) == {"k1": b"v1", "k2": b"v2"}
        assert s.stat(cid, oid)["size"] == 11
        await s.queue_transactions(
            pkg.Transaction().zero(cid, oid, 2, 3).truncate(cid, oid, 8)
            .rmattr(cid, oid, "a").omap_rmkeys(cid, oid, ["k1"]))
        assert s.read(cid, oid) == b"he\0\0\0 wo"
        assert s.getattrs(cid, oid) == {}
        assert s.omap_get(cid, oid) == {"k2": b"v2"}
        await s.queue_transactions(
            pkg.Transaction().write(cid, oid2, 100, b"end"))
        assert s.read(cid, oid2) == b"\0" * 100 + b"end"
        dst, moved = pkg.oid("copy"), pkg.oid("moved")
        await s.queue_transactions(pkg.Transaction().clone(cid, oid, dst))
        assert s.read(cid, dst) == s.read(cid, oid)
        await s.queue_transactions(pkg.Transaction().rename(cid, dst, moved))
        assert not s.exists(cid, dst) and s.exists(cid, moved)
        assert {o.name for o in s.list_objects(cid)} == {
            "obj", "other", "moved"}
        assert s.list_collections() == [cid]
        with pytest.raises(Exception):
            await s.queue_transactions(
                pkg.Transaction().remove_collection(cid))
        await s.umount()
    _run(run())


def test_filestore_crash_replay(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.FileStore, tmp_path)
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID).write(pkg.CID, pkg.OID, 0, b"durable"))
        await s.queue_transactions(
            pkg.Transaction().write(pkg.CID, pkg.OID, 7, b"-tail")
            .omap_setkeys(pkg.CID, pkg.OID, {"m": b"1"}))
        _hard_crash(s)
        with open(tmp_path / "wal.log", "ab") as f:
            f.write(struct.pack("<II", 9999, 1) + b"torn")
        s2 = await _mounted(pkg.FileStore, tmp_path)
        assert s2.read(pkg.CID, pkg.OID) == b"durable-tail"
        assert s2.omap_get(pkg.CID, pkg.OID) == {"m": b"1"}
        await s2.queue_transactions(
            pkg.Transaction().write(pkg.CID, pkg.OID, 12, b"!"))
        await s2.umount()
        s3 = await _mounted(pkg.FileStore, tmp_path)
        assert s3.read(pkg.CID, pkg.OID) == b"durable-tail!"
        await s3.umount()
    _run(run())


def test_filestore_wal_turnover_bounds_log(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.FileStore, tmp_path, wal_max=4096)
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID))
        for _ in range(20):
            await s.queue_transactions(pkg.Transaction().write(
                pkg.CID, pkg.OID, 0, bytes(512)))
        size = (tmp_path / "wal.log").stat().st_size
        assert size < 3 * 4096, f"wal never turned over: {size}"
        assert s.read(pkg.CID, pkg.OID) == bytes(512)
        await s.umount()
    _run(run())


def test_filestore_atomicity_validation(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.FileStore, tmp_path)
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID).write(pkg.CID, pkg.OID, 0, b"base"))
        with pytest.raises(KeyError):
            await s.queue_transactions(
                pkg.Transaction().write(pkg.CID, pkg.OID, 0, b"XXXX")
                .rmattr(pkg.CID, pkg.oid("ghost"), "a"))
        assert s.read(pkg.CID, pkg.OID) == b"base", "partial batch applied"
        await s.umount()
        s2 = await _mounted(pkg.FileStore, tmp_path)
        assert s2.read(pkg.CID, pkg.OID) == b"base"
        await s2.umount()
    _run(run())


def test_filestore_rename_crash_windows(pkg, tmp_path):
    async def run():
        cid = pkg.CID
        src, dst = pkg.oid("rsrc"), pkg.oid("rdst")
        s = await _mounted(pkg.FileStore, tmp_path)
        await s.queue_transactions(
            pkg.Transaction().create_collection(cid)
            .write(cid, src, 0, b"payload").setattr(cid, src, "a", b"v"))
        op = pkg.Transaction().rename(cid, src, dst)
        s._append(pkg.codec.encode([pkg.txcodec.encode_tx(op)]))
        os.replace(s._dpath(cid, src), s._dpath(cid, dst))
        _hard_crash(s)
        s2 = await _mounted(pkg.FileStore, tmp_path)
        assert not s2.exists(cid, src) and s2.exists(cid, dst)
        assert s2.read(cid, dst) == b"payload"
        assert s2.getattr(cid, dst, "a") == b"v"
        assert {o.name for o in s2.list_objects(cid)} == {"rdst"}
        await s2.umount()
    _run(run())


def test_filestore_rejects_op_on_removed_collection(pkg, tmp_path):
    async def run():
        s = await _mounted(pkg.FileStore, tmp_path)
        await s.queue_transactions(pkg.Transaction().create_collection(
            pkg.CID))
        with pytest.raises(Exception):
            await s.queue_transactions(pkg.Transaction().remove_collection(
                pkg.CID).touch(pkg.CID, pkg.OID))
        assert s.list_collections() == [pkg.CID]
        await s.umount()
    _run(run())


def test_filestore_clone_frame_marker_lag(pkg, tmp_path):
    async def run():
        cid, head, snap = pkg.CID, pkg.oid("head"), pkg.oid("snap")
        s = await _mounted(pkg.FileStore, tmp_path)
        await s.queue_transactions(pkg.Transaction().create_collection(cid)
                                   .write(cid, head, 0, b"OLD-DATA"))
        marker = s.applied_path.read_bytes()
        await s.queue_transactions(pkg.Transaction().clone(cid, head, snap)
                                   .write(cid, head, 0, b"NEW-DATA"))
        s.applied_path.write_bytes(marker)
        _hard_crash(s)
        s2 = await _mounted(pkg.FileStore, tmp_path)
        assert s2.read(cid, head) == b"NEW-DATA"
        assert s2.read(cid, snap) == b"OLD-DATA"
        await s2.umount()
    _run(run())


# -- the native WAL engine (tests/test_native_wal.py) -------------------------

NATIVE_CID = (1, 0)


async def _fill(pkg, store, n=20, prefix="o"):
    cid = pkg.CollectionId(*NATIVE_CID)
    await store.mount()
    await store.queue_transactions(pkg.Transaction().create_collection(cid))
    for i in range(n):
        oid = pkg.GHObject(1, f"{prefix}{i}")
        await store.queue_transactions(
            pkg.Transaction().write(cid, oid, 0, bytes([i]) * (100 + i))
            .setattr(cid, oid, "v", str(i).encode()))


def _check(pkg, store, n=20, prefix="o"):
    cid = pkg.CollectionId(*NATIVE_CID)
    for i in range(n):
        oid = pkg.GHObject(1, f"{prefix}{i}")
        assert store.read(cid, oid) == bytes([i]) * (100 + i)
        assert store.getattr(cid, oid, "v") == str(i).encode()


def test_native_restart_durability(pkg, tmp_path):
    async def run():
        s1 = pkg.WalStore(str(tmp_path), native=True)
        assert s1.native
        await _fill(pkg, s1)
        _hard_crash(s1)
        s2 = await _mounted(pkg.WalStore, tmp_path, native=True)
        _check(pkg, s2)
        await s2.umount()
        assert list((tmp_path / "ckpt").glob("*.seg"))
        s3 = await _mounted(pkg.WalStore, tmp_path, native=True)
        _check(pkg, s3)
        await s3.umount()
    _run(run())


@pytest.mark.parametrize("writer,reader", [(True, False), (False, True)],
                         ids=["native_to_python", "python_to_native"])
def test_cross_tier_interop(pkg, tmp_path, writer, reader):
    async def run():
        s1 = pkg.WalStore(str(tmp_path), native=writer)
        await _fill(pkg, s1, 10)
        await s1.umount()
        s1b = await _mounted(pkg.WalStore, tmp_path, native=writer)
        await s1b.queue_transactions(pkg.Transaction().write(
            pkg.CollectionId(*NATIVE_CID), pkg.GHObject(1, "extra"), 0,
            b"tail-data"))
        _hard_crash(s1b)
        s2 = await _mounted(pkg.WalStore, tmp_path, native=reader)
        _check(pkg, s2, 10)
        assert s2.read(pkg.CollectionId(*NATIVE_CID),
                       pkg.GHObject(1, "extra")) == b"tail-data"
        await s2.umount()
    _run(run())


def test_native_torn_tail_truncated(pkg, tmp_path):
    async def run():
        s1 = pkg.WalStore(str(tmp_path), native=True)
        await _fill(pkg, s1, 5)
        _hard_crash(s1)
        wal = tmp_path / "wal.log"
        with open(wal, "ab") as f:
            f.write(b"\x40\x00\x00\x00\x99\x99\x99\x99partial")
        s2 = await _mounted(pkg.WalStore, tmp_path, native=True)
        _check(pkg, s2, 5)
        await s2.umount()
        assert pkg.native_wal.replay(str(wal)) == []
        raw_dir = tmp_path / "raw"
        raw_dir.mkdir()
        s3 = pkg.WalStore(str(raw_dir), native=True)
        await _fill(pkg, s3, 3, prefix="z")
        _hard_crash(s3)
        wal3 = raw_dir / "wal.log"
        before = pkg.native_wal.replay(str(wal3))
        size = wal3.stat().st_size
        with open(wal3, "ab") as f:
            f.write(b"\xff\xff\xff\xffgarbage")
        assert pkg.native_wal.replay(str(wal3)) == before
        assert wal3.stat().st_size == size          # truncated in place
    _run(run())


def test_native_replay_truncates_at_poison_record(pkg, tmp_path):
    async def run():
        s1 = pkg.WalStore(str(tmp_path), native=True)
        await _fill(pkg, s1, 3)
        _hard_crash(s1)
        wal = tmp_path / "wal.log"
        good_size = wal.stat().st_size
        nw = pkg.native_wal.NativeWal(str(wal), sync=False)
        nw.append(b"\x00garbage-not-codec")
        nw.append(b"\x00also-garbage")
        nw.close()
        assert wal.stat().st_size > good_size
        s2 = await _mounted(pkg.WalStore, tmp_path, native=True)
        _check(pkg, s2, 3)
        assert wal.stat().st_size == good_size
        cid = pkg.CollectionId(*NATIVE_CID)
        await s2.queue_transactions(pkg.Transaction().write(
            cid, pkg.GHObject(1, "post"), 0, b"after-poison"))
        _hard_crash(s2)
        s3 = await _mounted(pkg.WalStore, tmp_path, native=True)
        assert s3.read(cid, pkg.GHObject(1, "post")) == b"after-poison"
        await s3.umount()
    _run(run())


def test_native_checkpoint_rejects_corruption(pkg, tmp_path):
    nw = pkg.native_wal
    blob = b"payload-blob" * 100
    path = str(tmp_path / "ck.bin")
    nw.write_checkpoint(path, blob)
    assert nw.read_checkpoint(path) == blob
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    assert nw.read_checkpoint(path) is None
    assert nw.read_checkpoint(str(tmp_path / "absent")) is None


# -- the compressor (tests/test_compressor.py) --------------------------------

def _payload(i):
    return (f"object {i} ".encode() * 500)[:4096]


def test_registry_round_trips_every_algorithm(pkg):
    comp = pkg.compressor
    body = b"the quick brown fox " * 999
    assert comp.list_compressors() == ["bz2", "lzma", "zlib", "zstd"]
    for alg in comp.list_compressors():
        c = comp.get_compressor(alg)
        packed = c.compress(body)
        assert packed != body and len(packed) < len(body)
        assert c.decompress(packed) == body
    with pytest.raises(ValueError):
        comp.get_compressor("snappy")


def test_envelope_integrity_and_passthrough(pkg):
    comp = pkg.compressor
    body = b"payload " * 4096
    for alg in comp.list_compressors():
        stored = comp.envelope_pack(body, alg)
        assert len(stored) < len(body)
        assert comp.envelope_unpack(stored) == body
        broken = bytearray(stored)
        broken[-3] ^= 0x40
        with pytest.raises(ValueError):
            comp.envelope_unpack(bytes(broken))
    assert comp.envelope_unpack(comp.envelope_pack(body, None)) == body
    tricky = b"\x01CZ1 pretending to be an envelope"
    assert comp.envelope_unpack(comp.envelope_pack(tricky, None)) == tricky


def test_walstore_inline_compression_round_trip(pkg, tmp_path):
    async def run():
        cid = pkg.CollectionId(7, 0)
        store = await _mounted(pkg.WalStore, tmp_path / "s",
                               compression="zstd")
        await store.queue_transactions(pkg.Transaction().create_collection(
            cid))
        for i in range(8):
            oid = pkg.GHObject(7, f"o{i}")
            await store.queue_transactions(
                pkg.Transaction().write(cid, oid, 0, _payload(i))
                .setattr(cid, oid, "k", b"v" * 64))
        raw = (tmp_path / "s" / "wal.log").read_bytes()
        assert b"\x01CZ1" in raw and _payload(0)[:64] not in raw
        await store.umount()
        store2 = await _mounted(pkg.WalStore, tmp_path / "s",
                                compression="zstd")
        for i in range(8):
            oid = pkg.GHObject(7, f"o{i}")
            assert store2.read(cid, oid, 0, 1 << 16) == _payload(i)
            assert store2.getattr(cid, oid, "k") == b"v" * 64
        await store2.umount()
    _run(run())


def test_walstore_crash_replay_compressed(pkg, tmp_path):
    async def run():
        cid, oid = pkg.CollectionId(7, 0), pkg.GHObject(7, "obj")
        store = await _mounted(pkg.WalStore, tmp_path / "s",
                               compression="zlib")
        await store.queue_transactions(pkg.Transaction().create_collection(
            cid))
        await store.queue_transactions(
            pkg.Transaction().write(cid, oid, 0, b"A" * 4096))
        await store.queue_transactions(
            pkg.Transaction().write(cid, oid, 4096, b"B" * 100))
        _hard_crash(store)
        store2 = await _mounted(pkg.WalStore, tmp_path / "s",
                                compression="zlib")
        assert store2.read(cid, oid, 0, 1 << 16) == b"A" * 4096 + b"B" * 100
        await store2.umount()
    _run(run())


def test_walstore_algorithm_migration(pkg, tmp_path):
    async def run():
        cid, oid, x = (pkg.CollectionId(7, 0), pkg.GHObject(7, "obj"),
                       pkg.GHObject(7, "x"))
        s1 = await _mounted(pkg.WalStore, tmp_path / "s")
        await s1.queue_transactions(pkg.Transaction().create_collection(cid))
        await s1.queue_transactions(
            pkg.Transaction().write(cid, oid, 0, b"plain " * 100))
        await s1.umount()
        s2 = await _mounted(pkg.WalStore, tmp_path / "s", compression="lzma")
        assert s2.read(cid, oid, 0, 1 << 16) == b"plain " * 100
        await s2.queue_transactions(
            pkg.Transaction().write(cid, x, 0, b"new " * 64))
        await s2.umount()
        s3 = await _mounted(pkg.WalStore, tmp_path / "s")
        assert s3.read(cid, oid, 0, 1 << 16) == b"plain " * 100
        assert s3.read(cid, x, 0, 1 << 16) == b"new " * 64
        await s3.umount()
        with pytest.raises(ValueError):
            pkg.WalStore(str(tmp_path / "t"), compression="snappy")
    _run(run())


def test_filestore_wal_compression(pkg, tmp_path):
    async def run():
        cid, oid = pkg.CollectionId(7, 0), pkg.GHObject(7, "obj")
        store = await _mounted(pkg.FileStore, tmp_path / "f",
                               compression="zstd")
        await store.queue_transactions(pkg.Transaction().create_collection(
            cid))
        await store.queue_transactions(
            pkg.Transaction().write(cid, oid, 0, _payload(1)))
        assert store.read(cid, oid, 0, 1 << 16) == _payload(1)
        await store.umount()
        store2 = await _mounted(pkg.FileStore, tmp_path / "f",
                                compression="zstd")
        assert store2.read(cid, oid, 0, 1 << 16) == _payload(1)
        await store2.umount()
    _run(run())


# -- lockdep (tests/test_lockdep.py) ------------------------------------------

@pytest.fixture
def lockdep(pkg):
    ld = pkg.lockdep
    ld.lockdep_enable(reset=True)
    yield ld
    ld.lockdep_reset()


def test_consistent_order_is_clean(lockdep):
    async def run():
        a, b = lockdep.DLock("A"), lockdep.DLock("B")
        for _ in range(3):
            async with a:
                async with b:
                    pass
        assert lockdep.lockdep_violations() == []
    _run(run())


def test_inversion_detected_without_deadlock(lockdep):
    async def run():
        a, b = lockdep.DLock("A"), lockdep.DLock("B")
        async with a:
            async with b:
                pass
        with pytest.raises(lockdep.LockOrderError) as e:
            async with b:
                async with a:
                    pass
        assert "A" in str(e.value) and "B" in str(e.value)
        assert lockdep.lockdep_violations()
    _run(run())


def test_transitive_cycle_detected(lockdep):
    async def run():
        a, b, c = (lockdep.DLock(n) for n in "ABC")
        async with a:
            async with b:
                pass
        async with b:
            async with c:
                pass
        with pytest.raises(lockdep.LockOrderError):
            async with c:
                async with a:
                    pass
    _run(run())


def test_same_class_nesting_not_flagged(lockdep):
    async def run():
        l1, l2 = lockdep.DLock("obj"), lockdep.DLock("obj")
        async with l1:
            async with l2:
                pass
        assert lockdep.lockdep_violations() == []
    _run(run())


def test_separate_tasks_do_not_leak_held_state(lockdep):
    async def run():
        a, b = lockdep.DLock("A"), lockdep.DLock("B")

        async def hold(lock):
            async with lock:
                await asyncio.sleep(0.01)

        await asyncio.gather(hold(a), hold(b))
        assert lockdep.lockdep_violations() == []
        async with b:
            async with a:
                pass
        with pytest.raises(lockdep.LockOrderError):
            async with a:
                async with b:
                    pass
    _run(run())


# -- across the packages ------------------------------------------------------

WRITER_READER = [("ceph_tpu", "ceph_tpu_torch"), ("ceph_tpu_torch", "ceph_tpu")]
WR_IDS = ["jax_to_torch", "torch_to_jax"]


async def _populate(pkg, store, crash: bool):
    """Two collections of objects with data, attrs and omap, a clone and a
    truncate; the last commits stay in the WAL when ``crash``."""
    a, b = pkg.CID, pkg.CID2
    await store.queue_transactions(
        pkg.Transaction().create_collection(a).create_collection(b))
    for i in range(6):
        oid = pkg.oid(f"o{i}")
        await store.queue_transactions(
            pkg.Transaction().write(a, oid, 0, bytes([i]) * (300 + 7 * i))
            .setattr(a, oid, "v", str(i).encode())
            .omap_setkeys(a, oid, {f"k{i}": b"x" * i, "z": b"last"}))
    await store.queue_transactions(
        pkg.Transaction().clone(a, pkg.oid("o1"), pkg.oid("c1"))
        .truncate(a, pkg.oid("o2"), 100)
        .write(b, pkg.GHObject(2, "hot", shard=0), 0, b"hot" * 50))
    if crash:
        _hard_crash(store)
    else:
        await store.umount()


def _image(pkg, store) -> dict:
    out = {}
    for cid in store.list_collections():
        for oid in store.list_objects(cid):
            out[str(cid), str(oid)] = (store.read(cid, oid),
                                       store.getattrs(cid, oid),
                                       store.omap_get(cid, oid))
    return out


@pytest.mark.parametrize("crash", [False, True], ids=["umount", "crash"])
@pytest.mark.parametrize("kind", ["WalStore", "FileStore"])
@pytest.mark.parametrize("writer,reader", WRITER_READER, ids=WR_IDS)
def test_store_directory_crosses_packages(tmp_path, writer, reader, kind,
                                          crash):
    """A directory written by one package (checkpoint segments after a
    clean umount, or a WAL alone after a crash) mounts in the other with
    the same objects, attrs and omap."""
    w, r = PKGS[writer], PKGS[reader]

    async def run():
        s = await _mounted(getattr(w, kind), tmp_path / "d")
        await _populate(w, s, crash)
        s_w = await _mounted(getattr(w, kind), tmp_path / "d")
        want = _image(w, s_w)
        _hard_crash(s_w)
        s_r = await _mounted(getattr(r, kind), tmp_path / "d")
        got = _image(r, s_r)
        await s_r.umount()
        return want, got

    want, got = _run(run())
    assert len(want) == 8 and got == want


@pytest.mark.parametrize("compression", [None, "zlib", "bz2", "lzma", "zstd"])
@pytest.mark.parametrize("kind", ["WalStore", "FileStore"])
def test_same_transactions_same_files(tmp_path, kind, compression):
    """The same transactions give byte-identical WAL frames in both
    packages and, after a clean umount, identical checkpoint segments
    (WalStore) or data files and sidecars (FileStore)."""
    trees = {}
    for name in PKG_NAMES:
        p = PKGS[name]
        root = tmp_path / name

        async def run():
            s = await _mounted(getattr(p, kind), root,
                               compression=compression)
            await _populate(p, s, crash=True)
            wal = (root / "wal.log").read_bytes()
            s2 = await _mounted(getattr(p, kind), root,
                                compression=compression)
            await s2.umount()
            return wal

        wal = _run(run())
        files = {str(f.relative_to(root)): f.read_bytes()
                 for f in sorted(root.rglob("*")) if f.is_file()}
        trees[name] = (wal, files)
    (j_wal, j_files), (t_wal, t_files) = trees.values()
    assert len(j_wal) > 1000 and t_wal == j_wal
    assert t_files.keys() == j_files.keys() and len(j_files) >= 2
    assert t_files == j_files


@pytest.mark.parametrize("alg", ["zlib", "bz2", "lzma", "zstd", None])
def test_envelopes_byte_identical(alg):
    body = b"".join(f"object {i} ".encode() * (i + 1) for i in range(200))
    j, t = PKGS["ceph_tpu"].compressor, PKGS["ceph_tpu_torch"].compressor
    packed = t.envelope_pack(body, alg)
    assert packed == j.envelope_pack(body, alg)
    assert j.envelope_unpack(packed) == t.envelope_unpack(packed) == body


@pytest.mark.parametrize("tail", [b"\xff\xff\xff\xff\x00torn",
                                  b"\x40\x00\x00\x00\x99\x99\x99\x99partial",
                                  b"\x05\x00"],
                         ids=["huge_length", "bad_crc", "half_header"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_torn_tail_cut_at_the_same_frame(tmp_path, tail, native):
    """One WAL written, a torn frame appended, copied twice: each package
    cuts its copy back to the same length and replays the same records."""
    src = PKGS["ceph_tpu"]

    async def write():
        s = await _mounted(src.WalStore, tmp_path / "w", native=native)
        await _populate(src, s, crash=True)

    _run(write())
    with open(tmp_path / "w" / "wal.log", "ab") as f:
        f.write(tail)
    raw = (tmp_path / "w" / "wal.log").read_bytes()
    sizes, images = {}, {}
    for name in PKG_NAMES:
        p = PKGS[name]
        d = tmp_path / name
        d.mkdir()
        (d / "wal.log").write_bytes(raw)

        async def mount():
            s = await _mounted(p.WalStore, d, native=native)
            img = _image(p, s)
            _hard_crash(s)
            return img

        images[name] = _run(mount())
        sizes[name] = (d / "wal.log").stat().st_size
    assert sizes["ceph_tpu"] == sizes["ceph_tpu_torch"] == len(raw) - len(tail)
    assert images["ceph_tpu"] == images["ceph_tpu_torch"]
    assert len(images["ceph_tpu"]) == 8


def test_native_wal_is_built_from_the_ports_sources():
    t = PKGS["ceph_tpu_torch"]
    crc_mod = t.crc_mod
    assert t.native_wal.available()
    lib = crc_mod._load_native()
    path = crc_mod.library_path()
    assert lib._name == str(path) and path.exists()
    assert path.parent == crc_mod.BUILD_DIR
    port = crc_mod.PACKAGE_DIR
    assert port.name == "ceph_tpu_torch"
    assert crc_mod.SOURCE == port / "native" / "crc32c.c"
    assert crc_mod.WAL_SOURCE == port / "native" / "wal_engine.cc"
    assert crc_mod.WAL_SOURCE.read_bytes() == (
        port.parent / "ceph_tpu" / "native" / "wal_engine.cc").read_bytes()
    assert hasattr(lib, "we_open") and hasattr(lib, "ceph_tpu_crc32c")
    assert t.native_wal._lib() is lib
