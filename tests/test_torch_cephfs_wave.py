"""Wave (l) of chip_smoke.py on the CPU, on both packages.

``chip_smoke.cephfs_wave`` runs each package's dev cluster (one monitor
and three OSD daemons) with a CephFS whose metadata pool is replicated and
whose data pool is erasure-coded: seeded files written under their write
caps and read back exact with ``readdir`` and ``stat``; write-through
overwrites at odd offsets (the EC backend's read-modify-write); every file
read again with an OSD lost; the active MDS shut down and its standby
taking rank 0, the files read through a new mount and one more written;
a subvolume made and given a quota through the CLI's argv parser, filled
and a write past it refused with EDQUOT; last the MDSs stopped, the
journal inspected by ``cephfs-journal-tool``, one directory's dentries
removed and put back by ``cephfs-data-scan scan``/``inject`` from the
backtraces in the EC pool, every one of its files exact through a new
MDS.  The wave raises on any failure; here its records are also held
equal across the packages where they do not depend on timing.

Cut from the card's wave: 3 OSDs and a k=2 m=1 profile (the card: 12,
8+4), 64 KiB blocks (the card: 4 MiB), 8 files of 160 KiB over 4
directories (the card: 16 of 16 MiB), 4 overwrites of 8 KiB (the card: 8
of 64 KiB), 2 subvolume files of 64 KiB (the card: 4 of 4 MiB), and the
port's daemons run their codecs on ``device="cpu"``, where no kernel
launches.  Tolerance 0.
"""

import asyncio
import functools
import importlib
import tempfile
from types import SimpleNamespace

import pytest

import chip_smoke as CS

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")
BLOCK, FILES, SIZE, PATCH = 64 << 10, 8, 160 << 10, 8 << 10
OVERWRITES, VOLUME_FILES, VOLUME_BYTES = 4, 2, 64 << 10


def _wave_ns(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    vstart = mod("vstart")
    device = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    launches = (lambda: dict(mod("ec.cuda_kernels").LAUNCHES)) \
        if root == "ceph_tpu_torch" else dict
    return SimpleNamespace(
        DevCluster=functools.partial(vstart.DevCluster, **device),
        SCALE_TEST_OVERRIDES=vstart.SCALE_TEST_OVERRIDES,
        reset_local_namespace=mod("msg").reset_local_namespace,
        compiler=mod("placement.compiler"), cli=mod("cli"),
        fs=mod("client.fs"), mds=mod("mds.daemon"),
        cephfs_journal_tool=mod("cephfs_journal_tool"),
        cephfs_data_scan=mod("cephfs_data_scan"), launches=launches,
        sync=lambda: None)


@functools.lru_cache(maxsize=None)
def _wave(root):
    lines = []
    with tempfile.TemporaryDirectory() as d:
        out = asyncio.run(CS.cephfs_wave(
            _wave_ns(root), d, n_osds=3, ec_k=2, ec_m=1, files=FILES,
            file_bytes=SIZE, overwrites=OVERWRITES, overwrite_bytes=PATCH,
            volume_files=VOLUME_FILES, volume_bytes=VOLUME_BYTES,
            block_size=BLOCK, victim=1, need=(), note=lines.append))
    return out, lines


@pytest.fixture(params=PKG_NAMES)
def wave(request):
    return _wave(request.param)


STEPS = ["boot", "write", "overwrite", "degraded", "failover", "volumes",
         "recover"]


def test_wave_notes_a_cephfs_line_per_step(wave):
    out, lines = wave
    assert [ln.split(" ", 1)[0] for ln in lines] == \
        ["[cephfs]"] * len(STEPS)
    assert list(out["steps"]) == STEPS


def test_filesystem_boots_over_the_erasure_coded_data_pool(wave):
    boot = wave[0]["steps"]["boot"]
    assert (boot["active"], boot["standby"]) == ("a", ["b"])
    assert boot["data_pool"] == "cephfs_data"
    assert boot["block_size"] == BLOCK


def test_files_exact_through_overwrite_loss_and_failover(wave):
    steps = wave[0]["steps"]
    assert steps["write"]["bytes"] == FILES * SIZE
    assert steps["write"]["data_objects"] == FILES * -(-SIZE // BLOCK)
    assert steps["write"]["tree"] == ["d0", "d1", "d2", "d3", "tree"]
    assert steps["overwrite"]["bytes"] == OVERWRITES * PATCH
    assert all(off % 2 for off in steps["overwrite"]["offsets"])
    assert steps["degraded"]["bytes"] == FILES * SIZE
    assert steps["failover"]["bytes"] == (FILES + 1) * SIZE
    assert steps["failover"]["active"] == "b"
    assert "a" in steps["failover"]["down"]


def test_subvolume_quota_refuses_the_write_past_it(wave):
    vol = wave[0]["steps"]["volumes"]
    assert vol["subvolumes"] == ["vol"]
    assert vol["path"] == "/volumes/_nogroup/vol"
    assert vol["refused"] == -122           # EDQUOT
    assert vol["quota"]["max_bytes"] == VOLUME_FILES * VOLUME_BYTES + 4096
    assert vol["quota"]["usage_bytes"] >= VOLUME_FILES * VOLUME_BYTES


def test_data_scan_puts_the_lost_directory_back(wave):
    """The wave removes the second directory's dentries: its seeded files
    (every ``CEPHFS_DIRS``-th, from the second on) and the file written
    after the failover."""
    rec = wave[0]["steps"]["recover"]
    files = [f"f{i:02d}" for i in range(1, FILES, CS.CEPHFS_DIRS)]
    assert rec["lost"] == [*files, "late"]
    assert rec["relinked"] == rec["back"] == rec["lost"]
    assert rec["lost_found"] == []
    assert rec["journal"]["overall"] == "OK"
    assert rec["bytes"] == (len(files) + 1) * SIZE


def test_timing_free_records_equal_across_packages():
    def free(out):
        s = out["steps"]
        keep = {"boot": ("active", "standby", "block_size", "data_pool"),
                "write": ("bytes", "files", "tree", "data_objects"),
                "overwrite": ("bytes", "offsets", "read_back"),
                "degraded": ("bytes", "victim"),
                "failover": ("bytes", "active", "down"),
                "volumes": ("bytes", "path", "subvolumes", "refused"),
                "recover": ("bytes", "journal", "lost", "scanned",
                            "relinked", "lost_found", "back")}
        out = {step: {k: s[step][k] for k in keys}
               for step, keys in keep.items()}
        # the subvolume's usage counts its JSON sidecar, whose creation
        # stamp prints as many digits as the clock gives
        out["volumes"]["max_bytes"] = s["volumes"]["quota"]["max_bytes"]
        return out

    assert free(_wave("ceph_tpu_torch")[0]) == free(_wave("ceph_tpu")[0])
