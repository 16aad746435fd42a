"""Wave (k) of chip_smoke.py on the CPU, on both packages.

``chip_smoke.block_wave`` runs each package's dev cluster (one monitor and
three OSD daemons on durable stores): its ``ceph``/``rados`` CLI, through
the argv parser, sets an erasure-code profile, creates the erasure-coded
pool and puts and gets seeded files, every one exact; an OSD is lost and
every file got again exactly, the CLI's ``status`` and ``osd df``; the rbd
tool imports an image, snapshots, protects and clones it, a write into the
clone through ``RBD``, both images exported exactly, ``rbd bench``, a group
snapshot, a journaled image mirrored into a second pool and read back;
last a stopped OSD's store listed by the objectstore tool (exactly the
erasure-coded shards the map places on it), ``osdmaptool --test-map-pgs``
on the mon's map and the dencoder's round trip of it.  The wave raises on
any failure; here its records are also held equal across the packages
where they do not depend on timing.

Cut from the card's wave: 3 OSDs and a k=2 m=1 profile (the card: 12,
8+4), 4 files of 64 KiB (the card: 16 of 4 MiB), a 1 MiB image of 64 KiB
objects with a 128 KiB clone write (the card: 64 MiB of 4 MiB objects,
16 MiB), a 256 KiB bench in 64 KiB writes and a 256 KiB mirrored image
(the card: 64 MiB in 4 MiB writes, 16 MiB), and the port's daemons run
their codecs on ``device="cpu"``, where no kernel launches.  Tolerance 0.
"""

import asyncio
import functools
import importlib
import tempfile
from types import SimpleNamespace

import pytest

import chip_smoke as CS

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")
FILES, SIZE, IMAGE, PATCH = 4, 64 << 10, 1 << 20, 128 << 10
BENCH, MIRROR = 256 << 10, 256 << 10


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
        rbd_tool=mod("rbd_tool"), objectstore_tool=mod("objectstore_tool"),
        osdmaptool=mod("tools.osdmaptool"), dencoder=mod("dencoder"),
        codec=mod("msg.codec"), rbd=mod("services.rbd"),
        rbd_group=mod("services.rbd_group"),
        rbd_mirror=mod("services.rbd_mirror"),
        object_to_ps=mod("osd.pg").object_to_ps, launches=launches,
        sync=lambda: None)


@functools.lru_cache(maxsize=None)
def _wave(root):
    lines = []
    with tempfile.TemporaryDirectory() as d:
        out = asyncio.run(CS.block_wave(
            _wave_ns(root), d, n_osds=3, ec_k=2, ec_m=1, files=FILES,
            file_bytes=SIZE, image_bytes=IMAGE, clone_write=PATCH,
            bench_bytes=BENCH, bench_io=64 << 10, mirror_bytes=MIRROR,
            order=16, victim=1, need=(), note=lines.append))
    return out, lines


@pytest.fixture(params=PKG_NAMES)
def wave(request):
    return _wave(request.param)


STEPS = ["boot", "ec-cli", "degraded-cli", "block", "offline"]


def test_wave_notes_a_block_line_per_step(wave):
    out, lines = wave
    assert [ln.split(" ", 1)[0] for ln in lines] == \
        ["[block]"] * len(STEPS)
    assert list(out["steps"]) == STEPS


def test_cli_files_are_exact_before_and_after_the_osd_loss(wave):
    steps = wave[0]["steps"]
    assert steps["ec-cli"]["bytes"] == FILES * SIZE
    assert steps["degraded-cli"]["bytes"] == FILES * SIZE
    assert steps["ec-cli"]["profile"] == {"plugin": "jax_rs", "k": "2",
                                          "m": "1"}
    assert steps["degraded-cli"]["df"]["nodes"] == 3


def test_block_images_round_trip(wave):
    block = wave[0]["steps"]["block"]
    assert block["imported"] == IMAGE
    assert block["exported"] == {"img": IMAGE, "child": IMAGE}
    assert block["bench"]["ops"] == BENCH // (64 << 10)
    assert block["group_snaps"] == ["gsnap"]
    assert block["mirror_shipped"] >= MIRROR
    assert block["kernel_launches"] == {}


def test_offline_tools_see_the_stopped_osds_shards(wave):
    off = wave[0]["steps"]["offline"]
    assert off["shards_listed"] > 0 and off["pgs_mapped"] == 8


def test_timing_free_records_equal_across_packages():
    def free(out):
        s = out["steps"]
        return {"boot": {k: s["boot"][k] for k in (
                    "mons", "osds", "stores")},
                "bytes": {k: s[k]["bytes"] for k in STEPS},
                "profile": s["ec-cli"]["profile"],
                "block": {k: s["block"][k] for k in (
                    "imported", "exported", "group_snaps",
                    "mirror_shipped")},
                "bench_ops": s["block"]["bench"]["ops"],
                "offline": {k: s["offline"][k] for k in (
                    "shards_listed", "map_epoch", "pgs_mapped",
                    "osd_pg_count", "dencoder_bytes")}}

    assert free(_wave("ceph_tpu_torch")[0]) == free(_wave("ceph_tpu")[0])
