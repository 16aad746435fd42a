"""Wave (j) of chip_smoke.py on the CPU, on both packages.

``chip_smoke.multisite_wave`` runs each package's realm of two zones (one
monitor and three OSD daemons each, MemStores, the resident shard cache,
and a gateway), each zone's STANDARD class pointed at an erasure-coded
data pool through the package's own ``rgw_admin``: signed PUTs into zone
a, the sync agent catching zone b up (every object read back exactly from
b over HTTP, user metadata included, and ``rgw_admin sync status``), the
Swift front end's TempAuth handshake and an SLO manifest over segments,
the file view's mkdir, writes, readdir, rename and reads, zone b caught up
again and read back, one of b's OSDs lost and every object read again
exactly, then the zone-loss drill with the offline mon-store rebuild.  The
wave raises on any failure; here its records are also held equal across
the packages where they do not depend on timing.

Cut from the card's wave: 3 OSDs a zone and a k=2 m=1 profile (the card:
12, 8+4), 6 objects of 64 KiB (the card: 32 of 4 MiB), 3 Swift segments
and 2 files of 64 KiB (the card: 8 and 4 of 4 MiB), and the port's
daemons run their codecs on ``device="cpu"``, where no kernel launches.
Tolerance 0.
"""

import asyncio
import functools
import importlib
import tempfile
from types import SimpleNamespace

import pytest

import chip_smoke as CS

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")
OBJECTS, SEGS, FILES, SIZE = 6, 3, 2, 64 << 10


def _wave_ns(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    vstart, chaos = mod("vstart"), mod("testing.chaos")
    device = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    launches = (lambda: dict(mod("ec.cuda_kernels").LAUNCHES)) \
        if root == "ceph_tpu_torch" else dict
    return SimpleNamespace(
        MultisiteRealm=functools.partial(vstart.MultisiteRealm, **device),
        SCALE_TEST_OVERRIDES=vstart.SCALE_TEST_OVERRIDES,
        reset_local_namespace=mod("msg").reset_local_namespace,
        compiler=mod("placement.compiler"), rgw_admin=mod("rgw_admin"),
        rgw_http=mod("services.rgw_http"), swift=mod("services.swift"),
        rgw_file=mod("services.rgw_file"),
        zone_loss_dr_drill=functools.partial(chaos.run_zone_loss_dr_drill,
                                             **device),
        launches=launches, sync=lambda: None)


@functools.lru_cache(maxsize=None)
def _wave(root):
    lines = []
    with tempfile.TemporaryDirectory() as d:
        out = asyncio.run(CS.multisite_wave(
            _wave_ns(root), d, n_osds=3, ec_k=2, ec_m=1, objects=OBJECTS,
            object_bytes=SIZE, swift_objects=SEGS, files=FILES, victim=1,
            need=(), note=lines.append))
    return out, lines


@pytest.fixture(params=PKG_NAMES)
def wave(request):
    return _wave(request.param)


STEPS = ["boot", "put-a", "sync", "swift+file", "degraded", "dr"]


def test_wave_notes_a_multisite_line_per_step(wave):
    out, lines = wave
    assert [ln.split(" ", 1)[0] for ln in lines] == \
        ["[multisite]"] * len(STEPS)
    assert list(out["steps"]) == STEPS


def test_every_zone_stores_bodies_in_its_ec_pool(wave):
    boot = wave[0]["steps"]["boot"]
    for zone in ("a", "b"):
        p = boot["placements"][zone]
        assert (p["pool"], p["pg_num"], p["type"], p["classes"]) == \
            (f"{zone}.rgw.data", 8, "erasure", ["COLD"])
    steps = wave[0]["steps"]
    assert steps["put-a"]["data_rados_objects"] >= OBJECTS
    assert steps["sync"]["data_rados_objects_b"] >= OBJECTS


def test_reads_from_b_are_exact_before_and_after_the_osd_loss(wave):
    steps = wave[0]["steps"]
    assert steps["sync"]["read_bytes"] == OBJECTS * SIZE
    # an object PUT while the agent's full sync is copying lands past its
    # snapshot and is replayed once more by the incremental pass (the
    # reference's design, services/rgw_sync.py _full_sync): at least one
    # put per object, each one a write to b's own datalog
    status = steps["sync"]["sync_status"]
    assert steps["sync"]["sync_put_ops"] >= OBJECTS
    assert status["source_positions"]["geo"]["0"] == \
        steps["sync"]["sync_put_ops"]
    assert status["sync_markers"] == {"geo": {"0": OBJECTS}}
    total = (OBJECTS + 2 * SEGS + FILES) * SIZE     # the SLO's body on b
    assert steps["swift+file"]["read_bytes"] == total
    assert steps["degraded"]["bytes"] == total
    assert steps["swift+file"]["slo_bytes"] == SEGS * SIZE


def test_dr_drill_rpo_equals_its_ledger(wave):
    dr = wave[0]["steps"]["dr"]
    assert dr["rpo"] == dr["ledger"] and dr["rpo"]["entries"] > 0
    assert dr["converged"] and dr["dr_rebuild"]
    assert dr["conflict_winner"] == "b"


def test_timing_free_records_equal_across_packages():
    def free(out):
        s = out["steps"]
        return {"boot": {k: s["boot"][k] for k in (
                    "zones", "osds", "placements", "profile")},
                "bytes": {k: s[k]["bytes"] for k in STEPS},
                "sync": {k: s["sync"][k] for k in (
                    "read_bytes", "data_rados_objects_b", "tiered")},
                "markers": s["sync"]["sync_status"]["sync_markers"],
                "put": s["put-a"]["data_rados_objects"],
                "swift+file": {k: s["swift+file"][k] for k in (
                    "slo_bytes", "files", "read_bytes")},
                "dr": {k: s["dr"][k] for k in (
                    "ledger", "rpo", "lost_keys", "conflict_winner",
                    "resync_purged", "converged", "dr_rebuild")}}

    assert free(_wave("ceph_tpu_torch")[0]) == free(_wave("ceph_tpu")[0])
