"""Wave (i) of chip_smoke.py on the CPU, on both packages.

``chip_smoke.rgw_wave`` runs each package's dev cluster: one monitor and
three OSD daemons (one per CRUSH host, MemStores, the resident shard cache,
the background deep scrub) with a mgr and its dashboard, and an S3 gateway
from ``start_rgw(cold_pool=...)``: a replicated hot pool and an
erasure-coded COLD class.  Signed PUTs straight into the cold class, PUTs
through the load generator's ``S3Backend`` and a multipart upload into the
hot pool, a lifecycle transition of every hot object into the cold class,
every object read back exactly (body, ETag, storage class) before and
after an OSD is lost, the dashboard's placement and lifecycle panels, a
closed-loop load generator with zero errors, a batched sweep verifying
every cold object, and deletes reaped by the GC from exactly the cold
pool.  The wave raises on any failure; here its records are also held
equal across the packages where they do not depend on timing.

Cut from the card's wave: 3 OSDs and a k=2 m=1 cold profile (the card: 12
OSDs, 8+4), 6 objects of 64 KiB (the card: 64 of 4 MiB), a 256 KiB
multipart upload in 64 KiB parts (the card: 64 MiB in 8 MiB parts), 40
load-generator ops (the card: 200), 2 deletes (the card: 16), and the
port's daemons run their codecs on ``device="cpu"``, where no kernel
launches.  Tolerance 0.
"""

import asyncio
import functools
import importlib
from types import SimpleNamespace

import pytest

import chip_smoke as CS

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")
OBJECTS, DELETES, PARTS = 6, 2, 4


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
        compiler=mod("placement.compiler"), loadgen=mod("testing.loadgen"),
        rgw_http=mod("services.rgw_http"), launches=launches,
        sync=lambda: None)


@functools.lru_cache(maxsize=None)
def _wave(root):
    lines = []
    out = asyncio.run(CS.rgw_wave(
        _wave_ns(root), n_osds=3, ec_k=2, ec_m=1, objects=OBJECTS,
        object_bytes=64 << 10, multipart_bytes=PARTS * (64 << 10),
        part_bytes=64 << 10, loadgen_ops=40, deletes=DELETES, victim=1,
        need=(), note=lines.append))
    return out, lines


@pytest.fixture(params=PKG_NAMES)
def wave(request):
    return _wave(request.param)


STEPS = ["boot", "put-cold", "put-hot+transition", "read-back", "degraded",
         "load", "scrub", "gc"]


def test_wave_notes_an_rgw_line_per_step(wave):
    out, lines = wave
    assert [ln.split(" ", 1)[0] for ln in lines] == ["[rgw]"] * len(STEPS)
    assert list(out["steps"]) == STEPS


def test_transition_moves_every_hot_object_into_the_cold_pool(wave):
    steps = wave[0]["steps"]
    assert steps["put-cold"]["cold_rados_objects"] == OBJECTS
    tr = steps["put-hot+transition"]
    assert tr["moved"] == OBJECTS + 1
    assert tr["cold_rados_objects"] == 2 * OBJECTS + PARTS


def test_reads_are_exact_before_and_after_the_osd_loss(wave):
    steps = wave[0]["steps"]
    total = 2 * OBJECTS * (64 << 10) + PARTS * (64 << 10)
    assert steps["read-back"]["bytes"] == total
    assert steps["degraded"]["bytes"] == total
    assert steps["read-back"]["dashboard"] == {
        "placement": 200, "lifecycle": 200, "cold_pool": "rgw.cold",
        "rules": ["to-cold"]}


def test_load_scrub_and_gc(wave):
    steps = wave[0]["steps"]
    assert steps["load"]["loadgen"]["errors"] == 0
    assert steps["load"]["loadgen"]["ops"] == 40
    assert steps["scrub"]["scrub"]["errors"] == 0
    assert steps["scrub"]["scrub"]["objects"] >= 2 * OBJECTS + PARTS
    gc = steps["gc"]
    assert gc["cold_before"] - gc["cold_after"] == DELETES
    assert gc["cold_before_gc"] == gc["cold_before"]
    assert gc["gc_reaped"] >= DELETES


def test_timing_free_records_equal_across_packages():
    def free(out):
        s = out["steps"]
        return {"boot": {k: s["boot"][k] for k in (
                    "mons", "osds", "cold_pg_num", "profile")},
                "bytes": {k: s[k]["bytes"] for k in STEPS},
                "cold": [s[k].get("cold_rados_objects") for k in STEPS],
                "moved": s["put-hot+transition"]["moved"],
                "dashboard": s["read-back"]["dashboard"],
                "loadgen": {k: s["load"]["loadgen"][k] for k in (
                    "ops", "errors", "puts", "gets", "bytes_put",
                    "bytes_get")},
                "gc": {k: s["gc"][k] for k in (
                    "deleted", "gc_queued", "gc_reaped", "cold_before",
                    "cold_before_gc", "cold_after")}}

    assert free(_wave("ceph_tpu_torch")[0]) == free(_wave("ceph_tpu")[0])
