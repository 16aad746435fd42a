"""Wave (h) of chip_smoke.py on the CPU, on both packages.

``chip_smoke.mgr_wave`` runs each package's dev cluster: one monitor and
twelve OSD daemons (one per CRUSH host, MemStores, the resident shard
cache, the background deep scrub) serve the Ceph docs' 8+4 profile while a
mgr with its dashboard and the QoS controller watches.  Concurrent writes
and a closed-loop load generator are read back exactly, a batched sweep
verifies every object, the digest's utilization section shows the
coalesced launches, the scrape, ``/metrics``, ``/api/slo`` and the TSDB
carry the utilization and burn series, and a delayed ``osd.sub_op`` raises
SLO_VIOLATION through the mgr into the mon's health and moves the QoS
controller, both of which clear once the failpoint does.  The wave raises
on any failure; here its records are also held equal across the packages
where they do not depend on timing.

Cut from the card's wave: the pool has 4 PGs (the card: 16), 16 objects of
64 KiB (the card: 64 of 4 MiB), 40 load-generator ops (the card: 200),
and the port's daemons run their codecs on ``device="cpu"``.  Tolerance
0.
"""

import asyncio
import functools
import importlib
from types import SimpleNamespace

import pytest

import chip_smoke as CS

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


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
        compiler=mod("placement.compiler"), fp=mod("common.failpoint"),
        loadgen=mod("testing.loadgen"), launches=launches,
        sync=lambda: None)


@functools.lru_cache(maxsize=None)
def _wave(root):
    lines = []
    out = asyncio.run(CS.mgr_wave(
        _wave_ns(root), pg_num=4, objects=16, object_bytes=64 << 10,
        loadgen_ops=40, note=lines.append))
    return out, lines


@pytest.fixture(params=PKG_NAMES)
def wave(request):
    return _wave(request.param)


def test_wave_notes_an_mgr_line_per_step(wave):
    out, lines = wave
    assert [ln.split(" ", 1)[0] for ln in lines] == ["[mgr]"] * 5
    assert list(out["steps"]) == ["boot", "serve", "judge", "scrape",
                                  "defend"]


def test_serve_reads_back_and_sweeps_every_object(wave):
    serve = wave[0]["steps"]["serve"]
    assert serve["loadgen"]["errors"] == 0 and serve["loadgen"]["ops"] == 40
    assert serve["scrub"]["errors"] == 0
    assert serve["scrub"]["objects"] >= 16 + 48


def test_judge_reads_the_coalesced_launches(wave):
    judge = wave[0]["steps"]["judge"]
    util = judge["utilization"]
    assert util["launch_bytes"] > 0 and util["coalesce_launches"] > 0
    assert judge["ec_launch_bytes"] >= util["launch_bytes"]
    assert judge["peak_gibps"] == 3120.0 or judge["peak_gibps"] == 763.0


def test_defend_raises_and_clears(wave):
    d = wave[0]["steps"]["defend"]
    assert d["check"]["severity"] == "HEALTH_WARN"
    assert "put_p99_ms" in d["check"]["message"]
    assert d["qos_moved"]["burning"] is True
    assert d["qos_moved"]["retunes"] > d["qos_before"]["retunes"]
    assert d["qos_after"]["burning"] is False


def test_timing_free_records_equal_across_packages():
    def free(out):
        s = out["steps"]
        return {"boot": {k: s["boot"][k] for k in ("mons", "osds",
                                                   "pg_num")},
                "loadgen": {k: s["serve"]["loadgen"][k] for k in (
                    "ops", "errors", "puts", "gets", "bytes_put",
                    "bytes_get")},
                "scrape": {k: s["scrape"][k] for k in (
                    "codes", "status_pgs", "slo_keys", "utilization_keys",
                    "missing")},
                "check": s["defend"]["check"]["severity"],
                "utilization": sorted(s["judge"]["utilization"])}

    assert free(_wave("ceph_tpu_torch")[0]) == free(_wave("ceph_tpu")[0])
