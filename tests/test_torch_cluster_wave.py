"""Wave (f) of chip_smoke.py on the CPU, on both packages.

``chip_smoke.cluster_wave`` runs each package's dev cluster: three
monitors and twelve OSD daemons (one per CRUSH host) on WalStores serve
the Ceph docs' 8+4 profile; a pool of one PG takes concurrent writes
through the daemons' coalescer; a pool of PGs is written, one OSD killed
and marked down by ``osd down``, degraded writes land in one PG, every
object is read degraded, the OSD is revived and the batched repair
engine rebuilds its shards; then a second cluster (1 mon, 12 OSDs on
MemStores, the resident shard cache) serves warm reads with no
host-to-device bytes, and, once ``osd unset noscrub`` releases it, the
background deep scrub sweeps every object with no error.  The wave raises on any read that is not
bit-identical, on any OSD but the victim marked down, and on a coalescer,
repair engine or resident cache that did not work; here its records are
also held equal across the packages where the reference repeats itself.

Cut from the card's wave: the ``ec`` pool has 8 PGs (the card: 128),
each step writes 64 objects of 16 KiB (the card: 4 MiB, and 512 KiB for
the resident step, whose 2 KiB shard streams stay below the device CRC's
length here), and the port's daemons run their codecs on
``device="cpu"``.  Tolerance 0.
"""

import asyncio
import functools
import importlib
import json
from types import SimpleNamespace

import pytest

import chip_smoke as CS

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")
PG_NUM = 8
OBJECTS = 64
OBJECT_BYTES = 16 << 10


def _wave_ns(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    vstart = mod("vstart")
    device = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    launches = (lambda: dict(mod("ec.cuda_kernels").LAUNCHES)) \
        if root == "ceph_tpu_torch" else dict
    return SimpleNamespace(
        DevCluster=functools.partial(vstart.DevCluster, **device),
        SCALE_TEST_OVERRIDES=vstart.SCALE_TEST_OVERRIDES,
        reset_local_namespace=mod("msg").reset_local_namespace,
        compiler=mod("placement.compiler"),
        object_to_ps=mod("osd.pg").object_to_ps, launches=launches,
        sync=lambda: None)


@functools.lru_cache(maxsize=None)
def _wave(root: str, tmp: str):
    lines = []
    out = asyncio.run(CS.cluster_wave(
        _wave_ns(root), f"{tmp}/{root}", pg_num=PG_NUM, objects=OBJECTS,
        object_bytes=OBJECT_BYTES, resident_bytes=OBJECT_BYTES,
        note=lines.append))
    return out, lines


@pytest.fixture(params=PKG_NAMES)
def pkg(request):
    return request.param


@pytest.fixture
def wave(pkg, tmp_path_factory):
    return _wave(pkg, str(tmp_path_factory.getbasetemp()))


def _ref(tmp_path_factory):
    return _wave("ceph_tpu", str(tmp_path_factory.getbasetemp()))[0]


def test_wave_notes_a_cluster_line_per_step(wave):
    out, lines = wave
    assert all(ln.startswith("[cluster] ") for ln in lines)
    recs = [json.loads(ln[len("[cluster] "):]) for ln in lines]
    assert [r["step"] for r in recs] == ["boot", "coalesce", "repair",
                                         "resident", "scrub"]
    assert recs[0]["mons"] == CS.CLUSTER_MONS
    assert recs[0]["osds"] == CS.CLUSTER_OSDS
    for rec in recs[1:]:
        assert rec["wall_s"] > 0 and rec["client_gib_s"] > 0
        assert rec["epochs"], rec["step"]
        for epoch, spread, slowest, total in rec["epochs"]:
            assert 0 <= slowest <= total and spread >= slowest - 1e-9
    assert out["seconds"] > 0


def test_coalescer_took_every_write(wave, tmp_path_factory):
    rec, ref = wave[0]["steps"]["coalesce"], _ref(tmp_path_factory)
    assert rec["ec_coalesce_ops"] == ref["steps"]["coalesce"][
        "ec_coalesce_ops"] >= OBJECTS
    assert rec["ec_coalesce_launches"] < rec["ec_coalesce_ops"]
    assert rec["holes"] == ref["steps"]["coalesce"]["holes"] == 0


def test_repair_after_a_marked_down_osd(wave, tmp_path_factory):
    rec, ref = wave[0]["steps"]["repair"], _ref(tmp_path_factory)["steps"][
        "repair"]
    assert rec["marked_down"] == [CS.CLUSTER_VICTIM] == ref["marked_down"]
    assert rec["repair_batches"] > 0
    for key in ("repair_objects", "holes"):
        assert rec[key] == ref[key], key


def test_background_scrub_sweeps_every_object(wave, tmp_path_factory):
    rec, ref = wave[0]["steps"]["scrub"], _ref(tmp_path_factory)["steps"][
        "scrub"]
    assert rec["errors"] == ref["errors"] == 0
    assert rec["objects"] >= OBJECTS and ref["objects"] >= OBJECTS


def test_resident_reads_stay_on_the_device(wave, tmp_path_factory):
    rec, ref = wave[0]["steps"]["resident"], _ref(tmp_path_factory)[
        "steps"]["resident"]
    assert rec["warm_h2d_bytes"] == ref["warm_h2d_bytes"] == 0
    assert rec["warm_hits"] >= OBJECTS
    for key in ("warm_hits", "cached_shards"):
        assert rec[key] == ref[key], key


def test_cluster_probe_runs_each_configuration(capsys):
    """``testing.cluster_probe`` (the coalescer by configuration behind
    the port's daemons) on the CPU at 4 objects of 64 KiB: one line per
    configuration, every write coalesced and read back."""
    from ceph_tpu_torch.testing import cluster_probe

    assert cluster_probe.main(["--objects", "4", "--object-bytes",
                               str(64 << 10), "--device", "cpu"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["config"] for r in recs] == [c[0] for c in
                                           cluster_probe.CONFIGS]
    for rec in recs:
        assert rec["ops"] == 4 and 1 <= rec["launches"] <= 4
        assert rec["write_s"] > 0 and rec["read_s"] > 0
