"""Wave (e) of chip_smoke.py on the CPU, on both packages.

``chip_smoke.mon_map_wave`` runs each package's control plane: three
``Monitor``s form a quorum, the 12 x 4 deployment's 48 OSDs boot through
``MonClient`` sessions, a ``Rados`` client injects the locally built
map's CRUSH text, sets the 8+4 profile and creates the erasure pool,
then marks osd.17 out.  At a pool of 64 PGs (the card runs 512), the
tables of the client's two maps, their diff, the moved rows and the
``plan_motion`` groups must equal those of the locally built map (the
wave raises otherwise) and each other across the packages; the client's
``Objecter`` targets the drained PG's objects at its new primary, and
the drain (8 objects of 64 KiB, the codec on ``device="cpu"``) rebuilds
every moved shard exactly.  Tolerance 0.
"""

import asyncio
import functools
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_torch_osd_map import CS, PKGS as OSD_PKGS

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")
PG_NUM = 64
OBJECTS = 8
OBJECT_BYTES = 64 << 10


def _mon_ns(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    mon, client = mod("mon"), mod("client")
    return SimpleNamespace(
        Monitor=mon.Monitor, MonClient=mon.MonClient, Rados=client.Rados,
        ConfigProxy=mod("common.config").ConfigProxy,
        backfill=mod("osd.backfill"), object_to_ps=mod("osd.pg").object_to_ps,
        reset_local_namespace=mod("msg").reset_local_namespace,
        compiler=mod("placement.compiler"))


@functools.lru_cache(maxsize=None)
def _local(root: str):
    """The deployment built locally at PG_NUM PGs, and its motion when
    osd.17 is marked out."""
    pkg = OSD_PKGS[root]
    osdmap = CS.ec_pool_map(pkg.cm, pkg.om, pg_num=PG_NUM)
    motion = CS.map_motion(osdmap, pkg.om, pkg.backfill)
    return osdmap, motion


@functools.lru_cache(maxsize=None)
def _wave(root: str, tmp: str):
    ns, pkg = _mon_ns(root), OSD_PKGS[root]
    osdmap, motion_d = _local(root)
    codec = pkg.registry.factory("jax_rs", dict(CS.OSD_PROFILE),
                                 **pkg.codec_kw)
    lines = []

    async def drain(motion, names):
        rng = np.random.default_rng(CS.SEED)
        datas = {nm: rng.bytes(OBJECT_BYTES) for nm in names}
        return await CS.map_drain(pkg.osd, codec, f"{tmp}/{root}", motion,
                                  datas, tag="e")

    return asyncio.run(CS.mon_map_wave(
        ns, ns.compiler.decompile(osdmap.crush), PG_NUM, motion_d, OBJECTS,
        CS.SEED, drain=drain, note=lines.append)), lines


@pytest.fixture(params=PKG_NAMES)
def pkg(request):
    return request.param


@pytest.fixture
def wave(pkg, tmp_path_factory):
    return _wave(pkg, str(tmp_path_factory.getbasetemp()))


def _ref_wave(tmp_path_factory):
    return _wave("ceph_tpu", str(tmp_path_factory.getbasetemp()))


def test_committed_maps_plan_the_local_motion(pkg, wave, tmp_path_factory):
    """The wave itself held the client's tables, diff, rows and groups
    to the locally built map's; here they are held across the packages,
    and the out-mark moved exactly the PGs that held osd.17."""
    (out, _), (ref, _) = wave, _ref_wave(tmp_path_factory)
    motion, motion_d = out["motion"], _local(pkg)[1]
    assert motion["moved"] == motion_d["moved"] == motion["held"]
    assert motion["plan"] == motion_d["plan"]
    assert motion["plan"]["moved_pgs"] == len(motion["moved"]) > 0
    assert motion["ps"] != motion_d["ps"]
    assert motion["ps"] not in motion["undersized"]
    for key in ("moved", "held", "undersized", "rows", "plan", "ps",
                "positions", "epoch"):
        assert motion[key] == ref["motion"][key], key
    for key in ("before", "after"):
        assert CS.tables_equal(motion[key], ref["motion"][key])
    assert out["out_epoch"] == out["pool_epoch"] + 1
    assert (out["pool_epoch"], out["out_epoch"]) == \
        (ref["pool_epoch"], ref["out_epoch"])


def test_objecter_targets_the_new_primary(pkg, wave, tmp_path_factory):
    (out, _), (ref, _) = wave, _ref_wave(tmp_path_factory)
    ps = out["motion"]["ps"]
    new_up = out["motion"]["rows"][ps][1]
    assert out["targets"] == [new_up[0]] * OBJECTS
    assert out["names"] == ref["names"]
    ops = OSD_PKGS[pkg].pg.object_to_ps
    assert all(ops(nm, PG_NUM) == ps for nm in out["names"])


def test_quorum_driven_drain_rebuilds_every_shard(pkg, wave,
                                                  tmp_path_factory):
    (out, _), (ref, _) = wave, _ref_wave(tmp_path_factory)
    res = out["drained"]
    assert res["done"] == res["names"] == sorted(out["names"])
    assert res["reads"]
    assert res["rebuilt"] == res["old"]
    assert sorted(res["rebuilt"]) == out["motion"]["positions"]
    assert res["counters"]["backfill_objects"] == OBJECTS
    assert res["rebuilt"] == ref["drained"]["rebuilt"]
    assert res["counters"] == ref["drained"]["counters"]


def test_wave_notes_a_mon_line_per_step(wave):
    steps = [json.loads(ln[len("[mon] "):]) for ln in wave[1]]
    assert all(ln.startswith("[mon] ") for ln in wave[1])
    assert [s["step"] for s in steps] == [
        "quorum", "boot", "connect", "command", "command", "command", "map",
        "command", "map", "target"]
    assert [s["prefix"] for s in steps if s["step"] == "command"] == [
        "osd setcrushmap", "osd erasure-code-profile set", "osd pool create",
        "osd out"]
    assert steps[0]["quorum"] == ["a", "b", "c"]
    assert steps[1]["osds"] == 48 and steps[1]["epochs"] >= 1
    assert [s["pg_num"] for s in steps if s["step"] == "map"] == [PG_NUM] * 2
