"""The port's dev cluster and QA harnesses against the JAX package's.

tests/test_harness.py's DevCluster boot / health / kill-revive round
trip, its RadosModel run on an EC pool and its RadosModel run under the
Thrasher, then scripts/tier1.sh's coalesce, resident and repair smokes at
their own sizes (jax_rs k=2 m=1, 4 KiB objects), each on a fresh
``DevCluster`` of each package: the JAX package's, then the port's with
its OSD daemons on ``device="cpu"`` and the port's own ``RadosModel`` and
``Thrasher``.  Read-back is exact on both; the seeded model's oracle
verifies on both, and without thrashing the two models end in the same
state.  Counters that a run of the reference repeats (coalesced ops, warm
host-to-device bytes, cached shards, objects rebuilt) must be equal across
the packages; those that depend on timing (launch counts, thrasher kills)
are held to the smoke's bounds, except the JAX package's coalesced
launches: in a process where its encode is already compiled, 64 ops of
4 KiB take 24-28 launches against tier1.sh's bound of 16, so it is held
to fewer launches than ops.  Tolerance 0.
"""

import asyncio
import importlib
from types import SimpleNamespace

import chip_smoke as CS
from tests.test_torch_osd_daemon import PKGS as DAEMON_PKGS
from tests.test_torch_osd_daemon import _clean_local  # noqa: F401
from tests.test_torch_osd_daemon import on_each_package as run_on_each

PKGS = {name: SimpleNamespace(
    **vars(DAEMON_PKGS[name]),
    RadosModel=importlib.import_module(
        f"{name}.testing.rados_model").RadosModel,
    Thrasher=importlib.import_module(f"{name}.testing.thrasher").Thrasher)
    for name in DAEMON_PKGS}


def on_each_package(scenario):
    return run_on_each(scenario, PKGS)


def summed(cluster, key):
    return sum(osd.perf.value(key) for osd in cluster.osds.values())


async def recovered(osds, timeout=60.0):
    """Wait until ``chip_smoke.pgs_clean`` holds for the daemons."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not CS.pgs_clean(osds.values()):
        assert loop.time() < deadline, "recovery never finished"
        await asyncio.sleep(0.05)


async def profile(rados, name):
    r = await rados.mon_command(
        "osd erasure-code-profile set", name=name,
        profile={"plugin": "jax_rs", "k": "2", "m": "1",
                 "crush-failure-domain": "osd"})
    assert r["rc"] in (0, -17), r


# ---------------------------------------------------------------------------
# tests/test_harness.py

async def _devcluster_boot_and_health(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    await cluster.wait_health_ok()
    rados = await cluster.client()
    got = [await rados.pool_create("p", pg_num=4)]
    io = await rados.open_ioctx("p")
    await io.write_full("o", b"hello")
    got.append(await io.read("o"))
    await cluster.kill_osd(2)
    await cluster.revive_osd(2)
    await cluster.wait_health_ok()
    got.append(await io.read("o"))
    got.append(sorted(cluster.osds))
    await rados.shutdown()
    await cluster.stop()
    return got


def test_devcluster_boot_and_health():
    out = on_each_package(_devcluster_boot_and_health)
    assert out["ceph_tpu_torch"] == out["ceph_tpu"] == [
        1, b"hello", b"hello", [0, 1, 2]]


async def _rados_model_ec_pool(p):
    cluster = p.DevCluster(n_mons=1, n_osds=4)
    await cluster.start()
    rados = await cluster.client()
    await profile(rados, "m21")
    await rados.pool_create("ecmodel", pool_type="erasure",
                            erasure_code_profile="m21", pg_num=4)
    io = await rados.open_ioctx("ecmodel")
    model = p.RadosModel(io, seed=11, n_objects=8, max_size=1 << 14,
                         ec=True)
    await model.run(80)
    verified = await model.verify_all()
    assert verified == len(model.model)
    state = (model.ops_done, verified,
             {oid: (bytes(obj.data), obj.xattrs, obj.omap)
              for oid, obj in sorted(model.model.items())})
    await rados.shutdown()
    await cluster.stop()
    return state


def test_rados_model_ec_pool():
    out = on_each_package(_rados_model_ec_pool)
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]
    assert out["ceph_tpu"][0] == 80 and out["ceph_tpu"][1] > 0


async def _rados_model_under_thrashing(p):
    cluster = p.DevCluster(n_mons=1, n_osds=4, overrides={
        "mon_osd_down_out_interval": 300.0,
    })
    await cluster.start()
    rados = await cluster.client()
    await rados.pool_create("thrash", pg_num=8, size=3, min_size=2)
    io = await rados.open_ioctx("thrash")
    model = p.RadosModel(io, seed=3, n_objects=10, max_size=1 << 14)
    await model.run(20)
    thrasher = p.Thrasher(cluster, min_live=3, down_interval=0.2,
                          revive_delay=0.4, seed=5)
    thrasher.start()
    try:
        for _ in range(40):
            await model.run(15)
            if thrasher.kills >= 2 and model.ops_done >= 120:
                break
    finally:
        await thrasher.stop(revive_all=True)
    assert thrasher.kills >= 2, thrasher.kills
    await cluster.wait_health_ok(timeout=30)
    await asyncio.sleep(1.0)
    verified = await model.verify_all()
    assert verified == len(model.model)
    await rados.shutdown()
    await cluster.stop()
    return verified == len(model.model), model.ops_done >= 120


def test_rados_model_under_thrashing():
    out = on_each_package(_rados_model_under_thrashing)
    assert out["ceph_tpu_torch"] == out["ceph_tpu"] == (True, True)


# ---------------------------------------------------------------------------
# scripts/tier1.sh's smokes

def _objects(n, base=0):
    return {f"obj-{i}": bytes([base + i]) * 4096 for i in range(n)}


async def _coalesce_smoke(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        rados = await cluster.client()
        await profile(rados, "coalsmoke")
        await rados.pool_create("coal", pg_num=1, pool_type="erasure",
                                erasure_code_profile="coalsmoke")
        io = await rados.open_ioctx("coal")
        datas = _objects(64)
        await asyncio.gather(*(io.write_full(o, d)
                               for o, d in datas.items()))
        got = [await io.read(o) for o in datas]
        assert got == list(datas.values())
        ops = summed(cluster, "ec_coalesce_ops")
        launches = summed(cluster, "ec_coalesce_launches")
        assert ops >= 64, (launches, ops)
        # tier1.sh's bound holds for the port; the JAX package's count
        # grows once its encode is compiled and fast (25-28 of 64 in a
        # warm process), so it is held to coalescing at all
        assert launches < (ops / 4 if p.root == "ceph_tpu_torch" else ops), \
            (launches, ops)
        return got, ops
    finally:
        await cluster.stop()


def test_coalesce_smoke():
    out = on_each_package(_coalesce_smoke)
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]


async def _resident_smoke(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        rados = await cluster.client()
        await profile(rados, "ressmoke")
        await rados.pool_create("res", pg_num=1, pool_type="erasure",
                                erasure_code_profile="ressmoke")
        io = await rados.open_ioctx("res")
        datas = _objects(64)
        await asyncio.gather(*(io.write_full(o, d)
                               for o, d in datas.items()))
        h2d0 = summed(cluster, "ec_resident_h2d_bytes")
        got = [await io.read(o) for o in datas]
        assert got == list(datas.values())
        h2d = summed(cluster, "ec_resident_h2d_bytes") - h2d0
        hits = summed(cluster, "ec_resident_hits")
        assert h2d == 0 and hits >= 64, (h2d, hits)
        entries = 0
        for osd_id in cluster.osds:
            stats = await rados.osd_daemon_command(osd_id,
                                                   "ec_resident_stats")
            entries += stats.get("cache", {}).get("entries", 0)
        assert entries > 0
        return got, h2d, hits, entries
    finally:
        await cluster.stop()


def test_resident_smoke():
    out = on_each_package(_resident_smoke)
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]


async def _repair_smoke(p):
    cluster = p.DevCluster(n_mons=1, n_osds=4, overrides={
        "mon_osd_down_out_interval": 300.0,
    })
    await cluster.start()
    try:
        rados = await cluster.client()
        await profile(rados, "repsmoke")
        await rados.pool_create("rep", pg_num=8, pool_type="erasure",
                                erasure_code_profile="repsmoke")
        io = await rados.open_ioctx("rep")
        datas = _objects(32)
        await asyncio.gather(*(io.write_full(o, d)
                               for o, d in datas.items()))
        victim = 1
        await cluster.kill_osd(victim)
        degraded = {f"deg-{i}": bytes([128 + i]) * 4096 for i in range(16)}
        await asyncio.gather(*(io.write_full(o, d)
                               for o, d in degraded.items()))
        datas.update(degraded)
        await cluster.revive_osd(victim)
        await cluster.wait_health_ok(timeout=60)
        batches = objects = 0
        for _ in range(120):
            batches = objects = 0
            for osd_id in cluster.osds:
                stats = await rados.osd_daemon_command(osd_id,
                                                       "ec_repair_stats")
                eng = stats.get("engine", {})
                batches += eng.get("batches", 0)
                objects += eng.get("objects", 0)
                assert stats.get("mclock", {}).get("enabled") is not None
            if batches > 0:
                break
            await asyncio.sleep(0.25)
        assert batches > 0 and objects > 0, (batches, objects)
        # read back, and count the drain's objects, once every primary PG
        # is clean again: the poll above stops at the first batch (a read
        # racing the drain took EIO once in ten runs on the JAX package)
        await recovered(cluster.osds)
        got = [await io.read(o) for o in datas]
        assert got == list(datas.values())
        objects = 0
        for osd_id in cluster.osds:
            stats = await rados.osd_daemon_command(osd_id, "ec_repair_stats")
            objects += stats.get("engine", {}).get("objects", 0)
        return got, objects
    finally:
        await cluster.stop()


def test_repair_smoke():
    out = on_each_package(_repair_smoke)
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]
