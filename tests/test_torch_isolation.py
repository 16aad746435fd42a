"""The port stands alone: it imports neither JAX nor the JAX package, and
runs on the CPU only when asked to."""

import ast
import asyncio
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "ceph_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]

BLOCKER = r"""
import importlib.abc, sys

def blocked(name):
    return (name in ("jax", "ceph_tpu") or name.startswith("jax.")
            or name.startswith("ceph_tpu."))

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked import of {name}")
        return None

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]
sys.meta_path.insert(0, Refuse())

"""

CHECK = r"""
try:
    import ceph_tpu.ec.gf
except ImportError:
    pass
else:
    raise SystemExit("the finder let ceph_tpu through")
assert not any(blocked(m) for m in sys.modules), "jax or ceph_tpu loaded"
print("isolated-ok")
"""

BLOCKED_RUN = BLOCKER + r"""
import numpy as np
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
ec = ErasureCodePluginRegistry().factory("jax_rs", {"k": "8", "m": "4"},
                                         device="cpu")
payload = np.random.default_rng(0).integers(0, 256, 9000, np.uint8).tobytes()
enc = ec.encode(list(range(12)), payload)
lost = [0, 5, 9, 11]
out = ec.decode(lost, {i: enc[i] for i in range(12) if i not in lost})
assert all(out[w] == enc[w] for w in lost)
""" + CHECK

# The CLAY repair path of the port: the codec, its probed operator and the
# batched repair through the grouped applier (plain versions on the CPU).
BLOCKED_CLAY_RUN = BLOCKER + r"""
import numpy as np
import ceph_tpu_torch.ec.plugins.clay
import ceph_tpu_torch.parallel.clay_sharding as cs
import ceph_tpu_torch.parallel.lrc_sharding
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ec.repair_operator import clay_repair_operator
ec = ErasureCodePluginRegistry().factory("clay", {"k": "8", "m": "4",
                                                  "d": "11"}, device="cpu")
data = np.random.default_rng(0).integers(0, 256, (2, 8, 64 * 16), np.uint8)
chunks = ec.encode_chunks_batch(data)
R, helpers, planes = clay_repair_operator(ec, 3)
flat = np.stack([chunks[:, h].reshape(2, 64, 16)[:, planes] for h in helpers],
                axis=1).reshape(2, -1, 16)
assert np.array_equal(cs.batched_clay_plane_repair(ec, R, flat), chunks[:, 3])
assert ec._engine.grouped_applier(R) is not None
""" + CHECK


# The port's perf lab: its experiments on the CPU (plain versions) and its
# kernels' wrappers (lab_copy, lab_bits, B1's tile).
BLOCKED_LAB_RUN = BLOCKER + r"""
import os
os.environ["PERF_LAB_STRIPES"] = "64"
import ceph_tpu_torch.testing
from ceph_tpu_torch.testing import perf_lab
for name in ("roof_copy", "enc_cmp_expand", "enc_u8_split2", "unpack_only",
             "roof_matmul", "enc_tile_4096"):
    assert perf_lab.run_experiment(name, device="cpu")["bit_identical"]
""" + CHECK


# The OSD path of the port: ECBackend writes, a degraded read, a batched
# scrub through the device CRC, and the resident write-back path, on the
# CPU.
BLOCKED_OSD_RUN = BLOCKER + r"""
import asyncio
import numpy as np
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShard
from ceph_tpu_torch.store import CollectionId, GHObject, MemStore, Transaction

async def run(resident):
    codec = ErasureCodePluginRegistry().factory("jax_rs", {"k": "4", "m": "2"},
                                                device="cpu")
    store = MemStore()
    shards = {}
    for i in range(6):
        cid = CollectionId(1, 0, shard=i)
        await store.queue_transactions(Transaction().create_collection(cid))
        shards[i] = LocalShard(store, cid, pool=1, shard=i)
    be = ECBackend(codec, shards, stripe_unit=128, resident=resident,
                   resident_writeback=resident)
    datas = {f"o{i}": bytes([i + 1]) * 4096 for i in range(4)}
    await asyncio.gather(*(be.write(o, d) for o, d in datas.items()))
    await be.flush_resident()
    if resident:
        await be.resident.evict(target=0)
    for s in (0, 3):
        await store.queue_transactions(Transaction().remove(
            CollectionId(1, 0, shard=s), GHObject(1, "o1", shard=s)))
    assert await be.read("o1") == datas["o1"]
    rep = await be.scrub_batch(["o0", "o2", "o3"])
    assert all(r["clean"] for r in rep["reports"].values())

asyncio.run(run(False))
asyncio.run(run(True))
""" + CHECK


# The durable stores, the backfill engine and the host substrate: every
# module of the slice imported, the native library (crc32c and the WAL
# engine) built and used, a WalStore on each tier and a FileStore remounted,
# a backfill drain through the repair scheduler, two messengers talking.
BLOCKED_SUBSTRATE_RUN = BLOCKER + r"""
import asyncio, tempfile
import ceph_tpu_torch.common.admin_socket
import ceph_tpu_torch.common.backoff
import ceph_tpu_torch.common.compressor
import ceph_tpu_torch.common.config
import ceph_tpu_torch.common.lockdep
import ceph_tpu_torch.common.throttle
import ceph_tpu_torch.msg.message
import ceph_tpu_torch.osd.backfill as bf
from ceph_tpu_torch.common.perf import PerfCounters
from ceph_tpu_torch.msg import Message, Messenger
from ceph_tpu_torch.osd.repair import RepairScheduler
from ceph_tpu_torch.store import (CollectionId, FileStore, GHObject, MemStore,
                                  Transaction, WalStore, native_wal)
assert native_wal.available()

async def run(root):
    cid, oid = CollectionId(1, 0), GHObject(1, "o")
    for cls, kw in ((WalStore, {"native": True}), (WalStore, {"native": False}),
                    (FileStore, {"compression": "zlib"})):
        path = f"{root}/{cls.__name__}{len(kw)}{sorted(kw)}"
        s = cls(path, **kw)
        await s.mount()
        await s.queue_transactions(Transaction().create_collection(cid)
                                   .write(cid, oid, 0, b"durable"))
        await s.umount()
        s = cls(path, **kw)
        await s.mount()
        assert s.read(cid, oid) == b"durable"
        await s.umount()

    class Repair:
        max_batch_objects = 2
        async def drain(self, backend, rebuild, versions=None,
                        clazz="recovery", stats=None):
            assert clazz == "backfill"
            return set(rebuild)

    eng = bf.BackfillEngine(Repair(), PerfCounters("t"))
    assert await eng.drain_pg(None, {"a": [1], "b": [1], "c": [1]}, pool=1,
                              ps=0, epoch=3) == {"a", "b", "c"}
    RepairScheduler(PerfCounters("r"))
    got = []

    class D:
        async def ms_dispatch(self, conn, msg):
            got.append(msg.data)
        def ms_handle_reset(self, conn):
            pass
        def ms_handle_connect(self, conn):
            pass

    a, b = Messenger("mon.a"), Messenger("osd.0")
    a.set_dispatcher(D())
    await a.bind("tcp://127.0.0.1:0")
    await b.bind("tcp://127.0.0.1:0")
    await b.send_to(str(a.my_addr), Message("ping", {"x": 1}))
    for _ in range(500):
        if got:
            break
        await asyncio.sleep(0.01)
    assert got == [{"x": 1}]
    await a.shutdown()
    await b.shutdown()

with tempfile.TemporaryDirectory() as root:
    asyncio.run(run(root))
""" + CHECK


# Placement, the OSD map and the OSD's host helpers: every module of the
# slice imported, chip_smoke's 48-OSD map built and a sample of its PGs
# mapped, a replicated pool through the bulk chooser, the crushtool text
# round trip, the moved PGs' motion plan, object names to PGs, the
# scheduler on an injected clock, the op tracker, a hit set and a SnapSet.
BLOCKED_PLACEMENT_RUN = BLOCKER + r"""
import asyncio
import chip_smoke as cs
import ceph_tpu_torch.osd.codes
import ceph_tpu_torch.placement
from ceph_tpu_torch.osd import backfill, osd_map, pg, scheduler, op_tracker
from ceph_tpu_torch.osd.hitset import BloomHitSet
from ceph_tpu_torch.osd.snaps import SnapSet, mapper_cid, mapper_oid
from ceph_tpu_torch.placement import (bulk, compiler, crush_map, hashing,
                                      mapping, straw2, tester)
m = cs.ec_pool_map(crush_map, osd_map)
assert len(m.osds) == 48 and m.pools[cs.MAP_POOL].pg_num == 512
rows = [m._pg_to_raw_osds_scalar(cs.MAP_POOL, ps) for ps in range(0, 512, 64)]
assert all(len({o // 4 for o in r if o >= 0}) == 12 for r in rows)
text = compiler.decompile(m.crush)
assert compiler.decompile(compiler.compile_text(text)) == text
m.crush.create_replicated_rule("rep", failure_domain="host")
inc = osd_map.Incremental(2, new_pools=[osd_map.PoolInfo(
    2, "rbd", size=3, pg_num=256, crush_rule="rep")])
m.apply_incremental(osd_map.Incremental.from_dict(inc.to_dict()))
before = m.mapping().up_acting_tables(2)
m.apply_incremental(osd_map.Incremental(3, new_weights={17: 0}))
after = m.mapping().up_acting_tables(2)
moved = {int(ps): (before.lookup(ps)[0], after.lookup(ps)[0])
         for ps in after.diff(before)}
assert set(int(p) for p in before.pgs_of(17)) <= set(moved)
assert backfill.plan_motion({2: moved})["moved_pgs"] == len(moved)
assert tester.simulate(m.crush, "rep", 3, 0, 64)["bad_mappings"] == 0
names = cs.pg_object_names(pg.object_to_ps, 5, 4, 1)
assert all(pg.object_to_ps(nm, 512) == 5 for nm in names)

async def sched():
    clock = lambda: 0.0
    s = scheduler.MClockScheduler(clock=clock)
    await asyncio.gather(*(s.acquire("client") for _ in range(8)))
    s.shutdown()
    return s.stats()

assert asyncio.run(sched()) == {"client": 8}
tracker = op_tracker.OpTracker()
tracker.finish(tracker.create("op"))
hs = BloomHitSet(target_size=64)
hs.insert("obj")
assert hs.contains("obj")
assert SnapSet(seq=2, clones=[2], clone_snaps={2: [1, 2]}).resolve_read(1) == 2
mapper_cid(1, 0), mapper_oid(1)
""" + CHECK


# The monitor and the client: a quorum of one port mon, an erasure profile
# validated and an EC pool created (the mon's codec on the CPU), an OSD
# booted and marked out, a Rados client following the map.
BLOCKED_MON_RUN = BLOCKER + r"""
import asyncio
import torch
torch.cuda.is_available = lambda: False
import ceph_tpu_torch.client.object_cacher
import ceph_tpu_torch.client.striper
from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.mon import MonClient, Monitor

async def run():
    monmap = {"a": "local://mon.a"}
    mon = Monitor("a", monmap)
    await mon.start()
    osd = MonClient("osd.0", monmap)
    await osd.start()
    osd.sub_want("osdmap")
    osd.renew_subs()
    await osd.send_boot(0, "local://osd.0", host="h0")
    rados = Rados(monmap, name="client.admin")
    await rados.connect()
    r = await rados.mon_command("osd erasure-code-profile set", name="p",
                                profile={"plugin": "jax_rs", "k": "2",
                                         "m": "1"})
    assert r["rc"] == 0, r
    assert await rados.pool_create("ec", pool_type="erasure",
                                   erasure_code_profile="p", pg_num=4) == 1
    assert (await rados.mon_command("osd out", ids=[0]))["rc"] == 0
    while rados.monc.osdmap.osds[0].weight != 0:
        await rados.monc.wait_for_map(rados.monc.osdmap.epoch + 1)
    assert rados.monc.osdmap.pools[1].size == 3
    await rados.shutdown()
    await osd.shutdown()
    await mon.shutdown()

asyncio.run(run())
""" + CHECK


# The OSD daemon and the dev cluster: a port DevCluster of one mon and three
# OSD daemons on the CPU, an erasure pool written and read through the
# daemons' sub-ops, an object class called, a RadosModel run verified.
BLOCKED_CLUSTER_RUN = BLOCKER + r"""
import asyncio
import json
import torch
torch.cuda.is_available = lambda: False
from ceph_tpu_torch.testing import RadosModel
from ceph_tpu_torch.vstart import DevCluster

async def run():
    cluster = DevCluster(n_mons=1, n_osds=3, device="cpu")
    await cluster.start()
    rados = await cluster.client()
    r = await rados.mon_command("osd erasure-code-profile set", name="p",
                                profile={"plugin": "jax_rs", "k": "2",
                                         "m": "1",
                                         "crush-failure-domain": "osd"})
    assert r["rc"] == 0, r
    await rados.pool_create("ec", pool_type="erasure",
                            erasure_code_profile="p", pg_num=4)
    io = await rados.open_ioctx("ec")
    await io.write_full("o", bytes(range(256)) * 40)
    assert await io.read("o") == bytes(range(256)) * 40
    await rados.pool_create("meta", pg_num=4)
    meta = await rados.open_ioctx("meta")
    await meta.write_full("v", b"x")
    assert json.loads(await meta.exec("v", "version", "inc")) == 1
    model = RadosModel(io, seed=1, n_objects=4, max_size=4096, ec=True)
    await model.run(20)
    assert await model.verify_all() == len(model.model)
    await rados.shutdown()
    await cluster.stop()

asyncio.run(run())
""" + CHECK


# The multi-device planes: the mesh functions, the host mesh coalescer with
# two backends sharing one launch, and the entry points, on 8 slots
# forced over the CPU.
BLOCKED_MESH_RUN = BLOCKER + r"""
import asyncio
import numpy as np
import torch
torch.cuda.is_available = lambda: False
from ceph_tpu_torch import entry
from ceph_tpu_torch.ec.matrix import generator_matrix
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShard
from ceph_tpu_torch.osd.mesh_coalesce import MeshCoalescer
from ceph_tpu_torch.parallel import distributed_ec_step, make_ec_mesh, mesh
from ceph_tpu_torch.store import CollectionId, MemStore, Transaction

try:
    make_ec_mesh()
except RuntimeError:
    pass
else:
    raise SystemExit("a mesh without CUDA")
mesh.force_device_count(8, device="cpu")
G = generator_matrix("reed_sol_van", 8, 4)
data = np.random.default_rng(0).integers(0, 256, (16, 8, 128), np.uint8)
shard, rep = distributed_ec_step(make_ec_mesh(cs=4), G, data, 3)
assert np.array_equal(np.asarray(rep), np.asarray(shard)[:, 3])

async def backend(co):
    codec = ErasureCodePluginRegistry().factory(
        "jax_rs", {"k": "4", "m": "2"}, device="cpu")
    store, shards = MemStore(), {}
    for i in range(6):
        cid = CollectionId(1, 0, shard=i)
        await store.queue_transactions(Transaction().create_collection(cid))
        shards[i] = LocalShard(store, cid, pool=1, shard=i)
    return ECBackend(codec, shards, stripe_unit=128, mesh_coalescer=co)

async def run():
    co = MeshCoalescer()
    a, b = await backend(co), await backend(co)
    await asyncio.gather(*(x.write(f"o{i}", bytes([i]) * 4096)
                           for x in (a, b) for i in range(8)))
    assert await b.read("o5") == bytes([5]) * 4096
    st = co.stats()
    assert st["cross_backend_launches"] >= 1 and st["devices"] == 8, st

asyncio.run(run())
mesh.force_device_count(None)
entry.dryrun_multichip(8, device="cpu")
""" + CHECK


def _run_blocked(script):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated-ok" in res.stdout


def test_port_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_RUN)


def test_clay_repair_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_CLAY_RUN)


def test_perf_lab_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_LAB_RUN)


def test_osd_path_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_OSD_RUN)


def test_substrate_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_SUBSTRATE_RUN)


def test_placement_and_osd_map_run_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_PLACEMENT_RUN)


def test_mon_and_client_run_with_jax_and_ceph_tpu_blocked():
    """The mon validates profiles on the CPU whether or not a card is
    there: with CUDA reported absent the erasure pool is still created."""
    _run_blocked(BLOCKED_MON_RUN)


def test_daemon_and_dev_cluster_run_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_CLUSTER_RUN)


def test_mesh_planes_run_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_MESH_RUN)


def test_native_library_builds_from_the_ports_sources_only():
    """The native library's build path: its two sources lie in the
    port's native/, include only system headers, and no port file names
    the JAX package's native directory or library."""
    from ceph_tpu_torch.common import crc32c as crc_mod

    native = REPO / "ceph_tpu_torch" / "native"
    assert crc_mod.SOURCE == native / "crc32c.c"
    assert crc_mod.WAL_SOURCE == native / "wal_engine.cc"
    assert crc_mod.BUILD_DIR == REPO / "ceph_tpu_torch" / "_build"
    for src in (crc_mod.SOURCE, crc_mod.WAL_SOURCE):
        includes = [line for line in src.read_text().splitlines()
                    if line.startswith("#include")]
        assert includes and all("<" in line for line in includes), src
    for path in PORT_FILES + sorted(native.iterdir()):
        text = path.read_text()
        assert "libceph_tpu_native" not in text, path
        assert "ceph_tpu/native" not in text.replace(
            "ceph_tpu_torch/native", ""), path


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_ceph_tpu_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ceph_tpu"), f"{path}: {mod}"


def test_codec_without_device_raises_without_cuda(monkeypatch):
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ErasureCodePluginRegistry().factory("jax_rs", {"k": "4", "m": "2"})


@pytest.mark.parametrize("plugin,profile", [
    ("clay", {"k": "4", "m": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
])
def test_repair_codecs_without_device_raise_without_cuda(monkeypatch, plugin,
                                                         profile):
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ErasureCodePluginRegistry().factory(plugin, profile)


def test_device_shard_cache_without_device_raises_without_cuda(monkeypatch):
    from ceph_tpu_torch.store import DeviceShardCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        DeviceShardCache()
    assert DeviceShardCache(device="cpu").device == torch.device("cpu")


def test_ec_backend_over_a_codec_without_device_raises_without_cuda(
        monkeypatch):
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend

    codec = ErasureCodePluginRegistry().factory("jax_rs", {"k": "2", "m": "1"},
                                                device="cpu")

    class NoDevice:
        """The codec's surface without its ``device``."""

        def __getattr__(self, name):
            if name == "device":
                raise AttributeError(name)
            return getattr(codec, name)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shards = {i: None for i in range(3)}
    with pytest.raises(RuntimeError):
        ECBackend(NoDevice(), shards, stripe_unit=128)
    assert ECBackend(codec, shards, stripe_unit=128).device == \
        torch.device("cpu")


def test_osd_daemon_without_device_raises_without_cuda(monkeypatch):
    from ceph_tpu_torch.osd.daemon import OSDDaemon

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monmap = {"a": "local://mon.a"}
    with pytest.raises(RuntimeError):
        OSDDaemon(0, monmap)
    assert OSDDaemon(0, monmap, device="cpu").device == torch.device("cpu")


def test_dev_cluster_start_without_device_raises_without_cuda(monkeypatch):
    from ceph_tpu_torch.msg import reset_local_namespace
    from ceph_tpu_torch.vstart import DevCluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def run():
        cluster = DevCluster(n_mons=1, n_osds=1)
        try:
            with pytest.raises(RuntimeError):
                await cluster.start()
            assert cluster.mons and not cluster.osds
        finally:
            await cluster.stop()

    reset_local_namespace()
    try:
        asyncio.run(run())
    finally:
        reset_local_namespace()


def test_osd_daemon_mesh_planes_take_the_forced_slots():
    """``osd_ec_mesh_cs`` and ``osd_ec_mesh_coalesce`` build their planes
    over ``local_devices(device)``: with 8 slots forced over the CPU, a
    (dp=4, cs=2) mesh, the host coalescer on the CPU pool and a resident
    cache placed with its sharding; without the options, none of them."""
    from ceph_tpu_torch.common.config import ConfigProxy
    from ceph_tpu_torch.osd import daemon as daemon_mod
    from ceph_tpu_torch.osd import mesh_coalesce
    from ceph_tpu_torch.parallel import mesh

    def daemon(**conf):
        return daemon_mod.OSDDaemon(0, {"a": "local://mon.a"},
                                    ConfigProxy(overrides=conf),
                                    device="cpu")

    mesh.force_device_count(8, device="cpu")
    daemon_mod._EC_MESH_CACHE.clear()
    mesh_coalesce.reset_host_coalescer()
    try:
        ec_mesh = daemon(osd_ec_mesh_cs=2)._ec_mesh()
        assert dict(ec_mesh.shape) == {"dp": 4, "cs": 2}
        assert [s.device for s in ec_mesh.slots()] == \
            [torch.device("cpu")] * 8
        assert daemon(osd_ec_mesh_cs=3)._ec_mesh() is None   # 3 ∤ 8
        coalesced = daemon(osd_ec_mesh_coalesce=True)
        co = coalesced._host_coalescer()
        assert co is mesh_coalesce.host_coalescer() and co.total == 8
        cache = coalesced._resident_cache()
        assert cache.device == torch.device("cpu")
        assert len(cache.sharding.device_set) == 8
        plain = daemon()
        assert plain._ec_mesh() is None and plain._host_coalescer() is None
        assert plain._resident_cache().sharding is None
    finally:
        mesh.force_device_count(None)
        daemon_mod._EC_MESH_CACHE.clear()
        mesh_coalesce.reset_host_coalescer()


def test_make_ec_mesh_without_devices_raises_without_cuda(monkeypatch):
    """No devices given, none forced and no CUDA: the mesh raises rather
    than falling back to the CPU."""
    from ceph_tpu_torch.parallel import make_ec_mesh, mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mesh, "_FORCED", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ec_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.local_devices()
    assert [s.device for s in mesh.local_devices("cpu")] == \
        [torch.device("cpu")]


def test_vstart_imports_no_mds_mgr_or_rgw():
    """The dev cluster's MDS, manager and gateway starters import their
    modules lazily (ROADMAP A12): importing vstart loads none of them, and
    starting one raises ModuleNotFoundError."""
    script = r"""
import asyncio, sys
import ceph_tpu_torch.vstart as vstart
later = ("ceph_tpu_torch.mds", "ceph_tpu_torch.services.mgr",
         "ceph_tpu_torch.services.rgw", "ceph_tpu_torch.services.dashboard",
         "ceph_tpu_torch.services.orchestrator")
loaded = [m for m in sys.modules if m.startswith(later)]
assert not loaded, loaded
cluster = vstart.DevCluster(n_mons=1, n_osds=0, device="cpu")
for start in (cluster.start_mds, cluster.start_mgr, cluster.start_rgw):
    try:
        asyncio.run(start())
    except ModuleNotFoundError as e:
        assert e.name.startswith(later), e.name
    else:
        raise SystemExit(f"{start.__name__} ran")
print("vstart-ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "vstart-ok" in res.stdout


def test_device_shard_cache_places_entries_on_its_slots():
    """An entry whose leading axis tiles over the sharding's slots, all on
    the cache's device, is placed as it lies (``reshards``); an entry that
    does not tile, or a cache without a sharding, places nothing."""
    from ceph_tpu_torch.parallel import make_ec_mesh, mesh
    from ceph_tpu_torch.store import DeviceShardCache

    slots = [mesh.MeshDevice(i, torch.device("cpu")) for i in range(8)]
    sharding = mesh.NamedSharding(make_ec_mesh(slots),
                                  mesh.PartitionSpec(("dp", "cs")))
    cache = DeviceShardCache(device="cpu", sharding=sharding)
    cache.put("ns", "a", 0, torch.zeros(64, dtype=torch.uint8), 1)
    cache.put("ns", "b", 0, torch.zeros(63, dtype=torch.uint8), 1)
    cache.put("ns", "c", 0, np.zeros(64, np.uint8), 1)
    assert cache.reshards == 1
    cache.set_sharding(None)
    cache.put("ns", "d", 0, torch.zeros(64, dtype=torch.uint8), 1)
    assert cache.reshards == 1
    with pytest.raises(ValueError):
        cache.put("ns", "e", 0, torch.zeros(64, dtype=torch.uint8,
                                            device="meta"), 1)


# -- the port's copies of reference modules -----------------------------------

# Modules that equal their reference apart from imports and docstrings:
# the monitor and the client, placement/, the OSD map and the OSD's host
# helpers, and the earlier slices' copies.  mon/osd_monitor.py departs by
# one keyword (``MON_DEPARTURE``).
COPIED = [
    "mon/__init__.py", "mon/store.py", "mon/service.py", "mon/paxos.py",
    "mon/election.py", "mon/sync.py", "mon/config_monitor.py",
    "mon/log_monitor.py", "mon/health_monitor.py", "mon/auth_monitor.py",
    "mon/mds_monitor.py", "mon/mgr_stat.py", "mon/monitor.py",
    "mon/client.py", "client/__init__.py", "client/rados.py",
    "client/objecter.py", "client/striper.py", "client/object_cacher.py",
    "placement/__init__.py", "placement/hashing.py", "placement/straw2.py",
    "placement/crush_map.py", "placement/bulk.py", "placement/mapping.py",
    "placement/compiler.py", "placement/tester.py", "osd/codes.py",
    "osd/osd_map.py", "osd/pg.py", "osd/scheduler.py", "osd/op_tracker.py",
    "osd/snaps.py", "osd/hitset.py", "common/perf_collect.py",
    "services/cls.py", "testing/rados_model.py", "testing/thrasher.py",
]
COPIED_EARLIER = [
    "common/admin_socket.py", "common/backoff.py", "common/cache.py",
    "common/compressor.py", "common/events.py", "common/failpoint.py",
    "common/lockdep.py", "common/perf.py", "common/throttle.py",
    "common/tracing.py", "msg/codec.py", "msg/message.py",
    "msg/messenger.py", "osd/backfill.py", "osd/pg_log.py", "osd/repair.py",
    "osd/scrub.py", "store/filestore.py", "store/memstore.py",
    "store/native_wal.py", "store/object_store.py", "store/txcodec.py",
    "store/types.py", "store/walstore.py",
]


class _Normalise(ast.NodeTransformer):
    """Drop every docstring and name the port's imports as the
    reference's."""

    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = _strip
    visit_FunctionDef = visit_AsyncFunctionDef = _strip

    @staticmethod
    def _ref(name):
        if name == "ceph_tpu_torch" or name.startswith("ceph_tpu_torch."):
            return "ceph_tpu" + name[len("ceph_tpu_torch"):]
        return name

    def visit_ImportFrom(self, node):
        if node.module:
            node.module = self._ref(node.module)
        return node

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = self._ref(alias.name)
        return node


def _normalised(path: pathlib.Path) -> str:
    return ast.dump(_Normalise().visit(ast.parse(path.read_text())))


@pytest.mark.parametrize("rel", COPIED + COPIED_EARLIER)
def test_copied_module_equals_its_reference(rel):
    port = REPO / "ceph_tpu_torch" / rel
    assert _normalised(port) == _normalised(REPO / "ceph_tpu" / rel)


class _DropMonDeparture(_Normalise):
    """The port's one departure in mon/osd_monitor.py taken out: the
    ``device="cpu"`` keyword of the ``factory`` calls that validate an
    erasure-code profile (``profile set``, erasure ``pool create``).  A mon
    only reads the codec's chunk counts, so it builds it on the CPU, card
    or no card."""

    def __init__(self):
        self.dropped = 0

    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "factory":
            keep = [kw for kw in node.keywords if not (
                kw.arg == "device" and isinstance(kw.value, ast.Constant)
                and kw.value.value == "cpu")]
            self.dropped += len(node.keywords) - len(keep)
            node.keywords = keep
        return node


def test_osd_monitor_equals_its_reference_but_for_the_cpu_codec():
    rel = "mon/osd_monitor.py"
    drop = _DropMonDeparture()
    port = ast.dump(drop.visit(ast.parse(
        (REPO / "ceph_tpu_torch" / rel).read_text())))
    assert drop.dropped == 2
    assert port == _normalised(REPO / "ceph_tpu" / rel)
    assert _normalised(REPO / "ceph_tpu_torch" / rel) != \
        _normalised(REPO / "ceph_tpu" / rel)


@pytest.mark.parametrize("rel,names", [
    ("mon/monitor.py", {"ceph_tpu_torch.common.admin_socket",
                        "ceph_tpu_torch.common.log",
                        "ceph_tpu_torch.common.events"}),
    ("mon/osd_monitor.py", {"ceph_tpu_torch.placement.compiler"}),
    ("mon/client.py", {"ceph_tpu_torch.osd.osd_map"}),
    ("mon/election.py", {"ceph_tpu_torch.mon.paxos"}),
    ("mon/sync.py", {"ceph_tpu_torch.mon.store"}),
    ("mon/mds_monitor.py", {"ceph_tpu_torch.msg.message"}),
    ("osd/osd_map.py", {"ceph_tpu_torch.osd.pg",
                        "ceph_tpu_torch.placement.mapping"}),
    ("osd/snaps.py", {"ceph_tpu_torch.osd.pg_log"}),
    ("placement/tester.py", {"ceph_tpu_torch.placement.compiler"}),
    ("osd/op_tracker.py", {"ceph_tpu_torch.common.tracing"}),
])
def test_lazy_imports_name_the_port(rel, names):
    """The imports made inside functions (the monitor's admin socket, log
    ring and process journal, the OSD monitor's CRUSH compiler, the
    MonClient's OSD map, the elector's trim window, sync's store
    transaction, the MDS monitor's message, osd_map's PG helpers and
    mapping, snaps' PG log names, tester's compiler) are the port's: the
    static scan above walks them too, and they are really there."""
    tree = ast.parse((REPO / "ceph_tpu_torch" / rel).read_text())
    lazy = {node.module for fn in ast.walk(tree)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            for node in ast.walk(fn) if isinstance(node, ast.ImportFrom)}
    assert lazy == names


class _DropDeviceDepartures(_Normalise):
    """The port's departures in osd/daemon.py and vstart.py taken out: the
    ``device`` parameter of ``cls``'s ``__init__``, its one assignment to
    ``self.device``, the ``device=self.device`` keywords that pass it on,
    the import of ``resolve_device``, ``cuda_kernels`` where the reference
    names ``pallas_kernels``, and the port's mesh where the reference
    takes ``jax.sharding`` and ``jax.devices()``.  Each is counted."""

    MESH = "ceph_tpu_torch.parallel.mesh"

    def __init__(self, cls):
        self.cls = cls
        self.dropped = {"param": 0, "assign": 0, "keyword": 0, "import": 0,
                        "variant": 0, "mesh": 0}

    def visit_ClassDef(self, node):
        if node.name == self.cls:
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and \
                        fn.name == "__init__":
                    args = fn.args
                    names = [a.arg for a in args.args]
                    if "device" in names:
                        i = names.index("device")
                        d = i - (len(args.args) - len(args.defaults))
                        del args.args[i], args.defaults[d]
                        self.dropped["param"] += 1
                    keep = [st for st in fn.body if not (
                        isinstance(st, ast.Assign)
                        and ast.unparse(st.targets[0]) == "self.device")]
                    self.dropped["assign"] += len(fn.body) - len(keep)
                    fn.body = keep
        return self._strip(node)

    def visit_Call(self, node):
        self.generic_visit(node)
        keep = [kw for kw in node.keywords if not (
            kw.arg == "device" and ast.unparse(kw.value) == "self.device")]
        self.dropped["keyword"] += len(node.keywords) - len(keep)
        node.keywords = keep
        if isinstance(node.func, ast.Name) and \
                node.func.id == "local_devices":
            node.func = ast.Attribute(
                value=ast.Name(id="jax", ctx=ast.Load()), attr="devices",
                ctx=ast.Load())
            self.dropped["mesh"] += 1
        return node

    def visit_ImportFrom(self, node):
        if node.module == "ceph_tpu_torch.ec.engine" and \
                [a.name for a in node.names] == ["resolve_device"]:
            self.dropped["import"] += 1
            return None
        if node.module == self.MESH:
            names = [a.name for a in node.names]
            self.dropped["mesh"] += 1
            if names == ["local_devices"]:
                return ast.Import(names=[ast.alias(name="jax")])
            node.module = "jax.sharding"
            return node
        for alias in node.names:
            if alias.name == "cuda_kernels":
                alias.name = "pallas_kernels"
                self.dropped["variant"] += 1
        return super().visit_ImportFrom(node)

    def visit_Name(self, node):
        if node.id == "cuda_kernels":
            node.id = "pallas_kernels"
            self.dropped["variant"] += 1
        return node


@pytest.mark.parametrize("rel,cls,dropped", [
    ("osd/daemon.py", "OSDDaemon",
     {"param": 1, "assign": 1, "keyword": 4, "import": 1, "variant": 2,
      "mesh": 3}),
    ("vstart.py", "DevCluster",
     {"param": 1, "assign": 1, "keyword": 1, "import": 0, "variant": 0,
      "mesh": 0}),
])
def test_daemon_and_vstart_equal_their_references_but_for_the_device(
        rel, cls, dropped):
    """osd/daemon.py and vstart.py are their references but for the
    departures ROADMAP Queue C lists: the ``device`` keyword and its uses,
    the encode variant set through ``cuda_kernels``, and the daemon's
    device pool and resident-cache sharding from the port's mesh
    (``local_devices(device=self.device)``, ``NamedSharding``,
    ``PartitionSpec``) in place of ``jax.devices()`` and
    ``jax.sharding``."""
    drop = _DropDeviceDepartures(cls)
    port = drop.visit(ast.parse((REPO / "ceph_tpu_torch" / rel).read_text()))
    ref = _Normalise().visit(ast.parse((REPO / "ceph_tpu" / rel).read_text()))
    assert drop.dropped == dropped
    assert ast.dump(port) == ast.dump(ref)
    assert _normalised(REPO / "ceph_tpu_torch" / rel) != \
        _normalised(REPO / "ceph_tpu" / rel)
