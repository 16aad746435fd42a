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
    modules lazily: importing vstart loads none of them.  Each starts the
    port's daemon on the CPU: the MDS takes rank 0 and serves a mount, the
    mgr with its dashboard and orchestrator backend boots, reports and
    stops, the gateway serves a signed S3 round trip."""
    script = r"""
import asyncio, sys
import ceph_tpu_torch.vstart as vstart
# services/__init__ exports Mgr and RGWLite, as the reference's does, so
# the mgr module and the gateway's object layer come with the object
# classes the daemon imports; the gateway's placement, front end and
# push endpoints stay lazy
lazy = ("ceph_tpu_torch.mds", "ceph_tpu_torch.services.rgw_",
        "ceph_tpu_torch.services.dashboard",
        "ceph_tpu_torch.services.orchestrator",
        "ceph_tpu_torch.services.mgr_")
loaded = [m for m in sys.modules if m.startswith(lazy)]
assert not loaded, loaded

async def mgr():
    from ceph_tpu_torch.client.fs import CephFS
    from ceph_tpu_torch.mds import MDSDaemon
    from ceph_tpu_torch.testing.loadgen import S3Backend

    cluster = vstart.DevCluster(n_mons=1, n_osds=3, device="cpu")
    await cluster.start()
    try:
        mgr = await cluster.start_mgr(dashboard=True, orchestrate=True)
        digest = await mgr.report()
        assert digest["num_pgs"] == 0 and "utilization" in digest, digest
        assert mgr.dashboard.port > 0
        backend = mgr.modules["orchestrator"].backend
        assert backend is not None and backend.cluster is cluster
        fe, users = await cluster.start_rgw()
        assert mgr.dashboard.rgw is fe.rgw
        alice = await users.create("alice")
        s3 = S3Backend(fe.host, fe.port, alice["access_key"],
                       alice["secret_key"], bucket="b")
        await s3.ensure_bucket()
        await s3.put("k", b"v" * 100)
        assert await s3.get("k") == b"v" * 100
        admin = await cluster.client()
        for pool in ("cephfs_meta", "cephfs_data"):
            await admin.pool_create(pool, pg_num=4)
        mds = await cluster.start_mds(block_size=4096)
        assert isinstance(mds, MDSDaemon) and cluster.mdss == {"a": mds}
        fs = await CephFS.connect(admin)
        await fs.mount()
        await fs.write_file("/f", b"m" * 5000)
        assert await fs.read_file("/f") == b"m" * 5000
        await fs.unmount()
        await admin.shutdown()
    finally:
        await cluster.stop()
    assert not cluster.mgrs and mgr.dashboard is None and not cluster.rgws
    assert not cluster.mdss

asyncio.run(mgr())
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
# CephFS (the MDS, the client, volumes, the journal and data-scan tools),
# block images (journal, groups, mirroring, the write-back log), the
# offline tools, the dencoder and the admin CLIs, multisite sync, Swift and
# the file view of buckets, the S3 gateway (object layer, placement, front
# end, bucket policies, key management, push endpoints), the manager, its
# modules and engines and the load generator, the monitor
# and the client, placement/, the OSD map and the OSD's host helpers, and
# the earlier slices' copies.  mon/osd_monitor.py, testing/chaos.py,
# vstart.py and cli.py each have a test of their departure below.
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
    "common/slo.py", "common/qos.py", "common/tsdb.py",
    "services/mgr_perf.py", "services/mgr_slo.py", "services/mgr_qos.py",
    "services/mgr_tsdb.py", "services/mgr_multisite.py",
    "services/orchestrator.py", "services/mgr.py", "services/dashboard.py",
    "testing/loadgen.py", "services/iam.py", "services/kms.py",
    "services/rgw_push.py", "services/rgw.py", "services/rgw_zone.py",
    "services/rgw_http.py", "services/rgw_sync.py", "services/rgw_file.py",
    "services/swift.py", "objectstore_tool.py", "tools/__init__.py",
    "tools/monmaptool.py", "tools/monstore_tool.py", "tools/osdmaptool.py",
    "dencoder.py", "services/rbd_journal.py", "services/rbd.py",
    "services/rbd_group.py", "services/rbd_mirror.py",
    "services/rbd_pwl.py", "rbd_tool.py", "rgw_admin.py",
    "services/mgr_modules.py", "mds/__init__.py", "mds/daemon.py",
    "client/fs.py", "services/volumes.py", "cephfs_journal_tool.py",
    "cephfs_data_scan.py",
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


class _DropLoopTrace(ast.NodeTransformer):
    """The port's on-loop tracing taken out of a copied module (ROADMAP
    Queue C): every name the departure adds (``names``: helpers, their
    imports, new attributes, the ``ambient`` and ``clock`` parameters,
    the ``context`` keyword of the messenger's I/O tasks) and every use
    of one, each use counted by its form: a definition, an import, an
    assignment, a call statement (of a named function or a method of a
    named object), a ``with`` block kept as its body, a keyword, a
    parameter, a ``**`` dict entry or a ``*`` list entry."""

    FORMS = ("def", "import", "assign", "call", "with", "keyword", "param",
             "dict", "list")

    def __init__(self, names):
        self.names = set(names)
        self.dropped = dict.fromkeys(self.FORMS, 0)

    def _named(self, node) -> bool:
        return (isinstance(node, ast.Name) and node.id in self.names) or (
            isinstance(node, ast.Attribute) and node.attr in self.names)

    def _call(self, node) -> bool:
        """A call of a named function, or of a method of a named object."""
        return isinstance(node, ast.Call) and (self._named(node.func) or (
            isinstance(node.func, ast.Attribute)
            and self._named(node.func.value)))

    def _def(self, node):
        if node.name in self.names:
            self.dropped["def"] += 1
            return None
        return self.generic_visit(node)

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _def

    def visit_Import(self, node):
        keep = [a for a in node.names if a.name not in self.names]
        self.dropped["import"] += len(node.names) - len(keep)
        if not keep:
            return None
        node.names = keep
        return node

    def visit_ImportFrom(self, node):
        keep = [a for a in node.names if a.name not in self.names]
        self.dropped["import"] += len(node.names) - len(keep)
        if not keep:
            return None
        node.names = keep
        return node

    def _assign(self, node):
        targets = getattr(node, "targets", None) or [node.target]
        if (node.value is not None and self._call(node.value)) or all(
                self._named(t) for t in targets):
            self.dropped["assign"] += 1
            return None
        return self.generic_visit(node)

    visit_Assign = visit_AnnAssign = _assign

    def visit_Expr(self, node):
        if self._call(node.value):
            self.dropped["call"] += 1
            return None
        return self.generic_visit(node)

    def visit_With(self, node):
        if all(self._call(item.context_expr) or self._named(
                item.context_expr) for item in node.items):
            self.dropped["with"] += 1
            body = []
            for st in node.body:
                st = self.visit(st)
                if st is None:
                    continue
                body.extend(st if isinstance(st, list) else [st])
            return body
        return self.generic_visit(node)

    def visit_Call(self, node):
        self.generic_visit(node)
        keep = [kw for kw in node.keywords if not (
            kw.arg in self.names or self._call(kw.value))]
        self.dropped["keyword"] += len(node.keywords) - len(keep)
        node.keywords = keep
        return node

    def visit_arguments(self, node):
        self.generic_visit(node)
        args = node.args
        for i in reversed(range(len(args))):
            if args[i].arg in self.names:
                d = i - (len(args) - len(node.defaults))
                del args[i]
                if d >= 0:
                    del node.defaults[d]
                self.dropped["param"] += 1
        return node

    def visit_Dict(self, node):
        self.generic_visit(node)
        keep = [(k, v) for k, v in zip(node.keys, node.values)
                if not (k is None and self._call(v))]
        self.dropped["dict"] += len(node.keys) - len(keep)
        node.keys = [k for k, _ in keep]
        node.values = [v for _, v in keep]
        return node

    def visit_List(self, node):
        self.generic_visit(node)
        keep = [e for e in node.elts if not (
            isinstance(e, ast.Starred) and self._call(e.value))]
        self.dropped["list"] += len(node.elts) - len(keep)
        node.elts = keep
        return node


def _counts(**kw) -> dict:
    return {f: kw.get(f, 0) for f in _DropLoopTrace.FORMS}


# rel -> (the names the on-loop tracing adds, each form's count)
LOOP_TRACE = {
    "common/tracing.py": (
        {"asyncio", "gc", "threading", "nullcontext",
         "BUCKET_NS", "PROBE_S", "_GC", "_LABELS",
         "RING_BUCKETS", "_STOCK_RUN", "_NO_SPAN", "_Acct", "_OPEN",
         "_HOLDERS", "_MONITOR", "_LAST", "LoopMonitor", "_TASK_ACCT",
         "_ambient_owner", "_settle",
         "_unspanned_label", "_run_step", "_owner", "_cut",
         "hold_loop_trace", "loop_monitor",
         "watch_trace_probability", "_open_span", "_close_span",
         "_span_clock", "_clock_fields", "child_span", "reply_trace",
         "untraced_context",
         "LoopLabel", "ambient", "clock"},
        _counts(**{"def": 19, "import": 4, "assign": 13, "call": 3,
                   "param": 2, "dict": 2})),
    "msg/messenger.py": (
        {"LoopLabel", "hold_loop_trace", "untraced_context",
         "watch_trace_probability", "_SEND", "_RECV", "_recv_done",
         "_sync_loop_trace", "ambient", "context"},
        _counts(**{"def": 2, "import": 4, "assign": 2, "call": 7,
                   "with": 1, "keyword": 6})),
    "store/object_store.py": (
        {"child_span"}, _counts(**{"import": 1, "with": 1})),
    "store/memstore.py": (
        {"child_span"}, _counts(**{"import": 1, "with": 1})),
    "client/objecter.py": ({"ambient"}, _counts(keyword=1)),
    "services/mgr_slo.py": (
        {"_launch_time_base", "_time_base_entry"},
        _counts(**{"def": 2, "assign": 1, "dict": 1})),
    "services/mgr_tsdb.py": (
        {"_add_device_us", "_kernel_seconds"},
        _counts(**{"def": 2, "assign": 1, "call": 1})),
    "services/dashboard.py": (
        {"_time_base_rows"}, _counts(**{"def": 1, "list": 1})),
    "osd/daemon.py": (
        {"reply_trace", "ambient"},
        _counts(**{"import": 1, "keyword": 2, "dict": 2})),
    "cli.py": ({"_note_time_base"}, _counts(**{"def": 1, "call": 2})),
}


def _drop_loop_trace(rel: str, tree):
    """``tree`` with the on-loop tracing taken out where ``rel`` has it,
    its counts checked."""
    if rel not in LOOP_TRACE:
        return tree
    names, counts = LOOP_TRACE[rel]
    drop = _DropLoopTrace(names)
    tree = drop.visit(tree)
    assert drop.dropped == counts, (rel, drop.dropped)
    return tree


@pytest.mark.parametrize("rel", COPIED + COPIED_EARLIER)
def test_copied_module_equals_its_reference(rel):
    """Each copied module is its reference, but for the on-loop tracing
    where LOOP_TRACE lists it (taken out, and counted)."""
    port = REPO / "ceph_tpu_torch" / rel
    tree = _drop_loop_trace(rel, ast.parse(port.read_text()))
    assert ast.dump(_Normalise().visit(tree)) == \
        _normalised(REPO / "ceph_tpu" / rel)


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
    ("services/mgr.py", {"ceph_tpu_torch.common.admin_socket",
                         "ceph_tpu_torch.common.log",
                         "ceph_tpu_torch.common.perf_collect",
                         "ceph_tpu_torch.services.mgr_modules",
                         "ceph_tpu_torch.services.mgr_multisite",
                         "ceph_tpu_torch.services.mgr_perf",
                         "ceph_tpu_torch.services.mgr_qos",
                         "ceph_tpu_torch.services.mgr_slo",
                         "ceph_tpu_torch.services.mgr_tsdb",
                         "ceph_tpu_torch.services.orchestrator"}),
    ("services/mgr_modules.py", {"ceph_tpu_torch.client.fs",
                                 "ceph_tpu_torch.client.rados"}),
    ("services/mgr_perf.py", {"ceph_tpu_torch.client.rados",
                              "ceph_tpu_torch.services.rbd"}),
    ("services/mgr_slo.py", {"ceph_tpu_torch.services.mgr"}),
    ("services/mgr_qos.py", {"ceph_tpu_torch.common.events",
                             "ceph_tpu_torch.services.mgr"}),
    ("services/mgr_tsdb.py", {"ceph_tpu_torch.common.tsdb"}),
    ("services/mgr_multisite.py", {"ceph_tpu_torch.services.mgr"}),
    ("services/dashboard.py", {"ceph_tpu_torch.services.rgw_zone"}),
    ("testing/loadgen.py", {"ceph_tpu_torch.client.rados",
                            "ceph_tpu_torch.services.rgw_http"}),
    ("services/rgw.py", {"cryptography.hazmat.primitives.ciphers",
                         "ceph_tpu_torch.services",
                         "ceph_tpu_torch.services.kms",
                         "ceph_tpu_torch.services.rgw_push",
                         "ceph_tpu_torch.services.rgw_zone"}),
    ("services/rgw_zone.py", {"ceph_tpu_torch.common.compressor",
                              "ceph_tpu_torch.services.rgw_sync"}),
    ("services/rgw_http.py", {"ceph_tpu_torch.client.rados",
                              "ceph_tpu_torch.services.rgw"}),
    ("testing/chaos.py", {"ceph_tpu_torch.osd.backfill",
                          "ceph_tpu_torch.osd.osd_map",
                          "ceph_tpu_torch.osd.pg",
                          "ceph_tpu_torch.services.rgw",
                          "ceph_tpu_torch.store.types",
                          "ceph_tpu_torch.tools", "ceph_tpu_torch.vstart"}),
    ("services/rgw_sync.py", {"ceph_tpu_torch.client.rados"}),
    ("services/rgw_file.py", set()),
    ("services/swift.py", {"ceph_tpu_torch.services.rgw"}),
    ("objectstore_tool.py", {"ceph_tpu_torch.msg.codec",
                             "ceph_tpu_torch.store.filestore"}),
    ("tools/__init__.py", set()),
    ("tools/monmaptool.py", set()),
    ("tools/monstore_tool.py", set()),
    ("tools/osdmaptool.py", {"ceph_tpu_torch.mon.store"}),
    ("dencoder.py", {"ceph_tpu_torch.msg.message",
                     "ceph_tpu_torch.osd.osd_map",
                     "ceph_tpu_torch.osd.pg_log",
                     "ceph_tpu_torch.placement.crush_map",
                     "ceph_tpu_torch.store.object_store",
                     "ceph_tpu_torch.store.txcodec",
                     "ceph_tpu_torch.store.types"}),
    ("services/rbd_journal.py", set()),
    ("services/rbd.py", {"ceph_tpu_torch.client.object_cacher"}),
    ("services/rbd_group.py", set()),
    ("services/rbd_mirror.py", {"ceph_tpu_torch.services.rbd_journal"}),
    ("services/rbd_pwl.py", set()),
    ("cli.py", {"ceph_tpu_torch.client.fs", "ceph_tpu_torch.client.rados",
                "ceph_tpu_torch.common.admin_socket",
                "ceph_tpu_torch.common.events",
                "ceph_tpu_torch.common.tracing", "ceph_tpu_torch.msg.codec",
                "ceph_tpu_torch.services.volumes"}),
    ("rbd_tool.py", {"ceph_tpu_torch.cli", "ceph_tpu_torch.client.rados",
                     "ceph_tpu_torch.services.rbd_group"}),
    ("rgw_admin.py", {"ceph_tpu_torch.cli", "ceph_tpu_torch.client.rados",
                      "ceph_tpu_torch.services.rgw_sync",
                      "ceph_tpu_torch.services.rgw_zone"}),
    ("mds/__init__.py", set()),
    ("mds/daemon.py", {"ceph_tpu_torch.common.admin_socket",
                       "ceph_tpu_torch.common.log",
                       "ceph_tpu_torch.placement.hashing"}),
    ("client/fs.py", set()),
    ("services/volumes.py", set()),
    ("cephfs_journal_tool.py", {"ceph_tpu_torch.cli",
                                "ceph_tpu_torch.msg.codec"}),
    ("cephfs_data_scan.py", {"ceph_tpu_torch.cli",
                             "ceph_tpu_torch.mds.daemon"}),
])
def test_lazy_imports_name_the_port(rel, names):
    """The imports made inside functions (the monitor's admin socket, log
    ring and process journal, the OSD monitor's CRUSH compiler, the
    MonClient's OSD map, the elector's trim window, sync's store
    transaction, the MDS monitor's message, osd_map's PG helpers and
    mapping, snaps' PG log names, tester's compiler, the mgr's modules and
    the reaches of the mgr, the load generator and the drills into the
    gateway, block images, CephFS and tools, the gateway's reaches into
    its placement, policies, key management, push endpoints and
    multisite sync, the offline tools' stores and codecs, the dencoder's
    wire types, RBD's object cacher and journal, the CLIs' reaches into
    each other, the client, tracing, admin socket and event journal, the
    MDS's admin socket, log ring and dentry hash, the CephFS tools' conf
    loader, codec and dirfrag names) are the port's: the static scan above
    walks them too."""
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

    def __init__(self, *cls):
        self.cls = cls
        self.dropped = {"param": 0, "assign": 0, "keyword": 0, "import": 0,
                        "variant": 0, "mesh": 0}

    def visit_ClassDef(self, node):
        if node.name in self.cls:
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
    ("osd/daemon.py", ("OSDDaemon",),
     {"param": 1, "assign": 1, "keyword": 4, "import": 1, "variant": 2,
      "mesh": 3}),
    ("vstart.py", ("DevCluster", "MultisiteRealm"),
     {"param": 2, "assign": 2, "keyword": 2, "import": 0, "variant": 0,
      "mesh": 0}),
])
def test_daemon_and_vstart_equal_their_references_but_for_the_device(
        rel, cls, dropped):
    """osd/daemon.py and vstart.py are their references but for the
    departures ROADMAP Queue C lists: the ``device`` keyword and its uses
    (on ``DevCluster``, and on ``MultisiteRealm``, which hands it to each
    zone's ``DevCluster``), the encode variant set through
    ``cuda_kernels``, and the daemon's
    device pool and resident-cache sharding from the port's mesh
    (``local_devices(device=self.device)``, ``NamedSharding``,
    ``PartitionSpec``) in place of ``jax.devices()`` and
    ``jax.sharding``; in osd/daemon.py the on-loop tracing (LOOP_TRACE) is
    taken out first."""
    drop = _DropDeviceDepartures(*cls)
    port = drop.visit(_drop_loop_trace(
        rel, ast.parse((REPO / "ceph_tpu_torch" / rel).read_text())))
    ref = _Normalise().visit(ast.parse((REPO / "ceph_tpu" / rel).read_text()))
    assert drop.dropped == dropped
    assert ast.dump(port) == ast.dump(ref)
    assert _normalised(REPO / "ceph_tpu_torch" / rel) != \
        _normalised(REPO / "ceph_tpu" / rel)


class _DropChaosDevice(_Normalise):
    """The port's departure in testing/chaos.py taken out: the ``device``
    parameter of ``ChaosHarness.__init__``, of ``_make_ec_cluster`` and of
    each drill that builds a cluster, the one ``self.device = device``, and
    the ``device=`` keywords that hand it to ``DevCluster`` and
    ``_make_ec_cluster``.  Each is counted."""

    def __init__(self):
        self.dropped = {"param": 0, "assign": 0, "keyword": 0}

    def _fn(self, node):
        args = node.args
        names = [a.arg for a in args.args]
        if "device" in names:
            i = names.index("device")
            d = i - (len(args.args) - len(args.defaults))
            del args.args[i], args.defaults[d]
            self.dropped["param"] += 1
        kw = [a.arg for a in args.kwonlyargs]
        if "device" in kw:
            i = kw.index("device")
            del args.kwonlyargs[i], args.kw_defaults[i]
            self.dropped["param"] += 1
        keep = [st for st in node.body if not (
            isinstance(st, ast.Assign)
            and ast.unparse(st) == "self.device = device")]
        self.dropped["assign"] += len(node.body) - len(keep)
        node.body = keep
        return self._strip(node)

    visit_FunctionDef = visit_AsyncFunctionDef = _fn

    def visit_Call(self, node):
        self.generic_visit(node)
        keep = [kw for kw in node.keywords if not (
            kw.arg == "device"
            and ast.unparse(kw.value) in ("device", "self.device"))]
        self.dropped["keyword"] += len(node.keywords) - len(keep)
        node.keywords = keep
        return node


def test_chaos_equals_its_reference_but_for_the_device():
    """testing/chaos.py is its reference but for ``device=``: taken out
    from ChaosHarness, the five drills that build a cluster (and their
    helper) and the zone-loss drill that builds a realm, it is the
    reference."""
    rel = "testing/chaos.py"
    drop = _DropChaosDevice()
    port = ast.dump(drop.visit(ast.parse(
        (REPO / "ceph_tpu_torch" / rel).read_text())))
    assert drop.dropped == {"param": 8, "assign": 1, "keyword": 8}
    assert port == _normalised(REPO / "ceph_tpu" / rel)
    assert _normalised(REPO / "ceph_tpu_torch" / rel) != \
        _normalised(REPO / "ceph_tpu" / rel)


class _NameToolsAsReference(_Normalise):
    """The port's departure in cli.py taken out: ``_TOOLS``, the ``tool``
    passthrough's table, names each offline tool's module as
    ``ceph_tpu_torch.…`` where the reference names ``ceph_tpu.…``; each
    value of that one table is counted."""

    def __init__(self):
        self.renamed = 0

    def visit_Assign(self, node):
        self.generic_visit(node)
        if [ast.unparse(t) for t in node.targets] == ["_TOOLS"]:
            for v in node.value.values:
                v.value = self._ref(v.value)
                self.renamed += 1
        return node


def test_cli_equals_its_reference_but_for_the_tool_table():
    """cli.py is its reference but for ``_TOOLS`` and, taken out first,
    the time-base line of ``ceph-tpu top`` (LOOP_TRACE)."""
    rel = "cli.py"
    drop = _NameToolsAsReference()
    port = ast.dump(drop.visit(_drop_loop_trace(rel, ast.parse(
        (REPO / "ceph_tpu_torch" / rel).read_text()))))
    assert drop.renamed == 4
    assert port == _normalised(REPO / "ceph_tpu" / rel)
    assert _normalised(REPO / "ceph_tpu_torch" / rel) != \
        _normalised(REPO / "ceph_tpu" / rel)
    from ceph_tpu_torch import cli

    assert all(v.startswith("ceph_tpu_torch.") for v in cli._TOOLS.values())


def _public(module):
    return sorted(n for n, v in vars(module).items()
                  if not n.startswith("_")
                  and getattr(v, "__module__", None) == module.__name__)


@pytest.mark.parametrize("rel", [
    "common/slo.py", "common/qos.py", "common/tsdb.py",
    "services/mgr_modules.py", "services/mgr_perf.py",
    "services/mgr_slo.py", "services/mgr_qos.py", "services/mgr_tsdb.py",
    "services/mgr_multisite.py", "services/orchestrator.py",
    "services/mgr.py", "services/dashboard.py", "testing/loadgen.py",
    "testing/chaos.py", "services/iam.py", "services/kms.py",
    "services/rgw_push.py", "services/rgw.py", "services/rgw_zone.py",
    "services/rgw_http.py", "services/rgw_sync.py", "services/rgw_file.py",
    "services/swift.py", "objectstore_tool.py", "tools/monmaptool.py",
    "tools/monstore_tool.py", "tools/osdmaptool.py", "dencoder.py",
    "services/rbd_journal.py", "services/rbd.py", "services/rbd_group.py",
    "services/rbd_mirror.py", "services/rbd_pwl.py", "cli.py",
    "rbd_tool.py", "rgw_admin.py", "mds/daemon.py", "client/fs.py",
    "services/volumes.py", "cephfs_journal_tool.py",
    "cephfs_data_scan.py"])
def test_public_names_equal_the_references(rel):
    """Each module of the manager's, the gateway's, the block and CLI and
    the CephFS slices defines the reference's public classes and functions
    (tools/__init__.py and mds/__init__.py define none: COPIED holds them
    equal)."""
    import importlib

    name = rel[:-3].replace("/", ".")
    port = importlib.import_module(f"ceph_tpu_torch.{name}")
    ref = importlib.import_module(f"ceph_tpu.{name}")
    assert _public(port) == _public(ref) != []


@pytest.mark.parametrize("pkg", ["services", "testing"])
def test_package_exports_name_the_ports_modules(pkg):
    """``testing`` and ``services`` export what the references do: object
    classes, the mgr, the gateway, block images and groups."""
    import importlib

    port = importlib.import_module(f"ceph_tpu_torch.{pkg}")
    ref = importlib.import_module(f"ceph_tpu.{pkg}")
    assert port.__all__ == ref.__all__
    for n in port.__all__:
        assert getattr(port, n).__module__.startswith("ceph_tpu_torch."), n


async def _schedule_and_subvolumes(root):
    """On package ``root``'s dev cluster (one mon, three OSD daemons, an
    MDS): the snapshot schedule module run twice on a schedule due now
    (one snapshot; not due again within its period), then ``fs subvolume
    create`` and ``ls`` through the CLI's handler."""
    import contextlib
    import importlib
    import io
    import json

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    device = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    mod("msg").reset_local_namespace()
    cluster = mod("vstart").DevCluster(n_mons=1, n_osds=3, **device)
    await cluster.start()
    try:
        rados = await cluster.client()
        for pool in ("cephfs_meta", "cephfs_data"):
            await rados.pool_create(pool, pg_num=4)
        await cluster.start_mds(block_size=4096)
        fs = await mod("client.fs").CephFS.connect(rados)
        await fs.mount()
        await fs.mkdirs("/data")
        await fs.write_file("/data/f", b"x" * 5000)
        r = await rados.mon_command(
            "config-key set", key="snap_sched/data",
            value=json.dumps({"period": 3600.0, "retain": 2}))
        assert r["rc"] == 0, r

        class Mgr:
            name = "client.admin"
            conf = cluster.conf_for("client.admin")
            monc = rados.monc

        sched = mod("services.mgr_modules").SnapSchedule(Mgr())
        await sched.serve_once()
        await sched.serve_once()
        snaps = sorted(await fs.listsnaps("/data"))
        in_snap = await fs.read_file(f"/data/.snap/{snaps[0]}/f")
        status = dict(sched._status["/data"])
        await sched.stop()
        cli = mod("cli")
        out = {}
        for argv in (["fs", "subvolume", "create", "sv", "--size", "65536"],
                     ["fs", "subvolume", "ls"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = await cli._fs_volumes(
                    rados, cli.build_parser().parse_args(argv), True)
            out[argv[2]] = (rc, json.loads(buf.getvalue()))
        await fs.unmount()
        await rados.shutdown()
        return {"snaps": [n.split("-")[0] for n in snaps],
                "in_snap": in_snap, "last": status.pop("last") > 0,
                "status": status, "volumes": out}
    finally:
        await cluster.stop()
        mod("msg").reset_local_namespace()


def test_snap_schedule_and_subvolumes_answer_on_both_packages():
    """The lazy reaches that waited for CephFS: a due snapshot schedule
    (the mgr's ``SnapSchedule``, which mounts the filesystem) takes one
    snapshot and keeps it, and the CLI's ``fs subvolume`` handler creates
    and lists a subvolume; both packages give equal results."""
    port = asyncio.run(_schedule_and_subvolumes("ceph_tpu_torch"))
    ref = asyncio.run(_schedule_and_subvolumes("ceph_tpu"))
    assert port == ref
    assert port["snaps"] == ["scheduled"] and port["in_snap"] == b"x" * 5000
    assert port["status"] == {"period": 3600.0, "retain": 2,
                              "scheduled_snaps": 1}
    assert port["volumes"] == {
        "create": (0, {"path": "/volumes/_nogroup/sv"}), "ls": (0, ["sv"])}


# The manager's slice: a port DevCluster of one mon and three OSD daemons
# on the CPU with a mgr (dashboard, orchestrator), an EC pool served by a
# closed-loop load generator, the digest's utilization section, the scrape,
# and the SLO, QoS and TSDB engines on an explicit clock.
BLOCKED_MGR_RUN = BLOCKER + r"""
import asyncio
import torch
torch.cuda.is_available = lambda: False
import ceph_tpu_torch.services as services
from ceph_tpu_torch.common.config import ConfigProxy
from ceph_tpu_torch.common.qos import QoSController
from ceph_tpu_torch.common.slo import SLOEngine, parse_slo_targets
from ceph_tpu_torch.common.tsdb import TSDB
from ceph_tpu_torch.testing.loadgen import LoadGen, RadosBackend
from ceph_tpu_torch.vstart import DevCluster

async def run():
    cluster = DevCluster(n_mons=1, n_osds=3, device="cpu")
    await cluster.start()
    try:
        mgr = await cluster.start_mgr(dashboard=True, orchestrate=True)
        assert isinstance(mgr, services.Mgr)
        rados = await cluster.client()
        r = await rados.mon_command("osd erasure-code-profile set", name="p",
                                    profile={"plugin": "jax_rs", "k": "2",
                                             "m": "1",
                                             "crush-failure-domain": "osd"})
        assert r["rc"] == 0, r
        await rados.pool_create("ec", pool_type="erasure",
                                erasure_code_profile="p", pg_num=4)
        io = await rados.open_ioctx("ec")
        gen = LoadGen(RadosBackend(io), seed=1, total_ops=40, n_keys=8)
        await gen.populate()
        res = await gen.run()
        assert res["errors"] == 0, res
        digest = await mgr.report()
        assert digest["pools"] and "utilization" in digest
        text = mgr.prometheus_text(await mgr.collect(),
                                   mgr.prometheus_extra())
        assert "ceph_osd_ec_launch_bytes" in text
        await rados.shutdown()
    finally:
        await cluster.stop()

asyncio.run(run())
eng = SLOEngine(parse_slo_targets("put_p99_ms=5"), window=10.0)
eng.observe(0.0, {})
eng.observe(1.0, {})
assert eng.evaluate()[0]["objective"] == "put_p99_ms"
qos = QoSController.from_conf(ConfigProxy())
assert "recovery" in qos.tick(eng.last_eval, eng.snapshot_window())
db = TSDB()
db.observe(0.0, "x", 1.0)
assert db.query("x")["points"] == [[0.0, 1.0]]
""" + CHECK


def test_manager_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_MGR_RUN)


# The gateway's slice: a port DevCluster of one mon and three OSD daemons
# on the CPU with an S3 endpoint over a replicated hot pool and a k=2 m=1
# erasure-coded cold class: a signed PUT and GET through the load
# generator's S3 client, a PUT straight into the cold class, a lifecycle
# transition into it, every body read back.
BLOCKED_RGW_RUN = BLOCKER + r"""
import asyncio, time
import torch
torch.cuda.is_available = lambda: False
from ceph_tpu_torch.testing.loadgen import S3Backend
from ceph_tpu_torch.vstart import DevCluster

async def run():
    cluster = DevCluster(n_mons=1, n_osds=3, device="cpu")
    await cluster.start()
    try:
        fe, users = await cluster.start_rgw(cold_pool="rgw.cold", ec_k=2,
                                            ec_m=1)
        alice = await users.create("alice")
        s3 = S3Backend(fe.host, fe.port, alice["access_key"],
                       alice["secret_key"], bucket="b")
        await s3.ensure_bucket()
        await s3.put("logs/hot", b"h" * 5000)
        gw = fe.rgw
        await gw.put_object("b", "cold", b"c" * 7000, storage_class="COLD")
        await gw.put_lifecycle("b", [
            {"id": "t", "prefix": "logs/", "status": "Enabled",
             "transition_seconds": 1, "transition_class": "COLD"}])
        assert await gw.lc_process(now=time.time() + 5) == \
            {"b": ["logs/hot->COLD"]}
        assert await s3.get("logs/hot") == b"h" * 5000
        got = await gw.get_object("b", "cold")
        assert got["data"] == b"c" * 7000
        assert (await gw.head_object("b", "cold"))["pool"] == "rgw.cold"
    finally:
        await cluster.stop()

asyncio.run(run())
""" + CHECK


def test_gateway_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_RGW_RUN)


# Multisite, Swift, block images and the CLIs: a port realm of two zones
# (one mon and three OSD daemons each, on the CPU) replicating a bucket
# from a to b, a Swift PUT and GET through the TempAuth handshake on zone
# a's gateway, an RBD image written and read back, and the CLI's
# ``rados put``/``get`` through its argv parser into a k=2 m=1 pool.
BLOCKED_MULTISITE_RUN = BLOCKER + r"""
import asyncio, contextlib, io, os, tempfile
import torch
torch.cuda.is_available = lambda: False
from ceph_tpu_torch import cli
from ceph_tpu_torch.services import RBD
from ceph_tpu_torch.services.swift import SwiftFrontend
from ceph_tpu_torch.vstart import DevCluster, MultisiteRealm

async def http(port, method, path, headers=None, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    hdrs = {"host": "x", "content-length": str(len(body)),
            "connection": "close", **(headers or {})}
    head = "\r\n".join([f"{method} {path} HTTP/1.1"]
                       + [f"{k}: {v}" for k, v in hdrs.items()])
    writer.write(head.encode() + b"\r\n\r\n" + body)
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    return (int(lines[0].split(" ")[1]),
            {k.strip().lower(): v.strip() for k, _, v in
             (ln.partition(":") for ln in lines[1:])}, payload)

async def realm_and_swift():
    realm = MultisiteRealm(("a", "b"), n_osds=3, device="cpu")
    await realm.start()
    try:
        a, b = realm.zones["a"]["gw"], realm.zones["b"]["gw"]
        await a.create_bucket("geo")
        await a.put_object("geo", "k", b"x" * 5000)
        loop = asyncio.get_running_loop()
        end = loop.time() + 60
        while True:
            if realm.zones["b"]["orch"].agents:
                lag = (await realm.lag())["b"]
                if lag == {"entries": 0, "bytes": 0} and \
                        "geo" in await b.list_buckets():
                    break
            assert loop.time() < end, "zone b never caught up"
            await asyncio.sleep(0.05)
        assert (await b.get_object("geo", "k"))["data"] == b"x" * 5000
        users = realm.zones["a"]["users"]
        bob = await users.create("bob")
        fe = SwiftFrontend(a, users=users)
        _, port = await fe.start()
        try:
            st, h, _ = await http(port, "GET", "/auth/v1.0", {
                "x-auth-user": "bob:swift", "x-auth-key": bob["secret_key"]})
            assert st == 200, st
            tok = {"x-auth-token": h["x-auth-token"]}
            acct = h["x-storage-url"].split("/v1/", 1)[1]
            st, _, _ = await http(port, "PUT", f"/v1/{acct}/c", tok)
            assert st in (201, 202), st
            st, _, _ = await http(port, "PUT", f"/v1/{acct}/c/o", tok,
                                  b"swift" * 999)
            assert st == 201, st
            st, _, got = await http(port, "GET", f"/v1/{acct}/c/o", tok)
            assert st == 200 and got == b"swift" * 999
        finally:
            await fe.stop()
    finally:
        await realm.stop()

async def block_and_cli():
    cluster = DevCluster(n_mons=1, n_osds=3, device="cpu")
    await cluster.start()
    try:
        rados = await cluster.client()
        await rados.pool_create("rbd", pg_num=8)
        rbd = RBD(await rados.open_ioctx("rbd"))
        await rbd.create("img", 1 << 20, order=16)
        img = await rbd.open("img")
        await img.write(70000, b"block" * 4000)
        assert await img.read(70000, 20000) == b"block" * 4000
        await img.close()
        await rados.shutdown()
        with tempfile.TemporaryDirectory() as d:
            conf = os.path.join(d, "c.json")
            cluster.write_conf(conf)
            src, dst = os.path.join(d, "in"), os.path.join(d, "out")
            with open(src, "wb") as f:
                f.write(os.urandom(9000))

            async def ceph(*argv):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = await cli._run(cli.build_parser().parse_args(
                        ["--conf", conf, *argv]))
                assert rc == 0, (argv, buf.getvalue())

            await ceph("osd", "erasure-code-profile", "set", "p", "k=2",
                       "m=1", "plugin=jax_rs", "crush-failure-domain=osd")
            await ceph("osd", "pool", "create", "ec", "--pg-num", "4",
                       "--pool-type", "erasure", "--profile", "p")
            await ceph("rados", "-p", "ec", "put", "o", src)
            await ceph("rados", "-p", "ec", "get", "o", dst)
            assert open(src, "rb").read() == open(dst, "rb").read()
    finally:
        await cluster.stop()

asyncio.run(realm_and_swift())
asyncio.run(block_and_cli())
""" + CHECK


def test_multisite_block_and_clis_run_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_MULTISITE_RUN)


# CephFS: a port DevCluster of one mon and three OSD daemons on the CPU
# with a k=2 m=1 erasure-coded data pool and two MDSs: a file written and
# read through a mount, the active MDS shut down and its standby taking
# rank 0, the file read through a new mount, ``fs subvolume create``
# through the CLI's handler, and ``cephfs-data-scan scan`` finding the
# file's size and backtrace in the EC pool.
BLOCKED_CEPHFS_RUN = BLOCKER + r"""
import asyncio, contextlib, io, json, os, tempfile
import torch
torch.cuda.is_available = lambda: False
from ceph_tpu_torch import cephfs_data_scan, cli
from ceph_tpu_torch.client.fs import CephFS
from ceph_tpu_torch.vstart import DevCluster

async def active_is(rados, name):
    loop = asyncio.get_running_loop()
    end = loop.time() + 60
    while True:
        r = await rados.mon_command("mds stat")
        act = r["data"]["filesystems"]["cephfs"]["active"]
        if act and act["name"] == name:
            return
        assert loop.time() < end, r
        await asyncio.sleep(0.1)

async def run():
    cluster = DevCluster(n_mons=1, n_osds=3, device="cpu", overrides={
        "mds_beacon_interval": 0.1, "mds_beacon_grace": 1.0})
    await cluster.start()
    try:
        rados = await cluster.client()
        r = await rados.mon_command("osd erasure-code-profile set", name="p",
                                    profile={"plugin": "jax_rs", "k": "2",
                                             "m": "1",
                                             "crush-failure-domain": "osd"})
        assert r["rc"] == 0, r
        await rados.pool_create("cephfs_meta", pg_num=4)
        await rados.pool_create("cephfs_data", pool_type="erasure",
                                erasure_code_profile="p", pg_num=4)
        await cluster.start_mds("a", block_size=4096)
        await active_is(rados, "a")
        await cluster.start_mds("b", block_size=4096)
        fs = await CephFS.connect(rados)
        await fs.mount()
        await fs.mkdirs("/d")
        data = os.urandom(10000)
        await fs.write_file("/d/f", data)
        assert await fs.read_file("/d/f") == data
        await fs.unmount()
        await cluster.mdss.pop("a").shutdown()
        await active_is(rados, "b")
        fs = await CephFS.connect(rados)
        await fs.mount()
        assert await fs.read_file("/d/f") == data
        args = cli.build_parser().parse_args(["fs", "subvolume", "create",
                                              "sv"])
        with contextlib.redirect_stdout(io.StringIO()):
            assert await cli._fs_volumes(rados, args, True) == 0
        assert "sv" in await fs.readdir("/volumes/_nogroup")
        await fs.unmount()
        with tempfile.TemporaryDirectory() as d:
            conf = os.path.join(d, "c.json")
            cluster.write_conf(conf)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = await cephfs_data_scan._run(
                    cephfs_data_scan.build_parser().parse_args(
                        ["--conf", conf, "--block-size", "4096", "scan"]))
            assert rc == 0
            rep = json.loads(buf.getvalue())
            assert [(r["name"], r["size"]) for r in rep.values()
                    if r["name"] == "f"] == [("f", 10000)], rep
        await rados.shutdown()
    finally:
        await cluster.stop()

asyncio.run(run())
""" + CHECK


def test_cephfs_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_CEPHFS_RUN)
