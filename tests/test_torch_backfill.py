"""The port's backfill engine against the JAX package's, on the CPU.

Every scenario of tests/test_backfill_engine.py (plan grouping, the
reservation slots, the persisted cursor, the drain through a stand-in
repair scheduler) runs once per package.  Then one real drain per
package: an EC pool on ``WalStore`` shards, one shard moved to a fresh
store as when the up set changes, and ``BackfillEngine.drain_pg`` pulling
every object through the real ``RepairScheduler`` (``recover_batch``,
class ``backfill``).  Both packages must move the same bytes, attrs and
omap into the new shard, equal to the old shard's, with the same
``backfill_*`` and ``ec_*`` counters.  Tolerance 0.
"""

import asyncio
import importlib

import pytest

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


class Pkg:
    """One package's backfill surface."""

    def __init__(self, root: str):
        self.root = root
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
        self.backfill = mod("osd.backfill")
        self.pg_log = mod("osd.pg_log")
        self.repair = mod("osd.repair")
        self.ec_backend = mod("osd.ec_backend")
        self.PerfCounters = mod("common.perf").PerfCounters
        store = mod("store")
        self.MemStore, self.WalStore = store.MemStore, store.WalStore
        self.Transaction, self.CollectionId, self.GHObject = (
            store.Transaction, store.CollectionId, store.GHObject)
        self.registry = mod("ec.registry").ErasureCodePluginRegistry()
        self.codec_kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}

    def meta_store(self):
        store = self.MemStore()
        asyncio.run(store.queue_transactions(
            self.Transaction().create_collection(self.pg_log.meta_cid(1, 0))))
        return store


PKGS = {name: Pkg(name) for name in PKG_NAMES}


@pytest.fixture(params=PKG_NAMES)
def pkg(request):
    return PKGS[request.param]


def _run(coro):
    return asyncio.run(coro)


# -- plan_motion --------------------------------------------------------------

def test_plan_motion_groups_by_sig_and_dests(pkg):
    moved = {
        1: {0: ([0, 1, 2], [0, 1, 3]),
            4: ([2, 0, 1], [2, 0, 3]),
            7: ([0, 1, 2], [4, 1, 2])},
        2: {1: ([0, 1], [3, 1])},
    }
    plan = pkg.backfill.plan_motion(moved)
    assert plan["moved_pgs"] == 4
    keyed = {(g["sig"], tuple(g["dests"])): g["pgs"]
             for g in plan["groups"]}
    assert keyed[("1", (3,))] == [[1, 0], [1, 4]]
    assert keyed[("1", (4,))] == [[1, 7]]
    assert keyed[("2", (3,))] == [[2, 1]]
    plan = pkg.backfill.plan_motion(moved, sig_of=lambda pool: "ec:k2m1",
                                    dests_of=lambda old, new: [9])
    assert len(plan["groups"]) == 1 and plan["groups"][0]["dests"] == [9]
    assert plan["moved_pgs"] == 4
    assert plan == PKGS["ceph_tpu"].backfill.plan_motion(
        moved, sig_of=lambda pool: "ec:k2m1", dests_of=lambda old, new: [9])


def test_plan_motion_ignores_holes_in_up_rows(pkg):
    plan = pkg.backfill.plan_motion({1: {0: ([0, 1, -1], [0, 1, 2])}})
    assert plan["groups"][0]["dests"] == [2]


# -- BackfillSlots ------------------------------------------------------------

def test_slots_exhaustion_queues_fifo(pkg):
    async def run():
        slots = pkg.backfill.BackfillSlots(max_slots=1)
        assert slots.try_reserve("1.0", epoch=5)
        assert not slots.try_reserve("1.1", epoch=5)
        assert slots.stats() == {"max": 1, "active": {"1.0": 5},
                                 "queued": 0}
        order = []

        async def want(key):
            order.append((key, await slots.reserve(key, epoch=5)))

        t1 = asyncio.ensure_future(want("1.1"))
        t2 = asyncio.ensure_future(want("1.2"))
        await asyncio.sleep(0)
        assert slots.stats()["queued"] == 2
        slots.release("1.0")
        await asyncio.gather(t1)
        assert order == [("1.1", True)]
        slots.release("1.1")
        await asyncio.gather(t2)
        assert order == [("1.1", True), ("1.2", True)]
        slots.release("1.2")
        assert await slots.reserve("1.3", epoch=6) is False
    _run(run())


def test_slots_rereserve_same_key_adopts_epoch(pkg):
    slots = pkg.backfill.BackfillSlots(max_slots=1)
    assert slots.try_reserve("1.0", epoch=5)
    assert slots.try_reserve("1.0", epoch=7)
    assert slots.stats()["active"] == {"1.0": 7}
    assert not slots.preempt_stale("1.0", newer_epoch=7)
    assert slots.preempt_stale("1.0", newer_epoch=8)
    assert slots.stats()["active"] == {}


@pytest.mark.parametrize("how", ["cancel", "preempt"])
def test_slots_waiter_leaves_no_ghost(pkg, how):
    """A queued waiter cancelled by its caller, or preempted by a newer
    epoch, gives its place back; preempting the holder frees its slot."""
    async def run():
        slots = pkg.backfill.BackfillSlots(max_slots=1)
        slots.try_reserve("1.0", epoch=3)
        t = asyncio.ensure_future(slots.reserve("1.1", epoch=3))
        await asyncio.sleep(0)
        if how == "cancel":
            t.cancel()
        else:
            assert slots.preempt_stale("1.1", newer_epoch=4)
        with pytest.raises(asyncio.CancelledError):
            await t
        assert slots.stats()["queued"] == 0
        if how == "cancel":
            slots.release("1.0")
        else:
            assert slots.preempt_stale("1.0", newer_epoch=4)
        assert slots.try_reserve("1.2", epoch=4)
    _run(run())


def test_slots_resize_pumps_waiters(pkg):
    async def run():
        slots = pkg.backfill.BackfillSlots(max_slots=1)
        slots.try_reserve("1.0", epoch=1)
        t = asyncio.ensure_future(slots.reserve("1.1", epoch=1))
        await asyncio.sleep(0)
        slots.resize(2)
        assert await t is True
        assert set(slots.stats()["active"]) == {"1.0", "1.1"}
    _run(run())


# -- cursor persistence -------------------------------------------------------

def test_cursor_roundtrip_and_clear(pkg):
    bf = pkg.backfill
    store = pkg.meta_store()
    assert bf.cursor_load(store, 1, 0) is None
    _run(bf.cursor_save(store, 1, 0, epoch=9, pos="obj-5", moved=6))
    assert bf.cursor_load(store, 1, 0) == {"epoch": 9, "pos": "obj-5",
                                           "moved": 6}
    _run(bf.cursor_clear(store, 1, 0))
    assert bf.cursor_load(store, 1, 0) is None


# -- BackfillEngine over a stand-in scheduler ---------------------------------

class _FakeRepair:
    """Records every drain call (names and mClock class) and reports one
    batch per call."""

    def __init__(self, max_batch_objects=4):
        self.max_batch_objects = max_batch_objects
        self.calls = []

    async def drain(self, backend, rebuild, versions=None,
                    clazz="recovery", stats=None):
        self.calls.append((tuple(sorted(rebuild)), clazz))
        if stats is not None:
            stats["batches"] = 1
            stats["bytes"] = 100 * len(rebuild)
        return set(rebuild)


def _engine(pkg, store=None, max_batch_objects=4):
    perf = pkg.PerfCounters("t")
    repair = _FakeRepair(max_batch_objects=max_batch_objects)
    return pkg.backfill.BackfillEngine(repair, perf, store=store), repair, perf


def test_drain_moves_all_in_batches_as_backfill_class(pkg):
    store = pkg.meta_store()
    eng, repair, perf = _engine(pkg, store)
    rebuild = {f"obj-{i}": [2] for i in range(10)}
    assert _run(eng.drain_pg(None, rebuild, pool=1, ps=0, epoch=7)) == \
        set(rebuild)
    assert [c for _, c in repair.calls] == ["backfill"] * 3
    assert (perf.value("backfill_objects"), perf.value("backfill_batches"),
            perf.value("backfill_bytes")) == (10, 3, 1000)
    assert eng.stats()["drains"] == 1
    assert pkg.backfill.cursor_load(store, 1, 0) is None


def test_preempt_then_resume_moves_no_object_twice(pkg):
    store = pkg.meta_store()
    eng, repair, perf = _engine(pkg, store)
    rebuild = {f"obj-{i:02d}": [3] for i in range(10)}
    epoch_cell = [7]

    def current_epoch():
        if repair.calls:
            epoch_cell[0] = 8
        return epoch_cell[0]

    with pytest.raises(pkg.backfill.BackfillPreempted):
        _run(eng.drain_pg(None, rebuild, pool=1, ps=0, epoch=7,
                          current_epoch=current_epoch))
    moved_first = {n for names, _ in repair.calls for n in names}
    assert len(moved_first) == 4
    assert perf.value("backfill_preempts") == 1
    assert eng.stats()["preempts"] == 1
    assert pkg.backfill.cursor_load(store, 1, 0) == {
        "epoch": 7, "pos": sorted(moved_first)[-1], "moved": 4}
    repair.calls.clear()
    done = _run(eng.drain_pg(None, rebuild, pool=1, ps=0, epoch=7))
    moved_second = {n for names, _ in repair.calls for n in names}
    assert done == moved_second
    assert moved_first | moved_second == set(rebuild)
    assert not moved_first & moved_second
    assert perf.value("backfill_objects") == len(rebuild)
    assert perf.value("backfill_cursor_skipped") == len(moved_first)
    assert perf.value("backfill_cursor_resumes") == 1
    assert eng.stats()["resumes"] == 1
    assert pkg.backfill.cursor_load(store, 1, 0) is None


def test_stale_cursor_from_older_epoch_is_ignored(pkg):
    store = pkg.meta_store()
    eng, repair, perf = _engine(pkg, store)
    _run(pkg.backfill.cursor_save(store, 1, 0, epoch=5, pos="obj-7",
                                  moved=8))
    rebuild = {f"obj-{i}": [2] for i in range(6)}
    assert _run(eng.drain_pg(None, rebuild, pool=1, ps=0, epoch=9)) == \
        set(rebuild)
    assert perf.value("backfill_cursor_resumes") == 0
    assert perf.value("backfill_cursor_skipped") == 0
    assert perf.value("backfill_objects") == 6


def test_gate_pauses_drain_until_cleared(pkg):
    store = pkg.meta_store()

    async def run():
        eng, repair, perf = _engine(pkg, store)
        rebuild = {f"obj-{i}": [2] for i in range(3)}
        gated = [True]
        task = asyncio.ensure_future(eng.drain_pg(
            None, rebuild, pool=1, ps=0, epoch=7, gate=lambda: gated[0]))
        await asyncio.sleep(0.05)
        assert not repair.calls
        assert perf.value("backfill_gated") == 1
        gated[0] = False
        assert await task == set(rebuild)
    _run(run())


def test_gated_drain_still_preempted_by_newer_epoch(pkg):
    store = pkg.meta_store()

    async def run():
        eng, repair, perf = _engine(pkg, store)
        epoch_cell = [7]
        task = asyncio.ensure_future(eng.drain_pg(
            None, {"obj-0": [2]}, pool=1, ps=0, epoch=7,
            current_epoch=lambda: epoch_cell[0], gate=lambda: True))
        await asyncio.sleep(0.05)
        epoch_cell[0] = 8
        with pytest.raises(pkg.backfill.BackfillPreempted):
            await task
        assert not repair.calls
    _run(run())


# -- a real drain: ECBackend on WalStore shards, RepairScheduler --------------

PROFILE = {"k": "4", "m": "2", "technique": "reed_sol_van"}
MOVED = 2
OBJECTS = 10
COUNTERS = ("backfill_objects", "backfill_batches", "backfill_bytes",
            "ec_repair_batches", "ec_repair_objects", "ec_repair_read_bytes",
            "ec_repair_rebuild_bytes", "ec_device_launches",
            "ec_coalesce_launches", "ec_coalesce_ops", "ec_launch_bytes")


def _shard_image(pkg, store, cid, names):
    return {nm: (store.read(cid, pkg.GHObject(1, nm, shard=cid.shard)),
                 store.getattrs(cid, pkg.GHObject(1, nm, shard=cid.shard)),
                 store.omap_get(cid, pkg.GHObject(1, nm, shard=cid.shard)))
            for nm in names}


async def _real_drain(pkg, root):
    codec = pkg.registry.factory("jax_rs", dict(PROFILE), **pkg.codec_kw)
    perf = pkg.PerfCounters("osd")
    stores, shards = {}, {}
    for i in range(codec.get_chunk_count()):
        store = pkg.WalStore(str(root / f"osd{i}"))
        await store.mount()
        cid = pkg.CollectionId(1, 0, shard=i)
        await store.queue_transactions(
            pkg.Transaction().create_collection(cid))
        stores[i] = (store, cid)
        shards[i] = pkg.ec_backend.LocalShard(store, cid, pool=1, shard=i)
    be = pkg.ec_backend.ECBackend(codec, shards, stripe_unit=128, perf=perf,
                                  coalesce=True)
    names = [f"rbd_data.{i:04x}" for i in range(OBJECTS)]
    datas = {nm: bytes((i * 37 + j) % 251 for j in range(3000 + 512 * i))
             for i, nm in enumerate(names)}
    await asyncio.gather(*(be.write(nm, d) for nm, d in datas.items()))
    old_store, cid = stores[MOVED]
    before = _shard_image(pkg, old_store, cid, names)
    # the up set changes: shard MOVED now lives on a fresh store
    new_store = pkg.WalStore(str(root / "new"))
    await new_store.mount()
    await new_store.queue_transactions(
        pkg.Transaction().create_collection(cid))
    be.shards[MOVED] = pkg.ec_backend.LocalShard(new_store, cid, pool=1,
                                                 shard=MOVED)
    sched = pkg.repair.RepairScheduler(perf, max_batch_objects=4)
    meta = pkg.MemStore()
    await meta.queue_transactions(pkg.Transaction().create_collection(
        pkg.pg_log.meta_cid(1, 0)))
    eng = pkg.backfill.BackfillEngine(sched, perf, store=meta)
    done = await eng.drain_pg(be, {nm: [MOVED] for nm in names}, pool=1,
                              ps=0, epoch=11)
    after = _shard_image(pkg, new_store, cid, names)
    reads = await asyncio.gather(*(be.read(nm) for nm in names))
    # the moved shard survives a remount of its store
    for store, _ in stores.values():
        await store.umount()
    await new_store.umount()
    remounted = pkg.WalStore(str(root / "new"))
    await remounted.mount()
    again = _shard_image(pkg, remounted, cid, names)
    await remounted.umount()
    return {"done": sorted(done), "before": before, "after": after,
            "again": again, "reads": reads == [datas[nm] for nm in names],
            "counters": {c: perf.value(c) for c in COUNTERS},
            "engine": eng.stats()}


def test_real_drain_through_the_repair_scheduler(tmp_path):
    runs = {}
    for name in PKG_NAMES:
        (tmp_path / name).mkdir()
        runs[name] = _run(_real_drain(PKGS[name], tmp_path / name))
    ref, port = runs["ceph_tpu"], runs["ceph_tpu_torch"]
    names = [f"rbd_data.{i:04x}" for i in range(OBJECTS)]
    assert port["done"] == names and port["reads"]
    assert port["after"] == port["before"] == port["again"]
    assert port["after"] == ref["after"]
    assert port["counters"] == ref["counters"]
    assert port["counters"]["backfill_objects"] == OBJECTS
    assert port["counters"]["backfill_batches"] >= 1
    assert port["engine"] == ref["engine"]
