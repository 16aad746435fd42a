"""The port's ECBackend on the CPU against the JAX package's, exact.

Every scenario of tests/test_ec_backend.py, tests/test_ec_coalesce.py and
tests/test_ec_resident.py (the chaos run aside) is written once, as a
coroutine over one package's OSD surface (``Pkg``), and run twice: over
the JAX backend and over the port's backend with its codec on the CPU.
Both runs must return the same observables: read-back bytes, every shard
object's stored bytes, attrs (``hinfo``, ``version``) and omap, and the
perf counters the reference tests read.  Tolerance 0.

On the port, "device data" is a CPU tensor, so the resident runs take the
device path and count the same host<->device bytes as the JAX backend.
"""

import asyncio
import math

import numpy as np
import pytest
import torch

COUNTERS = (
    "ec_device_launches", "ec_coalesce_launches", "ec_coalesce_ops",
    "ec_coalesce_pad_waste", "ec_launch_bytes", "ec_resident_h2d_bytes",
    "ec_resident_d2h_bytes", "ec_resident_hits", "ec_resident_misses",
    "ec_resident_evictions", "ec_scrub_launches", "ec_scrub_objects",
    "ec_scrub_batches", "ec_scrub_bytes", "ec_repair_batches",
    "ec_repair_objects", "ec_repair_read_bytes",
    "ec_repair_read_bytes_saved", "ec_repair_rebuild_bytes",
    "ec_repair_plan_hits", "ec_repair_plan_misses", "hedge_issued",
)


class Pkg:
    """One package's OSD surface: "ref" is the JAX package, "port" the
    PyTorch port with its codecs on the CPU."""

    def __init__(self, which):
        self.which = which
        if which == "ref":
            from ceph_tpu.common import failpoint
            from ceph_tpu.ec.registry import ErasureCodePluginRegistry
            from ceph_tpu.osd import ec_backend, repair
            from ceph_tpu.store import device_cache, memstore, types
            from ceph_tpu.store.object_store import Transaction
            self._codec_kw = {}
        else:
            from ceph_tpu_torch.common import failpoint
            from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
            from ceph_tpu_torch.osd import ec_backend, repair
            from ceph_tpu_torch.store import device_cache, memstore, types
            from ceph_tpu_torch.store.object_store import Transaction
            self._codec_kw = {"device": "cpu"}
        self.fp = failpoint
        self.eb = ec_backend
        self.repair = repair
        self.MemStore = memstore.MemStore
        self.Transaction = Transaction
        self.CollectionId = types.CollectionId
        self.GHObject = types.GHObject
        self.DeviceShardCache = device_cache.DeviceShardCache
        self._registry = ErasureCodePluginRegistry()

    def codec(self, plugin="jax_rs", profile=None):
        profile = profile or {"k": "4", "m": "2",
                              "technique": "reed_sol_van"}
        return self._registry.factory(plugin, dict(profile),
                                      **self._codec_kw)

    def cache(self, **kw):
        if self.which == "port":
            kw["device"] = "cpu"
        return self.DeviceShardCache(**kw)

    def dev(self, arr):
        """``arr`` as this package's device data."""
        if self.which == "ref":
            import jax.numpy as jnp
            return jnp.asarray(arr)
        return torch.from_numpy(np.array(arr, np.uint8))

    async def backend(self, plugin="jax_rs", profile=None, unit=128,
                      one_store=False, wrap=None, **kw):
        """An ECBackend over MemStore shards (one store per shard, or
        one shared store), ``unit`` rounded up to the codec's
        alignment."""
        codec = self.codec(plugin, profile)
        if unit is not None:
            align = getattr(codec, "get_alignment", lambda: 1)()
            unit = -(-unit // align) * align
        shared = self.MemStore() if one_store else None
        stores, shards = {}, {}
        for i in range(codec.get_chunk_count()):
            store = shared or self.MemStore()
            cid = self.CollectionId(1, 0, shard=i)
            await store.queue_transactions(
                self.Transaction().create_collection(cid))
            stores[i] = (store, cid)
            shard = self.eb.LocalShard(store, cid, pool=1, shard=i)
            shards[i] = wrap(shard) if wrap else shard
        be = self.eb.ECBackend(codec, shards, stripe_unit=unit, **kw)
        be._t_stores = stores
        be._t_shards = shards
        return be

    async def kill(self, be, name, shards):
        for s in shards:
            store, cid = be._t_stores[s]
            await store.queue_transactions(self.Transaction().remove(
                cid, self.GHObject(1, name, shard=s)))


def host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def snapshot(be):
    """Every shard store's contents through the public readers."""
    out = {}
    seen = set()
    for store, _ in be._t_stores.values():
        if id(store) in seen:
            continue
        seen.add(id(store))
        for cid in store.list_collections():
            for o in store.list_objects(cid):
                out[(str(cid), o.key())] = (
                    store.read(cid, o), dict(store.getattrs(cid, o)),
                    dict(store.omap_get(cid, o)))
    return out


def counters(be):
    return {k: be.perf.value(k) for k in COUNTERS}


def observe(be, **extra):
    return {"stores": snapshot(be), "perf": counters(be), **extra}


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size, np.uint8).tobytes()


def both(scenario, *args):
    """Run ``scenario`` over both packages; their observables must be
    equal.  Returns them."""
    ref = asyncio.run(scenario(Pkg("ref"), *args))
    port = asyncio.run(scenario(Pkg("port"), *args))
    assert port == ref
    return ref


@pytest.fixture(autouse=True)
def _clean_failpoints():
    for which in ("ref", "port"):
        Pkg(which).fp.fp_clear()
    yield
    for which in ("ref", "port"):
        Pkg(which).fp.fp_clear()


def _raises(exc):
    return type(exc).__name__ if isinstance(exc, BaseException) else None


# -- tests/test_ec_backend.py ------------------------------------------------

CAUCHY = {"k": "4", "m": "2", "technique": "cauchy_good"}


async def sc_roundtrip(P):
    be = await P.backend(profile=CAUCHY)
    data = payload(5000)
    meta = await be.write("obj1", data)
    reads = [await be.read("obj1"), await be.read("obj1", 100, 50),
             await be.read("obj1", 4990, 100)]
    assert reads == [data, data[100:150], data[4990:]]
    return observe(be, meta=(meta.size, meta.version), reads=reads)


async def sc_append(P):
    be = await P.backend(profile=CAUCHY)
    a, b = payload(1024, 1), payload(512, 2)
    await be.write("o", a)
    meta = await be.write("o", b, offset=1024)
    got = await be.read("o")
    assert got == a + b
    return observe(be, meta=(meta.size, meta.version), got=got)


async def sc_rmw(P):
    be = await P.backend(profile=CAUCHY)
    data = bytearray(payload(4096, 3))
    await be.write("o", bytes(data))
    await be.write("o", b"X" * 700, offset=1000)
    data[1000:1700] = b"X" * 700
    got = await be.read("o")
    assert got == bytes(data)
    return observe(be, got=got)


async def sc_degraded(P, lost):
    be = await P.backend(profile=CAUCHY)
    data = payload(8192, 4)
    await be.write("o", data)
    await P.kill(be, "o", lost)
    got = await be.read("o")
    assert got == data
    return observe(be, got=got)


async def sc_too_many(P):
    be = await P.backend(profile=CAUCHY)
    await be.write("o", payload(2048, 5))
    await P.kill(be, "o", (0, 1, 2))
    try:
        await be.read("o")
        err = None
    except (P.eb.ShardReadError, IOError) as e:
        err = e
    assert err is not None
    return observe(be, err=_raises(err))


async def sc_recover_shard(P):
    be = await P.backend(profile=CAUCHY)
    data = payload(16384, 6)
    await be.write("o", data)
    store1, cid1 = be._t_stores[1]
    original = store1.read(cid1, P.GHObject(1, "o", shard=1))
    await P.kill(be, "o", (1,))
    nbytes = await be.recover_shard("o", [1])
    assert store1.read(cid1, P.GHObject(1, "o", shard=1)) == original
    assert await be.read("o") == data
    return observe(be, nbytes=nbytes)


async def sc_scrub_corruption(P):
    be = await P.backend(profile=CAUCHY)
    await be.write("o", payload(4096, 7))
    clean = await be.scrub("o")
    store5, cid5 = be._t_stores[5]
    await store5.queue_transactions(P.Transaction().write(
        cid5, P.GHObject(1, "o", shard=5), 10, b"\xff\x00\xff"))
    dirty = await be.scrub("o")
    assert clean["clean"] and not dirty["clean"]
    assert 5 in dirty["parity_inconsistent"]
    return observe(be, reports=[clean, dirty])


async def sc_hinfo(P):
    be = await P.backend(profile=CAUCHY)
    await be.write("a", payload(1024, 8))
    await be.write("a", payload(1024, 9), offset=1024)
    await be.write("b", payload(4096, 10))
    await be.write("b", b"Y" * 100, offset=600)
    ha = await be.shards[0].get_attr("a", P.eb.HINFO_ATTR)
    hb = await be.shards[0].get_attr("b", P.eb.HINFO_ATTR)
    assert ha and hb == b""
    report = await be.scrub("b")
    assert report["clean"]
    return observe(be, hinfo=(ha, hb), report=report)


async def sc_missing_object(P):
    be = await P.backend(profile=CAUCHY)
    try:
        await be.read("ghost")
        err = None
    except KeyError as e:
        err = e
    return observe(be, err=_raises(err))


async def sc_concurrent_serialized(P):
    be = await P.backend(profile=CAUCHY)
    await asyncio.gather(*(
        be.write("o", bytes([i]) * 512, offset=i * 512) for i in range(8)))
    got = await be.read("o")
    assert got == b"".join(bytes([i]) * 512 for i in range(8))
    return observe(be, got=got)


class FailingShard:
    """Wraps a LocalShard; writes fail while .down is True."""

    def __init__(self, inner, err):
        self.inner = inner
        self.err = err
        self.down = False

    async def write_shard(self, *a, **kw):
        if self.down:
            raise self.err("injected shard write failure")
        return await self.inner.write_shard(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


async def sc_stale_shard(P):
    be = await P.backend(profile=CAUCHY,
                         wrap=lambda s: FailingShard(s, P.eb.ShardReadError))
    v1, v2 = payload(4096, 10), payload(4096, 11)
    await be.write("o", v1)
    be._t_shards[1].down = True
    meta = await be.write("o", v2)
    await asyncio.gather(*be._repair_tasks, return_exceptions=True)
    reads = [await be.read("o")]
    be._t_shards[1].down = False
    reads.append(await be.read("o"))
    stale = await be.scrub("o")
    await be.recover_shard("o", [1])
    healed = await be.scrub("o")
    assert reads == [v2, v2] and 1 in stale["stale_version"]
    assert healed["clean"]
    return observe(be, meta=meta.version, reads=reads,
                   reports=[stale, healed])


async def sc_eager_repair(P):
    be = await P.backend(profile=CAUCHY,
                         wrap=lambda s: FailingShard(s, P.eb.ShardReadError))
    await be.write("o", payload(2048, 12))
    be._t_shards[2].down = True
    v2 = payload(2048, 13)
    await be.write("o", v2)
    be._t_shards[2].down = False
    for _ in range(100):
        await asyncio.sleep(0.01)
        report = await be.scrub("o")
        if report["clean"]:
            break
    assert report["clean"]
    got = await be.read("o")
    assert got == v2
    # how many scrubs it took depends on timing: compare the stores only
    return {"stores": snapshot(be), "got": got}


async def sc_remove_unreachable(P):
    be = await P.backend(profile=CAUCHY)
    await be.write("o", payload(512, 14))

    class DeadRemove:
        def __getattr__(self, name):
            async def fail(*a, **kw):
                raise P.eb.ShardReadError("down")
            return fail

    for i in range(be.n):
        be.shards[i] = DeadRemove()
    try:
        await be.remove("o")
        err = None
    except P.eb.ShardReadError as e:
        err = e
    assert err is not None
    return observe(be, err=_raises(err))


BACKEND_SCENARIOS = [sc_roundtrip, sc_append, sc_rmw, sc_too_many,
                     sc_recover_shard, sc_scrub_corruption, sc_hinfo,
                     sc_missing_object, sc_concurrent_serialized,
                     sc_stale_shard, sc_eager_repair, sc_remove_unreachable]


@pytest.mark.parametrize("scenario", BACKEND_SCENARIOS,
                         ids=lambda f: f.__name__[3:])
def test_backend_scenario_matches_reference(scenario):
    both(scenario)


@pytest.mark.parametrize("lost", [(0, 2), (1, 4)], ids=["data", "parity"])
def test_degraded_read_matches_reference(lost):
    both(sc_degraded, lost)


# -- tests/test_ec_coalesce.py -----------------------------------------------

COALESCE_PROFILES = [
    {"k": "4", "m": "2", "technique": "reed_sol_van"},
    {"k": "8", "m": "4", "technique": "reed_sol_van"},
    {"k": "8", "m": "3", "technique": "isa_vandermonde"},
    {"k": "10", "m": "4", "technique": "cauchy_good"},
    {"k": "5", "m": "2", "technique": "liberation", "w": "7"},
]
PROFILE_IDS = lambda p: f"k{p['k']}m{p['m']}_{p['technique']}"  # noqa: E731


async def sc_coalesced_bit_identical(P, profile):
    be = await P.backend(profile=profile, one_store=True)
    rng = np.random.default_rng(11)
    k, chunk = be.k, be.sinfo.chunk_size
    batches = [np.asarray(rng.integers(0, 256, (b, k, chunk)), np.uint8)
               for b in (1, 3, 8, 5, 2, 16, 7, 1)]
    be._inflight_ops = len(batches) + 1
    try:
        coalesced = await asyncio.gather(*(
            be._coalesced_encode(s) for s in batches))
    finally:
        be._inflight_ops = 0
    st = be.coalescer.stats()
    assert st["ops"] == len(batches) and st["launches"] < len(batches)
    enc = []
    for s, got in zip(batches, coalesced):
        want = host(await be._encode_batch(s))
        assert np.array_equal(host(got), want)
        enc.append(want.tobytes())
    full = [host(await be._encode_batch(s)) for s in batches]
    missing = [0, be.k]
    avails = [{i: c[:, i] for i in range(be.n) if i not in missing}
              for c in full]
    be._inflight_ops = len(avails) + 1
    try:
        decs = await asyncio.gather(*(
            be._coalesced_decode(a, missing) for a in avails))
    finally:
        be._inflight_ops = 0
    for c, got in zip(full, decs):
        for w in missing:
            assert np.array_equal(host(got[w]), c[:, w])
    st = be.coalescer.stats()
    return observe(be, enc=enc, stats=st)


@pytest.mark.parametrize("profile", COALESCE_PROFILES, ids=PROFILE_IDS)
def test_coalesced_encode_decode_matches_reference(profile):
    both(sc_coalesced_bit_identical, profile)


async def sc_64_concurrent_writes(P):
    be = await P.backend(one_store=True)
    datas = {f"o{i}": bytes([i]) * 4096 for i in range(64)}
    await asyncio.gather(*(be.write(o, d) for o, d in datas.items()))
    for o, d in datas.items():
        assert await be.read(o) == d
    dump = be.perf.dump()
    assert dump["ec_coalesce_ops"] == 64
    assert dump["ec_coalesce_launches"] <= 64 / 8
    occ = dump["ec_coalesce_occupancy"]
    assert occ["avgcount"] == dump["ec_coalesce_launches"]
    assert occ["sum"] == 64
    assert dump["ec_coalesce_wait_us"]["avgcount"] == 64
    return observe(be, occupancy=(occ["avgcount"], occ["sum"]))


async def sc_serial_writes(P):
    be = await P.backend(one_store=True, coalesce_window_us=200_000.0)
    import time
    t0 = time.perf_counter()
    for i in range(5):
        await be.write("solo", bytes([i]) * 512)
    assert time.perf_counter() - t0 < 1.0
    return observe(be, launches=be.coalescer.stats()["launches"])


async def sc_failpoint_mid_gather(P):
    be = await P.backend(one_store=True)
    P.fp.set_seed(5)
    P.fp.fp_set("ec.shard_write", "error", count=3)
    datas = {f"o{i}": bytes([i + 1]) * 4096 for i in range(32)}
    results = await asyncio.gather(*(
        be.write(o, d) for o, d in datas.items()), return_exceptions=True)
    P.fp.fp_clear()
    failed = sorted(o for o, r in zip(datas, results)
                    if isinstance(r, BaseException))
    assert len(failed) <= 3
    await asyncio.gather(*be._repair_tasks, return_exceptions=True)
    for o, d in datas.items():
        if o not in failed:
            assert await be.read(o) == d
    return observe(be, failed=failed)


async def sc_poisoned_batchmate(P):
    be = await P.backend(one_store=True)
    rng = np.random.default_rng(3)
    chunk = be.sinfo.chunk_size
    good = np.asarray(rng.integers(0, 256, (4, be.k, chunk)), np.uint8)
    bad = np.asarray(rng.integers(0, 256, (2, be.k + 1, chunk)), np.uint8)
    be._inflight_ops = 3
    try:
        res = await asyncio.gather(
            be.coalescer.submit(("enc",), good, 4),
            be.coalescer.submit(("enc",), bad, 2),
            return_exceptions=True)
    finally:
        be._inflight_ops = 0
    want = host(await be._encode_batch(good))
    assert np.array_equal(host(res[0]), want)
    assert isinstance(res[1], BaseException)
    st = be.coalescer.stats()
    assert st["solo_retries"] == 2 and st["failed_ops"] == 1
    return observe(be, stats=st, good=want.tobytes())


async def sc_cancelled_waiter(P):
    be = await P.backend(one_store=True, coalesce_window_us=100_000.0)
    rng = np.random.default_rng(4)
    chunk = be.sinfo.chunk_size
    s1 = np.asarray(rng.integers(0, 256, (2, be.k, chunk)), np.uint8)
    s2 = np.asarray(rng.integers(0, 256, (3, be.k, chunk)), np.uint8)
    be._inflight_ops = 5
    t1 = asyncio.ensure_future(be._coalesced_encode(s1))
    t2 = asyncio.ensure_future(be._coalesced_encode(s2))
    await asyncio.sleep(0.05)
    assert not t1.done() and not t2.done()
    t2.cancel()
    with pytest.raises(asyncio.CancelledError):
        await t2
    be._inflight_ops = 1
    be.coalescer.notify()
    out = host(await t1)
    assert np.array_equal(out, host(await be._encode_batch(s1)))
    st = be.coalescer.stats()
    assert st["cancelled_waiters"] == 1 and st["ops"] == 1
    assert st["pending_ops"] == 0 and st["pending_stripes"] == 0
    be._inflight_ops = 0
    return observe(be, stats=st, out=out.tobytes())


async def sc_shape_buckets(P):
    be = await P.backend(one_store=True, coalesce=False)
    rng = np.random.default_rng(9)
    chunk = be.sinfo.chunk_size
    outs = []
    for b in list(range(1, 33)) + [47, 63, 64, 65, 99, 100]:
        s = np.asarray(rng.integers(0, 256, (b, be.k, chunk)), np.uint8)
        out = host(await be._encode_batch(s))
        assert out.shape == (b, be.n, chunk)
        outs.append(out.tobytes())
    buckets = sorted(be.mesh_stats["encode_buckets"])
    assert len(buckets) <= math.ceil(math.log2(100)) + 1
    assert all(bk & (bk - 1) == 0 for bk in buckets)
    return observe(be, buckets=buckets, outs=outs)


async def sc_decode_grouping(P):
    be = await P.backend(one_store=True)
    rng = np.random.default_rng(13)
    chunk = be.sinfo.chunk_size
    full = [host(await be._encode_batch(np.asarray(
        rng.integers(0, 256, (4, be.k, chunk)), np.uint8)))
        for _ in range(4)]
    jobs = []
    for i, c in enumerate(full):
        missing = [0] if i % 2 == 0 else [1]
        avail = {j: c[:, j] for j in range(be.n) if j not in missing}
        jobs.append((missing, c, be._coalesced_decode(avail, missing)))
    base = be.coalescer.stats()["launches"]
    be._inflight_ops = len(jobs) + 1
    try:
        outs = await asyncio.gather(*(j[2] for j in jobs))
    finally:
        be._inflight_ops = 0
    launches = be.coalescer.stats()["launches"] - base
    assert launches == 2
    for (missing, c, _), got in zip(jobs, outs):
        for w in missing:
            assert np.array_equal(host(got[w]), c[:, w])
    return observe(be, launches=launches)


COALESCE_SCENARIOS = [sc_64_concurrent_writes, sc_serial_writes,
                      sc_failpoint_mid_gather, sc_poisoned_batchmate,
                      sc_cancelled_waiter, sc_shape_buckets,
                      sc_decode_grouping]


@pytest.mark.parametrize("scenario", COALESCE_SCENARIOS,
                         ids=lambda f: f.__name__[3:])
def test_coalesce_scenario_matches_reference(scenario):
    both(scenario)


# -- tests/test_ec_resident.py -----------------------------------------------

RESIDENT_PROFILES = [
    {"k": "4", "m": "2", "technique": "reed_sol_van"},
    {"k": "10", "m": "4", "technique": "cauchy_good"},
    {"k": "5", "m": "2", "technique": "liberation", "w": "7"},
    {"k": "5", "m": "3", "technique": "reed_sol_van", "w": "16"},
]


def _arr(n, fill=0):
    return np.full(n, fill, np.uint8)


async def sc_cache_lru(P):
    cache = P.cache(max_bytes=1024, low_watermark=0.5)
    for i in range(4):
        cache.put("pg", f"o{i}", 0, _arr(256, i), version=1)
    cache.get("pg", "o0", 0)
    cache.put("pg", "o4", 0, _arr(256, 4), version=1)
    assert cache.over_high
    await cache.evict()
    alive = [cache.get("pg", f"o{i}", 0) is not None for i in range(5)]
    assert alive[0] and not alive[1] and cache.evictions == 3
    return {"alive": alive, "stats": cache.stats(), "bytes": cache.bytes}


async def sc_cache_spill(P):
    spilled = {}

    async def spill(oid, shard, data):
        spilled[(oid, shard)] = bytes(data)

    async def bad_spill(oid, shard, data):
        raise OSError("store degraded")

    cache = P.cache(max_bytes=512, low_watermark=0.5)
    cache.put("pg", "a", 0, _arr(256, 7), version=1, dirty=True,
              spill=spill)
    cache.put("pg", "b", 0, _arr(256, 9), version=1, dirty=True,
              spill=spill)
    await cache.flush()
    seen = [dict(spilled), cache.stats()]
    spilled.clear()
    cache.put("pg", "a", 0, _arr(256, 8), version=2, dirty=True,
              spill=spill)
    cache.put("pg", "c", 0, _arr(256, 1), version=1, dirty=True,
              spill=spill)
    await cache.evict(target=0)
    seen += [dict(spilled), cache.stats()]
    cache.put("pg", "d", 0, _arr(256, 3), version=1, dirty=True,
              spill=bad_spill)
    await cache.evict(target=0)
    kept = cache.get("pg", "d", 0, count=False) is not None
    try:
        await cache.flush()
        err = None
    except OSError as e:
        err = e
    assert kept and err is not None
    return {"seen": seen, "err": _raises(err), "stats": cache.stats()}


async def sc_cache_scopes(P):
    cache = P.cache(max_bytes=4096)
    for ns in ("1.0", "1.1"):
        for shard in range(3):
            cache.put(ns, "obj", shard, _arr(64), version=1)
    cache.drop("1.0", "obj", 0)
    cache.bump_version("1.1", "obj", 5)
    versions = [cache.get("1.1", "obj", 2, count=False).version,
                cache.get("1.0", "obj", 1, count=False).version]
    cache.drop_object("1.1", "obj")
    mid = cache.stats(ns="1.1")
    cache.drop_ns("1.0")
    return {"versions": versions, "mid": mid, "bytes": cache.bytes}


@pytest.mark.parametrize("scenario", [sc_cache_lru, sc_cache_spill,
                                      sc_cache_scopes],
                         ids=lambda f: f.__name__[3:])
def test_cache_scenario_matches_reference(scenario):
    both(scenario)


async def sc_resident_corpus(P, profile):
    be = await P.backend(profile=profile, one_store=True, resident=True)
    assert be.resident is not None
    data = payload(5000, 21)            # deliberately unaligned
    await be.write("corpus", data)
    cached = await be.read("corpus")
    await be.resident.evict(target=0)
    stored = await be.read("corpus")
    assert cached == stored == data
    return observe(be, resident=be.resident_stats())


@pytest.mark.parametrize("profile", RESIDENT_PROFILES, ids=PROFILE_IDS)
def test_resident_corpus_matches_reference(profile):
    both(sc_resident_corpus, profile)


async def sc_resident_cycle(P, writeback):
    be = await P.backend(one_store=True, resident=True,
                         resident_writeback=writeback)
    assert be.resident_writeback is writeback
    data = bytearray(bytes(range(256)) * 16)
    await be.write("cyc", bytes(data))
    h2d0 = be.perf.value("ec_resident_h2d_bytes")
    patch = b"\xee" * 96
    await be.write("cyc", patch, offset=700)
    data[700:796] = patch
    if writeback:
        assert be.perf.value("ec_resident_h2d_bytes") - h2d0 == 96
    reads = [await be.read("cyc")]
    await be.flush_resident()
    await be.resident.evict(target=0)
    reads.append(await be.read("cyc"))
    assert reads == [bytes(data)] * 2
    return observe(be, reads=reads, resident=be.resident_stats())


@pytest.mark.parametrize("writeback", [False, True],
                         ids=["writethrough", "writeback"])
def test_resident_cycle_matches_reference(writeback):
    both(sc_resident_cycle, writeback)


async def sc_resident_coherence(P):
    be = await P.backend(one_store=True, resident=True)
    await be.write("gone", b"\x42" * 1024)
    await be.remove("gone")
    entries = be.resident.stats()["entries"]
    try:
        await be.read("gone")
        err = None
    except Exception as e:          # noqa: BLE001
        err = e
    await be.write("attr", b"\x17" * 1024)
    await be.set_attr("attr", "user.x", b"y")
    got = await be.read("attr")
    assert entries == 0 and err is not None and got == b"\x17" * 1024
    return observe(be, err=_raises(err), got=got)


async def sc_mixed_batchmates(P):
    be = await P.backend(one_store=True, resident=True)
    rng = np.random.default_rng(23)
    k, chunk = be.k, be.sinfo.chunk_size
    host_batches = [np.asarray(rng.integers(0, 256, (b, k, chunk)),
                               np.uint8) for b in (2, 1, 4)]
    dev_batches = [P.dev(h) for h in host_batches[::-1]]
    batches = [x for pair in zip(host_batches, dev_batches) for x in pair]
    be._inflight_ops = len(batches) + 1
    try:
        outs = await asyncio.gather(*(
            be._coalesced_encode(s) for s in batches))
    finally:
        be._inflight_ops = 0
    st = be.coalescer.stats()
    assert st["launches"] < len(batches)
    kinds = []
    for src, got in zip(batches, outs):
        want = host(await be._encode_batch(host(src)))
        assert np.array_equal(host(got), want)
        kinds.append((isinstance(src, np.ndarray),
                      isinstance(got, np.ndarray)))
    assert all(a == b for a, b in kinds)
    return observe(be, stats=st, kinds=kinds)


async def sc_resident_and_classic(P):
    res = await P.backend(resident=True)
    cla = await P.backend(resident=False)
    assert cla.resident is None
    datas = {f"o{i}": bytes([i + 1]) * (512 + 128 * i) for i in range(8)}
    await asyncio.gather(*(be.write(o, d) for o, d in datas.items()
                           for be in (res, cla)))
    for o, d in datas.items():
        assert await res.read(o) == d
        assert await cla.read(o) == d
    return {"res": observe(res), "cla": observe(cla)}


RESIDENT_SCENARIOS = [sc_resident_coherence, sc_mixed_batchmates,
                      sc_resident_and_classic]


@pytest.mark.parametrize("scenario", RESIDENT_SCENARIOS,
                         ids=lambda f: f.__name__[3:])
def test_resident_scenario_matches_reference(scenario):
    both(scenario)


# -- the device-resident hinfo path: the device CRC in the write path -------

async def sc_writeback_hinfo(P):
    """Write-back writes compute hinfo through the device CRC: whole
    writes, appends (seeded by the stored hinfo), a mid-object overwrite
    (hinfo dropped) and an overwrite of the first stripe (hinfo of that
    prefix, which scrub checks on the host); a batched scrub verifies
    them."""
    be = await P.backend(one_store=True, resident=True,
                         resident_writeback=True)
    datas = {f"w{i}": payload(4096, 30 + i) for i in range(6)}
    await asyncio.gather(*(be.write(o, d) for o, d in datas.items()))
    await be.write("w0", payload(2048, 40), offset=4096)
    await be.write("w1", b"Z" * 64, offset=1000)
    await be.write("w2", b"Z" * 64, offset=100)     # hinfo of a prefix
    await be.flush_resident()
    hinfos = [await be.shards[0].get_attr(o, P.eb.HINFO_ATTR)
              for o in sorted(datas)]
    assert hinfos[0] and hinfos[1] == b"" and all(hinfos[2:])
    scrub = await be.scrub_batch(sorted(datas))
    assert all(r["clean"] for r in scrub["reports"].values())
    return observe(be, hinfos=hinfos, scrub=scrub)


def test_writeback_hinfo_matches_reference():
    both(sc_writeback_hinfo)


# -- construction -------------------------------------------------------------

def test_backend_runs_on_its_codecs_device():
    be = asyncio.run(Pkg("port").backend(resident=True))
    assert be.device == torch.device("cpu")
    assert be.resident.device == torch.device("cpu")


def test_resident_cache_on_another_device_refused():
    P = Pkg("port")
    cache = P.cache()
    cache.device = torch.device("cuda", 0)   # as if built for the card
    with pytest.raises(ValueError):
        asyncio.run(P.backend(resident=cache))
