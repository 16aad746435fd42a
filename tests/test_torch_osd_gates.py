"""The OSD parity gates on the port, each beside the JAX backend's run of
the same scenario, counter-exact on the CPU.

The scenarios are bench.py's cfg6, cfg7, cfg9 and cfg14 (written here
over either package; bench.py itself is the JAX package's), at bench.py's
own sizes.  Each runs over the JAX backend and over the port's backend
(codecs on the CPU); every counter and every byte read back must be
equal, wall times aside, and the port's run must pass bench.py's gates:

- cfg6: 64 concurrent 4 KiB writes take at least 8x fewer device
  launches with the CoalescedLauncher on than off;
- cfg7: the resident write-back path moves at least 4x fewer
  host<->device bytes than the classic path: 67,072 (the 65,536 client
  bytes up, and the CRC registers of the first round's 64 whole-stripe
  rewrites down, 64 x 6 x 4 bytes) against 1,310,720;
- cfg9: ``recover_batch`` takes at least 8x fewer launches than a
  per-object ``recover_shard`` drain, and LRC's and CLAY's locality
  reads are at least 1.5x smaller than whole-chunk reads (3.0, 2.91);
- cfg14: a batched scrub of 64 objects takes 2 launches against 64.

A pool written by one package's backend is also carried into the other's
stores (``ceph_tpu_torch.store.state``) and served there.
"""

import asyncio

import numpy as np
import pytest

from test_torch_ec_backend import Pkg, payload, snapshot


def _both(scenario, *args):
    ref = asyncio.run(scenario(Pkg("ref"), *args))
    port = asyncio.run(scenario(Pkg("port"), *args))
    assert port == ref
    return port


# -- cfg6: cross-op coalescing ----------------------------------------------

async def cfg6(P, n_writes=64, write_bytes=4096):
    out = {}
    for label, coalesce in (("on", True), ("off", False)):
        be = await P.backend(coalesce=coalesce)
        await be.write("warmup", b"\x5a" * 512)
        warm = be.perf.value("ec_device_launches")
        datas = {f"obj-{i}": bytes([i % 256]) * write_bytes
                 for i in range(n_writes)}
        await asyncio.gather(*(be.write(o, d) for o, d in datas.items()))
        for o, d in datas.items():
            assert await be.read(o) == d
        out[f"launches_{label}"] = be.perf.value("ec_device_launches") - warm
        out[f"stores_{label}"] = snapshot(be)
        if coalesce:
            out["stats"] = be.coalescer.stats()
            out["pad_waste"] = be.perf.value("ec_coalesce_pad_waste")
    return out


def test_cfg6_coalescing_gate_matches_reference():
    got = _both(cfg6)
    assert got["launches_off"] >= 8 * got["launches_on"], got["stats"]
    assert got["stats"]["ops"] == 65          # the warm-up write and 64


# -- cfg7: device residency ---------------------------------------------------

async def cfg7(P, n_objects=64, object_bytes=16384, sub_write_bytes=512,
               rounds=2):
    out = {}
    for label, resident in (("resident", True), ("classic", False)):
        be = await P.backend(profile={"k": "4", "m": "2",
                                      "technique": "cauchy_good"},
                             unit=1024, resident=resident,
                             resident_writeback=resident)
        datas = {f"obj-{i}": bytearray(bytes([i % 256]) * object_bytes)
                 for i in range(n_objects)}
        await asyncio.gather(*(be.write(o, bytes(d))
                               for o, d in datas.items()))
        h2d0 = be.perf.value("ec_resident_h2d_bytes")
        d2h0 = be.perf.value("ec_resident_d2h_bytes")
        for r in range(rounds):
            off = 512 + r * 4096
            patch = bytes([0xA0 + r]) * sub_write_bytes
            await asyncio.gather(*(be.write(o, patch, offset=off)
                                   for o in datas))
            for d in datas.values():
                d[off:off + sub_write_bytes] = patch
        h2d = be.perf.value("ec_resident_h2d_bytes") - h2d0
        d2h = be.perf.value("ec_resident_d2h_bytes") - d2h0
        if be.resident is not None:
            await be.flush_resident()
            await be.resident.evict(target=0)
            out["resident_stats"] = be.resident_stats()
        for o, d in datas.items():
            assert await be.read(o) == bytes(d)
        out[f"xfer_bytes_{label}"] = (h2d, d2h)
        out[f"stores_{label}"] = snapshot(be)
    return out


def test_cfg7_residency_gate_matches_reference():
    got = _both(cfg7)
    resident = sum(got["xfer_bytes_resident"])
    classic = sum(got["xfer_bytes_classic"])
    assert got["xfer_bytes_resident"] == (65536, 1536)
    assert (resident, classic) == (67072, 1310720)
    assert classic >= 4 * resident


# -- cfg9: batched locality-aware repair -------------------------------------

async def _seed(P, be, nobj, lost, object_bytes):
    originals, true_shards = {}, {}
    for i in range(nobj):
        data = (i % 251).to_bytes(1, "big") * object_bytes
        originals[f"obj-{i}"] = data
        await be.write(f"obj-{i}", data)
    for name in originals:
        for s in lost:
            true_shards[(name, s)] = await be.shards[s].read_shard(name)
        await P.kill(be, name, lost)
    return originals, true_shards


async def _verify(be, originals, true_shards, lost, client_read=True):
    for name, data in originals.items():
        for s in lost:
            assert await be.shards[s].read_shard(name) == \
                true_shards[(name, s)]
        if client_read:
            assert await be.read(name) == data


async def cfg9_rs(P, n_objects=256, object_bytes=4096):
    out = {}
    rs = {"k": "4", "m": "2", "technique": "reed_sol_van"}
    lost = [1, 4]
    for label in ("per_object", "batched"):
        P.repair.clear_plan_cache()
        be = await P.backend(profile=rs)
        originals, true_shards = await _seed(P, be, n_objects, lost,
                                             object_bytes)
        base = be.perf.value("ec_device_launches")
        if label == "per_object":
            for name in originals:
                await be.recover_shard(name, lost)
        else:
            res = await be.recover_batch(list(originals), lost, {})
            assert set(res["recovered"]) == set(originals)
            out["result"] = res
        out[f"launches_{label}"] = be.perf.value("ec_device_launches") - base
        await _verify(be, originals, true_shards, lost)
        out[f"stores_{label}"] = snapshot(be)
    return out


def test_cfg9_batched_repair_gate_matches_reference():
    got = _both(cfg9_rs)
    assert got["launches_per_object"] >= 8 * got["launches_batched"]


LOCALITY = [("lrc", {"k": "12", "m": "4", "l": "4"}, 3, 3.0),
            ("clay", {"k": "8", "m": "4", "d": "11"}, 3, 2.91)]


async def cfg9_locality(P, tag, profile, single, object_bytes=4096):
    P.repair.clear_plan_cache()
    be = await P.backend(tag, profile, unit=None)
    originals, true_shards = await _seed(P, be, 64, [single], object_bytes)
    res = await be.recover_batch(list(originals), [single], {})
    assert res["strategy"] == tag
    await _verify(be, originals, true_shards, [single],
                  client_read=(tag == "clay"))
    read = be.perf.value("ec_repair_read_bytes")
    saved = be.perf.value("ec_repair_read_bytes_saved")
    return {"result": res, "read": read, "saved": saved,
            "launches": be.perf.value("ec_device_launches"),
            "stores": snapshot(be)}


@pytest.mark.parametrize("tag,profile,single,ratio", LOCALITY,
                         ids=[t[0] for t in LOCALITY])
def test_cfg9_locality_read_gate_matches_reference(tag, profile, single,
                                                   ratio):
    got = _both(cfg9_locality, tag, profile, single)
    reduction = round((got["read"] + got["saved"]) / got["read"], 2)
    assert reduction == ratio and reduction >= 1.5


TECHNIQUES = [
    ({"k": "4", "m": "2", "technique": "reed_sol_van"}, [1, 4], 128),
    ({"k": "4", "m": "2", "technique": "cauchy_good"}, [1, 4], 128),
    ({"k": "4", "m": "2", "technique": "isa_vandermonde"}, [1, 4], 128),
    ({"k": "5", "m": "2", "technique": "liberation", "w": "7"}, [1, 5],
     None),
]


async def cfg9_technique(P, profile, lost, unit):
    P.repair.clear_plan_cache()
    be = await P.backend(profile=profile, unit=unit)
    originals, true_shards = await _seed(P, be, 16, lost, 4096)
    res = await be.recover_batch(list(originals), lost, {})
    assert set(res["recovered"]) == set(originals)
    await _verify(be, originals, true_shards, lost)
    return {"result": res, "stores": snapshot(be),
            "launches": be.perf.value("ec_device_launches")}


@pytest.mark.parametrize("profile,lost,unit", TECHNIQUES,
                         ids=[t[0]["technique"] for t in TECHNIQUES])
def test_cfg9_techniques_bit_identical_to_reference(profile, lost, unit):
    _both(cfg9_technique, profile, lost, unit)


# -- cfg14: batched deep scrub ------------------------------------------------

async def cfg14(P, seed=0, objects=64, obj_size=4096):
    be = await P.backend(one_store=True)
    rng = np.random.default_rng(seed)
    names = [f"s{i:03d}" for i in range(objects)]
    for name in names:
        await be.write(name,
                       rng.integers(0, 256, obj_size, np.uint8).tobytes())
    before = be.perf.value("ec_scrub_launches")
    batched = await be.scrub_batch(names)
    batched_launches = be.perf.value("ec_scrub_launches") - before
    before = be.perf.value("ec_scrub_launches")
    oracle = {name: await be.scrub(name) for name in names}
    oracle_launches = be.perf.value("ec_scrub_launches") - before
    assert all(batched["reports"][n] == oracle[n] for n in names)
    assert all(r["clean"] for r in oracle.values())
    return {"batched": batched, "batched_launches": batched_launches,
            "oracle_launches": oracle_launches}


def test_cfg14_scrub_gate_matches_reference():
    got = _both(cfg14)
    assert (got["batched_launches"], got["oracle_launches"]) == (2, 64)
    assert got["batched"]["groups"] == 1


async def scrub_flags_one_bit(P, resident):
    """One bit flipped at rest (MemStore.corrupt_shard under its
    failpoint) is flagged on exactly that object and shard."""
    be = await P.backend(one_store=True, resident=resident,
                         resident_writeback=resident)
    names = [f"c{i}" for i in range(8)]
    for i, name in enumerate(names):
        await be.write(name, payload(2048, 50 + i))
    await be.flush_resident()
    if resident:
        await be.resident.evict(target=0)
    P.fp.fp_set("store.corrupt_shard", "error", count=1)
    store, cid = be._t_stores[2]
    flip = store.corrupt_shard(cid, P.GHObject(1, "c5", shard=2),
                               offset=33, mask=4)
    P.fp.fp_clear()
    out = await be.scrub_batch(names)
    bad = {n: r for n, r in out["reports"].items() if not r["clean"]}
    assert list(bad) == ["c5"] and bad["c5"]["crc_mismatch"] == [2]
    return {"flip": flip, "reports": out["reports"],
            "launches": be.perf.value("ec_scrub_launches")}


@pytest.mark.parametrize("resident", [False, True],
                         ids=["classic", "resident"])
def test_scrub_flags_a_flipped_bit_like_reference(resident):
    _both(scrub_flags_one_bit, resident)


# -- state across packages ---------------------------------------------------

PROFILE = {"k": "4", "m": "2", "technique": "reed_sol_van"}


async def _write_pool(P, datas):
    be = await P.backend(profile=PROFILE)
    for name, data in datas.items():
        await be.write(name, data)
    await be.write("o1", b"P" * 300, offset=700)        # an overwrite
    return be


def _carry(be, into):
    """Rebuild ``be``'s shard stores as the other package's stores."""
    from ceph_tpu_torch.store import state

    stores = {}
    for i, (store, cid) in be._t_stores.items():
        dump = state.dump_memstore(store)
        cid = into.CollectionId(cid.pool, cid.pg, cid.shard)
        if into.which == "port":
            stores[i] = (state.memstore_from_dump(dump), cid)
        else:                       # a JAX MemStore built from the dump
            ref = into.MemStore()
            t = into.Transaction()
            for ckey, objs in dump.items():
                c = into.CollectionId(*ckey)
                t.create_collection(c)
                for okey, (data, attrs, omap) in objs.items():
                    o = into.GHObject(*okey)
                    t.touch(c, o).write(c, o, 0, data)
                    for name, value in attrs.items():
                        t.setattr(c, o, name, value)
                    if omap:
                        t.omap_setkeys(c, o, omap)
            ref.apply_transactions(t)
            stores[i] = (ref, cid)
    return stores


async def _serve(P, stores, datas):
    codec = P.codec(profile=PROFILE)
    shards = {i: P.eb.LocalShard(store, cid, pool=1, shard=i)
              for i, (store, cid) in stores.items()}
    be = P.eb.ECBackend(codec, shards, stripe_unit=128)
    be._t_stores = stores
    reads = {n: await be.read(n) for n in datas}
    await P.kill(be, "o0", (0, 3))
    degraded = await be.read("o0")
    scrub = await be.scrub_batch(sorted(set(datas) - {"o0"}))
    assert all(r["clean"] for r in scrub["reports"].values())
    return reads, degraded, scrub


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")],
                         ids=["jax_to_port", "port_to_jax"])
def test_pool_carried_across_packages(writer, reader):
    datas = {f"o{i}": payload(1000 + 512 * i, 60 + i) for i in range(5)}
    want = dict(datas)
    want["o1"] = want["o1"][:700] + b"P" * 300 + want["o1"][1000:]
    be = asyncio.run(_write_pool(Pkg(writer), datas))
    stores = _carry(be, Pkg(reader))
    reads, degraded, scrub = asyncio.run(_serve(Pkg(reader), stores,
                                                datas))
    assert reads == want and degraded == want["o0"]
    assert scrub["groups"] >= 1


def test_state_round_trip():
    from ceph_tpu_torch.store import state

    P = Pkg("port")
    be = asyncio.run(_write_pool(P, {"a": payload(3000, 1)}))
    store = be._t_stores[0][0]
    t = P.Transaction()
    cid = P.CollectionId(1, 0, shard=0)
    t.omap_setkeys(cid, P.GHObject(1, "a", shard=0), {"k": b"v"})
    t.create_collection(P.CollectionId(2, 7))
    store.apply_transactions(t)
    dump = state.dump_memstore(store)
    again = state.dump_memstore(state.memstore_from_dump(dump))
    assert again == dump
    assert dump[(2, 7, -1)] == {}
    obj = dump[(1, 0, 0)][(1, "a", -2, 0xFFFFFFFFFFFFFFFF, 0)]
    assert obj[0] and obj[1]["version"] and obj[2] == {"k": b"v"}
