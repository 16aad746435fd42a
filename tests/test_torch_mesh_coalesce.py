"""The port's host mesh coalescer against the JAX package's, exact.

Every case of tests/test_ec_mesh_coalesce.py, then bench.py's cfg8 arms
at their own sizes and scripts/tier1.sh's mesh smoke (a 3-OSD dev
cluster with ``osd_ec_mesh_coalesce`` on), each written once over one
package's surface and run on both: the JAX package on its 8 forced CPU
devices (tests/conftest.py), the port on 8 slots forced over the CPU
(``parallel.mesh.force_device_count(8, device="cpu")``), the same seeded
numpy inputs to both.  Results, shard layouts, plane counters and the
repair planes' interconnect counters must be equal; launch counts that
depend on when ops arrive are held to the reference's bounds on each.
Tolerance 0.
"""

import asyncio
import importlib

import numpy as np
import pytest
import torch

from tests.test_torch_ec_backend import Pkg, host

# the four dense GF(2^8) techniques of the corpus matrix (bit-schedule
# codes have generator=None and keep the per-backend launcher)
MESH_PROFILES = [
    {"k": "4", "m": "2", "technique": "reed_sol_van"},
    {"k": "8", "m": "3", "technique": "isa_vandermonde"},
    {"k": "10", "m": "4", "technique": "cauchy_good"},
    {"k": "6", "m": "3", "technique": "isa_cauchy"},
]
NDEV = 8


class MeshPkg(Pkg):
    """Pkg plus the package's mesh planes."""

    def __init__(self, which):
        super().__init__(which)
        root = "ceph_tpu" if which == "ref" else "ceph_tpu_torch"
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
        self.mc = mod("osd.mesh_coalesce")
        self.es = mod("parallel.ec_sharding")

    def devices(self):
        if self.which == "ref":
            import jax
            return jax.devices()
        from ceph_tpu_torch.parallel.mesh import local_devices
        return local_devices("cpu")


PKGS = {"ref": MeshPkg("ref"), "port": MeshPkg("port")}


@pytest.fixture(autouse=True)
def _eight_slots():
    from ceph_tpu_torch.parallel import mesh

    with mesh.forced_device_count(NDEV, device="cpu"):
        for P in PKGS.values():
            P.mc.reset_host_coalescer()
        yield
        for P in PKGS.values():
            P.mc.reset_host_coalescer()


def both(scenario, *args):
    """``scenario(P, *args)`` on the JAX package, then on the port; the
    two results must be equal."""
    out = {w: asyncio.run(scenario(P, *args)) for w, P in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["ref"]


def rand(seed, shape):
    return np.asarray(np.random.default_rng(seed).integers(0, 256, shape),
                      np.uint8)


def mesh_counters(be):
    return {k: be.perf.value(k) for k in (
        "ec_mesh_launches", "ec_mesh_ops", "ec_mesh_ici_bytes",
        "ec_mesh_ici_whole_bytes", "ec_resident_h2d_bytes",
        "ec_resident_d2h_bytes", "ec_coalesce_pad_waste",
        "ec_device_launches")}


def plane_stats(st):
    """A coalescer's stats without what depends on when ops arrive."""
    return {k: v for k, v in st.items() if k not in ("launches", "ops",
                                                     "occupancy")}


# ---------------------------------------------------------------------------
# tests/test_ec_mesh_coalesce.py

async def sc_cross_osd(P):
    co = P.mc.MeshCoalescer()
    be1 = await P.backend(mesh_coalescer=co)
    be2 = await P.backend(mesh_coalescer=co)
    assert be1.mesh_co is co and be2.mesh_co is co
    k, chunk = be1.k, be1.sinfo.chunk_size
    b1, b2 = rand(7, (5, k, chunk)), rand(8, (3, k, chunk))
    be1._inflight_ops = be2._inflight_ops = 2
    try:
        o1, o2 = await asyncio.gather(
            be1._coalesced_encode(b1), be2._coalesced_encode(b2))
    finally:
        be1._inflight_ops = be2._inflight_ops = 0
    st = co.stats()
    assert st["launches"] == 1 and st["ops"] == 2, st
    assert st["cross_backend_launches"] == 1, st
    # the proof the batch really fans out: REAL addressable-shard
    # layouts, every device holding rows, summing to the bucket
    assert len(st["last_per_device"]) == NDEV, st
    assert all(r > 0 for r in st["last_per_device"].values())
    assert sum(st["last_per_device"].values()) == 8  # pow2(5+3)
    w1 = await be1._encode_batch(b1)
    w2 = await be2._encode_batch(b2)
    assert np.array_equal(host(o1), host(w1))
    assert np.array_equal(host(o2), host(w2))
    assert (be1.perf.value("ec_mesh_launches")
            + be2.perf.value("ec_mesh_launches")) == 1
    assert (be1.perf.value("ec_mesh_ops")
            + be2.perf.value("ec_mesh_ops")) == 2
    return (host(o1).tobytes(), host(o2).tobytes(), st,
            mesh_counters(be1), mesh_counters(be2))


def test_cross_osd_ops_share_one_sharded_launch():
    both(sc_cross_osd)


async def sc_all_techniques(P, profile):
    co = P.mc.MeshCoalescer()
    be = await P.backend(profile=profile, mesh_coalescer=co)
    assert be.mesh_co is co and be._mesh_dec_ok
    k, chunk = be.k, be.sinfo.chunk_size
    batches = [rand(11 + i, (b, k, chunk))
               for i, b in enumerate((1, 3, 8, 5, 2, 16, 7, 1))]
    be._inflight_ops = len(batches) + 1
    try:
        outs = await asyncio.gather(*(
            be._coalesced_encode(s) for s in batches))
    finally:
        be._inflight_ops = 0
    assert co.stats()["launches"] < len(batches)
    for s, got in zip(batches, outs):
        want = await be._encode_batch(s)
        assert np.array_equal(host(got), host(want))
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
    return ([host(o).tobytes() for o in outs],
            [{w: host(d[w]).tobytes() for w in missing} for d in decs],
            plane_stats(co.stats()), be.mesh_stats)


@pytest.mark.parametrize(
    "profile", MESH_PROFILES,
    ids=lambda p: f"k{p['k']}m{p['m']}_{p['technique']}")
def test_sharded_bit_identity_all_techniques(profile):
    both(sc_all_techniques, profile)


async def sc_solo(P):
    import time

    co = P.mc.MeshCoalescer(window_us=200_000.0)
    be = await P.backend(mesh_coalescer=co)
    s = rand(3, (4, be.k, be.sinfo.chunk_size))
    t0 = time.perf_counter()
    out = await be._coalesced_encode(s)
    assert time.perf_counter() - t0 < 1.0
    want = await be._encode_batch(s)
    assert np.array_equal(host(out), host(want))
    st = co.stats()
    assert st["launches"] == 1 and st["ops"] == 1
    assert st["cross_backend_launches"] == 0
    return host(out).tobytes(), st


def test_solo_op_flushes_alone():
    both(sc_solo)


async def sc_one_device(P):
    co = P.mc.MeshCoalescer(devices=P.devices()[:1])
    be = await P.backend(mesh_coalescer=co)
    assert be.mesh_co is None
    assert be.coalescer is not None
    await be.write("obj", b"x" * 4096)
    assert await be.read("obj") == b"x" * 4096
    assert co.stats()["launches"] == 0
    assert be.coalescer.stats()["launches"] > 0
    return co.stats(), be.coalescer.stats()["launches"]


def test_one_device_mesh_degrades_to_backend_launcher():
    both(sc_one_device)


async def sc_no_generator(P):
    co = P.mc.MeshCoalescer()
    be = await P.backend("clay", {"k": "4", "m": "2", "d": "5"},
                         unit=1024, mesh_coalescer=co)
    assert be.mesh_co is None and be._mesh_host is co
    return co.stats()["backends"]


def test_codec_without_generator_keeps_backend_launcher():
    assert both(sc_no_generator) == 0


async def sc_resident_no_h2d(P):
    co = P.mc.MeshCoalescer()
    be = await P.backend(mesh_coalescer=co, resident=True)
    assert be.resident is not None and be.mesh_co is co
    h = rand(5, (8, be.k, be.sinfo.chunk_size))
    h2d0 = be.perf.value("ec_resident_h2d_bytes")
    d2h0 = be.perf.value("ec_resident_d2h_bytes")
    out = await be._coalesced_encode(P.dev(h))
    assert be._is_device(out)
    assert be.perf.value("ec_resident_h2d_bytes") == h2d0
    assert be.perf.value("ec_resident_d2h_bytes") == d2h0
    want = await be._encode_batch(h)
    assert np.array_equal(host(out), host(want))
    assert co.stats()["launches"] == 1
    return host(out).tobytes(), co.stats(), mesh_counters(be)


def test_resident_device_batch_feeds_sharded_launch_no_h2d():
    both(sc_resident_no_h2d)


def test_resident_batch_moves_no_bytes_between_slots():
    """On the port the zero-h2d claim is read off the mesh's own
    traffic counters too: a device batch is split into views, so
    nothing is uploaded, moved or copied between slots."""
    from ceph_tpu_torch.parallel import mesh

    mesh.reset_traffic()
    asyncio.run(sc_resident_no_h2d(PKGS["port"]))
    assert mesh.TRAFFIC == {"host": 0, "place": 0, "slot": 0}


async def sc_mixed(P):
    co = P.mc.MeshCoalescer()
    be1 = await P.backend(mesh_coalescer=co, resident=True)
    be2 = await P.backend(mesh_coalescer=co)
    k, chunk = be1.k, be1.sinfo.chunk_size
    h1, h2 = rand(9, (4, k, chunk)), rand(10, (2, k, chunk))
    be1._inflight_ops = be2._inflight_ops = 2
    try:
        o1, o2 = await asyncio.gather(
            be1._coalesced_encode(P.dev(h1)), be2._coalesced_encode(h2))
    finally:
        be1._inflight_ops = be2._inflight_ops = 0
    assert co.stats()["launches"] == 1
    assert be1._is_device(o1)
    assert isinstance(o2, np.ndarray)
    assert np.array_equal(host(o1), host(await be1._encode_batch(h1)))
    assert np.array_equal(o2, host(await be2._encode_batch(h2)))
    assert be2.perf.value("ec_resident_h2d_bytes") > 0
    assert be2.perf.value("ec_resident_d2h_bytes") > 0
    return (host(o1).tobytes(), o2.tobytes(), mesh_counters(be1),
            mesh_counters(be2))


def test_mixed_host_device_batchmates():
    both(sc_mixed)


async def sc_poisoned(P):
    co = P.mc.MeshCoalescer()
    be = await P.backend(mesh_coalescer=co)
    chunk = be.sinfo.chunk_size
    good = rand(13, (4, be.k, chunk))
    bad = rand(14, (2, be.k + 1, chunk))
    be._inflight_ops = 3
    try:
        res = await asyncio.gather(
            co.submit(be, ("enc",), good, 4),
            co.submit(be, ("enc",), bad, 2),
            return_exceptions=True,
        )
    finally:
        be._inflight_ops = 0
    assert not isinstance(res[0], BaseException), res[0]
    want = await be._encode_batch(good)
    assert np.array_equal(host(res[0]), host(want))
    assert isinstance(res[1], BaseException)
    st = co.stats()
    assert st["solo_retries"] == 2
    assert st["failed_ops"] == 1
    assert st["pending_ops"] == 0
    return host(res[0]).tobytes(), st


def test_poisoned_batchmate_solo_retries():
    both(sc_poisoned)


async def sc_subchunk(P, plugin, profile, lost, unit):
    co = P.mc.MeshCoalescer()
    be = await P.backend(plugin, profile, unit=unit, mesh_coalescer=co)
    data = rand(17, (4, be.k, be.sinfo.chunk_size))
    full = host(await be._encode_batch(data))
    avail = {i: full[:, i] for i in range(be.n) if i != lost}
    out = await be._coalesced_decode(avail, [lost])
    assert np.array_equal(host(out[lost]), full[:, lost])
    assert be.mesh_stats["repairs"] == 1
    moved = be.perf.value("ec_mesh_ici_bytes")
    whole = be.perf.value("ec_mesh_ici_whole_bytes")
    assert moved > 0 and moved * 2 <= whole, (moved, whole)
    assert be.perf.dump()["ec_mesh_launch_us"]["count"] == 1
    # multi-chunk loss takes the classic decode path
    lost2 = [lost, (lost + 1) % be.n]
    avail2 = {i: full[:, i] for i in range(be.n) if i not in lost2}
    out2 = await be._coalesced_decode(avail2, lost2)
    for w in lost2:
        assert np.array_equal(host(out2[w]), full[:, w])
    assert be.mesh_stats["repairs"] == 1   # unchanged
    return (host(out[lost]).tobytes(), moved, whole, be.mesh_stats,
            co.stats()["repair_mesh_grants"])


@pytest.mark.parametrize("plugin,profile,lost,unit,ici", [
    ("clay", {"k": "8", "m": "4", "d": "11"}, 3, 1024, (11264, 32768)),
    ("lrc", {"k": "12", "m": "4", "l": "4"}, 6, 1024, (16384, 49152)),
], ids=["clay_k8m4d11", "lrc_k12m4l4"])
def test_subchunk_repair_moves_less_ici(plugin, profile, lost, unit, ici):
    """bench.py cfg8's exact interconnect counters on both packages:
    CLAY 11,264 of 32,768 whole-chunk bytes, LRC 16,384 of 49,152."""
    got = both(sc_subchunk, plugin, profile, lost, unit)
    assert got[1:3] == ici


async def sc_host_singleton(P):
    P.mc.reset_host_coalescer()
    co = P.mc.host_coalescer()
    be1 = await P.backend(mesh_coalescer=co)
    be2 = await P.backend(mesh_coalescer=co)
    datas1 = {f"o{i}": bytes([i + 1]) * 4096 for i in range(16)}
    datas2 = {f"p{i}": bytes([i + 17]) * 4096 for i in range(16)}
    await asyncio.gather(
        *(be1.write(o, d) for o, d in datas1.items()),
        *(be2.write(o, d) for o, d in datas2.items()))
    for o, d in datas1.items():
        assert await be1.read(o) == d
    for o, d in datas2.items():
        assert await be2.read(o) == d
    st = co.stats()
    assert st["ops"] >= 32
    assert st["launches"] < st["ops"] / 4, st
    assert st["cross_backend_launches"] >= 1, st
    assert len(st["per_device_stripes"]) == NDEV
    return st["ops"], sorted(st["per_device_stripes"])


def test_full_write_read_through_host_singleton():
    both(sc_host_singleton)


# ---------------------------------------------------------------------------
# bench.py's cfg8 arms (_cfg8_mesh_ab), at its sizes

async def sc_cfg8(P):
    rs = {"k": "4", "m": "2", "technique": "reed_sol_van"}
    co = P.mc.MeshCoalescer()
    b1 = await P.backend(profile=rs, mesh_coalescer=co)
    b2 = await P.backend(profile=rs, mesh_coalescer=co)
    datas = {f"obj-{i}": bytes([i % 255 + 1]) * 4096 for i in range(32)}
    await asyncio.gather(*(b1.write(o, d) for o, d in datas.items()),
                         *(b2.write(o, d) for o, d in datas.items()))
    for be in (b1, b2):
        for o, d in datas.items():
            assert await be.read(o) == d
    st = co.stats()
    assert st["cross_backend_launches"] >= 1, st
    assert len(st["per_device_stripes"]) == NDEV
    assert all(r > 0 for r in st["per_device_stripes"].values())
    # SHEC joins the mesh encode plane (generator, no decode_selection)
    bs = await P.backend("shec", {"k": "4", "m": "3", "c": "2"},
                         unit=1024, mesh_coalescer=co)
    assert bs.mesh_co is co and not bs._mesh_dec_ok
    batch = rand(8, (6, bs.k, bs.sinfo.chunk_size))
    shec = host(await bs._coalesced_encode(batch))
    assert np.array_equal(shec, host(await bs._encode_batch(batch)))
    return st["ops"], shec.tobytes()


def test_cfg8_arms():
    both(sc_cfg8)


# ---------------------------------------------------------------------------
# scripts/tier1.sh --mesh-smoke

async def sc_mesh_smoke(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3, overrides={
        "osd_ec_mesh_coalesce": True})
    await cluster.start()
    try:
        rados = await cluster.client()
        r = await rados.mon_command(
            "osd erasure-code-profile set", name="meshsmoke",
            profile={"plugin": "jax_rs", "k": "2", "m": "1",
                     "crush-failure-domain": "osd"})
        assert r["rc"] in (0, -17), r
        await rados.pool_create("mesh", pg_num=8, pool_type="erasure",
                                erasure_code_profile="meshsmoke")
        io = await rados.open_ioctx("mesh")
        datas = {f"obj-{i}": bytes([i]) * 4096 for i in range(64)}
        await asyncio.gather(*(io.write_full(o, d)
                               for o, d in datas.items()))
        for o, d in datas.items():
            assert await io.read(o) == d, o
        replies = {}
        for osd_id in sorted(cluster.osds):
            reply = await rados.osd_daemon_command(osd_id, "ec_mesh_stats")
            reply.pop("tid", None)
            replies[osd_id] = reply
        await rados.shutdown()
    finally:
        await cluster.stop()
    return replies


# what depends on when ops arrive: how they batched, and so each launch's
# shape, backends and split
HOST_TIMED = ("launches", "ops", "occupancy", "cross_backend_launches",
              "max_backends_in_launch", "buckets", "per_device_stripes",
              "last_per_device")
PG_TIMED = ("encodes", "encode_buckets")


def _smoke_view(replies):
    """The replies' keys, each PG's plane, and every field that does not
    depend on when ops arrive."""
    def view(key, v):
        timed = HOST_TIMED if key == "host" else PG_TIMED
        return {f: x for f, x in v.items() if f not in timed}
    return {osd: {k: view(k, v) for k, v in reply.items()}
            for osd, reply in replies.items()}


def test_mesh_smoke_cluster():
    from tests.test_torch_osd_daemon import PKGS as DAEMON_PKGS
    from tests.test_torch_osd_daemon import on_each_package

    for P in PKGS.values():
        P.mc.reset_host_coalescer()
    out = on_each_package(sc_mesh_smoke, DAEMON_PKGS)
    views = {w: _smoke_view(r) for w, r in out.items()}
    assert views["ceph_tpu_torch"] == views["ceph_tpu"]
    for replies in out.values():
        host_st = next(r["host"] for r in replies.values() if "host" in r)
        assert host_st["devices"] == NDEV, host_st
        planes = {osd for osd, r in replies.items()
                  if any(k != "host" and v["plane"] == "mesh-coalesced"
                         and v["encodes"] > 0 for k, v in r.items())}
        assert len(planes) >= 2, planes
        assert host_st["ops"] >= 64, host_st
        assert host_st["launches"] < host_st["ops"], host_st
        assert host_st["max_backends_in_launch"] >= 2, host_st
        assert host_st["cross_backend_launches"] >= 1, host_st
        per_dev = host_st["per_device_stripes"]
        assert len(per_dev) == NDEV and all(
            r > 0 for r in per_dev.values()), per_dev


def test_mesh_smoke_host_coalescer_runs_on_the_daemons_device():
    """The port's daemons hand their device to the host coalescer: its
    pool is the 8 forced CPU slots, and every launch's pieces lay there."""
    P = PKGS["port"]
    co = P.mc.host_coalescer(device="cpu")
    assert [s.device for s in co.devices()] == [torch.device("cpu")] * NDEV
    assert co.mesh().shape == {"dp": NDEV, "cs": 1}


# ---------------------------------------------------------------------------
# chip_smoke.py's wave (g), rehearsed on the CPU at small sizes

def test_chip_smoke_mesh_phase_on_cpu_slots():
    """``chip_smoke.mesh_phase`` drives every step of wave (g) on 8 CPU
    slots, its checks exact, at a few stripes and objects of 64 KiB; the
    card runs it at the headline (the timings are the card's)."""
    import chip_smoke as CS

    lines = []
    out = CS.mesh_phase(
        "cpu", stripes=256, repair_stripes=16, repair_sc=16,
        backend_repair_stripes=8, objects=8, object_bytes=64 << 10,
        shec_stripes=64, pg_num=4, note=lines.append)
    steps = out["steps"]
    assert list(steps) == [
        "sharded_encode", "distributed_ec_step", "applier_encode",
        "applier_decode", "sharded_clay_repair", "sharded_lrc_repair_0",
        "sharded_lrc_repair_6", "cfg8_coalesced", "cfg8_shec_encode",
        "cfg8_clay_repair", "cfg8_lrc_repair", "mesh_cs_plane",
        "resident_batchmate", "daemons_boot", "daemons_pool",
        "daemons_write_read", "daemons_degraded_read"]
    assert len(lines) == len(steps) and all(
        line.startswith("[mesh] {") for line in lines)
    assert steps["resident_batchmate"]["moved_bytes"] == {
        "host": 0, "place": 0, "slot": 0}
    assert steps["sharded_encode"]["moved_bytes"]["slot"] == 0
    assert steps["distributed_ec_step"]["moved_bytes"]["slot"] > 0
    for step in ("cfg8_clay_repair", "cfg8_lrc_repair"):
        assert 2 * steps[step]["ici_bytes"] <= steps[step]["ici_whole_bytes"]
    degraded = steps["daemons_degraded_read"]
    assert degraded["planes"] == ["mesh-coalesced"]
    assert degraded["launches"] < degraded["ops"]
