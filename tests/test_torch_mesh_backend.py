"""The port's ECBackend mesh plane (``mesh=``) against the JAX package's.

tests/test_ec_mesh_backend.py's cases and
tests/test_dr_tools.py::test_ec_mesh_applier_pin_and_lru on both
packages: the JAX package on its 8 forced CPU devices, the port on 8
slots forced over the CPU, the same seeded inputs.  ``ShardedApplier``
outputs, every shard object's stored bytes and attrs, read-back bytes
and the plane counters must be equal; the OSD cluster case runs each
package's mon and six OSD daemons with ``osd_ec_mesh_cs=2``.
Tolerance 0.
"""

import numpy as np
import pytest

from tests.test_torch_ec_backend import snapshot
from tests.test_torch_mesh_coalesce import NDEV, PKGS, both, rand
from tests.test_torch_mesh_coalesce import _eight_slots  # noqa: F401

K, M = 4, 2
CAUCHY = {"k": str(K), "m": str(M), "technique": "cauchy_good"}


def test_sharded_applier_matches_codec():
    """ShardedApplier output == codec encode, any batch size (padding
    path included), equal across the packages."""
    async def sc(P):
        codec = P.codec(profile=CAUCHY)
        mesh = P.es.make_ec_mesh(P.devices(), cs=2)
        gen = np.asarray(codec.generator, np.uint8)
        ap = P.es.ShardedApplier(mesh, gen[K:])
        out = []
        for batch in (1, 3, 8, 13):
            data = rand(batch, (batch, K, 64))
            want = np.asarray(codec.encode_chunks_batch(data))
            parity = ap(data)
            assert np.array_equal(parity, want[:, K:]), f"batch={batch}"
            out.append(parity.tobytes())
        return out

    both(sc)


async def sc_write_read_recover(P):
    mesh = P.es.make_ec_mesh(P.devices(), cs=2)
    be_mesh = await P.backend(profile=CAUCHY, mesh=mesh)
    be_solo = await P.backend(profile=CAUCHY)
    assert be_mesh.mesh is not None and be_solo.mesh is None
    data = rand(0, 5000).tobytes()
    await be_mesh.write("obj", data)
    await be_solo.write("obj", data)
    assert be_mesh.mesh_stats["encodes"] >= 1
    assert snapshot(be_mesh) == snapshot(be_solo)
    # RMW overwrite through the mesh plane
    patch = rand(9, 700).tobytes()
    await be_mesh.write("obj", patch, offset=300)
    await be_solo.write("obj", patch, offset=300)
    got = await be_mesh.read("obj")
    assert got == await be_solo.read("obj")
    # degraded read (decode) + full shard recovery via the mesh
    await P.kill(be_mesh, "obj", [0, K + 1])
    dec0 = be_mesh.mesh_stats["decodes"]
    degraded = await be_mesh.read("obj")
    assert degraded == got
    assert be_mesh.mesh_stats["decodes"] > dec0
    await be_mesh.recover_shard("obj", [0, K + 1])
    assert snapshot(be_mesh) == snapshot(be_solo)
    return (got, snapshot(be_mesh), be_mesh.mesh_stats,
            {k: be_mesh.perf.value(k) for k in (
                "ec_device_launches", "ec_launch_bytes",
                "ec_resident_h2d_bytes", "ec_resident_d2h_bytes")})


def test_backend_mesh_write_read_recover_bit_identical():
    """The same writes through mesh and single-device backends leave
    byte-identical shard objects; recovery through the mesh plane
    rebuilds byte-identical shards — on both packages, equal."""
    both(sc_write_read_recover)


def test_mesh_backend_keeps_resident_off_and_generatorless_codecs_solo():
    """The mesh plane and the resident cache are exclusive, and a codec
    without a dense generator keeps the single-device plane."""
    async def sc(P):
        mesh = P.es.make_ec_mesh(P.devices(), cs=2)
        be = await P.backend(profile=CAUCHY, mesh=mesh, resident=True)
        clay = await P.backend("clay", {"k": "4", "m": "2", "d": "5"},
                               unit=1024, mesh=mesh)
        return be.resident is None, be.mesh is mesh, clay.mesh is None

    assert both(sc) == (True, True, True)


@pytest.mark.parametrize("which", ["ref", "port"])
def test_ec_mesh_applier_pin_and_lru(monkeypatch, which):
    """The write-path ('enc',) applier is pinned outside the bounded
    decode-combo cache, and the cache evicts least-recently-USED, not
    oldest-inserted."""
    P = PKGS[which]
    ECBackend = P.eb.ECBackend

    class _Stub:
        def __init__(self, mesh, coeff):
            self.coeff = coeff

    monkeypatch.setattr(P.es, "ShardedApplier", _Stub)
    be = ECBackend.__new__(ECBackend)
    be.mesh = object()
    be._mesh_appliers = {}
    be._mesh_enc_applier = None

    enc = be._mesh_applier(("enc",), lambda: "E")
    assert be._mesh_applier(("enc",), lambda: "E2") is enc  # cached
    assert ("enc",) not in be._mesh_appliers                # pinned

    cap = ECBackend._MESH_APPLIER_CAP
    assert cap == 64
    for i in range(cap):                      # fill to capacity
        be._mesh_applier(("dec", i), lambda: i)
    be._mesh_applier(("dec", 0), lambda: 0)   # touch the oldest
    be._mesh_applier(("dec", cap), lambda: cap)  # overflow by one
    assert ("dec", 0) in be._mesh_appliers    # recently used: kept
    assert ("dec", 1) not in be._mesh_appliers  # LRU victim
    assert len(be._mesh_appliers) == cap
    # a wide decode burst never evicted the pinned encoder
    assert be._mesh_applier(("enc",), lambda: "E3") is enc


async def _cluster_pg_write_and_recovery(p):
    from tests.test_torch_osd_daemon import (OSD_OVERRIDES, RawClient,
                                             _pool_id, wait_active)

    def conf():
        return p.ConfigProxy(overrides={**OSD_OVERRIDES,
                                        "osd_ec_mesh_cs": 2})

    monmap = {"a": "local://mon.a"}
    mon = p.Monitor("a", monmap, conf())
    await mon.start()
    osds = []
    for i in range(6):
        osd = p.OSDDaemon(i, monmap, conf(), host=f"h{i}")
        await osd.start()
        osds.append(osd)
    client = RawClient(p, monmap, conf())
    await client.start()
    for cmd in (
            {"prefix": "osd erasure-code-profile set", "name": "p42",
             "profile": {"plugin": "jax_rs", "k": "4", "m": "2",
                         "crush-failure-domain": "osd"}},
            {"prefix": "osd pool create", "pool": "ecm", "pg_num": 4,
             "pool_type": "erasure", "erasure_code_profile": "p42"}):
        r = await client.monc.command(**cmd)
        assert r["rc"] == 0, r
    pool_id = _pool_id(mon, "ecm")
    await wait_active(osds, pool_id)
    payload = bytes(range(256)) * 64      # 16 KiB
    r = await client.op("ecm", "big", [
        {"op": "write", "off": 0, "data": payload}])
    assert r["rc"] == 0, r
    r = await client.op("ecm", "big", [{"op": "read", "off": 0}])
    assert r["results"][0]["data"] == payload
    backends = [pg.backend for osd in osds for pg in osd.pgs.values()
                if pg.pgid.pool == pool_id and pg.backend]
    assert backends, "no EC backends instantiated"
    assert all(b.mesh is not None for b in backends)
    assert all(dict(b.mesh.shape) == {"dp": NDEV // 2, "cs": 2}
               for b in backends)
    assert sum(b.mesh_stats["encodes"] for b in backends) >= 1
    be = next(b for b in backends if b.mesh_stats["encodes"] >= 1)
    await be.shards[0].remove_shard("big")
    d0 = be.mesh_stats["decodes"]
    await be.recover_shard("big", [0])
    assert be.mesh_stats["decodes"] > d0
    r = await client.op("ecm", "big", [{"op": "read", "off": 0}])
    assert r["results"][0]["data"] == payload
    got = (r["results"][0]["data"],
           sorted(b.mesh_stats["encodes"] for b in backends),
           be.mesh_stats["decodes"] - d0)
    await client.shutdown()
    for o in osds:
        await o.shutdown()
    await mon.shutdown()
    return got


def test_cluster_pg_write_and_recovery_ride_the_mesh():
    """OSD-cluster proof on 8 slots: an EC-pool PG write and a shard
    recovery run the sharded data plane (mesh_stats move) and stay
    correct end to end, equal across the packages."""
    from ceph_tpu.osd import daemon as jdaemon
    from ceph_tpu_torch.osd import daemon as pdaemon
    from tests.test_torch_osd_daemon import PKGS as DAEMON_PKGS
    from tests.test_torch_osd_daemon import on_each_package

    pdaemon._EC_MESH_CACHE.clear()
    try:
        out = on_each_package(_cluster_pg_write_and_recovery, DAEMON_PKGS)
    finally:
        pdaemon._EC_MESH_CACHE.clear()
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]
    assert 2 in jdaemon._EC_MESH_CACHE
