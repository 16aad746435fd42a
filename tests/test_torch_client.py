"""The port's client stack against the JAX package's OSD daemons.

No OSD daemon has been ported yet, so the cluster is the JAX package's:
one ``Monitor`` and three ``OSDDaemon``s on loopback TCP (the packages
keep separate ``local://`` namespaces).  Each scenario of
tests/test_client.py (the full IoCtx API, watch/notify, the Objecter's
resend after an OSD failure, a watch that survives its primary's
failover, the striper round trip) runs once with the JAX package's
``Rados`` and once with the port's, each on a fresh cluster of the same
build, and the two clients' results must be equal.  ``StripeLayout`` and
``ObjectCacher`` are held equal across the packages on seeded inputs.
Tolerance 0.
"""

import asyncio
import importlib
import random
from types import SimpleNamespace

import pytest

from tests.test_torch_mon import SLACK, free_ports

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


def _client_pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    client = mod("client")
    return SimpleNamespace(
        root=root, Rados=client.Rados, ObjectOperation=client.ObjectOperation,
        RadosStriper=client.RadosStriper,
        RadosError=mod("client.rados").RadosError,
        StripeLayout=mod("client.striper").StripeLayout,
        ObjectCacher=mod("client.object_cacher").ObjectCacher,
        ConfigProxy=mod("common.config").ConfigProxy,
        object_to_ps=mod("osd.pg").object_to_ps)


CLIENTS = {name: _client_pkg(name) for name in PKG_NAMES}
REF = CLIENTS["ceph_tpu"]
OVERRIDES = {
    "mon_lease": 0.4, "mon_lease_interval": 0.1,
    "mon_election_timeout": 0.3, "mon_tick_interval": 0.1,
    "mon_accept_timeout": 0.5,
    "osd_heartbeat_interval": 0.1, "osd_heartbeat_grace": 0.6,
    "mon_osd_down_out_interval": 30.0,
}


def fast_conf(pkg):
    return pkg.ConfigProxy(overrides=dict(OVERRIDES))


async def start_cluster(client, n_osds=3):
    """The JAX package's mon and OSD daemons on TCP, and a connected
    ``Rados`` of the ``client`` package."""
    from ceph_tpu.mon import Monitor
    from ceph_tpu.osd.daemon import OSDDaemon

    ports = free_ports(1 + n_osds)
    monmap = {"a": f"tcp://127.0.0.1:{ports[0]}"}
    mon = Monitor("a", monmap, fast_conf(REF))
    await mon.start()
    osds = []
    for i in range(n_osds):
        osd = OSDDaemon(i, monmap, fast_conf(REF), host=f"h{i}",
                        addr=f"tcp://127.0.0.1:{ports[1 + i]}")
        await osd.start()
        osds.append(osd)
    rados = client.Rados(monmap, fast_conf(client), name="client.admin")
    await rados.connect()
    return mon, osds, rados


async def stop_cluster(mon, osds, rados, skip=()):
    await rados.shutdown()
    for o in osds:
        if o.osd_id not in skip:
            await o.shutdown()
    await mon.shutdown()


def run_with_each_client(scenario):
    """``scenario(client)`` with the JAX package's client, then the
    port's, each on a fresh cluster; returns {root: result}."""
    return {name: asyncio.run(scenario(client))
            for name, client in CLIENTS.items()}


def assert_equal_across(out):
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]


# ---------------------------------------------------------------------------
# test_client.py's scenarios

async def _ioctx_full_api(c):
    mon, osds, rados = await start_cluster(c)
    got = []
    got.append(await rados.pool_create("data", pg_num=8))
    assert "data" in await rados.list_pools()
    io = await rados.open_ioctx("data")
    await io.write_full("obj", b"hello world")
    got.append(await io.read("obj"))
    await io.write("obj", b"WORLD", 6)
    got.append(await io.read("obj"))
    await io.append("obj", b"!!")
    got.append(await io.read("obj", 5, 6))
    st = await io.stat("obj")
    assert st["size"] == 13
    got.append(st["size"])
    await io.set_xattr("obj", "lang", b"en")
    got.append(await io.get_xattr("obj", "lang"))
    await io.rm_xattr("obj", "lang")
    with pytest.raises(c.RadosError) as exc:
        await io.get_xattr("obj", "lang")
    got.append(exc.value.rc)
    await io.set_omap("obj", {"a": b"1", "b": b"2"})
    got.append(await io.get_omap("obj"))
    await io.rm_omap_keys("obj", ["a"])
    got.append(await io.get_omap("obj"))
    op = c.ObjectOperation().write_full(b"v2").set_xattr("tag", b"x")
    await io.operate("obj", op)
    got.append(await io.read("obj"))
    got.append(await io.get_xattr("obj", "tag"))
    await io.write_full("other", b"zzz")
    got.append(await io.list_objects())
    await io.remove("other")
    got.append(await io.list_objects())
    with pytest.raises(c.RadosError) as exc:
        await io.read("other")
    got.append(exc.value.rc)
    st = await rados.get_cluster_stats()
    assert st["osdmap"]["num_up_osds"] == 3
    got.append(st["osdmap"])
    await stop_cluster(mon, osds, rados)
    return got


def test_ioctx_full_api_round_trip():
    out = run_with_each_client(_ioctx_full_api)
    assert_equal_across(out)
    assert out["ceph_tpu"][1] == b"hello world"


async def _watch_notify(c):
    mon, osds, rados = await start_cluster(c)
    await rados.pool_create("wn", pg_num=4)
    io = await rados.open_ioctx("wn")
    await io.write_full("watched", b"x")
    got = []

    async def on_notify(payload):
        got.append(payload)
        return b"ack:" + payload

    handle = await io.watch("watched", on_notify)
    r1 = await io.notify("watched", b"ping")
    assert got == [b"ping"]
    assert list(r1["acks"].values()) == [b"ack:ping"]
    assert r1["timeouts"] == []
    rados2 = c.Rados(mon.monmap, fast_conf(c), name="client.second")
    await rados2.connect()
    io2 = await rados2.open_ioctx("wn")
    got2 = []

    async def on_notify2(payload):
        got2.append(payload)

    h2 = await io2.watch("watched", on_notify2)
    r2 = await io.notify("watched", b"again")
    assert got == [b"ping", b"again"] and got2 == [b"again"]
    assert len(r2["acks"]) == 2
    await io2.unwatch(h2)
    await io.unwatch(handle)
    r3 = await io.notify("watched", b"nobody")
    assert r3["acks"] == {}
    await rados2.shutdown()
    await stop_cluster(mon, osds, rados)
    return {"got": got, "got2": got2,
            "acks": [sorted(r["acks"].values(), key=lambda v: v or b"")
                     for r in (r1, r2, r3)],
            "timeouts": [r["timeouts"] for r in (r1, r2, r3)]}


def test_watch_notify():
    out = run_with_each_client(_watch_notify)
    assert_equal_across(out)


async def _kill_primary(c, mon, osds, rados, io, oid, pg_num):
    m = rados.monc.osdmap
    ps = c.object_to_ps(oid, pg_num)
    _, _, _, primary = m.pg_to_up_acting(io.pool_id, ps)
    await osds[primary].shutdown()
    await mon.osd_monitor.wait_map(lambda m: not m.is_up(primary),
                                   timeout=20 * SLACK)
    return primary


async def _resend(c):
    mon, osds, rados = await start_cluster(c)
    await rados.pool_create("rp", pg_num=4, size=3, min_size=2)
    io = await rados.open_ioctx("rp")
    await io.write_full("before", b"pre-failure")
    primary = await _kill_primary(c, mon, osds, rados, io, "before", 4)
    got = [primary, await io.read("before")]
    await io.write_full("after", b"post-failure")
    got.append(await io.read("after"))
    await stop_cluster(mon, osds, rados, skip={primary})
    return got


def test_objecter_resends_after_osd_failure():
    out = run_with_each_client(_resend)
    assert_equal_across(out)
    assert out["ceph_tpu"][1:] == [b"pre-failure", b"post-failure"]


async def _watch_failover(c):
    mon, osds, rados = await start_cluster(c)
    await rados.pool_create("wf", pg_num=4, size=3, min_size=2)
    io = await rados.open_ioctx("wf")
    await io.write_full("w", b"x")
    got = []

    async def cb(payload):
        got.append(payload)

    await io.watch("w", cb)
    primary = await _kill_primary(c, mon, osds, rados, io, "w", 4)
    # the linger re-arms on the new primary; notify until it answers
    for _ in range(int(100 * SLACK)):
        await asyncio.sleep(0.05)
        result = await io.notify("w", b"hello", timeout=2.0)
        if result["acks"]:
            break
    assert got and got[-1] == b"hello"
    await stop_cluster(mon, osds, rados, skip={primary})
    return {"primary": primary, "last": got[-1],
            "acks": list(result["acks"].values())}


def test_watch_survives_primary_failover():
    out = run_with_each_client(_watch_failover)
    assert_equal_across(out)


async def _striper(c):
    layout = c.StripeLayout(stripe_unit=1024, stripe_count=3,
                            object_size=4096)
    mon, osds, rados = await start_cluster(c)
    await rados.pool_create("sp", pg_num=8)
    io = await rados.open_ioctx("sp")
    striper = c.RadosStriper(io, layout)
    data = bytes(range(256)) * 64
    await striper.write("big", data)
    got = [(await striper.stat("big"))["size"]]
    assert await striper.read("big") == data
    got.append(await striper.read("big", 1000, 3000))
    names = await io.list_objects()
    assert "big.0000000000000000" in names
    got.append(names)
    await striper.write("big", b"tail", 40000)
    full = await striper.read("big")
    assert full[:len(data)] == data
    assert full[len(data):40000] == b"\0" * (40000 - len(data))
    got.append(full)
    await striper.truncate("big", 100)
    got.append((await striper.stat("big"))["size"])
    got.append(await striper.read("big"))
    await striper.remove("big")
    got.append(await io.list_objects())
    with pytest.raises(c.RadosError) as exc:
        await striper.read("big")
    got.append(exc.value.rc)
    await stop_cluster(mon, osds, rados)
    return got


def test_striper_round_trip_and_layout():
    out = run_with_each_client(_striper)
    assert_equal_across(out)
    data = bytes(range(256)) * 64
    assert out["ceph_tpu"][1] == data[3000:4000]


# ---------------------------------------------------------------------------
# the host helpers on seeded inputs

def test_stripe_layout_equal_across_packages():
    rng = random.Random(7)
    for _ in range(200):
        su = rng.choice([512, 1024, 4096, 65536])
        sc = rng.randint(1, 8)
        os_ = su * rng.randint(1, 16)
        off = rng.randrange(0, 1 << 22)
        length = rng.randrange(0, 1 << 18)
        layouts = [c.StripeLayout(stripe_unit=su, stripe_count=sc,
                                  object_size=os_) for c in CLIENTS.values()]
        frags = [list(lay.map_extent(off, length)) for lay in layouts]
        assert frags[1] == frags[0], (su, sc, os_, off, length)
        assert sum(f[2] for f in frags[0]) == length
    for c in CLIENTS.values():
        with pytest.raises(ValueError):
            c.StripeLayout(stripe_unit=1000, object_size=4096)


async def _cacher_trace(c, seed):
    rng = random.Random(seed)
    backing: dict = {}
    calls = []

    async def fetch(key):
        calls.append(("fetch", key))
        return backing.get(key, b"")

    async def writeback(key, data):
        calls.append(("writeback", key, data))
        backing[key] = data

    cache = c.ObjectCacher(fetch, writeback, max_dirty=4096, max_objects=4)
    reads = []
    for _ in range(300):
        key = f"o{rng.randrange(8)}"
        op = rng.random()
        if op < 0.45:
            off = rng.randrange(0, 2048)
            data = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(1, 700)))
            await cache.write(key, off, data)
        elif op < 0.85:
            reads.append(await cache.read(key, rng.randrange(0, 2048),
                                          rng.randrange(1, 512)))
        elif op < 0.95:
            await cache.flush(key if rng.random() < 0.5 else None)
        else:
            await cache.discard(key)
        reads.append(cache.stats())
    await cache.flush()
    return {"reads": reads, "calls": calls, "backing": backing,
            "stats": cache.stats()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_object_cacher_equal_across_packages(seed):
    out = {name: asyncio.run(_cacher_trace(c, seed))
           for name, c in CLIENTS.items()}
    assert_equal_across(out)
    assert out["ceph_tpu"]["stats"]["flushes"] > 0
    assert out["ceph_tpu"]["stats"]["evictions"] > 0
