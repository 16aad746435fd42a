"""The port's OSD daemon against the JAX package's, scenario by scenario.

Each scenario of tests/test_osd_daemon.py (a replicated pool's IO and
omap, an EC pool on a device class, an EC round trip with a partial
overwrite, a dead OSD detected by heartbeats and a degraded EC read, a
stale replica healed by recovery), the EC scrub of tests/test_scrub.py
(one shard's byte flipped, found, repaired) and the object-class
scenarios of tests/test_services.py (cls lock / refcount / version, a cls
call batched with a write, batch ops that see prior mutations, a shared
lock's blocked upgrade) runs once on a fresh cluster of each package: the
JAX package's mon and OSD daemons, then the port's, whose daemons run
their codecs on ``device="cpu"``.  Read bytes, omap values, return codes
and PG states must be equal.  The daemon scenarios run on
tests/test_osd_daemon.py's timers but the dev cluster's heartbeat grace
(3 s, not 0.6 s: see ``OSD_OVERRIDES``).  Tolerance 0.
"""

import asyncio
import functools
import importlib
import json
from types import SimpleNamespace

import pytest

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


def _pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    msg, mon, client, store = mod("msg"), mod("mon"), mod("client"), \
        mod("store")
    device = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    return SimpleNamespace(
        root=root, Monitor=mon.Monitor, MonClient=mon.MonClient,
        Messenger=msg.Messenger, Message=msg.Message, Policy=msg.Policy,
        reset_local_namespace=msg.reset_local_namespace,
        OSDDaemon=functools.partial(mod("osd.daemon").OSDDaemon, **device),
        DevCluster=functools.partial(mod("vstart").DevCluster, **device),
        ConfigProxy=mod("common.config").ConfigProxy,
        object_to_ps=mod("osd.pg").object_to_ps, PGId=mod("osd.pg").PGId,
        CollectionId=store.CollectionId, GHObject=store.GHObject,
        Transaction=store.Transaction, Rados=client.Rados,
        ObjectOperation=client.ObjectOperation,
        RadosError=mod("client.rados").RadosError)


PKGS = {name: _pkg(name) for name in PKG_NAMES}


@pytest.fixture(autouse=True)
def _clean_local():
    for p in PKGS.values():
        p.reset_local_namespace()
    yield
    for p in PKGS.values():
        p.reset_local_namespace()


def on_each_package(scenario, pkgs=PKGS):
    """``scenario(pkg)`` on a fresh cluster of the JAX package, then of the
    port; returns {root: result}."""
    out = {}
    for name, p in pkgs.items():
        p.reset_local_namespace()
        out[name] = asyncio.run(scenario(p))
        p.reset_local_namespace()
    return out


def assert_equal_across(out):
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]


# tests/test_osd_daemon.py's timers, but the dev cluster's heartbeat
# grace (vstart.FAST_TEST_OVERRIDES): at 0.6 s, six test processes on one
# host made a live OSD miss its grace, and the map churn failed a write's
# sub-ops with ESTALE
OSD_OVERRIDES = {
    "mon_lease": 0.4, "mon_lease_interval": 0.1,
    "mon_election_timeout": 0.3, "mon_tick_interval": 0.1,
    "mon_accept_timeout": 0.5,
    "osd_heartbeat_interval": 0.2, "osd_heartbeat_grace": 3.0,
    "mon_osd_down_out_interval": 30.0,
}
SERVICES_OVERRIDES = {
    "mon_lease": 0.4, "mon_lease_interval": 0.1,
    "mon_election_timeout": 0.3, "mon_tick_interval": 0.1,
    "mon_accept_timeout": 0.5,
    "osd_heartbeat_interval": 0.2, "osd_heartbeat_grace": 1.0,
}


class RawClient:
    """tests/test_osd_daemon.py's minimal client over one package: it
    computes placement itself and sends osd_op to the primary."""

    def __init__(self, p, monmap, conf):
        self.p = p
        self.msgr = p.Messenger("client.77", conf)
        self.msgr.set_policy("mon", p.Policy.lossy_client())
        self.msgr.set_policy("osd", p.Policy.lossy_client())
        self.msgr.set_dispatcher(self)
        self.monc = p.MonClient("client.77", monmap, conf, msgr=self.msgr)
        self.monc.on_osdmap = self._noop
        self._tid = 0
        self._futures = {}

    async def _noop(self, m):
        pass

    async def start(self):
        await self.monc.start()
        self.monc.sub_want("osdmap")
        self.monc.renew_subs()
        await self.monc.wait_for_map(1)

    async def shutdown(self):
        await self.monc.shutdown()
        await self.msgr.shutdown()

    async def ms_dispatch(self, conn, msg):
        if msg.type == "osd_op_reply":
            fut = self._futures.pop(int(msg.data["tid"]), None)
            if fut is not None and not fut.done():
                fut.set_result(msg.data)
        else:
            await self.monc.ms_dispatch(conn, msg)

    def ms_handle_reset(self, conn):
        self.monc.ms_handle_reset(conn)

    def ms_handle_connect(self, conn):
        pass

    async def op(self, pool_name, oid, ops, timeout=15.0):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            m = self.monc.osdmap
            pool = next(p for p in m.pools.values() if p.name == pool_name)
            ps = self.p.object_to_ps(oid, pool.pg_num)
            _, _, acting, primary = m.pg_to_up_acting(pool.pool_id, ps)
            if primary < 0:
                try:
                    await self.monc.wait_for_map(m.epoch + 1, timeout=1.0)
                except asyncio.TimeoutError:
                    pass
                if loop.time() > deadline:
                    raise TimeoutError(f"no primary for {pool_name}/{oid}")
                continue
            self._tid += 1
            tid = self._tid
            fut = loop.create_future()
            self._futures[tid] = fut
            await self.msgr.send_to(
                m.osds[primary].addr,
                self.p.Message("osd_op", {
                    "tid": tid, "pool": pool.pool_id, "ps": ps,
                    "oid": oid, "epoch": m.epoch, "ops": ops,
                }), f"osd.{primary}",
            )
            left = deadline - loop.time()
            if left <= 0:
                raise TimeoutError(f"op on {oid} timed out")
            reply = await asyncio.wait_for(fut, left)
            if reply["rc"] == -1000:
                await self.monc.wait_for_map(reply.get("epoch", m.epoch),
                                             timeout=5.0)
                await asyncio.sleep(0.05)
                continue
            return reply


def _conf(p, overrides=OSD_OVERRIDES):
    return p.ConfigProxy(overrides=dict(overrides))


async def start_cluster(p, n_osds, pools=()):
    monmap = {"a": "local://mon.a"}
    mon = p.Monitor("a", monmap, _conf(p))
    await mon.start()
    osds = []
    for i in range(n_osds):
        osd = p.OSDDaemon(i, monmap, _conf(p), host=f"h{i}")
        await osd.start()
        osds.append(osd)
    client = RawClient(p, monmap, _conf(p))
    await client.start()
    for cmd in pools:
        r = await client.monc.command(**cmd)
        assert r["rc"] == 0, r
    return mon, osds, client


async def stop_cluster(mon, osds, client, skip=()):
    await client.shutdown()
    for o in osds:
        if o.osd_id not in skip:
            await o.shutdown()
    await mon.shutdown()


async def wait_active(osds, pool_id, timeout=15.0):
    """Every primary PG of the pool reports active; returns the states."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        states = {str(pgid): pg.state for osd in osds
                  for pgid, pg in osd.pgs.items()
                  if pgid.pool == pool_id and pg.is_primary}
        if states and all(s == "active" for s in states.values()):
            return dict(sorted(states.items()))
        if loop.time() > deadline:
            raise TimeoutError(f"pgs not active: {states}")
        await asyncio.sleep(0.05)


def _pool_id(mon, name):
    return next(p.pool_id for p in mon.osd_monitor.osdmap.pools.values()
                if p.name == name)


def _results(reply):
    """An op reply's return code and per-op results, without the tid."""
    return reply["rc"], reply.get("results")


def _ok(reply):
    assert reply["rc"] == 0, reply
    return _results(reply)


# ---------------------------------------------------------------------------
# tests/test_osd_daemon.py's scenarios

async def _replicated_pool_io_and_omap(p):
    mon, osds, client = await start_cluster(p, 3, pools=[
        {"prefix": "osd pool create", "pool": "rep", "pg_num": 8,
         "size": 3},
    ])
    pool_id = _pool_id(mon, "rep")
    got = [await wait_active(osds, pool_id)]
    got.append(_ok(await client.op("rep", "obj1", [
        {"op": "write", "off": 0, "data": b"hello "},
        {"op": "append", "data": b"world"},
        {"op": "setxattr", "name": "color", "value": b"blue"},
        {"op": "omap_set", "kv": {"k1": b"v1", "k2": b"v2"}},
    ])))
    r = await client.op("rep", "obj1", [
        {"op": "read", "off": 0},
        {"op": "getxattr", "name": "color"},
        {"op": "omap_get"},
        {"op": "stat"},
    ])
    assert r["rc"] == 0, r
    assert r["results"][0]["data"] == b"hello world"
    assert r["results"][2]["kv"] == {"k1": b"v1", "k2": b"v2"}
    got.append([r["results"][0]["data"], r["results"][1]["value"],
                r["results"][2]["kv"], r["results"][3]["size"]])
    ps = p.object_to_ps("obj1", 8)
    _, _, acting, _ = mon.osd_monitor.osdmap.pg_to_up_acting(pool_id, ps)
    got.append([osds[o].store.read(p.CollectionId(pool_id, ps),
                                   p.GHObject(pool_id, "obj1"))
                for o in acting])
    assert got[-1] == [b"hello world"] * 3
    await stop_cluster(mon, osds, client)
    return got


def test_replicated_pool_io_and_omap():
    assert_equal_across(on_each_package(_replicated_pool_io_and_omap))


async def _ec_pool_on_device_class(p):
    mon, osds, client = await start_cluster(p, 6, pools=[
        {"prefix": "osd crush set-device-class", "class": "ssd",
         "ids": [0, 1, 2]},
        {"prefix": "osd crush set-device-class", "class": "hdd",
         "ids": [3, 4, 5]},
        {"prefix": "osd erasure-code-profile set", "name": "pssd",
         "profile": {"plugin": "jax_rs", "k": "2", "m": "1",
                     "crush-failure-domain": "osd",
                     "crush-device-class": "ssd"}},
        {"prefix": "osd pool create", "pool": "ecssd", "pg_num": 8,
         "pool_type": "erasure", "erasure_code_profile": "pssd"},
    ])
    pool_id = _pool_id(mon, "ecssd")
    got = [await wait_active(osds, pool_id)]
    actings = [mon.osd_monitor.osdmap.pg_to_up_acting(pool_id, ps)[2]
               for ps in range(8)]
    for acting in actings:
        real = [o for o in acting if o >= 0]
        assert real and set(real) <= {0, 1, 2}, acting
    got.append(actings)
    got.append(_ok(await client.op("ecssd", "obj", [
        {"op": "write", "off": 0, "data": b"classy" * 100}])))
    r = await client.op("ecssd", "obj", [{"op": "read", "off": 0}])
    assert r["results"][0]["data"] == b"classy" * 100
    got.append(_results(r))
    got.append((await client.monc.command("osd crush class ls"))["data"])
    got.append((await client.monc.command("osd crush class ls-osd",
                                          **{"class": "ssd"}))["data"])
    assert got[-2:] == [["hdd", "ssd"], [0, 1, 2]]
    await stop_cluster(mon, osds, client)
    return got


def test_ec_pool_on_device_class():
    assert_equal_across(on_each_package(_ec_pool_on_device_class))


EC42 = [
    {"prefix": "osd erasure-code-profile set", "name": "p42",
     "profile": {"plugin": "jax_rs", "k": "4", "m": "2",
                 "crush-failure-domain": "osd"}},
    {"prefix": "osd pool create", "pool": "ec", "pg_num": 4,
     "pool_type": "erasure", "erasure_code_profile": "p42"},
]


async def _ec_pool_io_round_trip(p):
    mon, osds, client = await start_cluster(p, 6, pools=EC42)
    got = [await wait_active(osds, _pool_id(mon, "ec"))]
    payload = bytes(range(256)) * 64
    got.append(_ok(await client.op("ec", "big", [
        {"op": "write", "off": 0, "data": payload}])))
    r = await client.op("ec", "big", [{"op": "read", "off": 0},
                                       {"op": "stat"}])
    assert r["results"][0]["data"] == payload
    assert r["results"][1]["size"] == len(payload)
    got.append(_results(r))
    got.append(_ok(await client.op("ec", "big", [
        {"op": "write", "off": 100, "data": b"X" * 50}])))
    r = await client.op("ec", "big", [{"op": "read", "off": 90,
                                       "len": 70}])
    assert r["results"][0]["data"] == \
        payload[90:100] + b"X" * 50 + payload[150:160]
    got.append(_results(r))
    r = await client.op("ec", "big", [{"op": "omap_set",
                                       "kv": {"k": b"v"}}])
    assert r["rc"] == -95
    got.append(r["rc"])
    await stop_cluster(mon, osds, client)
    return got


def test_ec_pool_io_round_trip():
    assert_equal_across(on_each_package(_ec_pool_io_round_trip))


async def _wait_down(mon, victim, up=False):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + 15
    while mon.osd_monitor.osdmap.is_up(victim) != up:
        assert loop.time() < deadline
        await asyncio.sleep(0.05)


async def _osd_death_detection_and_degraded_ec_read(p):
    mon, osds, client = await start_cluster(p, 6, pools=EC42)
    pool_id = _pool_id(mon, "ec")
    got = [await wait_active(osds, pool_id)]
    payload = b"ec-degraded-read" * 512
    got.append(_ok(await client.op("ec", "victim", [
        {"op": "write", "off": 0, "data": payload}])))
    ps = p.object_to_ps("victim", 4)
    _, _, acting, primary = mon.osd_monitor.osdmap.pg_to_up_acting(
        pool_id, ps)
    victim = next(o for o in acting if o != primary)
    got.append([acting, primary, victim])
    await osds[victim].shutdown()
    await _wait_down(mon, victim)
    r = await client.op("ec", "victim", [{"op": "read", "off": 0}])
    assert r["rc"] == 0 and r["results"][0]["data"] == payload, r["rc"]
    got.append(_results(r))
    await stop_cluster(mon, osds, client, skip=(victim,))
    return got


def test_osd_death_detection_and_degraded_ec_read():
    assert_equal_across(
        on_each_package(_osd_death_detection_and_degraded_ec_read))


async def _replicated_recovery_heals_stale_replica(p):
    mon, osds, client = await start_cluster(p, 3, pools=[
        {"prefix": "osd pool create", "pool": "rep", "pg_num": 4,
         "size": 3, "min_size": 2},
    ])
    pool_id = _pool_id(mon, "rep")
    got = [await wait_active(osds, pool_id)]
    got.append(_ok(await client.op("rep", "healme", [
        {"op": "write", "off": 0, "data": b"v1"}])))
    ps = p.object_to_ps("healme", 4)
    _, _, acting, primary = mon.osd_monitor.osdmap.pg_to_up_acting(
        pool_id, ps)
    victim = next(o for o in acting if o != primary)
    got.append([acting, primary, victim])
    await osds[victim].shutdown()
    await _wait_down(mon, victim)
    got.append(_ok(await client.op("rep", "healme", [
        {"op": "writefull", "data": b"v2-degraded"}])))
    revived = p.OSDDaemon(victim, mon.monmap, _conf(p),
                          store=osds[victim].store, host=f"h{victim}")
    await revived.start()
    await _wait_down(mon, victim, up=True)
    got.append(await wait_active(
        [o for o in osds if o.osd_id != victim] + [revived], pool_id))
    cid, oid = p.CollectionId(pool_id, ps), p.GHObject(pool_id, "healme")
    loop = asyncio.get_running_loop()
    deadline = loop.time() + 15
    while True:
        try:
            data = revived.store.read(cid, oid)
            if data == b"v2-degraded":
                break
        except KeyError:
            pass
        assert loop.time() < deadline, "stale replica never healed"
        await asyncio.sleep(0.05)
    got.append(data)
    await client.shutdown()
    for o in osds:
        if o.osd_id != victim:
            await o.shutdown()
    await revived.shutdown()
    await mon.shutdown()
    return got


def test_replicated_recovery_heals_stale_replica():
    assert_equal_across(
        on_each_package(_replicated_recovery_heals_stale_replica))


# ---------------------------------------------------------------------------
# tests/test_scrub.py's EC scrub

async def _ec_scrub_detects_and_repairs_shard_corruption(p):
    cluster = p.DevCluster(n_mons=1, n_osds=6)
    await cluster.start()
    rados = await cluster.client()
    got = [(await rados.mon_command(
        "osd erasure-code-profile set", name="scrubec",
        profile={"plugin": "jax_rs", "k": "4", "m": "2",
                 "crush-failure-domain": "osd"}))["rc"]]
    pool_id = await rados.pool_create(
        "ecscrub", pool_type="erasure", erasure_code_profile="scrubec",
        pg_num=2)
    io = await rados.open_ioctx("ecscrub")
    payload = bytes(range(256)) * 64
    await io.write_full("ecvictim", payload)
    m = next(iter(cluster.mons.values())).osd_monitor.osdmap
    ps = p.object_to_ps("ecvictim", 2)
    _, _, acting, primary = m.pg_to_up_acting(pool_id, ps)
    got.append([pool_id, ps, acting, primary])
    got.append((await rados.pg_scrub(pool_id, ps))["errors"])
    shard = 1
    osd = cluster.osds[acting[shard]]
    scid = p.CollectionId(pool_id, ps, shard)
    sobj = p.GHObject(pool_id, "ecvictim", shard=shard)
    raw = osd.store.read(scid, sobj)
    await osd.store.queue_transactions(p.Transaction().write(
        scid, sobj, 0, bytes([raw[0] ^ 0xFF]) + raw[1:]))
    got.append((await rados.pg_scrub(pool_id, ps))["errors"])
    got.append((await rados.pg_scrub(pool_id, ps, repair=True))["errors"])
    got.append((await rados.pg_scrub(pool_id, ps))["errors"])
    assert got[-4:] == [0, 1, 1, 0]
    got.append(osd.store.read(scid, sobj) == raw)
    got.append(await io.read("ecvictim"))
    assert got[-2:] == [True, payload]
    await rados.shutdown()
    await cluster.stop()
    return got


def test_ec_scrub_detects_and_repairs_shard_corruption():
    assert_equal_across(
        on_each_package(_ec_scrub_detects_and_repairs_shard_corruption))


# ---------------------------------------------------------------------------
# tests/test_services.py's object-class scenarios

async def start_services_cluster(p, n_osds=3):
    monmap = {"a": "local://mon.a"}
    mon = p.Monitor("a", monmap, _conf(p, SERVICES_OVERRIDES))
    await mon.start()
    osds = []
    for i in range(n_osds):
        osd = p.OSDDaemon(i, monmap, _conf(p, SERVICES_OVERRIDES),
                          host=f"h{i}")
        await osd.start()
        osds.append(osd)
    rados = p.Rados(monmap, _conf(p, SERVICES_OVERRIDES))
    await rados.connect()
    await rados.pool_create("meta", pg_num=4)
    return mon, osds, rados, await rados.open_ioctx("meta")


async def stop_services_cluster(mon, osds, rados):
    await rados.shutdown()
    for o in osds:
        await o.shutdown()
    await mon.shutdown()


async def _rc_of(p, coro):
    """The RadosError code ``coro`` raises (it must raise)."""
    with pytest.raises(p.RadosError) as exc:
        await coro
    return exc.value.rc


def _lock(who, kind=None):
    d = {"locker": who}
    if kind is not None:
        d["type"] = kind
    return json.dumps(d).encode()


async def _cls_lock_refcount_version(p):
    mon, osds, rados, io = await start_services_cluster(p)
    await io.write_full("obj", b"x")
    got = [await io.exec("obj", "lock", "lock", _lock("client.a",
                                                      "exclusive"))]
    got.append(await _rc_of(p, io.exec("obj", "lock", "lock",
                                       _lock("client.b", "exclusive"))))
    info = json.loads(await io.exec("obj", "lock", "get_info"))
    assert "client.a" in info["lockers"]
    got.append(sorted(info["lockers"]))
    got.append(await io.exec("obj", "lock", "unlock", _lock("client.a")))
    got.append(await io.exec("obj", "lock", "lock", _lock("client.b")))
    for tag in ("t1", "t2"):
        got.append(await io.exec("obj", "refcount", "get",
                                 json.dumps({"tag": tag}).encode()))
    for tag, empty in (("t1", False), ("t2", True)):
        out = json.loads(await io.exec("obj", "refcount", "put",
                                       json.dumps({"tag": tag}).encode()))
        assert out["empty"] is empty
        got.append(out)
    got.append([json.loads(await io.exec("obj", "version", m))
                for m in ("read", "inc", "inc")])
    assert got[-1] == [0, 1, 2]
    got.append(await _rc_of(p, io.exec("obj", "nope", "nope")))
    await stop_services_cluster(mon, osds, rados)
    return got


def test_cls_lock_refcount_version():
    assert_equal_across(on_each_package(_cls_lock_refcount_version))


async def _cls_atomic_with_batch(p):
    mon, osds, rados, io = await start_services_cluster(p)
    op = p.ObjectOperation().write_full(b"payload").call("version", "inc")
    r = await io.operate("obj", op)
    got = [json.loads(r["results"][1]["out"]), await io.read("obj")]
    assert got == [1, b"payload"]
    await stop_services_cluster(mon, osds, rados)
    return got


def test_cls_atomic_with_batch():
    assert_equal_across(on_each_package(_cls_atomic_with_batch))


async def _batch_ops_see_prior_mutations(p):
    mon, osds, rados, io = await start_services_cluster(p)
    op = (p.ObjectOperation().write_full(b"fresh").call("version", "inc")
          .read())
    r = await io.operate("brandnew", op)
    got = [json.loads(r["results"][1]["out"]), r["results"][2]["data"]]
    r = await io.operate("brandnew", p.ObjectOperation().set_xattr(
        "k", b"v").get_xattr("k"))
    got.append(r["results"][1]["value"])
    got.append(await _rc_of(p, io.operate(
        "brandnew", p.ObjectOperation().remove().stat())))
    assert got[:3] == [1, b"fresh", b"v"]
    await stop_services_cluster(mon, osds, rados)
    return got


def test_batch_ops_see_prior_mutations():
    assert_equal_across(on_each_package(_batch_ops_see_prior_mutations))


async def _cls_lock_shared_upgrade_blocked(p):
    mon, osds, rados, io = await start_services_cluster(p)
    await io.write_full("obj", b"x")
    got = [await io.exec("obj", "lock", "lock", _lock(who, "shared"))
           for who in ("client.a", "client.b")]
    got.append(await _rc_of(p, io.exec("obj", "lock", "lock",
                                       _lock("client.a", "exclusive"))))
    got.append(await io.exec("obj", "lock", "unlock", _lock("client.b")))
    got.append(await io.exec("obj", "lock", "lock",
                             _lock("client.a", "exclusive")))
    await stop_services_cluster(mon, osds, rados)
    return got


def test_cls_lock_shared_upgrade_blocked():
    assert_equal_across(on_each_package(_cls_lock_shared_upgrade_blocked))


# ---------------------------------------------------------------------------
# the daemons' stats commands over the wire

async def _stats_commands(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    rados = await cluster.client()
    await rados.mon_command(
        "osd erasure-code-profile set", name="k2m1",
        profile={"plugin": "jax_rs", "k": "2", "m": "1",
                 "crush-failure-domain": "osd"})
    await rados.pool_create("ec", pool_type="erasure",
                            erasure_code_profile="k2m1", pg_num=2)
    io = await rados.open_ioctx("ec")
    for i in range(4):
        await io.write_full(f"o{i}", bytes([i]) * 5000)
    got = {}
    for osd_id in sorted(cluster.osds):
        mesh = await rados.osd_daemon_command(osd_id, "ec_mesh_stats")
        mesh.pop("tid", None)
        got[osd_id] = mesh
    await rados.shutdown()
    await cluster.stop()
    return got


def test_ec_mesh_stats_over_the_wire():
    """``ec_mesh_stats`` names the single-device plane for every primary EC
    PG, with the same plane counters and launch buckets on both packages
    (the port's ECBackend carries the JAX backend's plane attributes; the
    mesh options are off here, tests/test_torch_mesh_coalesce.py turns
    them on)."""
    out = on_each_package(_stats_commands)
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]
    planes = [pg["plane"] for osd in out["ceph_tpu"].values()
              for key, pg in osd.items() if key != "host"]
    assert planes and set(planes) == {"single-device"}


def test_sub_op_payloads_are_bytes(monkeypatch):
    """The port's primary hands its peers host bytes: ``NetworkShard.
    write_shard`` wraps its data in ``bytes`` for the wire, which is right
    only because ``ECBackend`` passes it ``bytes``; a tensor must never
    reach it."""
    import torch

    p = PKGS["ceph_tpu_torch"]
    shard_cls = importlib.import_module(
        "ceph_tpu_torch.osd.daemon").NetworkShard
    seen = []
    write = shard_cls.write_shard

    async def spy(self, oid, offset, data, attrs, log=None):
        seen.append(type(data))
        assert not isinstance(data, torch.Tensor)
        assert not any(isinstance(v, torch.Tensor) for v in attrs.values())
        return await write(self, oid, offset, data, attrs, log)

    monkeypatch.setattr(shard_cls, "write_shard", spy)
    p.reset_local_namespace()
    try:
        asyncio.run(_ec_pool_io_round_trip(p))
    finally:
        p.reset_local_namespace()
    assert seen and set(seen) <= {bytes, bytearray, memoryview}
