"""Port and JAX OSD daemons in one cluster, over TCP.

One JAX package ``Monitor``, two port ``OSDDaemon``s (osd.0 and osd.2,
codecs on ``device="cpu"``) and two JAX ones (osd.1 and osd.3) on
loopback TCP serve one jax_rs k=2 m=1 pool of 4 PGs.  Objects are written
in turn through the JAX package's ``Rados`` and the port's, so each
package's primary fans sub-ops out to the other package's daemons and
takes theirs.  Every store's shard bytes, hinfo and version attrs must
equal those of an all-JAX cluster given the same writes.  Then every
object is read degraded with a port OSD killed, and again, once it is
revived and the PGs are clean, with a JAX OSD killed (each marked down by
``osd down``).  No OSD but a victim may be marked down.  Tolerance 0.
"""

import asyncio
import functools
import io

import numpy as np

from tests.test_torch_cluster import recovered
from tests.test_torch_mon import free_ports

import ceph_tpu.client as jax_client
import ceph_tpu.common.config as jax_config
import ceph_tpu.mon as jax_mon
import ceph_tpu.osd.daemon as jax_daemon
import ceph_tpu_torch.client as port_client
import ceph_tpu_torch.common.config as port_config
import ceph_tpu_torch.osd.daemon as port_daemon

OVERRIDES = {
    "mon_lease": 0.4, "mon_lease_interval": 0.1,
    "mon_election_timeout": 0.3, "mon_tick_interval": 0.1,
    "mon_accept_timeout": 0.5,
    # a first JAX compile stalls the shared loop for seconds: liveness
    # must not mark anyone down for it; the victims are marked down by
    # the operator's "osd down"
    "osd_heartbeat_interval": 0.5, "osd_heartbeat_grace": 20.0,
    "mon_osd_down_out_interval": 300.0,
}
PORT_OSDS = (0, 2)
JAX_VICTIM, PORT_VICTIM = 1, 0
OBJECTS = 12
SEED = 13


def _osd_factory(osd_id, mixed):
    if mixed and osd_id in PORT_OSDS:
        return (functools.partial(port_daemon.OSDDaemon, device="cpu"),
                port_config.ConfigProxy)
    return jax_daemon.OSDDaemon, jax_config.ConfigProxy


def _payloads():
    rng = np.random.default_rng(SEED)
    return {f"obj-{i}": rng.bytes(int(rng.integers(1, 40000)))
            for i in range(OBJECTS)}


def _shards(osds, pool_id):
    """(osd, pg, shard, object) -> (bytes, hinfo, version) of every EC
    shard object of the pool."""
    out = {}
    for osd in osds.values():
        st = osd.store
        for cid in st.list_collections():
            if cid.pool != pool_id or cid.shard < 0:
                continue
            for oid in st.list_objects(cid):
                attrs = st.getattrs(cid, oid)
                out[(osd.osd_id, cid.pg, cid.shard, oid.name)] = (
                    st.read(cid, oid), attrs.get("hinfo"),
                    attrs.get("version"))
    return out


async def _stop(daemon, timeout=10.0):
    """``daemon.shutdown()``, given up after ``timeout`` seconds.  A TCP
    messenger's shutdown awaits ``Server.wait_closed()``, which since
    Python 3.12.1 also waits for every connection the server accepted;
    one that a live peer still held open stalled a daemon's shutdown
    (both packages' messengers, about 1 run in 35: ROADMAP Queue C).  The
    daemon has marked its sessions down and closed its listener by then,
    and everything the test compares was read before."""
    try:
        await asyncio.wait_for(daemon.shutdown(), timeout)
    except asyncio.TimeoutError:
        pass


async def _until(cond, what, timeout=20.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        assert loop.time() < deadline, what
        await asyncio.sleep(0.05)


async def _scenario(mixed):
    ports = free_ports(5)
    monmap = {"a": f"tcp://127.0.0.1:{ports[0]}"}
    mon = jax_mon.Monitor("a", monmap, jax_config.ConfigProxy(
        overrides=dict(OVERRIDES)))
    await mon.start()
    osds = {}

    async def start_osd(i, store=None):
        make, conf = _osd_factory(i, mixed)
        osd = make(i, monmap, conf(overrides=dict(OVERRIDES)), host=f"h{i}",
                   addr=f"tcp://127.0.0.1:{ports[1 + i]}", store=store)
        await osd.start()
        osds[i] = osd

    for i in range(4):
        await start_osd(i)
    clients = []
    for pkg, name in ((jax_client, "client.jax"),
                      (port_client, "client.port")):
        conf = (jax_config if pkg is jax_client else port_config)
        rados = pkg.Rados(monmap, conf.ConfigProxy(
            overrides=dict(OVERRIDES)), name=name)
        await rados.connect()
        clients.append(rados)
    try:
        r = await clients[0].mon_command(
            "osd erasure-code-profile set", name="k2m1",
            profile={"plugin": "jax_rs", "k": "2", "m": "1",
                     "crush-failure-domain": "osd"})
        assert r["rc"] == 0, r
        pool_id = await clients[0].pool_create(
            "ec", pool_type="erasure", erasure_code_profile="k2m1",
            pg_num=4)
        ios = [await c.open_ioctx("ec") for c in clients]
        datas = _payloads()
        for i, (oid, data) in enumerate(datas.items()):
            io = ios[i % 2]
            await io.write_full(oid, data)
            if i % 3 == 0:
                patch = bytes([i]) * 700
                await ios[(i + 1) % 2].write(oid, patch, 100)
                datas[oid] = data[:100] + patch + data[800:] \
                    if len(data) > 800 else data[:100] + patch
        shards = _shards(osds, pool_id)
        reads = []
        for victim in (PORT_VICTIM, JAX_VICTIM):
            store = osds[victim].store
            await _stop(osds.pop(victim))
            r = await clients[0].mon_command("osd down", ids=[victim])
            assert r["rc"] == 0, r
            await _until(lambda: not mon.osd_monitor.osdmap.is_up(victim),
                         f"osd.{victim} down")
            for io in ios:
                got = [await io.read(oid) for oid in datas]
                assert got == list(datas.values()), victim
                reads.append(got)
            await start_osd(victim, store)
            await _until(lambda: mon.osd_monitor.osdmap.is_up(victim),
                         f"osd.{victim} up")
            await recovered(osds)
        kinds = {i: type(o).__module__ for i, o in osds.items()}
        downs = sorted({o for inc in mon.osd_monitor.incrementals_since(0)
                        for o in inc["new_down"]})
        assert downs == sorted((PORT_VICTIM, JAX_VICTIM)), downs
        return shards, reads, kinds
    finally:
        for daemon in [*clients, *osds.values(), mon]:
            await _stop(daemon)


async def _bounded(coro, timeout=240.0):
    """``coro``, or an assertion naming every pending task's stack if it
    has not finished in ``timeout`` seconds."""
    task = asyncio.ensure_future(coro)
    done, _ = await asyncio.wait({task}, timeout=timeout)
    if not done:
        stacks = []
        for t in asyncio.all_tasks():
            buf = io.StringIO()
            t.print_stack(limit=8, file=buf)
            stacks.append(buf.getvalue())
        task.cancel()
        raise AssertionError("stalled:\n" + "\n".join(stacks))
    return task.result()


def test_mixed_cluster_writes_the_all_jax_clusters_shards():
    mixed = asyncio.run(_bounded(_scenario(True)))
    ref = asyncio.run(_bounded(_scenario(False)))
    assert mixed[2] == {0: "ceph_tpu_torch.osd.daemon",
                        1: "ceph_tpu.osd.daemon",
                        2: "ceph_tpu_torch.osd.daemon",
                        3: "ceph_tpu.osd.daemon"}
    assert set(ref[2].values()) == {"ceph_tpu.osd.daemon"}
    shards, ref_shards = mixed[0], ref[0]
    assert shards and set(shards) == set(ref_shards)
    for key in sorted(shards):
        assert shards[key] == ref_shards[key], key
    assert all(v[1] and v[2] for v in shards.values())
    assert {k[0] for k in shards} == {0, 1, 2, 3}
    assert mixed[1] == ref[1] and len(mixed[1]) == 4
