"""The port's block images against the JAX package's.

The scenarios of tests/test_rbd_{clone,excl_lock,groups_ns,journal,mirror,
pwl}.py (clones and copy-up, the object map, the write-back cache,
exclusive locks, consistency groups and namespaces, the image journal and
its replay, snapshot and journal mirroring, the persistent write-back log)
and the RBD cases of tests/test_services.py, test_snapshots.py,
test_mgr_perf.py (iostat, and the mgr's scheduled trash purge through
``RBDSupport``) and test_deepcopy_snapsched.py run on both packages, the
port's daemons on ``device="cpu"``, each with its transcript (see
tests/test_torch_rgw.py) equal across them: every call into ``RBD``,
``Image``, ``RBDGroups``, ``RBDMirror``, the journal and the write-back
log with its result or error, and at teardown every RADOS object of every
pool.  A last test carries images written by one package's ``RBD`` (a
plain one, a journaled one with entries not yet applied, a clone) to the
other's, both ways.
"""

import asyncio

import pytest

from test_torch_rgw import run_twin_scenario, scenarios

RBD = [
    *scenarios("test_rbd_clone"),
    *scenarios("test_rbd_excl_lock"),
    *scenarios("test_rbd_groups_ns"),
    *scenarios("test_rbd_journal"),
    *scenarios("test_rbd_mirror"),
    *scenarios("test_rbd_pwl"),
    *scenarios("test_services", ["test_rbd_image_lifecycle"]),
    *scenarios("test_snapshots", ["test_rbd_snapshot_read_and_rollback"]),
    *scenarios("test_mgr_perf", ["test_rbd_perf_image_iostat_shows_live_ops",
                                 "test_scheduled_trash_purge_fires"]),
    *scenarios("test_deepcopy_snapsched", [
        "test_deep_copy_replays_snapshot_history",
        "test_deep_copy_zeroed_regions_do_not_resurrect",
        "test_migrate_moves_and_removes_source"]),
]


# A writer loops until the mgr's iostat shows its ops, and a scenario
# polls the trash until the mgr's RBD support has purged it: how many
# writes and polls follows the clock (see ``polls_collapsed``).
POLLED = {"test_rbd_perf_image_iostat_shows_live_ops",
          "test_scheduled_trash_purge_fires"}


@pytest.mark.parametrize("ref,name", RBD)
def test_rbd_scenario_equal_across_packages(ref, name, monkeypatch,
                                            tmp_path):
    run_twin_scenario(ref, name, monkeypatch, polled=name in POLLED,
                      tmp_path=tmp_path)


# -- images carried across the packages ---------------------------------------

ORDER, SIZE = 16, 1 << 20          # 64 KiB objects, 16 of them


async def _write_images(pkg, io, tag, seed):
    """Images written through one package's ``RBD``: a plain one, a parent
    with a protected snapshot and a clone written over part of it (copy-up),
    and a journaled one whose last write reached its journal only (the
    writer died before applying it).  Returns what each image holds."""
    import numpy as np

    rbd_mod = __import__(f"{pkg}.services.rbd", fromlist=["RBD"])
    journal = __import__(f"{pkg}.services.rbd_journal",
                         fromlist=["EV_WRITE"])
    rng = np.random.default_rng(seed)
    rbd = rbd_mod.RBD(io)
    want = {}

    plain = bytearray(SIZE)
    await rbd.create(f"{tag}-plain", SIZE, order=ORDER)
    img = await rbd.open(f"{tag}-plain")
    for off, n in ((0, 70000), (300001, 5000), (SIZE - 4096, 4096)):
        data = rng.bytes(n)
        await img.write(off, data)
        plain[off:off + n] = data
    await img.close()
    want[f"{tag}-plain"] = bytes(plain)

    parent = bytearray(SIZE)
    await rbd.create(f"{tag}-parent", SIZE, order=ORDER)
    img = await rbd.open(f"{tag}-parent")
    data = rng.bytes(200000)
    await img.write(10000, data)
    parent[10000:210000] = data
    await img.snap_create("s")
    await img.snap_protect("s")
    await img.write(0, b"after-snap" * 100)        # not in the clone
    await img.close()
    await rbd.clone(f"{tag}-parent", "s", f"{tag}-clone")
    clone = bytearray(parent)
    img = await rbd.open(f"{tag}-clone")
    data = rng.bytes(30000)
    await img.write(150000, data)                  # copy-up of object 2
    clone[150000:180000] = data
    await img.close()
    parent[0:1000] = b"after-snap" * 100
    want[f"{tag}-parent"] = bytes(parent)
    want[f"{tag}-clone"] = bytes(clone)

    jrnl = bytearray(SIZE)
    await rbd.create(f"{tag}-jrnl", SIZE, order=ORDER)
    img = await rbd.open(f"{tag}-jrnl", journaled=True)
    data = rng.bytes(9000)
    await img.write(4096, data)
    jrnl[4096:13096] = data
    tail = rng.bytes(5000)
    await img._journal.append(journal.EV_WRITE,
                              {"off": 500000, "data": tail})
    jrnl[500000:505000] = tail
    want[f"{tag}-jrnl"] = bytes(jrnl)
    return want


async def _read_images(pkg, io, names):
    rbd_mod = __import__(f"{pkg}.services.rbd", fromlist=["RBD"])
    rbd = rbd_mod.RBD(io)
    out = {}
    for name in names:
        img = await rbd.open(name, journaled=name.endswith("-jrnl"))
        out[name] = (await img.read(0, SIZE), img.stat()["size"],
                     [s["name"] for s in img.snap_list()],
                     img.parent is not None)
        await img.close()
    return out


def test_images_read_back_across_packages():
    """One cluster over TCP (a JAX mon, port osd.0 and osd.2 on the CPU,
    JAX osd.1 and osd.3): the JAX package's ``RBD`` writes a plain image, a
    parent with a protected snapshot and its clone, and a journaled image
    with an entry its writer never applied; the port's reads every image
    back exactly (replaying the journal on open), and the other way round.
    Sizes, snapshots and the clone's parent link agree too."""
    from test_torch_cluster_mixed import OVERRIDES, _osd_factory, _stop
    from test_torch_mon import free_ports

    import ceph_tpu.client as jax_client
    import ceph_tpu.common.config as jax_config
    import ceph_tpu.mon as jax_mon
    import ceph_tpu_torch.client as port_client
    import ceph_tpu_torch.common.config as port_config

    async def run():
        ports = free_ports(5)
        monmap = {"a": f"tcp://127.0.0.1:{ports[0]}"}
        mon = jax_mon.Monitor("a", monmap, jax_config.ConfigProxy(
            overrides=dict(OVERRIDES)))
        await mon.start()
        osds = []
        for i in range(4):
            make, conf = _osd_factory(i, True)
            osd = make(i, monmap, conf(overrides=dict(OVERRIDES)),
                       host=f"h{i}", addr=f"tcp://127.0.0.1:{ports[1 + i]}")
            await osd.start()
            osds.append(osd)
        clients = []
        try:
            for pkg, conf, name in (
                    (jax_client, jax_config, "client.jax"),
                    (port_client, port_config, "client.port")):
                rados = pkg.Rados(monmap, conf.ConfigProxy(
                    overrides=dict(OVERRIDES)), name=name)
                await rados.connect()
                clients.append(rados)
            await clients[0].pool_create("rbd", pg_num=8)
            ios = {"ceph_tpu": await clients[0].open_ioctx("rbd"),
                   "ceph_tpu_torch": await clients[1].open_ioctx("rbd")}
            for writer, reader in (("ceph_tpu", "ceph_tpu_torch"),
                                   ("ceph_tpu_torch", "ceph_tpu")):
                tag = "from-" + writer.split("_")[-1]
                want = await _write_images(writer, ios[writer], tag,
                                           seed=len(writer))
                got = await _read_images(reader, ios[reader], want)
                assert {n: g[0] for n, g in got.items()} == want
                assert got[f"{tag}-parent"][2] == ["s"]
                assert got[f"{tag}-clone"][3] and \
                    not got[f"{tag}-plain"][3]
                assert {g[1] for g in got.values()} == {SIZE}
                # the writer's own package agrees, the journal now applied
                own = await _read_images(writer, ios[writer], want)
                assert own == got
        finally:
            for c in clients:
                await c.shutdown()
            for osd in osds:
                await _stop(osd)
            await mon.shutdown()

    asyncio.run(run())
