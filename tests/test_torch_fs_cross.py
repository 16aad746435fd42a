"""A CephFS written by one package's MDS and client, mounted, read and
extended by the other's, both ways.

One cluster over TCP: a JAX mon, port osd.0 and osd.2 on the CPU, JAX
osd.1 and osd.3.  Two filesystems, each on a replicated metadata pool and
a k=2 m=1 erasure-coded data pool of its own: on ``fsa`` the JAX package's
MDS and client write a tree (directories, files across blocks, a symlink,
a hard link, a rename, a quota), then the JAX MDS stops and the port's MDS
takes the filesystem over; the port's client reads every file back
exactly, the ``readdir`` and ``stat`` of every directory and file equal to
the writer's, and extends it.  On ``fsb`` the same runs the other way
round.  The two filesystems' pools, read at the end through one client,
must be equal object by object once every MDS has stopped: every
dirfrag's dentries, the ino, anchor and quota tables, and every file block
and backtrace in the data pool, with the inodes' times compared by shape
(``test_torch_cephfs.fs_norm``); so must the writers' journal frames, read
before their MDSs stopped.  (The extending MDS replays and compacts its
journal on a takeover whose timing the monitor decides, so its frames are
compared only through the state they leave.)
"""

import asyncio

import numpy as np

from test_torch_cephfs import fs_norm
from test_torch_cluster_mixed import OVERRIDES, _osd_factory, _stop
from test_torch_mon import free_ports

BLOCK = 4096
MDS_OVERRIDES = {"mds_beacon_interval": 0.1, "mds_beacon_grace": 3.0}


def _pkg(root):
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return mod


async def _start_mds(root, name, monmap, port, fs_name):
    mod = _pkg(root)
    conf = mod("common.config").ConfigProxy(
        overrides={**OVERRIDES, **MDS_OVERRIDES})
    mds = mod("mds.daemon").MDSDaemon(
        name, monmap, conf, addr=f"tcp://127.0.0.1:{port}",
        meta_pool=f"meta-{fs_name}", data_pool=f"data-{fs_name}",
        block_size=BLOCK, fs_name=fs_name)
    await mds.start()
    return mds


async def _mount(root, rados, fs_name):
    fs = await _pkg(root)("client.fs").CephFS.connect(rados, fs_name,
                                                      timeout=30.0)
    await fs.mount()
    return fs


async def _active(rados, fs_name, name):
    loop = asyncio.get_running_loop()
    end = loop.time() + 30
    while True:
        r = await rados.mon_command("mds stat")
        act = r["data"]["filesystems"].get(fs_name, {}).get("active")
        if act and act["name"] == name:
            return
        assert loop.time() < end, r
        await asyncio.sleep(0.05)


async def _write_tree(fs, rng):
    """The writer's tree; returns every file's bytes by path."""
    want = {}
    await fs.mkdirs("/proj/src/deep")
    await fs.mkdirs("/proj/docs")
    for path, n in (("/proj/src/a.py", 9000), ("/proj/src/deep/b.bin",
                                                 3 * BLOCK + 17),
                    ("/proj/docs/readme", 100), ("/top", 5000)):
        want[path] = rng.bytes(n)
        await fs.write_file(path, want[path])
    fh = await fs.open("/proj/src/a.py", "a")
    tail = rng.bytes(700)
    await fh.write(tail)
    await fh.close()
    want["/proj/src/a.py"] += tail
    await fs.symlink("/proj/docs/readme", "/readme-link")
    await fs.link("/top", "/proj/top-link")
    want["/proj/top-link"] = want["/top"]
    await fs.rename("/proj/docs/readme", "/proj/docs/README")
    want["/proj/docs/README"] = want.pop("/proj/docs/readme")
    await fs.setquota("/proj", max_bytes=1 << 20, max_files=50)
    return want


async def _extend(fs, rng, want):
    """The other package's additions to the tree it took over."""
    await fs.mkdir("/proj/added")
    for path, n in (("/proj/added/c", 2 * BLOCK + 5), ("/new", 300)):
        want[path] = rng.bytes(n)
        await fs.write_file(path, want[path])
    fh = await fs.open("/proj/src/deep/b.bin", "r")
    patch = rng.bytes(1000)
    await fh.write(patch, 4000)              # write-through, EC RMW
    await fh.close()
    data = bytearray(want["/proj/src/deep/b.bin"])
    data[4000:5000] = patch
    want["/proj/src/deep/b.bin"] = bytes(data)
    await fs.unlink("/proj/top-link")
    del want["/proj/top-link"]


async def _view(fs, want):
    """What a client sees: every file's bytes, every directory's names
    with their dentries' types and sizes, the link, the quota."""
    files = {p: await fs.read_file(p) for p in sorted(want)}
    dirs = {}
    for d in ("/", "/proj", "/proj/src", "/proj/src/deep", "/proj/docs"):
        dirs[d] = sorted((n, e["type"], int(e.get("size", 0)))
                         for n, e in (await fs.readdir(d)).items())
    quota = await fs.getquota("/proj")
    return {"files": files, "dirs": dirs,
            "link": await fs.readlink("/readme-link"),
            "quota": quota["quota"]}


async def _dump(rados, fs_name):
    """Every object of the filesystem's two pools: data, xattrs, omap."""
    out = []
    for kind in ("meta", "data"):
        io = await rados.open_ioctx(f"{kind}-{fs_name}")
        for oid in sorted(await io.list_objects()):
            try:
                omap = fs_norm(await io.get_omap(oid))
            except Exception as e:       # an EC pool keeps no omap
                omap = type(e).__name__
            size = (await io.stat(oid))["size"]
            out.append((kind, oid, fs_norm(await io.read(oid, size)),
                        fs_norm(await io.get_xattrs(oid)), omap))
    return out


def test_filesystem_carried_across_packages_both_ways():
    import ceph_tpu.client as jax_client
    import ceph_tpu.common.config as jax_config
    import ceph_tpu.mon as jax_mon
    import ceph_tpu_torch.client as port_client
    import ceph_tpu_torch.common.config as port_config

    async def run():
        ports = free_ports(9)
        monmap = {"a": f"tcp://127.0.0.1:{ports[0]}"}
        mon = jax_mon.Monitor("a", monmap, jax_config.ConfigProxy(
            overrides=dict(OVERRIDES)))
        await mon.start()
        osds, mdss, clients = [], [], []
        try:
            for i in range(4):
                make, conf = _osd_factory(i, True)
                osd = make(i, monmap, conf(overrides=dict(OVERRIDES)),
                           host=f"h{i}",
                           addr=f"tcp://127.0.0.1:{ports[1 + i]}")
                await osd.start()
                osds.append(osd)
            rados = {}
            for root, pkg, conf in (("ceph_tpu", jax_client, jax_config),
                                    ("ceph_tpu_torch", port_client,
                                     port_config)):
                for who in ("w", "x"):
                    r = pkg.Rados(monmap, conf.ConfigProxy(
                        overrides=dict(OVERRIDES)), name=f"client.{who}")
                    await r.connect()
                    clients.append(r)
                    rados[root, who] = r
            admin = rados["ceph_tpu", "w"]
            r = await admin.mon_command(
                "osd erasure-code-profile set", name="fsx",
                profile={"plugin": "jax_rs", "k": "2", "m": "1",
                         "crush-failure-domain": "osd"})
            assert r["rc"] == 0, r
            views, journals = {}, {}
            mds_port = iter(ports[5:])
            for fs_name, writer, reader in (
                    ("fsa", "ceph_tpu", "ceph_tpu_torch"),
                    ("fsb", "ceph_tpu_torch", "ceph_tpu")):
                await admin.pool_create(f"meta-{fs_name}", pg_num=4)
                await admin.pool_create(f"data-{fs_name}",
                                        pool_type="erasure",
                                        erasure_code_profile="fsx",
                                        pg_num=4)
                r = await admin.mon_command(
                    "fs new", fs_name=fs_name, metadata=f"meta-{fs_name}",
                    data=f"data-{fs_name}")
                assert r["rc"] == 0, r
                rng = np.random.default_rng(7)
                mds = await _start_mds(writer, f"{fs_name}-w", monmap,
                                       next(mds_port), fs_name)
                mdss.append(mds)
                await _active(admin, fs_name, f"{fs_name}-w")
                fs = await _mount(writer, rados[writer, "w"], fs_name)
                want = await _write_tree(fs, rng)
                written = await _view(fs, want)
                await fs.unmount()
                meta = await admin.open_ioctx(f"meta-{fs_name}")
                journals[fs_name] = fs_norm(await meta.read("mds_journal"))
                await _stop(mdss.pop())
                mds = await _start_mds(reader, f"{fs_name}-x", monmap,
                                       next(mds_port), fs_name)
                mdss.append(mds)
                await _active(admin, fs_name, f"{fs_name}-x")
                fs = await _mount(reader, rados[reader, "x"], fs_name)
                read = await _view(fs, want)
                assert read == written
                assert read["files"] == {p: want[p] for p in sorted(want)}
                await _extend(fs, rng, want)
                views[fs_name] = (written, await _view(fs, want))
                await fs.unmount()
            # the extended trees, each read through the package that did
            # not extend it, and both filesystems' objects
            for fs_name, root in (("fsa", "ceph_tpu"),
                                  ("fsb", "ceph_tpu_torch")):
                fs = await _mount(root, rados[root, "w"], fs_name)
                _, extended = views[fs_name]
                assert await _view(fs, {p: None for p in
                                        extended["files"]}) == extended
                await fs.unmount()
            assert views["fsa"] == views["fsb"]
            # the writers' journals, read before their MDSs stopped
            assert journals["fsa"] == journals["fsb"]
            assert journals["fsa"][0] == "frames"
            assert [e[0] for e in journals["fsa"][1]][:3] == [
                ("op", "mkdir")] * 3
            # every MDS stopped (each compacts its journal into the table)
            while mdss:
                await _stop(mdss.pop())
            dumps = {n: await _dump(admin, n) for n in ("fsa", "fsb")}
            assert [o[:2] for o in dumps["fsa"]] == \
                [o[:2] for o in dumps["fsb"]]
            for a, b in zip(dumps["fsa"], dumps["fsb"]):
                assert a == b, (a, b)
            # six files and the symlink carry a backtrace
            assert sum(o[1].endswith(".bt") for o in dumps["fsa"]) == 7
        finally:
            for c in clients:
                await c.shutdown()
            for m in mdss:
                await _stop(m)
            for osd in osds:
                await _stop(osd)
            await mon.shutdown()

    asyncio.run(run())
