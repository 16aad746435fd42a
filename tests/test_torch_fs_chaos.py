"""The port's CephFS among the other subsystems, and the mgr's snapshot
schedules, against the JAX package's.

The scenarios of tests/test_chaos_combo.py (cephx, secure mode, a cache
tier, a mgr and an MDS together while OSDs are killed and revived; the
balancer, cross-rank renames and links, caps and quotas under an OSD's
loss) and test_deepcopy_snapsched.py's snapshot schedule (the mgr's
``SnapSchedule`` module taking a due snapshot through the CephFS client)
run on both packages, the port's daemons on ``device="cpu"``, each with
its transcript (see tests/test_torch_cephfs.py) equal across them.  The
schedule takes a snapshot every 0.3 s until the scenario removes it, so
how many it took (and pruned) by then follows the clock: in the twin it
stands still once it holds as many as it retains, on both packages, and
``test_snap_schedule_retention_equal_across_packages`` drives its pruning
on a clock of its own.

Not twinned: test_chaos_combo's two-rank CephFS on FileStores
(``test_round3_features_together_under_failures``), a known unsteady
reference test.  It gives the second MDS 15 s to take rank 1, and it
removes a snapshot right after reviving the OSD it killed, while that
OSD's PGs still recover: under six test workers the MDS's write to the
snapshot's dirfrag copy can meet the recovery and fail with EIO (seen in
the port's twin and in the reference test itself; both packages run the
same code).  The port runs the same path below, with a minute for the
rank and the PGs clean before the removal.
"""

import asyncio
import functools
import importlib
import json

import pytest

from test_torch_cephfs import run_fs_twin
from test_torch_rgw import ROOTS, scenarios

SCENARIOS = [
    *scenarios("test_chaos_combo",
               ["test_everything_on_under_failures",
                "test_session_features_together_under_failures"]),
    *scenarios("test_deepcopy_snapsched", ["test_snap_schedule_module"]),
]


# The scenario polls the snapshots until the schedule has taken and pruned
# enough of them: how many polls follows the clock (see
# ``polls_collapsed``).
POLLED = {"test_snap_schedule_module"}


def _stands_at_retention(serve_once):
    """``SnapSchedule.serve_once`` that does nothing once every schedule
    holds as many snapshots as it retains."""
    @functools.wraps(serve_once)
    async def serve(self):
        if self._status and all(
                st.get("scheduled_snaps", 0) >= st.get("retain", 0) > 0
                for st in self._status.values()):
            return
        await serve_once(self)
    return serve


@pytest.mark.parametrize("ref,name", SCENARIOS)
def test_fs_chaos_scenario_equal_across_packages(ref, name, monkeypatch,
                                                 tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        if name in POLLED:
            for root in ROOTS:
                cls = importlib.import_module(
                    f"{root}.services.mgr_modules").SnapSchedule
                mp.setattr(cls, "serve_once",
                           _stands_at_retention(cls.serve_once))
        run_fs_twin(ref, name, monkeypatch, polled=name in POLLED,
                    tmp_path=tmp_path)


class _Clock:
    """``time`` for the manager's modules: ``time()`` reads ``now``."""

    def __init__(self, now):
        self.now = now

    def time(self):
        return self.now

    def __getattr__(self, name):
        return getattr(__import__("time"), name)


async def _retention(root, monkeypatch):
    """On package ``root``'s dev cluster: a schedule of period 60 s that
    retains 2, served at 0, 30, 60 and 120 s of its module's clock; what
    the directory's snapshots are after each cycle."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    device = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    mod("msg").reset_local_namespace()
    clock = _Clock(1_700_000_000.0)
    monkeypatch.setattr(mod("services.mgr_modules"), "time", clock)
    cluster = mod("vstart").DevCluster(n_mons=1, n_osds=3, **device)
    await cluster.start()
    try:
        rados = await cluster.client()
        for pool in ("cephfs_meta", "cephfs_data"):
            await rados.pool_create(pool, pg_num=4)
        await cluster.start_mds(block_size=4096)
        fs = await mod("client.fs").CephFS.connect(rados)
        await fs.mount()
        await fs.mkdirs("/data")
        await fs.write_file("/data/f", b"x" * 5000)
        r = await rados.mon_command(
            "config-key set", key="snap_sched/data",
            value=json.dumps({"period": 60.0, "retain": 2}))
        assert r["rc"] == 0, r

        class Mgr:
            name = "client.admin"
            conf = cluster.conf_for("client.admin")
            monc = rados.monc

        sched = mod("services.mgr_modules").SnapSchedule(Mgr())
        seen = []
        for at in (0.0, 30.0, 60.0, 120.0):
            clock.now = 1_700_000_000.0 + at
            await sched.serve_once()
            seen.append((sorted(await fs.listsnaps("/data")),
                         sched._status["/data"]["scheduled_snaps"]))
        await sched.stop()
        await fs.unmount()
        await rados.shutdown()
        return seen
    finally:
        await cluster.stop()
        mod("msg").reset_local_namespace()


def test_snap_schedule_retention_equal_across_packages(monkeypatch):
    """The schedule's pruning, which the twin above stops short of: a
    snapshot at each due cycle (none at 30 s, within the period), and the
    oldest removed once a third would exceed the retention; both packages
    give equal results."""
    out = {root: asyncio.run(_retention(root, monkeypatch))
           for root in ROOTS}
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]
    name = "scheduled-{}".format
    assert out["ceph_tpu_torch"] == [
        ([name(1700000000000)], 1),
        ([name(1700000000000)], 1),
        ([name(1700000000000), name(1700000060000)], 2),
        ([name(1700000060000), name(1700000120000)], 2)]


def test_two_rank_cephfs_on_filestores_through_an_osd_loss(tmp_path):
    """test_chaos_combo's round-3 path on the port: a FileStore-backed
    cluster runs a two-rank CephFS with an exported subtree and a COW
    snapshot while osd.2 is killed and revived; every read stays exact,
    and once the PGs are clean again the snapshot is removed."""
    from ceph_tpu_torch.client.fs import CephFS
    from ceph_tpu_torch.store import FileStore
    from ceph_tpu_torch.vstart import DevCluster
    from chip_smoke import pgs_clean

    async def run():
        cluster = DevCluster(n_mons=1, n_osds=3, store_dir=str(tmp_path),
                             store_kind="file", device="cpu")
        await cluster.start()
        try:
            admin = await cluster.client()
            for pool in ("cephfs_meta", "cephfs_data"):
                await admin.pool_create(pool, pg_num=4, size=3, min_size=2)
            mds_a = await cluster.start_mds(name="a", block_size=4096)
            mds_b = await cluster.start_mds(name="b", block_size=4096)
            r = await admin.mon_command("fs set_max_mds", fs_name="cephfs",
                                        max_mds=2)
            assert r["rc"] == 0, r
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 60
            while mds_b.rank != 1:
                assert loop.time() < deadline
                await asyncio.sleep(0.05)
            rados = await cluster.client("client.fs")
            fs = CephFS(rados, str(mds_a.msgr.my_addr))
            await fs.mount()
            await fs.mkdirs("/exported/deep")
            await fs.export_dir("/exported", 1)
            await fs.write_file("/exported/deep/f", b"rank1-data")
            await fs.mkdirs("/snapped")
            await fs.write_file("/snapped/doc", b"version-one")
            await fs.mksnap("/snapped", "s1")
            await fs.write_file("/snapped/doc", b"version-two")

            await cluster.kill_osd(2)
            assert await fs.read_file("/exported/deep/f") == b"rank1-data"
            assert await fs.read_file("/snapped/.snap/s1/doc") == \
                b"version-one"
            assert await fs.read_file("/snapped/doc") == b"version-two"
            await fs.write_file("/exported/during-failure",
                                b"still-writable")
            await cluster.revive_osd(2)
            assert isinstance(cluster.osds[2].store, FileStore)
            assert await fs.read_file("/exported/during-failure") == \
                b"still-writable"
            deadline = loop.time() + 60
            while not (len(cluster.osds) == 3
                       and pgs_clean(cluster.osds.values())):
                assert loop.time() < deadline, "PGs never clean"
                await asyncio.sleep(0.1)
            await fs.rmsnap("/snapped", "s1")
            assert await fs.listsnaps("/snapped") == {}
            assert await fs.read_file("/snapped/doc") == b"version-two"
            await admin.shutdown()
            await fs.unmount()
            await rados.shutdown()
        finally:
            await cluster.stop()

    asyncio.run(run())
