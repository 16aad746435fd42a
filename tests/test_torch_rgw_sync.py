"""The port's multisite sync and realm against the JAX package's.

The scenarios of tests/test_rgw_sync.py (the datalog, full and incremental
sync, the background agent, snapshot trims, sharded cursors and the lag
ledger, last-writer-wins conflicts, version-level reconciliation) and
tests/test_rgw_zone.py (the period model, sync reconfigured by period
commits, markers kept across them) run on both packages, the port's
daemons on ``device="cpu"``, each with its transcript (see
tests/test_torch_rgw.py) equal across them: every call into the gateway,
the sync agent and the realm store with its result, and at teardown every
RADOS object of every pool.  Calls the agents' background loops make are
not recorded: they follow the clock.

The zone-loss drills have no reference test: ``run_zone_loss_drill`` and
``run_zone_loss_dr_drill`` run on both packages, the port's realm on
``device="cpu"``, and their reports must be equal but for times.  A last
test resumes one package's sync agent, stopped mid-backlog, with the
other's, over the persisted markers, both ways.
"""

import asyncio

import pytest

from test_torch_rgw import run_twin_scenario, scenarios

SYNC = [*scenarios("test_rgw_sync"), *scenarios("test_rgw_zone")]

# The scenarios whose agents run in the background while the scenario
# polls for convergence (see ``polls_collapsed``); the others step their
# agents with ``sync_once`` and compare every entry.
BACKGROUND = {"test_multisite_background_agent_converges",
              "test_period_commit_reconfigures_sync_without_restarts",
              "test_period_commit_preserves_sync_markers"}


@pytest.mark.parametrize("ref,name", SYNC)
def test_sync_scenario_equal_across_packages(ref, name, monkeypatch):
    run_twin_scenario(ref, name, monkeypatch, polled=name in BACKGROUND)


# -- the zone-loss drills ----------------------------------------------------

def _drill_report(out):
    """A drill's report but for times: the RTO's seconds by their bound,
    the forensic bundle by its presence."""
    slo = dict(out["slo"])
    assert 0 <= slo.pop("rto_s") <= slo["rto_slo_s"]
    assert out["forensics"]["bundle"].endswith(".json")
    return {**{k: v for k, v in out.items() if k != "forensics"},
            "slo": slo}


@pytest.mark.parametrize("drill", ["run_zone_loss_drill",
                                   "run_zone_loss_dr_drill"])
def test_zone_loss_drill_reports_equal_across_packages(drill):
    """Both packages' drills, the port's realm on the CPU: the ledger's
    predicted RPO, the measured RPO (entries, bytes and keys), the
    conflict's winner, the purged orphans and convergence are equal; the
    DR drill rebuilds zone a's mon store with each package's own
    monstore_tool and monmaptool."""
    import ceph_tpu.testing.chaos as jax_chaos
    import ceph_tpu_torch.testing.chaos as port_chaos
    import ceph_tpu.msg as jax_msg
    import ceph_tpu_torch.msg as port_msg

    ref = _drill_report(asyncio.run(getattr(jax_chaos, drill)()))
    jax_msg.reset_local_namespace()
    port = _drill_report(asyncio.run(getattr(port_chaos, drill)(
        device="cpu")))
    port_msg.reset_local_namespace()
    assert port == ref
    assert ref["slo"]["pass"] and ref["slo"]["converged"]
    assert ref["rpo"]["entries"] == ref["ledger"]["entries"] > 0
    assert ref["rpo"]["bytes"] == ref["ledger"]["bytes"] > 0
    assert ref["slo"]["conflict_winner"] == "b"
    assert ref["dr_rebuild"] == (drill == "run_zone_loss_dr_drill")


def test_realm_without_device_raises_without_cuda(monkeypatch):
    """``MultisiteRealm`` and the drill that builds one run on CUDA unless
    asked for the CPU: with no card they raise at the first zone's first
    OSD daemon."""
    import torch

    from ceph_tpu_torch.msg import reset_local_namespace
    from ceph_tpu_torch.testing import chaos
    from ceph_tpu_torch.vstart import MultisiteRealm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for start in (MultisiteRealm(("a", "b")).start,
                  chaos.run_zone_loss_drill):
        reset_local_namespace()
        with pytest.raises(RuntimeError, match="no CUDA device") as e:
            asyncio.run(start())
        frames = [f.name for f in e.traceback]
        assert "_boot_zone" in frames and "start_osd" in frames, frames
    reset_local_namespace()


# -- sync markers carried across the packages ---------------------------------

class AgentKilled(Exception):
    """The first agent dies between two shards of a pass."""


def test_sync_resumes_from_the_other_packages_markers():
    """One cluster over TCP (a JAX mon, port osd.0 and osd.2 on the CPU,
    JAX osd.1 and osd.3), a source and a destination zone's gateway of
    each package over two pools, a datalog of 4 shards.  One package's
    agent full-syncs a bucket, replays part of a backlog and dies between
    two shards of its pass; the other package's agent resumes from the
    markers the first persisted and converges: the destination equals the
    source, the lag is 0, and its ``sync_put_ops`` counts exactly the puts
    the first left behind (none replayed twice).  Both ways."""
    import ceph_tpu.services.rgw as jax_rgw
    import ceph_tpu.services.rgw_sync as jax_sync
    import ceph_tpu_torch.services.rgw as port_rgw
    import ceph_tpu_torch.services.rgw_sync as port_sync
    from test_torch_cluster_mixed import OVERRIDES, _osd_factory, _stop
    from test_torch_mon import free_ports

    import ceph_tpu.client as jax_client
    import ceph_tpu.common.config as jax_config
    import ceph_tpu.mon as jax_mon
    import ceph_tpu_torch.client as port_client
    import ceph_tpu_torch.common.config as port_config

    shards = 4

    async def listing(gw, bucket):
        out = {}
        for c in (await gw.list_objects(bucket))["contents"]:
            out[c["key"]] = (await gw.get_object(bucket, c["key"]))["data"]
        return out

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
            sides = {"jax": (jax_rgw, jax_sync, clients[0]),
                     "port": (port_rgw, port_sync, clients[1])}
            for first, second in (("jax", "port"), ("port", "jax")):
                src_pool, dst_pool = f"src-{first}", f"dst-{first}"
                for pool in (src_pool, dst_pool):
                    await clients[0].pool_create(pool, pg_num=8)

                async def agent(side):
                    rgw, sync, rados = sides[side]
                    src = rgw.RGWLite(await rados.open_ioctx(src_pool),
                                      datalog_shards=shards)
                    dst = rgw.RGWLite(await rados.open_ioctx(dst_pool),
                                      datalog_shards=shards)
                    return src, dst, sync.RGWSyncAgent(
                        src, dst, src_zone="a", dst_zone="b")

                src, dst, a1 = await agent(first)
                bucket = "geo"
                await src.create_bucket(bucket)
                for i in range(6):
                    await src.put_object(bucket, f"base-{i}",
                                         bytes([i]) * 3000)
                assert await a1.sync_once() == 6       # the full sync
                for i in range(16):
                    await src.put_object(bucket, f"back-{i}",
                                         bytes([100 + i]) * (1000 + i))
                await src.delete_object(bucket, "base-0")
                backlog = (await a1.lag())["entries"]
                assert backlog == 17

                # the first agent dies after two shards of its pass
                done = []
                incremental = a1._incremental

                async def dying(b, shard, after):
                    if len(done) == 2:
                        raise AgentKilled(shard)
                    done.append(await incremental(b, shard, after))
                    return done[-1]

                a1._incremental = dying
                with pytest.raises(AgentKilled):
                    await a1.sync_once()
                replayed = int(a1.perf.value("sync_put_ops"))
                left = (await a1.lag())["entries"]
                assert 0 < left < backlog

                _, _, a2 = await agent(second)
                assert (await a2.lag())["entries"] == left
                applied = await a2.sync_once()
                assert applied == left
                assert (await a2.lag())["entries"] == 0
                assert int(a2.perf.value("sync_put_ops")) + replayed \
                    == 6 + 16
                assert int(a2.perf.value("sync_full_passes")) == 0
                assert await listing(dst, bucket) == \
                    await listing(src, bucket)
                assert await listing(a2.dst, bucket) == \
                    await listing(a2.src, bucket)
        finally:
            for c in clients:
                await c.shutdown()
            for osd in osds:
                await _stop(osd)
            await mon.shutdown()

    asyncio.run(run())
