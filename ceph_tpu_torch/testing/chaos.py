"""Seeded chaos harness: Thrasher + failpoints + RadosModel oracle.

Counterpart of ceph_tpu/testing/chaos.py: the same module over the
port's imports.  Its one departure: ``device=`` on ``ChaosHarness`` and on
each drill that builds a cluster, handed to every ``DevCluster`` and
``MultisiteRealm`` it builds (None means CUDA, raising when there is
none); ``run_zone_loss_dr_drill`` hands its keywords, ``device=`` among
them, to ``run_zone_loss_drill``.

The qa thrash-erasure-code suites compose three independent chaos sources
(daemon kill/revive, socket-failure injection, model-based random ops with
an oracle) but leave the interleaving to wall-clock timers, so no run ever
replays.  This harness derives EVERYTHING from one seed:

- an abstract event plan (kill / revive / failpoint arm / clear / calm)
  generated from the seed alone, before the cluster exists;
- concrete kill/revive victims drawn from the Thrasher's seeded rng;
- failpoint prob/delay draws via ``failpoint.set_seed``;
- the op stream and its oracle via ``RadosModel(seed=...)``.

Events are applied between op batches (op count, never wall clock), so two
runs with the same seed produce the SAME recorded schedule, and the model's
invariants must hold in both.  ``run_chaos`` is the one-call entry point;
tests compare ``result["schedule"]`` across runs.
"""

from __future__ import annotations

import asyncio
import random

from ceph_tpu_torch.common import events
from ceph_tpu_torch.common import failpoint as fp
from ceph_tpu_torch.testing.rados_model import RadosModel
from ceph_tpu_torch.testing.thrasher import Thrasher

#: mild, self-healing faults the planner can arm (index-addressed so the
#: plan is stable even if parameters are tuned)
FAILPOINT_MENU: list[tuple[str, str, dict]] = [
    ("msgr.deliver", "delay", {"delay": 0.01}),
    ("osd.sub_op", "delay", {"delay": 0.01}),
    ("msgr.send", "prob", {"p": 0.02}),
    ("osd.recovery", "delay", {"delay": 0.02}),
]


class ChaosHarness:
    def __init__(self, seed: int = 0, n_osds: int = 4, n_batches: int = 10,
                 batch: int = 8, pool_size: int = 3, min_size: int = 2,
                 ec: bool = False, elastic: bool = False, device=None):
        self.seed = seed
        self.n_osds = n_osds
        self.n_batches = n_batches
        self.batch = batch
        self.pool_size = pool_size
        self.min_size = min_size
        # ec=True: the chaos pool is erasure-coded (jax_rs k=2 m=1), so
        # the op stream drives the EC write/read/reconstruct path — with
        # cross-op coalescing on by default, concurrent model ops share
        # device launches under kill/revive/failpoint churn
        self.ec = ec
        # elastic=True widens the plan menu with topology events:
        # add_host boots a brand-new OSD on a brand-new CRUSH host
        # (planned motion starts mid-op-stream), drain_host marks a
        # previously-added host's OSDs out again — so the backfill
        # engine thrashes under the same kill/revive/failpoint churn
        self.elastic = elastic
        self.schedule: list[tuple] = []       # recorded (step, event, arg)
        self.device = device

    def plan(self) -> list[tuple]:
        """Abstract event plan from the seed alone (no cluster state)."""
        rng = random.Random(f"chaos-plan:{self.seed}")
        plan = []
        for b in range(self.n_batches):
            r = rng.random()
            if self.elastic:
                if r < 0.15:
                    plan.append((b, "kill", None))
                elif r < 0.30:
                    plan.append((b, "revive", None))
                elif r < 0.45:
                    plan.append((b, "fp_set",
                                 rng.randrange(len(FAILPOINT_MENU))))
                elif r < 0.55:
                    plan.append((b, "fp_clear", None))
                elif r < 0.70:
                    plan.append((b, "add_host", None))
                elif r < 0.85:
                    plan.append((b, "drain_host", None))
                else:
                    plan.append((b, "calm", None))
                continue
            if r < 0.20:
                plan.append((b, "kill", None))
            elif r < 0.40:
                plan.append((b, "revive", None))
            elif r < 0.60:
                plan.append((b, "fp_set",
                             rng.randrange(len(FAILPOINT_MENU))))
            elif r < 0.75:
                plan.append((b, "fp_clear", None))
            else:
                plan.append((b, "calm", None))
        return plan

    async def run(self) -> dict:
        from ceph_tpu_torch.vstart import DevCluster

        fp.fp_clear()
        fp.set_seed(self.seed)
        self.schedule = []
        cluster = DevCluster(n_mons=1, n_osds=self.n_osds, overrides={
            "mon_osd_down_out_interval": 300.0,   # no auto-out churn
        }, device=self.device)
        await cluster.start()
        # mgr runs so the drill verdict can attach a forensic bundle;
        # the balancer stays off — upmap churn mid-thrash would fight
        # the drill's own kill/revive placement story
        mgr = await cluster.start_mgr(report_interval=0.5)
        mgr.modules["balancer"].active = False
        rados = await cluster.client()
        if self.ec:
            r = await rados.mon_command(
                "osd erasure-code-profile set", name="chaos_ec",
                profile={"plugin": "jax_rs", "k": "2", "m": "1",
                         "crush-failure-domain": "osd"})
            if r["rc"] not in (0, -17):
                raise RuntimeError(f"ec profile: {r}")
            await rados.pool_create("chaos", pg_num=8,
                                    pool_type="erasure",
                                    erasure_code_profile="chaos_ec")
        else:
            await rados.pool_create("chaos", pg_num=8,
                                    size=self.pool_size,
                                    min_size=self.min_size)
        # the mgr's autoscaler would hold health in WARN over the
        # deliberately small test pool, wedging wait_health_ok
        await rados.mon_command("osd pool set", pool="chaos",
                                var="pg_autoscale_mode", val="off")
        io = await rados.open_ioctx("chaos")
        model = RadosModel(io, seed=self.seed, n_objects=8,
                           max_size=1 << 14, ec=self.ec)
        thrasher = Thrasher(cluster, min_live=self.n_osds - 1,
                            seed=self.seed)
        added_hosts: list[str] = []        # growable, drainable
        drained: set[str] = set()
        elastic_rng = random.Random(f"chaos-elastic:{self.seed}")
        try:
            await model.run(self.batch)       # seed some state quietly
            events.emit_proc("chaos.start", seed=self.seed,
                             batches=self.n_batches)
            for step, event, arg in self.plan():
                # flight-recorder: every applied plan event lands in the
                # process journal, so a forensic bundle captured during
                # (or after) the storm shows WHAT chaos did and WHEN —
                # same seed, same chaos.* event sequence
                if event == "kill":
                    victim = await thrasher.kill_one()
                    self.schedule.append((step, "kill", victim))
                    events.emit_proc("chaos.kill", step=step,
                                     victim=-1 if victim is None
                                     else victim)
                elif event == "revive":
                    osd = await thrasher.revive_oldest()
                    self.schedule.append((step, "revive", osd))
                    events.emit_proc("chaos.revive", step=step,
                                     osd=-1 if osd is None else osd)
                elif event == "fp_set":
                    name, mode, kw = FAILPOINT_MENU[arg]
                    fp.fp_set(name, mode, **kw)
                    self.schedule.append((step, "fp_set", name))
                    events.emit_proc("chaos.fp_set", step=step,
                                     name=name, mode=mode)
                elif event == "fp_clear":
                    fp.fp_clear()
                    fp.set_seed(self.seed)
                    self.schedule.append((step, "fp_clear", None))
                    events.emit_proc("chaos.fp_clear", step=step)
                elif event == "add_host":
                    host = f"chaos-host{len(added_hosts)}"
                    osd_id = await cluster.add_osd(host=host)
                    added_hosts.append(host)
                    # growth must not widen the kill budget: the model
                    # stream assumes at most ONE osd dead at a time
                    # (k=2 m=1 tolerates a single loss), so min_live
                    # tracks the cluster size
                    thrasher.min_live += 1
                    self.schedule.append((step, "add_host", osd_id))
                    events.emit_proc("chaos.add_host", step=step,
                                     host=host, osd=osd_id)
                elif event == "drain_host":
                    # only added hosts drain: emptying a seed host
                    # under concurrent kills could drop an EC pool
                    # below k live members
                    pool = sorted(set(added_hosts) - drained)
                    host = (elastic_rng.choice(pool) if pool else None)
                    if host is not None:
                        drained.add(host)
                        ids = cluster.osds_on_host(host)
                        r = await rados.mon_command("osd out", ids=ids)
                        if r["rc"] != 0:
                            raise RuntimeError(f"osd out: {r}")
                    self.schedule.append((step, "drain_host", host))
                    events.emit_proc("chaos.drain_host", step=step,
                                     host=host or "")
                else:
                    self.schedule.append((step, "calm", None))
                    events.emit_proc("chaos.calm", step=step)
                await model.run(self.batch)
        finally:
            fp.fp_clear()
            while thrasher.dead:
                if await thrasher.revive_oldest() is None:
                    break
        # elastic runs end with planned motion still draining: give the
        # engine time to finish before the final verify
        await cluster.wait_health_ok(timeout=60 if self.elastic else 30)
        verified = await model.verify_all()
        events.emit_proc("chaos.done", seed=self.seed, verified=verified)
        # attach a forensic bundle to the drill verdict while the
        # cluster is still up — post-mortems read it via
        # `ceph-tpu forensics show <id>` long after stop()
        forensics = None
        mgr = next(iter(cluster.mgrs.values()), None)
        if mgr is not None:
            try:
                entry = await mgr.forensics_capture(
                    "chaos:" + ("ok" if verified else "fail"),
                    detail={"seed": self.seed,
                            "ops_done": model.ops_done})
                forensics = {"id": entry["id"], "bundle": entry["path"],
                             "worst_daemon": entry["worst_daemon"]}
            except (ConnectionError, TimeoutError):
                pass
        await rados.shutdown()
        await cluster.stop()
        return {
            "seed": self.seed,
            "schedule": list(self.schedule),
            "verified": verified,
            "checks": model.checks,
            "ops_done": model.ops_done,
            "kills": thrasher.kills,
            "revives": thrasher.revives,
            "forensics": forensics,
        }


async def run_chaos(seed: int = 0, **kw) -> dict:
    """One deterministic chaos run; see ChaosHarness."""
    return await ChaosHarness(seed=seed, **kw).run()


async def run_host_failure_drill(seed: int = 0, hosts: int = 4,
                                 osds_per_host: int = 2,
                                 n_objects: int = 48,
                                 victim: str = "host1",
                                 device=None) -> dict:
    """Full-host-failure drill: every OSD on one CRUSH host dies at
    once, seeded client load keeps writing through the degraded
    window, and the revived host's shards converge through the batched
    repair engine — the rack-power-pull scenario the per-object
    recovery loop handles one solo launch at a time.

    The EC pool is jax_rs k=2 m=1 over ``crush-failure-domain host``,
    so losing one host costs each PG at most one shard: client writes
    continue degraded, and every object written through the window
    shares the SAME lost-shard pattern per PG — exactly the grouping
    the engine batches.  Asserts:

    - client ops complete during the degraded window AND during the
      rebuild (mClock recovery pacing: no starvation);
    - the repair engine actually drained batches (summed
      ``ec_repair_batches``/``ec_repair_objects`` deltas > 0);
    - every object reads back bit-identical after HEALTH_OK.
    """
    import asyncio

    import numpy as np

    from ceph_tpu_torch.vstart import DevCluster

    fp.fp_clear()
    rng = np.random.default_rng(seed)
    cluster = DevCluster(
        n_mons=1, n_osds=hosts * osds_per_host,
        osds_per_host=osds_per_host,
        overrides={
            "mon_osd_down_out_interval": 300.0,   # revive, don't remap
        },
        device=device,
    )
    await cluster.start()
    mgr = await cluster.start_mgr(report_interval=0.5)
    mgr.modules["balancer"].active = False   # no upmap churn mid-drill
    rados = await cluster.client()
    out: dict = {"seed": seed, "victim": victim,
                 "osds": hosts * osds_per_host}
    try:
        r = await rados.mon_command(
            "osd erasure-code-profile set", name="hostdrill",
            profile={"plugin": "jax_rs", "k": "2", "m": "1",
                     "crush-failure-domain": "host"})
        assert r["rc"] in (0, -17), r
        await rados.pool_create("hostdrill", pg_num=8,
                                pool_type="erasure",
                                erasure_code_profile="hostdrill")
        await rados.mon_command("osd pool set", pool="hostdrill",
                                var="pg_autoscale_mode", val="off")
        io = await rados.open_ioctx("hostdrill")

        def payload() -> bytes:
            return rng.integers(0, 256, 4096, np.uint8).tobytes()

        # steady-state objects, written healthy
        datas = {f"pre-{i}": payload() for i in range(n_objects // 2)}
        await asyncio.gather(*(
            io.write_full(o, d) for o, d in datas.items()))

        killed = await cluster.kill_host(victim)
        assert killed, f"no OSDs on {victim}"
        out["killed_osds"] = killed
        events.emit_proc("chaos.host_kill", host=victim,
                         osds=list(killed))

        # the degraded window: seeded load MUST keep completing while
        # a whole host is dark (k survivors per stripe exist)
        degraded = {f"deg-{i}": payload()
                    for i in range(n_objects // 2)}
        await asyncio.wait_for(asyncio.gather(*(
            io.write_full(o, d) for o, d in degraded.items())),
            timeout=60)
        datas.update(degraded)
        out["degraded_writes"] = len(degraded)

        def summed(key: str) -> float:
            return float(sum(osd.perf.dump().get(key, 0)
                             for osd in cluster.osds.values()))

        batches0 = summed("ec_repair_batches")
        objects0 = summed("ec_repair_objects")

        # lights back on: the revived OSDs peer with stale logs and
        # the primaries drain their missing sets through the engine
        for osd_id in killed:
            await cluster.revive_osd(osd_id)
        events.emit_proc("chaos.host_revive", host=victim,
                         osds=list(killed))

        # client reads DURING the rebuild: mClock's recovery class may
        # not starve them (a stuck gather here is the starvation bug)
        probe = list(datas)[: 8]
        got = await asyncio.wait_for(asyncio.gather(*(
            io.read(o) for o in probe)), timeout=60)
        for o, g in zip(probe, got):
            assert g == datas[o], f"mid-rebuild read mismatch on {o}"
        out["mid_rebuild_reads"] = len(probe)

        await cluster.wait_health_ok(timeout=60)

        out["repair_batches"] = summed("ec_repair_batches") - batches0
        out["repair_objects"] = summed("ec_repair_objects") - objects0
        assert out["repair_batches"] > 0, (
            "rebuild never used the batched repair engine")
        assert out["repair_objects"] > 0, out

        for o, d in datas.items():
            got = await io.read(o)
            assert got == d, f"post-rebuild read mismatch on {o}"
        out["verified"] = len(datas)
        mgr = next(iter(cluster.mgrs.values()), None)
        if mgr is not None:
            try:
                entry = await mgr.forensics_capture(
                    "drill:host_failure",
                    detail={"victim": victim, "killed": list(killed)})
                out["forensics"] = {"id": entry["id"],
                                    "bundle": entry["path"],
                                    "worst_daemon":
                                        entry["worst_daemon"]}
            except (ConnectionError, TimeoutError):
                pass
        return out
    finally:
        await rados.shutdown()
        await cluster.stop()


# -- elasticity drills ------------------------------------------------------
# Seeded storms that grade the backfill engine: expansion, drain-then-
# remove, and rolling restart.  Each returns an SLO verdict plus a
# forensics bundle captured while the cluster is still up.

def _summed(cluster, key: str) -> float:
    return float(sum(osd.perf.dump().get(key, 0)
                     for osd in cluster.osds.values()))


async def _forensic_bundle(cluster, label: str, detail: dict):
    mgr = next(iter(cluster.mgrs.values()), None)
    if mgr is None:
        return None
    try:
        entry = await mgr.forensics_capture(label, detail=detail)
        return {"id": entry["id"], "bundle": entry["path"],
                "worst_daemon": entry["worst_daemon"]}
    except (ConnectionError, TimeoutError):
        return None


async def _wait_motion_complete(cluster, timeout: float = 90.0,
                                on_poll=None) -> None:
    """Planned motion is DONE when (1) every OSD caught up to the
    mon's current map (waiting on health alone races: right after a
    topology change the digest still reflects the PRE-storm interval,
    so health reads OK before any PG even re-peered), (2) every
    primary PG is active with nothing missing and no backfill
    reservation held — debounced, a map can land between polls — and
    (3) health clears (degraded AND misplaced both zero; the
    OBJECT_MISPLACED check holds WARN while the engine drains)."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    mon = next(iter(cluster.mons.values()))
    settled_polls = 0
    while settled_polls < 3:
        if on_poll is not None:
            on_poll()
        target = mon.osd_monitor.osdmap.epoch
        settled = all(
            o.osdmap is not None and o.osdmap.epoch >= target
            for o in cluster.osds.values())
        if settled:
            for o in cluster.osds.values():
                if o.backfill_local.stats()["active"] \
                        or o.backfill_remote.stats()["active"]:
                    settled = False
                    break
                for pg in o.pgs.values():
                    if pg.is_primary and (
                            pg.state != "active"
                            or pg.missing.total()
                            or pg.missing.backfill):
                        settled = False
                        break
                if not settled:
                    break
        settled_polls = settled_polls + 1 if settled else 0
        if loop.time() > deadline:
            raise TimeoutError("planned motion never completed")
        await asyncio.sleep(0.25)
    await cluster.wait_health_ok(timeout=max(
        5.0, deadline - loop.time()))


async def _wait_recovered(rados, timeout: float = 60.0,
                          ignore: tuple = (
                              "OSDMAP_FLAGS",
                              "DEVICE_HEALTH_FLAPPING")) -> None:
    """Wait until every health check OUTSIDE the expected set clears.
    A rolling-upgrade window holds noout/norebalance (OSDMAP_FLAGS
    warns by design) and repeated kill/revive trips the flapping
    detector — plain HEALTH_OK is unreachable until the drill ends,
    but PG availability/degradation must still fully settle."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    last = None
    while True:
        health = await rados.mon_command("health")
        if health["rc"] == 0:
            last = health["data"]
            checks = dict(last.get("checks", {}))
            for k in ignore:
                checks.pop(k, None)
            if not checks:
                return
        assert loop.time() < deadline, \
            f"recovery never settled: {last}"
        await asyncio.sleep(0.2)


async def _make_ec_cluster(n_osds: int, pool: str, *,
                           osds_per_host: int = 1,
                           failure_domain: str = "osd",
                           pg_num: int = 16,
                           overrides: dict | None = None,
                           device=None):
    from ceph_tpu_torch.vstart import DevCluster

    fp.fp_clear()
    cluster = DevCluster(
        n_mons=1, n_osds=n_osds, osds_per_host=osds_per_host,
        overrides={"mon_osd_down_out_interval": 300.0,
                   **(overrides or {})},
        device=device)
    await cluster.start()
    mgr = await cluster.start_mgr(report_interval=0.25)
    mgr.modules["balancer"].active = False   # no upmap churn mid-drill
    rados = await cluster.client()
    r = await rados.mon_command(
        "osd erasure-code-profile set", name=f"{pool}_ec",
        profile={"plugin": "jax_rs", "k": "2", "m": "1",
                 "crush-failure-domain": failure_domain})
    assert r["rc"] in (0, -17), r
    await rados.pool_create(pool, pg_num=pg_num, pool_type="erasure",
                            erasure_code_profile=f"{pool}_ec")
    await rados.mon_command("osd pool set", pool=pool,
                            var="pg_autoscale_mode", val="off")
    io = await rados.open_ioctx(pool)
    return cluster, rados, io


async def run_expansion_drill(seed: int = 0, n_osds: int = 4,
                              add: int = 1, n_objects: int = 64,
                              obj_size: int = 4096,
                              p99_slo_ms: float = 2000.0,
                              balance_slo_s: float = 90.0,
                              overrides: dict | None = None,
                              device=None) -> dict:
    """Live expansion: +25% OSDs under serving load.

    Grades the backfill engine on the three expansion SLOs:

    - **time-to-balanced** — seconds from the add to motion-complete
      (health clear + every reservation slot released), bounded by
      ``balance_slo_s``;
    - **moved == predicted** — objects and bytes actually drained
      (``backfill_objects``/``backfill_bytes`` counter deltas) must
      EQUAL the client-side prediction computed from
      ``PoolTables.diff`` between the pre- and post-expansion maps
      (the diff names the moved PGs; changed up-row positions name
      the moved shards);
    - **client p99 bounded** — a read loop serves throughout the storm
      and its p99 must stay under ``p99_slo_ms`` (the backfill mClock
      class may not starve clients);

    plus the batching guarantee: motion drains through coalesced
    launches, so ``backfill_batches`` ≪ ``backfill_objects``.
    """
    import numpy as np

    from ceph_tpu_torch.osd.backfill import plan_motion
    from ceph_tpu_torch.osd.osd_map import NO_OSD
    from ceph_tpu_torch.osd.pg import object_to_ps

    rng = np.random.default_rng(seed)
    cluster, rados, io = await _make_ec_cluster(n_osds, "expand",
                                                overrides=overrides,
                                                device=device)
    out: dict = {"seed": seed, "osds": n_osds, "added": add}
    loop = asyncio.get_running_loop()
    try:
        datas = {f"obj-{i}": rng.integers(0, 256, obj_size,
                                          np.uint8).tobytes()
                 for i in range(n_objects)}
        await asyncio.gather(*(
            io.write_full(o, d) for o, d in datas.items()))
        await cluster.wait_health_ok(timeout=30)

        m = rados.monc.osdmap
        pid = next(p.pool_id for p in m.pools.values()
                   if p.name == "expand")
        pg_num = m.pools[pid].pg_num
        tables_before = m.mapping().up_acting_tables(pid)
        objects0 = _summed(cluster, "backfill_objects")
        batches0 = _summed(cluster, "backfill_batches")
        bytes0 = _summed(cluster, "backfill_bytes")
        preempts0 = _summed(cluster, "backfill_preempts")

        # serving load: reads stream through the whole storm and every
        # latency sample lands in the p99 verdict
        lat: list[float] = []
        stop = asyncio.Event()
        names = list(datas)

        async def serve(worker: int) -> None:
            i = worker
            while not stop.is_set():
                o = names[i % len(names)]
                i += 3
                t = loop.time()
                got = await io.read(o)
                lat.append(loop.time() - t)
                assert got == datas[o], f"serving read mismatch on {o}"
                await asyncio.sleep(0.005)

        servers = [loop.create_task(serve(w)) for w in range(2)]
        t0 = loop.time()
        new_ids = []
        for j in range(add):
            new_ids.append(await cluster.add_osd(host=f"exp-host{j}"))
        out["new_osds"] = new_ids
        events.emit_proc("drill.expansion", seed=seed, added=new_ids)

        # prediction: wait for the client map to carry the new OSDs,
        # then diff the placement tables — the moved set, exactly
        deadline = loop.time() + 15
        while not all(i in m.osds and m.osds[i].up for i in new_ids):
            assert loop.time() < deadline, "new OSDs never mapped"
            await asyncio.sleep(0.1)
        tables_after = m.mapping().up_acting_tables(pid)
        width = min(tables_before.up.shape[1],
                    tables_after.up.shape[1])
        changed_pos: dict[int, list[int]] = {}
        moved_map: dict[int, dict] = {pid: {}}
        for ps in (int(x) for x in tables_after.diff(tables_before)):
            pos = [s for s in range(width)
                   if int(tables_after.up[ps, s])
                   != int(tables_before.up[ps, s])
                   and int(tables_after.up[ps, s]) != NO_OSD]
            if pos:
                changed_pos[ps] = pos
                moved_map[pid][ps] = (
                    [int(o) for o in tables_before.up[ps, :width]],
                    [int(o) for o in tables_after.up[ps, :width]])
        plan = plan_motion(moved_map)
        events.emit_proc("backfill.plan", pools=1,
                         moved_pgs=plan["moved_pgs"],
                         groups=len(plan["groups"]))
        shard_len = None
        for osd in cluster.osds.values():
            for pg in osd.pgs.values():
                if pg.pgid.pool == pid and pg.backend is not None:
                    shard_len = (pg.backend.sinfo
                                 .logical_to_next_chunk_offset(obj_size))
                    break
            if shard_len is not None:
                break
        predicted_objects = 0
        predicted_bytes = 0
        for name in datas:
            ps = object_to_ps(name, pg_num)
            if ps in changed_pos:
                predicted_objects += 1
                predicted_bytes += shard_len * len(changed_pos[ps])
        out["predicted"] = {"pgs": len(changed_pos),
                            "objects": predicted_objects,
                            "bytes": predicted_bytes}
        assert predicted_objects > 0, "expansion moved nothing"

        await _wait_motion_complete(cluster, timeout=balance_slo_s)
        time_to_balanced = loop.time() - t0
        stop.set()
        await asyncio.gather(*servers)

        moved_objects = int(_summed(cluster, "backfill_objects")
                            - objects0)
        moved_batches = int(_summed(cluster, "backfill_batches")
                            - batches0)
        moved_bytes = int(_summed(cluster, "backfill_bytes") - bytes0)
        out["moved"] = {"objects": moved_objects,
                        "batches": moved_batches,
                        "bytes": moved_bytes,
                        "preempts": int(
                            _summed(cluster, "backfill_preempts")
                            - preempts0)}
        assert moved_objects == predicted_objects, (
            f"moved {moved_objects} objects, PoolTables.diff "
            f"predicted {predicted_objects}")
        assert moved_bytes == predicted_bytes, (
            f"moved {moved_bytes} bytes, predicted {predicted_bytes}")
        assert 0 < moved_batches < moved_objects, (
            f"{moved_batches} launches for {moved_objects} objects: "
            "motion did not coalesce")

        lat.sort()
        p99_ms = lat[min(len(lat) - 1,
                         int(0.99 * (len(lat) - 1)))] * 1000.0
        out["slo"] = {
            "time_to_balanced_s": round(time_to_balanced, 3),
            "client_reads": len(lat),
            "client_p99_ms": round(p99_ms, 3),
            "pass": bool(time_to_balanced <= balance_slo_s
                         and p99_ms <= p99_slo_ms),
        }
        assert out["slo"]["pass"], out["slo"]

        for o, d in datas.items():
            assert await io.read(o) == d, \
                f"post-expansion read mismatch on {o}"
        out["verified"] = len(datas)
        out["forensics"] = await _forensic_bundle(
            cluster, "drill:expansion",
            detail={"seed": seed, "slo": out["slo"],
                    "moved": out["moved"]})
        return out
    finally:
        await rados.shutdown()
        await cluster.stop()


async def run_drain_drill(seed: int = 0, n_osds: int = 5,
                          n_objects: int = 48,
                          obj_size: int = 4096,
                          victim: int | None = None,
                          device=None) -> dict:
    """Drain-then-remove: ``osd out`` → motion-complete → stop →
    ``osd purge`` — with ZERO degraded objects throughout.

    Planned motion keeps every object fully redundant on its old
    holders (the drained OSD stays up and serving while the engine
    copies its shards out), so the degraded counter must never tick;
    the digest is sampled through the whole drain to prove it.  The
    purge then removes the OSD from the map and its CRUSH item without
    triggering a second storm (an emptied device carries no weight)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cluster, rados, io = await _make_ec_cluster(n_osds, "drain",
                                                device=device)
    if victim is None:
        victim = n_osds - 1
    out: dict = {"seed": seed, "osds": n_osds, "victim": victim}
    loop = asyncio.get_running_loop()
    try:
        datas = {f"obj-{i}": rng.integers(0, 256, obj_size,
                                          np.uint8).tobytes()
                 for i in range(n_objects)}
        await asyncio.gather(*(
            io.write_full(o, d) for o, d in datas.items()))
        await cluster.wait_health_ok(timeout=30)

        mon = next(iter(cluster.mons.values()))
        objects0 = _summed(cluster, "backfill_objects")
        r = await rados.mon_command("osd out", ids=[victim])
        assert r["rc"] == 0, r
        events.emit_proc("drill.drain", seed=seed, victim=victim)

        # motion drains while we sample the digest: misplaced may
        # spike, degraded MUST NOT (the victim still serves)
        peak = {"degraded": 0, "misplaced": 0}

        def sample():
            digest = mon.mgr_stat.digest or {}
            peak["degraded"] = max(
                peak["degraded"],
                int(digest.get("degraded_objects", 0)))
            peak["misplaced"] = max(
                peak["misplaced"],
                int(digest.get("misplaced_objects", 0)))

        await _wait_motion_complete(cluster, timeout=90,
                                    on_poll=sample)
        max_degraded = peak["degraded"]
        max_misplaced = peak["misplaced"]
        out["max_degraded"] = max_degraded
        out["max_misplaced"] = max_misplaced
        assert max_degraded == 0, (
            f"drain degraded {max_degraded} objects — planned motion "
            "must keep full redundancy")
        moved = int(_summed(cluster, "backfill_objects") - objects0)
        out["moved_objects"] = moved
        assert moved > 0, "drain moved nothing"

        # stop the emptied daemon, wait for the mon to see it down,
        # then purge it out of the map and the CRUSH tree
        await cluster.kill_osd(victim)
        m = rados.monc.osdmap
        deadline = loop.time() + 30
        while victim in m.osds and m.osds[victim].up:
            assert loop.time() < deadline, "victim never marked down"
            await asyncio.sleep(0.2)
        r = await rados.mon_command("osd purge", id=victim)
        assert r["rc"] == 0, r
        deadline = loop.time() + 15
        while victim in m.osds:
            assert loop.time() < deadline, "purge never applied"
            await asyncio.sleep(0.1)
        out["purged"] = True
        events.emit_proc("drill.drain.purged", victim=victim)
        # removal of a zero-weight device must not start a second storm
        await cluster.wait_health_ok(timeout=30)

        for o, d in datas.items():
            assert await io.read(o) == d, \
                f"post-drain read mismatch on {o}"
        out["verified"] = len(datas)
        out["forensics"] = await _forensic_bundle(
            cluster, "drill:drain",
            detail={"seed": seed, "victim": victim,
                    "moved_objects": moved,
                    "max_degraded": max_degraded})
        return out
    finally:
        await rados.shutdown()
        await cluster.stop()


async def run_rolling_restart_drill(seed: int = 0, hosts: int = 3,
                                    osds_per_host: int = 2,
                                    n_objects: int = 36,
                                    obj_size: int = 4096,
                                    device=None) -> dict:
    """Rolling restart: wave-by-wave host restarts under ``noout`` +
    ``norebalance`` — reads stay bit-identical mid-wave, and NO
    backfill storm follows any wave (the flags pin placement, the
    revived daemons rejoin log-connected, so the motion engine has
    nothing to move)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cluster, rados, io = await _make_ec_cluster(
        hosts * osds_per_host, "roll", osds_per_host=osds_per_host,
        failure_domain="host", device=device)
    out: dict = {"seed": seed, "hosts": hosts, "waves": []}
    loop = asyncio.get_running_loop()
    try:
        datas = {f"obj-{i}": rng.integers(0, 256, obj_size,
                                          np.uint8).tobytes()
                 for i in range(n_objects)}
        await asyncio.gather(*(
            io.write_full(o, d) for o, d in datas.items()))
        await cluster.wait_health_ok(timeout=30)

        for flag in ("noout", "norebalance"):
            r = await rados.mon_command("osd set", flag=flag)
            assert r["rc"] == 0, r
        m = rados.monc.osdmap
        probe = list(datas)[:8]
        objects0 = _summed(cluster, "backfill_objects")
        for wave in range(hosts):
            host = f"host{wave}"
            killed = await cluster.kill_host(host)
            assert killed, f"no OSDs on {host}"
            events.emit_proc("drill.rolling.wave", wave=wave,
                             host=host, osds=list(killed))
            deadline = loop.time() + 30
            while any(o in m.osds and m.osds[o].up for o in killed):
                assert loop.time() < deadline, \
                    f"wave {wave}: never marked down"
                await asyncio.sleep(0.2)
            # mid-wave reads: k shards survive per stripe, decode
            # must return bit-identical data while the host is dark
            got = await asyncio.wait_for(asyncio.gather(*(
                io.read(o) for o in probe)), timeout=60)
            for o, g in zip(probe, got):
                assert g == datas[o], \
                    f"wave {wave}: mid-wave read mismatch on {o}"
            for osd_id in killed:
                await cluster.revive_osd(osd_id)
            await _wait_recovered(rados, timeout=60)
            moved = int(_summed(cluster, "backfill_objects")
                        - objects0)
            out["waves"].append({"host": host, "killed": killed,
                                 "mid_wave_reads": len(probe),
                                 "backfill_after_wave": moved})
            assert moved == 0, (
                f"wave {wave}: backfill storm moved {moved} objects "
                "despite noout")
        for flag in ("noout", "norebalance"):
            r = await rados.mon_command("osd unset", flag=flag)
            assert r["rc"] == 0, r
        await _wait_recovered(rados, timeout=30)

        for o, d in datas.items():
            assert await io.read(o) == d, \
                f"post-restart read mismatch on {o}"
        out["verified"] = len(datas)
        out["forensics"] = await _forensic_bundle(
            cluster, "drill:rolling_restart",
            detail={"seed": seed, "waves": out["waves"]})
        return out
    finally:
        await rados.shutdown()
        await cluster.stop()


async def run_silent_corruption_drill(seed: int = 0, n_osds: int = 4,
                                      n_objects: int = 48,
                                      obj_size: int = 4096,
                                      n_victims: int = 6,
                                      p99_slo_ms: float = 2000.0,
                                      overrides: dict | None = None,
                                      device=None) -> dict:
    """Seeded silent-corruption storm graded by the integrity plane.

    Rots ``n_victims`` shard copies AT REST — one bit each, below
    every version check and replica digest, via the
    ``store.corrupt_shard`` failpoint (offsets/masks from the seeded
    failpoint rng, so the same seed rots the same bits) — then runs
    ONE batched deep-scrub sweep over every primary EC PG and asserts
    the plane's whole contract at once:

    - **every rot caught in one sweep** — each injected (object,
      shard) appears convicted in the sweep reports, attributed by
      the fused CRC epilogue / device parity compare;
    - **zero false positives** — no clean object is flagged;
    - **bit-identical repair** — convictions drain through the scrub
      repair path, every victim reads back byte-identical, and a
      SECOND sweep reports zero errors;
    - **client p99 bounded** — a read loop serves through injection,
      sweep, and repair, and its p99 stays under ``p99_slo_ms``;

    plus determinism: the returned injection ledger and caught set are
    pure functions of the seed (tests run the drill twice and diff).

    The resident device cache of each victim object is dropped after
    injection: a warm cache legitimately serves version-matched clean
    entries to deep scrub (that is the resident scrub's guarantee — the
    device copy IS verified, h2d-free), so at-rest rot only becomes
    visible to a sweep after eviction/restart.  The drop models that
    aging without waiting for it.
    """
    import numpy as np

    from ceph_tpu_torch.osd.pg import object_to_ps
    from ceph_tpu_torch.store.types import CollectionId, GHObject

    rng = np.random.default_rng(seed)
    cluster, rados, io = await _make_ec_cluster(n_osds, "rot",
                                                overrides=overrides,
                                                device=device)
    out: dict = {"seed": seed, "osds": n_osds, "objects": n_objects}
    loop = asyncio.get_running_loop()
    try:
        datas = {f"obj-{i}": rng.integers(0, 256, obj_size,
                                          np.uint8).tobytes()
                 for i in range(n_objects)}
        await asyncio.gather(*(
            io.write_full(o, d) for o, d in datas.items()))
        await cluster.wait_health_ok(timeout=30)

        m = rados.monc.osdmap
        pid = next(p.pool_id for p in m.pools.values()
                   if p.name == "rot")
        pg_num = m.pools[pid].pg_num

        def primary_pg(ps: int):
            for osd in cluster.osds.values():
                for pg in osd.pgs.values():
                    if pg.pgid.pool == pid and pg.pgid.ps == ps \
                            and pg.is_primary:
                        return osd, pg
            raise KeyError(f"no primary for pg {pid}.{ps}")

        # seeded injection: distinct victim objects, one shard each,
        # bit offset/mask drawn from the failpoint's own seeded rng
        fp.set_seed(seed)
        victims = sorted(str(v) for v in rng.choice(
            sorted(datas), size=n_victims, replace=False))
        fp.fp_set("store.corrupt_shard", "error", count=n_victims)
        ledger: list[dict] = []
        for name in victims:
            ps = object_to_ps(name, pg_num)
            osd, pg = primary_pg(ps)
            shard = int(rng.integers(0, len(pg.acting)))
            holder = cluster.osds[pg.acting[shard]]
            flip = holder.store.corrupt_shard(
                CollectionId(pid, ps, shard),
                GHObject(pid, name, shard=shard))
            assert flip is not None, \
                f"injection refused on {name} shard {shard}"
            ledger.append({"object": name, "ps": ps, "shard": shard,
                           "osd": int(pg.acting[shard]), **flip})
            # model cache aging: a warm resident entry would (by
            # design) satisfy deep scrub from the verified device
            # copy — evict so the sweep reads the rotted bytes
            be = pg.backend
            if be is not None and be.resident is not None:
                be.resident.drop_object(be.resident_ns, name)
        out["injections"] = ledger
        events.emit_proc("drill.silent_corruption", seed=seed,
                         victims=victims)

        # serving load: reads stream through the sweep and the repair
        lat: list[float] = []
        stop = asyncio.Event()
        names = sorted(datas)

        async def serve(worker: int) -> None:
            i = worker
            while not stop.is_set():
                o = names[i % len(names)]
                i += 3
                t = loop.time()
                await io.read(o)
                lat.append(loop.time() - t)
                await asyncio.sleep(0.005)

        servers = [loop.create_task(serve(w)) for w in range(2)]

        launches0 = _summed(cluster, "ec_scrub_launches")
        objects0 = _summed(cluster, "ec_scrub_objects")

        async def sweep() -> list[dict]:
            """One full pass: every primary EC PG of the pool,
            batched."""
            details: list[dict] = []
            for osd in cluster.osds.values():
                for pg in list(osd.pgs.values()):
                    if pg.pgid.pool != pid or not pg.is_primary \
                            or not pg.is_ec:
                        continue
                    rep = await osd._scrub_pg_batched(pg)
                    details.extend(rep.get("inconsistent", ()))
            return details

        t0 = loop.time()
        details = await sweep()
        sweep_s = loop.time() - t0
        stop.set()
        await asyncio.gather(*servers)

        flagged = {d["object"] for d in details}
        false_pos = sorted(flagged - set(victims))
        missed = sorted(set(victims) - flagged)
        assert not missed, f"sweep missed injected rot: {missed}"
        assert not false_pos, f"false positives: {false_pos}"
        by_obj = {d["object"]: d for d in details}
        for inj in ledger:
            d = by_obj[inj["object"]]
            convicted = (set(d.get("crc_mismatch", ()))
                         | set(d.get("parity_inconsistent", ()))
                         | set(d.get("stale_version", ()))
                         | set(d.get("missing_shards", ())))
            assert inj["shard"] in convicted, (
                f"{inj['object']}: rotted shard {inj['shard']} not "
                f"in convicted set {sorted(convicted)}")
            assert d.get("repaired"), \
                f"{inj['object']}: conviction not repaired in-sweep"

        # bit-identical repair: client reads match the originals AND
        # a second sweep over the same PGs comes back spotless
        for o, dta in datas.items():
            assert await io.read(o) == dta, \
                f"post-repair read mismatch on {o}"
        recheck = await sweep()
        assert not recheck, \
            f"second sweep still inconsistent: {recheck}"

        out["scrub"] = {
            "caught": len(flagged),
            "launches": int(_summed(cluster, "ec_scrub_launches")
                            - launches0),
            "objects_verified": int(
                _summed(cluster, "ec_scrub_objects") - objects0),
            "sweep_s": round(sweep_s, 3),
        }
        out["engine"] = {
            f"osd.{i}": o.scrub_engine.stats()
            for i, o in sorted(cluster.osds.items())}

        lat.sort()
        p99_ms = (lat[min(len(lat) - 1, int(0.99 * (len(lat) - 1)))]
                  * 1000.0) if lat else 0.0
        out["slo"] = {
            "injected": n_victims,
            "caught": len(flagged),
            "false_positives": len(false_pos),
            "repaired": len(flagged),
            "client_reads": len(lat),
            "client_p99_ms": round(p99_ms, 3),
            "pass": bool(not missed and not false_pos
                         and p99_ms <= p99_slo_ms),
        }
        assert out["slo"]["pass"], out["slo"]
        out["forensics"] = await _forensic_bundle(
            cluster, "drill:silent_corruption",
            detail={"seed": seed, "slo": out["slo"],
                    "injections": ledger})
        return out
    finally:
        fp.fp_clear()
        await rados.shutdown()
        await cluster.stop()


# -- geo-replication drills --------------------------------------------------
# Seeded two-zone storms that grade the multisite plane: measured RPO
# against the cursor ledger, measured RTO through a period-commit
# failover, and bit-identical convergence after the lost zone revives.

async def _wait_zone_lag_zero(realm, zone: str,
                              timeout: float = 60.0) -> None:
    """Wait until ``zone`` runs at least one pull agent and its
    replication backlog (entries AND bytes) has drained to zero."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        orch = realm.zones[zone]["orch"]
        if orch is not None and orch.agents:
            led = await realm.lag()
            if led[zone]["entries"] == 0 and led[zone]["bytes"] == 0:
                return
        if loop.time() > deadline:
            raise TimeoutError(f"zone {zone} never drained its lag")
        await asyncio.sleep(0.05)


async def run_zone_loss_drill(seed: int = 0, n_objects: int = 12,
                              n_unreplicated: int = 5,
                              obj_size: int = 4096,
                              rto_slo_s: float = 30.0,
                              datalog_shards: int = 4,
                              dr_rebuild: bool = False,
                              device=None) -> dict:
    """Whole-zone loss, graded end to end (the geo-replication SLO).

    Boots a two-zone realm — zone ``a`` master over durable stores,
    zone ``b`` secondary — replicates a seeded write set, then:

    1. **partition** — zone b's pull agents stop (the replication link
       goes dark) while a keeps acking client writes: fresh keys, an
       overwrite, a delete, and a conflict key.  The cursor ledger
       (:meth:`RGWSyncAgent.lag`) prices the unreplicated backlog in
       entries and bytes — the PREDICTED RPO;
    2. **zone loss** — zone a dies whole (mons, OSDs, gateway);
    3. **failover** — a period commit on b's OWN realm store promotes
       it to master; RTO = seconds from the kill until b acks a write
       after the commit, bounded by ``rto_slo_s``;
    4. **measured RPO** — every write a acked that b cannot serve,
       priced in entries and bytes by inspecting b, asserted EXACTLY
       EQUAL to the ledger (the ledger is trustworthy: what it says
       survives is servable, what it says is lost is lost);
    5. **conflict** — b, now master, writes the conflict key again:
       both zones wrote the same key across the partition;
    6. **revive + resync** — a reboots over its surviving stores
       (``dr_rebuild=True`` first WIPES a's mon store and rebuilds it
       offline from the OSD stores with monstore_tool + monmaptool —
       the offline recovery recipe — and restarts against the authored
       monmap),
       re-learns the committed topology, full-syncs from b (purging
       its orphaned unreplicated writes), drains lag to zero, and the
       drill asserts bit-identical convergence with the conflict key
       resolved to b's later write on BOTH zones.
    """
    import json
    import shutil
    import tempfile

    from ceph_tpu_torch.services.rgw import RGWError
    from ceph_tpu_torch.vstart import MultisiteRealm

    rng = random.Random(f"zone-loss:{seed}")
    adir = tempfile.mkdtemp(prefix="drill-zone-a-")
    realm = MultisiteRealm(
        ("a", "b"), n_osds=3,
        overrides={"rgw_datalog_shards": datalog_shards},
        store_dirs={"a": adir}, with_mgr=True,
        agent_kwargs={"poll_interval": 0.05, "seed": seed},
        device=device)
    out: dict = {"seed": seed, "dr_rebuild": dr_rebuild,
                 "shards": datalog_shards}
    loop = asyncio.get_running_loop()
    bucket = "geo"
    try:
        await realm.start()
        a_gw = realm.zones["a"]["gw"]
        b_gw = realm.zones["b"]["gw"]

        # 1a. seeded steady state, fully replicated before the storm
        datas = {f"obj-{i}": rng.randbytes(obj_size)
                 for i in range(n_objects)}
        await a_gw.create_bucket(bucket)
        for k, d in datas.items():
            await a_gw.put_object(bucket, k, d)
        await _wait_zone_lag_zero(realm, "b")
        assert (await b_gw.get_object(bucket, "obj-0"))["data"] \
            == datas["obj-0"]

        # 1b. the replication link goes dark: b's agents stop, the
        # orchestrator holds (the period didn't change), and a keeps
        # acking writes it can no longer replicate out
        orch_b = realm.zones["b"]["orch"]
        parted = dict(orch_b.agents)
        orch_b.agents.clear()
        for agent in parted.values():
            await agent.stop()
        ledger_agent = parted[("a", "b")]

        # (key, content b must serve for the write NOT to be lost):
        # None = the write was a delete
        post_partition: list[tuple[str, bytes | None]] = []
        predicted_entries = 0
        predicted_bytes = 0
        for i in range(n_unreplicated):
            d = rng.randbytes(obj_size)
            await a_gw.put_object(bucket, f"lost-{i}", d)
            post_partition.append((f"lost-{i}", d))
            predicted_entries += 1
            predicted_bytes += len(d)
        over = rng.randbytes(obj_size // 2)
        await a_gw.put_object(bucket, "obj-0", over)
        post_partition.append(("obj-0", over))
        predicted_entries += 1
        predicted_bytes += len(over)
        await a_gw.delete_object(bucket, "obj-1")
        post_partition.append(("obj-1", None))
        predicted_entries += 1
        conflict_v1 = rng.randbytes(obj_size)
        await a_gw.put_object(bucket, "conflict", conflict_v1)
        post_partition.append(("conflict", conflict_v1))
        predicted_entries += 1
        predicted_bytes += len(conflict_v1)

        ledger = await ledger_agent.lag()
        assert ledger["entries"] == predicted_entries, ledger
        assert ledger["bytes"] == predicted_bytes, ledger
        out["ledger"] = {"entries": ledger["entries"],
                         "bytes": ledger["bytes"]}

        # 2. the zone-loss event: a dies whole, mid-backlog
        t_kill = loop.time()
        await realm.stop_zone("a")
        events.emit_proc("drill.zone_loss", seed=seed, zone="a",
                         ledger_entries=ledger["entries"],
                         ledger_bytes=ledger["bytes"])

        # 3. failover: promote b on its own realm copy; RTO is the
        # whole runbook — kill to first acked write post-commit
        await realm.failover("b", survivors=["b"])
        while True:
            try:
                await b_gw.put_object(bucket, "rto-probe", b"serving")
                break
            except (RGWError, ConnectionError, TimeoutError):
                assert loop.time() - t_kill < rto_slo_s, \
                    "zone b never served writes within the RTO SLO"
                await asyncio.sleep(0.05)
        rto_s = loop.time() - t_kill

        # 4. measured RPO: what a acked that b cannot serve — must
        # equal the cursor ledger exactly, entries and bytes
        measured_entries = 0
        measured_bytes = 0
        lost_keys = []
        for k, want in post_partition:
            try:
                served = (await b_gw.get_object(bucket, k))["data"]
            except RGWError:
                served = None
            if served != want:
                measured_entries += 1
                measured_bytes += len(want or b"")
                lost_keys.append(k)
        out["rpo"] = {"entries": measured_entries,
                      "bytes": measured_bytes,
                      "keys": lost_keys}

        # 5. both zones wrote the same key across the partition: the
        # later write (b's, as the surviving master) must win on BOTH
        # sides once a returns
        conflict_v2 = rng.randbytes(obj_size)
        await b_gw.put_object(bucket, "conflict", conflict_v2)

        # 6. revive a over its surviving stores and resync from b
        if dr_rebuild:
            from ceph_tpu_torch.tools import monmaptool, monstore_tool

            shutil.rmtree(f"{adir}/mon.a")
            argv = ["rebuild", "--store-path", f"{adir}/mon.m",
                    "--admin-key", "drill-admin"]
            for i in range(realm.n_osds):
                argv += ["--osd-store", f"{adir}/osd.{i}"]
            assert await monstore_tool._run(
                monstore_tool.build_parser().parse_args(argv)) == 0
            conf = f"{adir}/cluster.json"
            assert await monmaptool._run(
                monmaptool.build_parser().parse_args(
                    [conf, "--create", "--add", "m",
                     "local://a-mon.m"])) == 0
            with open(conf) as f:
                monmap = json.load(f)["monmap"]
            await realm.revive_zone("a", monmap=monmap)
        else:
            await realm.revive_zone("a")
        await _wait_zone_lag_zero(realm, "a", timeout=90.0)

        # bit-identical convergence, the orphans purged
        a_gw = realm.zones["a"]["gw"]
        keys_a = [e["key"] for e in
                  (await a_gw.list_objects(bucket))["contents"]]
        keys_b = [e["key"] for e in
                  (await b_gw.list_objects(bucket))["contents"]]
        assert keys_a == keys_b, (keys_a, keys_b)
        assert not any(k.startswith("lost-") for k in keys_a), keys_a
        mismatched = []
        for k in keys_a:
            da = (await a_gw.get_object(bucket, k))["data"]
            db = (await b_gw.get_object(bucket, k))["data"]
            if da != db:
                mismatched.append(k)
        assert not mismatched, mismatched
        conflict_final = (await a_gw.get_object(
            bucket, "conflict"))["data"]
        purged = int(next(iter(
            realm.zones["a"]["orch"].agents.values()))
            .perf.value("sync_purged"))

        out["slo"] = {
            "rpo_entries_predicted": predicted_entries,
            "rpo_entries": measured_entries,
            "rpo_bytes_predicted": predicted_bytes,
            "rpo_bytes": measured_bytes,
            "rto_s": round(rto_s, 3),
            "rto_slo_s": rto_slo_s,
            "resync_purged": purged,
            "converged": not mismatched and keys_a == keys_b,
            "conflict_winner": "b" if conflict_final == conflict_v2
            else "a",
            "pass": bool(
                measured_entries == predicted_entries
                == ledger["entries"]
                and measured_bytes == predicted_bytes
                == ledger["bytes"]
                and rto_s <= rto_slo_s
                and not mismatched and keys_a == keys_b
                and conflict_final == conflict_v2),
        }
        assert out["slo"]["pass"], out["slo"]
        out["forensics"] = await _forensic_bundle(
            realm.zones["b"]["cluster"], "drill:zone_loss",
            detail={"seed": seed, "slo": out["slo"],
                    "ledger": out["ledger"]})
        return out
    finally:
        await realm.stop()
        shutil.rmtree(adir, ignore_errors=True)


async def run_zone_loss_dr_drill(seed: int = 0, **kw) -> dict:
    """DR composite: the zone-loss drill with the revived zone's mon
    store WIPED and rebuilt offline from its surviving OSD stores
    (monstore_tool + monmaptool) before the restart — chains the offline
    recovery recipe into the geo failover runbook."""
    kw.setdefault("dr_rebuild", True)
    return await run_zone_loss_drill(seed=seed, **kw)
