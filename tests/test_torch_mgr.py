"""The port's manager against the JAX package's, scenario by scenario.

The scenarios of tests/test_mgr_modules.py (the balancer's chained upmap
and its convergence, the autoscaler's warning, crash and config-key, device
health and telemetry), tests/test_mgr_perf.py's OSD perf query and iostat
(RBD support waits for the port's block images, ROADMAP A12.3) and
tests/test_orchestrator.py (scale up and down, a managed removal healed,
drain and a mgr restart, cephx scale-up, validation) run once on a fresh
dev cluster of each package: the JAX package's, then the port's, whose OSD
daemons run on ``device="cpu"``.  Each returns what does not depend on
timing, and the two must be equal: command replies, health-check names and
messages, module outputs, the PG digest's sections, and the Prometheus
scrape's metric names and label sets.  Waits poll with timeouts well above
the reference tests'; no step sleeps a fixed time to let state settle.
Tolerance 0.
"""

import asyncio
import functools
import importlib
import re
from types import SimpleNamespace

import pytest

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    device = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    return SimpleNamespace(
        root=root, fp=mod("common.failpoint"),
        reset_local_namespace=mod("msg").reset_local_namespace,
        DevCluster=functools.partial(mod("vstart").DevCluster, **device),
        mgr_modules=mod("services.mgr_modules"), mgr=mod("services.mgr"),
        dashboard=mod("services.dashboard"),
        osd_map=mod("osd.osd_map"), crush_map=mod("placement.crush_map"),
        rados=mod("client.rados"))


PKGS = {name: _pkg(name) for name in PKG_NAMES}


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS.values():
        p.reset_local_namespace()
        p.fp.fp_clear()
        p.fp.set_seed(0)
    yield
    for p in PKGS.values():
        p.fp.fp_clear()
        p.fp.set_seed(0)
        p.reset_local_namespace()


def on_each_package(scenario, pkgs=PKGS):
    """``scenario(pkg)`` on a fresh cluster of the JAX package, then of the
    port; returns {root: result}."""
    out = {}
    for name, p in pkgs.items():
        p.reset_local_namespace()
        p.fp.fp_clear()
        out[name] = asyncio.run(scenario(p))
        p.fp.fp_clear()
        p.reset_local_namespace()
    return out


def assert_equal_across(out):
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]
    return out["ceph_tpu"]


async def wait_for(pred, timeout=60.0, what="", every=0.1):
    """Poll ``pred`` (sync or async) until truthy; return its value."""
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        r = pred()
        if asyncio.iscoroutine(r):
            r = await r
        if r:
            return r
        assert asyncio.get_running_loop().time() < deadline, \
            f"timed out waiting for {what}"
        await asyncio.sleep(every)


def reply(r):
    """A mon command reply without the client's poll counter."""
    return {k: v for k, v in r.items() if k != "tid"}


_SAMPLE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})? ")


def scrape_series(text):
    """{metric name: sorted label sets} of a Prometheus text scrape (the
    values left out)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        assert m, line
        out.setdefault(m.group(1), set()).add(m.group(2) or "")
    return {k: sorted(v) for k, v in out.items()}


def timing_free_digest(d):
    """The PG digest's sections that a fixed workload on a settled
    cluster makes equal: PG and pool stats, health checks and the module
    outputs, with their clock readings and rates left out."""
    keep = ("pgs_by_state", "num_pgs", "num_objects", "num_bytes",
            "degraded_objects", "misplaced_objects", "pools", "osd_df",
            "health_checks", "pg_autoscale", "orchestrator",
            "osd_perf_query", "qos", "rbd_support", "snap_schedule",
            "progress")
    out = {k: d.get(k) for k in keep}
    out["keys"] = sorted(d)
    out["balancer"] = {k: d["balancer"][k] for k in ("active", "mode")}
    out["device_health"] = {
        o: {k: v for k, v in rec.items() if k != "last_down"}
        for o, rec in d["device_health"].items()}
    out["telemetry"] = {k: v for k, v in d["telemetry"].items()
                        if k != "report_timestamp"}
    ins = d["insights"]
    out["insights"] = ({c: h["severity"]
                        for c, h in ins["health_history"].items()},
                       ins["unarchived_crashes"], ins["crash_count"])
    slo = d["slo"]
    out["slo"] = ([o["objective"] for o in slo["objectives"]],
                  slo["violations"], sorted(slo["classes"]))
    out["utilization"] = sorted(d["utilization"])
    out["iostat"] = sorted(d["iostat"])
    out["tsdb"] = (sorted(d["tsdb"]), sorted(d["tsdb"]["tails"]))
    return out


# -- the manager on a dev cluster --------------------------------------------


async def _digest_and_scrape(p):
    """A settled replicated pool of 12 objects: the mgr's digest and its
    scrape."""
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        mgr = await cluster.start_mgr(report_interval=0.1)
        rados = await cluster.client()
        await rados.pool_create("dg", pg_num=8, size=2)
        io = await rados.open_ioctx("dg")
        for i in range(12):
            await io.write_full(f"o{i}", bytes([i]) * (100 * (i + 1)))

        def settled():
            d = mgr.last_digest or {}
            return d.get("num_objects") == 12 and \
                d.get("pgs_by_state") == {"active+clean": 8} and \
                d["tsdb"]["tails"].get("slo.put_p99_ms.burn") is None
        await wait_for(settled, what="a settled digest")
        digest = await mgr.report()
        text = mgr.prometheus_text(await mgr.collect(),
                                   mgr.prometheus_extra())
        await rados.shutdown()
        return timing_free_digest(digest), scrape_series(text)
    finally:
        await cluster.stop()


def test_digest_sections_and_scrape_names_equal():
    digest, series = assert_equal_across(on_each_package(_digest_and_scrape))
    assert digest["num_objects"] == 12 and digest["num_bytes"] == 7800
    assert "POOL_TOO_FEW_PGS" in digest["health_checks"]
    assert "ceph_osd_op_w_latency_us_bucket" in series
    assert "ceph_util_roofline_pct" in series


async def _boot_report_stop(p):
    """start_mgr(dashboard=True, orchestrate=True) boots, reports and
    stops cleanly."""
    cluster = p.DevCluster(n_mons=1, n_osds=2)
    await cluster.start()
    try:
        mgr = await cluster.start_mgr(dashboard=True, orchestrate=True)
        await wait_for(lambda: (mgr.last_digest or {}).get("orchestrator",
                                                           {}).get(
            "available"), what="the orchestrator backend")
        digest = await mgr.report()
        dash = mgr.dashboard
        running = (dash.port > 0, mgr._report_task.done())
    finally:
        await cluster.stop()
    await wait_for(mgr._report_task.done, timeout=10.0,
                   what="the report task's end")
    return (running, digest["orchestrator"], cluster.mgrs,
            mgr.dashboard, mgr._report_task.cancelled())


def test_start_mgr_with_dashboard_and_orchestrator_boots_reports_stops():
    running, orch, mgrs, dash, done = assert_equal_across(
        on_each_package(_boot_report_stop))
    assert running == (True, False) and orch["available"]
    assert mgrs == {} and dash is None and done


# -- tests/test_mgr_modules.py -------------------------------------------------


def _flat_map(p, n_osds, pool_size=2, pg_num=16):
    om, cm = p.osd_map, p.crush_map
    crush = cm.CrushMap()
    crush.add_bucket("default", "root")
    crush.create_replicated_rule("replicated_rule", failure_domain="osd")
    m = om.OSDMap()
    m.apply_incremental(om.Incremental(1, new_crush=crush.to_dict()))
    inc2 = om.Incremental(2)
    for i in range(n_osds):
        inc2.new_up[i] = f"local://osd.{i}"
        inc2.new_weights[i] = 0x10000
    inc2.new_pools.append(om.PoolInfo(1, "p", "replicated", size=pool_size,
                                      min_size=1, pg_num=pg_num,
                                      crush_rule="replicated_rule"))
    m.apply_incremental(inc2)
    crush2 = cm.CrushMap.from_dict(m.crush.to_dict())
    for i in range(n_osds):
        hb = crush2.add_bucket(f"h{i}", "host")
        crush2.add_item("default", hb)
        crush2.add_item(f"h{i}", i)
    m.apply_incremental(om.Incremental(3, new_crush=crush2.to_dict()))
    return m


async def _balancer_rewrites_chained_upmap(p):
    m = _flat_map(p, 4, pool_size=1, pg_num=1)
    raw_osd = m.pg_to_up_acting(1, 0)[0][0]
    hot = next(o for o in range(4) if o != raw_osd)
    m.apply_incremental(p.osd_map.Incremental(
        m.epoch + 1, new_pg_upmap_items={(1, 0): [(raw_osd, hot)]}))
    assert m.pg_to_up_acting(1, 0)[0] == [hot]
    sent = {}

    class FakeMonc:
        osdmap = m

        async def command(self, prefix, **kw):
            sent.update(kw, prefix=prefix)
            return {"rc": 0}

    class FakeMgr:
        monc = FakeMonc()

    bal = p.mgr_modules.Balancer(FakeMgr())
    counts, _ = bal._pg_distribution()
    bal.max_deviation = 0
    await bal.serve_once()
    pairs = [tuple(x) for x in sent["mappings"]]
    m.apply_incremental(p.osd_map.Incremental(
        m.epoch + 1, new_pg_upmap_items={(1, 0): list(pairs)}))
    return (counts, sent["prefix"], pairs, m.pg_to_up_acting(1, 0)[0],
            bal.digest_contrib())


def test_balancer_rewrites_chained_upmap():
    counts, prefix, pairs, up, _ = assert_equal_across(
        on_each_package(_balancer_rewrites_chained_upmap))
    assert prefix == "osd pg-upmap-items" and len(pairs) == 1
    assert up == [pairs[0][1]]


async def _balancer_converges(p):
    cluster = p.DevCluster(n_mons=1, n_osds=4)
    await cluster.start()
    try:
        rados = await cluster.client()
        r = await rados.mon_command("osd pool create", pool="bal",
                                    pg_num=32, size=2)
        assert r["rc"] == 0, r
        await cluster.wait_health_ok(timeout=60)
        mgr = await cluster.start_mgr()
        bal = mgr.modules["balancer"]

        def converged():
            counts, _ = bal._pg_distribution()
            return counts and max(counts.values()) - min(
                counts.values()) <= bal.max_deviation
        await wait_for(converged, what="balanced PG counts")

        async def reported():
            # the status is the mon's copy of the last digest: wait for
            # one that carries the balancer's section
            r = await rados.mon_command("balancer status")
            return r["data"].get("mode") == "upmap" and r
        status = reply(await wait_for(reported, what="balancer status"))
        await rados.shutdown()
        return (type(bal).__name__, bal.optimizations > 0,
                status["rc"], status["data"]["mode"],
                status["data"]["active"])
    finally:
        await cluster.stop()


def test_balancer_converges_pg_counts():
    name, optimized, rc, mode, active = assert_equal_across(
        on_each_package(_balancer_converges))
    assert (name, optimized, rc, mode) == ("Balancer", True, 0, "upmap")


async def _autoscaler_warns(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        rados = await cluster.client()
        r = await rados.mon_command("osd pool create", pool="tiny",
                                    pg_num=1, size=3)
        assert r["rc"] == 0, r
        await cluster.start_mgr()

        async def warned():
            r = await rados.mon_command("health")
            return r["data"]["checks"].get("POOL_TOO_FEW_PGS")
        check = await wait_for(warned, what="POOL_TOO_FEW_PGS")
        status = reply(await rados.mon_command("osd pool autoscale-status"))
        await rados.shutdown()
        return check, status
    finally:
        await cluster.stop()


def test_autoscaler_warns_on_tiny_pool():
    check, status = assert_equal_across(on_each_package(_autoscaler_warns))
    assert status["data"]["tiny"]["kind"] == "few"
    assert "tiny" in check["message"]


async def _crash_and_config_key(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        rados = await cluster.client()
        report = {"crash_id": "2026-07-30_osd.1_deadbeef",
                  "entity": "osd.1", "timestamp": 1785000000.0,
                  "backtrace": ["frame1", "frame2"]}
        cid = report["crash_id"]
        steps = [
            ("crash post", {"report": report}), ("crash ls", {}),
            ("crash info", {"id": cid}), ("health", {}),
            ("crash archive", {"id": cid}), ("health", {}),
            ("crash rm", {"id": cid}), ("crash ls", {}),
            ("config-key set", {"key": "mgr/test/blob", "value": "v1"}),
            ("config-key get", {"key": "mgr/test/blob"}),
            ("config-key ls", {}),
            ("config-key exists", {"key": "mgr/test/blob"}),
            ("config-key rm", {"key": "mgr/test/blob"}),
            ("config-key get", {"key": "mgr/test/blob"}),
        ]
        out = []
        for cmd, kw in steps:
            out.append((cmd, reply(await rados.mon_command(cmd, **kw))))
        await rados.shutdown()
        return out
    finally:
        await cluster.stop()


def test_crash_lifecycle_and_config_key():
    out = dict(enumerate(assert_equal_across(
        on_each_package(_crash_and_config_key))))
    assert [c["crash_id"] for c in out[1][1]["data"]] == \
        ["2026-07-30_osd.1_deadbeef"]
    assert "RECENT_CRASH" in out[3][1]["data"]["checks"]
    assert "RECENT_CRASH" not in out[5][1]["data"]["checks"]
    assert out[9][1]["data"] == "v1" and out[13][1]["rc"] != 0


async def _devicehealth_and_telemetry(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        rados = await cluster.client()
        r = await rados.mon_command("osd pool create", pool="tm",
                                    pg_num=8, size=3)
        assert r["rc"] == 0, r
        io = await rados.open_ioctx("tm")
        await io.write_full("o", b"x" * 500)
        mgr = await cluster.start_mgr()

        async def telemetry():
            r = await rados.mon_command("telemetry show")
            return r["rc"] == 0 and r["data"].get("num_pgs") == 8 and \
                r["data"]
        t = await wait_for(telemetry, what="telemetry")
        devices = reply(await rados.mon_command("device ls"))
        dh = mgr.modules["devicehealth"]
        dh._was_up[2] = True
        info = mgr.monc.osdmap.osds[2]
        was = info.up
        info.up = False
        await dh.serve_once()
        info.up = was
        flaps = dh._flaps[2]
        dh._flaps[2] = 3
        checks = dh.health_checks()
        await rados.shutdown()
        t = {k: v for k, v in t.items() if k != "report_timestamp"}
        return t, sorted(devices["data"]), flaps, checks
    finally:
        await cluster.stop()


def test_devicehealth_and_telemetry():
    t, devices, flaps, checks = assert_equal_across(
        on_each_package(_devicehealth_and_telemetry))
    assert t["num_osds"] == 3 and t["total_bytes"] >= 500
    assert "replicated" in t["pool_types"]
    assert "local://" not in str(t)
    assert devices == ["0", "1", "2"] and flaps == 1
    assert "DEVICE_HEALTH_FLAPPING" in checks


# -- tests/test_mgr_perf.py ----------------------------------------------------


async def _osd_perf_query_and_iostat(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    rados = await cluster.client()
    await cluster.start_mgr()
    try:
        r = await rados.mon_command("osd pool create", pool="p1",
                                    pg_num=8, size=2)
        assert r["rc"] == 0, r
        added = reply(await rados.mon_command("osd perf query add",
                                              type="by_pool"))
        qid = added["data"]["qid"]
        listed = reply(await rados.mon_command("osd perf query ls"))
        io = await rados.open_ioctx("p1")

        async def counters_show():
            for i in range(5):
                await io.write_full(f"o{i}", b"d" * 1024)
            r = await rados.mon_command("osd perf counters get", qid=qid)
            if r["rc"] != 0:
                return False
            c = r["data"]["counters"].get("p1")
            return bool(c) and c["write_ops"] >= 5 and \
                c["bytes_in"] >= 5 * 1024 and sorted(c)
        counter_keys = await wait_for(counters_show, what="perf counters")

        async def iostat():
            r = await rados.mon_command("iostat")
            return r["rc"] == 0 and "ops_per_sec" in r["data"] and \
                sorted(r["data"])
        iostat_keys = await wait_for(iostat, what="iostat")
        removed = reply(await rados.mon_command("osd perf query rm",
                                                qid=qid))
        after = reply(await rados.mon_command("osd perf query ls"))
        bad = await rados.mon_command("osd perf query add",
                                      type="by_moon_phase")
        await rados.shutdown()
        return (added, listed, counter_keys, iostat_keys, removed, after,
                bad["rc"])
    finally:
        await cluster.stop()


def test_osd_perf_query_and_iostat():
    added, listed, keys, iostat, removed, after, bad = assert_equal_across(
        on_each_package(_osd_perf_query_and_iostat))
    qid = added["data"]["qid"]
    assert any(q["qid"] == qid and q["type"] == "by_pool"
               for q in listed["data"])
    assert "write_ops" in keys and "ops_per_sec" in iostat
    assert removed["rc"] == 0 and not any(q["qid"] == qid
                                          for q in after["data"])
    assert bad != 0


# -- tests/test_orchestrator.py ------------------------------------------------


async def _osds_up(rados, n):
    r = await rados.mon_command("status")
    return r["rc"] == 0 and r["data"]["osdmap"]["num_up_osds"] == n


async def _orch_available(rados):
    r = await rados.mon_command("orch status")
    return r["rc"] == 0 and r["data"]["available"]


async def _orch_scales(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        rados = await cluster.client()
        await cluster.start_mgr(orchestrate=True)
        first = reply(await rados.mon_command("orch status"))["rc"]
        await wait_for(lambda: _orch_available(rados), what="backend")
        up = reply(await rados.mon_command("orch apply",
                                           service_type="osd", count=5))
        await wait_for(lambda: _osds_up(rados, 5), what="5 osds up")
        # a daemon is marked up inside its start(), before the cluster
        # lists it
        await wait_for(lambda: len(cluster.osds) == 5, what="5 osds")
        osds_up = sorted(cluster.osds)

        async def ls_running():
            r = await rados.mon_command("orch ls")
            row = (r["data"] or {}).get("osd")
            return row and row["running"] == 5 and row["target"] == 5 \
                and row
        row = await wait_for(ls_running, what="orch ls")
        down = reply(await rados.mon_command("orch apply",
                                             service_type="osd", count=4))
        await wait_for(lambda: len(cluster.osds) == 4, what="4 osds")
        ps = reply(await rados.mon_command("orch ps"))
        hosts = reply(await rados.mon_command("orch host ls"))
        await rados.shutdown()
        return (first, up, osds_up, row, down, sorted(cluster.osds),
                sorted(d["name"] for d in ps["data"]), hosts)
    finally:
        await cluster.stop()


def test_orch_apply_scales_osds_up_and_down():
    first, up, osds_up, row, down, osds, names, hosts = \
        assert_equal_across(on_each_package(_orch_scales))
    assert (first, up["rc"], down["rc"]) == (0, 0, 0)
    assert osds_up == [0, 1, 2, 3, 4] and osds == [0, 1, 2, 3]
    assert "osd.0" in names and "mgr.x" in names
    assert "host0" in hosts["data"]


async def _orch_daemon_rm(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        rados = await cluster.client()
        await cluster.start_mgr(orchestrate=True)
        out = [reply(await rados.mon_command("orch apply",
                                             service_type="osd", count=3))]
        await wait_for(lambda: _orch_available(rados), what="backend")
        out.append(reply(await rados.mon_command("orch daemon rm",
                                                 name="osd.1")))
        await wait_for(lambda: 1 not in cluster.osds and
                       len(cluster.osds) == 3, what="osd.1 healed back")
        out.append(sorted(cluster.osds))
        out.append(reply(await rados.mon_command(
            "orch apply", service_type="osd", count=3, unmanaged=True)))

        async def unmanaged():
            r = await rados.mon_command("config-key get",
                                        key="orch/spec/osd")
            return r["rc"] == 0 and '"unmanaged": true' in r["data"]
        await wait_for(unmanaged, what="the unmanaged spec")
        victim = max(cluster.osds)
        out.append(reply(await rados.mon_command("orch daemon rm",
                                                 name=f"osd.{victim}")))
        await wait_for(lambda: len(cluster.osds) == 2,
                       what="unmanaged removal")
        # the removal sticks through several reconcile cycles
        mgr = next(iter(cluster.mgrs.values()))
        cycles = mgr.collect_stats["cycles"]
        await wait_for(lambda: mgr.collect_stats["cycles"] >= cycles + 5,
                       what="five more mgr cycles")
        out.append(sorted(cluster.osds))
        await rados.shutdown()
        return out
    finally:
        await cluster.stop()


def test_orch_managed_daemon_rm_is_healed_unmanaged_is_not():
    out = assert_equal_across(on_each_package(_orch_daemon_rm))
    assert all(r["rc"] == 0 for r in (out[0], out[1], out[3], out[4]))
    assert len(out[2]) == 3 and 1 not in out[2] and len(out[5]) == 2


async def _orch_rm_and_mgr_restart(p):
    cluster = p.DevCluster(n_mons=1, n_osds=2)
    await cluster.start()
    try:
        rados = await cluster.client()
        mgr = await cluster.start_mgr(orchestrate=True)
        out = [reply(await rados.mon_command("orch apply",
                                             service_type="osd", count=4))]
        await wait_for(lambda: len(cluster.osds) == 4, what="4 osds")
        mgr._report_task.cancel()
        await mgr.shutdown()
        cluster.mgrs.clear()
        await cluster.kill_osd(max(cluster.osds))
        out.append(len(cluster.osds))
        await cluster.start_mgr(orchestrate=True)
        await wait_for(lambda: len(cluster.osds) == 4,
                       what="re-converged after mgr restart")
        out.append(reply(await rados.mon_command("orch rm",
                                                 service_type="osd")))
        await wait_for(lambda: not cluster.osds, what="drain to zero")

        async def spec_gone():
            g = await rados.mon_command("config-key ls")
            return not any(k.startswith("orch/spec/") for k in g["data"])
        await wait_for(spec_gone, what="spec retirement")
        out.append(reply(await rados.mon_command("orch rm",
                                                 service_type="osd")))
        await rados.shutdown()
        return out
    finally:
        await cluster.stop()


def test_orch_rm_drains_service_and_spec_survives_mgr_restart():
    applied, left, rm, again = assert_equal_across(
        on_each_package(_orch_rm_and_mgr_restart))
    assert applied["rc"] == 0 and left == 3 and rm["rc"] == 0
    assert again["rc"] != 0


async def _orch_scale_up_cephx(p):
    cluster = p.DevCluster(n_mons=1, n_osds=2, cephx=True)
    await cluster.start()
    try:
        rados = await cluster.client()
        await cluster.start_mgr(orchestrate=True)
        r = reply(await rados.mon_command("orch apply", service_type="osd",
                                          count=3))
        await wait_for(lambda: len(cluster.osds) == 3, timeout=90,
                       what="cephx scale-up to 3")
        await wait_for(lambda: _osds_up(rados, 3), timeout=90,
                       what="osd.2 authenticated and up")
        await rados.shutdown()
        return r, sorted(cluster.osds)
    finally:
        await cluster.stop()


def test_orch_scale_up_under_cephx():
    r, osds = assert_equal_across(on_each_package(_orch_scale_up_cephx))
    assert r["rc"] == 0 and osds == [0, 1, 2]


async def _orch_apply_validation(p):
    cluster = p.DevCluster(n_mons=1, n_osds=1)
    await cluster.start()
    try:
        rados = await cluster.client()
        out = []
        for cmd, kw in (("orch apply", {"service_type": "mon", "count": 1}),
                        ("orch apply", {"service_type": "osd",
                                        "count": -2}),
                        ("orch apply", {"service_type": "osd",
                                        "count": "many"}),
                        ("orch daemon rm", {"name": "osd1"}),
                        ("orch status", {})):
            out.append(reply(await rados.mon_command(cmd, **kw)))
        await rados.shutdown()
        return out
    finally:
        await cluster.stop()


def test_orch_apply_validation():
    out = assert_equal_across(on_each_package(_orch_apply_validation))
    assert all(r["rc"] != 0 for r in out[:4])
    assert out[4]["rc"] == 0 and not out[4]["data"]["available"]
