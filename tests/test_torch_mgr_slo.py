"""The port's mgr SLO, QoS and retention loops against the JAX package's,
on a live dev cluster of each package.

The cluster scenarios of tests/test_slo.py (SLO_VIOLATION raised through
the mgr into the mon's health by a delayed ``osd.sub_op`` failpoint, then
cleared; the burn and utilization gauges in the scrape), tests/test_qos.py
(the storm backs the recovery class off on every OSD and ramps it back)
and tests/test_observability_retention.py (classed load into TSDB series
and ``ts query``, the ``ts status`` rollup, a forensic bundle's lead-up; a
tenant class named in the health check) run once on a fresh cluster of
each package, the port's OSD daemons on ``device="cpu"``.  Equal across
packages: the health checks' names and the fixed parts of their messages,
the scrape's metric names and label sets, the digest's objectives and
section keys, the QoS decisions' kinds and the TSDB catalog.  Latencies,
burn rates and counts of cycles are timing: each package is held to the
reference test's own bounds on them.  Every wait polls ``mgr.last_digest``
or the mon with timeouts well above the reference's and none sleeps a
fixed time; no wait is ``wait_health_ok`` while a violation is active.
"""

import asyncio
import re

import pytest

from test_torch_mgr import (PKGS, assert_equal_across, on_each_package,
                            scrape_series, wait_for)


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


# tests/test_slo.py's overrides, but for a put target of 150 ms (test_qos.py's)
# where it has 50: the healthy phase must stay healthy under six test
# workers, and the failpoint's 300 ms sub-op delay burns either target.
# ec_hbm_peak_gibps is set equal on both packages (their defaults differ:
# the H100's and the TPU's).
SLO_OVERRIDES = {
    "slo_put_p99_ms": 150.0, "slo_window": 1.5, "slo_raise_evals": 1,
    "slo_clear_evals": 1, "osd_heartbeat_interval": 0.1,
    "ec_hbm_peak_gibps": 1000.0,
}
QOS_OVERRIDES = {
    "slo_put_p99_ms": 150.0, "slo_window": 1.5, "slo_raise_evals": 1,
    "slo_clear_evals": 1, "osd_heartbeat_interval": 0.1,
    "qos_enable": True, "qos_recovery_max_ops": 256.0,
    "qos_ramp_ops": 64.0, "ec_hbm_peak_gibps": 1000.0,
}
TS_OVERRIDES = {
    "slo_put_p99_ms": 50.0, "slo_window": 1.5, "slo_raise_evals": 1,
    "slo_clear_evals": 1, "osd_heartbeat_interval": 0.1,
    "slo_burn_fast_s": 1.0, "slo_burn_slow_s": 2.0,
    "ec_hbm_peak_gibps": 1000.0,
}


def _shape(msg):
    """A health message with its numbers (counts, burn rates, daemon ids)
    taken out; names such as ``put_p99_ms`` stay."""
    return re.sub(r"(?<![A-Za-z_\d])\d+(\.\d+)?", "#", msg)


async def _checks(rados):
    r = await rados.mon_command("health detail")
    assert r["rc"] == 0, r
    return r["data"]["checks"]


async def _slo_raise_and_clear(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3,
                           overrides=dict(SLO_OVERRIDES))
    await cluster.start()
    try:
        mgr = await cluster.start_mgr(report_interval=0.1)
        rados = await cluster.client()
        await rados.pool_create("slop", pg_num=4, size=3)
        io = await rados.open_ioctx("slop")
        for i in range(10):
            await io.write_full(f"ok{i}", b"x" * 512)
        cycles = mgr.collect_stats["cycles"]
        await wait_for(lambda: mgr.collect_stats["cycles"] >= cycles + 3,
                       what="three report cycles over the healthy writes")
        healthy = "SLO_VIOLATION" in await _checks(rados)

        p.fp.fp_set("osd.sub_op", "delay", delay=0.3)
        i = 0

        async def raised():
            nonlocal i
            await io.write_full(f"slow{i}", b"y" * 512)
            i += 1
            return (await _checks(rados)).get("SLO_VIOLATION")
        v = await wait_for(raised, timeout=60.0, every=0.05,
                           what="SLO_VIOLATION")
        in_digest = sorted((mgr.last_digest or {}).get("health_checks",
                                                       {}))
        p.fp.fp_clear("osd.sub_op")

        async def cleared():
            await io.write_full("fast", b"z" * 512)
            return "SLO_VIOLATION" not in await _checks(rados)
        await wait_for(cleared, timeout=60.0, what="the check to clear")
        await rados.shutdown()
        return {"healthy": healthy, "severity": v["severity"],
                "message": _shape(v["message"]),
                "detail": [_shape(ln) for ln in v["detail"]],
                "digest_checks": "SLO_VIOLATION" in in_digest}
    finally:
        await cluster.stop()


def test_slo_violation_health_raise_and_clear():
    out = assert_equal_across(on_each_package(_slo_raise_and_clear))
    assert not out["healthy"] and out["severity"] == "HEALTH_WARN"
    assert out["digest_checks"]
    assert "put_p99_ms" in out["message"] and "burning" in out["message"]
    assert any("worst daemon" in ln for ln in out["detail"])


async def _gauges_in_scrape(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3,
                           overrides=dict(SLO_OVERRIDES))
    await cluster.start()
    try:
        mgr = await cluster.start_mgr(report_interval=0.1)
        rados = await cluster.client()
        await rados.pool_create("gaug", pg_num=4, size=3)
        io = await rados.open_ioctx("gaug")
        for i in range(20):
            await io.write_full(f"o{i}", b"x" * 4096)
            await io.read(f"o{i}")

        def live():
            d = mgr.last_digest or {}
            return d.get("utilization", {}).get("client_p99_ms", 0.0) > 0 \
                and d.get("num_objects") == 20 and d
        digest = await wait_for(live, what="a live window")
        text = mgr.prometheus_text(await mgr.collect(),
                                   mgr.prometheus_extra())
        await rados.shutdown()
        series = scrape_series(text)
        slo_ok = [ln for ln in text.splitlines()
                  if ln.startswith('ceph_slo_ok{objective="put_p99_ms"}')]
        return {"series": {k: v for k, v in series.items()
                           if k.startswith(("ceph_slo", "ceph_util",
                                            "ceph_osd_op_w_latency",
                                            "ceph_tsdb", "ceph_qos"))},
                "slo_ok": slo_ok,
                "objectives": [o["objective"]
                               for o in digest["slo"]["objectives"]],
                "utilization": sorted(digest["utilization"])}
    finally:
        await cluster.stop()


def test_slo_and_utilization_gauges_in_scrape():
    out = assert_equal_across(on_each_package(_gauges_in_scrape))
    s = out["series"]
    assert '{objective="put_p99_ms"}' in s["ceph_slo_burn_rate"]
    assert out["slo_ok"] == ['ceph_slo_ok{objective="put_p99_ms"} 1']
    for name in ("ceph_util_roofline_pct", "ceph_util_rebuild_gibps",
                 "ceph_util_client_p99_ms",
                 "ceph_osd_op_w_latency_us_bucket"):
        assert name in s
    assert out["objectives"] == ["put_p99_ms"]
    assert "roofline_pct" in out["utilization"]


async def _qos_storm(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3,
                           overrides=dict(QOS_OVERRIDES))
    await cluster.start()
    try:
        mgr = await cluster.start_mgr(report_interval=0.1)
        rados = await cluster.client()
        await rados.pool_create("qosp", pg_num=4, size=3)
        io = await rados.open_ioctx("qosp")
        for i in range(10):
            await io.write_full(f"ok{i}", b"x" * 512)

        def retunes():
            return [e["fields"] for e in mgr.journal.snapshot()
                    if e["type"] == "qos.retune"]
        base = len(retunes())

        def storm_retunes():
            return [r for r in retunes()[base:] if r["burning"]]

        p.fp.fp_set("osd.sub_op", "delay", delay=0.3)
        i = 0

        async def backed_off():
            nonlocal i
            await io.write_full(f"slow{i}", b"y" * 512)
            i += 1
            return storm_retunes()
        first = (await wait_for(backed_off, timeout=60.0, every=0.05,
                                what="a burning retune"))[0]

        def applied():
            want = retunes()[-1]["limit"]
            return all(o.op_scheduler.profiles["recovery"].limit == want
                       for o in cluster.osds.values())
        await wait_for(applied, what="the OSD schedulers' retune")
        osd0 = next(iter(cluster.osds.values()))
        osd_side = any(e["type"] == "mclock.retune"
                       for e in osd0.journal.snapshot())
        p.fp.fp_clear("osd.sub_op")
        floor = min(r["limit"] for r in retunes()[base:])

        async def ramped():
            await io.write_full("fast", b"z" * 512)
            return retunes()[-1]["limit"] > floor
        await wait_for(ramped, timeout=60.0, what="the ramp back")
        last = retunes()[-1]
        q = await wait_for(lambda: (mgr.last_digest or {}).get("qos", {})
                           .get("retunes", 0) >= 2 and
                           mgr.last_digest["qos"], what="qos digest")
        await rados.shutdown()
        return {"first": (sorted(first), first["clazz"], first["burning"],
                          first["limit"] < 256.0,
                          first["reservation"] <= first["limit"]),
                "osd_side": osd_side, "ramped": last["burning"],
                "digest": (sorted(q), q["enabled"])}
    finally:
        await cluster.stop()


def test_qos_storm_retune_and_ramp_e2e():
    out = assert_equal_across(on_each_package(_qos_storm))
    keys, clazz, burning, backed, bounded = out["first"]
    assert burning and backed and bounded and "limit" in keys
    assert out["osd_side"] and out["ramped"] is False
    assert out["digest"][1] is True


async def _tsdb_e2e(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3, overrides=dict(TS_OVERRIDES))
    await cluster.start()
    try:
        mgr = await cluster.start_mgr(report_interval=0.1)
        rados = await cluster.client()
        await rados.pool_create("tsp", pg_num=4, size=3)
        io = await rados.open_ioctx("tsp")
        for i in range(15):
            with p.rados.op_class("gold"):
                await io.write_full(f"g{i}", b"x" * 512)
            with p.rados.op_class("bronze"):
                await io.write_full(f"b{i}", b"y" * 512)

        def recorded():
            q = mgr.ts_query(name="class.gold.ops")
            return q["points"] and max(v[1] for v in q["points"]) > 0 and \
                mgr.collect_stats["resyncs"] >= 3
        await wait_for(recorded, what="class.gold.ops in the tsdb")
        snap = await mgr.collect()
        gold = sum((c.get("op_class_gold_latency_us") or {}).get("count", 0)
                   for c in snap["osd_perf"].values())
        rvals = [v[1] for v in mgr.ts_query(name="collect.resyncs")
                 ["points"]]
        burn = mgr.ts_query(name="slo.put_p99_ms.burn")["points"]
        st = dict(mgr.collect_stats)
        names = mgr.ts_query()["names"]
        prefix = sorted(mgr.ts_query(prefix="collect.")["series"])

        async def rolled_up():
            r = await rados.mon_command("ts status")
            return r["rc"] == 0 and r["data"]["tsdb"]["tails"] and r
        ts = (await wait_for(rolled_up, what="ts status"))["data"]["tsdb"]
        entry = await mgr.forensics_capture("manual-test")
        bundle = mgr.forensics_bundle(entry["id"])
        series = sorted(bundle["modules"]["ts"]["series"])
        await rados.shutdown()
        return {"gold": gold, "monotone": rvals == sorted(rvals),
                "burn": bool(burn),
                "delta": (st["delta"], 0 < st["last_payload_bytes"]
                          < st["payload_bytes"]),
                "names": sorted(n for n in names
                                if not n.startswith("kernel.")),
                "prefix": prefix,
                "rollup": (sorted(ts), ts["stats"]["series"] > 0),
                "lead_up": [n for n in series if n.startswith("slo.")]}
    finally:
        await cluster.stop()


def test_tsdb_e2e_classed_load_and_ts_query():
    out = {name: r for name, r in on_each_package(_tsdb_e2e).items()}
    for r in out.values():
        assert r["gold"] > 0 and r["monotone"] and r["burn"]
        assert r["delta"] == (True, True)
        assert any(n.startswith("util.") for n in r["names"])
        assert "collect.payload_bytes" in r["prefix"]
        assert r["rollup"][1] and "tails" in r["rollup"][0]
        assert r["lead_up"]
    for key in ("names", "prefix", "rollup", "lead_up"):
        assert out["ceph_tpu_torch"][key] == out["ceph_tpu"][key], key


async def _class_violation(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3, overrides=dict(TS_OVERRIDES))
    await cluster.start()
    try:
        await cluster.start_mgr(report_interval=0.1)
        rados = await cluster.client()
        await rados.pool_create("clsp", pg_num=4, size=3)
        io = await rados.open_ioctx("clsp")
        p.fp.fp_set("osd.sub_op", "delay", delay=0.3)
        i = 0
        try:
            async def named():
                nonlocal i
                with p.rados.op_class("gold"):
                    await io.write_full(f"s{i}", b"x" * 512)
                i += 1
                c = (await _checks(rados)).get("SLO_VIOLATION")
                return c and "tenant class gold" in c["message"] and c
            c = await wait_for(named, timeout=60.0, every=0.05,
                               what="the gold class in SLO_VIOLATION")
        finally:
            p.fp.fp_clear("osd.sub_op")
        await rados.shutdown()
        return ([_shape(ln) for ln in c["detail"]
                 if "tenant class" in ln], c.get("tenant_class"))
    finally:
        await cluster.stop()


def test_class_violation_names_tenant_class_in_health():
    detail, clazz = assert_equal_across(on_each_package(_class_violation))
    assert any("tenant class gold" in ln for ln in detail)
