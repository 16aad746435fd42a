"""The port's monitor services and store sync against the JAX package's.

The scenarios of tests/test_mon_sync.py, and those of test_mon_depth.py
with their OSD daemons replaced by ``MonClient`` sessions that boot OSDs
and report failures (no OSD daemon and no mgr runs), written once over a
package handle and run on each package: the full-store sync of a mon
that was down past the paxos trim window and of a brand-new mon; the
cluster log and the health checks with their mutes and transitions, on
one mon and on a quorum of three; a stale subscriber that catches up past
the OSD map's trim window.  Command results, cluster-log entries, health
summaries and maps must be equal across the packages (the clock and the
random draws fixed as in test_torch_mon.py).  Tolerance 0.
"""

import asyncio

import pytest

from tests.test_torch_mon import (PKGS, REF, SLACK, assert_equal_across,
                                  assert_same_values, fast_conf, propose_n,
                                  run_on_both, start_mons, wait_committed,
                                  wait_for, wait_quorum)


@pytest.fixture
def small_window(monkeypatch):
    """The paxos trim window cut to 20 versions in both packages, so that
    being down past it takes 30 proposals, not 500."""
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.paxos, "KEEP_VERSIONS", 20)


def _synctest(mon) -> dict:
    return {k: mon.store.get("synctest", k)
            for k in mon.store.keys("synctest")}


# ---------------------------------------------------------------------------
# store sync (test_mon_sync.py)

async def _rejoin_beyond_window(pkg, root):
    paths = {n: f"{root}/{pkg.root}/mon.{n}" for n in "abc"}
    mons = await start_mons(pkg, ["a", "b", "c"], store_paths=paths)
    a, b, c = mons
    assert await wait_quorum(mons, size=3) is a
    await propose_n(a, 5, "before", pkg.StoreTransaction)
    await c.shutdown()
    await propose_n(a, pkg.paxos.KEEP_VERSIONS + 15, "while-down",
                    pkg.StoreTransaction)
    lc_a = a.paxos.last_committed
    assert a.paxos.version_value(c.paxos.last_committed + 1) is None
    c2 = pkg.Monitor("c", a.monmap, fast_conf(pkg), store_path=paths["c"])
    await c2.start()
    await wait_for(lambda: c2.paxos.last_committed >= lc_a)
    assert c2.store.get("synctest", "before-0") == b"v0"
    assert c2.store.get("synctest", "while-down-3") == b"v3"
    await wait_for(lambda: c2.elector.in_quorum())
    await a.shutdown()
    await wait_for(lambda: b.is_leader and b.paxos.ready
                   and c2.elector.leader == "b", timeout=20.0 * SLACK)
    await propose_n(b, 3, "after-kill", pkg.StoreTransaction)
    await wait_for(lambda: c2.store.get("synctest", "after-kill-2") == b"v2")
    lc = b.paxos.last_committed
    await wait_committed([b, c2], lc)
    assert_same_values([b, c2], lc)
    out = {"b": _synctest(b), "c": _synctest(c2),
           "map": c2.osd_monitor.full_map_dict()}
    await b.shutdown()
    await c2.shutdown()
    return out


def test_rejoin_beyond_trim_window_syncs_and_survives_leader_kill(
        tmp_path, monkeypatch, small_window):
    out = run_on_both(_rejoin_beyond_window, monkeypatch, str(tmp_path))
    assert_equal_across(out)
    assert out["ceph_tpu"]["c"] == out["ceph_tpu"]["b"]


async def _fresh_bootstrap(pkg, root):
    paths = {n: f"{root}/{pkg.root}/mon.{n}" for n in "abc"}
    monmap = {n: f"local://mon.{n}" for n in "abc"}
    ab = await start_mons(pkg, ["a", "b"], store_paths=paths, monmap=monmap)
    a, b = ab
    await wait_quorum(ab)
    await propose_n(a, pkg.paxos.KEEP_VERSIONS + 10, "hist",
                    pkg.StoreTransaction)
    lc = a.paxos.last_committed
    c = pkg.Monitor("c", a.monmap, fast_conf(pkg), store_path=paths["c"])
    await c.start()
    await wait_for(lambda: c.paxos.last_committed >= lc,
                   timeout=20.0 * SLACK)
    assert c.store.get("synctest", "hist-0") == b"v0"
    await wait_for(lambda: c.elector.in_quorum(), timeout=20.0 * SLACK)
    out = {"c": _synctest(c), "map": c.osd_monitor.full_map_dict()}
    for m in (a, b, c):
        await m.shutdown()
    return out


def test_fresh_mon_bootstraps_via_store_sync(tmp_path, monkeypatch,
                                             small_window):
    out = run_on_both(_fresh_bootstrap, monkeypatch, str(tmp_path))
    assert_equal_across(out)


# ---------------------------------------------------------------------------
# cluster log and health (test_mon_depth.py, OSDs as MonClient sessions)

async def _boot_osds(pkg, monmap, n):
    clients = []
    for i in range(n):
        mc = pkg.MonClient(f"osd.{i}", monmap, fast_conf(pkg))
        await mc.start()
        mc.sub_want("osdmap")
        mc.renew_subs()
        await mc.send_boot(i, f"local://osd.{i}", host=f"h{i}")
        clients.append(mc)
    return clients


async def _poll(client, prefix, cond, timeout=15.0 * SLACK, **kw):
    """Repeat a read command until its result satisfies ``cond``."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        r = await client.command(prefix, **kw)
        if cond(r):
            return r
        assert loop.time() < deadline, r
        await asyncio.sleep(0.05)


def _log_view(entries) -> list:
    return [(e["seq"], e["stamp"], e["who"], e["level"], e["message"])
            for e in entries]


async def _log_and_health(pkg):
    (mon,) = await start_mons(pkg, ["a"])
    await wait_quorum([mon])
    osds = await _boot_osds(pkg, mon.monmap, 3)
    rados = pkg.MonClient("client.admin", mon.monmap, fast_conf(pkg))
    await rados.start()
    # the boots' entries ride the leader's ticks: committed before the
    # client's own, so the log's order is the same each run
    await wait_for(lambda: sum("boot" in e["message"]
                               for e in mon.log_monitor.entries) == 3)
    await _poll(rados, "health", lambda r: r["data"]["status"] == "HEALTH_OK")
    seen = []
    r = await rados.command("log", message="hello world", who="client.test")
    assert r["rc"] == 0, r
    seen.append(r)
    r = await _poll(rados, "log last", lambda r: "hello world" in
                    [e["message"] for e in r["data"]], num=50)
    # osd.2 reported down -> OSD_DOWN and a "Health check failed" entry
    osds[0].report_failure(2, failed_for=10.0)
    r = await _poll(rados, "health detail",
                    lambda r: "OSD_DOWN" in r["data"]["checks"])
    detail = r["data"]["checks"]["OSD_DOWN"]
    assert detail["severity"] == "HEALTH_WARN"
    assert "osd.2 is down" in detail.get("detail", [])
    seen.append(r)
    await _poll(rados, "log last", lambda r: any(
        "OSD_DOWN" in e["message"] for e in r["data"]), num=50, level="warn")
    # mute -> OK, unmute -> WARN
    for prefix, status in (("health mute", "HEALTH_OK"),
                           ("health unmute", "HEALTH_WARN")):
        r = await rados.command(prefix, code="OSD_DOWN")
        assert r["rc"] == 0, r
        h = await rados.command("health")
        assert h["data"]["status"] == status
        seen += [r, h]
    # osd.2 boots again -> the check clears and is logged
    await osds[2].send_boot(2, "local://osd.2", host="h2")
    await _poll(rados, "health", lambda r: r["data"]["status"] == "HEALTH_OK")
    r = await _poll(rados, "log last", lambda r: any(
        "Health check cleared: OSD_DOWN" in e["message"] for e in r["data"]),
        num=100)
    await _poll(rados, "log last", lambda r: any(
        "Cluster is now healthy" in e["message"] for e in r["data"]),
        num=100)
    entries = _log_view(mon.log_monitor.entries)
    for mc in osds + [rados]:
        await mc.shutdown()
    await mon.shutdown()
    return {"seen": seen, "entries": entries}


def test_cluster_log_and_health_transitions(monkeypatch):
    out = run_on_both(_log_and_health, monkeypatch)
    assert_equal_across(out)
    msgs = [e[4] for e in out["ceph_tpu"]["entries"]]
    assert "hello world" in msgs
    assert any("OSD_DOWN" in m for m in msgs)


async def _nonsticky_mute(pkg):
    (mon,) = await start_mons(pkg, ["a"])
    await wait_quorum([mon])
    osds = await _boot_osds(pkg, mon.monmap, 3)
    rados = pkg.MonClient("client.admin", mon.monmap, fast_conf(pkg))
    await rados.start()
    osds[0].report_failure(1, failed_for=10.0)
    await _poll(rados, "health", lambda r: r["data"]["status"] != "HEALTH_OK")
    # the leader's health tick has seen the check (a mute only evaporates
    # when a tick sees its check clear)
    await _poll(rados, "log last", lambda r: any(
        "OSD_DOWN" in e["message"] for e in r["data"]), num=50, level="warn")
    r = await rados.command("health mute", code="OSD_DOWN")
    assert r["rc"] == 0
    muted = dict(mon.health_monitor.mutes)
    await osds[1].send_boot(1, "local://osd.1", host="h1")
    await _poll(rados, "health", lambda r: r["data"]["status"] == "HEALTH_OK")
    # the mute evaporates with the check, on a health tick
    await wait_for(lambda: "OSD_DOWN" not in mon.health_monitor.mutes,
                   timeout=10.0 * SLACK)
    h = await rados.command("health")
    for mc in osds + [rados]:
        await mc.shutdown()
    await mon.shutdown()
    return {"r": r, "muted": muted, "health": h,
            "mutes": dict(mon.health_monitor.mutes)}


def test_nonsticky_mute_clears_with_check(monkeypatch):
    out = run_on_both(_nonsticky_mute, monkeypatch)
    assert_equal_across(out)


async def _three_mon_log_and_health(pkg):
    mons = await start_mons(pkg, ["a", "b", "c"])
    await wait_quorum(mons, size=3)
    osds = await _boot_osds(pkg, mons[0].monmap, 3)
    # the client talks to peon c only: the log entry routes to the leader
    rados = pkg.MonClient("client.q3", {"c": mons[2].monmap["c"]},
                          fast_conf(pkg))
    await rados.start()
    r = await rados.command("log", message="quorum-entry", who="client.q3")
    assert r["rc"] == 0, r
    await wait_for(lambda: all(
        "quorum-entry" in [e["message"] for e in m.log_monitor.entries]
        for m in mons))
    osds[0].report_failure(1, failed_for=10.0)
    h = await _poll(rados, "health",
                    lambda r: r["data"]["status"] == "HEALTH_WARN",
                    timeout=20.0 * SLACK)
    assert "OSD_DOWN" in h["data"]["checks"]
    await wait_for(lambda: {m.health_monitor.summary()["status"]
                            for m in mons} == {"HEALTH_WARN"})
    summaries = [m.health_monitor.summary() for m in mons]
    assert summaries[1:] == summaries[:1] * 2
    # the leader's tick logged the transition on every mon: every entry
    # queued before it (the boots) is committed, and nothing follows
    await wait_for(lambda: all(
        any("(OSD_DOWN)" in e["message"] for e in m.log_monitor.entries)
        for m in mons))
    await wait_committed(mons, mons[0].paxos.last_committed)
    boots = await rados.command("log last", num=100)
    assert any("boot" in e["message"] for e in boots["data"])
    views = [_log_view(m.log_monitor.entries) for m in mons]
    assert views[1:] == views[:1] * 2
    boot_msgs = sorted(e["message"] for e in boots["data"]
                       if "boot" in e["message"])
    for mc in osds + [rados]:
        await mc.shutdown()
    for m in mons:
        await m.shutdown()
    return {"r": r, "health": h, "summary": summaries[0],
            "boots": boot_msgs}


def test_three_mon_log_and_health_quorum(monkeypatch):
    out = run_on_both(_three_mon_log_and_health, monkeypatch)
    assert_equal_across(out)


async def _stale_subscriber(pkg):
    (mon,) = await start_mons(pkg, ["a"])
    await wait_quorum([mon])
    mon.osd_monitor.KEEP_EPOCHS = 4
    rados = pkg.MonClient("client.admin", mon.monmap, fast_conf(pkg))
    await rados.start()
    await mon.osd_monitor.wait_map(lambda m: m.epoch >= 1, timeout=10 * SLACK)
    base = mon.osd_monitor.osdmap.epoch
    rs = []
    for i in range(10):
        r = await rados.command("osd pool create", pool=f"churn-{i}",
                                pg_num=4, size=2)
        assert r["rc"] == 0, r
        rs.append(r)
    cur = mon.osd_monitor.osdmap.epoch
    assert cur - base >= 10
    assert mon.store.get("osdmap", f"inc_{base}") is None
    stale = pkg.MonClient("client.stale", mon.monmap, fast_conf(pkg))
    await stale.start()
    stale.sub_want("osdmap")
    stale.sub_have["osdmap"] = 1
    stale.osdmap = None
    stale.renew_subs()
    await wait_for(lambda: stale.osdmap is not None
                   and stale.osdmap.epoch >= cur, timeout=10.0 * SLACK)
    m = stale.osdmap
    assert {f"churn-{i}" for i in range(10)} <= {p.name
                                                for p in m.pools.values()}
    got = m.to_dict()
    assert got == REF.osd_map.OSDMap.from_dict(
        mon.osd_monitor.full_map_dict()).to_dict()
    await stale.shutdown()
    await rados.shutdown()
    await mon.shutdown()
    return {"rs": rs, "map": got, "epochs": cur - base}


def test_stale_subscriber_catches_up_past_trim_window(monkeypatch):
    out = run_on_both(_stale_subscriber, monkeypatch)
    assert_equal_across(out)
