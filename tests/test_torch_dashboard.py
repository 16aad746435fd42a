"""The port's mgr dashboard against the JAX package's.

The scenarios of tests/test_dashboard.py (the status page, /api/status and
/metrics; the dashboard started by ``start_mgr(dashboard=True)`` and closed
by the cluster's stop; the token-gated write surface; the resource routes
and page sections) run once on a fresh dev cluster of each package, the
port's OSD daemons on ``device="cpu"``, with the dashboard on 127.0.0.1 and
port 0.  Equal across packages: every route's HTTP status, the keys of
every ``/api/*`` JSON reply (recursively, lists by their first element),
the values that a settled cluster fixes (PG counts, pool names, the OSD
tree's names), the page's sections and the scrape's metric names.  The
gateway's panels wait for the port's RGW (ROADMAP A12.2).
"""

import asyncio
import json

import pytest

from test_torch_mgr import (PKGS, assert_equal_across, on_each_package,
                            scrape_series, wait_for)


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS.values():
        p.reset_local_namespace()
    yield
    for p in PKGS.values():
        p.reset_local_namespace()


async def _http(host, port, method, path, body=None, token=None):
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode() if body is not None else b""
    hdrs = [f"{method} {path} HTTP/1.1", "host: x",
            f"content-length: {len(payload)}"]
    if token is not None:
        hdrs.append(f"authorization: Bearer {token}")
    writer.write("\r\n".join(hdrs).encode() + b"\r\n\r\n" + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rbody = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), rbody


def keys_of(obj):
    """The shape of a JSON value: dicts by their keys (recursively), lists
    by their first element, scalars by their type."""
    if isinstance(obj, dict):
        return {k: keys_of(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [keys_of(obj[0])] if obj else []
    return type(obj).__name__


async def _settled_mgr(cluster, rados, pool, nbytes):
    r = await rados.mon_command("osd pool create", pool=pool, pg_num=8,
                                size=3)
    assert r["rc"] == 0, r
    io = await rados.open_ioctx(pool)
    await io.write_full("obj1", b"x" * nbytes)
    mgr = await cluster.start_mgr()
    await wait_for(lambda: (mgr.last_digest or {}).get("num_objects") == 1
                   and mgr.last_digest["pgs_by_state"] ==
                   {"active+clean": 8}, what="a settled digest")
    return mgr


async def _status_metrics_and_page(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        rados = await cluster.client()
        mgr = await _settled_mgr(cluster, rados, "dash", 1000)
        dash = p.dashboard.Dashboard(mgr, host="127.0.0.1", port=0)
        host, port = await dash.start()
        st, body = await _http(host, port, "GET", "/api/status")
        s = json.loads(body)
        mst, metrics = await _http(host, port, "GET", "/metrics")
        pst, page = await _http(host, port, "GET", "/")
        text = page.decode()
        post, _ = await _http(host, port, "POST", "/api/status")
        nope, _ = await _http(host, port, "GET", "/nope")
        await dash.stop()
        await rados.shutdown()
        return {"status": (st, mst, pst, post, nope),
                "keys": keys_of({k: v for k, v in s.items()
                                 if k != "log"}),
                "log": bool(s["log"]) and isinstance(s["log"], list),
                "pgmap": (s["pgmap"]["num_pgs"], s["pgmap"]["pgs_by_state"]),
                "tree": sorted(n["name"] for n in s["osd_tree"]["nodes"]),
                "sections": [f for f in ("Health", "PGs", "Pools",
                                         "OSD tree", "Cluster log", "osd.0")
                             if f in text],
                "metrics": sorted(scrape_series(metrics.decode()))}
    finally:
        await cluster.stop()


def test_dashboard_status_metrics_and_page():
    out = assert_equal_across(on_each_package(_status_metrics_and_page))
    assert out["status"] == (200, 200, 200, 403, 404)
    assert out["pgmap"][0] >= 8 and out["log"]
    assert "default" in out["tree"] and len(out["sections"]) == 6
    assert "ceph_health_status" in out["metrics"]


async def _via_vstart(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        mgr = await cluster.start_mgr(dashboard=True)
        host, port = mgr.dashboard.host, mgr.dashboard.port
        st, body = await _http(host, port, "GET", "/api/status")
        served = (host, st, b"health" in body)
    finally:
        await cluster.stop()
    try:
        await _http(host, port, "GET", "/api/status")
        closed = False
    except (ConnectionError, OSError):
        closed = True
    return served, closed


def test_dashboard_via_vstart():
    served, closed = assert_equal_across(on_each_package(_via_vstart))
    assert served == ("127.0.0.1", 200, True) and closed


async def _write_surface(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        rados = await cluster.client()
        mgr = await cluster.start_mgr(dashboard=True,
                                      dashboard_token="s3cr3t")
        host, port = mgr.dashboard.host, mgr.dashboard.port
        tok = "s3cr3t"
        out = []

        async def call(method, path, body=None, token=None):
            st, rbody = await _http(host, port, method, path, body, token)
            out.append((method, path, st))
            return st, rbody

        async def pools():
            r = await rados.mon_command("osd dump")
            return sorted(q["name"] for q in r["data"]["pools"].values())

        async def osd1_in():
            r = await rados.mon_command("osd dump")
            return r["data"]["osds"]["1"]["in"]

        async def flags():
            r = await rados.mon_command("osd dump")
            return sorted(r["data"]["flags"])

        await call("POST", "/api/pool", {"pool": "nope"})
        await call("POST", "/api/pool", {"pool": "nope"}, token="wrong")
        await call("GET", "/api/status")
        await call("POST", "/api/pool", {"pool": "webpool", "pg_num": 8,
                                         "size": 2}, token=tok)
        out.append(await pools())
        _, body = await call("GET", "/api/pool")
        out.append(keys_of(json.loads(body)))
        await call("DELETE", "/api/pool/webpool", token=tok)
        out.append(await pools())
        await call("POST", "/api/osd/1/out", token=tok)
        await wait_for(lambda: _not(osd1_in()), what="osd.1 out")
        await call("POST", "/api/osd/1/in", token=tok)
        await wait_for(osd1_in, what="osd.1 in")
        await call("POST", "/api/osd_flags", {"flag": "noout", "set": True},
                   token=tok)
        out.append(await flags())
        await call("POST", "/api/osd_flags",
                   {"flag": "noout", "set": False}, token=tok)
        out.append(await flags())
        await cluster.kill_osd(2)

        async def osd_down():
            r = await rados.mon_command("health")
            return "OSD_DOWN" in r["data"]["checks"]
        await wait_for(osd_down, what="OSD_DOWN")
        await call("POST", "/api/health/mute", {"code": "OSD_DOWN"},
                   token=tok)
        out.append((await rados.mon_command("health"))["data"]["status"])
        await call("POST", "/api/health/unmute", {"code": "OSD_DOWN"},
                   token=tok)
        out.append((await rados.mon_command("health"))["data"]["status"])
        await call("POST", "/api/osd/x/out", token=tok)
        await call("POST", "/api/mystery", token=tok)
        await rados.shutdown()
        return out
    finally:
        await cluster.stop()


async def _not(coro):
    return not await coro


def test_dashboard_write_surface():
    out = assert_equal_across(on_each_package(_write_surface))
    codes = [x[2] for x in out if isinstance(x, tuple) and len(x) == 3
             and isinstance(x[2], int)]
    assert codes[:3] == [403, 403, 200] and codes[-2:] == [400, 404]
    assert ["webpool"] == [x for x in out if isinstance(x, list)][0]
    assert "noout" in [x for x in out if isinstance(x, list)][3]
    assert "HEALTH_OK" in out and "HEALTH_WARN" in out


ROUTES = ("/api/health", "/api/mon", "/api/quorum", "/api/df", "/api/pg",
          "/api/crush", "/api/log", "/api/osd_df", "/api/fs", "/api/pool",
          "/api/slo", "/api/forensics", "/api/ts", "/api/osd", "/api/qos")


async def _resource_routes(p):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    try:
        rados = await cluster.client()
        mgr = await _settled_mgr(cluster, rados, "dd", 2000)
        dash = p.dashboard.Dashboard(mgr, host="127.0.0.1", port=0)
        host, port = await dash.start()
        out = {}
        for route in ROUTES:
            st, body = await _http(host, port, "GET", route)
            js = json.loads(body) if body else None
            out[route] = (st, keys_of(js) if route != "/api/log"
                          else isinstance(js, list))
        st, body = await _http(host, port, "GET", "/api/df")
        pools = sorted(str(q.get("name"))
                       for q in json.loads(body)["pools"].values())
        st, page = await _http(host, port, "GET", "/")
        text = page.decode()
        await dash.stop()
        await rados.shutdown()
        return out, pools, [f for f in ("Capacity", "Monitors", "dd")
                            if f in text]
    finally:
        await cluster.stop()


def test_dashboard_resource_routes_and_api_keys():
    routes, pools, sections = assert_equal_across(
        on_each_package(_resource_routes))
    for route in ("/api/health", "/api/mon", "/api/quorum", "/api/df",
                  "/api/pg", "/api/crush", "/api/log", "/api/osd_df",
                  "/api/fs"):
        assert routes[route][0] == 200, route
    assert "dd" in pools and sections == ["Capacity", "Monitors", "dd"]
