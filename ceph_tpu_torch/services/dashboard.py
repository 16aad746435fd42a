"""Dashboard-lite: the mgr's operator-facing HTTP surface.

Counterpart of ceph_tpu/services/dashboard.py: the same module over the
port's imports.

The core of reference src/pybind/mgr/dashboard (scope per its status +
management pages, not the 11 MB web app) plus the prometheus module's
exposition endpoint and the restful module's programmatic API
(src/pybind/mgr/restful/module.py:36 role), on one asyncio server:

- ``GET /api/status``  cluster status JSON: health checks, mon quorum,
  osd/pg/pool summaries, the OSD tree, MDS ranks, and the recent
  cluster log — assembled from the same mon commands the CLI uses.
- ``GET /api/osd`` / ``GET /api/pool``  resource listings (restful).
- ``GET /api/slo``     per-objective SLO verdicts (value / burn rate /
  worst daemon) + utilization telemetry rates from the slo mgr module.
- ``GET /api/qos``     QoS defense-plane state from the qos mgr module
  (AIMD recovery limit, pushed hedge timeouts, front-door sheds).
- ``GET /api/ts``      time-series query against the mgr's retention
  store (``?name=`` one series, ``?prefix=`` a namespace, ``start`` /
  ``end`` / ``tier=raw|1m|1h|auto`` / ``max_points``; no args lists
  the catalog).
- ``GET /metrics``     prometheus text exposition of the mgr's last
  digest (the pybind/mgr/prometheus serve role) plus the SLO burn-rate
  and utilization gauges.
- ``GET /``            one self-refreshing HTML page rendering the
  status for a browser, with an operations panel driving the API.

Management surface (token-gated; disabled unless an ``api_token`` is
configured — reads stay open):

- ``POST /api/pool``              {"pool", "pg_num", "size"?}
- ``DELETE /api/pool/<name>``
- ``POST /api/osd/<id>/out|in|down``
- ``POST /api/osd_flags``         {"flag", "set": bool}  (noout &c)
- ``POST /api/health/mute``       {"code", "ttl"?} / ``.../unmute``

Every write maps 1:1 onto an existing, paxos-audited mon command —
the dashboard adds reach, not new authority.

Object-gateway panels (shown when a vstart RGW attaches itself via
``attach_rgw``; the JSON routes ride the same token gate as the
management API because placement records and lifecycle policies name
internal pools):

- ``GET /api/rgw/placement``          zone placement targets: every
  storage class with its data pool / compression / EC profile.
- ``GET /api/rgw/lifecycle``          per-bucket lifecycle rules
  (expiration + transition); ``?bucket=<name>`` narrows to one.
"""

from __future__ import annotations

import asyncio
import hmac as hmac_mod
import html
import json
import time

from ceph_tpu_torch.common.log import Dout

log = Dout("dashboard")


class Dashboard:
    def __init__(self, mgr, host: str = "127.0.0.1", port: int = 0,
                 api_token: str | None = None):
        self.mgr = mgr
        self.host = host
        self.port = port
        self.api_token = api_token
        self.rgw = None             # RGWLite, via attach_rgw()
        self._server: asyncio.AbstractServer | None = None
        self._metrics_cache: tuple[float, bytes] = (0.0, b"")

    def attach_rgw(self, gw) -> None:
        """Expose an RGWLite's placement + lifecycle state read-only."""
        self.rgw = gw

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.dout(1, "dashboard on %s:%d", self.host, self.port)
        return self.host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- http --------------------------------------------------------------
    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
            headers = {}
            head_lines = head.decode("latin-1").split("\r\n")
            line = head_lines[0]
            for ln in head_lines[1:]:
                k, _, v = ln.partition(":")
                headers[k.strip().lower()] = v.strip()
            method, path, _ = (line.split(" ", 2) + ["", ""])[:3]
            path, _, rawq = path.partition("?")
            query: dict[str, str] = {}
            for pair in rawq.split("&"):
                if pair:
                    k, _, v = pair.partition("=")
                    query[k] = v
            req_body = b""
            clen = int(headers.get("content-length", 0) or 0)
            if clen:
                req_body = await reader.readexactly(min(clen, 1 << 20))
            if method in ("POST", "DELETE"):
                status, body = await self._mutate(method, path,
                                                  headers, req_body)
                ctype = "application/json"
            elif method != "GET":
                body, ctype, status = b"bad method", "text/plain", 405
            elif path == "/api/status":
                body = json.dumps(await self._status()).encode()
                ctype, status = "application/json", 200
            elif path == "/api/osd":
                body = json.dumps(await self._osd_list()).encode()
                ctype, status = "application/json", 200
            elif path == "/api/pool":
                body = json.dumps(await self._pool_list()).encode()
                ctype, status = "application/json", 200
            elif path in self._GET_MON_ROUTES:
                prefix, kw = self._GET_MON_ROUTES[path]
                data = await self._mon(prefix, **kw)
                if data is None:
                    # a mon outage/election must read as a failed
                    # poll, not a successful empty one
                    body = json.dumps(
                        {"error": "mon command failed"}).encode()
                    ctype, status = "application/json", 503
                else:
                    body = json.dumps(data).encode()
                    ctype, status = "application/json", 200
            elif path in ("/api/rgw/placement", "/api/rgw/lifecycle"):
                status, body = await self._rgw_get(path, headers, query)
                ctype = "application/json"
            elif path == "/api/trace":
                status, body = await self._trace_get(headers, query)
                ctype = "application/json"
            elif path == "/api/forensics":
                # bundle index from the mgr's flight recorder; ?id=
                # loads one full bundle (merged timeline + per-daemon
                # rings) back from disk
                bid = query.get("id", "")
                if bid:
                    bundle = self.mgr.forensics_bundle(bid)
                    if bundle is None:
                        body = json.dumps(
                            {"error": f"no bundle {bid!r}"}).encode()
                        ctype, status = "application/json", 404
                    else:
                        body = json.dumps(bundle).encode()
                        ctype, status = "application/json", 200
                else:
                    body = json.dumps({
                        "bundles": self.mgr.forensics_index(),
                    }).encode()
                    ctype, status = "application/json", 200
            elif path == "/api/slo":
                # SLO verdicts + utilization rates straight from the
                # mgr's last digest (the slo module's contribution)
                digest = self.mgr.last_digest or {}
                body = json.dumps({
                    "slo": digest.get("slo", {}),
                    "utilization": digest.get("utilization", {}),
                }).encode()
                ctype, status = "application/json", 200
            elif path == "/api/qos":
                # defense-plane state: controller AIMD position,
                # pushed hedge timeouts, front-door shed counts
                digest = self.mgr.last_digest or {}
                body = json.dumps({
                    "qos": digest.get("qos", {}),
                }).encode()
                ctype, status = "application/json", 200
            elif path == "/api/ts":
                # time-series query against the retention module; the
                # same planner the asok `ts query` command uses
                def _qf(k):
                    v = query.get(k, "")
                    return float(v) if v else None
                body = json.dumps(self.mgr.ts_query(
                    name=query.get("name", ""),
                    prefix=query.get("prefix", ""),
                    start=_qf("start"), end=_qf("end"),
                    tier=query.get("tier", "auto"),
                    max_points=int(query.get("max_points", "0") or 0),
                )).encode()
                ctype, status = "application/json", 200
            elif path == "/metrics":
                # collect() messages every OSD; cache briefly so an
                # aggressive scraper doesn't multiply cluster traffic
                ts, cached = self._metrics_cache
                if time.monotonic() - ts < 1.0:
                    body = cached
                else:
                    snap = await self.mgr.collect()
                    body = self.mgr.prometheus_text(
                        snap, self.mgr.prometheus_extra()).encode()
                    self._metrics_cache = (time.monotonic(), body)
                ctype, status = "text/plain; version=0.0.4", 200
            elif path == "/":
                body = (await self._html()).encode()
                ctype, status = "text/html; charset=utf-8", 200
            else:
                body, ctype, status = b"not found", "text/plain", 404
            writer.write(
                f"HTTP/1.1 {status} X\r\ncontent-type: {ctype}\r\n"
                f"content-length: {len(body)}\r\n"
                f"connection: close\r\n\r\n".encode() + body)
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except Exception as e:          # noqa: BLE001 — serve a 500
            try:
                msg = f"internal error: {type(e).__name__}".encode()
                writer.write(
                    b"HTTP/1.1 500 X\r\ncontent-type: text/plain\r\n"
                    + f"content-length: {len(msg)}\r\n\r\n".encode()
                    + msg)
                await writer.drain()
            except (ConnectionError, OSError):
                pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # read-only resource routes (the restful module's GET surface):
    # each maps straight onto one paxos-consistent mon command
    _GET_MON_ROUTES = {
        "/api/health": ("health", {}),
        "/api/mon": ("mon dump", {}),
        "/api/quorum": ("quorum_status", {}),
        "/api/df": ("df", {}),
        "/api/osd_df": ("osd df", {}),
        "/api/pg": ("pg stat", {}),
        "/api/fs": ("fs status", {}),
        "/api/crush": ("osd tree", {}),
        "/api/log": ("log last", {"num": 100}),
    }

    # -- management API (restful module + dashboard write surface) ---------
    def _authorized(self, headers: dict) -> bool:
        if not self.api_token:
            return False            # writes disabled entirely
        auth = headers.get("authorization", "")
        tok = auth[len("Bearer "):] if auth.startswith("Bearer ") \
            else headers.get("x-auth-token", "")
        return hmac_mod.compare_digest(tok, self.api_token)

    async def _mutate(self, method: str, path: str, headers: dict,
                      raw: bytes) -> tuple[int, bytes]:
        def reply(status: int, **data) -> tuple[int, bytes]:
            return status, json.dumps(data).encode()

        if not self._authorized(headers):
            return reply(403, error="missing or bad api token")
        try:
            args = json.loads(raw) if raw else {}
            if not isinstance(args, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            return reply(400, error=f"bad body: {e}")
        parts = [p for p in path.split("/") if p]
        if not parts or parts[0] != "api":
            return reply(404, error="unknown route")

        async def mon(prefix: str, **kw):
            r = await self.mgr.monc.command(prefix, **kw)
            if r.get("rc") != 0:
                return reply(409, error=r.get("outs", "refused"),
                             rc=r.get("rc"))
            return reply(200, ok=True, result=r.get("data"))

        route = parts[1:]
        if method == "POST" and route == ["pool"]:
            pool = str(args.get("pool", ""))
            if not pool:
                return reply(400, error="pool name required")
            return await mon(
                "osd pool create", pool=pool,
                pg_num=int(args.get("pg_num", 8)),
                size=int(args.get("size", 3)))
        if method == "DELETE" and len(route) == 2 \
                and route[0] == "pool":
            return await mon("osd pool delete", pool=route[1])
        if method == "POST" and len(route) == 3 \
                and route[0] == "osd" and route[2] in ("out", "in",
                                                       "down"):
            try:
                osd = int(route[1])
            except ValueError:
                return reply(400, error=f"bad osd id {route[1]!r}")
            return await mon(f"osd {route[2]}", ids=[osd])
        if method == "POST" and route == ["osd_flags"]:
            flag = str(args.get("flag", ""))
            if not flag:
                return reply(400, error="flag required")
            verb = "osd set" if args.get("set", True) else "osd unset"
            return await mon(verb, flag=flag)
        if method == "POST" and route == ["health", "mute"]:
            return await mon("health mute",
                             code=str(args.get("code", "")),
                             sticky=bool(args.get("sticky", False)))
        if method == "POST" and route == ["health", "unmute"]:
            return await mon("health unmute",
                             code=str(args.get("code", "")))
        return reply(404, error="unknown route")

    # -- tracing -----------------------------------------------------------
    async def _trace_get(self, headers: dict,
                         query: dict) -> tuple[int, bytes]:
        """``GET /api/trace?trace_id=<id>``: cluster-wide span
        reassembly via the mgr's dump_traces fan-out.  Token-gated —
        span tags carry object names and pool ids."""
        def reply(status: int, data) -> tuple[int, bytes]:
            return status, json.dumps(data).encode()

        if not self._authorized(headers):
            return reply(403, {"error": "missing or bad api token"})
        trace_id = query.get("trace_id", "")
        if not trace_id:
            return reply(400, {"error": "trace_id required"})
        tree = await self.mgr.collect_trace(trace_id)
        return reply(200, {"trace_id": trace_id, "spans": tree})

    # -- object gateway (placement targets + lifecycle) --------------------
    async def _rgw_get(self, path: str, headers: dict,
                       query: dict) -> tuple[int, bytes]:
        def reply(status: int, data) -> tuple[int, bytes]:
            return status, json.dumps(data).encode()

        # placement records name internal pools and lifecycle rules
        # reveal bucket names — gate like the management API
        if not self._authorized(headers):
            return reply(403, {"error": "missing or bad api token"})
        if self.rgw is None:
            return reply(503, {"error": "no rgw attached"})
        if path == "/api/rgw/placement":
            return reply(200, await self._rgw_placement())
        return reply(200, await self._rgw_lifecycle(
            query.get("bucket") or None))

    async def _rgw_placement(self) -> list[dict]:
        from ceph_tpu_torch.services.rgw_zone import ZonePlacement
        return await ZonePlacement(self.rgw.ioctx).ls()

    async def _rgw_lifecycle(self, bucket: str | None = None) -> dict:
        out: dict = {}
        names = [bucket] if bucket else await self.rgw.list_buckets()
        for name in names:
            try:
                meta = await self.rgw._bucket_meta(name)
            except Exception:               # noqa: BLE001 — racing rm
                continue
            rules = meta.get("lifecycle") or []
            if rules:
                out[name] = rules
        return out

    async def _osd_list(self) -> list[dict]:
        dump = await self._mon("osd dump") or {}
        return [
            {"osd": int(oid), **info}
            for oid, info in sorted(
                (dump.get("osds") or {}).items(),
                key=lambda kv: int(kv[0]))
        ]

    async def _pool_list(self) -> list[dict]:
        dump = await self._mon("osd dump") or {}
        pools = dump.get("pools") or {}
        return [dict(p, pool_id=int(pid))
                for pid, p in sorted(pools.items(),
                                     key=lambda kv: str(kv[0]))]

    # -- data assembly -----------------------------------------------------
    async def _mon(self, prefix: str, **args):
        try:
            r = await self.mgr.monc.command(prefix, **args)
        except (ConnectionError, asyncio.TimeoutError):
            return None
        return r.get("data") if r.get("rc") == 0 else None

    async def _status(self) -> dict:
        out: dict = {"ts": time.time()}
        # seven mon reads, all independent: fetch concurrently ("df"
        # is NOT fetched — its payload is the mgr digest this process
        # already holds in last_digest)
        (out["status"], out["health"], out["osd_tree"], out["mds"],
         logs, out["fs"], out["quorum"]) = \
            await asyncio.gather(
            self._mon("status"), self._mon("health"),
            self._mon("osd tree"), self._mon("mds stat"),
            self._mon("log last", num=50),
            self._mon("fs status"), self._mon("quorum_status"))
        out["log"] = logs or []
        digest = getattr(self.mgr, "last_digest", None) or {}
        out["pgmap"] = {
            k: digest.get(k) for k in
            ("pgs_by_state", "num_pgs", "num_objects", "num_bytes",
             "degraded_objects", "pools", "osd_df")
            if k in digest
        }
        return out

    # -- html rendering ----------------------------------------------------
    async def _html(self) -> str:
        s = await self._status()
        esc = html.escape
        health = s.get("health") or {}
        checks = health.get("checks") or {}
        hstatus = health.get("status", "UNKNOWN")
        color = {"HEALTH_OK": "#2a2", "HEALTH_WARN": "#f90",
                 "HEALTH_ERR": "#d22"}.get(hstatus, "#888")
        rows: list[str] = []

        def section(title: str, inner: str) -> None:
            rows.append(f"<h2>{esc(title)}</h2>{inner}")

        def table(headers: list[str], body_rows: list[list[str]]) -> str:
            head = "".join(f"<th>{esc(h)}</th>" for h in headers)
            body = "".join(
                "<tr>" + "".join(f"<td>{c}</td>" for c in r) + "</tr>"
                for r in body_rows)
            return (f"<table><thead><tr>{head}</tr></thead>"
                    f"<tbody>{body}</tbody></table>")

        section("Health", (
            f'<p class="pill" style="background:{color}">'
            f"{esc(hstatus)}</p>"
            + (table(["check", "severity", "message"], [
                [esc(k), esc(v.get("severity", "")),
                 esc(v.get("message", ""))]
                for k, v in sorted(checks.items())
            ]) if checks else "<p>no active health checks</p>")))

        pg = s.get("pgmap") or {}
        states = pg.get("pgs_by_state") or {}
        section("PGs", table(["state", "count"], [
            [esc(k), str(v)] for k, v in sorted(states.items())
        ]) + f"<p>{pg.get('num_pgs', 0)} pgs, "
            f"{pg.get('num_objects', 0)} objects, "
            f"{pg.get('num_bytes', 0)} bytes, "
            f"{pg.get('degraded_objects', 0)} degraded</p>")

        pools = pg.get("pools") or {}
        section("Pools", table(
            ["pool", "pgs", "objects", "bytes", "degraded"], [
                [esc(str(p.get("name", pid))), str(p.get("num_pgs", 0)),
                 str(p.get("num_objects", 0)),
                 str(p.get("num_bytes", 0)), str(p.get("degraded", 0))]
                for pid, p in sorted(pools.items(),
                                     key=lambda kv: str(kv[0]))
            ]))

        section("Capacity",
                f"<p>{pg.get('num_bytes', 0)} bytes stored in "
                f"{pg.get('num_objects', 0)} objects</p>")

        digest = getattr(self.mgr, "last_digest", None) or {}
        slo = digest.get("slo") or {}
        objectives = slo.get("objectives") or []
        if objectives:
            def fmt_val(rec):
                v = rec.get("value")
                return "n/a" if v is None else \
                    f"{v:.4g} {rec.get('unit', '')}"

            section("Serving SLO", table(
                ["objective", "target", "value", "burn rate",
                 "worst daemon", "status"], [
                    [esc(r.get("objective", "")),
                     esc(f"{r.get('target', 0):g} {r.get('unit', '')}"),
                     esc(fmt_val(r)),
                     esc(f"{r.get('burn_rate', 0.0):.2f}x"),
                     esc(str(r.get("worst_daemon") or "-")),
                     ('<span style="color:#d22">VIOLATING</span>'
                      if r.get("violating") else
                      '<span style="color:#2a2">ok</span>')]
                    for r in objectives
                ]))

        util = digest.get("utilization") or {}
        if util:
            # the rebuild-vs-client-tail pair reads side by side: the
            # interference arxiv 1906.08602 names as THE tail driver
            section("Utilization", table(["series", "value"], [
                ["device GiB/s (EC launches)",
                 esc(f"{util.get('device_gibps', 0.0):g}")],
                ["HBM roofline %",
                 esc(f"{util.get('roofline_pct', 0.0):g}%")],
                ["coalesce occupancy (ops/launch)",
                 esc(f"{util.get('coalesce_occupancy', 0.0):g}")],
                ["coalesce wait p50/p99 µs",
                 esc(f"{util.get('coalesce_wait_p50_us', 0.0):g} / "
                     f"{util.get('coalesce_wait_p99_us', 0.0):g}")],
                ["resident cache hit rate",
                 esc(f"{util.get('resident_hit_rate', 0.0):g}")],
                ["rebuild GiB/s ⇄ client p99 ms",
                 esc(f"{util.get('rebuild_gibps', 0.0):g} ⇄ "
                     f"{util.get('client_p99_ms', 0.0):g}")],
                ["client p50/p99/p999 ms",
                 esc(f"{util.get('client_p50_ms', 0.0):g} / "
                     f"{util.get('client_p99_ms', 0.0):g} / "
                     f"{util.get('client_p999_ms', 0.0):g}")],
            ]))

        qos = digest.get("qos") or {}
        if qos.get("enabled"):
            hedges = qos.get("hedge_timeouts_ms") or {}
            hedge_s = ", ".join(f"{d}: {t:g}ms"
                                for d, t in sorted(hedges.items())) \
                or "none pushed"
            section("QoS defense plane", table(["series", "value"], [
                ["controller",
                 ('<span style="color:#d22">BACKING OFF</span>'
                  if qos.get("burning") else
                  '<span style="color:#2a2">steady</span>')],
                ["client latency burn",
                 esc(f"{qos.get('burn', 0.0):g}x")],
                ["recovery limit (ops/s)",
                 esc(f"{qos.get('recovery_limit', 0.0):g} "
                     f"(floor {qos.get('recovery_floor', 0.0):g}, "
                     f"ceiling {qos.get('recovery_ceiling', 0.0):g})")],
                ["mClock retunes", esc(str(qos.get("retunes", 0)))],
                ["adaptive hedge timeouts", esc(hedge_s)],
                ["recent RGW sheds (503)",
                 esc(str(qos.get("recent_sheds", 0)))],
            ]))

        fsmap = s.get("fs") or {}
        fs_rows = []
        for fsname, info in sorted(fsmap.items()):
            if not isinstance(info, dict):
                continue
            ranks = ", ".join(
                f"{r.get('rank')}:{r.get('name')}({r.get('state')})"
                for r in info.get("ranks", ()))
            fs_rows.append([esc(str(fsname)), esc(ranks),
                            esc(str(info.get("standbys", ""))),
                            esc(str(info.get("down", "")))])
        if fs_rows:
            section("Filesystems", table(
                ["fs", "ranks", "standbys", "down"], fs_rows))

        q = s.get("quorum") or {}
        if q:
            section("Monitors", table(["", ""], [
                [esc(k), esc(str(v))] for k, v in sorted(q.items())
            ]))

        tree = s.get("osd_tree") or {}
        tree_rows: list[list[str]] = []

        def walk(node: dict, depth: int) -> None:
            pad = "&nbsp;" * 4 * depth
            status = node.get("status", "")
            badge = (f'<span style="color:'
                     f'{"#2a2" if status == "up" else "#d22"}">'
                     f"{esc(status)}</span>" if status else "")
            tree_rows.append([
                pad + esc(node.get("name", "?")),
                esc(node.get("type", "")), badge,
                esc(f"{node.get('reweight', '')}"),
            ])
            for child in node.get("children", ()):
                walk(child, depth + 1)

        for root in tree.get("nodes", ()):
            walk(root, 0)
        section("OSD tree", table(["name", "type", "status", "reweight"],
                                  tree_rows))

        if self.rgw is not None:
            # object-gateway panels: where each storage class lands
            # and which buckets have tiering/expiration policies
            try:
                placements = await self._rgw_placement()
            except Exception:           # noqa: BLE001 — rgw racing
                placements = []
            pl_rows = []
            for rec in placements:
                classes = rec.get("storage_classes") or {}
                for cls, c in sorted(classes.items()):
                    pl_rows.append([
                        esc(rec.get("id", "")), esc(cls),
                        esc(c.get("pool", "") or "(zone pool)"),
                        esc(c.get("compression", "") or "-"),
                        esc(c.get("ec_profile", "") or "-")])
            section("RGW placement targets", table(
                ["placement", "class", "data pool", "compression",
                 "ec profile"], pl_rows)
                if pl_rows else "<p>no placement targets</p>")

            try:
                lc = await self._rgw_lifecycle()
            except Exception:           # noqa: BLE001
                lc = {}
            lc_rows = []
            for bname, rules in sorted(lc.items()):
                for r in rules:
                    acts = []
                    for kind, label in (
                            ("expiration", "expire"),
                            ("noncurrent", "expire-noncurrent"),
                            ("abort_mpu", "abort-mpu"),
                            ("transition", "transition"),
                            ("noncurrent_transition",
                             "transition-noncurrent")):
                        if f"{kind}_seconds" in r:
                            t = f"{r[f'{kind}_seconds']}s"
                        elif f"{kind}_days" in r:
                            t = f"{r[f'{kind}_days']}d"
                        else:
                            continue
                        cls = r.get(f"{kind}_class", "")
                        acts.append(f"{label} {t}"
                                    + (f" → {cls}" if cls else ""))
                    lc_rows.append([
                        esc(bname), esc(r.get("id", "")),
                        esc(r.get("prefix", "") or "-"),
                        esc(r.get("status", "")),
                        esc("; ".join(acts))])
            if lc_rows:
                section("RGW lifecycle", table(
                    ["bucket", "rule", "prefix", "status", "actions"],
                    lc_rows))

        if self.api_token:
            # operations panel: every button drives the token-gated
            # management API (the dashboard write surface)
            section("Operations", """
<p>api token: <input id="tok" type="password" size="24"></p>
<p>osd <input id="osdid" size="4" value="0">
 <button onclick="osd('out')">out</button>
 <button onclick="osd('in')">in</button>
 <button onclick="osd('down')">down</button></p>
<p>flag <input id="flag" size="10" value="noout">
 <button onclick="flags(true)">set</button>
 <button onclick="flags(false)">unset</button></p>
<p>pool <input id="pool" size="12">
 <button onclick="mkpool()">create</button>
 <button onclick="rmpool()">delete</button></p>
<p>mute <input id="code" size="14" value="OSD_DOWN">
 <button onclick="mute(true)">mute</button>
 <button onclick="mute(false)">unmute</button></p>
<pre id="out"></pre>
<script>
async function call(method, path, body) {
  const r = await fetch(path, {method: method,
    headers: {"authorization": "Bearer " +
              document.getElementById("tok").value},
    body: body ? JSON.stringify(body) : undefined});
  document.getElementById("out").textContent = await r.text();
}
function osd(verb) {
  call("POST", "/api/osd/" +
       document.getElementById("osdid").value + "/" + verb);
}
function flags(on) {
  call("POST", "/api/osd_flags",
       {flag: document.getElementById("flag").value, set: on});
}
function mkpool() {
  call("POST", "/api/pool",
       {pool: document.getElementById("pool").value});
}
function rmpool() {
  call("DELETE", "/api/pool/" +
       document.getElementById("pool").value);
}
function mute(on) {
  call("POST", "/api/health/" + (on ? "mute" : "unmute"),
       {code: document.getElementById("code").value});
}
</script>""")

        mds = s.get("mds") or {}
        mds_rows = []
        for fs, info in sorted((mds.get("filesystems") or {}).items()):
            for a in info.get("actives", ()):
                mds_rows.append([esc(fs), str(a.get("rank", 0)),
                                 esc(a.get("name", "")), "active"])
            for n in info.get("standby", ()):
                mds_rows.append([esc(fs), "-", esc(n), "standby"])
            for n in info.get("down", ()):
                mds_rows.append([esc(fs), "-", esc(n), "down"])
        if mds_rows:
            section("MDS", table(["fs", "rank", "name", "state"],
                                 mds_rows))

        logs = s.get("log") or []
        section("Cluster log", table(["when", "level", "who", "message"], [
            [esc(time.strftime("%H:%M:%S",
                               time.localtime(e.get("stamp", 0)))),
             esc(e.get("level", "")), esc(e.get("who", "")),
             esc(e.get("message", ""))]
            for e in logs[-25:][::-1]
        ]))

        return (
            "<!doctype html><html><head>"
            '<meta charset="utf-8">'
            '<meta http-equiv="refresh" content="5">'
            "<title>ceph_tpu dashboard</title><style>"
            "body{font-family:sans-serif;margin:2em;color:#223}"
            "table{border-collapse:collapse;margin:.5em 0}"
            "td,th{border:1px solid #ccd;padding:.25em .6em;"
            "text-align:left;font-size:.9em}"
            "th{background:#eef}h2{margin:.8em 0 .2em}"
            ".pill{display:inline-block;color:#fff;padding:.2em .8em;"
            "border-radius:1em;font-weight:bold}"
            "</style></head><body><h1>ceph_tpu</h1>"
            + "".join(rows) + "</body></html>"
        )
