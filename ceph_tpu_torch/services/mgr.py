"""Mgr: cluster metrics aggregation + prometheus exposition.

Counterpart of ceph_tpu/services/mgr.py: the same module over the
port's imports.

The reference's manager pulls MMgrReport perf-counter payloads from every
daemon (src/mgr/DaemonServer.h:51) and the prometheus mgr module renders
them (src/pybind/mgr/prometheus/module.py:1021). Here the mgr polls: it
asks each up OSD for a ``perf_dump`` (the admin-socket ``perf dump``
surface, reference common/admin_socket.h:105) and merges the replies with
monitor status into one snapshot, rendered in the prometheus text
exposition format with the metric names the reference's module exports
(ceph_osd_op, ceph_osd_op_in_bytes, ceph_osd_up, ...).
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import tempfile
import time

from ceph_tpu_torch.common.config import ConfigProxy
from ceph_tpu_torch.common.events import (
    EventJournal,
    merge_timeline,
    proc_journal,
)
from ceph_tpu_torch.common.perf import bucket_le, hist_merge, hist_quantile
from ceph_tpu_torch.common.tracing import assemble_tree
from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.msg.messenger import Connection, Messenger, Policy


def prom_escape(value: str) -> str:
    """Escape a prometheus label VALUE per the text exposition spec:
    backslash first (it is the escape char), then double-quote and
    newline.  Daemon names are tame today, but free-form label values
    (SLO objective specs, pool names) must not be able to break the
    scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def prom_label(**labels) -> str:
    """Render one ``{k="v",...}`` label set with escaped values."""
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{prom_escape(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


class Mgr:
    def __init__(self, monmap: dict[str, str],
                 conf: ConfigProxy | None = None, name: str = "mgr.x",
                 modules: list | None = None):
        from ceph_tpu_torch.services.mgr_modules import (
            Balancer,
            DeviceHealth,
            Insights,
            PGAutoscaler,
            Progress,
            SnapSchedule,
            Telemetry,
        )

        self.conf = conf or ConfigProxy()
        self.name = name
        self.msgr = Messenger(name, self.conf)
        self.msgr.set_policy("mon", Policy.lossy_client())
        self.msgr.set_policy("osd", Policy.lossy_client())
        self.msgr.set_dispatcher(self)
        self.monc = MonClient(name, monmap, self.conf, msgr=self.msgr)
        self._tid = 0
        self._futures: dict[int, asyncio.Future] = {}
        self.admin_socket = None
        if modules is None:
            from ceph_tpu_torch.services.mgr_perf import (
                IOStat,
                OSDPerfQuery,
                RBDSupport,
            )
            from ceph_tpu_torch.services.mgr_multisite import (
                MultisiteMonitor,
            )
            from ceph_tpu_torch.services.mgr_qos import QoSMonitor
            from ceph_tpu_torch.services.mgr_slo import SLOMonitor
            from ceph_tpu_torch.services.mgr_tsdb import TSDBMonitor
            from ceph_tpu_torch.services.orchestrator import Orchestrator

            pq = OSDPerfQuery(self)
            # QoSMonitor runs directly after SLOMonitor (insertion
            # order is dispatch order): each report cycle the defense
            # plane acts on the evaluation the SLO engine just made,
            # MultisiteMonitor follows so the replication-class
            # decision reaches the sync agents the same cycle, and
            # TSDBMonitor runs LAST so the retention layer records
            # what this cycle actually concluded
            modules = [Balancer(self), PGAutoscaler(self),
                       Progress(self), DeviceHealth(self),
                       Telemetry(self), Insights(self),
                       SnapSchedule(self), Orchestrator(self),
                       pq, RBDSupport(self, pq), IOStat(self),
                       SLOMonitor(self), QoSMonitor(self),
                       MultisiteMonitor(self), TSDBMonitor(self)]
        self.modules = {m.name: m for m in modules}
        # delta-encoded collect state: one decoder per OSD stream plus
        # counter-verified payload accounting (the cfg16 A/B and the
        # ts-smoke read these — bytes are measured, never estimated)
        self._delta_decoders: dict[int, object] = {}
        self.collect_stats = {
            "cycles": 0, "payload_bytes": 0, "last_payload_bytes": 0,
            "resyncs": 0, "delta": False,
        }
        self.last_digest: dict | None = None
        # flight recorder: the mgr's own ring (SLO eval transitions,
        # capture bookkeeping) + the bounded in-memory bundle index the
        # dashboard's /api/forensics serves
        self.journal = EventJournal(
            name, size=int(self.conf["event_journal_size"]))
        self._forensics: list[dict] = []
        self._forensics_seq = 0
        self._last_capture_mono = 0.0

    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        if msg.type == "perf_dump_reply":
            fut = self._futures.pop(int(msg.data.get("tid", 0)), None)
            if fut is not None and not fut.done():
                fut.set_result(msg.data.get("counters", {}))
            return
        if msg.type == "perf_dump_delta_reply":
            fut = self._futures.pop(int(msg.data.get("tid", 0)), None)
            if fut is not None and not fut.done():
                fut.set_result(dict(msg.data))
            return
        if msg.type == "pg_stats_reply":
            fut = self._futures.pop(int(msg.data.get("tid", 0)), None)
            if fut is not None and not fut.done():
                fut.set_result(msg.data.get("pgs", []))
            return
        if msg.type in ("perf_query_reply", "perf_query_dump_reply"):
            fut = self._futures.pop(int(msg.data.get("tid", 0)), None)
            if fut is not None and not fut.done():
                fut.set_result(dict(msg.data))
            return
        if msg.type == "dump_traces_reply":
            fut = self._futures.pop(int(msg.data.get("tid", 0)), None)
            if fut is not None and not fut.done():
                fut.set_result(msg.data.get("spans", []))
            return
        if msg.type == "forensics_capture_reply":
            fut = self._futures.pop(int(msg.data.get("tid", 0)), None)
            if fut is not None and not fut.done():
                fut.set_result(dict(msg.data))
            return
        if msg.type == "qos_set_reply":
            fut = self._futures.pop(int(msg.data.get("tid", 0)), None)
            if fut is not None and not fut.done():
                fut.set_result(dict(msg.data))
            return
        await self.monc.ms_dispatch(conn, msg)

    def ms_handle_reset(self, conn: Connection) -> None:
        self.monc.ms_handle_reset(conn)

    def ms_handle_connect(self, conn: Connection) -> None:
        pass

    async def start(self, timeout: float = 20.0) -> None:
        await self.monc.start(timeout)
        self.monc.sub_want("osdmap")
        self.monc.renew_subs()
        await self.monc.wait_for_map(1, timeout)
        run_dir = self.conf["admin_socket_dir"]
        if run_dir:
            from ceph_tpu_torch.common.admin_socket import AdminSocket

            sock = AdminSocket(self.name)
            sock.register("status", lambda: {
                "entity": self.name,
                "modules": sorted(self.modules),
                "osdmap_epoch": (self.monc.osdmap.epoch
                                 if self.monc.osdmap else 0),
            }, "mgr state")
            sock.register("config show", self.conf.show,
                          "live configuration")
            from ceph_tpu_torch.common.log import recent_lines
            sock.register("log dump", recent_lines,
                          "recent log ring (crash context)")
            sock.register("events dump", lambda: {
                "stats": self.journal.stats(),
                "events": self.journal.snapshot(),
            }, "flight-recorder event journal (full ring)")
            sock.register("forensics ls", self.forensics_index,
                          "forensic bundles captured this session")
            sock.register("ts query", self.ts_query,
                          "time-series query (name= or prefix=, "
                          "start/end/tier/max_points)")
            await sock.start(run_dir)
            self.admin_socket = sock

    async def shutdown(self) -> None:
        for mod in self.modules.values():
            stop = getattr(mod, "stop", None)
            if stop is not None:
                await stop()
        if self.admin_socket is not None:
            await self.admin_socket.stop()
            self.admin_socket = None
        dash = getattr(self, "dashboard", None)
        if dash is not None:
            await dash.stop()
            self.dashboard = None
        await self.monc.shutdown()
        await self.msgr.shutdown()

    # -- collection --------------------------------------------------------
    async def _poll_osd(self, osd: int, addr: str,
                        timeout: float = 3.0,
                        what: str = "perf_dump"):
        self._tid += 1
        tid = self._tid
        fut = asyncio.get_running_loop().create_future()
        self._futures[tid] = fut
        try:
            await self.msgr.send_to(
                addr, Message(what, {"tid": tid}), f"osd.{osd}"
            )
            return await asyncio.wait_for(fut, timeout)
        except (ConnectionError, asyncio.TimeoutError):
            self._futures.pop(tid, None)
            return None

    async def osd_request(self, osd: int, addr: str, mtype: str,
                          timeout: float = 3.0, **data):
        """One request/reply exchange with an OSD (dynamic perf query
        control + dump); None on timeout/unreachable."""
        self._tid += 1
        tid = self._tid
        fut = asyncio.get_running_loop().create_future()
        self._futures[tid] = fut
        try:
            await self.msgr.send_to(
                addr, Message(mtype, {"tid": tid, **data}),
                f"osd.{osd}"
            )
            return await asyncio.wait_for(fut, timeout)
        except (ConnectionError, asyncio.TimeoutError):
            self._futures.pop(tid, None)
            return None

    async def collect(self) -> dict:
        """One cluster snapshot: mon status + per-osd perf counters.

        With ``mgr_perf_collect_delta`` (the default) each OSD ships
        only counters changed since the epoch we acked — the decoded
        dumps are bit-identical to a full collect, but the wire
        payload is proportional to what MOVED, not to what exists
        (sublinear at the 1000-OSD scale ROADMAP item 1 targets).
        Payload bytes are counter-verified into ``collect_stats``
        either way, so the A/B is measured, never estimated."""
        from ceph_tpu_torch.common.perf_collect import (
            DeltaCollectDecoder,
            payload_bytes,
        )

        status = (await self.monc.command("status"))["data"]
        osdmap = self.monc.osdmap
        osd_perf: dict[int, dict] = {}
        delta = bool(self.conf["mgr_perf_collect_delta"])
        cycle_bytes = 0
        if osdmap is not None and delta:
            decs = self._delta_decoders
            polls = {
                osd: self.osd_request(
                    osd, info.addr, "perf_dump_delta",
                    ack_epoch=decs[osd].epoch
                    if osd in decs else 0)
                for osd, info in osdmap.osds.items() if info.up
            }
            # a decoder created before its first reply would ack a
            # stale 0 forever; create on reply instead
            results = await asyncio.gather(*polls.values())
            for osd, payload in zip(polls, results):
                if payload is None:
                    continue
                payload.pop("tid", None)
                cycle_bytes += payload_bytes(payload)
                dec = decs.get(osd)
                if dec is None:
                    dec = decs[osd] = DeltaCollectDecoder()
                if payload.get("full"):
                    self.collect_stats["resyncs"] += 1
                osd_perf[osd] = dec.decode(payload)
        elif osdmap is not None:
            polls = {
                osd: self._poll_osd(osd, info.addr)
                for osd, info in osdmap.osds.items() if info.up
            }
            results = await asyncio.gather(*polls.values())
            for osd, counters in zip(polls, results):
                if counters is not None:
                    cycle_bytes += payload_bytes(
                        {"counters": counters})
                    osd_perf[osd] = counters
        self.collect_stats["cycles"] += 1
        self.collect_stats["payload_bytes"] += cycle_bytes
        self.collect_stats["last_payload_bytes"] = cycle_bytes
        self.collect_stats["delta"] = delta
        return {
            "status": status,
            "osds": {
                osd: {"up": info.up, "in": info.in_cluster}
                for osd, info in (osdmap.osds.items() if osdmap else ())
            },
            "osd_perf": osd_perf,
        }

    def ts_query(self, name: str = "", start=None, end=None,
                 tier: str = "auto", prefix: str = "",
                 max_points=0) -> dict:
        """Time-series query against the retention module's store —
        the one entry point the dashboard ``/api/ts``, the ``ts
        query`` admin-socket command, and tests share.  With neither
        ``name`` nor ``prefix`` it returns the catalog."""
        ts = self.modules.get("ts")
        if ts is None:
            return {"error": "tsdb module not loaded"}
        return ts.query(
            name=str(name or ""),
            start=None if start is None else float(start),
            end=None if end is None else float(end),
            tier=str(tier or "auto"), prefix=str(prefix or ""),
            max_points=int(max_points or 0))

    async def collect_trace(self, trace_id: str) -> list[dict]:
        """Cluster-wide trace reassembly: fan ``dump_traces`` across
        every up OSD plus the mon's span ring, dedupe by span id, and
        assemble ONE parent-linked tree (the ``trace collect``
        backend and the dashboard's /api/trace payload)."""
        spans: list[dict] = []
        osdmap = self.monc.osdmap
        if osdmap is not None:
            polls = {
                osd: self.osd_request(osd, info.addr, "dump_traces",
                                      trace_id=trace_id)
                for osd, info in osdmap.osds.items() if info.up
            }
            for got in await asyncio.gather(*polls.values()):
                if got:
                    spans.extend(got)
        try:
            mon = await self.monc.command("dump_traces",
                                          trace_id=trace_id)
            spans.extend((mon.get("data") or {}).get("spans", []))
        except (ConnectionError, asyncio.TimeoutError, KeyError):
            pass
        seen: dict[str, dict] = {}
        for s in spans:
            seen.setdefault(str(s.get("span_id")), s)
        return assemble_tree(list(seen.values()))

    # -- forensics (flight-recorder capture) -------------------------------
    def forensics_dir(self) -> str:
        d = str(self.conf["forensics_dir"] or "")
        if not d:
            d = os.path.join(tempfile.gettempdir(),
                             "ceph_tpu_forensics")
        os.makedirs(d, exist_ok=True)
        return d

    def forensics_index(self) -> list[dict]:
        """Bundles captured this mgr session, newest last (the
        dashboard /api/forensics listing and ``forensics ls`` asok)."""
        return list(self._forensics)

    def forensics_bundle(self, bundle_id: str) -> dict | None:
        """Load one bundle back from disk by id (index entries carry
        the path, so this also works across mgr restarts when the
        caller knows the directory)."""
        for entry in self._forensics:
            if entry["id"] == bundle_id:
                try:
                    with open(entry["path"]) as f:
                        return json.load(f)
                except (OSError, ValueError):
                    return None
        return None

    async def forensics_capture(self, reason: str,
                                worst_daemon: str = "",
                                detail: dict | None = None) -> dict:
        """Fan a ``forensics_capture`` over every up daemon, snapshot
        the mon + mgr + process journals, merge one epoch-aligned
        timeline, and persist the JSON bundle.  Returns the index
        entry (id, path, worst_daemon, ...)."""
        window = float(self.conf["forensics_window_s"])
        daemons: dict[str, dict] = {}
        events: list[dict] = []
        osdmap = self.monc.osdmap
        if osdmap is not None:
            polls = {
                osd: self.osd_request(osd, info.addr,
                                      "forensics_capture",
                                      window_s=window)
                for osd, info in osdmap.osds.items() if info.up
            }
            got_all = await asyncio.gather(*polls.values())
            for osd, got in zip(polls, got_all):
                if got:
                    got.pop("tid", None)
                    daemons[f"osd.{osd}"] = got
                    events.extend(got.get("events", ()))
        try:
            mon = await self.monc.command("dump_events",
                                          window_s=window)
            md = mon.get("data") or {}
            if md.get("events") or md.get("stats"):
                daemons["mon"] = {"events": md.get("events", []),
                                  "journal": md.get("stats", {})}
                events.extend(md.get("events", ()))
        except (ConnectionError, asyncio.TimeoutError, KeyError):
            md = {}
        # process-global emitters (failpoints, chaos schedule, mesh
        # launches): prefer the mon's view, fall back to our own —
        # in this tree both see the same module-level ring
        proc_events = md.get("proc_events") \
            or proc_journal().snapshot(window)
        if proc_events:
            daemons["proc"] = {"events": proc_events}
            events.extend(proc_events)
        own = self.journal.snapshot(window)
        if own:
            daemons[self.name] = {"events": own}
            events.extend(own)
        timeline = merge_timeline(events)
        if not worst_daemon:
            worst_daemon = self._worst_from_bundle(daemons)
        # mgr-module state at capture time (the QoS controller's AIMD
        # position, pushed hedge timeouts, shed counts): a forensic
        # bundle must show what the defense plane was DOING when the
        # violation fired, not just what the daemons saw
        module_state: dict[str, dict] = {}
        for mname, mod in self.modules.items():
            hook = getattr(mod, "forensics_contrib", None)
            if hook is None:
                continue
            try:
                contrib = hook()
            except Exception:
                continue
            if contrib:
                module_state[mname] = contrib
        self._forensics_seq += 1
        bundle_id = (f"forensics-{int(time.time())}"
                     f"-{self._forensics_seq:03d}")
        bundle = {
            "id": bundle_id,
            "reason": reason,
            "captured_at": time.time(),
            "window_s": window,
            "worst_daemon": worst_daemon,
            "detail": detail or {},
            "daemons": daemons,
            "modules": module_state,
            "timeline": timeline,
        }
        path = os.path.join(self.forensics_dir(), f"{bundle_id}.json")
        try:
            with open(path, "w") as f:
                json.dump(bundle, f)
        except OSError:
            path = ""
        entry = {
            "id": bundle_id, "path": path, "reason": reason,
            "captured_at": bundle["captured_at"],
            "worst_daemon": worst_daemon,
            "events": len(timeline),
            "daemons": sorted(daemons),
        }
        self._forensics.append(entry)
        del self._forensics[:-64]        # bounded in-memory index
        self._last_capture_mono = time.monotonic()
        self.journal.emit("forensics.capture", reason=reason,
                          bundle=bundle_id,
                          worst_daemon=worst_daemon,
                          events=len(timeline))
        return dict(entry)

    @staticmethod
    def _worst_from_bundle(daemons: dict[str, dict]) -> str:
        """Fallback attribution when the trigger carried no payload:
        the daemon with the most slow ops in its captured ring, else
        the one with the deepest sampled queue."""
        worst, score = "", 0
        for name, d in daemons.items():
            slow = d.get("slow_ops") or {}
            n = int(slow.get("num_ops", 0) or 0)
            if n > score:
                worst, score = name, n
        return worst

    async def maybe_auto_capture(self, reason: str,
                                 worst_daemon: str = "",
                                 detail: dict | None = None
                                 ) -> dict | None:
        """Cooldown-gated capture for automatic triggers: a flapping
        health check must not storm bundles."""
        cd = float(self.conf["forensics_cooldown_s"])
        if (self._last_capture_mono
                and time.monotonic() - self._last_capture_mono < cd):
            return None
        try:
            return await self.forensics_capture(
                reason, worst_daemon=worst_daemon, detail=detail)
        except (ConnectionError, asyncio.TimeoutError):
            return None

    # -- PGMap digest (DaemonServer + PGMap aggregation) -------------------
    async def collect_pg_stats(self) -> dict[int, list[dict]]:
        """Poll every up OSD for per-PG stats (the MPGStats pull)."""
        osdmap = self.monc.osdmap
        if osdmap is None:
            return {}
        polls = {
            osd: self._poll_osd(osd, info.addr, what="pg_stats")
            for osd, info in osdmap.osds.items() if info.up
        }
        results = await asyncio.gather(*polls.values())
        return {osd: pgs for osd, pgs in zip(polls, results)
                if pgs is not None}

    async def build_digest(self) -> dict:
        """Fold per-OSD PG stats into the PGMap digest the monitor's
        MgrStatMonitor persists (reference src/mon/PGMap.cc summaries)."""
        per_osd = await self.collect_pg_stats()
        pgs_by_state: dict[str, int] = {}
        pools: dict[int, dict] = {}
        num_objects = num_bytes = degraded = misplaced = 0
        pool_names = {}
        osd_df: dict[int, dict] = {}
        osdmap = self.monc.osdmap
        if osdmap is not None:
            pool_names = {p.pool_id: p.name
                          for p in osdmap.pools.values()}
        seen: set[str] = set()
        for osd, pgs in sorted(per_osd.items()):
            osd_bytes = 0
            for st in pgs:
                osd_bytes += int(st.get("num_bytes", 0))
                pgid = str(st.get("pgid"))
                if pgid in seen:
                    continue          # one primary report per PG wins
                seen.add(pgid)
                state = str(st.get("state", "unknown"))
                pgs_by_state[state] = pgs_by_state.get(state, 0) + 1
                num_objects += int(st.get("num_objects", 0))
                num_bytes += int(st.get("num_bytes", 0))
                degraded += int(st.get("degraded", 0))
                misplaced += int(st.get("misplaced", 0))
                pid = int(st.get("pool", 0))
                p = pools.setdefault(pid, {
                    "name": pool_names.get(pid, str(pid)),
                    "num_pgs": 0, "num_objects": 0, "num_bytes": 0,
                    "degraded": 0, "misplaced": 0,
                })
                p["num_pgs"] += 1
                p["num_objects"] += int(st.get("num_objects", 0))
                p["num_bytes"] += int(st.get("num_bytes", 0))
                p["degraded"] += int(st.get("degraded", 0))
                p["misplaced"] += int(st.get("misplaced", 0))
            osd_df[osd] = {"bytes_used": osd_bytes}
        return {
            "pgs_by_state": pgs_by_state,
            "num_pgs": len(seen),
            "num_objects": num_objects,
            "num_bytes": num_bytes,
            "degraded_objects": degraded,
            "misplaced_objects": misplaced,
            "pools": pools,
            "osd_df": osd_df,
        }

    async def report(self) -> dict:
        """One aggregation + module + push cycle (MMonMgrReport).
        Two passes: serve + health first, so modules that OBSERVE the
        digest (telemetry) see health_checks populated."""
        digest = await self.build_digest()
        health: dict = {}
        for mod in self.modules.values():
            await mod.serve_once()
            health.update(mod.health_checks())
        if health:
            digest["health_checks"] = health
        for mod in self.modules.values():
            observe = getattr(mod, "observe_digest", None)
            if observe is not None:
                observe(digest)
            digest.update(mod.digest_contrib())
        self.last_digest = digest       # dashboard/metrics snapshot
        await self.monc.command("mgr report", digest=digest)
        return digest

    async def report_loop(self, interval: float = 1.0) -> None:
        """Periodic digest push; run as a task alongside the mgr."""
        while True:
            try:
                await self.report()
            except (ConnectionError, asyncio.TimeoutError, KeyError):
                pass
            await asyncio.sleep(interval)

    # -- prometheus exposition ---------------------------------------------
    def prometheus_extra(self) -> dict[str, dict]:
        """Gauge families contributed by modules (``prom_metrics``
        hook): the SLO burn rates + utilization rates ride the same
        scrape as the daemon counters."""
        extra: dict[str, dict] = {}
        for mod in self.modules.values():
            hook = getattr(mod, "prom_metrics", None)
            if hook is not None:
                extra.update(hook())
        return extra

    @staticmethod
    def prometheus_text(snapshot: dict,
                        extra: dict[str, dict] | None = None) -> str:
        """Render one snapshot in the text exposition format, with the
        metric names the reference prometheus module exports.
        ``extra`` appends module gauge families (name -> {"help",
        "type"?, "samples": [(labels, value)]}).  Label values are
        escaped per the exposition spec and ``# HELP``/``# TYPE``
        lines are emitted once per metric name even when several
        daemons (or an extra family) export the same series."""
        lines: list[str] = []
        described: set[str] = set()

        def metric(name: str, help_: str, samples: list[tuple[str, float]],
                   mtype: str = "gauge") -> None:
            if name not in described:
                described.add(name)
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {mtype}")
            for labels, value in samples:
                lines.append(f"{name}{labels} {value:g}")

        st = snapshot["status"]
        health = {"HEALTH_OK": 0, "HEALTH_WARN": 1, "HEALTH_ERR": 2}.get(
            st["health"]["status"], 2
        )
        metric("ceph_health_status", "cluster health (0=ok 1=warn 2=err)",
               [("", health)])
        om = st["osdmap"]
        metric("ceph_osd_stat", "osd counts by state", [
            ('{state="total"}', om["num_osds"]),
            ('{state="up"}', om["num_up_osds"]),
            ('{state="in"}', om["num_in_osds"]),
        ])
        metric("ceph_pool_count", "pools", [("", om["num_pools"])])
        metric("ceph_mon_quorum_count", "monitors in quorum",
               [("", len(st["mon"]["quorum"]))])
        up_samples = [
            (prom_label(ceph_daemon=f"osd.{osd}"),
             1.0 if info["up"] else 0.0)
            for osd, info in sorted(snapshot["osds"].items())
        ]
        if up_samples:
            metric("ceph_osd_up", "osd up state", up_samples)
        # per-osd counters, split by dump shape: scalars stay one
        # metric per key; (sum, avgcount) pairs export as *_sum /
        # *_count (NOT collapsed to the sum — the count is what turns
        # a total into a rate); log2 histograms export the full
        # prometheus histogram triplet *_bucket{le=...} (cumulative) /
        # *_sum / *_count per daemon, plus cluster-merged p50/p99
        # gauges (hist_merge across daemons, hist_quantile).
        scalars: dict[str, list[tuple[str, float]]] = {}
        pairs: dict[str, list[tuple[str, float, float]]] = {}
        hists: dict[str, list[tuple[str, dict]]] = {}
        merged: dict[str, dict] = {}
        for osd, counters in sorted(snapshot["osd_perf"].items()):
            lab = prom_label(ceph_daemon=f"osd.{osd}")
            for key, value in sorted(counters.items()):
                if isinstance(value, dict) and "buckets" in value:
                    hists.setdefault(key, []).append(
                        (f"osd.{osd}", value))
                    merged[key] = hist_merge(merged.get(key), value)
                elif isinstance(value, dict) and (
                        "sum" in value or "avgcount" in value):
                    pairs.setdefault(key, []).append(
                        (lab, float(value.get("sum", 0.0)),
                         float(value.get("avgcount", 0))))
                elif isinstance(value, dict):
                    # nested structured sections (ec_kernels) are not
                    # counters; they ride the digest, not the scrape
                    continue
                else:
                    scalars.setdefault(key, []).append(
                        (lab, float(value)))
        for key, samples in sorted(scalars.items()):
            metric(f"ceph_osd_{key}", f"osd {key} perf counter", samples,
                   mtype="counter")
        for key, entries in sorted(pairs.items()):
            metric(f"ceph_osd_{key}_sum", f"osd {key} total",
                   [(lab, s) for lab, s, _ in entries], mtype="counter")
            metric(f"ceph_osd_{key}_count", f"osd {key} samples",
                   [(lab, c) for lab, _, c in entries], mtype="counter")
        for key, entries in sorted(hists.items()):
            base = f"ceph_osd_{key}"
            if base not in described:
                described.add(base)
                lines.append(f"# HELP {base} osd {key} log2 histogram")
                lines.append(f"# TYPE {base} histogram")
            for daemon, h in entries:
                dlab = prom_escape(daemon)
                cum = 0
                for i, c in enumerate(h.get("buckets", ())):
                    cum += int(c)
                    le = bucket_le(i)
                    le_s = "+Inf" if math.isinf(le) else f"{le:g}"
                    lines.append(
                        f'{base}_bucket{{ceph_daemon="{dlab}",'
                        f'le="{le_s}"}} {cum:g}')
                lines.append(f'{base}_sum{{ceph_daemon="{dlab}"}} '
                             f'{float(h.get("sum", 0.0)):g}')
                lines.append(f'{base}_count{{ceph_daemon="{dlab}"}} '
                             f'{int(h.get("count", 0)):g}')
            m = merged[key]
            metric(f"{base}_quantile",
                   f"cluster-merged {key} quantiles",
                   [('{q="0.5"}', hist_quantile(m, 0.5) or 0.0),
                    ('{q="0.99"}', hist_quantile(m, 0.99) or 0.0)])
        for name, fam in sorted((extra or {}).items()):
            metric(name, str(fam.get("help", name)),
                   list(fam.get("samples", ())),
                   mtype=str(fam.get("type", "gauge")))
        return "\n".join(lines) + "\n"
