"""Mgr perf/maintenance modules: osd_perf_query, rbd_support, iostat.

Counterpart of ceph_tpu/services/mgr_perf.py: the same module over the
port's imports.

Reference counterparts:
- ``osd_perf_query`` (src/pybind/mgr/osd_perf_query/module.py:23):
  dynamic OSD perf queries — ``osd perf query add`` installs a grouped
  counter collector on every up OSD, ``osd perf counters get`` reads
  the merged results.
- ``rbd_support`` (src/pybind/mgr/rbd_support/module.py:14-16,148):
  trash purge schedules (cron-like deferred-trash reaping per pool)
  and ``rbd perf image iostat`` — per-image IO rates, fed by an
  rbd_image-grouped OSD perf query.
- ``iostat`` (src/pybind/mgr/iostat): whole-cluster IO rates derived
  from successive perf-counter samples.

Command plumbing follows the orchestrator module's contract: the
monitor stages specs in the config-key store (mon/mgr_stat.py command
handlers), these modules act on them each serve cycle, and results ride
the digest back to the monitor, where the CLI reads them.
"""

from __future__ import annotations

import json
import time

from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.services.mgr_modules import MgrModule

log = Dout("mgr")

PQ_SPEC_PREFIX = "mgr/osd_perf_query/"       # config-key: qid -> spec
TRASH_SCHED_PREFIX = "mgr/rbd_support/trash_sched/"   # pool -> spec
RBD_IOSTAT_QID = 1_000_000   # reserved query id for rbd image iostat


class OSDPerfQuery(MgrModule):
    """Dynamic perf queries over every up OSD."""

    name = "osd_perf_query"

    def __init__(self, mgr):
        super().__init__(mgr)
        self._installed: dict[int, dict] = {}   # qid -> spec
        self._results: dict[int, dict] = {}     # qid -> merged counters

    async def _kv(self, prefix_cmd: str, **kw):
        return await self.mgr.monc.command(prefix_cmd, **kw)

    async def _specs(self) -> dict[int, dict]:
        r = await self._kv("config-key ls")
        specs: dict[int, dict] = {}
        for key in r.get("data", []):
            if not key.startswith(PQ_SPEC_PREFIX):
                continue
            g = await self._kv("config-key get", key=key)
            if g.get("rc"):
                continue
            try:
                specs[int(key[len(PQ_SPEC_PREFIX):])] = \
                    json.loads(g["data"])
            except ValueError:
                continue
        return specs

    async def _broadcast(self, mtype: str, **data) -> dict[int, dict]:
        """Send one control/dump message to every up OSD; returns
        osd -> reply data."""
        import asyncio

        osdmap = self.mgr.monc.osdmap
        if osdmap is None:
            return {}
        polls = {
            osd: self.mgr.osd_request(osd, info.addr, mtype, **data)
            for osd, info in osdmap.osds.items() if info.up
        }
        results = await asyncio.gather(*polls.values())
        return {osd: r for osd, r in zip(polls, results)
                if r is not None}

    async def install(self, qid: int, spec: dict) -> None:
        await self._broadcast("perf_query_add", qid=qid, spec=spec)
        self._installed[qid] = spec

    async def remove(self, qid: int) -> None:
        await self._broadcast("perf_query_rm", qid=qid)
        self._installed.pop(qid, None)
        self._results.pop(qid, None)

    async def dump(self, qid: int) -> dict:
        """Merged {group key -> counters} across OSDs."""
        merged: dict[str, dict] = {}
        for reply in (await self._broadcast("perf_query_dump",
                                            qid=qid)).values():
            for key, c in reply.get("counters", {}).items():
                m = merged.setdefault(key, {
                    "ops": 0, "read_ops": 0, "write_ops": 0,
                    "bytes_in": 0, "bytes_out": 0, "lat_sum": 0.0,
                })
                for k in m:
                    m[k] += c.get(k, 0)
        return merged

    async def serve_once(self) -> None:
        want = await self._specs()
        # qids >= RBD_IOSTAT_QID are module-owned (rbd_support), not
        # config-key driven: reconciliation must not uninstall them
        for qid in [q for q in self._installed
                    if q not in want and q < RBD_IOSTAT_QID]:
            await self.remove(qid)
        for qid, spec in want.items():
            if self._installed.get(qid) != spec:
                await self.install(qid, spec)
        for qid in [q for q in self._installed if q < RBD_IOSTAT_QID]:
            self._results[qid] = await self.dump(qid)

    def digest_contrib(self) -> dict:
        return {"osd_perf_query": {
            str(qid): {"spec": self._installed.get(qid, {}),
                       "counters": self._results.get(qid, {})}
            for qid in self._installed
        }}


class RBDSupport(MgrModule):
    """Trash purge schedules + per-image IO stats."""

    name = "rbd_support"

    def __init__(self, mgr, pq: OSDPerfQuery):
        super().__init__(mgr)
        self.pq = pq
        self._rados = None
        self._last_run: dict[str, float] = {}
        self._sched_status: dict[str, dict] = {}
        self._iostat: dict[str, dict] = {}
        self._iostat_prev: dict[str, dict] = {}
        self._iostat_t = 0.0
        self._iostat_installed = False

    async def _client(self):
        from ceph_tpu_torch.client.rados import Rados

        if self._rados is None:
            self._rados = Rados(self.mgr.monc.monmap, self.mgr.conf,
                                name=self.mgr.name)
            await self._rados.connect(timeout=10.0)
        return self._rados

    async def stop(self) -> None:
        if self._rados is not None:
            await self._rados.shutdown()
            self._rados = None

    async def _schedules(self) -> dict[str, dict]:
        r = await self.mgr.monc.command("config-key ls")
        out: dict[str, dict] = {}
        for key in r.get("data", []):
            if not key.startswith(TRASH_SCHED_PREFIX):
                continue
            g = await self.mgr.monc.command("config-key get", key=key)
            if g.get("rc"):
                continue
            try:
                out[key[len(TRASH_SCHED_PREFIX):]] = \
                    json.loads(g["data"])
            except ValueError:
                continue
        return out

    async def _purge_pool(self, pool: str) -> int:
        """Reap every trash entry whose deferment expired (rbd trash
        purge semantics)."""
        from ceph_tpu_torch.services.rbd import RBD, RBDError

        rados = await self._client()
        io = await rados.open_ioctx(pool)
        rbd = RBD(io)
        purged = 0
        now = time.time()
        for entry in await rbd.trash_list():
            if float(entry.get("deferment_end", 0)) > now:
                continue
            try:
                await rbd.trash_remove(entry["id"])
                purged += 1
            except RBDError as e:
                log.dout(5, "trash purge of %s/%s declined: %s",
                         pool, entry["id"], e)
        return purged

    async def _serve_schedules(self) -> None:
        scheds = await self._schedules()
        self._sched_status = {
            p: dict(s) for p, s in self._sched_status.items()
            if p in scheds
        }
        now = time.time()
        for pool, spec in scheds.items():
            interval = float(spec.get("interval", 900))
            last = self._last_run.get(pool, 0.0)
            if now - last < interval:
                continue
            self._last_run[pool] = now
            try:
                purged = await self._purge_pool(pool)
            except (IOError, ConnectionError) as e:
                self._sched_status[pool] = {
                    "interval": interval, "error": str(e),
                    "last_run": now,
                }
                continue
            st = self._sched_status.setdefault(pool, {
                "interval": interval, "purged_total": 0,
            })
            st["interval"] = interval
            st["last_run"] = now
            st["last_purged"] = purged
            st["purged_total"] = st.get("purged_total", 0) + purged

    async def _serve_iostat(self) -> None:
        """Per-image rates from the rbd_image-grouped OSD perf query
        (rbd perf image iostat)."""
        if not self._iostat_installed:
            await self.pq.install(RBD_IOSTAT_QID,
                                  {"type": "rbd_image"})
            self._iostat_installed = True
            self._iostat_t = time.time()
            return
        cur = await self.pq.dump(RBD_IOSTAT_QID)
        now = time.time()
        dt = max(now - self._iostat_t, 1e-6)
        out: dict[str, dict] = {}
        for image, c in cur.items():
            prev = self._iostat_prev.get(image, {})
            dops = c["ops"] - prev.get("ops", 0)
            out[image] = {
                "ops": c["ops"],
                "ops_per_sec": round(dops / dt, 3),
                "read_ops_per_sec": round(
                    (c["read_ops"] - prev.get("read_ops", 0)) / dt, 3),
                "write_ops_per_sec": round(
                    (c["write_ops"] - prev.get("write_ops", 0)) / dt,
                    3),
                "wr_bytes_per_sec": round(
                    (c["bytes_in"] - prev.get("bytes_in", 0)) / dt, 3),
                "rd_bytes_per_sec": round(
                    (c["bytes_out"] - prev.get("bytes_out", 0)) / dt,
                    3),
                "avg_lat_ms": round(
                    (c["lat_sum"] - prev.get("lat_sum", 0.0))
                    / max(dops, 1) * 1e3, 3),
            }
        self._iostat_prev = cur
        self._iostat_t = now
        self._iostat = out

    async def serve_once(self) -> None:
        await self._serve_schedules()
        await self._serve_iostat()

    def digest_contrib(self) -> dict:
        return {"rbd_support": {
            "trash_schedules": self._sched_status,
            "image_iostat": self._iostat,
        }}


class IOStat(MgrModule):
    """Cluster-wide IO rates from successive OSD perf samples."""

    name = "iostat"

    def __init__(self, mgr):
        super().__init__(mgr)
        self._prev: dict | None = None
        self._prev_t = 0.0
        self._rates = {"ops_per_sec": 0.0, "rd_bytes_per_sec": 0.0,
                       "wr_bytes_per_sec": 0.0}

    async def serve_once(self) -> None:
        snap = await self.mgr.collect()
        totals = {"op": 0, "op_in_bytes": 0, "op_out_bytes": 0}
        for counters in snap["osd_perf"].values():
            for k in totals:
                v = counters.get(k, 0)
                totals[k] += (v.get("sum", 0)
                              if isinstance(v, dict) else v)
        now = time.time()
        if self._prev is not None:
            dt = max(now - self._prev_t, 1e-6)
            self._rates = {
                "ops_per_sec": round(
                    (totals["op"] - self._prev["op"]) / dt, 3),
                "wr_bytes_per_sec": round(
                    (totals["op_in_bytes"]
                     - self._prev["op_in_bytes"]) / dt, 3),
                "rd_bytes_per_sec": round(
                    (totals["op_out_bytes"]
                     - self._prev["op_out_bytes"]) / dt, 3),
            }
        self._prev = totals
        self._prev_t = now

    def digest_contrib(self) -> dict:
        return {"iostat": dict(self._rates)}
