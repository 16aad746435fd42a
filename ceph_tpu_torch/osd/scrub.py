"""ScrubEngine: batched, cursor-resumable deep scrub at EC-kernel rates.

Third sibling of the repair engine (osd/repair.py) and the backfill
engine (osd/backfill.py): where repair drains *lost* shards and backfill
drains *planned motion*, scrub drains *doubt*.  A PG's object set is
swept in cursor-resumable chunks; each chunk is verified by the EC
backend's batched deep scrub (``ECBackend.scrub_batch``) — shard streams
grouped by length, re-encoded in ONE coalesced launch per group, parity
compared ON DEVICE with the per-shard CRC32C in the same verify step
(ec/checksum.py).  The host sees a per-object verdict dict, never the
shard bytes.

Pacing and survivability follow the established house rules:

* scrub is a first-class mClock class (``osd_mclock_scrub_*``) and an
  AIMD position in the QoS controller — the sweep acquires the scrub
  class at batch cost, and mgr_qos retunes its reservation/limit each
  report cycle exactly like recovery and backfill;
* the sweep PAUSES (between batches) while the cluster is burning SLO —
  the daemon wires the qos_set burning flag to :meth:`pause` /
  :meth:`resume` — and resumes where the cursor left off;
* the cursor persists as a PG-meta attr (``scrub_cursor``) through the
  same transaction path as the backfill cursor, so an OSD restart
  mid-sweep resumes after the last verified chunk instead of
  re-scrubbing from the top;
* shards the verify pass convicts (crc mismatch, stale version, missing
  outright) route straight into ``RepairScheduler.drain`` as the scrub
  class; demoted singles fall back to the caller's per-object repair.

Port copy of ceph_tpu/osd/scrub.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.common.perf import CounterType, PerfCounters
from ceph_tpu_torch.osd import pg_log
from ceph_tpu_torch.store.object_store import Transaction

SCRUB_COUNTERS = (
    "ec_scrub_objects",          # objects whose shard sets were verified
    "ec_scrub_batches",          # batched verify groups launched
    "ec_scrub_launches",         # device launches issued by scrub verify
    "ec_scrub_bytes",            # shard-stream bytes verified
    "ec_scrub_errors",           # shards convicted (parity/crc/stale/missing)
    "ec_scrub_repaired",         # convicted objects healed via repair
    "ec_scrub_cursor_resumes",   # sweeps resumed from a persisted cursor
    "ec_scrub_preempts",         # sweeps paused by the SLO/QoS gate
)

# Persisted on the PG's meta object, next to the backfill cursor.
CURSOR_ATTR = "scrub_cursor"


def register_scrub_counters(perf: PerfCounters) -> None:
    """Idempotent: the backend and the engine both register (whichever
    constructs first wins; repeated add() of an existing key is a
    no-op)."""
    for key in SCRUB_COUNTERS:
        perf.add(key, CounterType.U64)


def cursor_load(store, pool: int, ps: int) -> dict | None:
    try:
        raw = store.getattr(pg_log.meta_cid(pool, ps),
                            pg_log.meta_oid(pool), CURSOR_ATTR)
        return json.loads(raw.decode())
    except Exception:                            # noqa: BLE001
        return None


async def cursor_save(store, pool: int, ps: int, epoch: int, pos: str,
                      scanned: int) -> None:
    tx = Transaction()
    tx.setattr(pg_log.meta_cid(pool, ps), pg_log.meta_oid(pool),
               CURSOR_ATTR,
               json.dumps({"epoch": int(epoch), "pos": pos,
                           "scanned": int(scanned)}).encode())
    await store.queue_transactions(tx)


async def cursor_clear(store, pool: int, ps: int) -> None:
    tx = Transaction()
    tx.setattr(pg_log.meta_cid(pool, ps), pg_log.meta_oid(pool),
               CURSOR_ATTR, b"")
    await store.queue_transactions(tx)


class ScrubEngine:
    """Sweeps PGs through the backend's batched deep scrub, routing
    convictions into the batched repair drain.

    Shared daemon-wide like the repair/backfill engines: one instance
    per OSD, handed the daemon's RepairScheduler (for convicted-shard
    drains), perf counters, store (cursor persistence) and journal.
    """

    def __init__(self, repair, perf: PerfCounters, store=None,
                 journal=None, op_scheduler=None,
                 use_mclock: bool = False):
        register_scrub_counters(perf)
        self.repair = repair
        self.perf = perf
        self.store = store
        self.journal = journal
        self.op_scheduler = op_scheduler
        self.use_mclock = bool(use_mclock)
        # pause gate: a set of reasons so independent actuators (SLO
        # burn, admin) can overlap without clobbering each other
        self._pause_reasons: set[str] = set()
        # lifetime engine stats (the asok `ec scrub stats` payload)
        self.sweeps = 0
        self.objects = 0
        self.errors = 0
        self.repaired = 0
        self.resumes = 0
        self.preempts = 0

    # -- SLO / admin gate -------------------------------------------------
    @property
    def paused(self) -> bool:
        return bool(self._pause_reasons)

    def pause(self, reason: str = "slo") -> None:
        """Raise a pause reason; an in-flight sweep stops dispatching
        new batches (the cursor keeps its place)."""
        if reason not in self._pause_reasons:
            self._pause_reasons.add(reason)
            if self.journal is not None:
                self.journal.emit("scrub.preempt", action="pause",
                                  reason=reason)

    def resume(self, reason: str = "slo") -> None:
        if reason in self._pause_reasons:
            self._pause_reasons.discard(reason)
            if self.journal is not None:
                self.journal.emit("scrub.preempt", action="resume",
                                  reason=reason)

    async def _gate(self) -> None:
        """Block between batches while paused.  Counts ONE preempt per
        pause episode, not per poll."""
        if not self.paused:
            return
        self.preempts += 1
        self.perf.inc("ec_scrub_preempts")
        while self.paused:
            await asyncio.sleep(0.25)

    def stats(self) -> dict:
        return {
            "sweeps": self.sweeps,
            "objects": self.objects,
            "errors": self.errors,
            "repaired": self.repaired,
            "resumes": self.resumes,
            "preempts": self.preempts,
            "paused": sorted(self._pause_reasons),
            "counters": {k: self.perf.value(k) for k in SCRUB_COUNTERS},
        }

    # -- conviction -------------------------------------------------------
    @staticmethod
    def convict(rep: dict) -> tuple[list[int], str | None]:
        """Name the shards to rebuild from a scrub report.

        Mirrors the per-object attribution in the daemon: shards with a
        crc mismatch, a stale version, or missing outright are convicted
        directly; a bare parity inconsistency convicts the disagreeing
        parity shards only when hinfo can vouch for the data shards.
        Returns (shards, error): with no attribution the error string
        says why repair was refused (rebuilding from unverified data
        shards would launder the corruption into the parity)."""
        culprits = sorted(set(rep.get("crc_mismatch", ()))
                          | set(rep.get("stale_version", ()))
                          | set(rep.get("missing_shards", ())))
        if culprits:
            return culprits, None
        if rep.get("hinfo") and rep.get("parity_inconsistent"):
            return sorted(rep["parity_inconsistent"]), None
        return [], ("unattributable without per-shard crcs (hinfo)"
                    if rep.get("parity_inconsistent") else None)

    # -- the sweep --------------------------------------------------------
    async def sweep_pg(self, backend, names, *, epoch: int = 0,
                       pool: int = 0, ps: int = 0,
                       batch_objects: int | None = None,
                       repair: bool = True,
                       repair_fallback=None) -> dict:
        """Deep-scrub ``names`` through ``backend.scrub_batch``.

        Returns a report in the ``pg_scrub`` wire shape: ``{"objects",
        "errors", "repaired", "inconsistent": [detail, ...]}``.
        ``repair_fallback(name, shards) -> bool`` handles convictions
        the batched drain demoted (single-object groups, engine
        failures); without one they stay flagged for the next sweep.
        """
        names = sorted(names)
        step = max(1, int(batch_objects
                          or self.repair.max_batch_objects))
        scanned = 0
        cur = cursor_load(self.store, pool, ps) \
            if self.store is not None else None
        if cur and int(cur.get("epoch", -1)) == int(epoch):
            pos = str(cur.get("pos", ""))
            names = [n for n in names if n > pos]
            scanned = int(cur.get("scanned", 0))
            self.resumes += 1
            self.perf.inc("ec_scrub_cursor_resumes")
            if self.journal is not None:
                self.journal.emit("scrub.cursor", action="resume",
                                  epoch=int(epoch), pos=pos,
                                  remaining=len(names))
        details: list[dict] = []
        repaired = 0
        for i in range(0, len(names), step):
            chunk = names[i:i + step]
            await self._gate()
            if self.use_mclock and self.op_scheduler is not None:
                await self.op_scheduler.acquire("scrub",
                                                cost=len(chunk))
            res = await backend.scrub_batch(chunk)
            reports = res.get("reports", {})
            scanned += len(chunk)
            rebuild: dict[str, list[int]] = {}
            versions: dict[str, int] = {}
            flagged_shards = 0
            for name in sorted(reports):
                rep = reports[name]
                if rep is None or rep.get("clean"):
                    continue
                detail = dict(rep)
                shards, err = self.convict(rep)
                if shards:
                    rebuild[name] = shards
                    if rep.get("version") is not None:
                        versions[name] = int(rep["version"])
                elif err:
                    detail["repair_error"] = err
                flagged_shards += (len(shards)
                                   or len(rep.get(
                                       "parity_inconsistent", ())))
                details.append(detail)
            if flagged_shards:
                self.errors += len(rebuild)
                self.perf.inc("ec_scrub_errors", flagged_shards)
                if self.journal is not None:
                    self.journal.emit(
                        "scrub.convict", objects=len(rebuild),
                        shards=flagged_shards,
                        unattributable=(len(details) and not rebuild))
            if repair and rebuild:
                done = await self.repair.drain(
                    backend, rebuild, versions, clazz="scrub")
                for name in sorted(set(rebuild) - done):
                    if repair_fallback is None:
                        continue
                    try:
                        if await repair_fallback(name, rebuild[name]):
                            done.add(name)
                    except Exception:            # noqa: BLE001
                        pass
                # re-verify what repair claims it healed: "repaired"
                # means a second verify pass came back clean, not that
                # the drain returned
                if done:
                    recheck = await backend.scrub_batch(sorted(done))
                    for name, rep in recheck.get("reports",
                                                 {}).items():
                        if rep is not None and rep.get("clean"):
                            repaired += 1
                            self.perf.inc("ec_scrub_repaired")
                            for d in details:
                                if d.get("object") == name:
                                    d["repaired"] = True
            if self.store is not None and chunk:
                await cursor_save(self.store, pool, ps, epoch,
                                  chunk[-1], scanned)
        if self.store is not None:
            await cursor_clear(self.store, pool, ps)
        self.sweeps += 1
        self.objects += scanned
        if self.journal is not None:
            self.journal.emit("scrub.done", epoch=int(epoch),
                              objects=scanned, errors=len(details),
                              repaired=repaired)
        return {
            "objects": scanned,
            "errors": len(details),
            "repaired": repaired,
            "inconsistent": details,
        }
