"""Backfill engine: the planned-motion twin of the RepairScheduler.

Counterpart of ceph_tpu/osd/backfill.py: the same module over the
port's imports.

Failure repair (osd/repair.py) drains *lost* data; this module drains
*moved* data — the object motion a topology change creates when an
OSDMap epoch remaps PGs (expansion, reweight, drain, ``osd out``).
The moved set comes straight from ``PoolTables.diff`` (the epoch-cached
placement tables already compute exactly which PGs' up/acting changed);
everything here turns that diff into paced, cancellable, resumable
motion:

- :func:`plan_motion` groups the remapped PGs of one epoch transition
  by (codec signature, destination set) — the same grouping key the
  repair engine uses for decode-matrix sharing, extended with the
  motion target so one ``backfill.plan`` journal entry describes the
  whole storm;
- :class:`BackfillSlots` is the per-OSD reservation table
  (``osd_max_backfills``): a PG's motion starts only once the primary
  holds a local slot AND a remote slot on every backfill target —
  local and remote are SEPARATE pools (the reference's local_reserver /
  remote_reserver split), which kills the hold-and-wait deadlock two
  mutually-backfilling primaries would otherwise build;
- :class:`BackfillEngine` drains one PG's rebuild map through the
  ``RepairScheduler`` batched machinery — one coalesced device launch
  per group, not one per object — paced as the mClock ``backfill``
  class (its own AIMD position in the QoS plane, distinct from
  recovery), checkpointing a persisted cursor after every batch so
  motion interrupted by preemption, a newer epoch, or a daemon restart
  resumes where it stopped instead of re-moving objects.

Accounting: ``backfill_*`` perf counters, ``backfill.*`` EventJournal
entries (plan / reserve / drain / cursor / done / gated / preempt), and
a ``backfill stats`` wire/asok surface on the daemon.
"""

from __future__ import annotations

import asyncio
import json
from collections import deque

from ceph_tpu_torch.common.perf import CounterType, PerfCounters
from ceph_tpu_torch.osd import pg_log
from ceph_tpu_torch.store import Transaction

BACKFILL_COUNTERS = (
    "backfill_batches",          # batched launches issued for motion
    "backfill_objects",          # objects moved through the engine
    "backfill_bytes",            # shard bytes written to destinations
    "backfill_reserve_waits",    # reservation attempts that had to wait
    "backfill_preempts",         # drains cancelled by a newer epoch
    "backfill_cursor_resumes",   # drains resumed from a persisted cursor
    "backfill_cursor_skipped",   # objects skipped as already moved
    "backfill_gated",            # motion paused by norebalance
)

CURSOR_ATTR = "backfill_cursor"


def register_backfill_counters(perf: PerfCounters) -> None:
    """Idempotently register the backfill counter set on ``perf``."""
    for key in BACKFILL_COUNTERS:
        perf.add(key, CounterType.U64)


def plan_motion(moved: dict, sig_of=None, dests_of=None) -> dict:
    """Group one epoch transition's remapped PGs for the motion plan.

    ``moved`` maps pool_id -> {ps: (old_up, new_up)} (the PoolTables
    diff plus the rows it named); ``sig_of(pool_id)`` returns a codec
    signature (any hashable; defaults to the pool id) and
    ``dests_of(old_up, new_up)`` the motion destinations (defaults to
    the member-set difference).  Returns::

        {"moved_pgs": N,
         "groups": [{"sig": ..., "dests": [...], "pgs": [[pool, ps]..]},
                    ...]}   # deterministic order

    One group = PGs that share a codec AND a destination set — their
    motion shares decode matrices and lands on the same daemons, so
    they drain back-to-back for launch coalescing and cache locality.
    """
    groups: dict[tuple, list] = {}
    total = 0
    for pool_id in sorted(moved):
        sig = sig_of(pool_id) if sig_of is not None else pool_id
        for ps in sorted(moved[pool_id]):
            old_up, new_up = moved[pool_id][ps]
            if dests_of is not None:
                dests = tuple(sorted(dests_of(old_up, new_up)))
            else:
                dests = tuple(sorted(
                    set(o for o in new_up if o >= 0)
                    - set(o for o in old_up if o >= 0)))
            total += 1
            groups.setdefault((repr(sig), dests), []).append(
                [pool_id, ps])
    return {
        "moved_pgs": total,
        "groups": [{"sig": sig, "dests": list(dests), "pgs": pgs}
                   for (sig, dests), pgs in sorted(groups.items())],
    }


class BackfillSlots:
    """One reservation pool: ``osd_max_backfills`` concurrent grants,
    FIFO-queued waiters, epoch-tagged holders.

    Each daemon owns TWO instances — local (PGs this daemon primaries)
    and remote (PGs backfilling INTO this daemon) — mirroring the
    reference's AsyncReserver pair.  ``reserve`` parks the caller until
    a slot frees; cancelling the waiting task (how re-peering tears a
    drain down) removes the waiter cleanly.  A re-reserve by the same
    key adopts the new epoch without consuming a second slot."""

    def __init__(self, max_slots: int = 1):
        self.max_slots = max(1, int(max_slots))
        self._active: dict[str, int] = {}        # key -> epoch
        self._waiters: deque = deque()           # (key, epoch, fut)

    def resize(self, max_slots: int) -> None:
        self.max_slots = max(1, int(max_slots))
        self._pump()

    def _pump(self) -> None:
        while self._waiters and len(self._active) < self.max_slots:
            key, epoch, fut = self._waiters.popleft()
            if fut.done():
                continue
            self._active[key] = epoch
            fut.set_result(True)

    def try_reserve(self, key: str, epoch: int = 0) -> bool:
        """Non-blocking grant attempt (the wire-served remote path)."""
        if key in self._active:
            self._active[key] = max(self._active[key], int(epoch))
            return True
        if len(self._active) < self.max_slots:
            self._active[key] = int(epoch)
            return True
        return False

    async def reserve(self, key: str, epoch: int = 0) -> bool:
        """Acquire a slot, queuing FIFO behind current holders.
        Returns True when the caller WAITED for the grant (slot
        exhaustion), False when it was granted immediately."""
        if self.try_reserve(key, epoch):
            return False
        fut = asyncio.get_running_loop().create_future()
        entry = (key, int(epoch), fut)
        self._waiters.append(entry)
        try:
            await fut
        except asyncio.CancelledError:
            if entry in self._waiters:
                self._waiters.remove(entry)
            elif self._active.get(key) == int(epoch):
                # granted between set_result and resumption: give back
                self.release(key)
            raise
        return True

    def release(self, key: str) -> None:
        if self._active.pop(key, None) is not None:
            self._pump()

    def preempt_stale(self, key: str, newer_epoch: int) -> bool:
        """Cancel a holder/waiter whose grant predates ``newer_epoch``
        (re-peering or a newer map invalidated its motion)."""
        held = self._active.get(key)
        if held is not None and held < int(newer_epoch):
            self.release(key)
            return True
        for entry in list(self._waiters):
            if entry[0] == key and entry[1] < int(newer_epoch):
                self._waiters.remove(entry)
                if not entry[2].done():
                    entry[2].cancel()
                return True
        return False

    def stats(self) -> dict:
        return {"max": self.max_slots,
                "active": {k: e for k, e in sorted(self._active.items())},
                "queued": len(self._waiters)}


# -- cursor persistence ----------------------------------------------------
# The cursor lives as an attr on the PG's pgmeta object (same meta
# collection as the PG log), written in its own transaction after each
# drained batch: {"epoch": interval epoch, "pos": last object name
# fully moved in sorted order, "moved": objects moved so far}.  A
# cursor from a DIFFERENT interval epoch is stale — the moved set it
# checkpointed no longer describes this interval's motion — and is
# ignored (then overwritten).

def cursor_load(store, pool: int, ps: int) -> dict | None:
    try:
        raw = store.getattr(pg_log.meta_cid(pool, ps),
                            pg_log.meta_oid(pool), CURSOR_ATTR)
        return json.loads(raw.decode())
    except Exception:
        return None


async def cursor_save(store, pool: int, ps: int, epoch: int,
                      pos: str, moved: int) -> None:
    tx = Transaction()
    tx.setattr(pg_log.meta_cid(pool, ps), pg_log.meta_oid(pool),
               CURSOR_ATTR,
               json.dumps({"epoch": int(epoch), "pos": pos,
                           "moved": int(moved)}).encode())
    await store.queue_transactions(tx)


async def cursor_clear(store, pool: int, ps: int) -> None:
    tx = Transaction()
    tx.setattr(pg_log.meta_cid(pool, ps), pg_log.meta_oid(pool),
               CURSOR_ATTR, b"")
    await store.queue_transactions(tx)


class BackfillPreempted(Exception):
    """A newer epoch invalidated this drain mid-flight; the cursor has
    already checkpointed everything moved so far."""


class BackfillEngine:
    """Per-OSD planned-motion drain: cursor-checkpointed batches through
    the shared :class:`RepairScheduler`, paced as mClock ``backfill``."""

    def __init__(self, repair, perf: PerfCounters, store=None,
                 journal=None):
        register_backfill_counters(perf)
        self.repair = repair
        self.perf = perf
        self.store = store
        self.journal = journal
        # lifetime stats (the `backfill stats` asok/wire payload)
        self.drains = 0
        self.objects = 0
        self.batches = 0
        self.preempts = 0
        self.resumes = 0

    def stats(self) -> dict:
        return {
            "drains": self.drains,
            "objects": self.objects,
            "batches": self.batches,
            "preempts": self.preempts,
            "resumes": self.resumes,
            "moved_bytes": self.perf.value("backfill_bytes"),
            "cursor_skipped": self.perf.value("backfill_cursor_skipped"),
        }

    async def drain_pg(self, backend, rebuild: dict, *, pool: int,
                       ps: int, epoch: int,
                       versions: dict | None = None,
                       current_epoch=None, gate=None) -> set[str]:
        """Drain one PG's motion map (oid -> destination shards).

        Objects move in sorted-name order, ``repair.max_batch_objects``
        per checkpoint; after each batch the cursor persists, so a
        second call for the SAME interval epoch resumes past everything
        already moved (counter ``backfill_cursor_skipped`` proves no
        object moves twice).  ``current_epoch()`` is polled between
        batches — when it outruns ``epoch`` the drain raises
        :class:`BackfillPreempted` (re-peering will replan against the
        new map).  ``gate()`` returning True (norebalance set mid-
        motion) pauses the drain between batches until it clears or a
        newer epoch preempts.  Returns the names moved by THIS call;
        names absent
        from the union of returned+skipped were demoted to the
        per-object path."""
        versions = versions or {}
        names = sorted(rebuild)
        cur = (cursor_load(self.store, pool, ps)
               if self.store is not None else None)
        if cur and int(cur.get("epoch", -1)) == int(epoch):
            pos = str(cur.get("pos", ""))
            skip = [n for n in names if n <= pos]
            if skip:
                names = [n for n in names if n > pos]
                self.resumes += 1
                self.perf.inc("backfill_cursor_resumes")
                self.perf.inc("backfill_cursor_skipped", len(skip))
                if self.journal is not None:
                    self.journal.emit(
                        "backfill.cursor", epoch=int(epoch),
                        pool=pool, ps=ps, action="resume", pos=pos,
                        skipped=len(skip))
        moved_before = (int(cur.get("moved", 0))
                        if cur and int(cur.get("epoch", -1)) == int(epoch)
                        else 0)
        self.drains += 1
        recovered: set[str] = set()
        step = self.repair.max_batch_objects
        for i in range(0, len(names), step):
            gated = False
            while True:
                if current_epoch is not None \
                        and current_epoch() != epoch:
                    self.preempts += 1
                    self.perf.inc("backfill_preempts")
                    if self.journal is not None:
                        self.journal.emit(
                            "backfill.preempt", epoch=int(epoch),
                            pool=pool, ps=ps,
                            newer_epoch=int(current_epoch()),
                            moved=len(recovered))
                    raise BackfillPreempted(
                        f"pg {pool}.{ps:x} epoch {epoch} -> "
                        f"{current_epoch()}")
                if gate is None or not gate():
                    break
                if not gated:
                    gated = True
                    self.perf.inc("backfill_gated")
                    if self.journal is not None:
                        self.journal.emit(
                            "backfill.gated", epoch=int(epoch),
                            pool=pool, ps=ps, flag="norebalance",
                            moved=len(recovered))
                await asyncio.sleep(0.25)
            chunk = names[i:i + step]
            stats: dict = {}
            done = await self.repair.drain(
                backend, {n: rebuild[n] for n in chunk}, versions,
                clazz="backfill", stats=stats)
            recovered |= done
            self.objects += len(done)
            self.batches += int(stats.get("batches", 0))
            self.perf.inc("backfill_objects", len(done))
            self.perf.inc("backfill_batches",
                          int(stats.get("batches", 0)))
            self.perf.inc("backfill_bytes", int(stats.get("bytes", 0)))
            if self.store is not None:
                await cursor_save(self.store, pool, ps, epoch,
                                  chunk[-1],
                                  moved_before + len(recovered))
            if self.journal is not None:
                self.journal.emit(
                    "backfill.drain", epoch=int(epoch), pool=pool,
                    ps=ps, objects=len(done),
                    batches=int(stats.get("batches", 0)),
                    bytes=int(stats.get("bytes", 0)),
                    cursor=chunk[-1])
        if self.store is not None:
            await cursor_clear(self.store, pool, ps)
        if self.journal is not None:
            self.journal.emit("backfill.done", epoch=int(epoch),
                              pool=pool, ps=ps,
                              objects=len(recovered),
                              total=moved_before + len(recovered))
        return recovered
