"""Cluster flight recorder: bounded structured event journals.

The reference cluster answers "what happened around the incident?" by
grepping daemon logs after the fact; here every daemon keeps an
always-on bounded ring of *structured* events stamped with both clocks
(monotonic for windowing, wall for cross-daemon ordering) and the map
epoch in force when the event fired.  Emission is a tuple append onto a
``deque(maxlen=N)`` — cheap enough to leave enabled on the hot path —
and rendering to dicts is deferred to snapshot time, which only runs
when forensics actually captures.

Three pieces:

* ``EventJournal`` — one per daemon (``event_journal_size`` conf sets
  the ring bound).  ``emit()`` at load-bearing transitions: PG state
  changes, peering rescans, map installs, mClock depth samples,
  coalescer flushes, cache evictions, repair drains, SLO eval
  transitions, heartbeat misses.
* the **process journal** — module-level pseudo-daemon ``proc`` ring
  for emitters with no daemon identity (the failpoint registry, the
  chaos harness): in this tree every daemon shares one process, so
  process-global faults get one shared timeline.
* ``merge_timeline`` — folds per-daemon snapshots into one ordered
  timeline, sorted by wall clock (all daemons share a process, so wall
  time is coherent) with (epoch, entity) as tiebreaks; the forensic
  bundle viewer renders this.

Port copy of ceph_tpu/common/events.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import time
from collections import deque

#: default ring bound; the ``event_journal_size`` option overrides.
DEFAULT_RING = 2048


class EventJournal:
    """Bounded per-daemon ring of structured events."""

    __slots__ = ("entity", "_ring", "emitted", "evicted")

    def __init__(self, entity: str, size: int = DEFAULT_RING):
        self.entity = entity
        self._ring: deque[tuple] = deque(maxlen=max(16, int(size)))
        self.emitted = 0
        self.evicted = 0

    def emit(self, etype: str, epoch: int = 0, **fields) -> None:
        """Record one event.  Hot-path cheap: two clock reads and a
        tuple append; no dict is built unless fields are passed."""
        ring = self._ring
        if len(ring) == ring.maxlen:
            self.evicted += 1
        self.emitted += 1
        ring.append((time.monotonic(), time.time(), int(epoch), etype,
                     fields or None))

    def snapshot(self, window_s: float | None = None) -> list[dict]:
        """Render the ring (optionally only the trailing ``window_s``
        seconds, by monotonic clock) to a list of event dicts."""
        cutoff = None if window_s is None \
            else time.monotonic() - float(window_s)
        out: list[dict] = []
        for mono, wall, epoch, etype, fields in self._ring:
            if cutoff is not None and mono < cutoff:
                continue
            ev = {"entity": self.entity, "wall": wall, "epoch": epoch,
                  "type": etype}
            if fields:
                ev["fields"] = fields
            out.append(ev)
        return out

    def stats(self) -> dict:
        return {"entity": self.entity, "size": len(self._ring),
                "capacity": self._ring.maxlen, "emitted": self.emitted,
                "evicted": self.evicted}

    def __len__(self) -> int:
        return len(self._ring)


# -- process journal ------------------------------------------------------
# Failpoints and the chaos harness are module-global (one registry per
# process, shared by every daemon) so their events live in one shared
# pseudo-daemon ring rather than being attributed to an arbitrary daemon.
_PROC = EventJournal("proc")


def proc_journal() -> EventJournal:
    return _PROC


def emit_proc(etype: str, epoch: int = 0, **fields) -> None:
    _PROC.emit(etype, epoch=epoch, **fields)


def reset_proc() -> None:
    """Fresh process journal (test isolation between DevClusters)."""
    global _PROC
    _PROC = EventJournal("proc", size=_PROC._ring.maxlen or DEFAULT_RING)


# -- timeline reconstruction ----------------------------------------------
def merge_timeline(events: list[dict]) -> list[dict]:
    """Merge per-daemon event snapshots into one ordered timeline.

    Wall clock is the primary order (every daemon shares this process,
    so wall time is coherent and the merged timeline is monotonic);
    map epoch then entity break ties so same-instant events group by
    the epoch they straddled.
    """
    return sorted(events, key=lambda e: (e.get("wall", 0.0),
                                         e.get("epoch", 0),
                                         e.get("entity", "")))


def render_timeline(events: list[dict], limit: int | None = None) -> str:
    """Human-readable timeline (``forensics show``).  One line per
    event: relative time, epoch, entity, type, fields."""
    merged = merge_timeline(events)
    if limit is not None:
        merged = merged[-limit:]
    if not merged:
        return "(empty timeline)"
    t0 = merged[0]["wall"]
    lines = []
    for ev in merged:
        fields = ev.get("fields") or {}
        ftxt = " ".join(f"{k}={fields[k]}" for k in sorted(fields))
        lines.append("%+9.3fs e%-4d %-12s %-28s %s" % (
            ev["wall"] - t0, ev.get("epoch", 0), ev.get("entity", "?"),
            ev.get("type", "?"), ftxt))
    return "\n".join(lines)
