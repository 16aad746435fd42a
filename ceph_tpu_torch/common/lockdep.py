"""lockdep: asyncio lock-order validation (deadlock detection).

Counterpart of ceph_tpu/common/lockdep.py: the same module over the
port's imports.

The role of reference src/common/lockdep.{h,cc}: record the ORDER in
which named locks are acquired while held together; the first time an
edge A->B joins a path B->...->A, a cycle exists and the acquisition
that would close it is reported — catching deadlocks that only
manifest under rare interleavings, at the moment the inconsistent
ORDER first occurs (no hang needed).

The asyncio analog tracks held locks per *task* (the thread analog).
``DLock`` wraps ``asyncio.Lock``; enable globally in tests with
``lockdep_enable()``.  Classes are keyed by NAME, so every instance of
"pg-obj-lock" shares one ordering class — two object locks taken in
either order by different code paths is itself the bug lockdep exists
to catch (the fix is a canonical acquisition order, e.g. sorted oids).
Instances that legitimately nest with themselves should use distinct
names per nesting level.
"""

from __future__ import annotations

import asyncio
from collections import defaultdict

_enabled = False
# observed order: name -> set of names acquired while it was held
_after: dict[str, set[str]] = defaultdict(set)
# where each edge was first observed (for reports)
_edge_site: dict[tuple[str, str], str] = {}
_violations: list[str] = []


def lockdep_enable(reset: bool = True) -> None:
    global _enabled
    _enabled = True
    if reset:
        lockdep_reset()


def lockdep_disable() -> None:
    global _enabled
    _enabled = False


def lockdep_reset() -> None:
    _after.clear()
    _edge_site.clear()
    _violations.clear()


def lockdep_violations() -> list[str]:
    return list(_violations)


class LockOrderError(RuntimeError):
    pass


def _held_var():
    task = asyncio.current_task()
    if task is None:
        return None
    held = getattr(task, "_lockdep_held", None)
    if held is None:
        held = []
        task._lockdep_held = held
    return held


def _path(frm: str, to: str, seen: set[str] | None = None
          ) -> list[str] | None:
    """A recorded acquisition path frm -> ... -> to, if any."""
    if seen is None:
        seen = set()
    if frm == to:
        return [frm]
    seen.add(frm)
    for nxt in _after.get(frm, ()):
        if nxt in seen:
            continue
        rest = _path(nxt, to, seen)
        if rest is not None:
            return [frm] + rest
    return None


def _record(name: str, site: str) -> None:
    held = _held_var()
    if held is None:
        return
    for prior in held:
        if prior == name:
            continue
        # would edge prior->name close a cycle name->...->prior?
        cycle = _path(name, prior)
        if cycle is not None and (prior, name) not in _edge_site:
            order = " -> ".join(cycle + [name])
            msg = (
                f"lock order violation: acquiring {name!r} while "
                f"holding {prior!r} at {site}, but the reverse order "
                f"{order} was recorded at "
                f"{_edge_site.get((cycle[0], cycle[1]), '?')}"
            )
            _violations.append(msg)
            raise LockOrderError(msg)
        if name not in _after[prior]:
            _after[prior].add(name)
            _edge_site[(prior, name)] = site


class DLock:
    """asyncio.Lock with lockdep ordering checks (by class name)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = asyncio.Lock()

    def locked(self) -> bool:
        return self._lock.locked()

    async def acquire(self) -> bool:
        if _enabled:
            import traceback

            frame = traceback.extract_stack(limit=3)[0]
            _record(self.name, f"{frame.filename}:{frame.lineno}")
        await self._lock.acquire()
        held = _held_var()
        if held is not None:
            held.append(self.name)
        return True

    def release(self) -> None:
        held = _held_var()
        if held is not None and self.name in held:
            # remove the most recent acquisition of this class
            for i in range(len(held) - 1, -1, -1):
                if held[i] == self.name:
                    del held[i]
                    break
        self._lock.release()

    async def __aenter__(self) -> None:
        await self.acquire()

    async def __aexit__(self, *exc) -> None:
        self.release()
