"""Per-subsystem leveled logging with a crash ring buffer.

The dout model (reference src/common/dout.h:122-176: cheap per-subsystem
level gates; src/common/subsys.h: subsystem catalogue; src/log/Log.cc:
async sink + in-memory ring dumped on crash) on top of stdlib logging:
every record also lands in a bounded deque at ``gather_level`` so a crash
dump contains recent high-verbosity context even when the emitted level is
low.

Port copy of ceph_tpu/common/log.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import collections
import logging
import sys
import threading
import time

SUBSYSTEMS = (
    "osd", "mon", "ms", "ec", "crush", "objecter", "store", "client",
    "mgr", "rbd", "rgw", "rgw-sync", "rgw-http", "mds", "config",
    "dashboard", "heartbeat",
    "peering", "asok", "failpoint",
)

_RING_SIZE = 10000


class _Ring:
    def __init__(self, size: int = _RING_SIZE):
        self._dq: collections.deque = collections.deque(maxlen=size)
        self._lock = threading.Lock()

    def append(self, rec: tuple) -> None:
        with self._lock:
            self._dq.append(rec)

    def dump(self) -> list[str]:
        with self._lock:
            return [
                f"{time.strftime('%H:%M:%S', time.localtime(t))}"
                f".{int((t % 1) * 1000):03d} {sub} {lvl} : {msg}"
                for (t, sub, lvl, msg) in self._dq
            ]


_ring = _Ring()
_levels: dict[str, int] = {}
_gather_levels: dict[str, int] = {}
_default_level = 1
_default_gather = 5


def set_level(subsys: str, level: int, gather: int | None = None) -> None:
    """``debug_<subsys> = level/gather`` analog."""
    _levels[subsys] = level
    if gather is not None:
        _gather_levels[subsys] = gather


class Dout:
    """Per-subsystem logger handle: ``log = Dout('osd'); log.dout(5, ...)``."""

    def __init__(self, subsys: str):
        if subsys not in SUBSYSTEMS:
            raise ValueError(f"unknown log subsystem {subsys!r}")
        self.subsys = subsys
        self._py = logging.getLogger("ceph_tpu_torch." + subsys)

    def _gate(self) -> int:
        return _levels.get(self.subsys, _default_level)

    def dout(self, level: int, msg: str, *args) -> None:
        gather = _gather_levels.get(self.subsys, _default_gather)
        if level > max(self._gate(), gather):
            return  # cheap gate, mirrors the compiled-out dout check
        text = msg % args if args else msg
        _ring.append((time.time(), self.subsys, level, text))
        if level <= self._gate():
            self._py.log(
                logging.DEBUG if level > 1 else logging.INFO,
                "%s %d : %s", self.subsys, level, text,
            )

    def derr(self, msg: str, *args) -> None:
        text = msg % args if args else msg
        _ring.append((time.time(), self.subsys, -1, text))
        self._py.error("%s : %s", self.subsys, text)


def dump_recent(file=None) -> list[str]:
    """Crash dump: flush the ring buffer (Log::dump_recent analog)."""
    lines = _ring.dump()
    out = file or sys.stderr
    print("--- begin dump of recent events ---", file=out)
    for line in lines:
        print(line, file=out)
    print("--- end dump of recent events ---", file=out)
    return lines


def recent_lines(count: int = 200) -> list[str]:
    """Tail of the log ring, bounded and side-effect-free: the asok
    ``log dump`` handler (the full ring can exceed the line-framed
    socket protocol's limit in a long-lived process)."""
    return _ring.dump()[-max(1, int(count)):]
