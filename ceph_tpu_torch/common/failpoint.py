"""Named failpoints: one cluster-wide fault-injection registry.

The reference scatters injection across subsystems (ms_inject_socket_failures
in Messenger, filestore_debug_inject_* in FileStore, qa thrashers); here every
layer consults ONE registry of named points, so a test or the chaos harness
can say ``fp_set("store.wal_commit", "error")`` and the fault fires no matter
which daemon owns the store.  Modes:

    ``off``           registered but inert
    ``error``         raise FailPointError(errno) every evaluation
    ``delay``         async sleep ``delay`` seconds, then proceed
    ``prob``          raise FailPointError(errno) with probability ``p``
    ``crash``         raise FailPointCrash — escapes the daemon's task,
                      simulating sudden death (pair with DevCluster revive)

Determinism: each point draws from its own ``random.Random`` seeded from
``(global seed, name)``; ``set_seed`` reseeds everything, so a chaos run
replays exactly.  ``count`` limits firings (-1 = unlimited); an exhausted
point flips itself ``off``.

Zero hot-path cost when idle: call sites guard on the module-level ``ACTIVE``
flag — one attribute read — and only then pay the dict lookup::

    from ceph_tpu_torch.common import failpoint as fp
    if fp.ACTIVE:
        await fp.fire("osd.sub_op")        # async sites (delay works)
    if fp.ACTIVE:
        fp.fire_sync("mon.paxos_commit")   # sync sites (delay is counted,
                                           # not slept — can't block the loop)

Config: the ``failpoint`` option carries a spec string applied at daemon
start (``name=mode[:arg][:arg]``, comma-separated), ``failpoint_seed`` seeds
the registry.  Runtime: every daemon's admin socket exposes
``failpoint ls`` / ``failpoint set`` / ``failpoint clear``.

Aliases: the legacy messenger knobs remain valid point names —
``ms_inject_socket_failures`` targets ``msgr.send`` (prob) and
``ms_inject_delay_max`` targets ``msgr.deliver`` (delay).

Well-known names threaded through the tree: ``msgr.send``, ``msgr.accept``,
``msgr.dial``, ``msgr.deliver``, ``store.wal_commit``, ``store.checkpoint``,
``osd.heartbeat``, ``osd.recovery``, ``osd.sub_op``, ``mon.paxos_commit``,
``mon.election``, ``mds.journal_flush``, ``ec.shard_read`` and
``ec.shard_write`` (plus ``ec.shard_read.<i>`` / ``ec.shard_write.<i>``
for a single shard).

Port copy of ceph_tpu/common/failpoint.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import asyncio
import errno as _errno
import random
from dataclasses import dataclass

from ceph_tpu_torch.common import events
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.common.perf import CounterType, PerfCounters

log = Dout("failpoint")

MODES = ("off", "error", "delay", "prob", "crash")

#: True iff any registered point is armed.  Call sites read this module
#: attribute before touching the registry, so the default-off cost is one
#: attribute load.
ACTIVE: bool = False

_registry: dict[str, "FailPoint"] = {}
_seed: int = 0

_ALIASES = {
    "ms_inject_socket_failures": "msgr.send",
    "ms_inject_delay_max": "msgr.deliver",
}

#: aggregate counters; per-point hit/fired live on the points (see ls()).
perf = PerfCounters("failpoint")
for _k in ("hit", "injected_error", "injected_delay", "injected_crash"):
    perf.add(_k, CounterType.U64)
perf.add("delay_seconds", CounterType.TIME)


class FailPointError(OSError):
    """Injected failure (carries the configured errno)."""

    def __init__(self, eno: int, name: str):
        super().__init__(eno, f"failpoint {name!r} injected "
                         f"{_errno.errorcode.get(eno, eno)}")
        self.failpoint = name


class FailPointCrash(RuntimeError):
    """Injected crash: meant to escape the daemon task entirely."""


@dataclass
class FailPoint:
    name: str
    mode: str = "off"
    errno: int = _errno.EIO
    delay: float = 0.0
    p: float = 1.0
    count: int = -1          # remaining firings; -1 = unlimited
    hits: int = 0            # evaluations while registered
    fired: int = 0           # actual injections
    rng: random.Random = None  # type: ignore[assignment]

    def describe(self) -> dict:
        d = {"mode": self.mode, "hits": self.hits, "fired": self.fired}
        if self.mode in ("error", "prob"):
            d["errno"] = self.errno
        if self.mode == "delay":
            d["delay"] = self.delay
        if self.mode == "prob":
            d["p"] = self.p
        if self.count >= 0:
            d["count"] = self.count
        return d


def _recompute_active() -> None:
    global ACTIVE
    ACTIVE = any(f.mode != "off" for f in _registry.values())


def _point_rng(name: str) -> random.Random:
    return random.Random(f"{_seed}:{name}")


def set_seed(seed: int) -> None:
    """Reseed every point's RNG deterministically (chaos replay)."""
    global _seed
    _seed = int(seed)
    for f in _registry.values():
        f.rng = _point_rng(f.name)


def fp_set(name: str, mode: str, *, errno: int | None = None,
           delay: float | None = None, p: float | None = None,
           count: int | None = None) -> FailPoint:
    """Arm (or re-arm) the named point; alias names are translated."""
    name = _ALIASES.get(name, name)
    if mode not in MODES:
        raise ValueError(f"bad failpoint mode {mode!r} (want {MODES})")
    f = _registry.get(name)
    if f is None:
        f = _registry[name] = FailPoint(name, rng=_point_rng(name))
    f.mode = mode
    if errno is not None:
        f.errno = int(errno)
    if delay is not None:
        f.delay = float(delay)
    if p is not None:
        f.p = float(p)
    f.count = -1 if count is None else int(count)
    _recompute_active()
    log.dout(1, "failpoint %s -> %s", name, f.describe())
    return f


def fp_clear(name: str | None = None) -> None:
    """Disarm one point (or all when ``name`` is None)."""
    if name is None:
        _registry.clear()
    else:
        _registry.pop(_ALIASES.get(name, name), None)
    _recompute_active()


def fp_get(name: str) -> FailPoint | None:
    return _registry.get(_ALIASES.get(name, name))


def ls() -> dict:
    return {n: f.describe() for n, f in sorted(_registry.items())}


# -- hot path ------------------------------------------------------------
def _eval(name: str) -> FailPoint | None:
    """One dict lookup; returns the point iff it should inject now."""
    f = _registry.get(name)
    if f is None or f.mode == "off":
        return None
    f.hits += 1
    if f.mode == "prob" and f.rng.random() >= f.p:
        return None
    if f.count == 0:
        return None
    if f.count > 0:
        f.count -= 1
        if f.count == 0:
            f.mode = "off"
            _recompute_active()
    f.fired += 1
    perf.inc("hit")
    # flight recorder: failpoints are process-global, so firings land
    # in the shared process journal rather than one daemon's ring
    events.emit_proc("failpoint.fired", name=f.name, mode=f.mode)
    return f


async def fire(name: str) -> None:
    """Async injection: delay sleeps, error/prob raise, crash raises."""
    f = _eval(name)
    if f is None:
        return
    if f.delay > 0 and f.mode in ("delay", "error", "prob", "crash"):
        perf.inc("injected_delay")
        perf.tinc("delay_seconds", f.delay)
        await asyncio.sleep(f.delay)
        if f.mode == "delay":
            return
    elif f.mode == "delay":
        return
    _raise(f)


def fire_sync(name: str) -> None:
    """Sync injection: error/prob/crash raise; delay is only counted
    (a blocking sleep would stall the event loop)."""
    f = _eval(name)
    if f is None:
        return
    if f.mode == "delay":
        perf.inc("injected_delay")
        return
    _raise(f)


def _raise(f: FailPoint) -> None:
    if f.mode == "crash":
        perf.inc("injected_crash")
        log.derr("failpoint %s: injected CRASH", f.name)
        raise FailPointCrash(f"failpoint {f.name!r} injected crash")
    perf.inc("injected_error")
    raise FailPointError(f.errno, f.name)


# -- config + admin socket integration -----------------------------------
def apply_spec(spec: str) -> None:
    """Parse a config spec: ``name=mode[:arg][:arg],...``.

    Positional args by mode: ``error[:errno]``, ``delay:seconds``,
    ``prob:p[:errno]``, ``crash``/``off`` (none).  Example::

        osd.sub_op=delay:0.05,msgr.send=prob:0.01:107,mon.paxos_commit=error
    """
    for item in spec.replace(";", ",").split(","):
        item = item.strip()
        if not item:
            continue
        name, _, rhs = item.partition("=")
        parts = rhs.split(":") if rhs else ["off"]
        mode, args = parts[0].strip() or "off", parts[1:]
        kw: dict = {}
        if mode == "error" and args:
            kw["errno"] = int(args[0])
        elif mode == "delay" and args:
            kw["delay"] = float(args[0])
        elif mode == "prob" and args:
            kw["p"] = float(args[0])
            if len(args) > 1:
                kw["errno"] = int(args[1])
        fp_set(name.strip(), mode, **kw)


def apply_conf(conf) -> None:
    """Arm points from a daemon's ConfigProxy at start: the ``failpoint``
    spec string plus ``failpoint_seed``."""
    try:
        seed = int(conf["failpoint_seed"] or 0)
        spec = str(conf["failpoint"] or "")
    except KeyError:  # schema without the options (old conf)
        return
    if seed:
        set_seed(seed)
    if spec:
        apply_spec(spec)


def register_admin_commands(asok) -> None:
    """Expose ``failpoint ls/set/clear`` on a daemon's admin socket."""

    def _set(name: str, mode: str, errno=None, delay=None, p=None,
             count=None) -> dict:
        f = fp_set(name, mode,
                   errno=None if errno is None else int(errno),
                   delay=None if delay is None else float(delay),
                   p=None if p is None else float(p),
                   count=None if count is None else int(count))
        return {f.name: f.describe()}

    def _clear(name: str | None = None) -> dict:
        fp_clear(name)
        return {"cleared": name or "all"}

    asok.register("failpoint ls", lambda: ls(),
                  "list registered failpoints")
    asok.register("failpoint set", _set,
                  "arm a failpoint: name mode [errno|delay|p] [count]")
    asok.register("failpoint clear", _clear,
                  "disarm one failpoint (or all)")
