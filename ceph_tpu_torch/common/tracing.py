"""Zipkin-lite distributed tracing for the op path.

The role of reference src/common/zipkin_trace.h (:24 ZTracer wrappers)
+ the OpRequest trace hooks (src/osd/OpRequest.h): a sampled client op
carries a trace context on the wire; every hop (objecter submit, OSD
op execution, sub-op fan-out, replica apply) records a timed span
linked by (trace_id, parent span id).  Spans land in a bounded
per-process ring inspectable via the admin socket / ``dump_traces``
message, keyed so a cross-daemon trace tree can be reassembled.

Sampling: the root decides (``trace_probability`` config); everything
downstream of a sampled op traces unconditionally, so a trace is
always complete.

On-loop time (the port's departure).  While any entity of the process
runs with ``trace_probability`` above 0 (``hold_loop_trace``), a hook on
``asyncio.events.Handle._run`` times every step of the event loop and
charges it to the innermost span ambient in the step's context, cut
where the ambient span changes inside a step (``use_span``, an ambient
``Tracer.span``, a ``LoopLabel`` block).  Each span then carries
``loop_ms``, the loop time of its own steps, and ``t_ns``, its start on
the ``perf_counter_ns`` clock.  A ``LoopMonitor`` keeps the loop's busy
time in 10 ms buckets, by span name, ``gc`` or ``unspanned:<callback>``,
with the lag of a probe that waits its turn every 10 ms
(``loop_monitor()`` reads the last one).  With no such entity nothing is
installed.

Port copy of ceph_tpu/common/tracing.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import asyncio
import contextvars
import gc
import secrets
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

_RING = 4096


@dataclass(frozen=True)
class SpanCtx:
    trace_id: str
    span_id: str

    def to_wire(self) -> dict:
        return {"t": self.trace_id, "s": self.span_id}

    @staticmethod
    def from_wire(d) -> "SpanCtx | None":
        if not isinstance(d, dict) or "t" not in d:
            return None
        return SpanCtx(str(d["t"]), str(d.get("s", "")))


# The task-local active span: set where an op's span is opened (RGW
# request handler, OSD do_op, EC per-op submit) and read at the next
# layer down (objecter, EC coalescer, messenger) so causality crosses
# module boundaries without threading a ctx argument through every
# signature.  A contextvar — each asyncio task sees its own value.
_ACTIVE: contextvars.ContextVar[SpanCtx | None] = contextvars.ContextVar(
    "tracing_active_span", default=None
)


def current_span() -> SpanCtx | None:
    """The ambient SpanCtx of the running task, if any."""
    return _ACTIVE.get()


@contextmanager
def use_span(ctx: SpanCtx | None):
    """Make ``ctx`` the ambient span for the enclosed block."""
    tok = _ACTIVE.set(ctx)
    _cut(_owner(ctx))
    try:
        yield ctx
    finally:
        _ACTIVE.reset(tok)
        _cut(_ambient_owner())


# -- on-loop time -------------------------------------------------------------

BUCKET_NS = 10_000_000
PROBE_S = 0.010
# 180 s of busy buckets: a 60 s window, the set-up before it and the
# read-back after it
RING_BUCKETS = 18_000

_STOCK_RUN = asyncio.events.Handle._run
_NO_SPAN = nullcontext()


class _Acct:
    """The loop time charged to one open span (or one LoopLabel)."""

    __slots__ = ("tracer", "name", "loop_ns")

    def __init__(self, tracer, name: str):
        self.tracer = tracer
        self.name = name
        self.loop_ns = 0


# span_id -> _Acct of every span open while the loop is traced
_OPEN: dict[str, _Acct] = {}
# where a task's steps go when no span is ambient in it: the LoopLabel
# its task holds (a messenger I/O task working on frames)
_TASK_ACCT: contextvars.ContextVar[_Acct | None] = contextvars.ContextVar(
    "tracing_task_acct", default=None
)
# entities that trace (hold_loop_trace); the hook is installed while
# there is one
_HOLDERS: set = set()
_MONITOR: "LoopMonitor | None" = None
_LAST: "LoopMonitor | None" = None
# a garbage collection that runs inside a traced step
_GC = _Acct(None, "gc")


class LoopMonitor:
    """The traced event loop's busy time in 10 ms buckets stamped with
    ``perf_counter_ns``: ``[t0_ns, busy_ns, steps, {label: ns},
    probe_lag_ns, probes]``, a bucket only where the loop ran.  A label
    is the span name a step (or a cut piece of it) was charged to,
    ``gc`` for a garbage collection inside a step, or
    ``unspanned:<callback qualname>``."""

    def __init__(self, loop, ring: int = RING_BUCKETS):
        self.loop = loop
        self.tid = threading.get_ident()
        self.bucket_ns = BUCKET_NS
        self.buckets: deque[list] = deque(maxlen=ring)
        self.evictions = 0
        self.busy_ns = 0
        self.steps = 0
        # the running step: its handle, whom the time since cut_ns goes
        # to, and its unspanned label once asked for
        self.handle = None
        self.owner: _Acct | None = None
        self.cut_ns = 0
        self.label = None
        self._timer = None
        self._gc_owner: _Acct | None = None

    def start(self) -> None:
        self._timer = self.loop.call_later(PROBE_S, self._probe)
        gc.callbacks.append(self._gc)

    def stop(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)

    def _gc(self, phase: str, info: dict) -> None:
        if self.handle is None or threading.get_ident() != self.tid:
            return
        if phase == "start":
            self._gc_owner = self.owner
            _cut(_GC)
        else:
            _cut(self._gc_owner)

    def _probe(self) -> None:
        self.loop.call_soon(self._probe_run, time.perf_counter_ns())

    def _probe_run(self, t_ns: int) -> None:
        now = time.perf_counter_ns()
        b = self._bucket(t_ns)
        b[4] += now - t_ns
        b[5] += 1
        if self._timer is not None:
            self._timer = self.loop.call_later(PROBE_S, self._probe)

    def _bucket(self, t_ns: int) -> list:
        t0 = t_ns - t_ns % BUCKET_NS
        ring = self.buckets
        at = len(ring)
        while at and ring[at - 1][0] >= t0:
            if ring[at - 1][0] == t0:
                return ring[at - 1]
            at -= 1
        b = [t0, 0, 0, {}, 0, 0]
        if len(ring) == ring.maxlen:
            self.evictions += 1
            ring.popleft()
            at = max(0, at - 1)
        ring.insert(at, b)
        return b

    def _step_label(self) -> str:
        if self.label is None:
            self.label = _unspanned_label(self.handle)
        return self.label

    def charge(self, a: int, b: int) -> None:
        """Charge [a, b) of the running step to its current owner."""
        d = b - a
        if d <= 0:
            return
        owner = self.owner
        if owner is not None:
            owner.loop_ns += d
            label = owner.name
        else:
            label = self.label or self._step_label()
        self.busy_ns += d
        bk = self.buckets[-1] if self.buckets else None
        if bk is not None and bk[0] <= a and b <= bk[0] + BUCKET_NS:
            bk[1] += d
            by = bk[3]
            by[label] = by.get(label, 0) + d
            return
        while True:
            bk = self._bucket(a)
            end = min(b, bk[0] + BUCKET_NS)
            bk[1] += end - a
            by = bk[3]
            by[label] = by.get(label, 0) + end - a
            if end >= b:
                return
            a = end


_LABELS: dict = {}


def _unspanned_label(handle) -> str:
    cb = getattr(handle, "_callback", None)
    owner = getattr(cb, "__self__", None)
    if isinstance(owner, asyncio.Task):
        what = owner.get_coro()
        key = getattr(what, "cr_code", None) or type(what)
    else:
        what = cb
        key = getattr(cb, "__func__", None) or cb
    label = _LABELS.get(key)
    if label is None:
        name = getattr(what, "__qualname__", None) or type(what).__name__
        label = _LABELS[key] = "unspanned:" + name
    return label


def _run_step(handle) -> None:
    """``Handle._run`` while the loop is traced: the step timed and
    charged to the span ambient in its context."""
    mon = _MONITOR
    if mon is None or handle._loop is not mon.loop:
        return _STOCK_RUN(handle)
    ctx = handle._context
    span = ctx.get(_ACTIVE)
    mon.owner = (_OPEN.get(span.span_id) if span is not None
                 else ctx.get(_TASK_ACCT))
    mon.handle = handle
    mon.label = None
    mon.cut_ns = time.perf_counter_ns()
    try:
        _STOCK_RUN(handle)
    finally:
        t1 = time.perf_counter_ns()
        mon.charge(mon.cut_ns, t1)
        bk = mon.buckets[-1] if mon.buckets else None
        if bk is None or not bk[0] <= t1 < bk[0] + BUCKET_NS:
            bk = mon._bucket(t1)
        bk[2] += 1
        mon.handle = None
        mon.owner = None
        mon.steps += 1


def _owner(ctx: SpanCtx | None) -> _Acct | None:
    return _OPEN.get(ctx.span_id) if ctx is not None else None


def _ambient_owner() -> _Acct | None:
    ctx = _ACTIVE.get()
    return _OPEN.get(ctx.span_id) if ctx is not None else _TASK_ACCT.get()


def _cut(owner: _Acct | None) -> None:
    """Inside a traced step: charge the step's time so far to its
    current owner and the rest to ``owner``."""
    mon = _MONITOR
    if mon is None or mon.handle is None or \
            threading.get_ident() != mon.tid:
        return
    now = time.perf_counter_ns()
    mon.charge(mon.cut_ns, now)
    mon.owner = owner
    mon.cut_ns = now


def hold_loop_trace(owner, on: bool) -> None:
    """Count ``owner`` (an entity with ``trace_probability`` above 0)
    among those that trace, or not.  The hook goes onto the running
    loop with the first and comes off, ``Handle._run`` restored, with
    the last."""
    global _MONITOR, _LAST
    if on:
        _HOLDERS.add(owner)
    else:
        _HOLDERS.discard(owner)
    if not _HOLDERS:
        if _MONITOR is not None:
            _MONITOR.stop()
            _MONITOR = None
        asyncio.events.Handle._run = _STOCK_RUN
        return
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        return                  # installed by the next call on a loop
    if _MONITOR is None or _MONITOR.loop is not loop:
        if _MONITOR is not None:
            _MONITOR.stop()
        _MONITOR = _LAST = LoopMonitor(loop)
        asyncio.events.Handle._run = _run_step
        _MONITOR.start()


def untraced_context() -> contextvars.Context:
    """A copy of the running context with no span ambient and no task
    account held: for a long-lived task started inside a traced op (a
    messenger's I/O tasks), which must not keep the op's span."""
    ctx = contextvars.copy_context()
    ctx.run(_ACTIVE.set, None)
    ctx.run(_TASK_ACCT.set, None)
    return ctx


def loop_monitor() -> LoopMonitor | None:
    """The loop monitor installed last, kept after it came off."""
    return _LAST


def watch_trace_probability(conf, callback) -> None:
    """Call ``callback`` when ``trace_probability`` changes on ``conf``
    (a ConfigProxy; anything else has no observers)."""
    observe = getattr(conf, "observe", None)
    if observe is not None:
        observe("trace_probability", callback)


def _open_span(tracer, ctx: SpanCtx, name: str, ambient: bool) -> tuple:
    acct = None
    if _MONITOR is not None:
        acct = _OPEN[ctx.span_id] = _Acct(tracer, name)
    tok = None
    if ambient:
        tok = _ACTIVE.set(ctx)
        _cut(acct)
    return ctx, acct, tok, time.perf_counter_ns()


def _close_span(state: tuple) -> None:
    ctx, acct, tok, _ = state
    if tok is not None:
        _ACTIVE.reset(tok)
        _cut(_ambient_owner())
    if acct is not None:
        _OPEN.pop(ctx.span_id, None)


def _settle(acct: _Acct) -> None:
    """Charge the running step's time so far to ``acct`` where it is the
    step's current owner."""
    mon = _MONITOR
    if mon is not None and mon.owner is acct:
        _cut(acct)


def _span_clock(state: tuple) -> dict:
    _, acct, _, t_ns = state
    if acct is None:
        return {"t_ns": t_ns}
    _settle(acct)
    return {"t_ns": t_ns, "loop_ms": acct.loop_ns / 1e6}


def _clock_fields(clock: dict | None) -> dict:
    return dict(clock) if clock else {}


def child_span(name: str, **tags):
    """While the loop is traced, a span of the ambient span's tracer
    under it, itself ambient for the block (the store's commits and
    reads); otherwise a context that does nothing."""
    if _MONITOR is None:
        return _NO_SPAN
    parent = _ACTIVE.get()
    acct = _owner(parent)
    if acct is None:
        return _NO_SPAN
    return acct.tracer.span(name, parent=parent, ambient=True, **tags)


def reply_trace() -> dict:
    """The ambient span's wire context for a reply payload, so the
    requester dispatches the reply in the same trace (its
    ``msgr:dispatch`` span, ambient there)."""
    ctx = _ACTIVE.get()
    return {"tctx": ctx.to_wire()} if ctx is not None else {}


class LoopLabel(_Acct):
    """A label of loop time that is no span (the messenger's frame work,
    ``msgr:send`` and ``msgr:recv``): ``with`` it around a synchronous
    block, or ``hold`` it for the running task's steps where no span is
    ambient, until ``release``.  The loop monitor's buckets keep its
    time by name; nothing is recorded per message."""

    def __init__(self, name: str):
        super().__init__(None, name)

    def __enter__(self):
        _cut(self)
        return self

    def __exit__(self, *exc) -> None:
        if _MONITOR is not None:
            _cut(_ambient_owner())

    def hold(self) -> None:
        _TASK_ACCT.set(self)
        if _MONITOR is not None:
            _cut(_ambient_owner())

    @staticmethod
    def release() -> None:
        _TASK_ACCT.set(None)
        if _MONITOR is not None:
            _cut(_ambient_owner())


class Tracer:
    """Per-process span collector (one per daemon entity)."""

    def __init__(self, entity: str):
        self.entity = entity
        self.spans: deque[dict] = deque(maxlen=_RING)
        #: spans pushed out of the bounded ring before collection —
        #: each eviction is a potential orphan in a later
        #: ``assemble_tree``, so span loss must be visible *before*
        #: a trace is pulled (perf counter / prom gauge)
        self.ring_evictions = 0

    def _append(self, span: dict) -> None:
        if len(self.spans) == self.spans.maxlen:
            self.ring_evictions += 1
        self.spans.append(span)

    @contextmanager
    def span(self, name: str, parent: SpanCtx | None = None,
             ambient: bool = False, **tags):
        """Record a timed span; yields the child SpanCtx to propagate.
        Works around both sync and async code (it only stamps clocks).
        ``ambient``: the span is also the block's ambient span."""
        ctx = SpanCtx(
            parent.trace_id if parent else secrets.token_hex(8),
            secrets.token_hex(4),
        )
        # wall-clock start for cross-daemon ordering, monotonic clock
        # for the duration (an NTP step must not yield negative spans)
        start = time.time()
        t0 = time.perf_counter()
        opened = _open_span(self, ctx, name, ambient)
        try:
            yield ctx
        finally:
            self._append({
                "trace_id": ctx.trace_id,
                "span_id": ctx.span_id,
                "parent": parent.span_id if parent else "",
                "name": name,
                "entity": self.entity,
                "start": start,
                "duration_ms": round(
                    (time.perf_counter() - t0) * 1e3, 3),
                **({"tags": tags} if tags else {}),
                **_span_clock(opened),
            })
            _close_span(opened)

    def record(self, name: str, parent: SpanCtx, start: float,
               duration_ms: float, clock: dict | None = None,
               **tags) -> SpanCtx:
        """Append a pre-measured span (no context manager).  For work
        shared across ops — a coalesced device launch serves many
        traces at once, so the one measured interval is recorded once
        per interested parent.  ``clock``: further fields of the span
        (``t_ns`` and the launch's device interval)."""
        ctx = SpanCtx(parent.trace_id, secrets.token_hex(4))
        self._append({
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "parent": parent.span_id,
            "name": name,
            "entity": self.entity,
            "start": start,
            "duration_ms": round(duration_ms, 3),
            **({"tags": tags} if tags else {}),
            **_clock_fields(clock),
        })
        return ctx

    def dump(self, trace_id: str | None = None) -> list[dict]:
        return [s for s in self.spans
                if trace_id is None or s["trace_id"] == trace_id]

    def orphan_count(self) -> int:
        """Spans currently in the ring whose parent has already fallen
        out of it — what ``assemble_tree`` would tag ``orphan`` if a
        collection ran now.  O(ring) walk; called at perf-dump time,
        not on the span hot path."""
        ids = {s["span_id"] for s in self.spans}
        return sum(1 for s in self.spans
                   if s.get("parent") and s["parent"] not in ids)


def assemble_tree(spans: list[dict]) -> list[dict]:
    """Merge spans (possibly from several daemons) into parent-linked
    trees sorted by start time — the trace-view the reference gets
    from its zipkin collector."""
    by_id = {s["span_id"]: dict(s) for s in spans}
    roots: list[dict] = []
    for s in sorted(by_id.values(), key=lambda s: s["start"]):
        pid = s.get("parent", "")
        parent = by_id.get(pid)
        if parent is not None:
            parent.setdefault("children", []).append(s)
        else:
            # a span naming a parent that isn't in the set (fell out
            # of the ring, or a daemon wasn't collected) is promoted
            # to a root but marked, so partial traces are
            # distinguishable from genuinely root spans
            if pid:
                s["orphan"] = True
            roots.append(s)
    return roots
