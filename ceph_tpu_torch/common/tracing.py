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

Port copy of ceph_tpu/common/tracing.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import contextvars
import secrets
import time
from collections import deque
from contextlib import contextmanager
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
    try:
        yield ctx
    finally:
        _ACTIVE.reset(tok)


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
    def span(self, name: str, parent: SpanCtx | None = None, **tags):
        """Record a timed span; yields the child SpanCtx to propagate.
        Works around both sync and async code (it only stamps clocks)."""
        ctx = SpanCtx(
            parent.trace_id if parent else secrets.token_hex(8),
            secrets.token_hex(4),
        )
        # wall-clock start for cross-daemon ordering, monotonic clock
        # for the duration (an NTP step must not yield negative spans)
        start = time.time()
        t0 = time.perf_counter()
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
            })

    def record(self, name: str, parent: SpanCtx, start: float,
               duration_ms: float, **tags) -> SpanCtx:
        """Append a pre-measured span (no context manager).  For work
        shared across ops — a coalesced device launch serves many
        traces at once, so the one measured interval is recorded once
        per interested parent."""
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
