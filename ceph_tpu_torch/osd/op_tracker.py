"""OpTracker: in-flight op observability.

Counterpart of ceph_tpu/osd/op_tracker.py: the same module over the
port's imports.

The role of reference src/osd/OpRequest.{h,cc} + common/TrackedOp.h: every
client op is registered with a monotonically increasing id and stamps a
timestamped event at each pipeline stage (received -> queued ->
executing -> replied, mirroring the reference's mark_* calls such as
"dequeue_op"/"commit_sent"). Live ops are inspectable via
dump_ops_in_flight and a bounded history of slow/recent ops via
dump_historic_ops — the admin-socket surface the reference exposes
(admin_socket.h:105), served here over the messenger ("dump_ops" message)
and the CLI.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class TrackedOp:
    opid: int
    description: str
    started: float = field(default_factory=time.monotonic)
    events: list[tuple[float, str]] = field(default_factory=list)
    done: bool = False
    trace_id: str = ""     # sampled op: links the op to its span tree

    def mark(self, stage: str) -> None:
        self.events.append((time.monotonic(), stage))

    @property
    def age(self) -> float:
        return time.monotonic() - self.started

    @property
    def duration(self) -> float:
        if not self.events:
            return self.age
        return self.events[-1][0] - self.started

    def dump(self) -> dict:
        return {
            "id": self.opid,
            "description": self.description,
            "age": round(self.age, 6),
            "duration": round(self.duration, 6),
            **({"trace_id": self.trace_id} if self.trace_id else {}),
            "events": [
                {"t": round(t - self.started, 6), "event": stage}
                for t, stage in self.events
            ],
        }


class OpTracker:
    def __init__(self, history_size: int = 64,
                 slow_op_seconds: float = 1.0,
                 slow_history_size: int = 20):
        self._next_id = 0
        self._inflight: dict[int, TrackedOp] = {}
        self._history: deque[dict] = deque(maxlen=history_size)
        self.slow_op_seconds = slow_op_seconds
        self.slow_ops = 0
        # forensic ring: the N slowest finished ops, each retaining the
        # full staged event timeline and (for sampled ops) the span
        # tree captured at completion — reference
        # dump_historic_slow_ops (TrackedOp.cc history.insert slow)
        self.slow_history_size = slow_history_size
        self._slow: list[dict] = []

    def create(self, description: str) -> TrackedOp:
        self._next_id += 1
        op = TrackedOp(self._next_id, description)
        op.mark("received")
        self._inflight[op.opid] = op
        return op

    def finish(self, op: TrackedOp, stage: str = "done",
               spans: list[dict] | None = None) -> None:
        """``spans``: the daemon's spans for the op's trace, captured
        by the caller when the op turns out slow; retained with the
        forensic record as an assembled subtree."""
        op.mark(stage)
        op.done = True
        self._inflight.pop(op.opid, None)
        if op.duration >= self.slow_op_seconds:
            self.slow_ops += 1
            self._retain_slow(op, spans)
        self._history.append(op.dump())

    def _retain_slow(self, op: TrackedOp,
                     spans: list[dict] | None) -> None:
        rec = op.dump()
        if spans:
            from ceph_tpu_torch.common.tracing import assemble_tree
            rec["span_tree"] = assemble_tree(spans)
        self._slow.append(rec)
        # keep the N slowest (ties broken by recency: stable sort on
        # duration keeps later arrivals when equal)
        self._slow.sort(key=lambda r: r["duration"], reverse=True)
        del self._slow[self.slow_history_size:]

    def has_slow_trace(self, trace_id: str) -> bool:
        return any(r.get("trace_id") == trace_id for r in self._slow)

    def attach_spans(self, trace_id: str, spans: list[dict]) -> None:
        """Refresh the retained span tree of forensic records for
        ``trace_id`` — the op's enclosing span only finalizes after the
        tracker's finish() ran, so the caller re-attaches once the
        full tree is in the ring."""
        if not spans:
            return
        from ceph_tpu_torch.common.tracing import assemble_tree
        tree = None
        for rec in self._slow:
            if rec.get("trace_id") == trace_id:
                if tree is None:
                    tree = assemble_tree(spans)
                rec["span_tree"] = tree

    def slow_inflight(self) -> int:
        """Ops currently in flight past the complaint threshold — the
        live count an OSD beacon reports (raises AND clears the mon's
        SLOW_OPS check)."""
        return sum(1 for op in self._inflight.values()
                   if op.age >= self.slow_op_seconds)

    def dump_ops_in_flight(self) -> dict:
        ops = [op.dump() for op in self._inflight.values()]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_ops(self) -> dict:
        return {"num_ops": len(self._history),
                "slow_ops": self.slow_ops,
                "ops": list(self._history)}

    def dump_historic_slow_ops(self) -> dict:
        return {"num_ops": len(self._slow),
                "slow_ops": self.slow_ops,
                "complaint_time": self.slow_op_seconds,
                "ops": list(self._slow)}
