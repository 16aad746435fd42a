"""Delta-encoded perf collection: the sublinear collect wire format.

Counterpart of ceph_tpu/common/perf_collect.py: the same module over the
port's imports.

The mgr polls every up OSD for a full perf dump each report cycle —
the exact hotspot ROADMAP item 1 predicts walls at 1000 OSDs, because
the payload is O(counters x OSDs) even when almost nothing moved
(idle OSDs, cold pools, registered-but-untouched histograms).  The
fix is classic state-sync:

- the OSD keeps the dump it last shipped plus a monotonically
  increasing **epoch**; each ``perf_dump_delta`` request carries the
  mgr's ``ack_epoch`` (the epoch it last integrated),
- on epoch match the OSD ships only the counters whose value changed
  since the baseline (plus removed keys), stamped with the next epoch,
- on mismatch — first contact, mgr restart, dropped reply, OSD
  restart — the OSD ships a **full resync** and both sides re-anchor.

The decoder replays payloads into the identical full dump the old
path produced, so digest/tsdb contents are bit-identical whichever
mode ran (the cfg16 A/B acceptance criterion).  Both halves are pure
and wire-free: daemon.py and mgr.py wrap them, and bench cfg16 drives
them directly over 200 simulated OSDs for exact payload accounting
via :func:`payload_bytes`.
"""

from __future__ import annotations

import json


def payload_bytes(payload) -> int:
    """Canonical payload size: compact sorted JSON encoding.  Both
    arms of the cfg16 A/B and the mgr byte counters use this one
    function, so the >= 5x claim is counter-verified, not estimated."""
    return len(json.dumps(payload, separators=(",", ":"),
                          sort_keys=True).encode())


class DeltaCollectEncoder:
    """OSD side: turns successive full dumps into delta payloads."""

    def __init__(self):
        self.epoch = 0          # epoch of the last payload shipped
        self._last: dict = {}   # the dump that payload described
        self.full_sends = 0
        self.delta_sends = 0

    def encode(self, dump: dict, ack_epoch: int) -> dict:
        """Encode ``dump`` against the baseline.  A full resync ships
        whenever the collector's ack doesn't match our last-shipped
        epoch (or nothing was ever shipped)."""
        resync = self.epoch == 0 or int(ack_epoch) != self.epoch
        self.epoch += 1
        if resync:
            self.full_sends += 1
            payload = {"epoch": self.epoch, "full": True,
                       "counters": dump}
        else:
            self.delta_sends += 1
            last = self._last
            changed = {k: v for k, v in dump.items()
                       if k not in last or last[k] != v}
            removed = [k for k in last if k not in dump]
            payload = {"epoch": self.epoch, "full": False,
                       "changed": changed, "removed": removed}
        # dump() builds fresh dicts per call, so holding the reference
        # as baseline is safe — the live counters never mutate it
        self._last = dump
        return payload


class DeltaCollectDecoder:
    """Mgr side: replays payloads back into full dumps (one decoder
    per OSD).  ``epoch`` after a decode is the ack to send with the
    next request."""

    def __init__(self):
        self.epoch = 0
        self._state: dict = {}
        self.resyncs = 0
        self.stale_drops = 0

    def decode(self, payload: dict) -> dict:
        epoch = int(payload.get("epoch", 0))
        if payload.get("full"):
            # a full payload re-anchors unconditionally (it IS the
            # state, whatever epoch stream it came from)
            self.resyncs += 1
            self._state = dict(payload.get("counters") or {})
            self.epoch = epoch
        elif epoch == self.epoch + 1:
            st = dict(self._state)
            st.update(payload.get("changed") or {})
            for k in payload.get("removed") or ():
                st.pop(k, None)
            self._state = st
            self.epoch = epoch
        else:
            # a delta is only valid against the exact baseline it was
            # encoded from; an out-of-order/stale one is dropped and
            # the next request's unchanged ack forces a full resync
            self.stale_drops += 1
        return dict(self._state)
