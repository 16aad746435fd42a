"""Device-kernel profiler: per-codec-signature launch attribution.

ROADMAP item 4 (the kernel round) needs ground truth before any
optimization: WHICH kernel burns the wall time, at what achieved
HBM bandwidth, vs the roofline (arxiv 2108.02692's playbook is
unusable without per-kernel measurement).  :class:`KernelProfiler`
attributes every device launch — coalesced encode/decode, resident
decode, mesh repair, host-mesh flush — to its codec signature
(``<codec>-k<k>-m<m>:<kind>``) with:

- ``launches``: launch count,
- ``wall_us``: measured launch wall time (the SAME timer sample that
  feeds ``ec_encode_launch_us``/``ec_decode_launch_us``/
  ``ec_mesh_launch_us``, recorded at the same sites),
- ``stripes``: stripes carried,
- ``hbm_bytes``: logical bytes moved (the SAME increments that feed
  ``ec_launch_bytes``), so per-signature byte totals reconcile with
  the existing counters EXACTLY — the profiler is an attribution of
  the counters, never a second opinion;
- ``device_us``: on a card, the launches' device time (CUDA events
  around each launch's uploads, kernels and download; the SAME sample
  that feeds ``ec_encode_device_us``/``ec_decode_device_us``, added by
  ``record_device`` once the events have passed), kept only where
  non-zero.  The events lie on the stream that every daemon of the
  process shares, so other daemons' work queued between them counts
  too;
- derived ``gibps`` and (given a peak) ``roofline_pct``, from
  ``device_us`` where a signature has it (``time_base`` "device"), else
  from ``wall_us`` as the reference does.

The dump rides the OSD's perf_dump under the ``ec_kernels`` key, the
mgr persists per-signature series into the TSDB, and
``ceph-tpu top --kernels`` renders the table.

One profiler per :class:`~ceph_tpu_torch.common.perf.PerfCounters` instance
(i.e. per daemon), resolved via :func:`profiler_for` — backends and
the host mesh launcher share the daemon's registry the same way they
share its counters.

Port copy of ceph_tpu/ec/profiler.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import threading
import weakref

_GIB = float(1 << 30)


class KernelProfiler:
    """Bounded per-signature accumulator (signatures are a function of
    pool EC profiles — a handful per daemon, never per-op)."""

    def __init__(self):
        self.kernels: dict[str, dict] = {}
        self._lock = threading.Lock()

    def record(self, signature: str, wall_us: float,
               stripes: int = 0, hbm_bytes: int = 0) -> None:
        with self._lock:
            rec = self.kernels.get(signature)
            if rec is None:
                rec = self.kernels[signature] = {
                    "launches": 0, "wall_us": 0.0,
                    "stripes": 0, "hbm_bytes": 0}
            rec["launches"] += 1
            rec["wall_us"] += float(wall_us)
            rec["stripes"] += int(stripes)
            rec["hbm_bytes"] += int(hbm_bytes)

    def record_device(self, signature: str, device_us: float) -> None:
        """Add a recorded launch's device time, read after the launch
        (its events pass later than its host return)."""
        with self._lock:
            rec = self.kernels.get(signature)
            if rec is not None:
                rec["device_us"] = rec.get("device_us", 0.0) + device_us

    def totals(self) -> dict:
        with self._lock:
            t = {"launches": 0, "wall_us": 0.0, "stripes": 0,
                 "hbm_bytes": 0}
            for rec in self.kernels.values():
                for k in t:
                    t[k] += rec[k]
            return t

    def dump(self, peak_gibps: float = 0.0) -> dict:
        """JSON-friendly per-signature table with derived bandwidth
        (and roofline % when a peak is known)."""
        out: dict[str, dict] = {}
        with self._lock:
            items = sorted((sig, dict(rec))
                           for sig, rec in self.kernels.items())
        for sig, rec in items:
            wall_s = rec["wall_us"] / 1e6
            if rec.get("device_us"):
                wall_s = rec["device_us"] / 1e6
                rec["device_us"] = round(rec["device_us"], 1)
                rec["time_base"] = "device"
            gibps = (rec["hbm_bytes"] / _GIB / wall_s) \
                if wall_s > 0 else 0.0
            rec["wall_us"] = round(rec["wall_us"], 1)
            rec["gibps"] = round(gibps, 3)
            if peak_gibps > 0:
                rec["roofline_pct"] = round(
                    100.0 * gibps / peak_gibps, 3)
            out[sig] = rec
        return out

    def reset(self) -> None:
        with self._lock:
            self.kernels = {}


# per-PerfCounters registry: every code site holding a daemon's perf
# handle reaches the daemon's ONE profiler without constructor churn
_REGISTRY: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_REG_LOCK = threading.Lock()


def profiler_for(perf) -> KernelProfiler:
    """The profiler attached to this PerfCounters instance (created on
    first use; lifetime tied to the counters themselves)."""
    with _REG_LOCK:
        prof = _REGISTRY.get(perf)
        if prof is None:
            prof = _REGISTRY[perf] = KernelProfiler()
        return prof
