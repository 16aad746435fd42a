"""RepairScheduler: batched locality-aware rebuild of EC missing sets.

Recovery was the last EC data path still running one object at a time:
``ECBackend.recover_shard`` issues a whole-chunk survivor read and a
solo decode launch per object.  This module drains a PG's missing set
through BATCHED device launches instead:

- degraded objects are grouped by codec signature and lost-shard
  pattern (objects sharing a failure pattern share a decode matrix, so
  they can share a launch — the same grouping key the cross-op
  coalescer uses);
- each group's cheapest repair is planned ONCE by a strategy selector
  (``plan_repair``): plain-RS ``minimum_to_decode`` read sets, LRC
  group-local reads, CLAY helper sub-chunk plane reads — the
  regenerating-code/locality levers the degraded-read path already
  exploits (arxiv 1412.3022, 1906.08602: repair cost is read/network
  bandwidth and strategy choice, not decode math);
- survivor shards are bulk-fetched and handed to
  ``ECBackend.recover_batch``, which flushes the whole batch through
  one coalesced decode launch and fans the rebuilt shards out;
- the engine is paced through the mClock ``recovery`` class with
  ``cost=len(batch)``, so a batched drain is charged exactly like the
  per-object loop it replaces and cannot starve client ops.

Accounting: ``ec_repair_batches/_objects/_read_bytes/_read_bytes_saved/
_rebuild_bytes`` perf counters (registered here, accrued by the
backend), ``ec repair stats`` asok/wire command (daemon), and
``osd:ec:repair_batch`` tracer spans.

Port copy of ceph_tpu/osd/repair.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import asyncio
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from ceph_tpu_torch.common.perf import CounterType, PerfCounters

REPAIR_COUNTERS = (
    "ec_repair_batches",         # batched decode launches issued
    "ec_repair_objects",         # objects rebuilt through the engine
    "ec_repair_read_bytes",      # survivor bytes actually read
    "ec_repair_read_bytes_saved",  # whole-chunk counterfactual - actual
    "ec_repair_rebuild_bytes",   # bytes written to rebuilt shards
    "ec_repair_demoted",         # objects demoted to per-object recovery
    "ec_repair_plan_hits",       # memoized decode plans served
    "ec_repair_plan_misses",     # decode plans computed
)


def register_repair_counters(perf: PerfCounters) -> None:
    """Idempotently register the repair-engine counter set on ``perf``."""
    for key in REPAIR_COUNTERS:
        perf.add(key, CounterType.U64)


def repair_codec_sig(ec) -> tuple:
    """Hashable codec identity for cross-PG plan sharing: two backends
    over the same plugin+profile repair identically, so their groups
    may share one memoized plan (and hence one decode matrix)."""
    get_profile = getattr(ec, "get_profile", None)
    if get_profile is not None:
        prof = tuple(sorted(get_profile().items()))
    else:
        # no profile surface: never alias distinct codec instances
        prof = ("id", id(ec))
    return (type(ec).__module__, type(ec).__name__, prof)


@dataclass(frozen=True)
class RepairPlan:
    """One group's cheapest repair, probed once and reused batch-wide.

    ``strategy``:
    - ``"rs"``  — classic minimum_to_decode read set, batched decode;
    - ``"lrc"`` — single loss on an lrc codec: read only the lost
      chunk's local group, recover with one (1, L) GF(2^8) apply;
    - ``"clay"``— single loss on a clay codec: read only the repair
      planes (1/q of the bytes) of the d helpers, recover with one
      (sub_chunk_no, d*P) GF(2^8) apply.
    """
    strategy: str
    read_set: tuple[int, ...]
    planes: tuple[int, ...] = ()
    matrix: np.ndarray | None = field(default=None, compare=False)
    sub_chunk_no: int = 0

    def read_fraction(self, k: int) -> float:
        """Survivor bytes read per shard_len, relative to the k whole
        chunks the whole-chunk baseline reads."""
        if self.strategy == "clay" and self.sub_chunk_no:
            return (len(self.read_set) * len(self.planes)
                    / self.sub_chunk_no) / k
        return len(self.read_set) / k


# Bounded module-level plan memo: keyed by (codec signature, lost set,
# avail set) so a 1000-object drain — or the per-object fallback loop —
# computes minimum_to_decode / probes the repair operator exactly once.
_PLAN_CACHE: OrderedDict[tuple, RepairPlan] = OrderedDict()
_PLAN_CACHE_CAP = 512


def clear_plan_cache() -> None:
    """Test hook: drop every memoized plan."""
    _PLAN_CACHE.clear()


def plan_repair(ec, lost, avail, perf: PerfCounters | None = None
                ) -> RepairPlan:
    """Select and memoize the cheapest repair for (codec, lost, avail).

    Single-loss repairs on locality/regenerating codecs use the probed
    repair operators (group-local / helper sub-chunk reads); anything
    the operators cannot serve — multi-chunk loss, helpers unavailable,
    probe failure — falls back to the plain-RS ``minimum_to_decode``
    read set.  Raises IOError (from the codec) when the loss is beyond
    repair, which is never cached.
    """
    lost_t = tuple(sorted(int(x) for x in lost))
    avail_t = tuple(sorted(int(x) for x in avail))
    key = ("plan", repair_codec_sig(ec), lost_t, avail_t)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        _PLAN_CACHE.move_to_end(key)
        if perf is not None:
            perf.inc("ec_repair_plan_hits")
        return hit
    plan = _probe_plan(ec, lost_t, avail_t)
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > _PLAN_CACHE_CAP:
        _PLAN_CACHE.popitem(last=False)
    if perf is not None:
        perf.inc("ec_repair_plan_misses")
    return plan


def minimum_to_decode_cached(ec, lost, avail,
                             perf: PerfCounters | None = None) -> list:
    """Memoized verbatim ``ec.minimum_to_decode(lost, avail)``.

    The per-object recovery/reconstruct loops re-derive the read set
    for every object of a drain even though it depends only on (codec,
    lost set, avail set); this caches the plugin's exact answer under
    the same bounded store the strategy plans use.  The caller's
    retry-on-dead-read-set loop stays intact: a shrinking avail set is
    a NEW key, and codec failures (IOError) propagate uncached."""
    lost_t = tuple(sorted(int(x) for x in lost))
    avail_t = tuple(sorted(int(x) for x in avail))
    key = ("min", repair_codec_sig(ec), lost_t, avail_t)
    hit = _PLAN_CACHE.get(key)
    if hit is None:
        hit = ec.minimum_to_decode(list(lost), list(avail))
        _PLAN_CACHE[key] = hit
        while len(_PLAN_CACHE) > _PLAN_CACHE_CAP:
            _PLAN_CACHE.popitem(last=False)
        if perf is not None:
            perf.inc("ec_repair_plan_misses")
    else:
        _PLAN_CACHE.move_to_end(key)
        if perf is not None:
            perf.inc("ec_repair_plan_hits")
    # verbatim plugin answer, shallow-copied so callers can't mutate
    # the memo (jerasure-style plugins return a list, jax_rs a dict of
    # shard -> read ranges)
    return dict(hit) if isinstance(hit, dict) else list(hit)


def _probe_plan(ec, lost_t: tuple, avail_t: tuple) -> RepairPlan:
    avail_set = set(avail_t)
    is_clay = hasattr(ec, "sub_chunk_no") and hasattr(ec, "q")
    is_lrc = hasattr(ec, "layers")
    if len(lost_t) == 1 and (is_clay or is_lrc):
        try:
            if is_clay:
                from ceph_tpu_torch.ec.repair_operator import \
                    clay_repair_operator
                R, helpers, planes = clay_repair_operator(ec, lost_t[0])
                if all(h in avail_set for h in helpers):
                    return RepairPlan("clay", tuple(helpers),
                                      tuple(planes), R,
                                      int(ec.sub_chunk_no))
            else:
                from ceph_tpu_torch.ec.repair_operator import \
                    lrc_repair_operator
                coeffs, minimum = lrc_repair_operator(ec, lost_t[0])
                if all(h in avail_set for h in minimum):
                    return RepairPlan("lrc", tuple(minimum), (),
                                      np.asarray(coeffs, np.uint8))
        except Exception:
            # operator probe failed (profile it can't serve, helper
            # outside avail, ...): the plain read set still repairs
            pass
    need = ec.minimum_to_decode(list(lost_t), list(avail_t))
    return RepairPlan("rs", tuple(sorted(int(s) for s in need)))


class RepairScheduler:
    """Per-OSD batched repair engine.

    ``drain`` takes a PG's rebuild map (oid -> lost shard positions)
    and pushes it through ``backend.recover_batch`` in lost-pattern
    groups of at most ``max_batch_objects``, pacing each batch through
    the mClock ``recovery`` class at batch cost.  Objects the batch
    path cannot serve (metadata probe failure, stray-only sources,
    short batches below ``min_batch_objects``) are left to the classic
    per-object path — the engine is an accelerator, never the only way
    home.
    """

    def __init__(self, perf: PerfCounters, tracer=None,
                 op_scheduler=None, use_mclock: bool = False,
                 max_batch_objects: int = 64,
                 min_batch_objects: int = 2, journal=None):
        register_repair_counters(perf)
        self.perf = perf
        self.tracer = tracer
        self.journal = journal
        self.op_scheduler = op_scheduler
        self.use_mclock = bool(use_mclock)
        self.max_batch_objects = max(1, int(max_batch_objects))
        self.min_batch_objects = max(1, int(min_batch_objects))
        # lifetime engine stats (the asok `ec repair stats` payload;
        # the perf counters aggregate the same signals daemon-wide)
        self.stats_by_strategy: dict[str, int] = {}
        self.batches = 0
        self.objects = 0
        self.demoted = 0

    def stats(self) -> dict:
        return {
            "batches": self.batches,
            "objects": self.objects,
            "demoted": self.demoted,
            "by_strategy": dict(self.stats_by_strategy),
            "max_batch_objects": self.max_batch_objects,
            "read_bytes": self.perf.value("ec_repair_read_bytes"),
            "read_bytes_saved":
                self.perf.value("ec_repair_read_bytes_saved"),
            "rebuild_bytes": self.perf.value("ec_repair_rebuild_bytes"),
            "plan_hits": self.perf.value("ec_repair_plan_hits"),
            "plan_misses": self.perf.value("ec_repair_plan_misses"),
        }

    async def drain(self, backend, rebuild: dict,
                    versions: dict | None = None, *,
                    clazz: str = "recovery",
                    stats: dict | None = None) -> set[str]:
        """Drain ``rebuild`` (oid -> lost shards) through batched
        launches; returns the set of object names rebuilt.  Names not
        returned were demoted and still need the per-object path.

        ``clazz`` selects the mClock pacing class — failure repair
        drains as ``recovery``, the backfill engine reuses this exact
        machinery as ``backfill`` (planned motion, own AIMD position).
        When ``stats`` is given, per-call totals accumulate into it
        ({"batches", "objects", "bytes"}) so the caller can attribute
        its own share without racing other concurrent drains on the
        daemon-wide perf counters."""
        versions = versions or {}
        groups: dict[tuple[int, ...], list[str]] = {}
        for name, shards in rebuild.items():
            groups.setdefault(
                tuple(sorted(int(s) for s in shards)), []
            ).append(name)
        recovered: set[str] = set()
        for lost_t, names in sorted(groups.items()):
            if len(names) < self.min_batch_objects:
                continue          # classic path: a batch of 1 gains nothing
            names.sort()
            for i in range(0, len(names), self.max_batch_objects):
                chunk = names[i:i + self.max_batch_objects]
                # recovery-class pacing at batch cost: the engine is
                # charged one recovery op per OBJECT, exactly like the
                # per-object loop it replaces
                if self.use_mclock and self.op_scheduler is not None:
                    await self.op_scheduler.acquire(
                        clazz, cost=len(chunk))
                try:
                    res = await backend.recover_batch(
                        chunk, list(lost_t), versions)
                except Exception:
                    # engine failure demotes the whole chunk to the
                    # per-object path (which retries, pulls strays, ..)
                    self.demoted += len(chunk)
                    self.perf.inc("ec_repair_demoted", len(chunk))
                    continue
                done = set(res.get("recovered", ()))
                recovered |= done
                demoted = len(chunk) - len(done)
                self.batches += int(res.get("batches", 0))
                self.objects += len(done)
                self.demoted += demoted
                if stats is not None:
                    stats["batches"] = (stats.get("batches", 0)
                                        + int(res.get("batches", 0)))
                    stats["objects"] = stats.get("objects", 0) + len(done)
                    stats["bytes"] = (stats.get("bytes", 0)
                                      + int(res.get("bytes", 0)))
                if demoted:
                    self.perf.inc("ec_repair_demoted", demoted)
                strat = res.get("strategy")
                if strat:
                    self.stats_by_strategy[strat] = (
                        self.stats_by_strategy.get(strat, 0) + len(done)
                    )
                if self.journal is not None:
                    self.journal.emit(
                        "repair.batch_drain", strategy=strat or "?",
                        objects=len(done), demoted=demoted,
                        lost=list(lost_t), clazz=clazz)
                # let client ops interleave between batches even when
                # mClock pacing is off
                await asyncio.sleep(0)
        return recovered
