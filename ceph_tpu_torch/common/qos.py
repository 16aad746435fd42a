"""QoS defense plane: the controller core that closes the SLO loop.

Counterpart of ceph_tpu/common/qos.py: the same module over the
port's imports.

The SLO engine (common/slo.py) *detects* burn; nothing before this
module fought back.  Three actuator families turn the burn-rate signal
into defenses, actuating the client/recovery interference pair of
arxiv 1709.05365 (online-EC recovery I/O directly inflates client tail
latency) under the degraded-EC regime arxiv 1906.08602 grades:

- :class:`AIMDController` — additive-increase / multiplicative-decrease
  of the recovery-class mClock limit.  While client latency objectives
  burn, the recovery share backs off multiplicatively (classic
  congestion response: interference is a shared-resource congestion
  signal); when the burn clears it ramps back additively.  The backoff
  never drops below a pacing floor derived from
  ``slo_rebuild_floor_gibs`` — starving rebuild stretches the degraded
  window, which is its own SLO violation.
- :func:`derive_hedge_timeout` — quantile-adaptive hedged reads: each
  OSD's EC hedge timeout tracks a configured quantile (default p95) of
  its own windowed shard-read latency histogram instead of a static
  conf value, with min/max clamps and a widening term when the
  ``hedge_lost`` feedback says hedges fire early and lose the race.
- :class:`TokenBucket` — per-session admission control for the RGW
  front door (rgw_http.py): overload sheds with ``503 Slow Down``
  before OSD queues melt.

Everything here is deterministic: a decision is a pure function of the
evaluation sequence and prior controller state (no wall-clock, no
randomness), so the same seed replays the same retune/shed sequence
through the flight recorder.

:class:`QoSController` composes the pieces into one per-tick decision
the mgr module (services/mgr_qos.py) fans out cluster-wide.
"""

from __future__ import annotations

from ceph_tpu_torch.common.perf import hist_quantile
from ceph_tpu_torch.common.slo import SnapshotWindow

# re-push / re-journal an adaptive hedge timeout only when it moved by
# more than this relative amount: the quantile estimate jitters a few
# percent tick to tick and spamming identical retunes would bury the
# flight recorder
HEDGE_REL_TOL = 0.2
# hedge feedback: if more than this fraction of the window's hedges
# LOST the race (the straggler beat reconstruction), the timeout is
# firing too early — widen it
HEDGE_LOSS_FRAC = 0.5
HEDGE_WIDEN = 2.0


class AIMDController:
    """Additive-increase / multiplicative-decrease value controller
    with raise/clear hysteresis (mirrors ``slo_raise/clear_evals``).

    ``step(burning)`` feeds one evaluation; after ``raise_evals``
    consecutive burning evals the value backs off by ``backoff`` on
    every further burning eval (sustained pressure keeps shrinking it
    toward the floor); after ``clear_evals`` consecutive clean evals it
    ramps by ``ramp`` per eval back toward the ceiling.  A lone noisy
    eval in either direction only resets the opposite streak — no
    flapping."""

    def __init__(self, initial: float, floor: float, ceiling: float,
                 backoff: float = 0.5, ramp: float = 16.0,
                 raise_evals: int = 2, clear_evals: int = 2):
        self.floor = max(0.0, float(floor))
        self.ceiling = max(self.floor, float(ceiling))
        self.value = min(self.ceiling, max(self.floor, float(initial)))
        self.backoff = float(backoff)
        self.ramp = float(ramp)
        self.raise_evals = max(1, int(raise_evals))
        self.clear_evals = max(1, int(clear_evals))
        self._bad = 0
        self._good = 0

    def step(self, burning: bool) -> float | None:
        """One evaluation. Returns the new value when it changed,
        else None."""
        prev = self.value
        if burning:
            self._good = 0
            self._bad += 1
            if self._bad >= self.raise_evals:
                self.value = max(self.floor, self.value * self.backoff)
        else:
            self._bad = 0
            self._good += 1
            if self._good >= self.clear_evals:
                self.value = min(self.ceiling, self.value + self.ramp)
        return self.value if self.value != prev else None


def derive_hedge_timeout(hist: dict, quantile: float,
                         min_s: float, max_s: float, *,
                         hedges_issued: float = 0.0,
                         hedges_lost: float = 0.0,
                         min_samples: int = 16) -> float | None:
    """Adaptive EC hedge timeout (seconds) from one daemon's windowed
    shard-read latency histogram (``ec_shard_read_us``).

    Returns None when no retune should happen: adaptive hedging is off
    (``quantile <= 0``) or the window holds fewer than ``min_samples``
    reads (a thin histogram's quantile is noise — the last pushed
    value stays in force).  When the window's hedge feedback says most
    hedges fired and then LOST the race to the straggler, the timeout
    was too aggressive and the derived value widens before clamping."""
    if quantile <= 0.0:
        return None
    if int(hist.get("count") or 0) < max(1, int(min_samples)):
        return None
    q_us = hist_quantile(hist, quantile)
    if q_us is None:
        return None
    t = q_us / 1e6
    if hedges_issued > 0 and hedges_lost / hedges_issued > HEDGE_LOSS_FRAC:
        t *= HEDGE_WIDEN
    return min(max_s, max(min_s, t))


class TokenBucket:
    """Deterministic token bucket: ``rate`` tokens/s refill up to
    ``burst`` capacity.  The caller supplies the clock reading (the
    RGW frontend passes the event-loop time), so the bucket itself has
    no wall-clock dependence."""

    def __init__(self, rate: float, burst: float, now: float = 0.0):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._last = float(now)

    def take(self, now: float, n: float = 1.0) -> bool:
        """Refill to ``now`` then try to spend ``n`` tokens."""
        if now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
            self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available."""
        if self.rate <= 0:
            return 1.0
        return max(0.0, (n - self.tokens) / self.rate)


class QoSController:
    """One closed-loop tick: SLO evaluations + the shared snapshot
    window in, actuator decisions out.

    Decisions are pure functions of the inputs and prior controller
    state — the mgr module journals each one into the flight recorder,
    so identical load (same seed) replays an identical retune
    sequence."""

    def __init__(self, *, recovery_res: float, recovery_max_ops: float,
                 recovery_min_ops: float, recovery_min_share: float,
                 rebuild_floor_gibs: float, gib_per_op: float,
                 backoff: float, ramp_ops: float,
                 raise_evals: int, clear_evals: int,
                 hedge_quantile: float, hedge_min_s: float,
                 hedge_max_s: float, hedge_min_samples: int,
                 backfill_res: float = 5.0,
                 backfill_max_ops: float = 128.0,
                 backfill_min_ops: float = 2.0,
                 backfill_min_share: float = 0.02,
                 scrub_res: float = 1.0,
                 scrub_max_ops: float = 64.0,
                 scrub_min_ops: float = 1.0,
                 scrub_min_share: float = 0.01,
                 replication_max_ops: float = 64.0,
                 replication_min_ops: float = 2.0,
                 replication_min_share: float = 0.05):
        # the pacing floor: never throttle recovery below the largest
        # of (absolute ops floor, share-of-ceiling floor, the ops rate
        # that sustains slo_rebuild_floor_gibs at the assumed GiB/op)
        floor = max(recovery_min_ops,
                    recovery_min_share * recovery_max_ops,
                    (rebuild_floor_gibs / max(gib_per_op, 1e-9))
                    if rebuild_floor_gibs > 0 else 0.0)
        self.recovery = AIMDController(
            initial=recovery_max_ops, floor=floor,
            ceiling=recovery_max_ops, backoff=backoff, ramp=ramp_ops,
            raise_evals=raise_evals, clear_evals=clear_evals)
        self.recovery_res = float(recovery_res)
        # backfill (planned motion) is a SECOND AIMD position driven by
        # the SAME burn signal but with its own floor/ceiling: during
        # rebalance every object still has full redundancy, so there is
        # no rebuild-GiB floor term and backfill may be squeezed much
        # harder than failure recovery before the controller relents
        bf_floor = max(backfill_min_ops,
                       backfill_min_share * backfill_max_ops)
        self.backfill = AIMDController(
            initial=backfill_max_ops, floor=bf_floor,
            ceiling=backfill_max_ops, backoff=backoff, ramp=ramp_ops,
            raise_evals=raise_evals, clear_evals=clear_evals)
        self.backfill_res = float(backfill_res)
        # scrub (verification of data already fully redundant) is the
        # THIRD AIMD position: like backfill it has no rebuild-GiB
        # floor, and its share floor sits lower still — of the three
        # background classes, doubt drains last when clients burn.
        # The daemon additionally PAUSES in-flight sweeps on the
        # burning flag; this position governs the dispatch rate of the
        # sweeps that do run.
        sc_floor = max(scrub_min_ops, scrub_min_share * scrub_max_ops)
        self.scrub = AIMDController(
            initial=scrub_max_ops, floor=sc_floor,
            ceiling=scrub_max_ops, backoff=backoff, ramp=ramp_ops,
            raise_evals=raise_evals, clear_evals=clear_evals)
        self.scrub_res = float(scrub_res)
        # geo-replication (multisite sync throughput) is the FOURTH
        # AIMD position: it is not an mClock class — the decision is
        # actuated as a token-bucket rate on the secondary's sync
        # agents — but it rides the same burn signal and hysteresis.
        # Its floor IS the RPO bound: however hard clients burn, the
        # replication backlog drains at least this fast, so
        # unreplicated bytes cannot grow without limit.
        rp_floor = max(replication_min_ops,
                       replication_min_share * replication_max_ops)
        self.replication = AIMDController(
            initial=replication_max_ops, floor=rp_floor,
            ceiling=replication_max_ops, backoff=backoff,
            ramp=ramp_ops, raise_evals=raise_evals,
            clear_evals=clear_evals)
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_min_s = float(hedge_min_s)
        self.hedge_max_s = float(hedge_max_s)
        self.hedge_min_samples = int(hedge_min_samples)
        self._hedge_last: dict[str, float] = {}
        self.ticks = 0
        self.retunes = 0

    @classmethod
    def from_conf(cls, conf) -> "QoSController":
        return cls(
            recovery_res=float(conf["osd_mclock_recovery_res"]),
            recovery_max_ops=float(conf["qos_recovery_max_ops"]),
            recovery_min_ops=float(conf["qos_recovery_min_ops"]),
            recovery_min_share=float(conf["qos_recovery_min_share"]),
            rebuild_floor_gibs=float(conf["slo_rebuild_floor_gibs"]),
            gib_per_op=float(conf["qos_recovery_gib_per_op"]),
            backoff=float(conf["qos_backoff"]),
            ramp_ops=float(conf["qos_ramp_ops"]),
            raise_evals=int(conf["slo_raise_evals"]),
            clear_evals=int(conf["slo_clear_evals"]),
            hedge_quantile=float(conf["qos_hedge_quantile"]),
            hedge_min_s=float(conf["qos_hedge_min_ms"]) / 1e3,
            hedge_max_s=float(conf["qos_hedge_max_ms"]) / 1e3,
            hedge_min_samples=int(conf["qos_hedge_min_samples"]),
            backfill_res=float(conf["osd_mclock_backfill_res"]),
            backfill_max_ops=float(conf["qos_backfill_max_ops"]),
            backfill_min_ops=float(conf["qos_backfill_min_ops"]),
            backfill_min_share=float(conf["qos_backfill_min_share"]),
            scrub_res=float(conf["osd_mclock_scrub_res"]),
            scrub_max_ops=float(conf["qos_scrub_max_ops"]),
            scrub_min_ops=float(conf["qos_scrub_min_ops"]),
            scrub_min_share=float(conf["qos_scrub_min_share"]),
            replication_max_ops=float(
                conf["qos_replication_max_ops"]),
            replication_min_ops=float(
                conf["qos_replication_min_ops"]),
            replication_min_share=float(
                conf["qos_replication_min_share"]),
        )

    @staticmethod
    def latency_burn(evals: list[dict]) -> float:
        """Worst client-latency burn rate in one evaluation pass (the
        rebuild floor is an objective the controller PROTECTS, not a
        congestion signal to back recovery off for)."""
        worst = 0.0
        for rec in evals:
            obj = str(rec.get("objective", ""))
            if obj.endswith("_ms"):
                worst = max(worst, float(rec.get("burn_rate", 0.0)))
        return worst

    def tick(self, evals: list[dict],
             win: SnapshotWindow) -> dict:
        """One controller evaluation.  Returns::

            {"burning": bool, "burn": float,
             "recovery":    {"limit", "reservation", "floor", "changed"},
             "backfill":    {"limit", "reservation", "floor", "changed"},
             "scrub":       {"limit", "reservation", "floor", "changed"},
             "replication": {"limit", "reservation", "floor", "changed"},
             "hedge": {daemon: timeout_s}}   # only entries that moved

        ``hedge`` keys are daemon names (``osd.N``); an entry appears
        only when the derived timeout moved more than HEDGE_REL_TOL
        from the last pushed value."""
        self.ticks += 1
        burn = self.latency_burn(evals)
        burning = burn > 1.0
        new_limit = self.recovery.step(burning)
        limit = self.recovery.value
        rec = {
            "limit": limit,
            # the reservation (guaranteed ops/s) tracks the limit down
            # so phase-1 dispatch cannot grant above the cap
            "reservation": min(self.recovery_res, limit),
            "floor": self.recovery.floor,
            "changed": new_limit is not None,
        }
        if new_limit is not None:
            self.retunes += 1
        new_bf = self.backfill.step(burning)
        bf = {
            "limit": self.backfill.value,
            "reservation": min(self.backfill_res, self.backfill.value),
            "floor": self.backfill.floor,
            "changed": new_bf is not None,
        }
        if new_bf is not None:
            self.retunes += 1
        new_sc = self.scrub.step(burning)
        sc = {
            "limit": self.scrub.value,
            "reservation": min(self.scrub_res, self.scrub.value),
            "floor": self.scrub.floor,
            "changed": new_sc is not None,
        }
        if new_sc is not None:
            self.retunes += 1
        new_rp = self.replication.step(burning)
        rp = {
            "limit": self.replication.value,
            # the agents actuate a plain rate limit, not an mClock
            # (reservation, limit) pair — reservation mirrors the
            # limit for the journal's uniform retune shape
            "reservation": self.replication.value,
            "floor": self.replication.floor,
            "changed": new_rp is not None,
        }
        if new_rp is not None:
            self.retunes += 1

        hedge: dict[str, float] = {}
        if self.hedge_quantile > 0.0:
            _, per_hist = win.hist("ec_shard_read_us")
            _, per_issued = win.scalar("hedge_issued")
            _, per_lost = win.scalar("hedge_lost")
            for daemon in sorted(per_hist):
                t = derive_hedge_timeout(
                    per_hist[daemon], self.hedge_quantile,
                    self.hedge_min_s, self.hedge_max_s,
                    hedges_issued=per_issued.get(daemon, 0.0),
                    hedges_lost=per_lost.get(daemon, 0.0),
                    min_samples=self.hedge_min_samples)
                if t is None:
                    continue
                last = self._hedge_last.get(daemon)
                if last is not None and abs(t - last) <= \
                        HEDGE_REL_TOL * last:
                    continue
                self._hedge_last[daemon] = t
                hedge[daemon] = t

        return {"burning": burning, "burn": burn, "recovery": rec,
                "backfill": bf, "scrub": sc, "replication": rp,
                "hedge": hedge}

    def state(self) -> dict:
        """Controller state snapshot (digest / forensic bundles)."""
        return {
            "ticks": self.ticks,
            "retunes": self.retunes,
            "recovery_limit": round(self.recovery.value, 3),
            "recovery_floor": round(self.recovery.floor, 3),
            "recovery_ceiling": round(self.recovery.ceiling, 3),
            "backfill_limit": round(self.backfill.value, 3),
            "backfill_floor": round(self.backfill.floor, 3),
            "backfill_ceiling": round(self.backfill.ceiling, 3),
            "scrub_limit": round(self.scrub.value, 3),
            "scrub_floor": round(self.scrub.floor, 3),
            "scrub_ceiling": round(self.scrub.ceiling, 3),
            "replication_limit": round(self.replication.value, 3),
            "replication_floor": round(self.replication.floor, 3),
            "replication_ceiling": round(
                self.replication.ceiling, 3),
            "hedge_timeouts_ms": {
                d: round(t * 1e3, 3)
                for d, t in sorted(self._hedge_last.items())},
        }
