"""The port's SLO, QoS and TSDB engines against the JAX package's, on an
explicit clock.

Every engine of the manager's slice takes its time as an argument:
``SLOEngine.observe(t, ...)``, ``MultiWindowBurn.observe/evaluate(t)``,
``QoSController.tick`` over the engine's window, ``TokenBucket(now=)`` and
the ``TSDB``.  Each test feeds both packages the same seeded sequence
(numpy ``default_rng``) of cumulative per-daemon perf dumps, a quiet phase,
a storm and a recovery, and requires every output to be equal at tolerance
0: evaluations, health checks, gauges, burn rates, QoS decisions and
``state()``, TSDB series and their downsampled tiers.  The mgr's SLO, QoS
and TSDB modules run the same way on a stand-in mgr whose clock the test
sets (``time`` patched in the two modules that read it) and whose
``collect()`` returns the seeded dumps; their digest sections, health
checks, Prometheus families, journal events and the pushes to the OSDs must
be equal, and so must ``Mgr.prometheus_text`` of the result.  No wall clock
is read anywhere.
"""

import asyncio
import copy
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _pkg(root):
    return SimpleNamespace(
        root=root, perf=_mod(root, "common.perf"),
        slo=_mod(root, "common.slo"), qos=_mod(root, "common.qos"),
        tsdb=_mod(root, "common.tsdb"), events=_mod(root, "common.events"),
        config=_mod(root, "common.config"),
        mgr=_mod(root, "services.mgr"),
        mgr_slo=_mod(root, "services.mgr_slo"),
        mgr_qos=_mod(root, "services.mgr_qos"),
        mgr_tsdb=_mod(root, "services.mgr_tsdb"))


PKGS = {name: _pkg(name) for name in PKG_NAMES}
SEEDS = [0, 1, 2, 7]

HISTS = ("op_w_latency_us", "op_r_latency_us", "op_latency_us",
         "ec_encode_launch_us", "ec_decode_launch_us",
         "ec_coalesce_wait_hist_us", "ec_shard_read_us",
         "op_class_gold_latency_us", "op_class_bronze_latency_us")
SCALARS = ("op", "op_error", "ec_launch_bytes", "ec_repair_rebuild_bytes",
           "ec_resident_hits", "ec_resident_misses", "hedge_issued",
           "hedge_lost", "tracer_ring_evictions", "tracer_orphan_spans")
DAEMONS = ("osd.0", "osd.1", "osd.2", "osd.3")
STEP_S = 0.5


def _events(seed, steps=24):
    """The seeded increments, step by step and daemon by daemon: quiet for
    the first third, a storm on one daemon (slow writes, errors, hedges,
    a rebuild) in the middle third, quiet again after."""
    rng = np.random.default_rng(seed)
    victim = DAEMONS[int(rng.integers(len(DAEMONS)))]
    out = []
    for step in range(steps):
        storm = steps // 3 <= step < 2 * steps // 3
        per = {}
        for d in DAEMONS:
            hot = storm and (d == victim or rng.random() < 0.3)
            scale = 60_000.0 if hot else 1_500.0
            n = int(rng.integers(8, 40))
            ev = {"hist": {}, "scalar": {}, "avg": []}
            for key in HISTS:
                k = n if key.startswith(("op_", "ec_shard")) else \
                    int(rng.integers(0, 12))
                ev["hist"][key] = (rng.lognormal(0.0, 0.8, k)
                                   * scale).round(3).tolist()
            ev["scalar"]["op"] = n
            ev["scalar"]["op_error"] = int(rng.integers(0, 4)) if hot \
                else 0
            ev["scalar"]["ec_launch_bytes"] = int(rng.integers(1, 64)) << 20
            ev["scalar"]["ec_repair_rebuild_bytes"] = \
                int(rng.integers(0, 8)) << 20 if storm else 0
            ev["scalar"]["ec_resident_hits"] = int(rng.integers(0, 30))
            ev["scalar"]["ec_resident_misses"] = int(rng.integers(0, 10))
            ev["scalar"]["hedge_issued"] = int(rng.integers(0, 6)) if hot \
                else 0
            ev["scalar"]["hedge_lost"] = int(rng.integers(0, 3)) if hot \
                else 0
            ev["scalar"]["tracer_ring_evictions"] = int(rng.integers(0, 3))
            ev["scalar"]["tracer_orphan_spans"] = int(rng.integers(0, 2))
            ev["avg"] = rng.uniform(1.0, 8.0, int(rng.integers(1, 6))) \
                .round(3).tolist()
            ev["kernel"] = (int(rng.integers(1, 9)),
                            round(float(rng.uniform(20.0, 400.0)), 3))
            per[d] = ev
        degraded = int(rng.integers(1, 50)) if storm else 0
        out.append((step * STEP_S, per, degraded))
    return out


def _dumps(p, events):
    """Cumulative per-daemon perf dumps, made by the package's own
    PerfCounters from the seeded increments (plus the kernel profile's
    nested section, which the TSDB module harvests)."""
    ct = p.perf.CounterType
    counters, kernels, seq = {}, {}, []
    for d in DAEMONS:
        pc = counters[d] = p.perf.PerfCounters(d)
        for key in HISTS:
            pc.add(key, ct.HISTOGRAM)
        for key in SCALARS:
            pc.add(key)
        pc.add("ec_coalesce_occupancy", ct.LONGRUNAVG)
        kernels[d] = {"launches": 0, "stripes": 0, "wall_us": 0.0,
                      "hbm_bytes": 0}
    for t, per, degraded in events:
        snap = {}
        for d, ev in per.items():
            pc = counters[d]
            for key, samples in ev["hist"].items():
                for s in samples:
                    pc.hinc(key, s)
            for key, by in ev["scalar"].items():
                pc.inc(key, by)
            for occ in ev["avg"]:
                pc.tinc("ec_coalesce_occupancy", occ)
            launches, wall = ev["kernel"]
            k = kernels[d]
            k["launches"] += launches
            k["stripes"] += launches * 4096
            k["wall_us"] = round(k["wall_us"] + wall, 3)
            k["hbm_bytes"] += launches * (12 << 20)
            dump = pc.dump()
            dump["ec_kernels"] = {"jax_rs:8+4": dict(k)}
            snap[d] = dump
        seq.append((t, copy.deepcopy(snap), degraded))
    return seq


CONF = {
    "slo_put_p99_ms": 20.0, "slo_get_p999_ms": 80.0,
    "slo_error_rate": 0.01, "slo_rebuild_floor_gibs": 0.05,
    "slo_targets": "op_p50_ms=5,put_p9999_ms=60", "slo_window": 2.0,
    "slo_raise_evals": 2, "slo_clear_evals": 2,
    "slo_class_labels": "gold,bronze", "slo_burn_fast_s": 2.0,
    "slo_burn_slow_s": 6.0, "qos_enable": True,
    "qos_hedge_min_samples": 4, "tsdb_raw_points": 8,
    "tsdb_minute_points": 6, "tsdb_hour_points": 4, "tsdb_tier1_s": 2.0,
    "tsdb_tier2_s": 6.0, "tsdb_digest_points": 5,
    # the two packages' defaults differ (the H100's 3120 and the TPU's
    # 763): every comparison sets it
    "ec_hbm_peak_gibps": 1000.0,
}


def _conf(p, **over):
    return p.config.ConfigProxy(overrides={**CONF, **over})


def _equal_across(fn):
    out = {name: fn(p) for name, p in PKGS.items()}
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]
    return out["ceph_tpu"]


# -- SLOEngine ---------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_engine_equal_on_a_seeded_storm(seed):
    events = _events(seed)

    def run(p):
        eng = p.slo.SLOEngine(p.slo.targets_from_conf(_conf(p)),
                              window=2.0, raise_evals=2, clear_evals=2)
        rows = []
        for t, snap, degraded in _dumps(p, events):
            eng.observe(t, snap)
            win = eng.snapshot_window()
            evals = eng.evaluate(recovery_active=degraded > 0)
            rows.append({
                "span": eng.window_span(), "evals": evals,
                "health": eng.health_checks(), "gauges": eng.gauges(),
                "active": sorted(eng.active),
                "put": win.hist("op_w_latency_us"),
                "occupancy": win.pair("ec_coalesce_occupancy"),
                "bytes": win.scalar("ec_launch_bytes"),
                "class_burn": p.slo.class_burn(
                    win.hist("op_class_gold_latency_us")[0], eng.targets),
            })
        return rows

    rows = _equal_across(run)
    # the storm raised SLO_VIOLATION and the recovery cleared it
    raised = [bool(r["health"]) for r in rows]
    assert any(raised) and not raised[-1]


# -- MultiWindowBurn ---------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_multiwindow_burn_equal_on_a_seeded_burn_sequence(seed):
    rng = np.random.default_rng(seed)
    samples = []
    t = 0.0
    for i in range(60):
        t += float(rng.uniform(30.0, 240.0))
        hot = 15 <= i < 35
        for clazz in ("gold", "bronze", "silver"):
            if rng.random() < 0.8:
                burn = float(rng.uniform(2.0, 40.0)) if hot and \
                    clazz != "silver" else float(rng.uniform(0.0, 0.9))
                samples.append((round(t, 3), clazz, round(burn, 4)))

    def run(p):
        mw = p.slo.MultiWindowBurn(fast_s=300.0, slow_s=3600.0,
                                   raise_evals=2, clear_evals=2)
        rows = []
        for t, clazz, burn in samples:
            mw.observe(t, clazz, burn)
            rows.append((mw.evaluate(t), mw.worst(),
                         copy.deepcopy(mw.active)))
        return rows

    rows = _equal_across(run)
    assert any(w is not None for _, w, _ in rows)


# -- QoS: AIMD, hedge derivation, controller, token bucket --------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_qos_controller_equal_on_a_seeded_storm(seed):
    events = _events(seed)

    def run(p):
        conf = _conf(p)
        eng = p.slo.SLOEngine(p.slo.targets_from_conf(conf), window=2.0,
                              raise_evals=1, clear_evals=1)
        ctrl = p.qos.QoSController.from_conf(conf)
        rows = []
        for t, snap, degraded in _dumps(p, events):
            eng.observe(t, snap)
            evals = eng.evaluate(recovery_active=degraded > 0)
            rows.append((p.qos.QoSController.latency_burn(evals),
                         ctrl.tick(evals, eng.snapshot_window()),
                         ctrl.state()))
        return rows

    rows = _equal_across(run)
    limits = [r[2]["recovery_limit"] for r in rows]
    assert min(limits) < limits[0] and rows[-1][2]["retunes"] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_aimd_and_hedge_timeout_equal(seed):
    rng = np.random.default_rng(seed)
    burning = (rng.random(80) < 0.4).tolist()
    hists = [(rng.lognormal(0.0, 1.0, int(rng.integers(0, 64)))
              * 4000.0).round(2).tolist() for _ in range(20)]
    feedback = rng.integers(0, 20, (20, 2)).tolist()

    def run(p):
        a = p.qos.AIMDController(initial=200.0, floor=12.0, ceiling=256.0,
                                 backoff=0.5, ramp=16.0, raise_evals=2,
                                 clear_evals=3)
        steps = [(a.step(b), a.value) for b in burning]
        timeouts = []
        for samples, (issued, lost) in zip(hists, feedback):
            pc = p.perf.PerfCounters("h")
            pc.add("h", p.perf.CounterType.HISTOGRAM)
            for s in samples:
                pc.hinc("h", s)
            for q in (0.0, 0.9, 0.99):
                timeouts.append(p.qos.derive_hedge_timeout(
                    pc.dump()["h"], q, 0.005, 0.25, hedges_issued=issued,
                    hedges_lost=lost, min_samples=8))
        return steps, timeouts

    _equal_across(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_token_bucket_equal_on_an_explicit_clock(seed):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.0, 0.05, 400)).round(6).tolist()
    sizes = rng.choice([0.5, 1.0, 2.0, 4.0], 400).tolist()

    def run(p):
        b = p.qos.TokenBucket(rate=40.0, burst=8.0, now=0.0)
        return [(b.take(t, n), round(b.tokens, 12), b.retry_after(n))
                for t, n in zip(times, sizes)]

    rows = _equal_across(run)
    assert {r[0] for r in rows} == {True, False}


# -- TSDB --------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_tsdb_series_and_downsamples_equal(seed):
    rng = np.random.default_rng(seed)
    names = [f"slo.put_p99_ms.{k}" for k in ("burn", "value")] + \
        [f"util.{k}" for k in ("device_gibps", "roofline_pct")] + \
        ["qos.burn", "class.gold.ops"]
    feed = []
    t = 1000.0
    for _ in range(300):
        t += float(rng.uniform(0.1, 3.0))
        feed.append((round(t, 3), {n: round(float(rng.normal(5.0, 3.0)), 4)
                                   for n in names if rng.random() < 0.9}))
    end = feed[-1][0]
    starts = [None, end - 5.0, end - 30.0, end - 200.0, feed[0][0] - 1.0]

    def run(p):
        db = p.tsdb.TSDB(raw_points=16, m1_points=12, h1_points=6,
                         tier1_s=4.0, tier2_s=20.0, max_series=5)
        for t, values in feed:
            db.observe_many(t, values)
            db.observe(t, "bad", "not a number")
        out = {"names": db.names(), "stats": db.stats(),
               "last": [db.last(n) for n in db.names()],
               "prefix": db.query_prefix("util.", start=end - 60.0)}
        for n in db.names():
            s = db.series[n]
            out[n] = {tier: s.tier_points(tier)
                      for tier in ("raw", "1m", "1h")}
            out[n]["queries"] = [
                db.query(n, start=st, end=end - 1.0, tier=tier,
                         max_points=mp)
                for st in starts for tier in ("auto", "raw", "1m", "1h")
                for mp in (0, 3)]
        aggs = [p.tsdb.agg_new(0.0, 2.0)]
        for v in (5.0, -1.0, 7.5):
            aggs.append(p.tsdb.agg_add(aggs[-1], v))
        out["aggs"] = (aggs, p.tsdb.agg_merge(aggs[1], aggs[3]),
                       p.tsdb.agg_mean(aggs[-1]))
        return out

    out = _equal_across(run)
    assert out["stats"]["dropped_series"] > 0
    assert out["stats"]["evictions"] > 0


# -- the mgr's SLO, QoS and TSDB modules on a stand-in mgr ---------------------


class _Clock:
    """The modules' ``time``: ``monotonic()`` and ``time()`` read the
    test's clock."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now

    def time(self):
        return 1.0e9 + self.now


class _StandInMgr:
    """What the three modules read of a Mgr: conf, modules, journal,
    collect(), last_digest, collect_stats, the OSD map, osd_request and
    maybe_auto_capture (both recorded)."""

    def __init__(self, p, conf):
        self.conf = conf
        self.journal = p.events.EventJournal("mgr.x", size=4096)
        self.collect_stats = {"cycles": 0, "payload_bytes": 0,
                              "last_payload_bytes": 0, "resyncs": 0,
                              "delta": True}
        self.last_digest = None
        self.snapshot = None
        self.requests = []
        self.captures = []
        up = SimpleNamespace(up=True, addr="local://osd")
        self.monc = SimpleNamespace(osdmap=SimpleNamespace(
            osds={i: up for i in range(len(DAEMONS))}))
        self.modules = {m.name: m for m in (
            p.mgr_slo.SLOMonitor(self), p.mgr_qos.QoSMonitor(self),
            p.mgr_tsdb.TSDBMonitor(self))}

    async def collect(self):
        self.collect_stats["cycles"] += 1
        return self.snapshot

    async def osd_request(self, osd, addr, mtype, **data):
        self.requests.append((osd, mtype, copy.deepcopy(data)))
        return {}

    async def maybe_auto_capture(self, reason, worst_daemon="",
                                 detail=None):
        self.captures.append((reason, worst_daemon, detail))
        return None


def _status(health):
    return {"health": {"status": health, "checks": {}},
            "osdmap": {"num_osds": len(DAEMONS), "num_up_osds": len(DAEMONS),
                       "num_in_osds": len(DAEMONS), "num_pools": 1},
            "mon": {"quorum": [0]}}


@pytest.mark.parametrize("seed", SEEDS)
def test_mgr_slo_qos_tsdb_modules_equal_on_an_explicit_clock(seed,
                                                             monkeypatch):
    events = _events(seed)

    def run(p):
        clock = _Clock()
        monkeypatch.setattr(p.mgr_slo, "time", clock)
        monkeypatch.setattr(p.mgr_tsdb, "time", clock)
        mgr = _StandInMgr(p, _conf(p))
        p.events.reset_proc()
        rows = []

        async def cycle(t, snap, degraded):
            clock.now = t
            health = {}
            for mod in mgr.modules.values():
                await mod.serve_once()
                health.update(mod.health_checks())
            digest = {"degraded_objects": degraded}
            if health:
                digest["health_checks"] = health
            for mod in mgr.modules.values():
                digest.update(mod.digest_contrib())
            mgr.last_digest = digest
            extra = {}
            for mod in mgr.modules.values():
                extra.update(mod.prom_metrics())
            text = p.mgr.Mgr.prometheus_text(mgr.snapshot, extra)
            return digest, extra, text

        for t, snap, degraded in _dumps(p, events):
            mgr.snapshot = {
                "status": _status("HEALTH_WARN" if degraded else
                                  "HEALTH_OK"),
                "osds": {i: {"up": True, "in": True}
                         for i in range(len(DAEMONS))},
                "osd_perf": {int(d[4:]): dump for d, dump in snap.items()}}
            rows.append(asyncio.run(cycle(t, snap, degraded)))
        ts = mgr.modules["ts"]
        return {
            "rows": rows,
            "journal": [e[3:] for e in mgr.journal._ring],
            "requests": mgr.requests, "captures": mgr.captures,
            "forensics": {n: m.forensics_contrib()
                          for n, m in mgr.modules.items()
                          if hasattr(m, "forensics_contrib")},
            "ts": ts.query(), "ts_util": ts.query(prefix="util."),
        }

    out = _equal_across(run)
    digests = [d for d, _, _ in out["rows"]]
    assert any("health_checks" in d for d in digests)
    assert digests[-1]["utilization"]["launch_bytes"] > 0
    assert any(mtype == "qos_set" for _, mtype, _ in out["requests"])
    assert out["ts"]["names"]
    text = out["rows"][-1][2]
    for family in ("ceph_slo_burn_rate", "ceph_util_roofline_pct",
                   "ceph_qos_recovery_limit", "ceph_tsdb_series",
                   "ceph_osd_op_w_latency_us_bucket"):
        assert family in text
