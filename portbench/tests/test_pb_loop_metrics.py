"""The readers of the loop monitor and of the spans' on-loop time, on a
hand-built run: what each reads, and nothing where the program has no
monitor or its spans no such field (the parent of this benchmark)."""

import pytest

from ceph_tpu_torch.common import tracing
from portbench import run as bench

MS = 1_000_000
W = 10 * MS


def hand_run(t_open_s=100.0, seconds=0.05, ops=4, spans=()):
    spec = {"cell": {"name": "hand"}, "config": {},
            "workload": {"params": {}}}
    r = bench.Run(spec, 1, seconds, True, "cpu")
    r.t_open, r.t_close = t_open_s, t_open_s + seconds
    r.ops = [("write", t_open_s + 0.001 * i, t_open_s + 0.002 * i + 0.01,
              4 << 20, True, 0) for i in range(ops)]
    r.spans = list(spans)
    return r


@pytest.fixture
def monitor(monkeypatch):
    mon = tracing.LoopMonitor(loop=None)
    monkeypatch.setattr(tracing, "_LAST", mon)
    return mon


def test_loop_busy_and_wait_read_the_window_of_the_monitor(monitor):
    t0 = 100 * 10**9
    # a bucket before the window, five inside, the last half outside
    for i, busy in enumerate([9, 8, 4, 6, 2, 10]):
        b = monitor._bucket(t0 - W + i * W)
        b[1] = busy * MS
        b[4], b[5] = 3 * MS * (i + 1), i + 1
    r = hand_run(seconds=0.045)       # [t0, t0 + 45 ms]
    busy = 8 + 4 + 6 + 2 + 10 * 0.5
    assert bench.reader("loop_busy_pct")(r) == pytest.approx(
        100.0 * busy / 45)
    lag = sum(3 * (i + 1) for i in range(1, 6))
    assert bench.reader("loop_wait_ms")(r) == pytest.approx(
        lag / sum(range(2, 7)))


def test_loop_readers_read_nothing_without_a_monitor_or_window(
        monkeypatch, monitor):
    r = hand_run()
    assert bench.reader("loop_busy_pct")(r) is None      # no bucket
    monitor._bucket(100 * 10**9 + W)[1] = MS
    monitor.evictions = 1                                 # window cut
    assert bench.reader("loop_busy_pct")(r) is None
    assert bench.reader("loop_wait_ms")(r) is None
    monkeypatch.setattr(tracing, "_LAST", None)
    monitor.evictions = 0
    assert bench.reader("loop_busy_pct")(r) is None
    monkeypatch.delattr(tracing, "loop_monitor")          # the parent
    assert bench.reader("loop_wait_ms")(r) is None


def span(name, loop_ms=None, **kw):
    s = {"name": name, "span_id": kw.pop("span_id", name), "parent": "",
         "entity": kw.pop("entity", "osd.0"), "start": 100.0,
         "duration_ms": kw.pop("duration_ms", 5.0)}
    if loop_ms is not None:
        s["loop_ms"] = loop_ms
    s.update(kw)
    return s


def test_span_readers_sum_their_layer_per_op():
    spans = [span("osd:do_op", 10.0), span("osd:do_op", 20.0),
             span("store:commit", 0.75), span("osd:sub_op:write:send", 9.0)]
    r = hand_run(ops=2, spans=spans)
    assert bench.reader("osd_op_loop_ms")(r) == pytest.approx(15.0)


def test_label_readers_sum_their_layer_per_op(monitor):
    """The messengers' and the stores' loop time per op comes from the
    monitor's labels in the window, the edge bucket in proportion."""
    t0 = 100 * 10**9
    for i, by in enumerate([
            {"msgr:send": 4 * MS, "store:commit": 4 * MS},     # before
            {"msgr:send": MS, "msgr:recv": 2 * MS, "gc": 3 * MS},
            {"msgr:dispatch": MS // 2, "store:commit": 3 * MS // 4,
             "store:read": MS // 4, "osd:do_op": 5 * MS},
            {"msgr:recv": 2 * MS, "store:read": MS}]):       # half in
        b = monitor._bucket(t0 - W + i * W)
        b[3] = by
        b[1] = sum(by.values())
    r = hand_run(ops=2, seconds=0.025)
    assert bench.reader("msgr_loop_ms_per_op")(r) == pytest.approx(
        (1 + 2 + 0.5 + 2 * 0.5) / 2)
    assert bench.reader("store_loop_ms_per_op")(r) == pytest.approx(
        (0.75 + 0.25 + 0.5) / 2)


def test_span_readers_read_nothing_without_loop_time(monkeypatch):
    monkeypatch.setattr(tracing, "_LAST", None)
    spans = [span("osd:do_op"), span("msgr:send"), span("store:commit"),
             span("osd:ec:launch", t_ns=5)]
    r = hand_run(spans=spans)
    for name in ("osd_op_loop_ms", "msgr_loop_ms_per_op",
                 "store_loop_ms_per_op", "ec_launch_offdev_ms"):
        assert bench.reader(name)(r) is None


def test_launch_off_device_time_counts_each_launch_once():
    """Three batchmates share one launch (one record each, one start);
    a second launch stands alone; a third, whose result stayed on the
    card, returned before its device work ended: only the overlap of
    the two intervals counts as the card's."""
    shared = dict(t_ns=7, duration_ms=4.0, dev_t_ns=8, dev_ms=1.0)
    spans = [span("osd:ec:launch", span_id=f"a{i}", **shared)
             for i in range(3)]
    spans.append(span("osd:ec:launch", span_id="b", t_ns=9,
                      duration_ms=10.0, dev_t_ns=10, dev_ms=2.0))
    spans.append(span("osd:ec:launch", span_id="c", entity="osd.1",
                      **shared))
    spans.append(span("osd:ec:launch", span_id="d", entity="osd.2",
                      t_ns=0, duration_ms=2.0, dev_t_ns=MS // 2,
                      dev_ms=5.0))
    r = hand_run(spans=spans)
    assert bench.reader("ec_launch_offdev_ms")(r) == pytest.approx(
        (3.0 + 8.0 + 3.0 + 0.5) / 4)


def test_idle_fits_the_profile_clock_and_splits_idle_time(monitor):
    """A profile 3.2 ms off its first guess: the fit finds the offset
    that places every B1 kernel in its launch's device interval, and the
    card's idle time splits by the buckets the loop ran meanwhile."""
    from types import SimpleNamespace

    from portbench import idle

    t0 = 100 * 10**9
    true_off = t0 + 3_200_000
    launch_at = [1, 4, 12, 13, 27, 31]          # ms into the window
    spans, events = [], []
    for i, at in enumerate(launch_at):
        a = t0 + at * MS
        spans.append(span("osd:ec:launch", span_id=f"l{i}", t_ns=a - 50_000,
                          duration_ms=1.0, dev_t_ns=a, dev_ms=0.5))
        ks = a + 300_000 - true_off
        events.append(("void gf2::gf2_words_kernel<WordIO>", ks / 1e9,
                       (ks + 150_000) / 1e9))
        events.append(("Memcpy HtoD", (a - true_off) / 1e9,
                       (a - true_off + 250_000) / 1e9))
    r = hand_run(seconds=0.04, spans=spans)
    r.devtrace = SimpleNamespace(events=events, _t0=t0 / 1e9)
    for k in range(4):
        b = monitor._bucket(t0 + k * W)
        b[1] = W // 2
        b[3] = {"osd:do_op": W // 4, "unspanned:x": W // 4}
    out = idle.analyse(r)
    fit = out["fit"]
    assert fit["placed"] == 1.0 and fit["residual_median_us"] == 0.0
    assert abs(fit["offset_from_guess_us"] - 3200) <= fit["slack_us"] + 1
    assert fit["launch_before_host"] == 0
    busy_ns = 6 * 400_000
    assert out["idle"]["idle_s"] == pytest.approx((40 * MS - busy_ns) / 1e9)
    table = dict((k, s) for k, s, _ in out["idle"]["by_label"])
    assert table["loop idle"] == pytest.approx(out["idle"]["idle_s"] / 2)
    assert table["osd:do_op"] == pytest.approx(out["idle"]["idle_s"] / 4)
    assert out["loop"]["unspanned_share"] == pytest.approx(0.5)


def test_cpu_rehearsal_reads_the_loop_metrics():
    """A traced small write cell on the CPU reports the loop's metrics
    and the spans' on-loop time; the launch's device time is the card's
    alone, so that metric is left out here."""
    from portbench.tests.small import run_small

    result, _ = run_small("rados_ec84.write", trace=True)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    assert {"loop_busy_pct", "loop_wait_ms", "osd_op_loop_ms",
            "msgr_loop_ms_per_op", "store_loop_ms_per_op"} <= set(got)
    assert 0 < got["loop_busy_pct"]["value"] <= 100
    assert "ec_launch_offdev_ms" not in got


@pytest.mark.cuda
def test_write_cell_reads_the_launch_clock_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = bench.load_cell("rados_ec84.write")
    result, _ = bench.run_cell(spec, 2**31 + 9, 3.0, True)
    assert result["correct"], result["checks"]
    assert {"ec_launch_offdev_ms", "loop_busy_pct",
            "osd_op_loop_ms"} <= set(result["metrics"])
