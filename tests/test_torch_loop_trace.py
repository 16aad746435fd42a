"""On-loop time in the port's tracer (``ceph_tpu_torch.common.tracing``).

While an entity samples ops (``trace_probability`` above 0) a hook on
``asyncio.events.Handle._run`` charges each loop step to the span ambient
in it; spans carry ``loop_ms`` and ``t_ns``, the store records
``store:*`` spans, the messenger's frame work goes to the ``msgr:send`` /
``msgr:recv`` labels, and the loop monitor keeps the loop's busy time in
10 ms buckets by label.  With no such entity nothing is installed.  The
``cuda`` tests place an EC launch's device interval on the span clock;
they skip without a card.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.msg import Message, Messenger, reset_local_namespace
from ceph_tpu_torch.vstart import DevCluster

STOCK_RUN = asyncio.events.Handle._run


@pytest.fixture(autouse=True)
def _clean():
    reset_local_namespace()
    yield
    reset_local_namespace()
    assert asyncio.events.Handle._run is STOCK_RUN


def _busy(ms: float) -> None:
    end = time.perf_counter() + ms / 1e3
    while time.perf_counter() < end:
        pass


class _Holder:
    """An entity that traces for the length of a block."""

    def __enter__(self):
        tracing.hold_loop_trace(self, True)
        return self

    def __exit__(self, *exc):
        tracing.hold_loop_trace(self, False)


def test_interleaved_spans_charge_only_their_own_steps():
    """Two tasks in ambient spans take turns on the loop, 20 ms and 5 ms
    a step: each span's ``loop_ms`` is its own steps' time (within 10%),
    far below its wall ``duration_ms``, which holds the other's too."""
    tracer = tracing.Tracer("t")
    own = {}

    async def worker(name, ms, steps):
        with tracer.span(name, ambient=True):
            spent = 0.0
            for _ in range(steps):
                t0 = time.perf_counter()
                _busy(ms)
                spent += time.perf_counter() - t0
                await asyncio.sleep(0)
        own[name] = spent * 1e3

    async def main():
        with _Holder():
            assert asyncio.events.Handle._run is not STOCK_RUN
            await asyncio.gather(worker("long", 20, 6),
                                 worker("short", 5, 6))

    asyncio.run(main())
    spans = {s["name"]: s for s in tracer.dump()}
    for name in ("long", "short"):
        s = spans[name]
        assert s["loop_ms"] == pytest.approx(own[name], rel=0.1)
        assert isinstance(s["t_ns"], int)
    assert spans["short"]["loop_ms"] < 0.5 * spans["short"]["duration_ms"]
    assert spans["long"]["loop_ms"] < 0.9 * spans["long"]["duration_ms"]


def test_use_span_and_synchronous_children_cut_the_step():
    """Inside one step, time moves to an ambient child while it is open
    (a ``use_span`` block, a store's span) and back to the parent after:
    the child holds its own block's time, the two together the step's."""
    tracer = tracing.Tracer("t")
    wall = {}

    async def main():
        with _Holder():
            await asyncio.sleep(0)
            with tracer.span("parent") as ctx:
                t0 = time.perf_counter()
                with tracing.use_span(ctx):
                    _busy(6)
                    t1 = time.perf_counter()
                    with tracing.child_span("store:commit"):
                        _busy(12)
                    t2 = time.perf_counter()
                    _busy(6)
                t3 = time.perf_counter()
        wall.update(child=(t2 - t1) * 1e3, block=(t3 - t0) * 1e3)

    asyncio.run(main())
    spans = {s["name"]: s for s in tracer.dump()}
    child, parent = spans["store:commit"], spans["parent"]
    assert child["parent"] == parent["span_id"]
    assert child["loop_ms"] == pytest.approx(wall["child"], rel=0.05)
    assert parent["loop_ms"] + child["loop_ms"] == pytest.approx(
        wall["block"], rel=0.05)
    assert parent["loop_ms"] >= 12.0


def test_no_trace_probability_installs_nothing():
    """With ``trace_probability`` 0, ``Handle._run`` is the stock function
    before, during and after a cluster's run, and the store's spans are a
    context that does nothing."""
    seen = []

    async def main():
        cluster = DevCluster(n_mons=1, n_osds=3, device="cpu")
        await cluster.start()
        try:
            seen.append(asyncio.events.Handle._run)
            rados = await cluster.client()
            await rados.pool_create("p", pg_num=4, size=3)
            io = await rados.open_ioctx("p")
            await io.write_full("o", b"x" * 5000)
            assert await io.read("o") == b"x" * 5000
            seen.append(asyncio.events.Handle._run)
            assert tracing._MONITOR is None
            assert tracing.child_span("store:read") is tracing._NO_SPAN
            await rados.shutdown()
        finally:
            await cluster.stop()
        seen.append(asyncio.events.Handle._run)

    seen.append(asyncio.events.Handle._run)
    asyncio.run(main())
    assert seen == [STOCK_RUN] * 4


async def _traced_write(n_osds, size, data):
    cluster = DevCluster(n_mons=1, n_osds=n_osds, device="cpu",
                         overrides={"trace_probability": 1.0})
    await cluster.start()
    try:
        assert tracing._MONITOR is not None
        assert asyncio.events.Handle._run is tracing._run_step
        rados = await cluster.client()
        await rados.pool_create("p", pg_num=1, size=size)
        io = await rados.open_ioctx("p")
        for t in [osd.tracer for osd in cluster.osds.values()] + [
                osd.msgr.tracer for osd in cluster.osds.values()]:
            t.spans.clear()
        rados.objecter.tracer.spans.clear()
        rados.msgr.tracer.spans.clear()
        await io.write_full("o", data)
        assert await io.read("o") == data
        spans = (rados.objecter.tracer.dump() + rados.msgr.tracer.dump())
        for osd in cluster.osds.values():
            spans += osd.tracer.dump() + osd.msgr.tracer.dump()
        await rados.shutdown()
    finally:
        await cluster.stop()
    return spans, tracing.loop_monitor()


def test_messenger_and_store_spans_parent_under_their_op():
    """On a two-OSD cluster every commit and read has a ``store:*`` span
    under the op or sub-op that made it, and a reply is dispatched in
    its op's trace; the messengers' frame work is charged to the
    ``msgr:send`` / ``msgr:recv`` labels, with no record a message.
    Every span has ``loop_ms`` and ``t_ns``."""
    spans, mon = asyncio.run(_traced_write(2, 2, b"y" * 20000))
    assert asyncio.events.Handle._run is STOCK_RUN
    by_id = {s["span_id"]: s for s in spans}
    names = {s["name"] for s in spans}
    assert {"objecter:op_submit", "osd:do_op", "msgr:dispatch",
            "store:commit", "store:read"} <= names
    assert not names & {"msgr:send", "msgr:recv"}
    for s in spans:
        assert isinstance(s["t_ns"], int)
        assert s["loop_ms"] >= 0.0
        if s["name"].startswith("store:"):
            assert by_id[s["parent"]]["name"] in ("osd:do_op",
                                                  "osd:sub_op:tx")
    # the client's op goes out, and its reply comes back in its trace
    submit = [s for s in spans if s["name"] == "objecter:op_submit"]
    assert submit
    for op in submit:
        kids = {s["name"] for s in spans if s["parent"] == op["span_id"]}
        assert {"osd:do_op", "msgr:dispatch"} <= kids
        assert any(s["name"] == "msgr:dispatch"
                   and s["entity"] == op["entity"]
                   and s["trace_id"] == op["trace_id"]
                   and by_id[s["parent"]]["name"] == "osd:do_op"
                   for s in spans)
    labels = {}
    for b in mon.buckets:
        for k, ns in b[3].items():
            labels[k] = labels.get(k, 0) + ns
    assert labels["msgr:send"] > 0 and labels["msgr:recv"] > 0
    assert labels["store:commit"] > 0


def test_io_tasks_start_in_a_clean_context():
    """A session dialled inside a traced op does not keep the op's span
    ambient in its reader and writer tasks."""

    class Sink:
        def __init__(self):
            self.got = asyncio.Event()

        async def ms_dispatch(self, conn, msg):
            self.got.set()

        def ms_handle_reset(self, conn):
            pass

        def ms_handle_connect(self, conn):
            pass

    async def main():
        a, b = Messenger("osd.0"), Messenger("osd.1")
        sink = Sink()
        a.set_dispatcher(Sink())
        b.set_dispatcher(sink)
        await a.bind("local://a")
        await b.bind("local://b")
        tracer = tracing.Tracer("osd.0")
        with tracer.span("osd:do_op", ambient=True) as ctx:
            assert tracing.current_span() == ctx
            conn = await a.connect("local://b", "osd.1")
            conn.send_message(Message("ping", {}))
        await asyncio.wait_for(sink.got.wait(), 5)
        tasks = conn._tasks + [t for c in b._accepted.values()
                               for t in c._tasks]
        assert len(tasks) == 4
        for t in tasks:
            assert t.get_context().get(tracing._ACTIVE) is None
        await a.shutdown()
        await b.shutdown()

    asyncio.run(main())


def test_loop_monitor_buckets_sum_to_its_total_and_evict():
    """The buckets' busy time sums to the monitor's total, steps split at
    bucket edges, and a full ring drops its oldest bucket and counts it."""
    loop = asyncio.new_event_loop()
    try:
        mon = tracing.LoopMonitor(loop, ring=4)
        w = tracing.BUCKET_NS
        t = 1000 * w
        for i in range(3):
            mon.charge(t + i * w + 100, t + i * w + 400)
        assert mon.busy_ns == 900
        assert sum(b[1] for b in mon.buckets) == mon.busy_ns
        mon.charge(t + 3 * w - 50, t + 3 * w + 150)   # across an edge
        assert [b[1] for b in mon.buckets] == [300, 300, 350, 150]
        assert mon.busy_ns == sum(b[1] for b in mon.buckets) == 1100
        assert mon.evictions == 0
        mon.charge(t + 5 * w, t + 5 * w + 10)
        assert mon.evictions == 1 and len(mon.buckets) == 4
        assert mon.buckets[0][0] == t + w
        assert all("unspanned:" in k for b in mon.buckets for k in b[3])
    finally:
        loop.close()


def test_loop_monitor_counts_steps_labels_and_probe_lag():
    """On a traced loop every step is counted, a step under no span goes
    to ``unspanned:<its coroutine>``, and the probe waits behind the
    runnable steps ahead of it: eight tasks that each stay ready with
    4 ms steps hold it back by about 30 ms."""

    async def churn():
        for _ in range(8):
            _busy(4)
            await asyncio.sleep(0)

    async def main():
        with _Holder():
            await asyncio.gather(*(asyncio.create_task(churn())
                                   for _ in range(8)))
        return tracing.loop_monitor()

    mon = asyncio.run(main())
    assert mon.steps == sum(b[2] for b in mon.buckets) > 64
    labels = {k for b in mon.buckets for k in b[3]}
    assert any(k.startswith("unspanned:") and k.endswith(".churn")
               for k in labels)
    lags = [b[4] / b[5] for b in mon.buckets if b[5]]
    assert max(lags) > 15e6


def test_ec_launch_span_carries_its_clock_on_the_cpu():
    """An ``osd:ec:launch`` span has ``t_ns`` and the worker's
    ``thread_ms``; off a card no device interval and no device time."""
    spans, counters = asyncio.run(_ec_launch("cpu"))
    launch = [s for s in spans if s["name"] == "osd:ec:launch"]
    assert launch
    for s in launch:
        assert isinstance(s["t_ns"], int) and s["thread_ms"] >= 0.0
        assert "dev_t_ns" not in s and "dev_ms" not in s
    assert counters["ec_encode_device_us"]["count"] == 0


async def _backend(device, tracer=None, **kw):
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShard
    from ceph_tpu_torch.store import CollectionId, MemStore, Transaction

    codec = ErasureCodePluginRegistry().factory(
        "jax_rs", {"k": "8", "m": "4", "technique": "reed_sol_van"},
        device=device)
    shards = {}
    for i in range(12):
        store = MemStore()
        cid = CollectionId(1, 0, shard=i)
        await store.queue_transactions(Transaction().create_collection(cid))
        shards[i] = LocalShard(store, cid, pool=1, shard=i)
    return ECBackend(codec, shards, tracer=tracer, **kw)


async def _ec_launch(device, **kw):
    tracer = tracing.Tracer("osd.0")
    be = await _backend(device, tracer, **kw)
    data = np.random.default_rng(5).integers(0, 256, 4 << 20,
                                             np.uint8).tobytes()
    with _Holder():
        for i in range(3):
            with tracer.span("osd:do_op", ambient=True):
                await be.write(f"o{i}", data)
    assert await be.read("o2") == data
    if device == "cuda":
        torch.cuda.synchronize()
        be._settle_device_times()
    return tracer.dump(), be.perf.dump()


class _Event:
    """A CUDA event's face: passed or not, at a time on the card."""

    def __init__(self, at_ms, passed=True):
        self.at_ms, self.passed = at_ms, passed

    def query(self):
        return self.passed

    def elapsed_time(self, later):
        return later.at_ms - self.at_ms


def test_launch_device_time_is_read_once_its_events_pass():
    """Nothing waits for a launch's end event: its device time is
    counted, and its span recorded, at the backend's next download after
    the event has passed, placed on the span clock by its anchor."""
    from ceph_tpu_torch.osd.ec_backend import LaunchTiming

    async def main():
        be = await _backend("cpu")
        sig = f"{be.codec_sig}:enc"
        be.profiler.record(sig, 900.0)
        end = _Event(2.5, passed=False)
        timing = LaunchTiming(7, (_Event(0.0), 10**9, _Event(2.0), end))
        be._device_time(timing, "enc")
        spans = []
        be._when_timed([timing], lambda: spans.append(timing.dev_t_ns))
        be._to_host(torch.zeros(4, dtype=torch.uint8))
        assert not spans and be._dev_waiting
        assert be.perf.dump()["ec_encode_device_us"]["count"] == 0
        end.passed = True
        be._to_host(torch.zeros(4, dtype=torch.uint8))
        assert spans == [10**9 + 2_000_000] and not be._dev_waiting
        enc = be.perf.dump()["ec_encode_device_us"]
        assert enc["count"] == 1 and enc["sum"] == pytest.approx(500.0)
        assert be.profiler.dump()[sig]["device_us"] == pytest.approx(500.0)

    asyncio.run(main())


def test_anchor_is_taken_anew_and_a_wide_bracket_is_not_taken(
        monkeypatch):
    """The card's clock is placed on the host's anew once a second; a
    re-anchor whose host bracket is wide keeps the last anchor (and is
    tried again soon) until that one is ANCHOR_KEEP_NS old."""
    from types import SimpleNamespace

    from ceph_tpu_torch.osd import ec_backend as ecb

    clock, step = [10**12], [5_000]

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self, stream):
            clock[0] += step[0]

        def query(self):
            return True

    monkeypatch.setattr(ecb.torch.cuda, "Event", Event)
    monkeypatch.setattr(ecb.torch.cuda, "Stream", lambda device: "side")
    monkeypatch.setattr(ecb, "time", SimpleNamespace(
        perf_counter_ns=lambda: clock[0]))
    monkeypatch.setattr(ecb, "_ANCHORS", {})
    dev = torch.device("cuda", 0)
    first = ecb._anchor(dev)
    assert first[1] == 10**12 + 2_500 and first[2] == "side"
    clock[0] += ecb.ANCHOR_NS // 2
    assert ecb._anchor(dev) is first
    clock[0] += ecb.ANCHOR_NS
    step[0] = 10 * ecb.ANCHOR_BRACKET_NS
    now = clock[0]
    kept = ecb._anchor(dev)
    assert kept[:2] == first[:2] and kept[3] == now + ecb.ANCHOR_RETRY_NS
    clock[0] = first[1] + ecb.ANCHOR_KEEP_NS
    late = ecb._anchor(dev)
    assert late[1] > first[1] and late[0] is not first[0]
    step[0] = 1_000
    clock[0] = late[3]
    assert ecb._anchor(dev)[1] == late[3] + 500


@pytest.mark.cuda
def test_ec_launch_device_interval_lies_inside_its_host_interval():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spans, counters = asyncio.run(_ec_launch("cuda"))
    launch = [s for s in spans if s["name"] == "osd:ec:launch"]
    assert len(launch) == 3
    for s in launch:
        host_end = s["t_ns"] + s["duration_ms"] * 1e6
        assert s["t_ns"] <= s["dev_t_ns"]
        assert s["dev_t_ns"] + s["dev_ms"] * 1e6 <= host_end
        assert 0.0 < s["dev_ms"] <= s["duration_ms"]
    enc = counters["ec_encode_device_us"]
    assert enc["count"] == 3 and enc["sum"] > 0
    assert counters["ec_encode_launch_us"]["sum"] > enc["sum"]


@pytest.mark.cuda
def test_resident_launch_device_time_is_read_without_a_sync():
    """With the resident cache the encode's result stays on the card and
    the launch returns before its device work ends: its span and
    counters still get the device interval, which starts after the
    launch's host start."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spans, counters = asyncio.run(_ec_launch("cuda", resident=True))
    launch = [s for s in spans if s["name"] == "osd:ec:launch"]
    assert len(launch) == 3
    for s in launch:
        assert s["t_ns"] <= s["dev_t_ns"] and s["dev_ms"] > 0.0
    enc = counters["ec_encode_device_us"]
    assert enc["count"] == 3 and enc["sum"] > 0
