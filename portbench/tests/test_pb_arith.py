"""Percentiles, interval unions, self times, the import guard and the
metric readers' arithmetic on synthetic spans, counters and ops."""

import pytest

from portbench import guard, stats
from portbench.metrics import (b1_roofline_pct, client_gib_s,
                               coalesce_ops_per_launch, device_idle_pct,
                               host_cpu_ms_per_mib, op_p50_ms, op_p95_ms,
                               osd_op_self_ms, resident_h2d_bytes_per_byte)
from portbench.peaks import HBM_BYTES_PER_S
from portbench.run import Run


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([], 50) is None
    assert stats.percentile([3, 1, 2], 50) == 2


def test_union_length():
    assert stats.union_length([(0, 1), (0.5, 2), (3, 4)]) == 3
    assert stats.union_length([(0, 10)], 2, 5) == 3
    assert stats.union_length([]) == 0


def span(sid, name, start, ms, parent=""):
    return {"span_id": sid, "parent": parent, "name": name,
            "start": start, "duration_ms": ms}


def test_self_time_subtracts_covered_children():
    spans = [span("a", "osd:do_op", 0.0, 100.0),
             span("b", "osd:sub_op:write:send", 0.010, 30.0, "a"),
             span("c", "osd:sub_op:write:send", 0.020, 30.0, "a"),
             span("d", "osd:ec:launch", 0.095, 20.0, "a"),
             span("e", "msgr:dispatch", 0.0, 100.0, "a")]
    got = stats.self_times_ms(
        spans, {"osd:do_op"}, lambda n: n.startswith("osd:sub_op:")
        or n == "osd:ec:launch")
    # children cover 10..50 ms and 95..100 ms of the span
    assert got == [pytest.approx(55.0)]


def fake_run(ops, spans=(), counters=None, cpu_s=None, devtrace=None):
    run = Run.__new__(Run)
    run.ops = list(ops)
    run.t_open, run.t_close = 0.0, 10.0
    run.spans = list(spans)
    run.counters = counters or {}
    run.cpu_s = cpu_s
    run.devtrace = devtrace
    return run


def test_end_to_end_readers():
    ops = [("write", 0.5 * i, 0.5 * i + 0.1 * (i + 1), 1 << 20, True, 0)
           for i in range(20)]
    ops.append(("write", 9.95, 10.5, 1 << 20, True, 0))   # done after
    ops.append(("write", -1.0, 0.5, 1 << 20, True, 0))    # issued before
    run = fake_run(ops)
    # op i ends at 0.6 i + 0.1 s: ops 0..16 end inside the 10 s window
    assert client_gib_s.read(run) == pytest.approx(17 / 1024 / 10)
    lat = sorted([100.0 * (i + 1) for i in range(20)] + [550.0])
    assert op_p50_ms.read(run) == pytest.approx(lat[10])
    assert op_p95_ms.read(run) == pytest.approx(lat[19])


def test_counter_and_cpu_readers():
    ops = [("write", 1.0, 2.0, 4 << 20, True, 0)]
    run = fake_run(ops, counters={"ec_coalesce_ops": 30.0,
                                  "ec_coalesce_launches": 12.0,
                                  "ec_resident_h2d_bytes": 6 << 20},
                   cpu_s=2.0)
    assert coalesce_ops_per_launch.read(run) == 2.5
    assert resident_h2d_bytes_per_byte.read(run) == 1.5
    assert host_cpu_ms_per_mib.read(run) == 500.0
    empty = fake_run([])
    assert coalesce_ops_per_launch.read(empty) is None
    assert host_cpu_ms_per_mib.read(empty) is None


def test_span_readers():
    spans = [span("c", "osd:do_op", 0.0, 10.0),
             span("d", "osd:ec:launch", 0.001, 4.0, "c"),
             span("e", "objecter:op_submit", 0.0, 20.0)]
    run = fake_run([], spans)
    assert osd_op_self_ms.read(run) == pytest.approx(6.0)
    assert osd_op_self_ms.read(fake_run([], spans[2:])) is None


class Trace:
    def __init__(self, events, window_s):
        self.events, self.window_s = events, window_s

    @property
    def busy_s(self):
        return stats.union_length((a, b) for _, a, b in self.events)

    def seconds_by_name(self):
        out = {}
        for n, a, b in self.events:
            out[n] = out.get(n, 0.0) + b - a
        return out


def test_device_readers():
    need = 6 << 20
    ops = [("write", 1.0, 2.0, 4 << 20, True, need)] * 4
    b1 = "void gf2_words_kernel<WordIO, false, false, 1>(unsigned int const*)"
    t = 4 * need / HBM_BYTES_PER_S
    events = [(b1, 0.0, t), ("Memcpy HtoD", 1.0, 1.5),
              ("void gf2_words_kernel<ByteIO, false, true, 1>()", 2, 2.25)]
    run = fake_run(ops, devtrace=Trace(events, 10.0))
    # B1 alone, at exactly its bound: 100%
    assert b1_roofline_pct.read(run) == pytest.approx(100.0)
    assert device_idle_pct.read(run) == pytest.approx(
        100 * (1 - (t + 0.75) / 10))
    assert b1_roofline_pct.read(fake_run(ops)) is None
    no_b1 = fake_run(ops, devtrace=Trace(events[1:], 10.0))
    assert b1_roofline_pct.read(no_b1) is None


def test_guard_compares_whole_top_level_names():
    mods = {"ceph_tpu_torch": 1, "ceph_tpu_torch.osd": 1, "jax_x": 1,
            "ceph_tpu_tools": 1, "ceph_tpu.ec": 1, "jaxlib": 1,
            "jax": 1, "flax.linen": 1}
    assert guard.forbidden_modules(mods) == [
        "ceph_tpu.ec", "flax.linen", "jax", "jaxlib"]
    assert guard.forbidden_modules({"ceph_tpu_torch": 1}) == []


def test_the_harness_loads_no_forbidden_module():
    import subprocess
    import sys
    code = ("import portbench.run, portbench.control, portbench.traffic."
            "rados_bench, portbench.reference.rs, portbench.cluster, "
            "portbench.faults; import ceph_tpu_torch.vstart; "
            "from portbench import guard; "
            "print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[2]))
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_port():
    import ast
    import pathlib
    ref = pathlib.Path(__file__).resolve().parents[1] / "reference"
    for f in ref.glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in {"numpy", "__future__",
                                           "hashlib"}, (f, n)
