"""Run one cell of BENCHMARK.json and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run boots the cell's configuration (configs/<config>.json) as one
``ceph_tpu_torch.vstart.DevCluster`` in this process, lets the cell's
traffic module (traffic/<kind>.py, named by workloads/<cell>.json) set up
and warm up, then drives closed-loop clients for ``--seconds``.  With
``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` every op is traced and the card profiled, and the line
carries its per-layer metrics.  Each metric is read by
metrics/<name>.py.  Once the window has closed the traffic module
gathers what the program produced (read-backs, the stores' shards) and
judges it against the plain reference (reference/): ``correct``.

Exits 2 without a result where there is no CUDA device, and 3 where a
forbidden module (jax, jaxlib, flax, ceph_tpu) is loaded.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# fixed, inside the checkout: only a cell's first run there builds
CACHE = ROOT / ".portbench_cache"
DRAIN_S = 0.2
STRAGGLER_S = 120.0
# device op names in the breakdown, cut (template arguments run long)
NAME_CHARS = 160


def cache_env() -> None:
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: pathlib.Path = ROOT) -> dict:
    """Everything a run needs of ``name``, found by name under ``root``:
    its entry in BENCHMARK.json, its workload file, its configuration
    file and the metrics it reports in each kind of run."""
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(root / "portbench" / "workloads" / f"{name}.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(root / entry["file"])
    if workload["config"] != cell["config"]:
        raise ValueError(f"{name}: the workload file names config "
                         f"{workload['config']!r}, BENCHMARK.json "
                         f"{cell['config']!r}")
    return {
        "cell": cell, "workload": workload, "config": config,
        # an end-to-end metric without ``workloads`` is every cell's; a
        # per-layer metric names its cells
        "end_to_end": [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"]
                      if name in m["workloads"]],
    }


def reader(metric: str):
    return importlib.import_module(f"portbench.metrics.{metric}").read


def traffic_module(kind: str):
    return importlib.import_module(f"portbench.traffic.{kind}")


class Run:
    """One run of one cell: its inputs, the ops of its window and what
    the traced run read.  Traffic modules and metric readers share it."""

    def __init__(self, spec: dict, seed: int, seconds: float,
                 trace: bool, device):
        self.spec = spec
        self.name = spec["cell"]["name"]
        self.config = spec["config"]
        self.params = spec["workload"]["params"]
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.cluster = None
        self.state = None            # the traffic module's own
        #: (kind, t_issue, t_done, payload_bytes, ok, b1_bytes)
        self.ops: list[tuple] = []
        self.errors: list[str] = []
        self.recording = False
        self.t_open = self.t_close = None
        self.setup_s = None
        self.spans: list[dict] = []
        self.ring_evictions = 0
        self.counters: dict[str, float] = {}
        self.cpu_s = None
        self.devtrace = None
        self.power_limit_w = None
        self.memory_peak_bytes = 0

    # -- the window ----------------------------------------------------------
    def open(self) -> bool:
        """Whether a client may issue another op."""
        return self.t_close is None or time.perf_counter() < self.t_close

    def record(self, kind: str, t0: float, t1: float, nbytes: int,
               ok: bool, b1_bytes: int = 0, error: str = "") -> None:
        if not self.recording:
            if not ok:
                raise RuntimeError(f"set-up {kind} failed: {error}")
            return
        self.ops.append((kind, t0, t1, nbytes, ok, b1_bytes))
        if not ok:
            self.errors.append(f"{kind}: {error}")

    def window_ops(self) -> list[tuple]:
        """Ops issued inside the window (stragglers waited for)."""
        return [op for op in self.ops if self.t_open <= op[1] < self.t_close]

    def done_ops(self) -> list[tuple]:
        """Ops issued and completed inside the window."""
        return [op for op in self.window_ops() if op[2] <= self.t_close]

    def client_bytes(self) -> int:
        return sum(op[3] for op in self.done_ops() if op[4])

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


def sum_counters(daemons) -> dict[str, float]:
    """Every perf counter summed over the daemons (a histogram or an
    average by its sum)."""
    out: dict[str, float] = {}
    for osd in daemons:
        for key, v in osd.perf.dump().items():
            v = v["sum"] if isinstance(v, dict) else v
            out[key] = out.get(key, 0.0) + float(v)
    return out


class SpanDrain:
    """Moves spans out of every tracer's 4096-span ring while the window
    runs, so none is pushed out unread."""

    def __init__(self, run: Run, tracers):
        self.run = run
        self.tracers = tracers
        self.evicted0 = sum(t.ring_evictions for t in tracers)
        self.task = None

    def drain(self) -> None:
        for t in self.tracers:
            spans = list(t.spans)
            t.spans.clear()
            self.run.spans.extend(spans)

    async def loop(self) -> None:
        while True:
            self.drain()
            await asyncio.sleep(DRAIN_S)

    def start(self) -> None:
        self.drain()                 # set-up's spans are not the window's
        self.run.spans.clear()
        self.task = asyncio.get_running_loop().create_task(self.loop())

    async def stop(self) -> None:
        self.task.cancel()
        try:
            await self.task
        except asyncio.CancelledError:
            pass
        self.drain()
        self.run.ring_evictions = sum(
            t.ring_evictions for t in self.tracers) - self.evicted0


async def drive(run: Run, traffic) -> dict:
    """Set up, warm up, measure, gather: the traffic module's evidence."""
    from portbench.cluster import Cluster
    from portbench.devtrace import DeviceTrace

    run.cluster = Cluster(run.config, run.device, run.trace)
    try:
        await run.cluster.start()
        await traffic.prepare(run)
        clients = int(run.params["clients"])
        drain = None
        if run.trace:
            drain = SpanDrain(run, run.cluster.tracers())
            if torch_device_type(run.device) == "cuda":
                run.devtrace = DeviceTrace()
        sync()
        gc.collect()
        gc.freeze()
        c0 = sum_counters(run.cluster.daemons())
        cpu0 = os.times()
        if drain is not None:
            drain.start()
        if run.devtrace is not None:
            run.devtrace.start()
        run.recording = True
        run.t_open = time.perf_counter()
        run.setup_s = run.t_open - START
        run.t_close = run.t_open + run.seconds
        tasks = [asyncio.get_running_loop().create_task(
            traffic.client(run, c)) for c in range(clients)]
        await asyncio.sleep(max(0.0, run.t_close - time.perf_counter()))
        cpu1 = os.times()
        c1 = sum_counters(run.cluster.daemons())
        if run.devtrace is not None:
            run.devtrace.stop()
        if drain is not None:
            await drain.stop()
        run.cpu_s = (cpu1.user + cpu1.system) - (cpu0.user + cpu0.system)
        run.counters = {k: v - c0.get(k, 0.0) for k, v in c1.items()}
        done, pending = await asyncio.wait(tasks, timeout=STRAGGLER_S)
        for t in pending:
            t.cancel()
            run.errors.append("a client never finished its last op")
        for t in done:
            if t.exception() is not None:
                run.errors.append(f"client: {t.exception()!r}")
        run.recording = False
        gc.unfreeze()
        run.memory_peak_bytes = memory_peak(run.device)
        return await traffic.collect(run)
    finally:
        await run.cluster.stop()


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(torch.device(device)))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device="cuda") -> tuple[dict, Run]:
    """One run: the result line's object and the Run behind it."""
    traffic = traffic_module(spec["workload"]["kind"])
    run = Run(spec, seed, seconds, trace, device)
    evidence = asyncio.run(drive(run, traffic))
    checks = traffic.judge(run, evidence)
    checks["failed_ops"] = (len(run.errors), 0)
    if trace:
        checks["span_ring_evictions"] = (run.ring_evictions, 0)
        from portbench.devtrace import power_limit_w
        if torch_device_type(device) == "cuda":
            run.power_limit_w = power_limit_w()
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    window = run.window_ops()
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": len(window),
        "failed": sum(1 for op in window if not op[4]),
        "metrics": metrics,
        "device": device_info(run),
    }
    if trace:
        result["breakdown"] = breakdown(run)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, run


def torch_device_type(device) -> str:
    import torch

    return torch.device(device).type


def device_info(run: Run) -> dict:
    import torch

    if torch_device_type(run.device) == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = run.memory_peak_bytes
    if run.devtrace is not None:
        info["busy_s"] = run.devtrace.busy_s
        info["window_s"] = run.devtrace.window_s
    if run.power_limit_w is not None:
        info["power_limit_w"] = run.power_limit_w
    return info


def breakdown(run: Run) -> dict:
    """The ten device ops that took most time, and the ten span names
    that took most host self time (what the host did between them)."""
    from portbench.stats import self_times_ms

    out = {}
    if run.devtrace is not None:
        by = run.devtrace.seconds_by_name()
        out["device_ops"] = [[n[:NAME_CHARS], s] for n, s in sorted(
            by.items(), key=lambda kv: -kv[1])[:10]]
    names = {s["name"] for s in run.spans}
    selfs = {}
    for n in names:
        selfs[n] = sum(self_times_ms(run.spans, {n}, lambda _: True)) / 1e3
    out["idle_gaps"] = [[n, s] for n, s in sorted(
        selfs.items(), key=lambda kv: -kv[1])[:10]]
    return out


def main(argv=None) -> int:
    cache_env()
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    spec = load_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    traffic_module(spec["workload"]["kind"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        reader(m["name"])
    from portbench import guard
    guard.check()
    result, run = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for err in run.errors[:20]:
        print(f"error: {err}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
