"""Erasure-code benchmark harness (counterpart of ceph_tpu/ec/benchmark.py).

CLI mirror of the reference's ceph_erasure_code_benchmark (flags
--plugin/--workload/--size/--erasures/--parameter, encode loop, exhaustive
decode_erasures verification), with the stripe-batch dimension: one kernel
launch covers ``--stripes`` stripes of ``--size / --stripes`` bytes.

Timing is on the card: CUDA events around ``--iterations`` back-to-back
calls after a warm-up, median of ``--runs`` such runs
(``cuda_seconds_per_call``).  Calls issued from Python cost host time to
enqueue, so a call whose kernel is shorter than that measures the host;
``device_seconds_per_iter``, the counterpart of the JAX package's serial
``fori_loop`` differenced over two trip counts, captures serial steps in
CUDA graphs and differences their replays, so host costs cancel (the perf
lab's timer).  The JAX package's ``--profile`` flag (jax.profiler) is
dropped: time per kernel comes from CUDA events, and kernel launches from
the wrappers' counts, which every record names.

Each record says what it timed: ``path`` (the codec entry), ``kernel``
(the kernels that entry launched, read off the launch counts) and
``timing``.  ``bytes`` is the data (k chunks) of one call; the device
moves those bytes in and the parity (or rebuilt chunks) out.

    python -m ceph_tpu_torch.ec.benchmark --plugin jax_rs -P k=8 -P m=4 \\
        --size $((64*1024*1024)) --stripes 16384 --json
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics

import numpy as np
import torch

from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--plugin", default="jax_rs")
    p.add_argument("--workload", choices=("encode", "decode"),
                   default="encode")
    p.add_argument("--size", type=int, default=1 << 20,
                   help="total data bytes per call")
    p.add_argument("--iterations", type=int, default=16,
                   help="calls per timed run")
    p.add_argument("--runs", type=int, default=5,
                   help="timed runs; the median is reported")
    p.add_argument("--stripes", type=int, default=1024,
                   help="stripe batch per kernel launch")
    p.add_argument("--erasures", type=int, default=2,
                   help="erasures per decode call")
    p.add_argument("--erased", type=int, action="append", default=None,
                   help="explicit chunk ids to erase (repeatable)")
    p.add_argument("--parameter", "-P", action="append", default=[],
                   help="profile key=value (repeatable)")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must exist)")
    p.add_argument("--verify", action="store_true",
                   help="exhaustively verify all erasure combinations "
                        "(decode_erasures sweep)")
    p.add_argument("--json", action="store_true", help="emit one JSON line")
    return p.parse_args(argv)


def cuda_seconds_per_call(fn, iterations: int = 16, runs: int = 5,
                          warmup: int = 3) -> float:
    """Median over ``runs`` of (CUDA-event time of ``iterations`` calls of
    ``fn``) / iterations, after ``warmup`` calls.  Raises without CUDA: a
    device time is never taken from a host clock."""
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iterations):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3 / iterations)
    return statistics.median(samples)


def device_seconds_per_iter(step, x, lo: int = 64, hi: int = 320,
                            trials: int = 3) -> float:
    """Device seconds per ``step(x)``, a step that updates ``x`` in place
    and writes only into preallocated tensors (counterpart of
    ceph_tpu/ec/benchmark.py:51).

    The step runs once outside any graph (which builds its kernels and is
    the one launch the wrappers count), then ``lo`` and ``hi`` serial steps
    are each captured into a CUDA graph; each graph is replayed between
    CUDA events, and the result is the median over ``trials`` of
    (t_hi - t_lo) / (hi - lo), so the graph launch and the events cancel.
    The in-place carry keeps the steps data-dependent, as the JAX loop's
    carry does; a counter in the step is baked in at capture, so step i of
    a replay still applies i.  Raises without CUDA, and when a capture
    fails: it never falls back to timing eager calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")
    if not 0 < lo < hi or trials < 1:
        raise ValueError(f"need 0 < lo < hi and trials >= 1, got lo={lo} "
                         f"hi={hi} trials={trials}")
    step(x)
    torch.cuda.synchronize()
    graphs = {}
    for n in (lo, hi):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                step(x)
        graphs[n] = graph

    def replay_s(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graphs[n].replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    replay_s(lo), replay_s(hi)      # first replays upload the graphs
    samples = [(replay_s(hi) - replay_s(lo)) / (hi - lo)
               for _ in range(trials)]
    del graphs
    return statistics.median(samples)


def kernels_launched(fn) -> list[str]:
    """Run ``fn`` once and name the kernels it launched."""
    before = dict(ck.LAUNCHES)
    fn()
    return sorted(n for n, c in ck.LAUNCHES.items() if c > before[n])


def make_codec(plugin: str, parameters: list[str], device=None):
    profile = {}
    for kv in parameters:
        key, _, val = kv.partition("=")
        profile[key] = val
    return ErasureCodePluginRegistry().factory(plugin, profile, device=device)


def _stripes(ec, size: int, stripes: int) -> np.ndarray:
    k = ec.get_data_chunk_count()
    chunk = ec.get_chunk_size(max(size // max(stripes, 1), 1))
    return np.random.default_rng(0).integers(
        0, 256, (stripes, k, chunk), dtype=np.uint8
    )


def shard_words(ec, data: np.ndarray) -> torch.Tensor:
    """(stripes, k, C) host batch -> (k, stripes*C/4) int32 on the codec's
    device (the shard-stream layout, viewed as lane words)."""
    stripes, k, C = data.shape
    stream = np.ascontiguousarray(
        np.transpose(data, (1, 0, 2)).reshape(k, stripes * C)
    )
    return ck.bytes_to_words(torch.from_numpy(stream).to(ec.device))


def _record(workload: str, fn, data: np.ndarray, path: str,
            iterations: int, runs: int) -> dict:
    kernels = kernels_launched(fn)
    sec = cuda_seconds_per_call(fn, iterations, runs)
    return {
        "workload": workload, "bytes": data.nbytes, "seconds": sec,
        "GiBps": data.nbytes / sec / 2**30, "chunk_size": data.shape[2],
        "stripes": data.shape[0], "path": path, "kernel": kernels,
        "timing": "cuda_events",
    }


def run_encode(ec, size: int, iterations: int, stripes: int,
               runs: int = 5) -> dict:
    """Device-resident encode throughput: the data already on the card,
    parity written there (the device analog of the reference benchmark's
    RAM-resident buffers)."""
    data = _stripes(ec, size, stripes)
    if ec.full_bm is not None:
        dev = torch.from_numpy(data).to(ec.device)
        return _record("encode", lambda: ec.encode_chunks_device(dev), data,
                       "encode_chunks_device", iterations, runs)
    words = shard_words(ec, data)
    return _record("encode", lambda: ec.encode_words_device(words), data,
                   "encode_words_device", iterations, runs)


def run_decode(ec, size: int, iterations: int, stripes: int,
               erasures: int, erased=None, runs: int = 5) -> dict:
    """Device-resident reconstruct of the erased chunks from k survivors."""
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    data = _stripes(ec, size, stripes)
    lost = list(erased) if erased else list(range(min(erasures, n)))
    if ec.full_bm is not None:
        chunks = ec.encode_chunks_device(torch.from_numpy(data).to(ec.device))
        avail = {i: chunks[:, i].contiguous() for i in range(n)
                 if i not in lost}
        rec = _record("decode",
                      lambda: ec.decode_chunks_device(avail, lost), data,
                      "decode_chunks_device", iterations, runs)
    else:
        words = shard_words(ec, data)
        full = torch.cat([words, ec.encode_words_device(words)], dim=0)
        avail_ids = [i for i in range(n) if i not in lost][:k]
        avail = {a: full[a] for a in avail_ids}
        rec = _record("decode",
                      lambda: ec.decode_words_device(avail, lost), data,
                      "decode_words_device", iterations, runs)
    rec["erased"] = lost
    return rec


def verify_all_erasures(ec, size: int = 4096) -> int:
    """Exhaustive erasure sweep — every combination of up to m lost chunks
    must reconstruct bit-identically (benchmark.cc:202-243 semantics).
    Returns the number of combinations checked."""
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    m = n - k
    payload = np.random.default_rng(1).integers(
        0, 256, size, np.uint8).tobytes()
    enc = ec.encode(list(range(n)), payload)
    checked = 0
    for r in range(1, m + 1):
        for lost in itertools.combinations(range(n), r):
            avail = {i: enc[i] for i in range(n) if i not in lost}
            out = ec.decode(list(lost), avail)
            for w in lost:
                if out[w] != enc[w]:
                    raise AssertionError(f"mismatch: lost={lost} chunk={w}")
            checked += 1
    return checked


def main(argv=None) -> dict:
    args = _parse_args(argv)
    ec = make_codec(args.plugin, args.parameter, args.device)
    if args.verify:
        result = {"workload": "verify",
                  "combinations": verify_all_erasures(ec), "ok": True}
    elif args.workload == "encode":
        result = run_encode(ec, args.size, args.iterations, args.stripes,
                            args.runs)
    else:
        result = run_decode(ec, args.size, args.iterations, args.stripes,
                            args.erasures, args.erased, args.runs)
    result["plugin"] = args.plugin
    result["profile"] = ec.get_profile()
    result["device"] = (torch.cuda.get_device_name(ec.device)
                        if ec.device.type == "cuda" else str(ec.device))
    print(json.dumps(result) if args.json else result)
    return result


if __name__ == "__main__":
    main()
