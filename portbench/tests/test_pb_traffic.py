"""The traffic generators: deterministic per seed, the configured mix,
and distinct bodies."""

import asyncio
import hashlib
import json
import pathlib
import types
from collections import Counter

import pytest

from portbench.payload import Payloads
from portbench.traffic import rados_bench

PKG = pathlib.Path(__file__).resolve().parents[1]
SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


def test_payloads_deterministic_and_distinct():
    for seed in SEEDS:
        a, b = Payloads(seed, 4096), Payloads(seed, 4096)
        bodies = [a.get(i) for i in range(64)]
        assert bodies == [b.get(i) for i in range(64)]
        assert len(set(bodies)) == 64
        assert all(len(x) == 4096 for x in bodies)
    assert Payloads(1, 4096).get(5) != Payloads(2, 4096).get(5)


class FakeIO:
    def __init__(self, size):
        self.calls, self.size = [], size

    async def write_full(self, name, data):
        self.calls.append((name, hashlib.sha1(data).hexdigest()))

    async def read(self, name):
        self.calls.append(name)
        return b"\0" * self.size


def fake_run(workload: str, seed: int, ops: int):
    spec = json.loads((PKG / "workloads" / f"{workload}.json").read_text())
    config = json.loads(
        (PKG / "configs" / f"{spec['config']}.json").read_text())
    left = [ops]

    def open_():
        left[0] -= 1
        return left[0] >= 0

    run = types.SimpleNamespace(
        params=spec["params"], config=config, seed=seed,
        cluster=types.SimpleNamespace(pools={"ec": 1}), open=open_,
        ops=[], record=lambda *a, **kw: run.ops.append(a))
    run.state = rados_bench.State(run)
    run.state.io = FakeIO(run.state.size)
    return run


def drive(workload: str, seed: int, ops: int = 40):
    run = fake_run(workload, seed, ops)
    asyncio.run(rados_bench.client(run, 3))
    return run.state.io.calls


@pytest.mark.parametrize("workload", ["rados_ec84.write",
                                      "rados_ec84.read_degraded"])
def test_rados_bench_deterministic_per_seed(workload):
    for seed in SEEDS:
        assert drive(workload, seed) == drive(workload, seed)
    assert drive(workload, 1) != drive(workload, 2)


def test_rados_bench_write_names_are_the_clients_own():
    calls = drive("rados_ec84.write", 5, ops=200)
    names = [n for n, _ in calls]
    # client 3 of 16 owns objects 3, 19, 35, ... and cycles over its 64
    idx = [int(n.removeprefix("benchmark_data_object")) for n in names]
    assert all(i % 16 == 3 for i in idx)
    assert idx[:64] == list(range(3, 1024, 16)) and idx[64] == 3
    assert len({h for _, h in calls}) == 200


def test_rados_bench_reads_are_uniform():
    names = drive("rados_ec84.read_degraded", 9, ops=6400)
    counts = Counter(names)
    assert len(counts) == 64
    # 100 expected per object; 5 sigma of a binomial(6400, 1/64)
    assert all(50 <= c <= 150 for c in counts.values())

