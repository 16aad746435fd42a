"""The port's seeded chaos harness against the JAX package's.

``ChaosHarness.plan()`` derives from the seed alone: equal across packages
for several seeds, with and without the elastic topology events.  Then
``run_chaos(seed, ec=True)`` (tests/test_ec_coalesce.py's and
tests/test_failpoint.py's entry point, on the erasure-coded pool) and
tests/test_repair_engine.py's full-host failure drill run once on a fresh
dev cluster of each package, the port's OSD daemons on ``device="cpu"``
(the port's one departure in testing/chaos.py): the recorded schedules
(kill victims, revives, failpoints) must be equal, and each run's verdict
must hold on both (every model object verified, the batched repair engine
drained, every object read back).  With no ``device=`` and no CUDA the
port's harness raises rather than fall back to the CPU.  Tolerance 0.
"""

import asyncio
import functools
import importlib
from types import SimpleNamespace

import pytest
import torch

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    device = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    chaos = mod("testing.chaos")
    return SimpleNamespace(
        root=root, chaos=chaos, fp=mod("common.failpoint"),
        events=mod("common.events"),
        reset_local_namespace=mod("msg").reset_local_namespace,
        ChaosHarness=functools.partial(chaos.ChaosHarness, **device),
        run=lambda name, **kw: getattr(chaos, name)(**device, **kw))


PKGS = {name: _pkg(name) for name in PKG_NAMES}


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS.values():
        p.reset_local_namespace()
        p.fp.fp_clear()
    yield
    for p in PKGS.values():
        p.fp.fp_clear()
        p.fp.set_seed(0)
        p.reset_local_namespace()


def on_each_package(drill, **kw):
    out = {}
    for name, p in PKGS.items():
        p.reset_local_namespace()
        p.events.reset_proc()
        out[name] = asyncio.run(p.run(drill, **kw))
        p.fp.fp_clear()
        p.reset_local_namespace()
    return out


@pytest.mark.parametrize("elastic", [False, True])
@pytest.mark.parametrize("seed", [0, 2, 3, 12, 99])
def test_chaos_plans_equal(seed, elastic):
    plans = {name: p.ChaosHarness(seed=seed, ec=True, elastic=elastic,
                                  n_batches=24).plan()
             for name, p in PKGS.items()}
    assert plans["ceph_tpu_torch"] == plans["ceph_tpu"]
    kinds = {e for _, e, _ in plans["ceph_tpu"]}
    assert {"kill", "revive", "fp_set"} <= kinds
    assert ("add_host" in kinds) == elastic


def test_run_chaos_ec_schedules_and_verdicts_equal():
    out = on_each_package("run_chaos", seed=3, ec=True, n_batches=6)
    port, ref = out["ceph_tpu_torch"], out["ceph_tpu"]
    assert port["schedule"] == ref["schedule"]
    for r in (port, ref):
        assert r["verified"] > 0 and r["ops_done"] > 0, r
        assert r["forensics"] is not None
    assert (port["kills"], port["revives"]) == (ref["kills"],
                                                ref["revives"])


def test_host_failure_drill_equal():
    out = on_each_package("run_host_failure_drill", seed=5)
    keep = ("seed", "victim", "osds", "killed_osds", "verified",
            "mid_rebuild_reads", "degraded_writes")
    port, ref = out["ceph_tpu_torch"], out["ceph_tpu"]
    assert {k: port[k] for k in keep} == {k: ref[k] for k in keep}
    for r in (port, ref):
        assert r["repair_batches"] > 0 and r["repair_objects"] > 0
        assert r["verified"] == 48 and r["mid_rebuild_reads"] == 8
        assert len(r["killed_osds"]) == 2


def test_chaos_harness_without_device_raises_without_cuda(monkeypatch):
    p = PKGS["ceph_tpu_torch"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        asyncio.run(p.chaos.ChaosHarness(seed=0, n_batches=1).run())
