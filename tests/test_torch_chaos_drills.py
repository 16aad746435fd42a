"""The port's elasticity and integrity drills against the JAX package's.

tests/test_elasticity_drills.py's expansion and drain drills and
tests/test_integrity_drill.py's silent-corruption drill run once on a fresh
dev cluster of each package, the port's OSD daemons on ``device="cpu"``.
Their seeded parts must be equal across packages (the expansion's predicted
motion, the rot's injection ledger, what was verified) and each drill's
verdict must hold on both, as the reference tests pin it: moved equal to
predicted through batched launches, zero degraded objects through a drain
and a purge, every rot caught and repaired with no false positive.  The
rolling-restart drill and the corruption drill's same-seed replay stay
``slow``, as the reference marks them; the zone-loss drills wait for the
port's gateway (ROADMAP A12.2).  Tolerance 0.
"""

import pytest

from test_torch_chaos import PKGS, on_each_package


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


def test_expansion_drill_moves_exactly_the_diff_on_each_package():
    out = on_each_package("run_expansion_drill", seed=0)
    port, ref = out["ceph_tpu_torch"], out["ceph_tpu"]
    keep = ("seed", "osds", "added", "new_osds", "predicted", "verified")
    assert {k: port[k] for k in keep} == {k: ref[k] for k in keep}
    for r in (port, ref):
        assert r["slo"]["pass"], r["slo"]
        assert r["moved"]["objects"] == r["predicted"]["objects"] > 0
        assert r["moved"]["bytes"] == r["predicted"]["bytes"] > 0
        assert 0 < r["moved"]["batches"] < r["moved"]["objects"]
        assert r["verified"] == 64 and r["slo"]["client_reads"] > 0


def test_drain_drill_zero_degraded_then_purge_on_each_package():
    out = on_each_package("run_drain_drill", seed=0)
    port, ref = out["ceph_tpu_torch"], out["ceph_tpu"]
    keep = ("seed", "osds", "victim", "max_degraded", "purged", "verified")
    assert {k: port[k] for k in keep} == {k: ref[k] for k in keep}
    for r in (port, ref):
        assert r["max_degraded"] == 0 and r["moved_objects"] > 0
        assert r["purged"] is True and r["verified"] == 48


def _ledger(out):
    return [(i["object"], i["ps"], i["shard"], i["osd"], i["offset"],
             i["mask"]) for i in out["injections"]]


def test_silent_corruption_drill_catches_and_repairs_on_each_package():
    out = on_each_package("run_silent_corruption_drill", seed=7,
                          n_objects=32, n_victims=4)
    port, ref = out["ceph_tpu_torch"], out["ceph_tpu"]
    assert _ledger(port) == _ledger(ref) and len(_ledger(ref)) == 4
    for r in (port, ref):
        assert r["slo"]["pass"], r["slo"]
        assert r["slo"]["caught"] == r["slo"]["injected"] == 4
        assert r["slo"]["false_positives"] == 0
        assert r["slo"]["repaired"] == 4 and r["slo"]["client_reads"] > 0
        assert r["scrub"]["objects_verified"] >= 32
        assert r["scrub"]["launches"] > 0


@pytest.mark.slow
def test_silent_corruption_drill_same_ledger_across_packages_and_seeds():
    for seed in (3, 11):
        out = on_each_package("run_silent_corruption_drill", seed=seed,
                              n_objects=24, n_victims=3)
        assert _ledger(out["ceph_tpu_torch"]) == _ledger(out["ceph_tpu"])
        assert out["ceph_tpu_torch"]["slo"]["caught"] == \
            out["ceph_tpu"]["slo"]["caught"] == 3


@pytest.mark.slow
def test_rolling_restart_drill_no_storm_per_wave_on_each_package():
    out = on_each_package("run_rolling_restart_drill", seed=0)
    for r in out.values():
        assert len(r["waves"]) == 3 and r["verified"] == 36
        for wave in r["waves"]:
            assert wave["backfill_after_wave"] == 0, wave
            assert wave["mid_wave_reads"] == 8
    assert [w["host"] for w in out["ceph_tpu_torch"]["waves"]] == \
        [w["host"] for w in out["ceph_tpu"]["waves"]]
