"""The port's S3 front end against the JAX package's.

The scenarios of tests/test_rgw_{http,cors,presign,push}.py, the REST
case of tests/test_rgw_tagging.py and the gateway cases of
tests/test_qos.py (admission control sheds and the client backs off),
tests/test_loadgen.py (``S3Backend`` through a live gateway) and
tests/test_dashboard.py (the placement and lifecycle panels) run on both
packages, the port's daemons on ``device="cpu"``, each with its transcript
(see tests/test_torch_rgw.py) equal across them: every status, S3 error
code, header and body the test's client saw, every gateway call's result
and, at teardown, every RADOS object of every pool.  ``vstart``'s
``start_rgw`` with an erasure-coded cold pool is held the same way.
"""

import pytest

from test_torch_rgw import run_twin_scenario, scenarios

FRONT_END = [
    *scenarios("test_rgw_http"),
    *scenarios("test_rgw_cors"),
    *scenarios("test_rgw_presign"),
    *scenarios("test_rgw_push"),
    *scenarios("test_rgw_tagging", ["test_tagging_rest_surface"]),
    *scenarios("test_loadgen", ["test_s3_backend_roundtrip_through_rgw"]),
    *scenarios("test_dashboard",
               ["test_dashboard_rgw_placement_and_lifecycle_panels"]),
]


@pytest.mark.parametrize("ref,name", FRONT_END)
def test_front_end_scenario_equal_across_packages(ref, name, monkeypatch):
    run_twin_scenario(ref, name, monkeypatch)


def test_admission_sheds_and_client_backs_off_equal_across_packages(
        monkeypatch):
    """Four clients against a 20 op/s session rate: which requests are shed
    follows the wall clock, so the two runs compare as sets of entries."""
    out = run_twin_scenario(
        "test_qos", "test_rgw_admission_sheds_and_client_backs_off",
        monkeypatch, timed=True)
    assert any(e[0] == "pools" for e in out)
