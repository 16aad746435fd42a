"""The port's bucket policies and key management against the JAX
package's.

The scenarios of tests/test_iam.py (policy validation and evaluation,
cross-user grants and denies, the REST round trip) and, where the
``cryptography`` package is present, tests/test_sse_kms.py (SSE-KMS
round trips, rotation, multipart and copy, the config-key store, the REST
headers) and tests/test_vault_kms.py (a Vault transit stand-in, wrap /
rotate / unwrap and SSE-KMS end to end) run on both packages, the port's
daemons on ``device="cpu"``, each with its transcript (see
tests/test_torch_rgw.py) equal across them: every policy verdict, every
gateway call's result, the client's HTTP exchanges and every RADOS object
at teardown (encrypted bodies byte for byte: keys and nonces come from the
seeded ``secrets`` streams).
"""

import os
import pathlib
import subprocess
import sys

import pytest

from tests._deps import requires_cryptography
from test_torch_rgw import run_twin_scenario, scenarios

SCENARIOS = [
    *scenarios("test_iam"),
    *scenarios("test_sse_kms"),
    *scenarios("test_vault_kms"),
]


@pytest.mark.parametrize("ref,name", SCENARIOS)
def test_policy_and_kms_scenario_equal_across_packages(ref, name,
                                                       monkeypatch):
    run_twin_scenario(ref, name, monkeypatch)


# A fresh interpreter whose first import of the port's S3 front end happens
# inside a recorded run, as when a scenario reaches it lazily
# (``DevCluster.start_rgw``) before any test file imported it.
FIRST_IMPORT_WHILE_RECORDING = r"""
import importlib, sys
import pytest
import test_torch_rgw as r

front = "ceph_tpu_torch.services.rgw_http"
assert front not in sys.modules
r.run_recorded("ceph_tpu_torch", lambda: importlib.import_module(front),
               pytest.MonkeyPatch())
rgw = importlib.import_module("ceph_tpu_torch.services.rgw")
assert sys.modules[front].sse_check is rgw.sse_check
r.run_twin_scenario("test_sse_kms", "test_kms_rest_headers",
                    pytest.MonkeyPatch())
print("twin-ok")
"""


@requires_cryptography
def test_a_module_first_imported_while_recording_keeps_no_wrapper():
    """``test_sse_kms::test_kms_rest_headers`` failed here in a full run
    of the suite, when a test process had first imported the port's
    ``rgw_http`` in an earlier scenario while the recording wrappers were
    in place: it had bound ``rgw.sse_check``'s wrapper by name, so every
    HEAD through the port's front end recorded a call the reference's did
    not.  ``run_recorded`` imports every module of the package first, and
    the scenario stays equal."""
    tests = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tests), str(tests.parent)]))
    res = subprocess.run([sys.executable, "-c", FIRST_IMPORT_WHILE_RECORDING],
                         cwd=tests.parent, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "twin-ok" in res.stdout
