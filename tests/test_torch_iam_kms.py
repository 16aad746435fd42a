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

import pytest

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
