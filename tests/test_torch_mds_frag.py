"""The port's directory fragments and balancer against the JAX
package's.

The scenarios of tests/test_mds_frag.py (automatic splits and merges, a
large directory over many fragments, fragments under snapshots and under
a multi-active export, churn against a model) and tests/test_mds_balancer.py
(loads in ``mds stat``, the balancer exporting a hot subtree, ``fs
status``) run on both packages, the port's daemons on ``device="cpu"``,
each with its transcript equal across them (see tests/test_torch_cephfs.py).
"""

import pytest

from test_torch_cephfs import run_fs_twin
from test_torch_rgw import scenarios

SCENARIOS = [*scenarios("test_mds_frag"), *scenarios("test_mds_balancer")]


@pytest.mark.parametrize("ref,name", SCENARIOS)
def test_frag_and_balancer_scenario_equal_across_packages(ref, name,
                                                          monkeypatch):
    run_fs_twin(ref, name, monkeypatch)
