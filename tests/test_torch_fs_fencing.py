"""The port's client fencing, quotas and trash, and the MDS case of the
auth tests, against the JAX package's.

The scenarios of tests/test_blocklist.py (``osd blocklist`` fencing of an
instance and of a bare entity, expiry, the MDS's eviction that fences the
evicted session, an RBD lock broken with its holder fenced),
tests/test_trash_quota.py (RBD trash, CephFS directory quotas on files
and bytes), the MDS case of tests/test_auth.py (an MDS that joins a cephx
cluster with its own key, signed peering through an OSD's kill and
revival) run on both packages, the port's daemons on
``device="cpu"``, each with its transcript equal across them (see
tests/test_torch_cephfs.py).
"""

import pytest

from test_torch_cephfs import run_fs_twin
from test_torch_rgw import scenarios

SCENARIOS = [
    *scenarios("test_blocklist"),
    *scenarios("test_trash_quota"),
    *scenarios("test_auth",
               ["test_cephx_cephfs_and_recovery_under_signed_peering"]),
]


@pytest.mark.parametrize("ref,name", SCENARIOS)
def test_fencing_and_quota_scenario_equal_across_packages(ref, name,
                                                          monkeypatch,
                                                          tmp_path):
    run_fs_twin(ref, name, monkeypatch, tmp_path=tmp_path)
