"""The port's cross-rank MDS operations against the JAX package's.

The scenarios of tests/test_mds_cross_rank.py (directory renames and hard
links across ranks, repointing, promotion of a hard-linked primary, and
the crash repair of each intent) run on both packages, the port's daemons
on ``device="cpu"``, each with its transcript equal across them (see
tests/test_torch_cephfs.py).
"""

import pytest

from test_torch_cephfs import run_fs_twin
from test_torch_rgw import scenarios

SCENARIOS = scenarios("test_mds_cross_rank")


@pytest.mark.parametrize("ref,name", SCENARIOS)
def test_cross_rank_scenario_equal_across_packages(ref, name, monkeypatch):
    run_fs_twin(ref, name, monkeypatch)
