"""The port's CephFS caps and forward scrub against the JAX package's.

The scenarios of tests/test_fs_caps.py (the exclusive write cap, its
recall and flush, a dead holder revoked on timeout, session listing and
eviction) and tests/test_fs_scrub.py (the forward scrub, its damage table
and repairs, the admin command guard) run on both packages, the port's
daemons on ``device="cpu"``, each with its transcript equal across them
(see tests/test_torch_cephfs.py).
"""

import pytest

from test_torch_cephfs import run_fs_twin
from test_torch_rgw import scenarios

SCENARIOS = [*scenarios("test_fs_caps"), *scenarios("test_fs_scrub")]


@pytest.mark.parametrize("ref,name", SCENARIOS)
def test_caps_and_scrub_scenario_equal_across_packages(ref, name,
                                                       monkeypatch,
                                                       tmp_path):
    run_fs_twin(ref, name, monkeypatch, tmp_path=tmp_path)
