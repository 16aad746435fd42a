"""The port's CephFS recovery tools and volumes against the JAX
package's.

The scenarios of tests/test_journal_tool.py (``cephfs-journal-tool``:
inspect, export, event listing, reset, the table verbs),
tests/test_data_scan.py (``cephfs-data-scan``: metadata rebuilt from the
data pool's backtraces, orphans to lost+found, backtraces that follow
promotions and symlinks) and tests/test_volumes_insights.py (subvolumes
and their groups, sizes, snapshots and clones, the insights report) run on
both packages, the port's daemons on ``device="cpu"``, each with its
transcript equal across them (see tests/test_torch_cephfs.py): each tool
run with its arguments, return code and standard output too.
"""

import pytest

from test_torch_cephfs import run_fs_twin
from test_torch_rgw import scenarios

SCENARIOS = [*scenarios("test_journal_tool"), *scenarios("test_data_scan"),
             *scenarios("test_volumes_insights")]


# A unit scenario that calls nothing the transcript records (the journal
# tool's frame walker over bytes it builds): it holds its own assertions
# on both packages.
UNRECORDED = {"test_walk_frames_pure"}


@pytest.mark.parametrize("ref,name", SCENARIOS)
def test_fs_tool_scenario_equal_across_packages(ref, name, monkeypatch,
                                                tmp_path):
    run_fs_twin(ref, name, monkeypatch, compare=name not in UNRECORDED,
                tmp_path=tmp_path)
