"""The port's multi-active MDS against the JAX package's.

The scenarios of tests/test_mds_multirank.py (two ranks serving disjoint
subtrees, exports and their nesting, cross-rank renames and their crash
replay, snapshots across rank boundaries, a rank's standby taking over)
and tests/test_mds_monitor.py (the ``fs`` commands, beacons, discovery,
failover to a standby) run on both packages, the port's daemons on
``device="cpu"``, each with its transcript equal across them (see
tests/test_torch_cephfs.py).
"""

import pytest

from test_torch_cephfs import run_fs_twin
from test_torch_rgw import scenarios

SCENARIOS = [*scenarios("test_mds_multirank"),
             *scenarios("test_mds_monitor")]

# Scenarios whose pool dump is taken once the MDSs have shut down.  In
# each, an MDS replays its journal (and so compacts it into the ino table)
# at a moment the beacons decide: after ``fs rm --force`` the still-running
# MDS's next beacon registers it again, the monitor hands it rank 0 with a
# takeover notice, and its replay re-applies the journal while the dump
# reads the pool (a dentry's size read 0 mid-replay, 6 after it); after a
# failover, the standby's first beacon ack as active starts a second replay
# that lands before or after the client's next create.  An MDS's shutdown
# waits for a replay under way and compacts, so the dump then sees one
# state: dirfrags and tables compared whole, the journal empty but for
# open rename intents.
MDS_FIRST = {"test_fs_commands_and_discovery",
             "test_mds_failover_to_standby",
             "test_rank1_failover_standby_takes_over"}


@pytest.mark.parametrize("ref,name", SCENARIOS)
def test_multirank_scenario_equal_across_packages(ref, name, monkeypatch):
    run_fs_twin(ref, name, monkeypatch, mds_first=name in MDS_FIRST)
