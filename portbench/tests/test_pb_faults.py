"""``correct`` against planted breaks, at a size the CPU runs: the
control (a cheaper parity in every parity shard) and each fault a cell
can have must read false, and the same run unbroken true."""

import pytest

from portbench import faults
from portbench.tests.small import run_small

CASES = [
    ("rados_ec84.write", None),
    ("rados_ec84.write", "xor_parity"),
    ("rados_ec84.write", "unchanged_write"),
    ("rados_ec84.write", "half_batch"),
    ("rados_ec84.write", "dropped_exchange"),
    ("rados_ec84.write", "altered_read"),
    ("rados_ec84.read_degraded", None),
    ("rados_ec84.read_degraded", "xor_parity"),
    ("rados_ec84.read_degraded", "half_decode"),
    ("rados_ec84.read_degraded", "altered_read"),
]
PLANTS = {"xor_parity": faults.xor_parity, **faults.FAULTS}


@pytest.mark.parametrize("cell,plant", CASES,
                         ids=[f"{c}-{p}" for c, p in CASES])
def test_correct_reads_each_break(cell, plant):
    if plant is None:
        result, _ = run_small(cell)
        assert result["correct"], result["checks"]
        return
    with PLANTS[plant]():
        result, _ = run_small(cell)
    assert not result["correct"], result["checks"]
