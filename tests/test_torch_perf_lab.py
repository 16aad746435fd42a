"""The port's perf lab (ceph_tpu_torch.testing.perf_lab) on the CPU.

With ``device="cpu"`` every experiment runs through the plain versions,
checks bit identity (the variants against the production kernel's plain
version, the production step against the numpy oracle) and skips timing,
as the JAX lab does off a TPU.  The lab's copy kernel (L1) runs only on a
card: chip_smoke.py and tests/test_torch_cuda.py hold it against its plain
version there.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from ceph_tpu.testing import perf_lab as j_lab
from ceph_tpu_torch.testing import perf_lab as lab

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setenv("PERF_LAB_STRIPES", "256")


@pytest.mark.parametrize("name", sorted(lab.EXPERIMENTS))
def test_experiment_bit_identical_on_cpu(small, name):
    lab.reset_launch_counts()
    rec = lab.run_experiment(name, device="cpu")
    assert rec["exp"] == name
    assert rec["bit_identical"] is True
    assert rec["skipped_timing"] == "non-cuda device"
    assert "sec" not in rec and "gibps" not in rec
    assert rec["device"] == "cpu"
    assert lab.LAUNCHES == {"roof_copy_xor": 0}


def test_experiments_are_the_jax_labs_minus_the_unported():
    """Same names as the JAX lab; what is missing is L2, L3 and the tile
    sweep, still to port."""
    missing = set(j_lab.EXPERIMENTS) - set(lab.EXPERIMENTS)
    assert set(lab.EXPERIMENTS) <= set(j_lab.EXPERIMENTS)
    assert missing == {"roof_matmul", "unpack_only", "enc_tile_2048",
                       "enc_tile_4096", "enc_tile_8192", "enc_tile_16384"}
    assert (lab.K, lab.M, lab.CHUNK) == (j_lab.K, j_lab.M, j_lab.CHUNK)


def test_roof_copy_plain_is_xor_one():
    x = np.random.default_rng(0).integers(-2**31, 2**31, (8, 1001),
                                          dtype=np.int64).astype(np.int32)
    x[0, :3] = [-2**31, 2**31 - 1, 0]
    got = lab.roof_copy_xor(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), x ^ 1)
    out = torch.zeros((8, 1001), dtype=torch.int32)
    assert lab.roof_copy_xor(torch.from_numpy(x), out=out) is out
    assert np.array_equal(out.numpy(), x ^ 1)
    assert lab.LAUNCHES == {"roof_copy_xor": 0}


def test_roof_copy_refuses_other_devices_and_types():
    with pytest.raises(ValueError):
        lab.roof_copy_xor(torch.empty((8, 4), dtype=torch.int32,
                                      device="meta"))
    with pytest.raises(TypeError):
        lab.roof_copy_xor(torch.zeros((8, 4), dtype=torch.int64))


@pytest.mark.parametrize("stripes", ["100", "0", "-64"])
def test_stripes_knob_is_a_multiple_of_64(monkeypatch, stripes):
    monkeypatch.setenv("PERF_LAB_STRIPES", stripes)
    with pytest.raises(ValueError):
        lab.stripes()


def test_no_device_means_cuda(monkeypatch, small):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        lab.run_experiment("enc_base")


def test_main_prints_a_line_per_experiment_and_writes_no_file(
        monkeypatch, small, capsys):
    """Without a card every experiment reports its error, main returns 1,
    and the JAX package's PERF_LAB.jsonl is untouched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    record = REPO / "PERF_LAB.jsonl"
    before = record.read_bytes()
    assert lab.main(["roof_copy", "enc_split2", "nope"]) == 1
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["exp"] for r in lines] == ["roof_copy", "enc_split2", "nope"]
    assert all("error" in r for r in lines)
    assert record.read_bytes() == before


SASS = """
        Function : _Z6kernelv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LOP3.LUT R2, R3, R4, RZ, 0xc0, !PT ;
""" + "".join(f"        /*{0x20 + 16 * i:04x}*/                   "
              f"{'PRMT' if i % 2 else 'LOP3.LUT'} R5, R6, R7, R8 ;\n"
              for i in range(70)) + """
        /*0480*/              @!P0 BRA 0x10 ;
        /*0490*/                   EXIT ;
        /*04a0*/                   BRA 0x4a0;
        Function : _Z5shortv
        /*0000*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0010*/              @P0 BRA 0x0 ;
"""


def test_sass_loops_counts_each_loop_body():
    """A backward branch closes a loop; its body's length and opcode mix
    are reported, loops of MIN_BODY instructions or fewer are not."""
    from ceph_tpu_torch.testing import sass

    found = sass.loops(SASS)
    assert list(found) == ["_Z6kernelv", "_Z5shortv"]
    assert found["_Z5shortv"] == []
    (n, ops), = found["_Z6kernelv"]
    assert n == 72                    # 0x10 .. 0x480 inclusive
    assert ops["LOP3"] == 36 and ops["PRMT"] == 35 and ops["BRA"] == 1
