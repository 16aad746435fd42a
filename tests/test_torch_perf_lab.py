"""The port's perf lab (ceph_tpu_torch.testing.perf_lab) on the CPU.

With ``device="cpu"`` every experiment runs through the plain versions,
checks bit identity (the variants against the production kernel's plain
version, the production and tiled steps against the numpy oracle) and
skips timing, as the JAX lab does off a TPU.  B1's tile argument is held
to the JAX ``_pallas_apply_words(..., tile=)`` in interpret mode.  The
device-loop timer (``benchmark.device_seconds_per_iter``) is checked with
a stubbed graph and event clock.  The lab's kernels (L1-L3) run only on a
card: chip_smoke.py and tests/test_torch_cuda.py hold them against their
plain versions there.
"""

import contextlib
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import pallas_kernels as pk
from ceph_tpu.testing import perf_lab as j_lab
from ceph_tpu_torch.ec import benchmark
from ceph_tpu_torch.ec import cuda_kernels as ck
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
    assert lab.LAUNCHES == {name: 0 for name in lab.LAUNCHES}
    if name.startswith("enc_tile_"):
        assert rec["tile"] == int(name.rsplit("_", 1)[1])


def test_experiments_are_the_jax_labs_minus_the_unported():
    """The JAX lab's experiments, every one: none is left unported."""
    assert set(lab.EXPERIMENTS) == set(j_lab.EXPERIMENTS)
    assert len(lab.EXPERIMENTS) == 14
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
    assert lab.LAUNCHES["roof_copy_xor"] == 0


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


# -- B1's tile ------------------------------------------------------------------

@pytest.mark.parametrize("tile", lab.TILES)
def test_tiled_b1_is_the_jax_tiled_launch(small, tile):
    """gf2_apply_words(..., tile=t) against _pallas_apply_words(..., tile=t,
    kblk=ap.kblk) in interpret mode on the lab's data (256 stripes: (8,
    32768) words), the JAX lab's enc_tile_<t> step."""
    data, words = lab._data(torch.device("cpu"))
    G = np.asarray(lab._codec("cpu").generator[lab.K:], np.uint8)
    ap = pk.PallasShardApply(G, interpret=True)
    want = np.asarray(pk._pallas_apply_words(
        ap._bm32_arg(), pk.bytes_to_words(jnp.asarray(data)), tile=tile,
        kblk=ap.kblk, interpret=True))
    consts = ck.ShardApply(G).consts
    got = ck.gf2_apply_words(consts, words, tile=tile)
    assert np.array_equal(got.numpy(), want)
    out = torch.empty_like(got)
    assert ck.gf2_apply_words(consts, words, out=out, tile=tile) is out
    assert torch.equal(out, got)
    assert ck.LAUNCHES["gf2_apply_words"] == 0


@pytest.mark.parametrize("tile", [0, -1024, 1000, 1536, 1024.0, True,
                                  "2048"])
def test_bad_tiles_raise(tile):
    consts = ck.ShardApply(np.asarray(
        lab._codec("cpu").generator[lab.K:], np.uint8)).consts
    with pytest.raises(ValueError):
        ck.gf2_apply_words(consts, torch.zeros((8, 64), dtype=torch.int32),
                           tile=tile)


# -- launch counting under capture ------------------------------------------------

@pytest.mark.parametrize("capturing", [False, True])
def test_a_captured_call_is_not_a_launch(monkeypatch, capturing):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    counts = {"k": 3}
    ck.count_launch(counts, "k")
    assert counts["k"] == (3 if capturing else 4)


# -- the device-loop timer ------------------------------------------------------

def test_device_loop_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        benchmark.device_seconds_per_iter(lambda x: None, torch.zeros(1))


class _FakeCard:
    """A CUDA graph and event clock: a replay of a graph of n captured
    steps advances the clock by ``fixed + per_step * n`` ms (plus the next
    jitter value), and events read the clock."""

    def __init__(self, monkeypatch, per_step, fixed, jitter=(0.0,),
                 capture_fails=False):
        self.ms, self.capturing, self.eager = 0.0, None, 0
        self.jitter, self.replays = list(jitter), 0
        card = self

        class Graph:
            def __init__(self):
                self.steps = 0

            def replay(self):
                card.ms += (fixed + per_step * self.steps
                            + card.jitter[card.replays % len(card.jitter)])
                card.replays += 1

        @contextlib.contextmanager
        def graph(g):
            if capture_fails:
                raise RuntimeError("operation not permitted when stream is "
                                   "capturing")
            card.capturing = g
            try:
                yield
            finally:
                card.capturing = None

        class Event:
            def __init__(self, enable_timing=False):
                self.t = None

            def record(self):
                self.t = card.ms

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                return end.t - self.t

        for name, value in (("is_available", lambda: True),
                            ("synchronize", lambda: None),
                            ("CUDAGraph", Graph), ("graph", graph),
                            ("Event", Event)):
            monkeypatch.setattr(torch.cuda, name, value)

    def step(self, x):
        if self.capturing is None:
            self.eager += 1
            x += 1
        else:
            self.capturing.steps += 1


def test_device_loop_differences_two_step_counts(monkeypatch):
    """(t_hi - t_lo) / (hi - lo): the fixed cost of a replay cancels, the
    step runs eagerly once, and lo and hi steps are captured."""
    card = _FakeCard(monkeypatch, per_step=0.0625, fixed=3.5)
    x = torch.zeros(1)
    sec = benchmark.device_seconds_per_iter(card.step, x, lo=64, hi=320)
    assert sec == pytest.approx(0.0625e-3)
    assert card.eager == 1 and int(x) == 1
    assert card.replays == 2 + 2 * 3          # warm pair + 3 trials


def test_device_loop_takes_the_median_of_the_trials(monkeypatch):
    """Jitter on one replay of each trial moves that trial's sample; the
    median of three ignores the outlier."""
    # replays: warm lo, warm hi, then (hi, lo) per trial
    jitter = [0.0, 0.0, 0.0, 0.0, 25.6, 0.0, 0.0, 0.0]
    card = _FakeCard(monkeypatch, per_step=0.01, fixed=1.0, jitter=jitter)
    sec = benchmark.device_seconds_per_iter(card.step, torch.zeros(1),
                                            lo=10, hi=138, trials=3)
    assert sec == pytest.approx(0.01e-3)


def test_device_loop_never_falls_back_to_eager_timing(monkeypatch):
    card = _FakeCard(monkeypatch, per_step=1.0, fixed=0.0,
                     capture_fails=True)
    with pytest.raises(RuntimeError, match="capturing"):
        benchmark.device_seconds_per_iter(card.step, torch.zeros(1))
    assert card.replays == 0


@pytest.mark.parametrize("lo,hi,trials", [(64, 64, 3), (0, 320, 3),
                                          (64, 320, 0)])
def test_device_loop_refuses_bad_counts(monkeypatch, lo, hi, trials):
    _FakeCard(monkeypatch, per_step=1.0, fixed=0.0)
    with pytest.raises(ValueError):
        benchmark.device_seconds_per_iter(lambda x: None, torch.zeros(1),
                                          lo=lo, hi=hi, trials=trials)


@pytest.mark.parametrize("name", sorted(lab.EXPERIMENTS))
def test_every_step_runs_into_preallocated_outputs(monkeypatch, small, name):
    """Each experiment's timed step (its kernel into a preallocated output,
    then the JAX step's carry) run on the CPU as the device loop runs it:
    the carry changes the first element of the input (or, for
    enc_row_carry, row 0) and nothing else."""
    seen = {}

    def loop(step, x, lo=64, hi=320, trials=3):
        before = x.clone()
        for _ in range(3):
            step(x)
        seen["changed"] = (x != before).reshape(x.shape[0], -1)
        return 1e-4

    orig = lab._check_and_time

    def check_and_time(step, x, expect, got, nbytes):
        rec = orig(step, x, expect, got, nbytes)
        benchmark.device_seconds_per_iter(step, x)
        return rec

    monkeypatch.setattr(benchmark, "device_seconds_per_iter", loop)
    monkeypatch.setattr(lab, "_check_and_time", check_and_time)
    assert lab.run_experiment(name, device="cpu")["bit_identical"]
    changed = seen["changed"]
    assert not changed[1:].any()
    if name != "enc_row_carry":
        assert not changed[0, 1:].any()
