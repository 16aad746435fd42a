"""The lab's copy kernel (L1, csrc/lab_copy.cu ``roof_copy_xor``) and the
sweeps of kernel builds (ceph_tpu_torch.testing.copy_builds and
split2_builds) on the CPU.

The kernel runs only on a card; here its split of the words is modelled as
the source writes it: head words up to the input's first 16-byte boundary,
16-byte units from there, tail words, or every word plain when the input
and output lie at different offsets mod 16; a grid of ``THREADS``-thread
blocks over max(units, plain words), thread t taking unit t and plain word
t.  The model must cover every word exactly once, with every unit 16-byte
aligned in both buffers, and ``x ^ 1`` through it must equal the port's
plain version and the JAX lab's Pallas body (ceph_tpu/testing/perf_lab.py
exp_roof_copy, its kernel and BlockSpecs) in interpret mode.  Tolerance:
exact (integer XOR).  The sweeps' builds are checked against the
committed sources, so that a sweep cannot go stale.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ceph_tpu_torch.common import cuda_build
from ceph_tpu_torch.testing import builds, copy_builds, perf_lab
from ceph_tpu_torch.testing import split2_builds

SOURCE = (cuda_build.CSRC_DIR / "lab_copy.cu").read_text()
THREADS = int(re.search(r"constexpr int THREADS = (\d+);", SOURCE).group(1))
BLOCK_WORDS = 4 * THREADS
OFFSETS = [0, 4, 8, 12]     # bytes past 16-byte alignment


def split_of(a: int, b: int, n: int):
    """lab_copy.cu split_of for an input at byte offset a and an output at
    b (mod 16): (head words, 16-byte units, tail words)."""
    if a % 16 != b % 16:
        return n, 0, 0
    head = min(n, (16 - a % 16) % 16 // 4)
    units = (n - head) // 4
    return head, units, n - head - 4 * units


def model_copy(x: np.ndarray, a: int, b: int) -> np.ndarray:
    """``x ^ 1`` as the kernel computes it, word by word, for an input at
    byte offset a and an output at b; asserts that every word is written
    exactly once and every unit is aligned."""
    n = x.size
    head, units, tail = split_of(a, b, n)
    plain = head + tail
    blocks = -(-max(units, plain) // THREADS)
    assert blocks * THREADS >= max(units, plain)   # one of each per thread
    out = np.zeros(n, np.int32)
    hits = np.zeros(n, np.int64)
    j = np.arange(plain)
    w = np.where(j < head, j, j + 4 * units)
    out[w] = x[w] ^ 1
    hits[w] += 1
    t = np.arange(units)
    first = head + 4 * t
    assert np.all((a + 4 * first) % 16 == 0)
    assert np.all((b + 4 * first) % 16 == 0)
    words = (first[:, None] + np.arange(4)).ravel()
    out[words] = x[words] ^ 1
    hits[words] += 1
    assert np.array_equal(hits, np.ones(n, np.int64))
    return out


def _words(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -2**31, 2**31, n, dtype=np.int64).astype(np.int32)


@settings(max_examples=150, deadline=None)
@given(n=st.integers(1, 3 * BLOCK_WORDS + 7), a=st.sampled_from(OFFSETS),
       b=st.sampled_from(OFFSETS))
def test_model_covers_every_word_once(n, a, b):
    x = _words(n, n)
    got = model_copy(x, a, b)
    assert np.array_equal(
        got, perf_lab.roof_copy_xor_plain(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("a,b,want", [
    (0, 0, (0, 250, 0)), (4, 4, (3, 249, 1)), (8, 8, (2, 249, 2)),
    (12, 12, (1, 249, 3)), (4, 8, (1000, 0, 0)), (0, 12, (1000, 0, 0))])
def test_split_of_a_thousand_words(a, b, want):
    assert split_of(a, b, 1000) == want


@pytest.mark.parametrize("n", [1, 3, BLOCK_WORDS - 48, BLOCK_WORDS,
                               4 * BLOCK_WORDS])
def test_split_edges(n):
    """n = 1 and 3 (plain words only, whatever the offset), under one
    block, one block and four: units cover all but at most 3 + 3 words."""
    for a in OFFSETS:
        head, units, tail = split_of(a, a, n)
        assert head + 4 * units + tail == n
        assert head <= 3 and tail <= 3
        if n < 4:
            assert units == 0
        if a == 0:
            assert (head, tail) == (0, n % 4)


def _pallas_roof_copy(words: np.ndarray) -> np.ndarray:
    """exp_roof_copy's pallas_call (ceph_tpu/testing/perf_lab.py:150-165):
    its body and BlockSpecs, tile 8192, in interpret mode."""
    kin, n4 = words.shape
    tile = 8192

    def kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:] ^ 1

    call = pl.pallas_call(
        kernel,
        grid=(n4 // tile,),
        in_specs=[pl.BlockSpec((kin, tile), lambda t: (0, t),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((kin, tile), lambda t: (0, t),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((kin, n4), jnp.int32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(words)))


@pytest.mark.parametrize("a,b", [(0, 0), (4, 4), (4, 12)])
def test_model_equals_the_pallas_body(a, b):
    x = _words(8 * 16384, 3).reshape(8, 16384)
    want = _pallas_roof_copy(x)
    got = model_copy(x.ravel(), a, b).reshape(x.shape)
    assert np.array_equal(got, want)
    assert np.array_equal(
        perf_lab.roof_copy_xor_plain(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("a,b", [(1, 1), (1, 2), (0, 3), (3, 0)])
@pytest.mark.parametrize("use_out", [False, True])
def test_wrapper_on_cpu_views_off_alignment(a, b, use_out):
    """The wrapper on CPU tensors whose data start 4-12 bytes past an
    allocation: the plain version, with and without ``out=``, no launch
    counted."""
    n = 1001
    base = torch.from_numpy(_words(n + a, 5))
    x = base[a:]
    perf_lab.reset_launch_counts()
    if use_out:
        out = torch.zeros(n + b, dtype=torch.int32)[b:]
        assert perf_lab.roof_copy_xor(x, out=out) is out
        got = out
    else:
        got = perf_lab.roof_copy_xor(x)
    assert torch.equal(got, x ^ 1)
    assert perf_lab.LAUNCHES["roof_copy_xor"] == 0


@pytest.mark.parametrize("build", sorted(copy_builds.BUILDS))
def test_copy_build_edits_apply_once(build):
    files = builds.sources([], "committed")
    for name, old, new in copy_builds.BUILDS[build]:
        assert name == "lab_copy.cu"
        assert files[name].count(old) == 1, (build, old)
        assert old != new
    copy_builds.sources(build)


def test_copy_builds_name_every_design():
    """The builds the sweep must time, the in-flight figure of each, and
    one probe that is not a candidate."""
    for name in ("kept", "v1", "unroll2", "unroll4", "persistent",
                 "stream_hints", "bulk", "probe_read"):
        assert name in copy_builds.BUILDS
    assert set(copy_builds.IN_FLIGHT) == set(copy_builds.BUILDS)
    assert copy_builds.PROBES == {"probe_read"}
    assert copy_builds.BUILDS["kept"] == []


@pytest.mark.parametrize("module", [copy_builds, split2_builds],
                         ids=["copy_builds", "split2_builds"])
def test_kept_is_the_committed_source(module):
    committed = {p.name: p.read_text()
                 for p in cuda_build.CSRC_DIR.iterdir()
                 if p.suffix in (".cu", ".cuh")}
    assert module.sources("kept") == committed


def test_shared_helper_refuses_a_stale_edit():
    with pytest.raises(ValueError, match="stale: edit of lab_copy.cu"):
        builds.sources([("lab_copy.cu", "no such text", "x")], "stale")


@pytest.mark.parametrize("registers,smem,threads,want", [
    (17, 0, 512, 4), (28, 0, 256, 8), (82, 0, 256, 2), (29, 65536, 256, 3),
    (29, 16384, 256, 8), (64, 0, 1024, 1)])
def test_resident_blocks(registers, smem, threads, want):
    assert copy_builds.resident_blocks(registers, smem, threads) == want


def test_sweeps_need_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert copy_builds.main(["kept"]) == 1
    assert split2_builds.main(["kept"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
