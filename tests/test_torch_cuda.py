"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip where there is no CUDA device, and run on a
machine with one by

    python -m pytest -m cuda tests/test_torch_cuda.py -q

chip_smoke.py runs the same comparisons at the main path's full shapes.
Run on a card with ``--noconftest`` (tests/conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import corpus
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec.matrix import generator_matrix
from ceph_tpu_torch.ec.plugins.jax_rs import ErasureCodeJaxRS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _u8(shape, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8)).to(device)


@pytest.mark.parametrize("n", [4096, 4097 * 4, 12])
def test_words_kernel_matches_plain(cuda, n):
    consts = ck.ShardApply(generator_matrix("reed_sol_van", 8, 4)[8:]).consts
    words = ck.bytes_to_words(_u8((8, n), n, cuda))
    before = ck.LAUNCHES["gf2_apply_words"]
    got = ck.gf2_apply_words(consts, words)
    assert ck.LAUNCHES["gf2_apply_words"] == before + 1
    want = ck.gf2_apply_words_plain(consts.plain_bm32(cuda), words)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(8, 4096), (8, 1001), (5, 8, 96)])
def test_u8_kernel_matches_plain(cuda, shape):
    consts = ck.ShardApply(generator_matrix("cauchy_good", 8, 4)[8:]).consts
    data = _u8(shape, 3, cuda)
    before = ck.LAUNCHES["gf2_apply_u8"]
    got = ck.gf2_apply_u8(consts, data)
    assert ck.LAUNCHES["gf2_apply_u8"] == before + 1
    assert torch.equal(got, ck.gf2_apply_u8_plain(consts.plain_bm(cuda), data))


def test_packet_matrix_w32(cuda):
    ec = ErasureCodeJaxRS({"k": "4", "m": "2", "technique": "reed_sol_van",
                           "w": "32"}, device=cuda)
    consts = ck.ShardApply(ec.full_bm[4 * 32:]).consts
    data = _u8((16, 128, 64), 4, cuda)
    assert torch.equal(ck.gf2_apply_u8(consts, data),
                       ck.gf2_apply_u8_plain(consts.plain_bm(cuda), data))


def test_corpus_on_the_card(cuda):
    assert corpus.check(device=cuda) == []


def _sparse(mout, kin, per_row, seed):
    rng = np.random.default_rng(seed)
    coeff = np.zeros((mout, kin), np.uint8)
    for i in range(mout):
        cols = rng.choice(kin, size=per_row, replace=False)
        coeff[i, cols] = rng.integers(1, 256, per_row)
    return coeff


# (mout, kin, per_row, seed): the CLAY k=8 m=4 d=11 operator's shape, a
# matrix with short groups and the pair-padding group, and one whose group
# tables route it to the paired kernel
GROUPED_CASES = [(64, 176, 15, 1), (30, 120, 9, 2), (512, 2048, 8, 5)]


@pytest.mark.parametrize("case", GROUPED_CASES)
@pytest.mark.parametrize("layout", ["words", "bytes", "batch", "ragged"])
def test_grouped_kernels_match_plain(cuda, case, layout):
    plan = ck.GroupedPlan(_sparse(*case))
    assert plan.profitable
    kin = plan.kin
    shape = {"words": (kin, 4096), "bytes": (kin, 8192),
             "batch": (6, kin, 1024), "ragged": (kin, 1001)}[layout]
    data = _u8(shape, case[3], cuda)
    if layout == "words":
        data = ck.bytes_to_words(data)
    row_dim = data.ndim - 2
    gathered = data.index_select(row_dim, plan.gather_index(cuda))
    for name, fn, plain, arg in [
            ("gf2_apply_grouped", ck.gf2_apply_grouped,
             ck.gf2_apply_grouped_plain, data),
            ("gf2_apply_grouped_paired", ck.gf2_apply_grouped_paired,
             ck.gf2_apply_grouped_paired_plain, gathered)]:
        before = ck.LAUNCHES[name]
        got = fn(plan, arg)
        assert ck.LAUNCHES[name] == before + 1
        assert torch.equal(got, plain(plan, arg)), name


def test_grouped_apply_routes(cuda):
    small = ck.GroupedApply(_sparse(64, 176, 15, 1))
    large = ck.GroupedApply(_sparse(512, 2048, 8, 5))
    assert small.plan.fused and not large.plan.fused
    for ap, name in [(small, "gf2_apply_grouped"),
                     (large, "gf2_apply_grouped_paired")]:
        data = _u8((3, ap.kin, 512), 9, cuda)
        before = dict(ck.LAUNCHES)
        got = ap(data)
        assert ck.LAUNCHES[name] == before[name] + 1
        assert sum(ck.LAUNCHES.values()) == sum(before.values()) + 1
        assert torch.equal(got, ck.gf2_apply_grouped_plain(ap.plan, data))
