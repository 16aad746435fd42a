"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip where there is no CUDA device, and run on a
machine with one by

    python -m pytest -m cuda tests/test_torch_cuda.py -q

chip_smoke.py runs the same comparisons at the main path's full shapes.
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
