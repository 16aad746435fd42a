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


# (wrapper, plain version, input shapes): the encode-variant kernels; a
# shape of two is a (B, C) stripe batch, which only the byte kernel takes
VARIANT_KERNELS = [
    ("gf2_apply_words_cmp", ck.gf2_apply_words_cmp_plain,
     [(4096,), (4097 * 4,), (12,)]),
    ("gf2_apply_words_split2", ck.gf2_apply_words_split2_plain,
     [(4096,), (4097 * 4,), (12,)]),
    ("gf2_apply_u8_split2", ck.gf2_apply_u8_split2_plain,
     [(4096,), (4097 * 4,), (1001,), (5, 96)]),
]
VARIANT_CASES = [(name, plain, shape) for name, plain, shapes
                 in VARIANT_KERNELS for shape in shapes]


@pytest.mark.parametrize("coeff", ["encode", "gate_edge_32x32", "one_row"])
@pytest.mark.parametrize("name,plain,shape", VARIANT_CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in VARIANT_CASES])
def test_variant_kernels_match_plain(cuda, name, plain, shape, coeff):
    mat = {"encode": generator_matrix("reed_sol_van", 8, 4)[8:],
           "gate_edge_32x32": np.random.default_rng(1).integers(
               0, 256, (32, 32), dtype=np.uint8),
           "one_row": np.random.default_rng(2).integers(
               0, 256, (1, 1000), dtype=np.uint8)}[coeff]
    consts = ck.ShardApply(mat).consts
    on_bytes = name == "gf2_apply_u8_split2"
    full = (shape[0], consts.kin, shape[1]) if len(shape) == 2 \
        else (consts.kin,) + shape
    data = _u8(full, 7, cuda)
    arg = data if on_bytes else ck.bytes_to_words(data)
    mat_t = consts.plain_bm(cuda) if on_bytes else consts.plain_bm32(cuda)
    before = ck.LAUNCHES[name]
    got = ck.KERNELS[name](consts, arg)
    assert ck.LAUNCHES[name] == before + 1
    assert torch.equal(got, plain(mat_t, arg))


@pytest.mark.parametrize("variant", ck.ENCODE_VARIANTS)
def test_shard_apply_launches_the_routed_kernel(cuda, variant):
    """Under each variant the entries launch exactly ``route``'s kernel:
    the variant's for an unblocked matrix, B1 for a blocked one."""
    prev = ck.get_encode_variant()
    ck.set_encode_variant(variant)
    try:
        for coeff in (generator_matrix("reed_sol_van", 8, 4)[8:],
                      np.random.default_rng(3).integers(
                          0, 256, (20, 60), dtype=np.uint8)):
            ap = ck.ShardApply(coeff)
            data = _u8((ap.kin, 8192), 5, cuda)
            before = dict(ck.LAUNCHES)
            got = ap.apply_bytes(data)
            name = ap.route(8192)
            assert ck.LAUNCHES[name] == before[name] + 1
            assert sum(ck.LAUNCHES.values()) == sum(before.values()) + 1
            assert torch.equal(got, ck.gf2_apply_u8_plain(
                ap.consts.plain_bm(cuda), data))
    finally:
        ck.set_encode_variant(prev)


@pytest.mark.parametrize("shape", [(8, 1 << 16), (8, 1001), (3,)])
def test_roof_copy_kernel_matches_plain(cuda, shape):
    from ceph_tpu_torch.testing import perf_lab

    words = torch.from_numpy(np.random.default_rng(4).integers(
        -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).to(cuda)
    before = perf_lab.LAUNCHES["roof_copy_xor"]
    got = perf_lab.roof_copy_xor(words)
    assert perf_lab.LAUNCHES["roof_copy_xor"] == before + 1
    assert torch.equal(got, perf_lab.roof_copy_xor_plain(words))


def _int32(shape, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).to(device)


@pytest.mark.parametrize("tile", [2048, 4096, 8192, 16384])
@pytest.mark.parametrize("case", ["encode", "ragged", "blocked_w32"])
def test_tiled_words_kernel_matches_plain(cuda, tile, case):
    """B1 at each tile of the lab's sweep: the encode matrix at a length
    that is a whole number of tiles and a ragged one, and a blocked matrix
    (kin = 128 > one table chunk) that re-stages per column group."""
    if case == "blocked_w32":
        ec = ErasureCodeJaxRS({"k": "4", "m": "2",
                               "technique": "reed_sol_van", "w": "32"},
                              device=cuda)
        consts = ck.ShardApply(ec.full_bm[4 * 32:]).consts
        n4 = 3 * tile + 5
    else:
        consts = ck.ShardApply(
            generator_matrix("reed_sol_van", 8, 4)[8:]).consts
        n4 = 4 * tile if case == "encode" else 3 * tile + 1001
    words = _int32((consts.kin, n4), tile, cuda)
    before = ck.LAUNCHES["gf2_apply_words"]
    got = ck.gf2_apply_words(consts, words, tile=tile)
    assert ck.LAUNCHES["gf2_apply_words"] == before + 1
    assert torch.equal(got, ck.gf2_apply_words(consts, words))
    assert torch.equal(got, ck.gf2_apply_words_plain(
        consts.plain_bm32(cuda), words))


@pytest.mark.parametrize("shape", [(8, 1 << 16), (8, 1001), (3, 257),
                                   (13, 4096), (1, 3)])
def test_unpack_repack_kernel_matches_plain(cuda, shape):
    from ceph_tpu_torch.testing import perf_lab

    words = _int32(shape, 6, cuda)
    before = perf_lab.LAUNCHES["unpack_repack_words"]
    got = perf_lab.unpack_repack_words(words)
    assert perf_lab.LAUNCHES["unpack_repack_words"] == before + 1
    assert torch.equal(got, perf_lab.unpack_repack_words_plain(words))
    assert torch.equal(got, words)


@pytest.mark.parametrize("n", [4096, 1000, 1003, 64, 5])
def test_roof_matmul_kernel_matches_plain(cuda, n):
    """Asymmetric int8 over the whole range (a transposed fragment would
    not pass), at whole and ragged tiles, n % 8 != 0 included."""
    from ceph_tpu_torch.testing import perf_lab

    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.integers(-128, 128, (128, 256)).astype(
        np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-128, 128, (256, n)).astype(
        np.int8)).to(cuda)
    before = perf_lab.LAUNCHES["roof_matmul_s8"]
    got = perf_lab.roof_matmul_s8(a, b)
    assert perf_lab.LAUNCHES["roof_matmul_s8"] == before + 1
    assert torch.equal(got, perf_lab.roof_matmul_s8_plain(a, b))


def test_device_loop_times_the_card_and_counts_one_launch(cuda):
    """The lab's roof_copy step through the device-loop timer: a positive
    time, and only the eager warm-up counted as a launch (the captured
    calls launch nothing; the replays do not pass through the wrapper)."""
    from ceph_tpu_torch.ec import benchmark
    from ceph_tpu_torch.testing import perf_lab

    words = _int32((8, 1 << 16), 8, cuda)
    out = torch.empty_like(words)
    step = perf_lab.carry_step(lambda w: perf_lab.roof_copy_xor(w, out=out))
    before = perf_lab.LAUNCHES["roof_copy_xor"]
    sec = benchmark.device_seconds_per_iter(step, words, lo=8, hi=40)
    assert sec > 0
    assert perf_lab.LAUNCHES["roof_copy_xor"] == before + 1
