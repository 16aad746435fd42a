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


# L1's edges: n of 1 and 3 words (head or tail only), 4000 (under one
# block's 1024 units of 4 words), 4096 and 16384 (whole blocks); input and
# output offsets in words past 16-byte alignment, equal (head, units, tail)
# or different (every word on the plain path).
@pytest.mark.parametrize("n", [1, 3, 4000, 4096, 16384, 1_000_003])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (1, 2), (0, 1),
                                     (3, 0)])
def test_roof_copy_kernel_edges(cuda, n, offsets):
    from ceph_tpu_torch.testing import perf_lab

    a, b = offsets
    src = _int32((n + a,), n + a, cuda)[a:]
    out = torch.zeros(n + b, dtype=torch.int32, device=cuda)[b:]
    before = perf_lab.LAUNCHES["roof_copy_xor"]
    assert perf_lab.roof_copy_xor(src, out=out) is out
    assert perf_lab.LAUNCHES["roof_copy_xor"] == before + 1
    assert torch.equal(out, perf_lab.roof_copy_xor_plain(src))


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


# B1's field-table kernel: every matrix shape the main path gives it, rows
# strided in and out, ragged lengths, at the production launch and at each
# tile of the lab's sweep
B1_MATRICES = {
    "encode": lambda: generator_matrix("reed_sol_van", 8, 4)[8:],
    "random_32x32": lambda: np.random.default_rng(32).integers(
        0, 256, (32, 32), dtype=np.uint8),
    "blocked_w32": lambda: ErasureCodeJaxRS(
        {"k": "4", "m": "2", "technique": "reed_sol_van", "w": "32"},
        device="cpu").full_bm[4 * 32:],
    "one_row_40": lambda: np.random.default_rng(5).integers(
        1, 256, (1, 40), dtype=np.uint8),
}


@pytest.mark.parametrize("tile", [None, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("n4", [3 * 4096 + 1001, 4099, 3])
@pytest.mark.parametrize("matrix", sorted(B1_MATRICES))
def test_field_table_kernel_strided_ragged(cuda, matrix, n4, tile):
    consts = ck.ShardApply(B1_MATRICES[matrix]()).consts
    big = _int32((consts.kin, n4 + 37), n4, cuda)
    words = big[:, 5:5 + n4]                 # row stride n4 + 37, offset 5
    out_big = torch.zeros((consts.mout, n4 + 12), dtype=torch.int32,
                          device=cuda)
    out = out_big[:, 4:4 + n4]
    before = ck.LAUNCHES["gf2_apply_words"]
    got = ck.gf2_apply_words(consts, words, out=out, tile=tile)
    assert ck.LAUNCHES["gf2_apply_words"] == before + 1
    assert got is out
    want = ck.gf2_apply_words_plain(consts.plain_bm32(cuda),
                                    words.contiguous())
    assert torch.equal(out, want)
    assert int(out_big[:, :4].abs().sum()) == 0
    assert int(out_big[:, 4 + n4:].abs().sum()) == 0


@pytest.mark.parametrize("shape", [(8, 1 << 18), (17, 70001), (9, 4100),
                                   (8, 4099), (2, 256)])
def test_unpack_repack_tiles_and_edges(cuda, shape):
    """Many tiles per block (the persistent grid), row-block and column
    edges, n4 % 4 != 0 (no 16-byte access), and a base that is only 4-byte
    aligned."""
    from ceph_tpu_torch.testing import perf_lab

    words = _int32(shape, 9, cuda)
    flat = _int32((shape[0] * shape[1] + 1,), 10, cuda)
    offset = flat[1:].view(shape)            # contiguous, 4-byte aligned
    for x in (words, offset):
        before = perf_lab.LAUNCHES["unpack_repack_words"]
        got = perf_lab.unpack_repack_words(x)
        assert perf_lab.LAUNCHES["unpack_repack_words"] == before + 1
        assert torch.equal(got, x)


# The byte view's edges (csrc/gf2_io.cuh): (B, k, C) batches whose 16-byte
# units straddle segments (C = 1001, C = 5), the k=16 repair's C = 16, the
# CLAY batch's C = 1024, rows strided past their data, and input and output
# bases 4 bytes off 16-byte alignment (edge path only)
BYTE_EDGES = [
    ("c1024", (3, 1024), 0, 0), ("c1001", (3, 1001), 0, 0),
    ("c16", (9, 16), 0, 0), ("c5", (7, 5), 0, 0),
    ("c1024_strided", (3, 1024), 0, 48), ("c16_strided", (9, 16), 0, 16),
    ("c1024_base4", (3, 1024), 4, 0), ("stream_base4", (4100,), 4, 0),
]


def _byte_edge(shape, rows, base, pad, seed, device):
    """(rows, N) or (B, rows, C) uint8 whose rows are `pad` bytes longer
    than their data and whose first byte is `base` bytes past a 16-byte
    boundary (torch allocations are 16-byte aligned)."""
    full = (shape[0], rows, shape[1] + pad) if len(shape) == 2 \
        else (rows, shape[0] + pad)
    n = int(np.prod(full))
    flat = _u8((n + base,), seed, device)[base:]
    x = flat.view(full)
    return x[..., :x.shape[-1] - pad] if pad else x


@pytest.mark.parametrize("edge", BYTE_EDGES, ids=[e[0] for e in BYTE_EDGES])
@pytest.mark.parametrize("coeff", ["encode", "decode", "blocked_w32"])
def test_u8_kernel_byte_edges(cuda, edge, coeff):
    """B2 on field tables at every edge of the byte view, its output
    written through the same strided, offset layout (nothing else
    written)."""
    _, shape, base, pad = edge
    mat = B1_MATRICES["blocked_w32"]() if coeff == "blocked_w32" else \
        generator_matrix("reed_sol_van", 8, 4)[8:] if coeff == "encode" \
        else np.random.default_rng(7).integers(1, 256, (4, 8),
                                               dtype=np.uint8)
    consts = ck.ShardApply(mat).consts
    data = _byte_edge(shape, consts.kin, base, pad, 11, cuda)
    out = _byte_edge(shape, consts.mout, base, pad, 12, cuda)
    padded = out.as_strided(out.shape[:-1] + (out.shape[-1] + pad,),
                            out.stride())
    keep = padded.clone()
    before = ck.LAUNCHES["gf2_apply_u8"]
    got = ck.gf2_apply_u8(consts, data, out=out)
    assert ck.LAUNCHES["gf2_apply_u8"] == before + 1
    assert got is out
    assert torch.equal(out, ck.gf2_apply_u8_plain(consts.plain_bm(cuda),
                                                  data.contiguous()))
    # the row padding is untouched
    assert torch.equal(padded[..., out.shape[-1]:], keep[..., out.shape[-1]:])


@pytest.mark.parametrize("edge", BYTE_EDGES, ids=[e[0] for e in BYTE_EDGES])
@pytest.mark.parametrize("case", GROUPED_CASES[:2] + [(10, 96, 5, 3)],
                         ids=["clay_shape", "short_groups", "pair_padding"])
def test_grouped_kernels_byte_edges(cuda, case, edge):
    """B3 and B4 on field tables at every edge of the byte view, for the
    CLAY operator's shape, short groups and the pair-padding group."""
    _, shape, base, pad = edge
    plan = ck.GroupedPlan(_sparse(*case))
    data = _byte_edge(shape, plan.kin, base, pad, case[3], cuda)
    row_dim = data.ndim - 2
    gathered = data.index_select(row_dim, plan.gather_index(cuda))
    if base or pad:
        gathered = _byte_edge(shape, gathered.shape[row_dim], base, pad, 0,
                              cuda).copy_(gathered)
    for name, fn, plain, arg in [
            ("gf2_apply_grouped", ck.gf2_apply_grouped,
             ck.gf2_apply_grouped_plain, data),
            ("gf2_apply_grouped_paired", ck.gf2_apply_grouped_paired,
             ck.gf2_apply_grouped_paired_plain, gathered)]:
        out = _byte_edge(shape, plan.mout, base, pad, 13, cuda)
        before = ck.LAUNCHES[name]
        assert fn(plan, arg, out=out) is out
        assert ck.LAUNCHES[name] == before + 1
        assert torch.equal(out, plain(plan, arg.contiguous())), name


# The split2 kernels (two units per thread, 512 units per block): lengths
# whose last block has only its first half live (2560 words, 9216 bytes),
# both halves (3328 words, 13312 bytes), a ragged last unit and a single
# ragged unit; rows strided in and out, bases 16-byte aligned or 4 bytes
# off; and the byte view's edges
SPLIT2_MATRICES = ("encode", "random_32x32", "one_row_40")


@pytest.mark.parametrize("offset", [4, 5], ids=["aligned", "base4"])
@pytest.mark.parametrize("n4", [2560, 3328, 3257, 3])
@pytest.mark.parametrize("matrix", SPLIT2_MATRICES)
def test_split2_words_kernel_strided_ragged(cuda, matrix, n4, offset):
    """B5b on field tables, its output written through the same strided
    layout (nothing else written)."""
    consts = ck.ShardApply(B1_MATRICES[matrix]()).consts
    big = _int32((consts.kin, n4 + 36), n4, cuda)
    words = big[:, offset:offset + n4]         # row stride n4 + 36
    out_big = torch.zeros((consts.mout, n4 + 36), dtype=torch.int32,
                          device=cuda)
    out = out_big[:, offset:offset + n4]
    before = ck.LAUNCHES["gf2_apply_words_split2"]
    got = ck.gf2_apply_words_split2(consts, words, out=out)
    assert ck.LAUNCHES["gf2_apply_words_split2"] == before + 1
    assert got is out
    assert torch.equal(out, ck.gf2_apply_words_split2_plain(
        consts.plain_bm32(cuda), words.contiguous()))
    assert int(out_big[:, :offset].abs().sum()) == 0
    assert int(out_big[:, offset + n4:].abs().sum()) == 0


SPLIT2_BYTE_EDGES = BYTE_EDGES + [("stream_half0_last", (9216,), 0, 0),
                                  ("stream_both_last", (13312,), 0, 0)]


@pytest.mark.parametrize("edge", SPLIT2_BYTE_EDGES,
                         ids=[e[0] for e in SPLIT2_BYTE_EDGES])
@pytest.mark.parametrize("coeff", ["encode", "decode", "random_32x32"])
def test_split2_u8_kernel_byte_edges(cuda, edge, coeff):
    """B5c on field tables at every edge of the byte view and at both kinds
    of last block, its output written through the same strided, offset
    layout (nothing else written)."""
    _, shape, base, pad = edge
    mat = B1_MATRICES["random_32x32"]() if coeff == "random_32x32" else \
        generator_matrix("reed_sol_van", 8, 4)[8:] if coeff == "encode" \
        else np.random.default_rng(7).integers(1, 256, (4, 8),
                                               dtype=np.uint8)
    consts = ck.ShardApply(mat).consts
    data = _byte_edge(shape, consts.kin, base, pad, 11, cuda)
    out = _byte_edge(shape, consts.mout, base, pad, 12, cuda)
    padded = out.as_strided(out.shape[:-1] + (out.shape[-1] + pad,),
                            out.stride())
    keep = padded.clone()
    before = ck.LAUNCHES["gf2_apply_u8_split2"]
    got = ck.gf2_apply_u8_split2(consts, data, out=out)
    assert ck.LAUNCHES["gf2_apply_u8_split2"] == before + 1
    assert got is out
    assert torch.equal(out, ck.gf2_apply_u8_split2_plain(
        consts.plain_bm(cuda), data.contiguous()))
    assert torch.equal(padded[..., out.shape[-1]:], keep[..., out.shape[-1]:])


# -- the OSD path: the device CRC and a resident backend ---------------------

@pytest.mark.parametrize("shape", [(12, 65536), (768, 4096)],
                         ids=["write_path", "scrub_group"])
def test_crc_bits_device_matches_plain(cuda, shape):
    from ceph_tpu_torch.common.crc32c import crc32c
    from ceph_tpu_torch.ec import checksum as cs

    streams = _u8(shape, 21, cuda)
    before = ck.LAUNCHES["gf2_apply_u8"]
    bits = cs.crc_bits_device(streams)
    assert ck.LAUNCHES["gf2_apply_u8"] == before + 1
    assert bits.device == streams.device
    consts = cs.crc_constants(shape[1])
    plain = ck.gf2_apply_u8_plain(consts.plain_bm(cuda),
                                  streams.t().contiguous()).t()
    assert torch.equal(bits, plain)
    host = streams[:3].cpu().numpy()
    assert cs.finalize_crcs(bits[:3].cpu().numpy(), [cs.CRC_SEED] * 3,
                            shape[1]) == [
        crc32c(cs.CRC_SEED, r.tobytes()) for r in host]


def test_resident_backend_round_trip(cuda):
    import asyncio

    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShard
    from ceph_tpu_torch.store import CollectionId, MemStore, Transaction

    async def run():
        codec = ErasureCodePluginRegistry().factory(
            "jax_rs", {"k": "4", "m": "2"}, device=cuda)
        store = MemStore()
        shards = {}
        for i in range(6):
            cid = CollectionId(1, 0, shard=i)
            await store.queue_transactions(
                Transaction().create_collection(cid))
            shards[i] = LocalShard(store, cid, pool=1, shard=i)
        be = ECBackend(codec, shards, stripe_unit=1024, resident=True,
                       resident_writeback=True)
        assert be.device == cuda and be.resident.device == cuda
        datas = {f"o{i}": np.random.default_rng(i).integers(
            0, 256, 16384, np.uint8).tobytes() for i in range(8)}
        await asyncio.gather(*(be.write(o, d) for o, d in datas.items()))
        ent = be.resident.get("", "o0", 0, count=False)
        assert ent.arr.device == cuda
        assert await be.read("o3") == datas["o3"]
        await be.flush_resident()
        scrub = await be.scrub_batch(sorted(datas))
        assert all(r["clean"] and r["hinfo"]
                   for r in scrub["reports"].values())
        await be.resident.evict(target=0)
        for o, d in datas.items():
            assert await be.read(o) == d

    asyncio.run(run())
