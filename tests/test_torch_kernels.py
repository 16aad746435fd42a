"""The port's GF(2) kernels, by their plain versions on the CPU, against the
JAX package's Pallas kernels run in interpret mode on the same inputs.

Exact equality throughout: both sides compute GF(2) sums of bits.  The
CUDA kernels themselves run only on a card; chip_smoke.py holds them
against these same plain versions there (and tests/test_torch_cuda.py,
marked ``cuda``).
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import matrix as j_matrix
from ceph_tpu.ec import pallas_kernels as pk
from ceph_tpu.ec import reference as j_ref
from ceph_tpu.ec.plugins.jax_rs import ErasureCodeJaxRS as JaxCodec
from ceph_tpu_torch.ec import cuda_kernels as ck


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _rs84():
    return j_matrix.generator_matrix("reed_sol_van", 8, 4)


def _decode_84():
    G = _rs84()
    return j_ref.decode_matrix(G, [4, 5, 6, 7, 8, 9, 10, 11], [0, 1, 2, 3])


def _packet_w16():
    ec = JaxCodec({"k": "5", "m": "3", "technique": "reed_sol_van",
                   "w": "16"})
    return ec.full_bm[5 * 16:]


# (label, coefficient matrix, N4 lanes)
WORD_CASES = [
    ("encode_k8_m4", lambda: _rs84()[8:], 256),
    ("decode_4_erasures", _decode_84, 256),
    ("blocked_w16", _packet_w16, 128),
    ("ragged_n4", lambda: _rs84()[8:], 301),
]


@pytest.mark.parametrize("label,coeff_fn,n4", WORD_CASES,
                         ids=[c[0] for c in WORD_CASES])
def test_words_plain_matches_pallas(label, coeff_fn, n4):
    coeff = coeff_fn()
    jap = pk.PallasShardApply(coeff, interpret=True)
    if label == "blocked_w16":
        assert jap.kblk < jap.kin          # the TPU kernel's blocked path
    words = _words((coeff.shape[1], n4), seed=n4)
    expect = np.asarray(jap.apply_words(words))
    ap = ck.ShardApply(coeff)
    got = ap.apply_words(torch.from_numpy(words))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), expect)


@pytest.mark.parametrize("n", [512, 1000])
def test_u8_plain_matches_pallas_u8_variant(n):
    coeff = _rs84()[8:]
    data = _bytes((8, n), seed=n)
    prev = pk.get_encode_variant()
    pk.set_encode_variant("enc_u8_expand")
    try:
        expect = np.asarray(
            pk.PallasShardApply(coeff, interpret=True).apply_bytes(data))
    finally:
        pk.set_encode_variant(prev)
    consts = ck.ShardApply(coeff).consts
    got = ck.gf2_apply_u8(consts, torch.from_numpy(data))
    assert np.array_equal(got.numpy(), expect)


def test_u8_plain_batched_and_any_length():
    """(B, k, C) stripe batches and lengths that are not a multiple of 4
    (which the TPU kernels refuse) against the numpy oracle."""
    G = _rs84()
    consts = ck.ShardApply(G[8:]).consts
    data = _bytes((3, 8, 37), seed=7)
    got = ck.gf2_apply_u8(consts, torch.from_numpy(data)).numpy()
    for b in range(3):
        assert np.array_equal(got[b], j_ref.encode(G, data[b])[8:])


def test_lane_views_match_jax():
    data = _bytes((3, 64), seed=3)
    words = ck.bytes_to_words(torch.from_numpy(data))
    assert np.array_equal(words.numpy(), np.asarray(pk.bytes_to_words(data)))
    assert np.array_equal(ck.words_to_bytes(words).numpy(), data)
    with pytest.raises(ValueError):
        ck.bytes_to_words(torch.zeros((2, 6), dtype=torch.uint8))


def test_column_table_applies_bitmatrix():
    """table[r, c, j] byte i == BM[8r+i, 8c+j], replicated in 4 bytes."""
    bm = np.random.default_rng(9).integers(0, 2, (16, 24), dtype=np.uint8)
    tab = ck.column_table(bm)
    assert tab.shape == (2, 3, 8)
    for r, c, j, i in [(0, 0, 0, 0), (1, 2, 7, 7), (1, 0, 3, 5)]:
        byte = int(tab[r, c, j]) & 0xFF
        assert (byte >> i) & 1 == bm[8 * r + i, 8 * c + j]
        assert int(tab[r, c, j]) == byte * 0x01010101


def test_from_lane_bitmatrix_roundtrip():
    coeff = _packet_w16()
    jap = pk.PallasShardApply(coeff, interpret=True)
    want = ck.ShardApply(coeff).consts.bitmatrix
    ap = ck.ShardApply.from_lane_bitmatrix(jap.bm32, jap.kin)
    assert np.array_equal(ap.consts.bitmatrix, want)
    # zero contraction padding (the TPU kernel's kpad) is dropped
    padded = np.pad(jap.bm32, ((0, 0), (0, 64)))
    ap = ck.ShardApply.from_lane_bitmatrix(padded, jap.kin)
    assert np.array_equal(ap.consts.bitmatrix, want)
    bad = np.array(jap.bm32)
    bad[0, 8] ^= 1                   # breaks the block-diagonal structure
    with pytest.raises(ValueError):
        ck.ShardApply.from_lane_bitmatrix(bad, jap.kin)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA gets no fallback."""
    consts = ck.ShardApply(_rs84()[8:]).consts
    with pytest.raises(ValueError):
        ck.gf2_apply_words(consts, torch.empty((8, 4), dtype=torch.int32,
                                               device="meta"))
    with pytest.raises(ValueError):
        ck.gf2_apply_u8(consts, torch.empty((8, 16), dtype=torch.uint8,
                                            device="meta"))
    with pytest.raises(TypeError):
        ck.gf2_apply_words(consts, torch.zeros((8, 4), dtype=torch.int64))


def test_plain_versions_count_no_launches():
    ck.reset_launch_counts()
    ap = ck.ShardApply(_rs84()[8:])
    prev = ck.get_encode_variant()
    try:
        for variant in ck.ENCODE_VARIANTS:
            ck.set_encode_variant(variant)
            ap(torch.from_numpy(_bytes((2, 8, 64), seed=1)))
            ap.apply_words(torch.from_numpy(_words((8, 16), seed=1)))
    finally:
        ck.set_encode_variant(prev)
    assert ck.LAUNCHES == {"gf2_apply_words": 0, "gf2_apply_u8": 0,
                           "gf2_apply_words_cmp": 0,
                           "gf2_apply_words_split2": 0,
                           "gf2_apply_u8_split2": 0,
                           "gf2_apply_grouped": 0,
                           "gf2_apply_grouped_paired": 0}


def test_encode_variant_selection(monkeypatch):
    prev = ck.get_encode_variant()
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        ck.set_encode_variant("auto")
        assert ck.get_encode_variant() == ""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        ck.set_encode_variant("auto")
        assert ck.get_encode_variant() == "enc_u8_expand"
        with pytest.raises(ValueError):
            ck.set_encode_variant("nope")
        for name in ("enc_cmp_expand", "enc_split2", "enc_u8_split2"):
            ck.set_encode_variant(name)
            assert ck.get_encode_variant() == name
        assert ck.ENCODE_VARIANTS == pk.ENCODE_VARIANTS
    finally:
        ck.set_encode_variant(prev)


@pytest.mark.parametrize("variant", ck.ENCODE_VARIANTS)
def test_shard_apply_variants_agree(variant):
    """Both formulations behind apply_bytes / __call__ give the oracle's
    bytes, 2-D and batched, including into a strided output view."""
    G = _rs84()
    data = _bytes((4, 8, 128), seed=11)
    prev = ck.get_encode_variant()
    ck.set_encode_variant(variant)
    try:
        ap = ck.ShardApply(G[8:])
        got = ap(torch.from_numpy(data)).numpy()
        out = torch.zeros((4, 12, 128), dtype=torch.uint8)
        ap(torch.from_numpy(data), out=out[:, 8:])
        flat = np.ascontiguousarray(data.transpose(1, 0, 2).reshape(8, -1))
        got2 = ap.apply_bytes(torch.from_numpy(flat)).numpy()
    finally:
        ck.set_encode_variant(prev)
    for b in range(4):
        want = j_ref.encode(G, data[b])[8:]
        assert np.array_equal(got[b], want)
        assert np.array_equal(out[b, 8:].numpy(), want)
        assert np.array_equal(got2[:, b * 128:(b + 1) * 128], want)
