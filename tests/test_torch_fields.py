"""B1's field-table arithmetic (csrc/gf2_apply.cu ``gf2_words_kernel``) on
the CPU.

The kernel runs only on a card.  Its arithmetic is modelled here in numpy,
thread by thread as the source writes it: the host's ``field_tables``, the
selectors of a word pair (fields 0-2, 3-5 and 6-7 of each byte, a's in the
even nibbles and b's in the odd, lanes 0-1 in the low half and 2-3 in the
high half), ``prmt.b32``'s byte selection (default mode: nibble i picks
byte i of the result from the 8 bytes {lo, hi}; bit 3 would replicate a
sign, so the model refuses it), the interleaved accumulators and the two
``prmt`` that undo the interleave before the store.  The model is held
exact against the port's plain version and the JAX package's ``_kernel``
in interpret mode, on the matrices the main path gives B1.  Tolerance:
exact (GF(2) sums of bits).
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import matrix as j_matrix
from ceph_tpu.ec import pallas_kernels as pk
from ceph_tpu.ec import reference as j_ref
from ceph_tpu.ec.plugins.jax_rs import ErasureCodeJaxRS as JaxCodec
from ceph_tpu_torch.ec import bitmatrix as bm
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec import gf

VEC = 4     # words of a row per thread (gf2_io.cuh)


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    w.flat[:3] = [-2**31, 2**31 - 1, -1]
    return w


def prmt(lo, hi, sel):
    """prmt.b32 lo, hi, sel in its default mode, elementwise on uint32."""
    lo, hi, sel = (np.asarray(x, np.uint32) for x in (lo, hi, sel))
    pool = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    out = np.zeros(np.broadcast(lo, hi, sel).shape, np.uint32)
    for i in range(4):
        nib = (sel >> np.uint32(4 * i)) & np.uint32(0xF)
        assert not np.any(nib & 8), "selector sets the sign-replicate bit"
        byte = (pool >> (np.uint64(8) * nib.astype(np.uint64))) & 0xFF
        out |= byte.astype(np.uint32) << np.uint32(8 * i)
    return out


def field_selectors(a, b):
    """The source's six selectors of the word pair (a, b)."""
    a, b = np.asarray(a, np.uint32), np.asarray(b, np.uint32)
    u0 = (a & 0x07070707) | ((b << 4) & 0x70707070)
    u1 = ((a >> 3) & 0x07070707) | ((b << 1) & 0x70707070)
    u2 = ((a >> 6) & 0x03030303) | ((b >> 2) & 0x30303030)
    return [u0, u0 >> 16, u1, u1 >> 16, u2, u2 >> 16]


def model_apply_words(bitmatrix: np.ndarray, words: np.ndarray) -> np.ndarray:
    """(kin, N4) int32 -> (mout, N4) int32 through the kernel's arithmetic:
    every thread's 4 words as two pairs, zero past the ragged edge (the
    kernel's masked load), masked on the store."""
    fields = ck.field_tables(bitmatrix)                 # (m, k, 5) uint32
    mout, kin, _ = fields.shape
    n4 = words.shape[1]
    pad = -n4 % VEC
    w = np.pad(words.view(np.uint32), ((0, 0), (0, pad)))
    a, b = w[:, 0::2], w[:, 1::2]                       # the pairs
    sel = [field_selectors(a[c], b[c]) for c in range(kin)]
    out = np.zeros((mout, w.shape[1]), np.uint32)
    for r in range(mout):
        acc = [np.zeros(a.shape[1], np.uint32) for _ in range(2)]
        for c in range(kin):
            t = fields[r, c]
            s = sel[c]
            for h in range(2):
                acc[h] ^= (prmt(t[0], t[1], s[h]) ^ prmt(t[2], t[3], s[2 + h])
                           ^ prmt(t[4], t[4], s[4 + h]))
        out[r, 0::2] = prmt(acc[0], acc[1], 0x6420)
        out[r, 1::2] = prmt(acc[0], acc[1], 0x7531)
    return out[:, :n4].view(np.int32)


def _rs84():
    return j_matrix.generator_matrix("reed_sol_van", 8, 4)


def _packet(k, m, w):
    ec = JaxCodec({"k": str(k), "m": str(m), "technique": "reed_sol_van",
                   "w": str(w)})
    return ec.full_bm[k * w:]


# (label, coefficient matrix, N4): the headline encode, the 4-erasure
# decode, the w=16 and w=32 packet matrices (both blocked on the TPU) and a
# random 32 x 32 matrix (the encode variants' gate), one ragged length
MATRICES = [
    ("encode_k8_m4", lambda: _rs84()[8:], 256),
    ("decode_4_erasures", lambda: j_ref.decode_matrix(
        _rs84(), [4, 5, 6, 7, 8, 9, 10, 11], [0, 1, 2, 3]), 256),
    ("packet_w16", lambda: _packet(5, 3, 16), 128),
    ("packet_w32", lambda: _packet(4, 2, 32), 64),
    ("random_32x32", lambda: np.random.default_rng(32).integers(
        0, 256, (32, 32), dtype=np.uint8), 128),
    ("encode_ragged", lambda: _rs84()[8:], 301),
]


@pytest.mark.parametrize("label,coeff_fn,n4", MATRICES,
                         ids=[c[0] for c in MATRICES])
def test_model_matches_plain_and_pallas(label, coeff_fn, n4):
    coeff = np.asarray(coeff_fn(), np.uint8)
    words = _words((coeff.shape[1], n4), seed=n4)
    ap = ck.ShardApply(coeff)
    got = model_apply_words(ap.consts.bitmatrix, words)
    plain = ck.gf2_apply_words_plain(ap.consts.plain_bm32(torch.device("cpu")),
                                     torch.from_numpy(words)).numpy()
    assert np.array_equal(got, plain)
    jax = np.asarray(pk.PallasShardApply(coeff, interpret=True)
                     .apply_words(words))
    assert np.array_equal(got, jax)


def test_field_tables_are_the_byte_maps():
    """Words 0-1 hold M(v), 2-3 M(v << 3), 4 M(v << 6), byte v each, where
    M is block (r, c) of the bitmatrix applied to a byte."""
    bmat = np.random.default_rng(9).integers(0, 2, (16, 24), dtype=np.uint8)
    tab = ck.field_tables(bmat)
    assert tab.shape == (2, 3, 5) and tab.dtype == np.uint32
    B = bmat.reshape(2, 8, 3, 8)
    for r in range(2):
        for c in range(3):
            def m(x):
                bits = [(x >> j) & 1 for j in range(8)]
                return sum((int(np.dot(B[r, i, c], bits)) & 1) << i
                           for i in range(8))
            raw = tab[r, c].astype("<u4").view(np.uint8)
            assert list(raw[0:8]) == [m(v) for v in range(8)]
            assert list(raw[8:16]) == [m(v << 3) for v in range(8)]
            assert list(raw[16:20]) == [m(v << 6) for v in range(4)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_fields_cover_every_byte(seed):
    """M(x) = T0[x & 7] ^ T1[(x >> 3) & 7] ^ T2[x >> 6] for all 256 bytes:
    the linearity the kernel rests on."""
    bmat = np.random.default_rng(seed).integers(0, 2, (8, 8), dtype=np.uint8)
    raw = ck.field_tables(bmat)[0, 0].astype("<u4").view(np.uint8)
    maps = ck._byte_maps(bmat)[0, 0]
    x = np.arange(256)
    assert np.array_equal(raw[x & 7] ^ raw[8 + ((x >> 3) & 7)]
                          ^ raw[16 + (x >> 6)], maps)
    # and the byte maps are the GF(2^8) product for a coefficient's block
    coeff = np.uint8(seed * 37 + 5)
    block = bm.gf_matrix_to_bitmatrix(np.array([[coeff]], np.uint8))
    prod = ck._byte_maps(block)[0, 0]
    assert [int(gf.gf_mul(int(coeff), int(v))) for v in range(256)] == \
        [int(p) for p in prod]


def test_selectors_index_each_lane_and_never_sign_replicate():
    """Nibble 2i of the low half is field f of a's byte i (i = 0, 1), 2i+1
    of b's; the high half holds lanes 2-3.  No nibble sets bit 3."""
    a, b = np.uint32(0xF3C5A917), np.uint32(0x6E82B4D9)
    s = field_selectors(a, b)
    for f, (shift, width) in enumerate(ck.FIELDS):
        for h in range(2):
            sel = int(s[2 * f + h]) & 0xFFFF
            for i in range(2):
                lane = 2 * h + i
                fa = (int(a) >> (8 * lane + shift)) & ((1 << width) - 1)
                fb = (int(b) >> (8 * lane + shift)) & ((1 << width) - 1)
                assert (sel >> (8 * i)) & 0xF == fa
                assert (sel >> (8 * i + 4)) & 0xF == fb
    words = np.random.default_rng(4).integers(0, 2**32, (2, 4096),
                                              dtype=np.uint64).astype(np.uint32)
    for sel in field_selectors(words[0], words[1]):
        assert not np.any(sel & 0x8888)


def test_prmt_model_selects_bytes():
    lo, hi = 0x03020100, 0x07060504
    assert int(prmt(lo, hi, 0x7531)) == 0x07050301
    assert int(prmt(lo, hi, 0x6420)) == 0x06040200
    assert int(prmt(lo, hi, 0xFFFF0123)) == 0x00010203   # high half ignored
    with pytest.raises(AssertionError):
        prmt(lo, hi, 0x0008)


def test_field_tables_cached_per_device():
    consts = ck.ShardApply(_rs84()[8:]).consts
    cpu = torch.device("cpu")
    t = consts.fields(cpu)
    assert t is consts.fields(cpu)
    assert t.dtype == torch.int32 and tuple(t.shape) == (4, 8, 5)
    assert np.array_equal(t.numpy().view(np.uint32),
                          ck.field_tables(consts.bitmatrix))
