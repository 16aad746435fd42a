"""The split2 kernels (csrc/gf2_variants.cu: B5b ``gf2_apply_words_split2``,
B5c ``gf2_apply_u8_split2``) on the CPU.

Both are csrc/gf2_io.cuh's field-table kernel with two units per thread.
The kernels run only on a card; here they are modelled thread by thread in
numpy as the source writes them: block b of ``2 * THREADS`` units gives
thread i the units ``b * 2 * THREADS + i`` and that plus ``THREADS``, each
found once, before any row is read; a unit past the end of the data is
dead (zeros in, no store), and a thread whose first unit is dead does
nothing.  B5b keeps one loop that tests each unit per row; B5c takes an
interior-only loop (one 16-byte access per unit and row) when both of its
units are interior, else that same per-row test.  Each unit's words go
through the field-table arithmetic of tests/test_torch_fields.py; the
byte view is tests/test_torch_byte_io.py's flat-memory model.  The model
is held equal to the port's plain versions, to the JAX package's einsum
and to the Pallas bodies (``_kernel_split2``, ``_kernel_u8_split2``) in
interpret mode, at small widths whose last block has only its first half
live, or both halves.  Tolerance: exact (GF(2) sums of bits).
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import engine as j_engine
from ceph_tpu.ec import matrix as j_matrix
from ceph_tpu.ec import pallas_kernels as pk
from ceph_tpu.ec import reference as j_ref
from ceph_tpu_torch.ec import cuda_kernels as ck
from tests.test_torch_byte_io import _read_out, _view
from tests.test_torch_fields import _words, model_apply_words

THREADS = 256   # gf2_io.cuh FIELD_THREADS
HALVES = 2      # units per thread
VEC = 4         # words per unit
CPU = torch.device("cpu")


@dataclasses.dataclass
class WordUnit:
    """gf2_io.cuh WordUnit: word w0 of row 0, n words inside the row."""
    w0: int
    n: int
    vec: bool


class WordView:
    """gf2_io.cuh WordIO over a flat memory of uint32 words (addresses in
    words from the start of the memory, which is 16-byte aligned)."""

    def __init__(self, mem, omem, inp, out, n4, in_stride, out_stride):
        self.mem, self.omem = mem, omem
        self.inp, self.out = inp, out
        self.n4, self.in_stride, self.out_stride = n4, in_stride, out_stride
        self.vec_ok = all(x % 4 == 0 for x in (inp, out, in_stride,
                                                out_stride))
        self.units = 0

    def threads_needed(self):
        return -(-self.n4 // VEC)

    def unit(self, t):
        self.units += 1
        n = min(VEC, self.n4 - VEC * t)
        return WordUnit(VEC * t, n, self.vec_ok and n == VEC)

    def load(self, u, c):
        a = self.inp + c * self.in_stride + u.w0
        if u.vec:
            assert a % 4 == 0, "LDG.128 at an unaligned address"
            return self.mem[a:a + VEC].copy()
        return np.array([self.mem[a + v] if v < u.n else 0
                         for v in range(VEC)], np.uint32)

    def store(self, u, r, words):
        a = self.out + r * self.out_stride + u.w0
        assert not u.vec or a % 4 == 0, "STG.128 at an unaligned address"
        for v in range(max(u.n, 0)):
            self.omem[a + v] = words[v]


def model_split2(view, bitmatrix, kin, mout, split):
    """Run the two-units kernel over ``view``; returns the paths the live
    threads took, as {(path, unit 0 vec, unit 1 live): threads}.  ``split``
    picks the path once per thread (B5c); otherwise every thread runs the
    loop that tests each unit per row (B5b)."""
    T = view.threads_needed()
    blocks = -(-T // (HALVES * THREADS))
    units, paths = [], collections.Counter()
    for b in range(blocks):
        for i in range(THREADS):
            t = [b * HALVES * THREADS + i + h * THREADS
                 for h in range(HALVES)]
            us = [view.unit(x) for x in t]         # found once, both halves
            live = [x < T for x in t]
            if not live[0]:
                continue
            path = "vec" if split and all(u.vec for u in us) else "any"
            paths[path, us[0].vec, live[1]] += 1
            if path == "vec":
                assert all(u.vec for u in us)
            units += [(u, lv) for u, lv in zip(us, live)]
    # every unit's rows, read row by row through the view (a dead unit
    # reads zeros), then the field-table arithmetic on all of them at once
    words = np.zeros((kin, VEC * len(units)), np.uint32)
    for j, (u, _) in enumerate(units):
        for c in range(kin):
            words[c, VEC * j:VEC * j + VEC] = \
                np.asarray(view.load(u, c)).view("<u4")
    res = model_apply_words(bitmatrix, words.view(np.int32)).view(np.uint32)
    for j, (u, live) in enumerate(units):
        if not live:
            continue
        for r in range(mout):
            got = res[r, VEC * j:VEC * j + VEC]
            view.store(u, r, got if isinstance(view, WordView)
                       else got.view(np.uint8))
    # each unit found once, dead ones included (ByteIO: one division each)
    found = view.units if isinstance(view, WordView) else view.divisions
    assert found == HALVES * THREADS * blocks
    return paths


def _rs84():
    return j_matrix.generator_matrix("reed_sol_van", 8, 4)


MATRICES = {
    "encode": lambda: _rs84()[8:],
    "decode_4_erasures": lambda: j_ref.decode_matrix(
        _rs84(), [4, 5, 6, 7, 8, 9, 10, 11], [0, 1, 2, 3]),
    "gate_32x32": lambda: np.random.default_rng(32).integers(
        0, 256, (32, 32), dtype=np.uint8),
    "one_row_40": lambda: np.random.default_rng(5).integers(
        1, 256, (1, 40), dtype=np.uint8),
}

# N4 (words) and the last block of 512 units it leaves: 2560 -> 128 units,
# only the first half live; 3328 -> 320, both halves; 3257 -> 303 with a
# ragged last unit; 3 -> one ragged unit
WORD_LENGTHS = [2560, 3328, 3257, 3]


def _word_view(words, mout, base=0, pad=0):
    """(kin, n4) words in a flat memory at word ``base``, each row ``pad``
    words longer than its data; an output memory laid out alike."""
    kin, n4 = words.shape
    stride = n4 + pad
    mem = np.full(base + kin * stride + 8, 0xEEEEEEEE, np.uint32)
    for c in range(kin):
        mem[base + c * stride:base + c * stride + n4] = words[c].view("<u4")
    omem = np.full(base + mout * stride + 8, 0xEEEEEEEE, np.uint32)
    return WordView(mem, omem, base, base, n4, stride, stride)


def _word_out(view, mout):
    return np.stack([view.omem[view.out + r * view.out_stride:
                               view.out + r * view.out_stride + view.n4]
                     for r in range(mout)]).view(np.int32)


@pytest.mark.parametrize("n4", WORD_LENGTHS)
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_b5b_model_matches_plain_and_pallas(matrix, n4):
    """B5b's two units per thread against the plain version and, at
    lengths the Pallas grid tiles exactly, ``_kernel_split2`` in interpret
    mode."""
    coeff = np.asarray(MATRICES[matrix](), np.uint8)
    consts = ck.ShardApply(coeff).consts
    words = _words((consts.kin, n4), seed=n4)
    view = _word_view(words, consts.mout)
    paths = model_split2(view, consts.bitmatrix, consts.kin, consts.mout,
                         split=False)
    assert set(p for p, _, _ in paths) == {"any"}
    got = _word_out(view, consts.mout)
    plain = ck.gf2_apply_words_split2_plain(consts.plain_bm32(CPU),
                                            torch.from_numpy(words)).numpy()
    assert np.array_equal(got, plain)
    if n4 % 256 == 0:
        jap = pk.PallasShardApply(coeff, interpret=True)
        expect = np.asarray(pk._pallas_apply_words_variant(
            jnp.asarray(jap.bm32), jnp.asarray(words), tile=256,
            variant="enc_split2", interpret=True))
        assert np.array_equal(got, expect)


@pytest.mark.parametrize("base,pad", [(1, 0), (0, 5), (4, 8)],
                         ids=["base_4_bytes_off", "row_stride_odd",
                              "strided_aligned"])
def test_b5b_model_strided_and_unaligned(base, pad):
    """Rows strided past their data and a base 4 bytes off 16-byte
    alignment (every unit on the word-by-word path), nothing written
    outside the output rows."""
    coeff = _rs84()[8:]
    consts = ck.ShardApply(coeff).consts
    words = _words((8, 3257), seed=base + pad)
    view = _word_view(words, consts.mout, base, pad)
    before = view.omem.copy()
    model_split2(view, consts.bitmatrix, 8, 4, split=False)
    got = _word_out(view, 4)
    plain = ck.gf2_apply_words_plain(consts.plain_bm32(CPU),
                                     torch.from_numpy(words)).numpy()
    assert np.array_equal(got, plain)
    written = np.zeros(view.omem.shape, bool)
    for r in range(4):
        a = base + r * view.out_stride
        written[a:a + 3257] = True
    assert np.array_equal(view.omem[~written], before[~written])


# (label, shape, base address, row padding): byte streams whose last block
# has only its first half live (9216 bytes: 576 units) or both halves
# (13312: 832 units), a ragged stream, a base 4 bytes off, and the (B, k,
# C) batch at C = 1024, 1001 (no 16-byte access; a base 4 bytes off) and 16
BYTE_LAYOUTS = [
    ("stream_half0_last", (8, 9216), 0, 0),
    ("stream_both_last", (8, 13312), 0, 0),
    ("stream_ragged", (8, 8001), 0, 0),
    ("stream_base4", (8, 9216), 4, 0),
    ("batch_c1024", (9, 8, 1024), 0, 0),
    ("batch_c1001_base4", (9, 8, 1001), 4, 0),
    ("batch_c16_strided", (40, 8, 16), 0, 32),
]


@pytest.mark.parametrize("label,shape,base,pad", BYTE_LAYOUTS,
                         ids=[x[0] for x in BYTE_LAYOUTS])
@pytest.mark.parametrize("matrix", ["encode", "decode_4_erasures"])
def test_b5c_model_matches_plain_and_jax(label, shape, base, pad, matrix):
    """B5c's two units per thread over the byte view, each thread's path
    picked once, against the plain version and the JAX engine's einsum;
    nothing outside the output's rows written."""
    coeff = MATRICES[matrix]()
    consts = ck.ShardApply(coeff).consts
    data = np.random.default_rng(len(label)).integers(0, 256, shape,
                                                      dtype=np.uint8)
    view, oshape = _view(data, base, pad, consts.mout)
    before = view.omem.copy()
    model_split2(view, consts.bitmatrix, consts.kin, consts.mout, split=True)
    got = _read_out(view, oshape, base, pad).reshape(oshape)
    plain = ck.gf2_apply_u8_split2_plain(consts.plain_bm(CPU),
                                         torch.from_numpy(data)).numpy()
    assert np.array_equal(got, plain)
    want = np.asarray(j_engine.BitplaneEngine(use_pallas=False)
                      .apply(coeff, data))
    assert np.array_equal(got, want)
    written = set()
    nseg = oshape[0] if len(oshape) == 3 else 1
    for s in range(nseg):
        for r in range(consts.mout):
            a = base + s * view.out_seg + r * view.out_row
            written.update(range(a, a + oshape[-1]))
    assert set(np.nonzero(view.omem != before)[0].tolist()) <= written


@pytest.mark.parametrize("n", [9216, 13312])
@pytest.mark.parametrize("matrix", ["encode", "gate_32x32"])
def test_b5c_model_matches_pallas_u8_split2(matrix, n):
    """The stream cases against ``_kernel_u8_split2`` itself in interpret
    mode (its (kin, 4, nq) slot layout is the (kin, 4*nq) stream
    reshaped)."""
    coeff = MATRICES[matrix]()
    consts = ck.ShardApply(coeff).consts
    data = np.random.default_rng(n).integers(0, 256, (consts.kin, n),
                                             dtype=np.uint8)
    view, oshape = _view(data, 0, 0, consts.mout)
    model_split2(view, consts.bitmatrix, consts.kin, consts.mout, split=True)
    got = _read_out(view, oshape, 0, 0).reshape(oshape)
    jap = pk.PallasShardApply(coeff, interpret=True)
    out8 = np.asarray(pk._pallas_apply_u8_variant(
        jnp.asarray(jap.bm32), jnp.asarray(data.reshape(consts.kin, 4, -1)),
        tile=256, variant="enc_u8_split2", interpret=True))
    assert np.array_equal(got, out8.reshape(oshape))


def test_each_thread_takes_its_own_path():
    """Full blocks of an aligned stream take the interior-only loop; in
    the last block of 9216 bytes (64 live units) a thread whose second
    unit is dead takes the per-row test with its first unit interior; at
    C = 1001 with a base 4 bytes off no unit is interior."""
    consts = ck.ShardApply(_rs84()[8:]).consts
    data = np.zeros((8, 9216), np.uint8)
    view, _ = _view(data, 0, 0, 4)
    paths = model_split2(view, consts.bitmatrix, 8, 4, split=True)
    assert paths == {("vec", True, True): 256, ("any", True, False): 64}
    view, _ = _view(np.zeros((9, 8, 1001), np.uint8), 4, 0, 4)
    paths = model_split2(view, consts.bitmatrix, 8, 4, split=True)
    # 9009 bytes = 564 units: one full block, then 52 threads with one
    # live unit
    assert paths == {("any", False, True): 256, ("any", False, False): 52}
    words = np.zeros((8, 3328), np.int32)
    paths = model_split2(_word_view(words, 4), consts.bitmatrix, 8, 4,
                         split=False)
    assert paths == {("any", True, True): 256 + 64,
                     ("any", True, False): 256 - 64}


class _Stop(Exception):
    pass


def test_split2_kernels_take_the_field_tables(monkeypatch):
    """B5b's and B5c's wrappers hand their kernels GF2Constants.fields; B5a
    keeps the column table (GF2Constants.table), its only user.  Both
    getters are spied on a machine without CUDA: the spy stops the launch
    there, before any library is loaded."""
    seen = []

    def spy(what):
        def get(self, device):
            seen.append(what)
            raise _Stop
        return get

    monkeypatch.setattr(ck.GF2Constants, "fields", spy("fields"))
    monkeypatch.setattr(ck.GF2Constants, "table", spy("table"))
    monkeypatch.setattr(ck, "_require_cuda", lambda name, t: None)
    consts = ck.ShardApply(_rs84()[8:]).consts
    words = torch.empty((8, 64), dtype=torch.int32, device="meta")
    data = torch.empty((8, 256), dtype=torch.uint8, device="meta")
    for fn, arg, want in ((ck.gf2_apply_words_split2, words, "fields"),
                          (ck.gf2_apply_u8_split2, data, "fields"),
                          (ck.gf2_apply_words_cmp, words, "table")):
        seen.clear()
        with pytest.raises(_Stop):
            fn(consts, arg)
        assert seen == [want], fn.__name__
