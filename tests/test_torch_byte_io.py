"""The byte view of the port's kernels (csrc/gf2_io.cuh ``ByteIO``) on the
CPU, and B2 (csrc/gf2_apply.cu ``gf2_apply_u8``) through it.

The kernels run only on a card.  How a thread finds its 16 bytes is
modelled here in numpy over a flat memory with explicit addresses, as the
header writes it: the thread's segment and offset found once (one
division), its two base pointers, a row one
``c * row_stride`` away; the interior path (``vec``: 16-byte aligned, the
whole unit in one segment) as one 16-byte access per row, and the edge
path as a byte walk that steps to the next segment's row at the end of
one.  The model is held against the layouts the wrappers accept: (kin, N)
streams of any N, the (B, kin, C) batch with C = 1024, 1001 and 16,
strided rows and a base 4 bytes off alignment.  B2's model (this view
around the field-table arithmetic of tests/test_torch_fields.py) is held
exact against the port's plain version, the JAX engine's einsum and the
JAX ``_kernel_u8`` in interpret mode.  Tolerance: exact.
"""

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
from tests.test_torch_fields import model_apply_words

UNIT = 16       # bytes per thread (gf2_io.cuh: VEC words)


@dataclasses.dataclass
class Unit:
    """gf2_io.cuh ByteUnit: addresses of row 0 of the unit's first byte."""
    inp: int
    out: int
    off: int
    n: int
    vec: bool


class ByteView:
    """gf2_io.cuh ByteIO over two flat memories (input and output), every
    address in bytes from the start of its memory, which is 16-byte
    aligned."""

    def __init__(self, mem, omem, inp, out, seg, nseg, in_row, in_seg,
                 out_row, out_seg):
        self.mem, self.omem = mem, omem
        self.inp, self.out = inp, out
        self.seg, self.nseg = seg, nseg
        self.in_row, self.in_seg = in_row, in_seg
        self.out_row, self.out_seg = out_row, out_seg
        self.vec_ok = all(x % 16 == 0 for x in (inp, out, seg, in_row,
                                                  out_row, in_seg, out_seg))
        self.divisions = 0

    def total(self):
        return self.seg * self.nseg

    def threads_needed(self):
        return -(-self.total() // UNIT)

    def unit(self, t):
        x0 = UNIT * t
        s = x0 // self.seg              # the thread's one division
        self.divisions += 1
        off = x0 - s * self.seg
        n = min(UNIT, self.total() - x0)
        return Unit(self.inp + s * self.in_seg + off,
                    self.out + s * self.out_seg + off, off, n,
                    self.vec_ok and n == UNIT)

    def _walk(self, u, base, row, seg_stride):
        """The edge path's addresses of the unit's bytes in one row (None
        past the end of the data)."""
        p, o, addrs = base + row, u.off, []
        for b in range(UNIT):
            addrs.append(p if b < u.n else None)
            p += 1
            o += 1
            if o == self.seg:
                o, p = 0, p + seg_stride - self.seg
        return addrs

    def load(self, u, c):
        if u.vec:
            a = u.inp + c * self.in_row
            assert a % 16 == 0, "LDG.128 at an unaligned address"
            return self.mem[a:a + UNIT].copy()
        return np.array([0 if a is None else self.mem[a] for a in
                         self._walk(u, u.inp, c * self.in_row,
                                    self.in_seg)], np.uint8)

    def store(self, u, r, data):
        if u.vec:
            a = u.out + r * self.out_row
            assert a % 16 == 0, "STG.128 at an unaligned address"
            self.omem[a:a + UNIT] = data
            return
        for b, a in enumerate(self._walk(u, u.out, r * self.out_row,
                                         self.out_seg)):
            if a is not None:
                self.omem[a] = data[b]


def _place(arr: np.ndarray, base: int, row_pad: int):
    """Lay (k, N) or (B, k, C) bytes into a flat memory at address
    ``base``, each row ``row_pad`` bytes longer than its data.  Returns
    the memory and the view's (seg, nseg, row stride, segment stride)."""
    if arr.ndim == 2:
        arr = arr[None]
    b, k, c = arr.shape
    row, segs = c + row_pad, k * (c + row_pad)
    mem = np.full(base + b * segs + 64, 0xEE, np.uint8)
    for s in range(b):
        for r in range(k):
            a = base + s * segs + r * row
            mem[a:a + c] = arr[s, r]
    if b == 1:
        return mem, (c, 1, row, 0)
    return mem, (c, b, row, segs)


# (label, shape, base address, row padding): the headline-like streams, a
# ragged stream, the (B, k, C) batch at C = 1024 (the CLAY batch's sc),
# 1001 (no 16-byte access) and 16 (the k=16 repair's sc), strided rows,
# and bases 4 bytes off alignment
LAYOUTS = [
    ("stream", (8, 4096), 0, 0),
    ("stream_ragged", (8, 1001), 0, 0),
    ("stream_base4", (8, 4096), 4, 0),
    ("batch_c1024", (3, 8, 1024), 0, 0),
    ("batch_c1001", (3, 8, 1001), 0, 0),
    ("batch_c16", (5, 8, 16), 0, 0),
    ("batch_c16_strided", (5, 8, 16), 0, 32),
    ("batch_c1024_base4", (2, 8, 1024), 4, 0),
    ("batch_c5", (4, 8, 5), 0, 3),
]


def _view(data, base, pad, mout):
    mem, (seg, nseg, in_row, in_seg) = _place(data, base, pad)
    oshape = ((data.shape[0], mout, data.shape[2]) if data.ndim == 3
              else (mout, data.shape[1]))
    omem, (_, _, out_row, out_seg) = _place(np.zeros(oshape, np.uint8), base,
                                           pad)
    return ByteView(mem, omem, base, base, seg, nseg, in_row, in_seg,
                    out_row, out_seg), oshape


def _read_out(view, oshape, base, pad):
    if len(oshape) == 2:
        oshape = (1,) + oshape
    b, m, c = oshape
    out = np.zeros(oshape, np.uint8)
    for s in range(b):
        for r in range(m):
            a = base + s * view.out_seg + r * view.out_row
            out[s, r] = view.omem[a:a + c]
    return out


@pytest.mark.parametrize("label,shape,base,pad", LAYOUTS,
                         ids=[x[0] for x in LAYOUTS])
def test_units_read_the_layout(label, shape, base, pad):
    """Every thread's 16 bytes of every row are the virtual columns
    x0..x0+15 of the (B*C) byte columns, zero past the end; the segment is
    found once per thread, before any row is read; the interior path
    serves exactly the aligned units that lie in one segment."""
    data = np.random.default_rng(len(label)).integers(0, 256, shape,
                                                      dtype=np.uint8)
    view, _ = _view(data, base, pad, 1)
    kin = shape[-2]
    flat = (data if data.ndim == 2 else
            data.transpose(1, 0, 2).reshape(kin, -1))   # (kin, B*C)
    cols = np.pad(flat, ((0, 0), (0, -flat.shape[1] % UNIT)))
    T = view.threads_needed()
    units = [view.unit(t) for t in range(T)]
    assert view.divisions == T
    for t, u in enumerate(units):
        for c in range(kin):
            assert np.array_equal(view.load(u, c),
                                  cols[c, UNIT * t:UNIT * (t + 1)])
    seg = shape[-1]
    vec = [u.vec for u in units]
    if base % 16 or pad % 16 or seg % 16:
        assert not any(vec)
    else:
        assert all(vec[:-1]) and vec[-1] == (flat.shape[1] % UNIT == 0)


@pytest.mark.parametrize("label,shape,base,pad", LAYOUTS,
                         ids=[x[0] for x in LAYOUTS])
@pytest.mark.parametrize("matrix", ["encode_k8_m4", "decode_4_erasures"])
def test_b2_model_matches_plain_and_jax(label, shape, base, pad, matrix):
    """B2 = B1's field-table arithmetic over the byte view: each thread's
    unit loaded row by row, applied, stored through the view (nothing
    outside the output's rows written), against the plain version and the
    JAX engine's einsum on the same bytes."""
    G = j_matrix.generator_matrix("reed_sol_van", 8, 4)
    coeff = G[8:] if matrix == "encode_k8_m4" else \
        j_ref.decode_matrix(G, list(range(4, 12)), [0, 1, 2, 3])
    consts = ck.ShardApply(coeff).consts
    data = np.random.default_rng(len(label) + 7).integers(0, 256, shape,
                                                          dtype=np.uint8)
    view, oshape = _view(data, base, pad, consts.mout)
    T = view.threads_needed()
    units = [view.unit(t) for t in range(T)]
    words = np.zeros((consts.kin, 4 * T), np.uint32)
    for t, u in enumerate(units):
        for c in range(consts.kin):
            words[c, 4 * t:4 * t + 4] = view.load(u, c).view("<u4")
    res = model_apply_words(consts.bitmatrix, words.view(np.int32))
    res = res.view(np.uint32)
    before = view.omem.copy()
    for t, u in enumerate(units):
        for r in range(consts.mout):
            view.store(u, r, res[r, 4 * t:4 * t + 4].view(np.uint8))
    got = _read_out(view, oshape, base, pad).reshape(oshape)
    plain = ck.gf2_apply_u8_plain(consts.plain_bm(torch.device("cpu")),
                                  torch.from_numpy(data)).numpy()
    assert np.array_equal(got, plain)
    want = np.asarray(j_engine.BitplaneEngine(use_pallas=False)
                      .apply(coeff, data))
    assert np.array_equal(got, want)
    # only the output's rows changed: row padding and the guard bytes kept
    changed = np.nonzero(view.omem != before)[0]
    written = set()
    b = oshape[0] if len(oshape) == 3 else 1
    for s in range(b):
        for r in range(consts.mout):
            a = base + s * view.out_seg + r * view.out_row
            written.update(range(a, a + oshape[-1]))
    assert set(changed.tolist()) <= written


def test_b2_model_matches_pallas_u8_kernel():
    """The stream case against ``_kernel_u8`` itself in interpret mode (its
    (kin, 4, nq) slot layout is the (kin, 4*nq) stream reshaped)."""
    coeff = j_matrix.generator_matrix("reed_sol_van", 8, 4)[8:]
    consts = ck.ShardApply(coeff).consts
    data = np.random.default_rng(3).integers(0, 256, (8, 4 * 512),
                                             dtype=np.uint8)
    view, oshape = _view(data, 0, 0, consts.mout)
    words = np.zeros((8, data.shape[1] // 4), np.uint32)
    units = [view.unit(t) for t in range(view.threads_needed())]
    for t, u in enumerate(units):
        for c in range(8):
            words[c, 4 * t:4 * t + 4] = view.load(u, c).view("<u4")
    res = model_apply_words(consts.bitmatrix, words.view(np.int32))
    got = res.view(np.uint8).reshape(oshape)
    jap = pk.PallasShardApply(coeff, interpret=True)
    out8 = np.asarray(pk._pallas_apply_u8_variant(
        jnp.asarray(jap.bm32), jnp.asarray(data.reshape(8, 4, 512)),
        tile=256, variant="enc_u8_expand", interpret=True))
    assert np.array_equal(got, out8.reshape(4, 4 * 512))


class _Stop(Exception):
    pass


def test_b2_takes_the_field_tables(monkeypatch):
    """B2's wrapper hands its kernel GF2Constants.fields, and so does B5c's,
    the same kernel with two units per thread.  The fields getter is spied
    on a machine without CUDA: the spy stops each launch there."""
    seen = []

    def spy(self, device):
        seen.append(device)
        raise _Stop

    monkeypatch.setattr(ck.GF2Constants, "fields", spy)
    monkeypatch.setattr(ck, "_require_cuda", lambda name, t: None)
    consts = ck.ShardApply(j_matrix.generator_matrix("reed_sol_van", 8, 4)
                           [8:]).consts
    meta = torch.empty((8, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(_Stop):
        ck.gf2_apply_u8(consts, meta)
    assert seen == [meta.device]
    with pytest.raises(_Stop):
        ck.gf2_apply_u8_split2(consts, meta)
    assert seen == [meta.device, meta.device]
