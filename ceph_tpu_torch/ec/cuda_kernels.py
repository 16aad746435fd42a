"""GF(2) bitmatrix region apply on Hopper: the port's erasure-code kernels.

Counterpart of ceph_tpu/ec/pallas_kernels.py.  Two hand-written CUDA C++
kernels (``csrc/gf2_apply.cu``) carry every encode, decode, degraded read
and recovery of the jax_rs codecs:

- ``gf2_apply_words``: (kin, N4) int32 lane words -> (mout, N4) int32.
  Replaces ``_kernel`` (pallas_kernels.py:96-117, launched by
  ``_pallas_apply_words`` :120-141), blocked contraction included; its
  ``tile`` argument is the launch's (words of a row per block).
- ``gf2_apply_u8``: (kin, N) uint8 byte streams, or a (B, kin, C) stripe
  batch, -> (mout, N) / (B, mout, C) uint8.  Replaces ``_kernel_u8``
  (:199-213, launched by ``_pallas_apply_u8_variant`` :267-288), the
  ``enc_u8_expand`` formulation.  The TPU kernel needs the (kin, 4, N/4)
  slot relayout; on Hopper a thread reads 16 contiguous bytes, so the port
  kernel takes the byte streams as they are, at any length.

Both look up GF(2)-linear byte tables of three bit fields with ``prmt``
(``field_tables``, ``GF2Constants.fields``).

Three more (``csrc/gf2_variants.cu``) are the other encode variants, each
for an unblocked contraction only (``variant_applies``):

- ``gf2_apply_words_cmp``: B1's function, bits expanded by a per-byte
  sign test and ANDed with the column table (``column_table``,
  ``GF2Constants.table``, which serves this kernel alone).  Replaces
  ``_kernel_cmp_expand`` (:166-178, launched by
  ``_pallas_apply_words_variant`` :244-264), ``enc_cmp_expand``.
- ``gf2_apply_words_split2``: B1's kernel with two independent 16-byte
  units per thread, both loads of a row issued before either XOR chain.
  Replaces ``_kernel_split2`` (:181-196, same launch), ``enc_split2``.
- ``gf2_apply_u8_split2``: B2's kernel with two units per thread.
  Replaces ``_kernel_u8_split2`` (:216-231, launched at :275),
  ``enc_u8_split2``.

Both split2 kernels take the field tables, as B1 and B2 do.

Two more (``csrc/gf2_grouped.cu``) carry the sparse repair operators
(CLAY regenerating repair), row-grouped by ``GroupedPlan``:

- ``gf2_apply_grouped``: every row group of a sparse matrix in one launch,
  each group's support rows selected from the input.  Replaces
  ``_gkernel_fused`` (:429-451, launched by ``_pallas_apply_grouped_fused``
  :454-475).
- ``gf2_apply_grouped_paired``: each group over its own gathered rows.
  Replaces ``_gkernel`` (:495-507, launched by ``_pallas_apply_grouped``
  :510-526).

Both take per-group field tables (``GroupedPlan.fields``).

``GroupedApply`` (counterpart of ``PallasGroupedApply``) picks between them
by the TPU applier's rule.  Both write each output row at its caller
position, so the TPU applier's ``out[gather_rows]`` reorder is not needed.

Each kernel has a plain PyTorch version of the same function here
(``<wrapper>_plain``).  A wrapper uses it only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.  Each launch adds one
to ``LAUNCHES[name]`` (``count_launch``); a call recorded into a CUDA graph
under capture is not a launch, and a graph's replays do not pass through
the wrapper.

Bit order is LSB-first and lane order little-endian (byte 0 = bits 0..7 of
the int32 word), matching ``bitcast_convert_type`` at pallas_kernels.py:
319-332, so outputs are bit-identical to the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from ceph_tpu_torch.ec import bitmatrix as bm

LANE_BYTES = 4      # bytes packed per int32 lane word
KERNEL_SOURCE = "gf2_apply"
VARIANT_SOURCE = "gf2_variants"
GROUPED_SOURCE = "gf2_grouped"

# Launch counts of the kernels, by wrapper name.  Only real launches count;
# the plain versions never touch them.
LAUNCHES = {"gf2_apply_words": 0, "gf2_apply_u8": 0,
            "gf2_apply_words_cmp": 0, "gf2_apply_words_split2": 0,
            "gf2_apply_u8_split2": 0,
            "gf2_apply_grouped": 0, "gf2_apply_grouped_paired": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(counts: dict, name: str) -> None:
    """Add one launch of ``name``'s kernel to ``counts``, unless the call
    was recorded into a CUDA graph being captured: that launches nothing
    until the graph replays."""
    if not torch.cuda.is_current_stream_capturing():
        counts[name] += 1


# -- encode-variant selection -------------------------------------------------
#
# The JAX package chooses among alternative formulations of the same
# contraction (pallas_kernels.py:59-93); each has a kernel here.  A named
# variant serves only an unblocked contraction, as in the JAX package
# (:646-647, :690-691); blocked matrices keep the production kernel.
ENCODE_VARIANTS = ("", "enc_cmp_expand", "enc_u8_expand", "enc_split2",
                   "enc_u8_split2")
# variant -> the wrapper that launches its kernel
WORD_VARIANT_KERNELS = {"enc_cmp_expand": "gf2_apply_words_cmp",
                        "enc_split2": "gf2_apply_words_split2"}
U8_VARIANT_KERNELS = {"enc_u8_expand": "gf2_apply_u8",
                      "enc_u8_split2": "gf2_apply_u8_split2"}
_encode_variant = ""

# The JAX package's largest unblocked (32 mout x 32 kin) int8 matrix
# (pallas_kernels.py:50), kept as is so that both packages route, and group
# (GroupedPlan's per-pair VMEM term), exactly the same matrices.
_MAX_MATRIX_BYTES = 1 << 20


def set_encode_variant(name: str) -> None:
    """Select the formulation behind ``ShardApply``'s entries.

    "auto" resolves at set time to the formulation measured fastest on the
    card, and to "" elsewhere.  The JAX package resolves it to
    enc_u8_expand on a TPU; on an H100 at the jax_rs headline encode
    (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700.00 W) B2 (enc_u8_expand)
    takes 45.13 us, B1's field tables ("") 45.19, B5b (enc_split2) 47.37,
    B5c (enc_u8_split2) 50.63 and B5a (enc_cmp_expand) 55.55.  Timed in
    one interleaved loop, B5b is 1.036x B1 and B5c 1.119x B2 at the encode
    (1.035x and 1.115x at the 4-erasure decode), slower in every round,
    and B1 and B2 are level, so "auto" is "" there too.
    """
    global _encode_variant
    if name == "auto":
        name = ""
    if name not in ENCODE_VARIANTS:
        raise ValueError(
            f"unknown encode variant {name!r}; one of {ENCODE_VARIANTS}"
        )
    _encode_variant = name


def get_encode_variant() -> str:
    return _encode_variant


def variant_applies(kin: int, mout: int) -> bool:
    """Whether a named variant serves a (mout x kin) coefficient matrix:
    its lane-expanded int8 bitmatrix fits one unblocked block, the JAX
    package's ``_pick_kblk(kin, mout) == kin`` (pallas_kernels.py:144-153).
    The variant kernels hold the whole column table in shared memory."""
    return 32 * mout * 32 * kin <= _MAX_MATRIX_BYTES


def route(kin: int, mout: int, n: int) -> str:
    """The wrapper a ``ShardApply`` call launches, under the current
    variant, for a (mout x kin) matrix over rows of ``n`` bytes
    (``apply_words`` rows of N4 words are n = 4 * N4 bytes).

    As ``PallasShardApply`` dispatches (pallas_kernels.py:643-671,
    :684-703): a word variant launches its word kernel and a u8 variant
    its byte kernel, from either entry through a zero-copy view, when
    ``variant_applies``; everything else takes the production words
    kernel.  A length that is not a multiple of 4, which the TPU refuses,
    takes a byte kernel, since each byte column is independent."""
    variant = _encode_variant
    if variant and variant_applies(kin, mout):
        if variant in U8_VARIANT_KERNELS:
            return U8_VARIANT_KERNELS[variant]
        if n % LANE_BYTES == 0:
            return WORD_VARIANT_KERNELS[variant]
    return "gf2_apply_words" if n % LANE_BYTES == 0 else "gf2_apply_u8"


# -- lane views ---------------------------------------------------------------

def bytes_to_words(data: torch.Tensor) -> torch.Tensor:
    """(..., N) uint8 -> (..., N/4) int32 view, zero-copy for a contiguous
    tensor.  Both the CPU and the GPU are little-endian, so byte b of a
    word is bits 8b..8b+7, the lane order of the JAX package."""
    if data.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {data.dtype}")
    if data.shape[-1] % LANE_BYTES:
        raise ValueError(f"byte count {data.shape[-1]} not a multiple of 4")
    return data.contiguous().view(torch.int32)


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """(..., N4) int32 -> (..., 4*N4) uint8 view, inverse of bytes_to_words."""
    if words.dtype != torch.int32:
        raise TypeError(f"expected int32, got {words.dtype}")
    return words.contiguous().view(torch.uint8)


# -- per-matrix constants -----------------------------------------------------

def column_table(bitmatrix: np.ndarray) -> np.ndarray:
    """(8m, 8k) GF(2) bitmatrix -> (m, k, 8) uint32 kernel table.

    table[r, c, j] holds, in each of its four bytes, the byte whose bit i is
    BM[8r+i, 8c+j]: the contribution of bit j of input byte c to output
    byte r.  B5a (``gf2_apply_words_cmp``, csrc/gf2_variants.cu), its only
    kernel, ANDs it with bit j of every input byte expanded to 0x00/0xFF
    and XORs the result into row r."""
    B = np.asarray(bitmatrix, np.uint32)
    m8, k8 = B.shape
    B = B.reshape(m8 // 8, 8, k8 // 8, 8)               # (r, i, c, j)
    col = (B << np.arange(8, dtype=np.uint32)[None, :, None, None]).sum(1)
    return np.ascontiguousarray(
        (col.astype(np.uint32) * np.uint32(0x01010101)).astype(np.uint32)
    )


# The three bit fields of an input byte that index the byte tables of B1,
# B2 and the grouped kernels: bits 0-2, 3-5 and 6-7 (shift, width).  At
# most 3 bits each, so a field never sets the sign-replicate bit of a prmt
# selector nibble.
FIELDS = ((0, 3), (3, 3), (6, 2))


def _byte_maps(bitmatrix: np.ndarray, xs=None) -> np.ndarray:
    """(8m, 8k) GF(2) bitmatrix -> (m, k, len(xs)) uint8: entry [r, c, t] is
    block (r, c) applied to the byte x = xs[t] (all 256 bytes when xs is
    None), bit i = XOR_j BM[8r+i, 8c+j] * bit j of x.  Built as the XOR of
    the block's columns selected by the bits of x, so a matrix of 2^16
    input rows (the CRC contraction) stays a few MiB."""
    B = np.asarray(bitmatrix, np.uint8)
    m8, k8 = B.shape
    B = B.reshape(m8 // 8, 8, k8 // 8, 8)               # (r, i, c, j)
    col = np.zeros((m8 // 8, k8 // 8, 8), np.uint8)     # (r, c, j)
    for i in range(8):
        col |= B[:, i] << np.uint8(i)
    xs = np.arange(256) if xs is None else np.asarray(xs)
    out = np.zeros((m8 // 8, k8 // 8, xs.size), np.uint8)
    for j in range(8):
        sel = ((xs >> j) & 1).astype(bool)
        out[:, :, sel] ^= col[:, :, j:j + 1]
    return out


def field_tables(bitmatrix: np.ndarray) -> np.ndarray:
    """(8m, 8k) GF(2) bitmatrix -> (m, k, 5) uint32 tables of B1 and B2
    (csrc/gf2_apply.cu) and, per group, of B3 and B4 (csrc/gf2_grouped.cu).

    Block (r, c) of the bitmatrix is a linear map M on bytes, so M(x) =
    M(f0) ^ M(f1 << 3) ^ M(f2 << 6) over the fields of ``FIELDS``.  Words
    0-1 hold T0[v] = M(v) for v = 0..7 as bytes (T0[v] in byte v of the
    pair, little-endian), words 2-3 T1[v] = M(v << 3), word 4 T2[v] =
    M(v << 6) for v = 0..3: the byte pools prmt selects from."""
    cols = []
    for shift, width in FIELDS:
        entries = _byte_maps(bitmatrix, np.arange(1 << width) << shift)
        cols.append(np.ascontiguousarray(entries).view("<u4"))
    return np.ascontiguousarray(np.concatenate(cols, axis=2))


class GF2Constants:
    """Device constants of one GF(2) bitmatrix, cached per device.

    The table-cache role of ErasureCodeIsaTableCache: the kernel tables on
    a CUDA device (the field tables of B1, B2, B5b and B5c; B5a's column
    table), the float32 bitmatrices the plain versions contract with on
    the CPU."""

    def __init__(self, bitmatrix: np.ndarray):
        self.bitmatrix = np.ascontiguousarray(np.asarray(bitmatrix, np.uint8))
        m8, k8 = self.bitmatrix.shape
        if m8 % 8 or k8 % 8:
            raise ValueError(f"bitmatrix shape {self.bitmatrix.shape} is not "
                             f"a multiple of 8")
        self.mout, self.kin = m8 // 8, k8 // 8
        self._dev: dict[tuple, torch.Tensor] = {}

    def _cached(self, what: str, device: torch.device, make) -> torch.Tensor:
        key = (what, str(device))
        hit = self._dev.get(key)
        if hit is None:
            hit = make().to(device)
            self._dev[key] = hit
        return hit

    def table(self, device: torch.device) -> torch.Tensor:
        """(mout, kin, 8) column table of B5a as int32 (same bits as
        uint32)."""
        return self._cached("table", device, lambda: torch.from_numpy(
            column_table(self.bitmatrix).view(np.int32)))

    def fields(self, device: torch.device) -> torch.Tensor:
        """(mout, kin, 5) field tables of B1, B2, B5b and B5c as int32 (same
        bits as uint32)."""
        return self._cached("fields", device, lambda: torch.from_numpy(
            field_tables(self.bitmatrix).view(np.int32)))

    def plain_bm(self, device: torch.device) -> torch.Tensor:
        """(8m, 8k) float32 0/1 bitmatrix for the byte plain version."""
        return self._cached("bm", device, lambda: torch.from_numpy(
            self.bitmatrix.astype(np.float32)))

    def plain_bm32(self, device: torch.device) -> torch.Tensor:
        """(32m, 32k) float32 lane-expanded bitmatrix for the word plain
        version (bitmatrix.expand_bitmatrix_lanes)."""
        return self._cached("bm32", device, lambda: torch.from_numpy(
            bm.expand_bitmatrix_lanes(self.bitmatrix).astype(np.float32)))


# -- plain versions -----------------------------------------------------------

_PLAIN_COLS = 1 << 16   # columns per chunk: bounds the bit-plane temporaries


@contextlib.contextmanager
def _exact_float32_matmul():
    """0/1 operands with float32 sums <= 32*kin < 2^24 are exact.  TF32
    would keep them exact too (0 and 1 are representable, accumulation is
    float32), but the flag is pinned off so the claim does not rest on it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _shift_planes(w: torch.Tensor) -> torch.Tensor:
    """(k, n) int32 -> (k, 32, n) 0/1 bit planes by shift and mask, the
    production kernel's expansion (``>>`` on int32 is arithmetic, but
    ``& 1`` keeps only the wanted bit)."""
    shifts = torch.arange(32, dtype=torch.int32, device=w.device)
    return (w[:, None, :] >> shifts[None, :, None]) & 1


def _cmp_planes(w: torch.Tensor) -> torch.Tensor:
    """(k, n) int32 -> (k, 32, n) bool bit planes by mask-AND and
    compare-to-zero, the enc_cmp_expand expansion (pallas_kernels.py:173-
    175).  The masks are built as uint32 bits, so 1 << 31 is exact."""
    masks = torch.from_numpy(np.left_shift(
        np.uint32(1), np.arange(32, dtype=np.uint32)).view(np.int32))
    return (w[:, None, :] & masks.to(w.device)[None, :, None]) != 0


def _apply_word_planes(bm32: torch.Tensor, words: torch.Tensor,
                       planes) -> torch.Tensor:
    """(32m, 32k) float32 lane-expanded bitmatrix x (k, N4) int32 words ->
    (m, N4) int32: ``planes`` expands each word to 32 bit planes, which
    contract in float32, reduce mod 2 and pack back.  Packing sums in
    int64 and folds values >= 2^31 to negative int32, so bit 31 survives."""
    kin, n4 = words.shape
    mout = bm32.shape[0] // 32
    dev = words.device
    weights = torch.ones(32, dtype=torch.int64, device=dev) \
        << torch.arange(32, dtype=torch.int64, device=dev)
    out = torch.empty((mout, n4), dtype=torch.int32, device=dev)
    with _exact_float32_matmul():
        for s in range(0, n4, _PLAIN_COLS):
            w = words[:, s:s + _PLAIN_COLS]
            n = w.shape[1]
            bits = planes(w)
            acc = bm32 @ bits.reshape(kin * 32, n).to(torch.float32)
            pb = (acc.to(torch.int64) & 1).reshape(mout, 32, n)
            packed = (pb * weights[None, :, None]).sum(dim=1)
            packed = torch.where(packed >= (1 << 31), packed - (1 << 32),
                                 packed)
            out[:, s:s + n] = packed.to(torch.int32)
    return out


def gf2_apply_words_plain(bm32: torch.Tensor,
                          words: torch.Tensor) -> torch.Tensor:
    """Plain version of gf2_apply_words, the TPU kernel's formulation:
    (32m, 32k) float32 lane-expanded bitmatrix x (k, N4) int32 words ->
    (m, N4) int32, bit planes by shift and mask."""
    return _apply_word_planes(bm32, words, _shift_planes)


def gf2_apply_words_cmp_plain(bm32: torch.Tensor,
                              words: torch.Tensor) -> torch.Tensor:
    """Plain version of gf2_apply_words_cmp, enc_cmp_expand's formulation:
    bit planes by mask-AND and ``!= 0``, then the same contraction."""
    return _apply_word_planes(bm32, words, _cmp_planes)


def _halves(plain, mat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``plain`` over the two column halves of (k, n) data separately,
    concatenated: the split2 variants' two independent half-tiles."""
    h = (data.shape[-1] + 1) // 2
    return torch.cat([plain(mat, data[:, :h]), plain(mat, data[:, h:])],
                     dim=1)


def gf2_apply_words_split2_plain(bm32: torch.Tensor,
                                 words: torch.Tensor) -> torch.Tensor:
    """Plain version of gf2_apply_words_split2, enc_split2's formulation:
    the production expansion and contraction over each half of the
    columns separately."""
    return _halves(gf2_apply_words_plain, bm32, words)


def gf2_apply_u8_plain(bmat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain version of gf2_apply_u8: (8m, 8k) float32 bitmatrix x (k, N)
    or (B, k, C) uint8 -> (m, N) / (B, m, C) uint8, by bit planes,
    float32 contraction (exact: sums <= 8k < 2^24), mod 2 and repack."""
    if data.ndim == 3:
        return _per_stripe_columns(gf2_apply_u8_plain, bmat, data)
    kin, n = data.shape
    mout = bmat.shape[0] // 8
    dev = data.device
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    weights = torch.ones(8, dtype=torch.int32, device=dev) \
        << torch.arange(8, dtype=torch.int32, device=dev)
    out = torch.empty((mout, n), dtype=torch.uint8, device=dev)
    with _exact_float32_matmul():
        for s in range(0, n, _PLAIN_COLS):
            d = data[:, s:s + _PLAIN_COLS]
            cols = d.shape[1]
            bits = (d[:, None, :] >> shifts[None, :, None]) & 1
            acc = bmat @ bits.reshape(kin * 8, cols).to(torch.float32)
            pb = (acc.to(torch.int32) & 1).reshape(mout, 8, cols)
            out[:, s:s + cols] = (pb * weights[None, :, None]).sum(dim=1) \
                .to(torch.uint8)
    return out


def gf2_apply_u8_split2_plain(bmat: torch.Tensor,
                              data: torch.Tensor) -> torch.Tensor:
    """Plain version of gf2_apply_u8_split2, enc_u8_split2's formulation:
    byte planes over each half of the byte columns separately; a (B, k, C)
    batch as its B*C columns, as the kernel reads it."""
    if data.ndim == 3:
        return _per_stripe_columns(gf2_apply_u8_split2_plain, bmat, data)
    return _halves(gf2_apply_u8_plain, bmat, data)


def _per_stripe_columns(plain, bmat: torch.Tensor,
                        data: torch.Tensor) -> torch.Tensor:
    """A (B, k, C) batch through a (k, N) plain version as its B*C byte
    columns, and back to (B, m, C)."""
    b, kin, c = data.shape
    out = plain(bmat, data.permute(1, 0, 2).reshape(kin, b * c))
    return out.reshape(-1, b, c).permute(1, 0, 2).contiguous()


# -- kernel wrappers ----------------------------------------------------------

_c_entries: dict[str, object] = {}


def c_entry(source: str, name: str, argtypes: list):
    """The typed C function ``name`` of csrc/<source>.cu's library (built
    at first use)."""
    fn = _c_entries.get(name)
    if fn is None:
        from ceph_tpu_torch.common import cuda_build

        fn = getattr(cuda_build.load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _c_entries[name] = fn
    return fn


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# table, in, out, kin, mout, n4, in_stride, out_stride, stream
_WORD_ARGS = [_P, _P, _P, _I, _I, _LL, _LL, _LL, _P]
# ..., out_stride, tile, stream
_TILED_WORD_ARGS = _WORD_ARGS[:-1] + [_I, _P]
# B1's tile (words of a row per block) is a multiple of its block's 256
# threads x 4 words
TILE_QUANTUM = 1024
# table, in, out, kin, mout, seg, nseg, in_row, in_seg, out_row, out_seg,
# stream
_BYTE_ARGS = [_P, _P, _P, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL, _P]


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def _require_unblocked(name: str, consts: GF2Constants) -> None:
    if not variant_applies(consts.kin, consts.mout):
        raise ValueError(f"{name}: a {consts.mout}x{consts.kin} matrix needs "
                         f"a blocked contraction; this kernel takes "
                         f"32*mout*32*kin <= {_MAX_MATRIX_BYTES} only")


def _words_launch(name: str, source: str, plain, consts: GF2Constants,
                  words: torch.Tensor, out: torch.Tensor | None, tables,
                  tile: int | None = None) -> torch.Tensor:
    """Shared body of the word-layout wrappers: (kin, N4) int32 ->
    (mout, N4) int32 by the kernel ``name`` on a CUDA tensor (through its
    ``<name>_tiled`` entry when given a tile), with ``tables(consts,
    device)`` as its constants; by ``plain`` on a CPU tensor."""
    if words.dtype != torch.int32 or words.ndim != 2:
        raise TypeError(f"expected 2-D int32 words, got {words.dtype} "
                        f"{tuple(words.shape)}")
    kin, n4 = words.shape
    if kin != consts.kin:
        raise ValueError(f"expected {consts.kin} rows, got {kin}")
    if words.device.type == "cpu":
        res = plain(consts.plain_bm32(words.device), words)
        if out is None:
            return res
        out.copy_(res)
        return out
    _require_cuda(name, words)
    if words.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous")
    if out is None:
        out = torch.empty((consts.mout, n4), dtype=torch.int32,
                          device=words.device)
    if (out.shape != (consts.mout, n4) or out.dtype != torch.int32
            or out.device != words.device or out.stride(1) != 1):
        raise ValueError(f"{name}: bad output tensor")
    table = tables(consts, words.device)
    args = [table.data_ptr(), words.data_ptr(), out.data_ptr(), consts.kin,
            consts.mout, n4, words.stride(0), out.stride(0)]
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        if tile is None:
            rc = c_entry(source, name, _WORD_ARGS)(*args, stream)
        else:
            rc = c_entry(source, f"{name}_tiled", _TILED_WORD_ARGS)(
                *args, tile, stream)
    check_rc(name, rc)
    count_launch(LAUNCHES, name)
    return out


def _bytes_launch(name: str, source: str, plain, consts: GF2Constants,
                  data: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """Shared body of the byte-layout wrappers: (kin, N) -> (mout, N), or
    (B, kin, C) -> (B, mout, C), uint8, by the kernel ``name`` on a CUDA
    tensor (any N; rows and the stripe axis may be strided, bytes within a
    chunk contiguous), with the field tables as its constants; by ``plain``
    on a CPU tensor."""
    if data.dtype != torch.uint8 or data.ndim not in (2, 3):
        raise TypeError(f"expected 2-D or 3-D uint8, got {data.dtype} "
                        f"{tuple(data.shape)}")
    batched = data.ndim == 3
    kin = data.shape[1] if batched else data.shape[0]
    if kin != consts.kin:
        raise ValueError(f"expected {consts.kin} rows, got {kin}")
    shape = ((data.shape[0], consts.mout, data.shape[2]) if batched
             else (consts.mout, data.shape[1]))
    if data.device.type == "cpu":
        res = plain(consts.plain_bm(data.device), data)
        if out is None:
            return res
        out.copy_(res)
        return out
    _require_cuda(name, data)
    if data.stride(-1) != 1:
        raise ValueError(f"{name}: bytes must be contiguous")
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=data.device)
    if (tuple(out.shape) != shape or out.dtype != torch.uint8
            or out.device != data.device or out.stride(-1) != 1):
        raise ValueError(f"{name}: bad output tensor")
    if batched:
        nseg, seg = data.shape[0], data.shape[2]
        in_row, in_seg = data.stride(1), data.stride(0)
        out_row, out_seg = out.stride(1), out.stride(0)
    else:
        nseg, seg = 1, data.shape[1]
        in_row, in_seg = data.stride(0), 0
        out_row, out_seg = out.stride(0), 0
    table = consts.fields(data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = c_entry(source, name, _BYTE_ARGS)(
            table.data_ptr(), data.data_ptr(), out.data_ptr(),
            consts.kin, consts.mout, seg, nseg, in_row, in_seg, out_row,
            out_seg, stream)
    check_rc(name, rc)
    count_launch(LAUNCHES, name)
    return out


def _check_tile(tile) -> None:
    """Raise unless ``tile`` is None or a positive multiple of
    TILE_QUANTUM words."""
    if tile is None:
        return
    if (not isinstance(tile, int) or isinstance(tile, bool) or tile <= 0
            or tile % TILE_QUANTUM):
        raise ValueError(f"tile {tile!r} is not a positive multiple of "
                         f"{TILE_QUANTUM} words")


def gf2_apply_words(consts: GF2Constants, words: torch.Tensor,
                    out: torch.Tensor | None = None,
                    tile: int | None = None) -> torch.Tensor:
    """B1: (kin, N4) int32 -> (mout, N4) int32, any matrix.  ``tile``, the
    Pallas launch's argument (``_pallas_apply_words(..., tile=)``), is the
    words of each row one block covers, a positive multiple of 1024; None
    is the production launch (1024 words per block).  The plain version for
    a CPU tensor, at any tile."""
    _check_tile(tile)
    return _words_launch("gf2_apply_words", KERNEL_SOURCE,
                         gf2_apply_words_plain, consts, words, out,
                         GF2Constants.fields, tile)


def gf2_apply_u8(consts: GF2Constants, data: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """B2: (kin, N) -> (mout, N), or (B, kin, C) -> (B, mout, C), uint8,
    any matrix and any N.  ``out`` may be a strided view, such as the
    parity rows of an encode output.  The plain version for a CPU
    tensor."""
    return _bytes_launch("gf2_apply_u8", KERNEL_SOURCE, gf2_apply_u8_plain,
                         consts, data, out)


def gf2_apply_words_cmp(consts: GF2Constants, words: torch.Tensor,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """B5a (enc_cmp_expand): B1's function for an unblocked matrix, bits
    expanded by a per-byte sign test.  The plain version for a CPU
    tensor."""
    _require_unblocked("gf2_apply_words_cmp", consts)
    return _words_launch("gf2_apply_words_cmp", VARIANT_SOURCE,
                         gf2_apply_words_cmp_plain, consts, words, out,
                         GF2Constants.table)


def gf2_apply_words_split2(consts: GF2Constants, words: torch.Tensor,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """B5b (enc_split2): B1's function for an unblocked matrix, on the
    field tables, each thread owning two independent 16-byte units.  The
    plain version for a CPU tensor."""
    _require_unblocked("gf2_apply_words_split2", consts)
    return _words_launch("gf2_apply_words_split2", VARIANT_SOURCE,
                         gf2_apply_words_split2_plain, consts, words, out,
                         GF2Constants.fields)


def gf2_apply_u8_split2(consts: GF2Constants, data: torch.Tensor,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """B5c (enc_u8_split2): B2's function for an unblocked matrix, on the
    field tables, two units per thread, the same layouts as gf2_apply_u8.
    The plain version for a CPU tensor."""
    _require_unblocked("gf2_apply_u8_split2", consts)
    return _bytes_launch("gf2_apply_u8_split2", VARIANT_SOURCE,
                         gf2_apply_u8_split2_plain, consts, data, out)


# wrapper name -> wrapper, for ``route``'s answer
KERNELS = {"gf2_apply_words": gf2_apply_words,
           "gf2_apply_u8": gf2_apply_u8,
           "gf2_apply_words_cmp": gf2_apply_words_cmp,
           "gf2_apply_words_split2": gf2_apply_words_split2,
           "gf2_apply_u8_split2": gf2_apply_u8_split2}
BYTE_KERNELS = ("gf2_apply_u8", "gf2_apply_u8_split2")


# -- the applier --------------------------------------------------------------

def _byte_view(words: torch.Tensor) -> torch.Tensor:
    """(..., N4) int32 -> (..., 4*N4) uint8 without a copy where the words
    of a row are contiguous (rows may be strided)."""
    return words.view(torch.uint8) if words.stride(-1) == 1 \
        else words_to_bytes(words)


class ShardApply:
    """Apply a GF(2^8) coefficient matrix to shard-layout data.

    Counterpart of ceph_tpu.ec.pallas_kernels.PallasShardApply: the same
    (k, N) / (B, k, C) layouts and apply_words / apply_bytes / __call__
    entries, with the per-matrix constants cached in ``consts``, and the
    same dispatch on the encode variant (``route``).  Any (kin, mout) is
    supported; the production kernels block the contraction themselves,
    so there is no VMEM-size limit to check.
    """

    def __init__(self, coeff: np.ndarray | None = None, *,
                 bitmatrix: np.ndarray | None = None):
        if (coeff is None) == (bitmatrix is None):
            raise ValueError("give exactly one of coeff or bitmatrix")
        if bitmatrix is None:
            bitmatrix = bm.gf_matrix_to_bitmatrix(np.asarray(coeff, np.uint8))
        self.consts = GF2Constants(bitmatrix)
        self.mout, self.kin = self.consts.mout, self.consts.kin

    @classmethod
    def from_lane_bitmatrix(cls, bm32: np.ndarray, kin: int) -> "ShardApply":
        """Build from a lane-expanded (32m, 32kpad) bitmatrix, such as the
        ``bm32`` of a JAX PallasShardApply (zero-padded columns beyond
        32*kin are dropped).  Raises unless it is exactly the lane
        expansion of its (8m, 8k) bitmatrix."""
        bm32 = np.asarray(bm32).astype(np.uint8)
        if np.any(bm32[:, 32 * kin:]):
            raise ValueError("nonzero padding columns in bm32")
        bm32 = bm32[:, :32 * kin]
        m32 = bm32.shape[0]
        B = bm32.reshape(m32 // 32, 4, 8, kin, 4, 8)[:, 0, :, :, 0, :]
        bitmatrix = B.reshape(m32 // 4, 8 * kin)
        if not np.array_equal(bm.expand_bitmatrix_lanes(bitmatrix), bm32):
            raise ValueError("bm32 is not a lane-expanded bitmatrix")
        return cls(bitmatrix=bitmatrix)

    def route(self, n: int) -> str:
        """The wrapper a call over rows of ``n`` bytes launches."""
        return route(self.kin, self.mout, n)

    def apply_words(self, words: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
        """(k, N4) int32 -> (m, N4) int32, any N4.  A u8 variant's kernel
        reads the words as their bytes and writes the output's bytes."""
        name = self.route(LANE_BYTES * words.shape[-1])
        if name not in BYTE_KERNELS:
            return KERNELS[name](self.consts, words, out)
        if words.dtype != torch.int32 or words.ndim != 2:
            raise TypeError(f"expected 2-D int32 words, got {words.dtype} "
                            f"{tuple(words.shape)}")
        res = KERNELS[name](self.consts, _byte_view(words),
                            None if out is None else out.view(torch.uint8))
        return res.view(torch.int32) if out is None else out

    def apply_bytes(self, data: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
        """(k, N) uint8 byte streams -> (m, N) uint8 parity streams.

        A byte kernel (a u8 variant, or a length that is not a multiple of
        4) reads the streams as they are; a words kernel reads them as
        int32 words, as the JAX package's production path does."""
        name = self.route(data.shape[-1])
        if name in BYTE_KERNELS:
            return KERNELS[name](self.consts, data, out)
        par = words_to_bytes(KERNELS[name](self.consts,
                                           bytes_to_words(data)))
        if out is None:
            return par
        out.copy_(par)
        return out

    def __call__(self, data: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        """(k, N) or (B, k, C) uint8 -> same-layout parity bytes."""
        if data.ndim == 2:
            return self.apply_bytes(data, out)
        name = self.route(data.shape[-1])
        if name in BYTE_KERNELS:
            return KERNELS[name](self.consts, data, out)
        batch, kin, C = data.shape
        flat = data.permute(1, 0, 2).reshape(kin, batch * C)
        par = self.apply_bytes(flat).reshape(self.mout, batch, C) \
            .permute(1, 0, 2)
        if out is None:
            return par.contiguous()
        out.copy_(par)
        return out


# -- sparse row-grouped repair operators --------------------------------------

# The TPU applier's route rule (pallas_kernels.py:564): the fused kernel when
# the whole lane-expanded bitmatrix set is at most this large, else paired.
FUSED_MAX_BYTES = 6 << 20


def _greedy_groups(nz: np.ndarray, grp_rows: int) -> list[list[int]]:
    """Partition rows into groups of grp_rows minimizing union supports:
    seed each group with the unassigned row of largest support, then add
    the rows whose supports add the fewest new columns (copy of
    pallas_kernels.py:335-353)."""
    mout = nz.shape[0]
    sups = [frozenset(np.nonzero(nz[i])[0]) for i in range(mout)]
    unassigned = set(range(mout))
    groups: list[list[int]] = []
    while unassigned:
        seed = max(unassigned, key=lambda r: len(sups[r]))
        unassigned.remove(seed)
        grp, union = [seed], set(sups[seed])
        while len(grp) < grp_rows and unassigned:
            best = min(unassigned, key=lambda r: len(sups[r] - union))
            unassigned.remove(best)
            grp.append(best)
            union |= sups[best]
        groups.append(grp)
    return groups


class GroupedPlan:
    """Row-grouped sparse factorization of a GF(2^8) coefficient matrix.

    Counterpart of ceph_tpu.ec.pallas_kernels.GroupedPlan (:356-427): the
    same ``groups``, ``cols``, ``cmax``, ``mac_ratio``, ``profitable`` and
    ``gather_rows`` for the same matrix.  Repair operators are sparse (CLAY
    k=8 m=4 d=11 single-chunk repair is 64 x 176 with ~15 nonzeros per
    row); grouping rows by shared column support and reading only those
    columns cuts the work by the density factor.

    In place of the TPU's lane-expanded ``bms`` the port keeps, per group:
    ``bitmatrices`` (G, 32, 8*cmax) the GF(2) bitmatrix of its (4 x cmax)
    sub-matrix; ``fields`` (G, 4, cmax, 5) uint32 its kernel tables (the
    prmt byte tables of ``field_tables``, zero for padding columns and
    padding slots); ``ncols`` (G,) its real support size; and
    ``slot_rows`` (G, 4) the caller row of each slot, -1 for a padding
    slot, so a kernel writes each row where the caller wants it.
    """

    GRP_ROWS = 4        # GF rows per group (a 128-row MXU tile on a TPU)

    def __init__(self, coeff: np.ndarray):
        coeff = np.asarray(coeff, np.uint8)
        self.mout, self.kin = coeff.shape
        nz = coeff != 0
        grp = self.GRP_ROWS
        natural = [list(range(g, min(g + grp, self.mout)))
                   for g in range(0, self.mout, grp)]
        greedy = _greedy_groups(nz, grp)

        def cmax_of(groups):
            return max(
                max(1, int(nz[g].any(axis=0).sum())) for g in groups
            )

        groups = min((natural, greedy), key=cmax_of)
        cmax = -(-cmax_of(groups) // 8) * 8
        if len(groups) % 2:
            groups = groups + [[]]      # pair padding (zero group)
        self._set_profitability(groups, cmax)
        if not self.profitable:
            return                      # skip the table build
        G = len(groups)
        cols = np.zeros((G, cmax), np.int32)
        bitmatrices = np.zeros((G, 8 * grp, 8 * cmax), np.uint8)
        for gi, rows in enumerate(groups):
            sup = np.nonzero(nz[rows].any(axis=0))[0] if rows else \
                np.zeros(0, np.int64)
            cols[gi, :len(sup)] = sup
            if len(rows) == 0:
                continue
            sub = np.zeros((grp, cmax), np.uint8)
            sub[:len(rows), :len(sup)] = coeff[rows][:, sup]
            bitmatrices[gi] = bm.gf_matrix_to_bitmatrix(sub)
        self._set_tables(cols, bitmatrices)

    def _set_profitability(self, groups: list[list[int]], cmax: int) -> None:
        grp = self.GRP_ROWS
        G = len(groups)
        self.cmax, self.groups = cmax, groups
        # Profitability exactly as the JAX plan (pallas_kernels.py:390-400):
        # grouped MACs vs the dense contraction, and the TPU's per-pair
        # VMEM term.
        self.mac_ratio = (G * grp * cmax) / float(self.mout * self.kin)
        self.profitable = (
            cmax < self.kin
            and self.mac_ratio <= 0.6
            and 2 * 32 * grp * 32 * cmax <= _MAX_MATRIX_BYTES
        )

    def _set_tables(self, cols: np.ndarray, bitmatrices: np.ndarray) -> None:
        grp = self.GRP_ROWS
        G = len(self.groups)
        self.cols = cols
        self.bitmatrices = bitmatrices
        # support columns come first in cols and have nonzero blocks
        self.ncols = np.array(
            [len(np.nonzero(self._support_mask(g))[0]) for g in range(G)],
            np.int32)
        self.slot_rows = np.full((G, grp), -1, np.int32)
        for gi, rows in enumerate(self.groups):
            self.slot_rows[gi, :len(rows)] = rows
        self.fields = np.stack([field_tables(b) for b in bitmatrices])
        # Caller row r sits at kernel position gather_rows[r]
        # (pallas_kernels.py:418-426); the port's kernels write through
        # slot_rows instead, which is the same map read the other way.
        real_pos = [gi * grp + j
                    for gi, rows in enumerate(self.groups)
                    for j in range(len(rows))]
        flat_rows = [r for rows in self.groups for r in rows]
        order = np.argsort(np.asarray(flat_rows, np.int64), kind="stable")
        self.gather_rows = np.asarray(real_pos, np.int64)[order]
        self._dev: dict[tuple, object] = {}
        self._plain: dict[int, GF2Constants] = {}

    def _support_mask(self, g: int) -> np.ndarray:
        blocks = self.bitmatrices[g].reshape(
            self.bitmatrices.shape[1], self.cmax, 8)
        return blocks.any(axis=(0, 2))

    @classmethod
    def from_reference(cls, mout: int, kin: int, groups, cols: np.ndarray,
                       bms: np.ndarray,
                       gather_rows: np.ndarray) -> "GroupedPlan":
        """Build from a JAX plan's arrays (``groups``, ``cols``, the
        lane-expanded int8 ``bms`` and ``gather_rows``).  Raises unless
        each ``bms[g]`` is exactly the lane expansion of a GF(2)
        bitmatrix, each group's nonzero columns are its first ``cols``
        entries, and ``gather_rows`` is the groups' row map."""
        plan = cls.__new__(cls)
        plan.mout, plan.kin = int(mout), int(kin)
        groups = [[int(r) for r in rows] for rows in groups]
        cols = np.asarray(cols, np.int32)
        bms = np.asarray(bms).astype(np.uint8)
        G, cmax = cols.shape
        grp = cls.GRP_ROWS
        if len(groups) != G or bms.shape != (G, 32 * grp, 32 * cmax):
            raise ValueError(f"bms {bms.shape} / cols {cols.shape} do not "
                             f"match {len(groups)} groups")
        if sorted(r for rows in groups for r in rows) != list(range(mout)):
            raise ValueError("groups do not cover each row exactly once")
        plan._set_profitability(groups, cmax)
        bitmatrices = np.stack([
            bms[g].reshape(grp, 4, 8, cmax, 4, 8)[:, 0, :, :, 0, :]
            .reshape(8 * grp, 8 * cmax) for g in range(G)])
        for g in range(G):
            if not np.array_equal(
                    bm.expand_bitmatrix_lanes(bitmatrices[g]), bms[g]):
                raise ValueError(f"bms[{g}] is not a lane-expanded bitmatrix")
        plan._set_tables(cols, bitmatrices)
        for g in range(G):
            n = int(plan.ncols[g])
            if (not plan._support_mask(g)[:n].all()
                    or np.any(cols[g, n:] != 0)):
                raise ValueError(f"group {g}: support is not cols[:{n}]")
        if not np.array_equal(plan.gather_rows,
                              np.asarray(gather_rows, np.int64)):
            raise ValueError("gather_rows is not the groups' row map")
        return plan

    @property
    def fused(self) -> bool:
        """Whether the fused kernel serves this plan (else the paired one):
        the TPU applier's rule at pallas_kernels.py:564."""
        return (len(self.groups) * 32 * self.GRP_ROWS * 32 * self.cmax
                <= FUSED_MAX_BYTES)

    def coefficients(self) -> np.ndarray:
        """The (mout, kin) GF(2^8) matrix this plan applies, rebuilt from
        its group bitmatrices (bit j of column c: coefficient * 2^j, so
        the coefficient is the j=0 column)."""
        coeff = np.zeros((self.mout, self.kin), np.uint8)
        weights = (1 << np.arange(8, dtype=np.uint32))
        for g, rows in enumerate(self.groups):
            b = self.bitmatrices[g].reshape(self.GRP_ROWS, 8, self.cmax, 8)
            sub = (b[:, :, :, 0].astype(np.uint32)
                   * weights[None, :, None]).sum(axis=1)
            n = int(self.ncols[g])
            for s, r in enumerate(rows):
                coeff[r, self.cols[g, :n]] = sub[s, :n]
        return coeff

    def _cached(self, what: str, device: torch.device, make):
        key = (what, str(device))
        hit = self._dev.get(key)
        if hit is None:
            hit = self._dev[key] = make()
        return hit

    def tensors(self, device: torch.device) -> tuple:
        """(fields as int32, cols, ncols, slot_rows) on ``device``."""
        return self._cached("tensors", device, lambda: tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (self.fields.view(np.int32), self.cols, self.ncols,
                      self.slot_rows)))

    def group_constants(self, g: int) -> GF2Constants:
        """GF2Constants of group g's (4 x ncols[g]) sub-bitmatrix, for the
        plain versions."""
        hit = self._plain.get(g)
        if hit is None:
            n = int(self.ncols[g])
            hit = GF2Constants(self.bitmatrices[g][:, :8 * n])
            self._plain[g] = hit
        return hit

    def gather_index(self, device: torch.device) -> torch.Tensor:
        """Flat (G * cmax,) row index of the paired kernel's gathered
        input: ``data.index_select(row_dim, index)`` is the JAX applier's
        ``words[plan.cols]`` (pallas_kernels.py:577)."""
        return self._cached("gather", device, lambda: torch.from_numpy(
            self.cols.reshape(-1).astype(np.int64)).to(device))


def _grouped_plain(plan: GroupedPlan, data: torch.Tensor,
                   gathered: bool) -> torch.Tensor:
    """Both grouped plain versions: for each group, the dense plain
    version of its (4 x ncols) sub-bitmatrix over its support rows
    (``cols[g]``, or rows g*cmax.. of a gathered input), each real slot
    written to its caller row."""
    row_dim = data.ndim - 2
    shape = list(data.shape)
    shape[row_dim] = plan.mout
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    for g in range(len(plan.groups)):
        n = int(plan.ncols[g])
        if n == 0:
            continue
        rows = (np.arange(g * plan.cmax, g * plan.cmax + n) if gathered
                else plan.cols[g, :n])
        sel = data.index_select(
            row_dim, torch.from_numpy(rows.astype(np.int64)).to(data.device))
        consts = plan.group_constants(g)
        if data.dtype == torch.int32:
            res = gf2_apply_words_plain(consts.plain_bm32(data.device), sel)
        else:
            res = gf2_apply_u8_plain(consts.plain_bm(data.device), sel)
        for s, r in enumerate(plan.slot_rows[g]):
            if r >= 0:
                out.select(row_dim, int(r)).copy_(res.select(row_dim, s))
    return out


def gf2_apply_grouped_plain(plan: GroupedPlan,
                            data: torch.Tensor) -> torch.Tensor:
    """Plain version of gf2_apply_grouped: (kin, N4) int32, (kin, N) or
    (B, kin, C) uint8 -> the same layout with mout rows."""
    return _grouped_plain(plan, data, gathered=False)


def gf2_apply_grouped_paired_plain(plan: GroupedPlan,
                                   gathered: torch.Tensor) -> torch.Tensor:
    """Plain version of gf2_apply_grouped_paired: the gathered
    (G*cmax, N4) int32, (G*cmax, N) or (B, G*cmax, C) uint8 input ->
    the same layout with mout rows."""
    return _grouped_plain(plan, gathered, gathered=True)


# head: fields, [cols,] ncols, slot_rows, G, cmax, in, out
_GROUPED_HEAD = [_P, _P, _P, _I, _I, _P, _P]
# words: n4, in_stride, out_stride, stream
_GROUPED_WORDS = [_LL, _LL, _LL, _P]
# bytes: seg, nseg, in_row, in_seg, out_row, out_seg, stream
_GROUPED_BYTES = [_LL, _LL, _LL, _LL, _LL, _LL, _P]


def _grouped_launch(name: str, plan: GroupedPlan, data: torch.Tensor,
                    out: torch.Tensor | None, gathered: bool) -> torch.Tensor:
    words = data.dtype == torch.int32 and data.ndim == 2
    if not (words or (data.dtype == torch.uint8 and data.ndim in (2, 3))):
        raise TypeError(f"{name}: expected 2-D int32 words or 2-D/3-D uint8, "
                        f"got {data.dtype} {tuple(data.shape)}")
    row_dim = data.ndim - 2
    G = len(plan.groups)
    rows = G * plan.cmax if gathered else plan.kin
    if data.shape[row_dim] != rows:
        raise ValueError(f"{name}: expected {rows} rows, got "
                         f"{data.shape[row_dim]}")
    shape = list(data.shape)
    shape[row_dim] = plan.mout
    shape = tuple(shape)
    if data.device.type == "cpu":
        res = _grouped_plain(plan, data, gathered)
        if out is None:
            return res
        out.copy_(res)
        return out
    _require_cuda(name, data)
    if data.stride(-1) != 1:
        raise ValueError(f"{name}: columns must be contiguous")
    if out is None:
        out = torch.empty(shape, dtype=data.dtype, device=data.device)
    if (tuple(out.shape) != shape or out.dtype != data.dtype
            or out.device != data.device or out.stride(-1) != 1):
        raise ValueError(f"{name}: bad output tensor")
    fields, cols, ncols, slot_rows = plan.tensors(data.device)
    head = ([fields.data_ptr()] + ([] if gathered else [cols.data_ptr()])
            + [ncols.data_ptr(), slot_rows.data_ptr(), G, plan.cmax,
               data.data_ptr(), out.data_ptr()])
    kind = "paired_" if gathered else ""
    head_types = _GROUPED_HEAD[:1] + ([] if gathered else [_P]) \
        + _GROUPED_HEAD[1:]
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        if words:
            rc = c_entry(GROUPED_SOURCE, f"gf2_apply_grouped_{kind}words",
                         head_types + _GROUPED_WORDS)(
                *head, data.shape[1], data.stride(0), out.stride(0), stream)
        else:
            fn = c_entry(GROUPED_SOURCE, f"gf2_apply_grouped_{kind}u8",
                         head_types + _GROUPED_BYTES)
            if data.ndim == 3:
                rc = fn(*head, data.shape[2], data.shape[0], data.stride(1),
                        data.stride(0), out.stride(1), out.stride(0), stream)
            else:
                rc = fn(*head, data.shape[1], 1, data.stride(0), 0,
                        out.stride(0), 0, stream)
    check_rc(name, rc)
    count_launch(LAUNCHES, name)
    return out


def gf2_apply_grouped(plan: GroupedPlan, data: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """B3: (kin, N4) int32 words, (kin, N) uint8 streams or a (B, kin, C)
    uint8 batch -> the same layout with mout rows, every group in one
    launch.  Rows and the stripe axis may be strided; columns (bytes or
    words within a row) must be contiguous.  The plain version for a CPU
    tensor."""
    return _grouped_launch("gf2_apply_grouped", plan, data, out,
                           gathered=False)


def gf2_apply_grouped_paired(plan: GroupedPlan, gathered: torch.Tensor,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """B4: the gathered input (rows g*cmax + c = input row cols[g][c]), as
    (G*cmax, N4) int32, (G*cmax, N) uint8 or (B, G*cmax, C) uint8 -> the
    same layout with mout rows.  The plain version for a CPU tensor."""
    return _grouped_launch("gf2_apply_grouped_paired", plan, gathered, out,
                           gathered=True)


class GroupedApply:
    """Sparse-grouped counterpart of ShardApply for repair operators.

    Counterpart of ceph_tpu.ec.pallas_kernels.PallasGroupedApply
    (:529-595): the same entries (``apply_words`` for (kin, N4) int32,
    ``__call__`` for (kin, N) or (B, kin, C) uint8) and the same route:
    the fused kernel when the plan is ``fused``, else the paired kernel
    over the input gathered by ``plan.cols`` (a PyTorch ``index_select``,
    as the JAX package gathers outside its kernel).  Unlike the JAX
    applier it takes any length and a strided batch as it lies.
    """

    def __init__(self, coeff: np.ndarray | None = None, *,
                 plan: GroupedPlan | None = None):
        self.plan = plan or GroupedPlan(coeff)
        if not self.plan.profitable:
            raise ValueError("matrix too dense for the grouped kernel")
        self.mout, self.kin = self.plan.mout, self.plan.kin

    def _apply(self, data: torch.Tensor,
               out: torch.Tensor | None) -> torch.Tensor:
        if self.plan.fused:
            return gf2_apply_grouped(self.plan, data, out)
        gathered = data.index_select(data.ndim - 2,
                                     self.plan.gather_index(data.device))
        return gf2_apply_grouped_paired(self.plan, gathered, out)

    def apply_words(self, words: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
        """(kin, N4) int32 -> (mout, N4) int32, any N4."""
        if words.dtype != torch.int32 or words.ndim != 2:
            raise TypeError(f"expected 2-D int32 words, got {words.dtype} "
                            f"{tuple(words.shape)}")
        return self._apply(words, out)

    def __call__(self, data: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        """(kin, N) or (B, kin, C) uint8 -> same-layout output rows."""
        if data.dtype != torch.uint8:
            raise TypeError(f"expected uint8, got {data.dtype}")
        return self._apply(data, out)
