"""The lab's bit kernels (L2 unpack_repack_words, L3 roof_matmul_s8) on the
CPU, against the JAX lab's kernel bodies.

The JAX experiments ``exp_unpack_only`` and ``exp_roof_matmul`` have no
interpret flag and run only on a TPU, so their Pallas bodies
(ceph_tpu/testing/perf_lab.py:189-193 and :235-237) are evaluated here as
the same ``jax.numpy`` expressions on the CPU, on inputs made from numpy
seeds, and the port's plain versions (what the wrappers run for a CPU
tensor) are held equal to them.  A numpy model of roof_matmul_s8's
fragment and k-permutation arithmetic (csrc/lab_bits.cu, with the PTX ISA's
m16n8k32 .s8 fragment layouts) is held to the exact product too.  The
kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py).  Tolerance: exact throughout (integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import bitmatrix as j_bm
from ceph_tpu.ec import matrix as j_matrix
from ceph_tpu_torch.testing import perf_lab as lab


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    w.flat[:3] = [-2**31, 2**31 - 1, -1]
    return w


def _jax_unpack_only(d: np.ndarray) -> np.ndarray:
    """The body of exp_unpack_only (perf_lab.py:190-193)."""
    d = jnp.asarray(d)
    shift = jax.lax.broadcasted_iota(jnp.int32, (1, 32, 1), 1)
    bits = ((d[:, None, :] >> shift) & 1)
    return np.asarray(jnp.sum(bits << shift, axis=1))


def _jax_roof_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The body of exp_roof_matmul (perf_lab.py:236-237)."""
    return np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                              preferred_element_type=jnp.int32))


@pytest.mark.parametrize("shape", [(8, 8192), (8, 1001), (3, 257), (1, 1)])
def test_unpack_repack_plain_is_the_jax_body(shape):
    w = _words(shape, shape[1])
    want = _jax_unpack_only(w)
    assert np.array_equal(want, w)          # the repack is the identity
    got = lab.unpack_repack_words(torch.from_numpy(w))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_unpack_repack_plain_crosses_chunks(monkeypatch):
    monkeypatch.setattr(lab, "_PLAIN_COLS", 100)
    w = _words((8, 1003), 5)
    assert np.array_equal(lab.unpack_repack_words_plain(
        torch.from_numpy(w)).numpy(), w)


def test_unpack_repack_wrapper_on_cpu():
    w = torch.from_numpy(_words((8, 64), 1))
    out = torch.zeros_like(w)
    assert lab.unpack_repack_words(w, out=out) is out
    assert torch.equal(out, w)
    assert lab.LAUNCHES["unpack_repack_words"] == 0
    with pytest.raises(TypeError):
        lab.unpack_repack_words(w.to(torch.int64))
    with pytest.raises(TypeError):
        lab.unpack_repack_words(w.reshape(-1))
    with pytest.raises(ValueError):
        lab.unpack_repack_words(torch.empty((8, 4), dtype=torch.int32,
                                            device="meta"))


def test_lab_bm32_is_the_jax_labs():
    """perf_lab.py:227-229: expand_bitmatrix_lanes(gf_matrix_to_bitmatrix(
    G[8:])) of reed_sol_van k=8 m=4, as int8."""
    G = j_matrix.generator_matrix("reed_sol_van", 8, 4)
    want = np.asarray(j_bm.expand_bitmatrix_lanes(
        j_bm.gf_matrix_to_bitmatrix(np.asarray(G[8:], np.uint8))), np.int8)
    got = lab.lab_bm32()
    assert got.shape == (128, 256) and got.dtype == np.int8
    assert np.array_equal(got, want)


def _int8(shape, seed):
    """Asymmetric int8 over the whole range, extremes included."""
    x = np.random.default_rng(seed).integers(-128, 128, shape,
                                             dtype=np.int64).astype(np.int8)
    x.flat[:2] = [-128, 127]
    return x


@pytest.mark.parametrize("n", [4096, 1000, 1003, 8, 5])
def test_roof_matmul_plain_is_the_jax_body(n):
    a, b = _int8((128, 256), 1), _int8((256, n), n)
    want = _jax_roof_matmul(a, b)
    got = lab.roof_matmul_s8(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (128, n)
    assert np.array_equal(got.numpy(), want)
    # the extremes: every product -128 * -128, summed over the depth
    got = lab.roof_matmul_s8(torch.full((128, 256), -128, dtype=torch.int8),
                             torch.full((256, n), -128, dtype=torch.int8))
    assert int(got.max()) == int(got.min()) == 256 * 128 * 128


def test_roof_matmul_plain_on_the_labs_bits(monkeypatch):
    """The lab's own operands: bm32 and 0/1 bits from seed 1."""
    monkeypatch.setattr(lab, "_PLAIN_COLS", 1000)
    a = lab.lab_bm32()
    b = np.random.default_rng(1).integers(0, 2, (256, 4096), np.int8)
    got = lab.roof_matmul_s8_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), _jax_roof_matmul(a, b))


def test_roof_matmul_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.zeros((128, 256), dtype=torch.int8)
    b = torch.zeros((256, 16), dtype=torch.int8)
    out = torch.ones((128, 16), dtype=torch.int32)
    assert lab.roof_matmul_s8(a, b, out=out) is out
    assert int(out.abs().sum()) == 0
    with pytest.raises(TypeError):
        lab.roof_matmul_s8(a.to(torch.int32), b)
    with pytest.raises(ValueError):
        lab.roof_matmul_s8(a[:64], b)
    with pytest.raises(ValueError):
        lab.roof_matmul_s8(a, b[:128])
    with pytest.raises(ValueError):
        lab.roof_matmul_s8(a, torch.empty((256, 16), dtype=torch.int8,
                                          device="meta"))
    assert lab.LAUNCHES["roof_matmul_s8"] == 0


# -- a numpy model of roof_matmul_s8's index arithmetic -------------------------

def _bt_chunk(q):
    return q ^ ((q >> 3) << 1)


def _model_roof_matmul_tile(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One 64-column tile through csrc/lab_bits.cu's arithmetic: the staging
    (16 k-rows x 4 columns per thread, byte-transposed, swizzled chunks),
    the fragments (k permuted: lane quad t owns k in [64t, 64t+64), step s
    register r holds word 16t + 2s + r), and mma.m16n8k32 .s8 with the PTX
    ISA's fragment layouts (groupID g = lane >> 2, t = lane & 3; A regs
    0/1/2/3 = rows g/g+8/g/g+8 at k 4t.. / 4t.. / 16+4t.. / 16+4t..; B
    regs 0/1 = k 4t.. / 16+4t.. of column g; C regs 0,1 / 2,3 = rows g /
    g+8 at columns 2t, 2t+1)."""
    aw = a.view(np.uint8).reshape(128, 64, 4)          # A words, 4 bytes each
    # staging: s_bt[column, physical chunk] = 16 k-bytes
    s_bt = np.zeros((64, 17, 16), np.uint8)
    for tid in range(256):
        sq, sk = tid & 15, tid >> 4
        for j in range(4):
            col = 4 * sq + j
            s_bt[col, _bt_chunk(sk)] = b[16 * sk:16 * sk + 16, col]
    c = np.zeros((128, 64), np.int64)
    for warp in range(8):
        for nt in range(8):
            a_frag = np.zeros((16, 32), np.int64)
            b_frag = np.zeros((32, 8), np.int64)
            d_ref = np.zeros((16, 8), np.int64)
            for s in range(8):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    row0 = 16 * warp + g
                    regs_a = [aw[row0, 16 * t + 2 * s], aw[row0 + 8, 16 * t + 2 * s],
                              aw[row0, 16 * t + 2 * s + 1],
                              aw[row0 + 8, 16 * t + 2 * s + 1]]
                    for reg, (dr, dk) in enumerate(
                            [(0, 0), (8, 0), (0, 16), (8, 16)]):
                        a_frag[g + dr, dk + 4 * t:dk + 4 * t + 4] = \
                            regs_a[reg].view(np.int8)
                    run = np.concatenate([s_bt[8 * nt + g, _bt_chunk(4 * t + q)]
                                          for q in range(4)]).reshape(16, 4)
                    for reg in range(2):
                        b_frag[16 * reg + 4 * t:16 * reg + 4 * t + 4, g] = \
                            run[2 * s + reg].view(np.int8)
                d_ref += a_frag @ b_frag
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                row0 = 16 * warp + g
                cc = 8 * nt + 2 * t
                c[row0, cc:cc + 2] = d_ref[g, 2 * t:2 * t + 2]
                c[row0 + 8, cc:cc + 2] = d_ref[g + 8, 2 * t:2 * t + 2]
    return c


def test_roof_matmul_kernel_arithmetic_model_is_the_product():
    """The kernel's k permutation, staging swizzle and fragment reads,
    modelled lane by lane, give exactly A . B on asymmetric int8 (a
    transposed or misplaced fragment would not)."""
    a, b = _int8((128, 256), 3), _int8((256, 64), 4)
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert np.array_equal(_model_roof_matmul_tile(a, b), want)


def test_roof_matmul_staging_swizzle_is_conflict_free():
    """The fragment loads of one 8-lane phase (LDS.128) hit 8 distinct
    4-bank groups: rows of 17 chunks, chunk q at q ^ ((q >> 3) << 1)."""
    for nt in range(8):
        for q in range(4):
            for phase in range(4):
                groups = {((8 * nt + (lane >> 2)) * 17
                           + _bt_chunk(4 * (lane & 3) + q)) % 8
                          for lane in range(8 * phase, 8 * phase + 8)}
                assert len(groups) == 8
