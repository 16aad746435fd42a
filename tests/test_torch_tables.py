"""The port's GF(2^8) tables and matrices equal the JAX package's, exactly."""

import numpy as np
import pytest

from ceph_tpu.ec import bitmatrix as j_bm
from ceph_tpu.ec import bitsched as j_bs
from ceph_tpu.ec import gf as j_gf
from ceph_tpu.ec import matrix as j_matrix
from ceph_tpu.ec import reference as j_ref
from ceph_tpu_torch.ec import bitmatrix as t_bm
from ceph_tpu_torch.ec import bitsched as t_bs
from ceph_tpu_torch.ec import gf as t_gf
from ceph_tpu_torch.ec import matrix as t_matrix
from ceph_tpu_torch.ec import reference as t_ref

TECHNIQUES = [
    ("reed_sol_van", 8, 4),
    ("reed_sol_van", 4, 2),
    ("reed_sol_r6_op", 6, 2),
    ("cauchy_orig", 10, 4),
    ("cauchy_good", 10, 4),
    ("isa_vandermonde", 8, 3),
    ("isa_cauchy", 8, 4),
]


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize(
    "name", ["GF_EXP", "GF_LOG", "GF_MUL_TABLE", "GF_INV_TABLE"])
def test_gf_tables_equal(name):
    assert np.array_equal(getattr(t_gf, name), getattr(j_gf, name))


def test_gf_ops_equal():
    a, b = _rand((64, 64), 1), _rand((64, 64), 2)
    assert np.array_equal(t_gf.gf_mul(a, b), j_gf.gf_mul(a, b))
    A = j_matrix.generator_matrix("reed_sol_van", 8, 4)[4:12]
    assert np.array_equal(t_gf.gf_inv_matrix(A), j_gf.gf_inv_matrix(A))
    assert np.array_equal(t_gf.gf_matmul(A, a[:8]), j_gf.gf_matmul(A, a[:8]))


@pytest.mark.parametrize("technique,k,m", TECHNIQUES)
def test_generator_matrix_equal(technique, k, m):
    G = t_matrix.generator_matrix(technique, k, m)
    assert np.array_equal(G, j_matrix.generator_matrix(technique, k, m))
    bm = t_bm.gf_matrix_to_bitmatrix(G[k:])
    assert np.array_equal(bm, j_bm.gf_matrix_to_bitmatrix(G[k:]))
    assert np.array_equal(t_bm.expand_bitmatrix_lanes(bm),
                          j_bm.expand_bitmatrix_lanes(bm))


@pytest.mark.parametrize("kind,args", [
    ("liberation", (5, 7)),
    ("blaum_roth", (6, 6)),
    ("liber8tion", (6,)),
])
def test_bitsched_parity_equal(kind, args):
    fn = f"{kind}_bitmatrix"
    assert np.array_equal(getattr(t_bs, fn)(*args), getattr(j_bs, fn)(*args))


@pytest.mark.parametrize("k,m,w", [(5, 3, 16), (4, 2, 32)])
def test_wide_symbol_bitmatrix_equal(k, m, w):
    gen = t_bs.reed_sol_van_w(k, m, w)
    assert np.array_equal(gen, j_bs.reed_sol_van_w(k, m, w))
    full = t_bs.matrix_to_bitmatrix(gen, w)
    assert np.array_equal(full, j_bs.matrix_to_bitmatrix(gen, w))
    D = t_bs.decode_bitmatrix(full, k, w, list(range(m, k + m)), [0, 1])
    assert np.array_equal(
        D, j_bs.decode_bitmatrix(full, k, w, list(range(m, k + m)), [0, 1]))


def test_reference_oracle_equal():
    G = j_matrix.generator_matrix("reed_sol_van", 8, 4)
    data = _rand((8, 512), 3)
    assert np.array_equal(t_ref.encode(G, data), j_ref.encode(G, data))
    assert np.array_equal(t_ref.encode_bitplane(G, data),
                          j_ref.encode(G, data))
    surv, want = [1, 2, 4, 5, 6, 7, 8, 11], [0, 3, 9, 10]
    assert np.array_equal(t_ref.decode_matrix(G, surv, want),
                          j_ref.decode_matrix(G, surv, want))
