"""The port's grouped repair path on the CPU against the JAX package, exact.

GroupedPlan against the JAX plan field by field; the grouped plain
versions against the Pallas kernels in interpret mode (the fused applier,
and the paired kernel called directly) and against the JAX engine's
einsum; the port engine's grouped dispatch against the JAX engine's.
Every path is integer GF(2) arithmetic, so equality is exact.  The CUDA
kernels themselves run on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import engine as j_engine
from ceph_tpu.ec import matrix as j_matrix
from ceph_tpu.ec import pallas_kernels as pk
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu.ec.repair_operator import clay_repair_operator as j_clay_op
from ceph_tpu.ec.repair_operator import lrc_repair_operator as j_lrc_op
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec import engine as t_engine


def _sparse(mout, kin, per_row, seed):
    """tests/test_pallas.py's random sparse matrices."""
    rng = np.random.default_rng(seed)
    coeff = np.zeros((mout, kin), np.uint8)
    for i in range(mout):
        cols = rng.choice(kin, size=per_row, replace=False)
        coeff[i, cols] = rng.integers(1, 256, per_row)
    return coeff


def _vmem_gate():
    """tests/test_pallas.py:206-221: sparse by MAC ratio, too wide for the
    TPU's VMEM term, so not groupable."""
    rng = np.random.default_rng(4)
    coeff = np.zeros((8, 4096), np.uint8)
    for i in range(8):
        coeff[i, rng.choice(4096, size=600, replace=False)] = 7
    return coeff


def _clay_op(k, m, d, lost):
    ec = JaxRegistry().factory("clay", {"k": str(k), "m": str(m),
                                        "d": str(d)})
    return j_clay_op(ec, lost)[0]


def _lrc_op():
    ec = JaxRegistry().factory("lrc", {"k": "8", "m": "4", "l": "3"})
    return j_lrc_op(ec, 0)[0]


MATRICES = {
    "sparse_64x176": lambda: _sparse(64, 176, 15, 1),
    "sparse_30x120_short_groups": lambda: _sparse(30, 120, 9, 2),
    "sparse_7x96_pair_padding": lambda: _sparse(7, 96, 5, 3),
    "sparse_512x2048_paired": lambda: _sparse(512, 2048, 8, 5),
    "vmem_gate": _vmem_gate,
    "clay_4_2_5_lost0": lambda: _clay_op(4, 2, 5, 0),
    "clay_6_3_8_lost1": lambda: _clay_op(6, 3, 8, 1),
    "clay_6_3_8_lost7": lambda: _clay_op(6, 3, 8, 7),
    "clay_8_4_11_lost0": lambda: _clay_op(8, 4, 11, 0),
    "clay_8_4_11_lost3": lambda: _clay_op(8, 4, 11, 3),
    "clay_8_4_11_lost10": lambda: _clay_op(8, 4, 11, 10),
    "lrc_8_4_3_local": _lrc_op,
    "rs_8_4_parity": lambda: j_matrix.generator_matrix("reed_sol_van", 8,
                                                       4)[8:],
}
GROUPABLE = [n for n in MATRICES
             if n not in ("vmem_gate", "clay_4_2_5_lost0", "lrc_8_4_3_local",
                          "rs_8_4_parity")]


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("name", list(MATRICES))
def test_plan_matches_jax(name):
    coeff = MATRICES[name]()
    jp, tp = pk.GroupedPlan(coeff), ck.GroupedPlan(coeff)
    assert tp.groups == jp.groups
    assert (tp.cmax, tp.mac_ratio, tp.profitable) == \
        (jp.cmax, jp.mac_ratio, jp.profitable)
    assert tp.profitable == (name in GROUPABLE)
    if tp.profitable:
        assert np.array_equal(tp.cols, jp.cols)
        assert np.array_equal(tp.gather_rows, jp.gather_rows)
        # the port's constants describe the same matrix as the TPU's bms
        for g in range(len(tp.groups)):
            assert np.array_equal(
                ck.bm.expand_bitmatrix_lanes(tp.bitmatrices[g]),
                jp.bms[g].astype(np.uint8))
        assert np.array_equal(tp.coefficients(), coeff)


@pytest.mark.parametrize("name", GROUPABLE)
def test_route_matches_jax_rule(name):
    """Fused or paired as PallasGroupedApply.apply_words decides
    (pallas_kernels.py:564), read from the plans alone."""
    coeff = MATRICES[name]()
    jp, tp = pk.GroupedPlan(coeff), ck.GroupedPlan(coeff)
    jax_fused = len(jp.groups) * 32 * jp.GRP_ROWS * 32 * jp.cmax <= 6 << 20
    assert tp.fused == jax_fused
    assert tp.fused == (name != "sparse_512x2048_paired")


def test_slot_rows_invert_gather_rows():
    plan = ck.GroupedPlan(_sparse(30, 120, 9, 2))
    flat = plan.slot_rows.reshape(-1)
    assert np.array_equal(flat[plan.gather_rows], np.arange(30))
    assert (flat == -1).sum() == len(flat) - 30


@pytest.mark.parametrize("name", [n for n in GROUPABLE
                                  if n != "sparse_512x2048_paired"])
def test_fused_plain_matches_pallas_interpret(name):
    coeff = MATRICES[name]()
    jap = pk.PallasGroupedApply(coeff, interpret=True)
    plan = ck.GroupedPlan(coeff)
    data = _bytes((coeff.shape[1], 512), seed=coeff.shape[0])
    want = np.asarray(jap(data))
    got = ck.gf2_apply_grouped(plan, torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)
    words = pk.bytes_to_words(data)
    want_w = np.asarray(jap.apply_words(words))
    got_w = ck.gf2_apply_grouped(plan, ck.bytes_to_words(
        torch.from_numpy(data)))
    assert np.array_equal(got_w.numpy(), want_w)


@pytest.mark.parametrize("name", ["sparse_30x120_short_groups",
                                  "clay_6_3_8_lost1"])
def test_paired_plain_matches_pallas_paired_kernel(name):
    """The paired plain version against _pallas_apply_grouped in interpret
    mode, called directly on the gathered words, then reordered by
    gather_rows as the JAX applier does."""
    coeff = MATRICES[name]()
    jp = pk.GroupedPlan(coeff)
    data = _bytes((coeff.shape[1], 1024), seed=7)
    words = pk.bytes_to_words(data)
    gath = words[jp.cols]
    want = np.asarray(pk._pallas_apply_grouped(
        jp.bms, gath, tile=pk.LANE, grp_rows=jp.GRP_ROWS,
        interpret=True))[jp.gather_rows]
    plan = ck.GroupedPlan(coeff)
    tw = ck.bytes_to_words(torch.from_numpy(data))
    got = ck.gf2_apply_grouped_paired(
        plan, tw.index_select(0, plan.gather_index(tw.device)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", GROUPABLE)
@pytest.mark.parametrize("shape", [(3, None, 40), (None, 37)],
                         ids=["batch", "ragged"])
def test_grouped_apply_matches_jax_einsum(name, shape):
    """GroupedApply on either route, batched and ragged (lengths the TPU
    kernels refuse), against the JAX engine's XLA einsum."""
    coeff = MATRICES[name]()
    shape = tuple(coeff.shape[1] if s is None else s for s in shape)
    data = _bytes(shape, seed=len(shape))
    want = np.asarray(j_engine.BitplaneEngine(use_pallas=False)
                      .apply(coeff, data))
    got = ck.GroupedApply(coeff)(torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)


def test_grouped_apply_writes_into_strided_output():
    coeff = MATRICES["sparse_64x176"]()
    data = _bytes((2, 176, 64), seed=3)
    out = torch.zeros((2, 80, 64), dtype=torch.uint8)
    ck.GroupedApply(coeff)(torch.from_numpy(data), out=out[:, 16:])
    want = np.asarray(j_engine.BitplaneEngine(use_pallas=False)
                      .apply(coeff, data))
    assert np.array_equal(out[:, 16:].numpy(), want)
    assert not out[:, :16].any()


def test_grouped_apply_refuses_dense_and_bad_inputs():
    with pytest.raises(ValueError):
        ck.GroupedApply(MATRICES["rs_8_4_parity"]())
    ap = ck.GroupedApply(MATRICES["sparse_64x176"]())
    with pytest.raises(ValueError):
        ap(torch.zeros((175, 16), dtype=torch.uint8))
    with pytest.raises(TypeError):
        ap.apply_words(torch.zeros((176, 16), dtype=torch.uint8))
    with pytest.raises(ValueError):          # no kernel, no fallback
        ck.gf2_apply_grouped(ap.plan, torch.empty((176, 16),
                                                  dtype=torch.uint8,
                                                  device="meta"))


@pytest.mark.parametrize("name", list(MATRICES))
def test_engine_groups_what_jax_groups(name):
    coeff = MATRICES[name]()
    j_eng = j_engine.BitplaneEngine(use_pallas=True)
    t_eng = t_engine.BitplaneEngine(device="cpu")
    jax_grouped = j_eng._grouped_applier(coeff) is not None
    assert (t_eng.grouped_applier(coeff) is not None) == jax_grouped
    assert t_eng.grouped_applier(coeff) is t_eng.grouped_applier(coeff.copy())


@pytest.mark.parametrize("name", ["clay_8_4_11_lost3", "rs_8_4_parity"])
def test_engine_apply_matches_jax(name):
    coeff = MATRICES[name]()
    t_eng = t_engine.BitplaneEngine(device="cpu")
    j_eng = j_engine.BitplaneEngine(use_pallas=False)
    data = _bytes((2, coeff.shape[1], 64), seed=11)
    assert np.array_equal(t_eng.apply(coeff, data).numpy(),
                          np.asarray(j_eng.apply(coeff, data)))
    flat = _bytes((coeff.shape[1], 256), seed=12)
    got = t_eng.apply_words(coeff, ck.bytes_to_words(torch.from_numpy(flat)))
    want = j_eng.apply_words(coeff, pk.bytes_to_words(flat))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_clay_k16_operator_routes_to_paired():
    """The CLAY k=16 m=4 d=19 repair operator: the JAX plan puts it on
    the paired route (its bitmatrix set exceeds 6 MiB), and so does the
    port's, with the same plan."""
    R = _clay_op(16, 4, 19, 16)
    assert R.shape == (1024, 4864)
    jp, tp = pk.GroupedPlan(R), ck.GroupedPlan(R)
    assert tp.groups == jp.groups and np.array_equal(tp.cols, jp.cols)
    assert np.array_equal(tp.gather_rows, jp.gather_rows)
    assert tp.profitable and not tp.fused
    assert len(jp.groups) * 32 * 4 * 32 * jp.cmax > 6 << 20
    data = _bytes((4864, 16), seed=16)
    want = np.asarray(j_engine.BitplaneEngine(use_pallas=False)
                      .apply(R, data))
    assert np.array_equal(ck.GroupedApply(plan=tp)(torch.from_numpy(data))
                          .numpy(), want)


def test_plain_versions_count_no_launches():
    ck.reset_launch_counts()
    ap = ck.GroupedApply(MATRICES["sparse_64x176"]())
    ap(torch.from_numpy(_bytes((176, 64), seed=1)))
    assert all(n == 0 for n in ck.LAUNCHES.values())
