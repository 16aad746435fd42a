"""The grouped kernels' field-table arithmetic (csrc/gf2_grouped.cu
``gf2_grouped_kernel``, B3 and B4) on the CPU.

The kernels run only on a card.  Their arithmetic is modelled here in
numpy, thread by thread as the source writes it: per group, its support
columns in order (``cols[g][:ncols[g]]``, or rows g*cmax.. of a gathered
input), each support row's six selectors per word pair computed once for
the 4 slots, per slot the three ``prmt`` lookups in the group's field
tables (``GroupedPlan.fields``), the interleaved accumulators, the two
``prmt`` that undo the interleave at the store, and the store through
``slot_rows`` (padding slots write nothing).  The model is held exact
against the port's plain versions and the JAX package's ``_gkernel_fused``
and ``_gkernel`` in interpret mode, as tests/test_torch_grouped.py runs
them.  Tolerance: exact (GF(2) sums of bits).
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import pallas_kernels as pk
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu.ec.repair_operator import clay_repair_operator as j_clay_op
from ceph_tpu_torch.ec import cuda_kernels as ck
from tests.test_torch_fields import VEC, field_selectors, prmt

CPU = torch.device("cpu")


def _sparse(mout, kin, per_row, seed):
    """tests/test_torch_cuda.py's GROUPED_CASES matrices."""
    rng = np.random.default_rng(seed)
    coeff = np.zeros((mout, kin), np.uint8)
    for i in range(mout):
        cols = rng.choice(kin, size=per_row, replace=False)
        coeff[i, cols] = rng.integers(1, 256, per_row)
    return coeff


def _clay8():
    ec = JaxRegistry().factory("clay", {"k": "8", "m": "4", "d": "11"})
    return j_clay_op(ec, 3)[0]


# The CLAY k=8 m=4 d=11 repair operator (the headline repair, B3), the
# GROUPED_CASES of tests/test_torch_cuda.py (the CLAY operator's shape, a
# short last group, a plan the JAX rule sends to the paired kernel) and a
# plan of 3 groups, padded with the empty pair-padding group.
PLANS = {
    "clay_8_4_11_lost3": _clay8,
    "sparse_64x176": lambda: _sparse(64, 176, 15, 1),
    "sparse_30x120_short_groups": lambda: _sparse(30, 120, 9, 2),
    "sparse_512x2048_paired": lambda: _sparse(512, 2048, 8, 5),
    "sparse_10x96_pair_padding": lambda: _sparse(10, 96, 5, 3),
}


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    w.flat[:3] = [-2**31, 2**31 - 1, -1]
    return w


def model_grouped(plan: ck.GroupedPlan, words: np.ndarray,
                  gathered: bool) -> np.ndarray:
    """(rows, N4) int32 -> (mout, N4) int32 through the grouped kernel's
    arithmetic, every thread (VEC words) at once: zero past the ragged edge
    (the edge path's masked load), written only through slot_rows."""
    n4 = words.shape[1]
    w = np.pad(words.view(np.uint32), ((0, 0), (0, -n4 % VEC)))
    a, b = w[:, 0::2], w[:, 1::2]                       # the word pairs
    out = np.zeros((plan.mout, w.shape[1]), np.uint32)
    for g in range(len(plan.groups)):
        acc = np.zeros((ck.GroupedPlan.GRP_ROWS, 2, a.shape[1]), np.uint32)
        for c in range(int(plan.ncols[g])):     # padding columns: never
            row = g * plan.cmax + c if gathered else int(plan.cols[g, c])
            sel = field_selectors(a[row], b[row])   # once for the 4 slots
            for s in range(ck.GroupedPlan.GRP_ROWS):
                t = plan.fields[g, s, c]
                for h in range(2):
                    acc[s, h] ^= (prmt(t[0], t[1], sel[h])
                                  ^ prmt(t[2], t[3], sel[2 + h])
                                  ^ prmt(t[4], t[4], sel[4 + h]))
        for s, r in enumerate(plan.slot_rows[g]):
            if r >= 0:
                out[r, 0::2] = prmt(acc[s, 0], acc[s, 1], 0x6420)
                out[r, 1::2] = prmt(acc[s, 0], acc[s, 1], 0x7531)
    return out[:, :n4].view(np.int32)


@pytest.fixture(scope="module", params=list(PLANS))
def case(request):
    coeff = np.asarray(PLANS[request.param](), np.uint8)
    return request.param, coeff, ck.GroupedPlan(coeff), pk.GroupedPlan(coeff)


def test_fields_are_the_group_bitmatrices_tables(case):
    """plan.fields[g] is field_tables of group g's (32, 8*cmax) bitmatrix:
    zero for padding columns and for padding slots (short groups, the
    pair-padding group), so the kernel may run every slot."""
    _, _, plan, _ = case
    G = len(plan.groups)
    assert plan.fields.shape == (G, 4, plan.cmax, 5)
    assert plan.fields.dtype == np.uint32
    for g in range(G):
        assert np.array_equal(plan.fields[g],
                              ck.field_tables(plan.bitmatrices[g]))
        assert not plan.fields[g, :, int(plan.ncols[g]):].any()
        for s in range(len(plan.groups[g]), 4):
            assert not plan.fields[g, s].any()
    tensors = plan.tensors(CPU)
    assert np.array_equal(tensors[0].numpy().view(np.uint32), plan.fields)


@pytest.mark.parametrize("n4", [256, 37])
def test_fused_model_matches_plain_and_pallas(case, n4):
    """B3's model against gf2_apply_grouped's plain version and the JAX
    applier in interpret mode (``_gkernel_fused`` for a plan the JAX rule
    fuses, ``_gkernel`` for the paired one), at a whole and a ragged
    length."""
    _, coeff, plan, _ = case
    words = _words((plan.kin, n4), seed=n4 + plan.mout)
    got = model_grouped(plan, words, gathered=False)
    plain = ck.gf2_apply_grouped_plain(plan, torch.from_numpy(words))
    assert np.array_equal(got, plain.numpy())
    jax = np.asarray(pk.PallasGroupedApply(coeff, interpret=True)
                     .apply_words(words))
    assert np.array_equal(got, jax)


def test_paired_model_matches_plain_and_pallas(case):
    """B4's model over the gathered rows against the paired plain version
    and ``_pallas_apply_grouped`` (``_gkernel``) in interpret mode, called
    on the JAX plan's gathered words and reordered by gather_rows as the
    JAX applier does."""
    _, _, plan, jp = case
    words = _words((plan.kin, 256), seed=plan.kin)
    gathered = words[plan.cols.reshape(-1)]
    got = model_grouped(plan, gathered, gathered=True)
    plain = ck.gf2_apply_grouped_paired_plain(plan, torch.from_numpy(gathered))
    assert np.array_equal(got, plain.numpy())
    want = np.asarray(pk._pallas_apply_grouped(
        jp.bms, words[jp.cols], tile=pk.LANE, grp_rows=jp.GRP_ROWS,
        interpret=True))[jp.gather_rows]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mout,kin,per_row,seed,short", [
    (30, 120, 9, 2, [27, 29]), (10, 96, 5, 3, [])])
def test_padding_slots_own_no_row(mout, kin, per_row, seed, short):
    """The short last group's missing slots and the pair-padding group's
    four are -1 in slot_rows, so the kernel writes nothing for them, and
    every caller row is owned by exactly one slot."""
    plan = ck.GroupedPlan(_sparse(mout, kin, per_row, seed))
    real = plan.slot_rows[plan.slot_rows >= 0]
    assert sorted(real.tolist()) == list(range(mout))
    assert plan.groups[-1] == short
    assert (plan.slot_rows[-1, len(short):] == -1).all()
    words = _words((kin, 64), seed=seed)
    assert np.array_equal(model_grouped(plan, words, False),
                          ck.gf2_apply_grouped_plain(
                              plan, torch.from_numpy(words)).numpy())


def test_from_reference_plan_serves_the_same_fields():
    """A plan carried from the JAX package (ec/state.py) builds the same
    field tables as one built from the matrix."""
    coeff = _clay8()
    jp = pk.GroupedPlan(coeff)
    carried = ck.GroupedPlan.from_reference(
        jp.mout, jp.kin, jp.groups, jp.cols, jp.bms, jp.gather_rows)
    built = ck.GroupedPlan(coeff)
    assert np.array_equal(carried.fields, built.fields)
    assert np.array_equal(carried.tensors(CPU)[0].numpy(),
                          built.tensors(CPU)[0].numpy())
    words = _words((coeff.shape[1], 64), seed=5)
    assert np.array_equal(model_grouped(carried, words, False),
                          model_grouped(built, words, False))


def test_sass_row_loop_guard_sees_every_opcode():
    """chip_smoke.py's row-loop guard for B2 and B3: the shortest loop
    with the PRMT of one input row, with every opcode counted (a CALL to
    the 64-bit division subroutine and the byte loads of an inline edge
    path would be rare opcodes in a long loop)."""
    from ceph_tpu_torch.testing import sass
    from tests.test_torch_perf_lab import SASS

    body = "".join(f"        /*{0x20 + 16 * i:04x}*/                   "
                   f"{op} ;\n" for i, op in enumerate(
                       ["PRMT R1, R2, R3, R4"] * 60 + ["LDG.E.U8 R5, [R6]"]
                       * 16 + ["CALL.REL.NOINC 0x900"]))
    end = 0x20 + 16 * 77
    text = SASS + ("        Function : _Z4edgev\n" + body +
                   f"        /*{end:04x}*/              @P0 BRA 0x20 ;\n")
    found = sass.loops(text)
    (n, ops), = found["_Z4edgev"]
    assert n == 78 and ops["LDG"] == 16 and ops["CALL"] == 1
    assert sass.row_loop(found["_Z4edgev"], 48) == (n, ops)
    assert sass.row_loop(found["_Z6kernelv"], 48) is None
    assert sass.row_loop(found["_Z6kernelv"], 35)[0] == 72
