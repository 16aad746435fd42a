"""The engine resolves a repair operator's applier once, not on every call.

``batched_clay_plane_repair_device`` hands the engine the same probed
operator R on every repair batch.  R is a read-only array over the probe's
bytes (``clay_repair_operator``), so the engine keys it by identity after
the first call and never copies or hashes its bytes again; a writeable
matrix is keyed by its contents on every call, so changing it in place
changes the result.  On the CPU, against the plain versions and the JAX
engine's einsum, exact.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import engine as j_engine
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu.ec.repair_operator import clay_repair_operator as j_clay_op
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec import engine as t_engine
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ec.repair_operator import clay_repair_operator
from ceph_tpu_torch.parallel.clay_sharding import (
    batched_clay_plane_repair_device,
)


@pytest.fixture
def key_calls(monkeypatch):
    """Count the engine's content keys, by matrix shape."""
    calls = []
    key = t_engine._key

    def counting(coeff):
        calls.append(coeff.shape)
        return key(coeff)

    monkeypatch.setattr(t_engine, "_key", counting)
    return calls


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_k16_operator_is_hashed_once(key_calls):
    """The CLAY k=16 m=4 d=19 operator (1024 x 4864, the paired route)
    over three repair batches: one content key in all, and the same
    answer each time."""
    ec = ErasureCodePluginRegistry().factory(
        "clay", {"k": "16", "m": "4", "d": "19"}, device="cpu")
    R, helpers, planes = clay_repair_operator(ec, 16)
    assert R.shape == (1024, 4864) and not R.flags.writeable
    assert t_engine._immutable(R)
    helper = _bytes((2, len(helpers) * len(planes), 16), seed=16)
    want = np.asarray(j_engine.BitplaneEngine(use_pallas=False)
                      .apply(R, helper)).reshape(2, -1)
    for _ in range(3):
        got = batched_clay_plane_repair_device(ec, R, helper)
        assert np.array_equal(got.numpy(), want)
    assert key_calls.count(R.shape) == 1


def test_same_bytes_in_a_new_array_are_keyed_by_content(key_calls):
    """A second read-only array with the same bytes is another object: it
    is keyed once by content and served the same cached applier."""
    ec = JaxRegistry().factory("clay", {"k": "8", "m": "4", "d": "11"})
    R = j_clay_op(ec, 3)[0]
    eng = t_engine.BitplaneEngine(device="cpu")
    a = np.frombuffer(R.tobytes(), np.uint8).reshape(R.shape)
    b = np.frombuffer(R.tobytes(), np.uint8).reshape(R.shape)
    data = _bytes((2, R.shape[1], 32), seed=8)
    first = eng.apply(a, data)
    for _ in range(2):
        assert torch.equal(eng.apply(a, data), first)
        assert torch.equal(eng.apply(b, data), first)
    assert key_calls == [R.shape, R.shape]
    assert eng._applier_for(a) is eng._applier_for(b)


@pytest.mark.parametrize("matrix", ["clay_8_4_11_lost3", "rs_8_4_parity"])
def test_mutated_writeable_matrix_gets_the_new_result(matrix):
    """A writeable matrix changed in place between two calls is applied
    as it is now (the grouped route and the dense one), never through the
    applier of its old contents."""
    if matrix == "rs_8_4_parity":
        from ceph_tpu.ec import matrix as j_matrix
        coeff = j_matrix.generator_matrix("reed_sol_van", 8, 4)[8:].copy()
    else:
        ec = JaxRegistry().factory("clay", {"k": "8", "m": "4", "d": "11"})
        coeff = j_clay_op(ec, 3)[0].copy()
    assert coeff.flags.writeable and not t_engine._immutable(coeff)
    eng = t_engine.BitplaneEngine(device="cpu")
    ref = j_engine.BitplaneEngine(use_pallas=False)
    data = _bytes((2, coeff.shape[1], 64), seed=3)
    before = eng.apply(coeff, data).numpy()
    assert np.array_equal(before, np.asarray(ref.apply(coeff, data)))
    r, c = np.argwhere(coeff)[0]
    coeff[r, c] ^= 0x5A                   # still nonzero: same support
    after = eng.apply(coeff, data).numpy()
    assert np.array_equal(after, np.asarray(ref.apply(coeff, data)))
    assert not np.array_equal(after, before)
    words = ck.bytes_to_words(torch.from_numpy(data[0]))
    coeff[r, c] ^= 0x33
    got = eng.apply_words(coeff, words)
    want = ref.apply_words(coeff, np.ascontiguousarray(words.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_read_only_view_of_writeable_memory_is_keyed_by_content():
    """A read-only view whose memory another array can still write is not
    immutable: a change through the writeable array is seen."""
    base = np.zeros((4, 8), np.uint8)
    base[:, :4] = np.arange(1, 17, dtype=np.uint8).reshape(4, 4)
    view = base.view()
    view.flags.writeable = False
    assert not t_engine._immutable(view)
    eng = t_engine.BitplaneEngine(device="cpu")
    data = _bytes((8, 64), seed=1)
    first = eng.apply(view, data).clone()
    base[0, 0] ^= 0xFF
    second = eng.apply(view, data)
    ref = j_engine.BitplaneEngine(use_pallas=False)
    assert np.array_equal(second.numpy(), np.asarray(ref.apply(base, data)))
    assert not torch.equal(first, second)


def test_installed_applier_replaces_a_resolved_one():
    """An applier installed after an immutable matrix was resolved (a
    plan carried from the JAX package, ec/state.py) serves the next call."""
    ec = JaxRegistry().factory("clay", {"k": "8", "m": "4", "d": "11"})
    R = np.frombuffer(j_clay_op(ec, 3)[0].tobytes(), np.uint8).reshape(
        64, 176)
    eng = t_engine.BitplaneEngine(device="cpu")
    first = eng._applier_for(R)
    assert isinstance(first, ck.GroupedApply)
    carried = ck.GroupedApply(R)
    eng.install_grouped(R, carried)
    assert eng._applier_for(R) is carried
    dense = ck.ShardApply(R)
    eng.install_applier(R, dense)         # grouped still wins, as before
    assert eng._applier_for(R) is carried
