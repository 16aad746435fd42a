"""The port's entry points against __graft_entry__.py.

``entry()``'s step on the JAX entry's own example arguments carried
across (its bf16 0/1 bitmatrix and its (64, 8, 512) batch) must equal the
JAX step's output; ``dryrun_multichip(8, device="cpu")`` must print the
same check lines as ``__graft_entry__._dryrun_body(8)`` on the JAX
package's 8 forced CPU devices.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ceph_tpu_torch import entry as pentry
from ceph_tpu_torch.parallel import mesh as M


def test_entry_step_equals_the_jax_entry():
    jfn, (jmat, jdata) = graft.entry()
    want = np.asarray(jfn(jmat, jdata))
    fn, (mat, data) = pentry.entry(device="cpu")
    assert mat.device == data.device == torch.device("cpu")
    assert np.array_equal(np.asarray(jmat, np.float32).astype(np.uint8),
                          mat.numpy())
    assert np.array_equal(np.asarray(jdata), data.numpy())
    carried = torch.from_numpy(
        np.asarray(jmat, np.float32).astype(np.uint8))
    got = fn(carried, torch.from_numpy(np.array(jdata)))
    assert got.shape == (64, 4, 512)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(fn(mat, data).numpy(), want)


def test_entry_reuses_its_applier_until_the_matrix_changes():
    fn, (mat, data) = pentry.entry(device="cpu")
    fn(mat, data)
    first = pentry._APPLIERS[(id(mat), mat._version)][1]
    fn(mat, data)
    assert pentry._APPLIERS[(id(mat), mat._version)][1] is first
    mat[0, 0] ^= 1                            # in place: a new version
    changed = fn(mat, data)
    assert pentry._APPLIERS[(id(mat), mat._version)][1] is not first
    mat[0, 0] ^= 1
    assert not torch.equal(changed, fn(mat, data))


def test_entry_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pentry.entry()
    monkeypatch.setattr(M, "_FORCED", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pentry.dryrun_multichip(8)


def test_dryrun_prints_the_jax_dryrun_lines(capsys):
    graft._dryrun_body(8)
    want = capsys.readouterr().out.splitlines()
    assert M._FORCED is None
    pentry.dryrun_multichip(8, device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert len(got) == 6 and got[0] == "mesh: 8 devices, dp=2 cs=4"
    assert M._FORCED is None                  # the forcing was undone


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_on_fewer_slots_prints_the_jax_lines(capsys, n):
    graft._dryrun_body(n)
    want = capsys.readouterr().out.splitlines()
    with M.forced_device_count(8, device="cpu") as before:
        pentry.dryrun_multichip(n, device="cpu")   # 8 slots: no forcing
        assert M.local_devices() == before
    assert capsys.readouterr().out.splitlines() == want
