"""The port's SHEC codec on the CPU against the JAX package's, exact.

The shingled parity matrix, the recoverability search (minimum_to_decode)
and the encode / decode bytes must equal the JAX plugin's; cases mirror
tests/test_shec.py at small sizes.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec.plugins.shec import shec_parity_matrix as j_parity
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch.ec.plugins.shec import shec_parity_matrix
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

GEOMETRIES = [(4, 3, 2), (6, 4, 3), (8, 4, 2), (5, 3, 3)]
TECHNIQUES = ["single", "multiple"]


def _codecs(k, m, c, technique):
    profile = {"k": str(k), "m": str(m), "c": str(c), "technique": technique}
    return (ErasureCodePluginRegistry().factory("shec", profile,
                                                device="cpu"),
            JaxRegistry().factory("shec", profile))


@pytest.mark.parametrize("technique", TECHNIQUES)
@pytest.mark.parametrize("k,m,c", GEOMETRIES)
def test_parity_matrix_matches_jax(k, m, c, technique):
    single = technique == "single"
    assert np.array_equal(shec_parity_matrix(k, m, c, single),
                          j_parity(k, m, c, single))


@pytest.mark.parametrize("technique", TECHNIQUES)
@pytest.mark.parametrize("k,m,c", GEOMETRIES)
def test_encode_and_every_decode_match_jax(k, m, c, technique):
    """Every erasure pattern of up to c chunks: the same minimum set, the
    same bytes (or the same refusal) as the JAX plugin."""
    tec, jec = _codecs(k, m, c, technique)
    n = k + m
    payload = np.random.default_rng(n).integers(
        0, 256, 3000, dtype=np.uint8).tobytes()
    enc = tec.encode(range(n), payload)
    assert enc == jec.encode(range(n), payload)
    for r in range(1, c + 1):
        for lost in itertools.combinations(range(n), r):
            avail = [i for i in range(n) if i not in lost]
            try:
                want_min = jec.minimum_to_decode(list(lost), avail)
            except IOError:
                with pytest.raises(IOError):
                    tec.minimum_to_decode(list(lost), avail)
                continue
            assert tec.minimum_to_decode(list(lost), avail) == want_min
            chunks = {i: enc[i] for i in avail}
            out = tec.decode(list(lost), chunks)
            assert out == jec.decode(list(lost), chunks)
            assert all(out[w] == enc[w] for w in lost), lost


def test_local_repair_reads_fewer_than_k():
    tec, jec = _codecs(8, 4, 2, "multiple")
    avail = [i for i in range(12) if i != 0]
    got = tec.minimum_to_decode([0], avail)
    assert got == jec.minimum_to_decode([0], avail)
    assert len(got) < 8


def test_device_decode_batches_and_reencodes_parity():
    tec, jec = _codecs(6, 4, 3, "multiple")
    data = np.random.default_rng(2).integers(0, 256, (3, 6, 96), np.uint8)
    enc = tec.encode_chunks_batch(data)
    assert np.array_equal(enc, np.asarray(jec.encode_chunks_batch(data)))
    lost = [1, 7]                            # one data chunk, one parity
    avail = {i: enc[:, i] for i in range(10) if i not in lost}
    got = tec.decode_chunks_batch(avail, lost)
    want = jec.decode_chunks_batch(avail, lost)
    for w in lost:
        assert np.array_equal(got[w], np.asarray(want[w]))
        assert np.array_equal(got[w], enc[:, w])
    dev = tec.decode_chunks_device(
        {i: torch.from_numpy(np.ascontiguousarray(c))
         for i, c in avail.items()}, [7, 2, 1])
    assert np.array_equal(dev.numpy(), enc[:, [7, 2, 1]])


def test_unrecoverable_raises_like_jax():
    tec, jec = _codecs(4, 3, 2, "single")
    avail = [4, 5, 6]
    for ec in (tec, jec):
        with pytest.raises(IOError):
            ec.minimum_to_decode([0, 1, 2, 3], avail)


@pytest.mark.parametrize("profile", [
    {"k": "13", "m": "3", "c": "2"}, {"k": "4", "m": "3", "c": "4"},
    {"k": "4", "m": "3", "c": "2", "w": "16"},
    {"k": "4", "m": "3", "c": "2", "technique": "nope"},
])
def test_bad_profiles_refused_like_jax(profile):
    with pytest.raises(ValueError):
        ErasureCodePluginRegistry().factory("shec", profile, device="cpu")
    with pytest.raises(ValueError):
        JaxRegistry().factory("shec", profile)
