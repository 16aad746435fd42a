"""The port's CLAY codec on the CPU against the JAX package's, exact.

Encode, full decode, repair (through ``decode`` with repair-sized helper
reads, the coupling schedule) and the probed repair operators must give
the JAX plugin's bytes; ``batched_clay_plane_repair`` (one grouped apply)
must rebuild every single lost chunk.  Cases mirror tests/test_clay.py at
small sizes.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu.ec.repair_operator import clay_repair_operator as j_operator
from ceph_tpu.parallel import clay_sharding as j_sharding
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ec.repair_operator import clay_repair_operator
from ceph_tpu_torch.parallel import clay_sharding

PROFILES = [
    {"k": "4", "m": "2", "d": "5"},
    {"k": "4", "m": "2", "d": "4"},                 # aloof nodes
    {"k": "3", "m": "3", "d": "4"},
    {"k": "5", "m": "4", "d": "8"},                 # nu = 3 shortened nodes
    {"k": "6", "m": "3", "d": "8"},
    {"k": "8", "m": "4", "d": "11"},                # the BASELINE config
    {"k": "4", "m": "2", "scalar_mds": "shec"},     # shec inner code
    {"k": "4", "m": "2", "scalar_mds": "isa", "technique": "cauchy"},
]
IDS = ["-".join(f"{k}{v}" for k, v in p.items()) for p in PROFILES]


def _codecs(profile):
    return (ErasureCodePluginRegistry().factory("clay", profile,
                                                device="cpu"),
            JaxRegistry().factory("clay", profile))


def _payload(ec, seed=0):
    size = ec.get_data_chunk_count() * ec.get_chunk_size(1) - 7
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _partial(ec, encoded, lost):
    """The repair sub-chunk ranges of each helper: what ECBackend reads."""
    chunk_size = len(encoded[0])
    sc = chunk_size // ec.sub_chunk_no
    avail = [i for i in range(ec.get_chunk_count()) if i != lost]
    minimum = ec.minimum_to_decode([lost], avail)
    out = {}
    for i, ranges in minimum.items():
        buf = np.frombuffer(encoded[i], np.uint8)
        out[i] = np.concatenate(
            [buf[off * sc:(off + cnt) * sc] for off, cnt in ranges]).tobytes()
    return out


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_geometry_matches_jax(profile):
    tec, jec = _codecs(profile)
    for attr in ("k", "m", "d", "q", "t", "nu", "sub_chunk_no"):
        assert getattr(tec, attr) == getattr(jec, attr), attr
    assert tec.get_alignment() == jec.get_alignment()
    assert np.array_equal(tec.pair.P, jec.pair.P)
    assert np.array_equal(tec.mds.generator, jec.mds.generator)
    n = tec.get_chunk_count()
    for lost in range(n):
        avail = [i for i in range(n) if i != lost]
        try:
            want = jec.minimum_to_decode([lost], avail)
        except IOError:
            with pytest.raises(IOError):
                tec.minimum_to_decode([lost], avail)
            continue
        assert tec.minimum_to_decode([lost], avail) == want


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_encode_matches_jax(profile):
    tec, jec = _codecs(profile)
    n = tec.get_chunk_count()
    payload = _payload(tec)
    enc = tec.encode(range(n), payload)
    assert enc == jec.encode(range(n), payload)
    assert tec.decode_concat(enc)[:len(payload)] == payload
    batch = np.random.default_rng(1).integers(
        0, 256, (3, tec.k, tec.get_chunk_size(1)), np.uint8)
    got = tec.encode_chunks_batch(batch)
    assert np.array_equal(got, np.asarray(jec.encode_chunks_batch(batch)))
    dev = tec.encode_chunks_device(torch.from_numpy(batch))
    assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(), got)


@pytest.mark.parametrize("profile,erasures", [
    (PROFILES[0], 1), (PROFILES[0], 2), (PROFILES[2], 3), (PROFILES[3], 4),
    (PROFILES[6], 2), (PROFILES[5], 4)])
def test_full_decode_matches_jax(profile, erasures):
    tec, jec = _codecs(profile)
    n = tec.get_chunk_count()
    enc = tec.encode(range(n), _payload(tec, seed=erasures))
    patterns = list(itertools.combinations(range(n), erasures))
    for lost in patterns[:: max(1, len(patterns) // 12)]:
        avail = {i: c for i, c in enc.items() if i not in lost}
        out = tec.decode(list(lost), avail)
        assert out == jec.decode(list(lost), avail)
        assert all(out[w] == enc[w] for w in lost), lost


def test_decode_batch_and_device_entries():
    tec, jec = _codecs(PROFILES[0])
    batch = np.random.default_rng(11).integers(
        0, 256, (3, 4, tec.get_chunk_size(1)), np.uint8)
    enc = tec.encode_chunks_batch(batch)
    lost = [1, 4]
    avail = {i: enc[:, i] for i in range(6) if i not in lost}
    got = tec.decode_chunks_batch(avail, lost)
    want = jec.decode_chunks_batch(avail, lost)
    for w in lost:
        assert np.array_equal(got[w], np.asarray(want[w]))
        assert np.array_equal(got[w], enc[:, w])
    dev = tec.decode_chunks_device(
        {i: torch.from_numpy(np.ascontiguousarray(c)) for i, c in
         avail.items()}, [4, 0, 1])
    assert dev.shape == (3, 3, enc.shape[2])
    assert np.array_equal(dev.numpy(), enc[:, [4, 0, 1]])


def test_too_many_erasures_raise_like_jax():
    tec, jec = _codecs(PROFILES[0])
    enc = tec.encode(range(6), _payload(tec))
    avail = {i: enc[i] for i in range(3)}
    for ec in (tec, jec):
        with pytest.raises(IOError):
            ec.decode([3, 4, 5], avail)


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_repair_matches_jax(profile):
    """Single-chunk repair from d helpers' sub-chunks (the coupling
    schedule), every lost chunk that takes the repair path."""
    tec, jec = _codecs(profile)
    n = tec.get_chunk_count()
    enc = tec.encode(range(n), _payload(tec, seed=5))
    chunk_size = len(enc[0])
    repaired = 0
    for lost in range(n):
        avail = [i for i in range(n) if i != lost]
        if not tec.is_repair([lost], avail):
            continue
        partial = _partial(tec, enc, lost)
        if len(partial) != tec.d:
            continue
        out = tec.decode([lost], partial, chunk_size=chunk_size)
        assert out == jec.decode([lost], partial, chunk_size=chunk_size)
        assert out[lost] == enc[lost], lost
        repaired += 1
    assert repaired > 0


@pytest.mark.parametrize("profile", PROFILES[:6], ids=IDS[:6])
def test_repair_operator_matches_jax(profile):
    tec, jec = _codecs(profile)
    for lost in range(tec.get_chunk_count()):
        try:
            want = j_operator(jec, lost)
        except IOError:
            with pytest.raises(IOError):
                clay_repair_operator(tec, lost)
            continue
        R, helpers, planes = clay_repair_operator(tec, lost)
        assert np.array_equal(R, want[0]), lost
        assert (helpers, planes) == (want[1], want[2])


@pytest.mark.parametrize("profile", [PROFILES[0], PROFILES[4], PROFILES[5]],
                         ids=[IDS[0], IDS[4], IDS[5]])
def test_batched_plane_repair_recovers_every_chunk(profile):
    """One engine apply of R (the grouped kernel's plain version where R
    groups) rebuilds every single lost chunk of a stripe batch."""
    tec, _ = _codecs(profile)
    sc = 16
    C = tec.sub_chunk_no * sc
    data = np.random.default_rng(3).integers(0, 256, (3, tec.k, C), np.uint8)
    chunks = tec.encode_chunks_batch(data)
    for lost in range(tec.get_chunk_count()):
        R, helpers, planes = clay_repair_operator(tec, lost)
        flat = np.stack([chunks[:, h].reshape(3, tec.sub_chunk_no, sc)[:, planes]
                         for h in helpers], axis=1).reshape(3, -1, sc)
        got = clay_sharding.batched_clay_plane_repair(tec, R, flat)
        assert np.array_equal(got, chunks[:, lost]), lost
        dev = clay_sharding.batched_clay_plane_repair_device(
            tec, R, torch.from_numpy(flat))
        assert np.array_equal(dev.numpy(), got)


def test_k8_repair_takes_the_grouped_route():
    tec, _ = _codecs(PROFILES[5])
    R, _, _ = clay_repair_operator(tec, 3)
    ap = tec._engine.grouped_applier(R)
    assert isinstance(ap, ck.GroupedApply) and ap.plan.fused


@pytest.mark.parametrize("sc", [16, 1024])
def test_plane_ranges_and_ici_bytes_match_jax(sc):
    tec, jec = _codecs(PROFILES[5])
    for lost in (0, 3, 11):
        planes = tec._repair_planes(tec._node_of(lost))
        assert clay_sharding.clay_plane_ranges(planes, sc) == \
            j_sharding.clay_plane_ranges(planes, sc)
    args = (11, 64, tec.sub_chunk_no * sc)
    assert clay_sharding.clay_repair_ici_bytes(tec, *args) == \
        j_sharding.clay_repair_ici_bytes(jec, *args)


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "2", "d": "6"},
    {"k": "4", "m": "2", "scalar_mds": "nope"},
    {"k": "4", "m": "2", "scalar_mds": "shec", "technique": "reed_sol_van"},
    {"k": "4", "m": "2", "scalar_mds": "isa", "technique": "cauchy_good"},
])
def test_bad_profiles_refused_like_jax(profile):
    with pytest.raises(ValueError):
        ErasureCodePluginRegistry().factory("clay", profile, device="cpu")
    with pytest.raises(ValueError):
        JaxRegistry().factory("clay", profile)
