"""The port's LRC codec on the CPU against the JAX package's, exact.

Profile parsing (kml and explicit layers), the layered minimum_to_decode,
encode and decode bytes, the local repair operator and
``batched_lrc_group_repair`` must equal the JAX package's; cases mirror
tests/test_lrc.py at small sizes.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu.ec.repair_operator import lrc_repair_operator as j_operator
from ceph_tpu.parallel import lrc_sharding as j_sharding
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ec.repair_operator import lrc_repair_operator
from ceph_tpu_torch.parallel import lrc_sharding

PROFILE_3L = {
    "mapping": "__DD__DD",
    "layers": '[ [ "_cDD_cDD", "" ], [ "c_DD____", "" ], [ "____cDDD", "" ] ]',
}
PROFILES = [
    {"k": "4", "m": "2", "l": "3"},
    {"k": "8", "m": "4", "l": "3"},
    {"k": "12", "m": "4", "l": "4"},
    PROFILE_3L,
    {"mapping": "__DDD__DD_",
     "layers": '[ [ "_cDDD_cDD_", "" ], [ "c_DDD_____", "" ],'
               ' [ "_____cDDD_", "" ], [ "_____DDDDc", "" ] ]'},
    {"mapping": "DD_", "layers": '[ [ "DDc", "plugin=isa technique=cauchy" ] ]'},
]
IDS = ["k4m2l3", "k8m4l3", "k12m4l4", "explicit_3l", "explicit_4l", "isa"]


def _codecs(profile):
    return (ErasureCodePluginRegistry().factory("lrc", profile, device="cpu"),
            JaxRegistry().factory("lrc", profile))


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_parse_matches_jax(profile):
    tec, jec = _codecs(profile)
    assert tec.mapping == jec.mapping
    assert tec.get_chunk_mapping() == jec.get_chunk_mapping()
    assert tec.rule_steps == jec.rule_steps
    assert [(l.chunks_map, l.profile) for l in tec.layers] == \
        [(l.chunks_map, l.profile) for l in jec.layers]
    for tl, jl in zip(tec.layers, jec.layers):
        assert np.array_equal(tl.code.generator, jl.code.generator)


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_encode_and_decode_match_jax(profile):
    tec, jec = _codecs(profile)
    n, k = tec.get_chunk_count(), tec.get_data_chunk_count()
    payload = np.random.default_rng(n).integers(
        0, 256, k * 512 - 5, dtype=np.uint8).tobytes()
    enc = tec.encode(range(n), payload)
    assert enc == jec.encode(range(n), payload)
    for r in (1, 2):
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
            try:
                want = jec.decode(list(lost), chunks)
            except IOError:
                with pytest.raises(IOError):
                    tec.decode(list(lost), chunks)
                continue
            assert tec.decode(list(lost), chunks) == want
            assert all(want[w] == enc[w] for w in lost)


@pytest.mark.parametrize("profile", PROFILES[:3], ids=IDS[:3])
def test_device_entries_match_host(profile):
    tec, jec = _codecs(profile)
    n, k = tec.get_chunk_count(), tec.get_data_chunk_count()
    data = np.random.default_rng(4).integers(0, 256, (3, k, 256), np.uint8)
    enc = tec.encode_chunks_device(torch.from_numpy(data))
    assert np.array_equal(enc.numpy(), np.asarray(
        jec.encode_chunks_device(data)))
    assert np.array_equal(tec.encode_chunks_batch(data), enc.numpy())
    lost = [0, n - 1]
    avail = {i: enc[:, i] for i in range(n) if i not in lost}
    got = tec.decode_chunks_device(avail, lost)
    assert np.array_equal(got.numpy(), enc[:, lost].numpy())
    host = tec.decode_chunks_batch({i: c.numpy() for i, c in avail.items()},
                                   lost)
    for j, w in enumerate(lost):
        assert np.array_equal(host[w], got[:, j].numpy())


@pytest.mark.parametrize("profile", PROFILES[:3], ids=IDS[:3])
def test_repair_operator_and_group_repair_match_jax(profile):
    tec, jec = _codecs(profile)
    n, k = tec.get_chunk_count(), tec.get_data_chunk_count()
    data = np.random.default_rng(6).integers(0, 256, (4, k, 128), np.uint8)
    enc = tec.encode_chunks_batch(data)
    for lost in range(n):
        coeffs, minimum = lrc_repair_operator(tec, lost)
        want = j_operator(jec, lost)
        assert np.array_equal(coeffs, want[0]) and minimum == want[1]
        got = lrc_sharding.batched_lrc_group_repair(tec, coeffs,
                                                    enc[:, minimum])
        assert np.array_equal(got, enc[:, lost]), lost
    args = (len(minimum), 16, 4096)
    assert lrc_sharding.lrc_repair_ici_bytes(tec, *args) == \
        j_sharding.lrc_repair_ici_bytes(jec, *args)


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "2", "l": "4"},
    {"k": "4", "m": "2"},
    {"mapping": "DD_", "layers": '[ [ "DDc_", "" ] ]'},
    {"k": "4", "m": "2", "l": "3", "mapping": "DD_DD_"},
])
def test_bad_profiles_refused_like_jax(profile):
    with pytest.raises(ValueError):
        ErasureCodePluginRegistry().factory("lrc", profile, device="cpu")
    with pytest.raises(ValueError):
        JaxRegistry().factory("lrc", profile)
