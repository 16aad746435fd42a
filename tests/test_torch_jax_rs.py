"""The port's jax_rs / xor codecs on the CPU against the JAX package's,
exact: encode, decode, batched decode, the device entries, the corpus and
erasure sweeps."""

import itertools
import json

import numpy as np
import pytest
import torch

from ceph_tpu.ec.pallas_kernels import bytes_to_words as j_bytes_to_words
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu.osd.ec_util import StripeInfo as JaxStripeInfo
from ceph_tpu_torch.ec import benchmark, corpus
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.osd.ec_util import StripeInfo

PROFILES = [
    ("jax_rs", {"k": "8", "m": "4", "technique": "reed_sol_van"}),
    ("jax_rs", {"k": "4", "m": "2", "technique": "isa_cauchy"}),
    ("jax_rs", {"k": "6", "m": "2", "technique": "reed_sol_r6_op"}),
    ("jax_rs", {"k": "5", "m": "2", "technique": "liberation", "w": "7"}),
    ("jax_rs", {"k": "5", "m": "3", "technique": "reed_sol_van", "w": "16"}),
    ("xor", {"k": "3", "m": "1"}),
]
IDS = ["_".join(f"{k}={v}" for k, v in p.items()) for _, p in PROFILES]


def _codecs(plugin, profile):
    return (ErasureCodePluginRegistry().factory(plugin, profile, device="cpu"),
            JaxRegistry().factory(plugin, profile))


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_encode_decode_match_jax(plugin, profile):
    tec, jec = _codecs(plugin, profile)
    n, k = tec.get_chunk_count(), tec.get_data_chunk_count()
    payload = _bytes(5000, seed=n).tobytes()
    enc = tec.encode(list(range(n)), payload)
    assert enc == jec.encode(list(range(n)), payload)
    lost = list(range(0, n, 2))[: n - k]
    avail = {i: enc[i] for i in range(n) if i not in lost}
    assert tec.decode(lost, avail) == jec.decode(lost, avail)


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_batched_and_device_entries_match_jax(plugin, profile):
    tec, jec = _codecs(plugin, profile)
    n, k = tec.get_chunk_count(), tec.get_data_chunk_count()
    C = tec.get_chunk_size(1024 * k)
    data = _bytes((3, k, C), seed=C)
    want = np.array(jec.encode_chunks_batch(data))
    assert np.array_equal(tec.encode_chunks_batch(data), want)
    got = tec.encode_chunks_device(torch.from_numpy(data))
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)
    lost = [n - 1, 0][: n - k]
    avail = {i: want[:, i] for i in range(n) if i not in lost}
    expect = jec.decode_chunks_batch(avail, lost)
    got = tec.decode_chunks_batch(avail, lost)
    assert all(np.array_equal(got[w], np.asarray(expect[w])) for w in lost)
    dev = tec.decode_chunks_device(
        {i: torch.from_numpy(a) for i, a in avail.items()}, lost)
    jdev = np.asarray(jec.decode_chunks_device(avail, lost))
    assert np.array_equal(dev.numpy(), jdev)


def test_word_and_shard_entries_match_jax():
    tec, jec = _codecs("jax_rs", {"k": "8", "m": "4"})
    stream = _bytes((8, 2048), seed=8)
    words = j_bytes_to_words(stream)
    tw = ck.bytes_to_words(torch.from_numpy(stream))
    parity = tec.encode_words_device(tw)
    assert np.array_equal(parity.numpy(),
                          np.asarray(jec.encode_words_device(words)))
    assert np.array_equal(tec.encode_shards_device(stream).numpy(),
                          np.asarray(jec.encode_shards_device(stream)))
    full = torch.cat([tw, parity])
    lost = [0, 3, 9, 10]
    avail = {i: full[i] for i in range(12) if i not in lost}
    got = tec.decode_words_device(avail, lost)
    jfull = np.asarray(full)
    want = jec.decode_words_device(
        {i: jfull[i] for i in range(12) if i not in lost}, lost)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), full[lost].numpy())
    with pytest.raises(IOError):
        tec.decode_words_device({i: full[i] for i in range(7)}, [11])


def test_packet_codec_refuses_word_entries():
    tec, _ = _codecs("jax_rs", {"k": "6", "m": "2",
                                "technique": "liber8tion"})
    with pytest.raises(NotImplementedError):
        tec.encode_words_device(torch.zeros((6, 8), dtype=torch.int32))


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "3", "technique": "reed_sol_r6_op"},
    {"k": "5", "m": "3", "technique": "reed_sol_van", "w": "7"},
    {"technique": "nope"},
])
def test_bad_profiles_refused_like_jax(profile):
    with pytest.raises(ValueError):
        ErasureCodePluginRegistry().factory("jax_rs", profile, device="cpu")
    with pytest.raises(ValueError):
        JaxRegistry().factory("jax_rs", profile)


def _ported_archives():
    return [p.name for p in corpus.archives()]


@pytest.mark.parametrize("name", _ported_archives())
def test_corpus_archive_bit_identical(name):
    rec = json.loads((corpus.CORPUS_DIR / name).read_text())
    got = corpus._encode_digests(rec["plugin"], rec["profile"], "cpu")
    assert got == rec["chunk_sha256"]


def test_corpus_check_covers_every_jax_rs_and_xor_archive():
    names = [p.name for p in corpus.archives()]
    assert len(names) == 16
    assert sum(n.startswith(("jax_rs_", "xor_")) for n in names) == 13
    assert [n[:4] for n in names if not n.startswith(("jax_rs_", "xor_"))] \
        == ["lrc_"] * 3
    assert corpus.check(device="cpu") == []


def test_exhaustive_erasure_sweep_k4_m2():
    tec, _ = _codecs("jax_rs", {"k": "4", "m": "2"})
    assert benchmark.verify_all_erasures(tec) == 6 + 15


def test_sampled_erasures_k8_m4_match_jax():
    tec, jec = _codecs("jax_rs", {"k": "8", "m": "4"})
    payload = _bytes(8 * 512, seed=12).tobytes()
    enc = tec.encode(list(range(12)), payload)
    patterns = [p for r in range(1, 5)
                for p in itertools.combinations(range(12), r)]
    rng = np.random.default_rng(84)
    for idx in rng.choice(len(patterns), size=24, replace=False):
        lost = list(patterns[idx])
        avail = {i: enc[i] for i in range(12) if i not in lost}
        got = tec.decode(lost, avail)
        assert got == jec.decode(lost, avail)
        assert all(got[w] == enc[w] for w in lost)


def test_stripe_info_matches_jax_and_keeps_kind():
    info, jinfo = StripeInfo(k=4, chunk_size=128), JaxStripeInfo(4, 128)
    obj = _bytes(4 * 128 * 6, seed=6)
    stripes = info.split_stripes(obj.tobytes())
    assert np.array_equal(stripes, jinfo.split_stripes(obj.tobytes()))
    tstripes = info.split_stripes(torch.from_numpy(obj))
    assert isinstance(tstripes, torch.Tensor)
    assert np.array_equal(tstripes.numpy(), stripes)
    enc = np.concatenate([stripes, stripes[:, :2]], axis=1)    # (6, 6, 128)
    streams = info.shard_streams(enc)
    assert np.array_equal(streams, jinfo.shard_streams(enc))
    tstreams = info.shard_streams(torch.from_numpy(enc))
    assert np.array_equal(tstreams.numpy(), streams)
    assert np.array_equal(info.stack_shard_streams(tstreams[:4], 6).numpy(),
                          obj)
    assert np.array_equal(info.merge_stripes(tstripes).numpy(), obj)
    assert all(np.array_equal(a, b) for a, b in
               zip(info.shard_bytes(enc), jinfo.shard_bytes(enc)))
    assert (info.offset_len_to_stripe_bounds(700, 100)
            == jinfo.offset_len_to_stripe_bounds(700, 100))
    with pytest.raises(ValueError):
        info.split_stripes(obj[:-1])


def test_object_round_trip_through_device_entries():
    """The smoke's object path at a small size: split, encode, drop 4
    shards, decode, merge."""
    tec, _ = _codecs("jax_rs", {"k": "8", "m": "4"})
    info = StripeInfo(k=8, chunk_size=512)
    obj = torch.from_numpy(_bytes(8 * 512 * 5, seed=5))
    chunks = tec.encode_chunks_device(info.split_stripes(obj))
    lost = [1, 4, 8, 10]
    avail = {i: chunks[:, i] for i in range(12) if i not in lost}
    rebuilt = tec.decode_chunks_device(avail, [1, 4])
    data = chunks[:, :8].clone()
    data[:, 1], data[:, 4] = rebuilt[:, 0], rebuilt[:, 1]
    assert torch.equal(info.merge_stripes(data), obj)


def test_benchmark_cli_verify_on_cpu(capsys):
    rec = benchmark.main(["--plugin", "jax_rs", "-P", "k=3", "-P", "m=2",
                          "--verify", "--device", "cpu", "--json"])
    assert rec["combinations"] == 5 + 10 and rec["device"] == "cpu"
    assert json.loads(capsys.readouterr().out)["ok"] is True


def test_benchmark_timing_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        benchmark.cuda_seconds_per_call(lambda: None)
