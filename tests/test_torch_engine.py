"""The port's BitplaneEngine on the CPU against the JAX package's engine
(its XLA einsum path), exact, on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import engine as j_engine
from ceph_tpu.ec import matrix as j_matrix
from ceph_tpu.ec.bitmatrix import gf_matrix_to_bitmatrix
from ceph_tpu.ec.pallas_kernels import bytes_to_words as j_bytes_to_words
from ceph_tpu.ec.plugins.jax_rs import ErasureCodeJaxRS as JaxCodec
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec import engine as t_engine


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def engines():
    return (t_engine.BitplaneEngine(device="cpu"),
            j_engine.BitplaneEngine(use_pallas=False))


@pytest.mark.parametrize("technique,k,m,shape", [
    ("reed_sol_van", 8, 4, (3, 8, 512)),
    ("cauchy_good", 10, 4, (2, 10, 100)),
    ("isa_vandermonde", 8, 3, (8, 257)),           # (k, N), ragged N
])
def test_apply_and_encode_match_jax(engines, technique, k, m, shape):
    t_eng, j_eng = engines
    G = j_matrix.generator_matrix(technique, k, m)
    data = _bytes(shape, seed=k + m)
    got = t_eng.apply(G[k:], data)
    assert np.array_equal(got.numpy(), np.asarray(j_eng.apply(G[k:], data)))
    enc = t_eng.encode(G, torch.from_numpy(data))
    assert np.array_equal(enc.numpy(), np.asarray(j_eng.encode(G, data)))


def test_apply_words_and_shards_match_jax(engines):
    t_eng, j_eng = engines
    G = j_matrix.generator_matrix("reed_sol_van", 8, 4)
    stream = _bytes((8, 1024), seed=5)
    words = j_bytes_to_words(stream)
    expect = np.asarray(j_eng.apply_words(G[8:], words))
    got = t_eng.apply_words(G[8:], ck.bytes_to_words(torch.from_numpy(stream)))
    assert np.array_equal(got.numpy(), expect)
    assert np.array_equal(t_eng.encode_shards(G, stream).numpy(),
                          np.asarray(j_eng.encode_shards(G, stream)))


@pytest.mark.parametrize("profile,shape", [
    ({"k": "5", "m": "2", "technique": "liberation", "w": "7"}, (2, 5, 896)),
    ({"k": "6", "m": "2", "technique": "blaum_roth", "w": "6"}, (6, 384)),
    ({"k": "5", "m": "3", "technique": "reed_sol_van", "w": "16"},
     (2, 5, 512)),
    ({"k": "4", "m": "2", "technique": "reed_sol_van", "w": "32"},
     (1, 4, 1024)),
])
def test_apply_packets_matches_jax(engines, profile, shape):
    t_eng, j_eng = engines
    jec = JaxCodec(profile)
    k, w = jec.k, jec.w
    BM = jec.full_bm[k * w:]
    data = _bytes(shape, seed=w)
    expect = np.asarray(j_eng.apply_packets(BM, data, w))
    assert np.array_equal(t_eng.apply_packets(BM, data, w).numpy(), expect)


def test_plain_bitplane_apply_matches_jax():
    G = j_matrix.generator_matrix("reed_sol_van", 6, 3)
    bm = gf_matrix_to_bitmatrix(G[6:])
    data = _bytes((2, 6, 96), seed=2)
    expect = np.asarray(j_engine.bitplane_apply(
        jnp.asarray(bm, jnp.bfloat16), jnp.asarray(data)))
    got = t_engine.bitplane_apply(torch.from_numpy(bm.astype(np.float32)),
                                  torch.from_numpy(data))
    assert np.array_equal(got.numpy(), expect)


def test_plain_packet_apply_matches_jax():
    jec = JaxCodec({"k": "6", "m": "2", "technique": "liber8tion"})
    BM = jec.full_bm[6 * 8:]
    data = _bytes((2, 6, 256), seed=4)
    expect = np.asarray(j_engine.packet_bitmatrix_apply(
        jnp.asarray(BM, jnp.bfloat16), jnp.asarray(data), 8))
    got = t_engine.packet_bitmatrix_apply(
        torch.from_numpy(BM.astype(np.float32)), torch.from_numpy(data), 8)
    assert np.array_equal(got.numpy(), expect)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 64, 100])
def test_bucket_helpers_match_jax(n):
    assert t_engine.pow2_bucket(n) == j_engine.pow2_bucket(n)
    assert t_engine.mesh_bucket(n, 3) == j_engine.mesh_bucket(n, 3)
    arr = _bytes((n, 2, 4), seed=n)
    got, b = t_engine.pad_batch_pow2(arr)
    want, bj = j_engine.pad_batch_pow2(arr)
    assert b == bj and np.array_equal(got, want)
    dev, b = t_engine.pad_batch_pow2_device(torch.from_numpy(arr))
    assert b == n and np.array_equal(dev.numpy(), want)
    assert np.array_equal(t_engine.pad_batch_to(arr, n + 3),
                          j_engine.pad_batch_to(arr, n + 3))


def test_engine_caches_appliers(engines):
    t_eng, _ = engines
    G = j_matrix.generator_matrix("reed_sol_van", 4, 2)
    assert t_eng.applier(G[4:]) is t_eng.applier(G[4:].copy())
    assert t_eng.applier(G[4:]) is not t_eng.applier(G[:2])


def test_engine_needs_a_device(monkeypatch):
    """No device and no CUDA: the entry point raises, it does not carry on
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        t_engine.BitplaneEngine()
    with pytest.raises(RuntimeError):
        t_engine.default_engine()
    assert t_engine.default_engine("cpu").device == torch.device("cpu")


def test_engine_refuses_tensor_on_other_device(engines):
    t_eng, _ = engines
    G = j_matrix.generator_matrix("reed_sol_van", 4, 2)
    with pytest.raises(ValueError):
        t_eng.apply(G[4:], torch.empty((4, 8), dtype=torch.uint8,
                                       device="meta"))
    with pytest.raises(TypeError):
        t_eng.apply(G[4:], torch.zeros((4, 8), dtype=torch.int32))
