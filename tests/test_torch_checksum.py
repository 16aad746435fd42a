"""The port's crc32c, device CRC and HashInfo on the CPU against the JAX
package's, exact.

``crc32c`` is the port's own build of its copy of the C source;
``crc_bits_device`` contracts the CRC bitmatrix through B2's plain
version on a CPU tensor (the kernel on a CUDA one); ``verify_batch`` and
``parity_only_batch`` give the scrub verdicts.  Each must return the JAX
package's values on the same seeded inputs (the cases of
tests/test_checksum.py), tolerance 0.
"""

import shutil

import numpy as np
import pytest
import torch

from ceph_tpu.common import crc32c as j_crc_mod
from ceph_tpu.common.crc32c import crc32c as j_crc32c
from ceph_tpu.ec import checksum as j_cs
from ceph_tpu.osd.ec_util import HashInfo as JHashInfo
from ceph_tpu_torch.common import crc32c as crc_mod
from ceph_tpu_torch.common.crc32c import crc32c
from ceph_tpu_torch.ec import checksum as cs
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.osd.ec_util import HashInfo

LENGTHS = [1, 3, 17, 64, 255, 256, 1024, 4096]


def _rows(rows, length, seed):
    return np.random.default_rng(seed).integers(0, 256, (rows, length),
                                                np.uint8)


# -- host crc32c --------------------------------------------------------------

@pytest.mark.skipif(shutil.which("gcc") is None,
                    reason="no C compiler: crc32c serves from the Python "
                           "table loop")
def test_native_crc32c_is_built_from_the_ports_source():
    assert crc_mod.backend() == "native"
    lib = crc_mod.library_path()
    assert lib.parent == crc_mod.BUILD_DIR and lib.exists()
    assert crc_mod.SOURCE.parent.name == "native"
    assert crc_mod.SOURCE.parent.parent.name == "ceph_tpu_torch"


def test_crc_table_matches_reference():
    assert crc_mod.table() == j_crc_mod._table()


@pytest.mark.parametrize("length", [0, 1, 3, 4095, 4096, 65536])
def test_crc32c_matches_reference(length):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, length, np.uint8).tobytes()
    for seed in [0, 0xFFFFFFFF] + [int(s) for s in
                                   rng.integers(0, 1 << 32, 3)]:
        assert crc32c(seed, data) == j_crc32c(seed, data)


def test_python_table_loop_matches_native(monkeypatch):
    data = _rows(1, 1000, 5)[0].tobytes()
    native = crc32c(0x1234, data)
    monkeypatch.setattr(crc_mod, "_native", False)
    assert crc_mod.backend() == "python"
    assert crc32c(0x1234, data) == native


def test_crc32c_seed_chaining():
    a, b = _rows(2, 777, 9)
    whole = crc32c(0xFFFFFFFF, a.tobytes() + b.tobytes())
    assert crc32c(crc32c(0xFFFFFFFF, a.tobytes()), b.tobytes()) == whole


# -- the device CRC -----------------------------------------------------------

@pytest.mark.parametrize("length", [1, 3, 17, 96, 4096])
def test_crc_bitmatrix_matches_reference(length):
    assert np.array_equal(cs.crc_bitmatrix(length),
                          j_cs.crc_bitmatrix(length))


def test_crc_constants_cached_per_length():
    assert cs.crc_constants(256) is cs.crc_constants(256)
    consts = cs.crc_constants(256)
    assert (consts.mout, consts.kin) == (4, 256)


@pytest.mark.parametrize("length", LENGTHS)
def test_device_crc32c_matches_reference(length):
    streams = _rows(5, length, length)
    got = cs.device_crc32c(streams, device="cpu")
    assert got == j_cs.device_crc32c(streams)
    assert got == [crc32c(cs.CRC_SEED, r.tobytes()) for r in streams]


def test_crc_bits_device_matches_reference_and_stays_on_its_device():
    streams = _rows(12, 4096, 1)
    t = torch.from_numpy(streams)
    bits = cs.crc_bits_device(t)
    assert bits.device == t.device and bits.shape == (12, 4)
    assert np.array_equal(bits.numpy(), np.asarray(
        j_cs.crc_bits_device(streams)))


def test_crc_bits_device_goes_through_b2(monkeypatch):
    seen = []
    real = ck.gf2_apply_u8

    def spy(consts, data, out=None):
        seen.append((consts.mout, consts.kin, tuple(data.shape)))
        return real(consts, data, out)

    monkeypatch.setattr(ck, "gf2_apply_u8", spy)
    cs.crc_bits_device(torch.from_numpy(_rows(7, 300, 2)))
    assert seen == [(4, 300, (300, 7))]


def test_chained_seeds_match_hashinfo_append():
    n, L = 4, 512
    chunks = [_rows(n, L, 70 + j) for j in range(3)]
    hinfo, jhinfo = HashInfo(n), JHashInfo(n)
    seeds = [cs.CRC_SEED] * n
    for j, batch in enumerate(chunks):
        rows = [batch[i].tobytes() for i in range(n)]
        hinfo.append(j * L, rows)
        jhinfo.append(j * L, rows)
        seeds = cs.device_crc32c(batch, seeds=seeds, device="cpu")
    assert seeds == list(hinfo.cumulative_shard_hashes)
    assert hinfo.to_dict() == jhinfo.to_dict()


def test_zero_crc_matches_reference():
    for seed in (cs.CRC_SEED, 0, 0xDEADBEEF):
        for L in (1, 64, 1000):
            assert cs.zero_crc(seed, L) == j_cs.zero_crc(seed, L)


def test_verify_batch_matches_reference():
    rng = np.random.default_rng(11)
    B, n, L = 3, 4, 256
    stored = rng.integers(0, 256, (B, n, L), np.uint8)
    recomputed = stored.copy()
    recomputed[1, 2, 17] ^= 0x40
    eq, crcs = cs.verify_batch(recomputed, stored, device="cpu")
    j_eq, j_crcs = j_cs.verify_batch(recomputed, stored)
    assert np.array_equal(eq, np.asarray(j_eq))
    assert np.array_equal(crcs, np.asarray(j_crcs))
    assert crcs.dtype == np.uint32 and not eq[1, 2] and eq.sum() == 11


def test_verify_batch_on_tensors():
    rng = np.random.default_rng(12)
    stored = rng.integers(0, 256, (2, 6, 128), np.uint8)
    recomputed = stored.copy()
    recomputed[0, 5, 0] ^= 1
    eq, crcs = cs.verify_batch(torch.from_numpy(recomputed),
                               torch.from_numpy(stored))
    j_eq, j_crcs = j_cs.verify_batch(recomputed, stored)
    assert np.array_equal(eq, np.asarray(j_eq))
    assert np.array_equal(crcs, np.asarray(j_crcs))


def test_parity_only_batch_matches_reference():
    rng = np.random.default_rng(13)
    stored = rng.integers(0, 256, (2, 3, 128), np.uint8)
    recomputed = stored.copy()
    recomputed[0, 1, 5] ^= 1
    eq = cs.parity_only_batch(recomputed, stored, device="cpu")
    assert np.array_equal(eq, np.asarray(
        j_cs.parity_only_batch(recomputed, stored)))


@pytest.mark.parametrize("length,cap", [
    (1, None), (0, None), (-4, None), (cs.CRC_DEVICE_MAX_LEN, None),
    (cs.CRC_DEVICE_MAX_LEN + 1, None), (1 << 20, 1 << 22),
    ((1 << 21) - 1, 1 << 30), (1 << 21, 1 << 30)])
def test_supported_len_gate_matches_reference(length, cap):
    assert cs.supported_len(length, cap) == j_cs.supported_len(length, cap)
    assert cs.CRC_DEVICE_MAX_LEN == j_cs.CRC_DEVICE_MAX_LEN == 1 << 16


def test_device_crc_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cs.device_crc32c(_rows(2, 16, 0))


# -- HashInfo -----------------------------------------------------------------

def test_hashinfo_chaining_and_dict_round_trip():
    n = 6
    hinfo, jhinfo = HashInfo(n), JHashInfo(n)
    off = 0
    for j, L in enumerate((128, 1, 4096, 300)):
        batch = _rows(n, L, 90 + j)
        rows = [batch[i].tobytes() for i in range(n)]
        hinfo.append(off, rows)
        jhinfo.append(off, rows)
        off += L
        assert hinfo.to_dict() == jhinfo.to_dict()
    d = hinfo.to_dict()
    assert HashInfo.from_dict(n, d).to_dict() == d
    assert JHashInfo.from_dict(n, d).to_dict() == d
    assert [hinfo.get_chunk_hash(i) for i in range(n)] == \
        [jhinfo.get_chunk_hash(i) for i in range(n)]


@pytest.mark.parametrize("old,rows", [
    (5, [b"a"] * 3), (0, [b"a"] * 2), (0, [b"a", b"bb", b"c"])],
    ids=["wrong_offset", "wrong_count", "unequal"])
def test_hashinfo_refuses_what_reference_refuses(old, rows):
    with pytest.raises(ValueError):
        HashInfo(3).append(old, rows)
    with pytest.raises(ValueError):
        JHashInfo(3).append(old, rows)
