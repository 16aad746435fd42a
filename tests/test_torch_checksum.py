"""The port's crc32c, device CRC and HashInfo on the CPU against the JAX
package's, exact.

``crc32c`` is the port's own build of its copy of the C source;
``crc_bits_device`` contracts the CRC bitmatrix through B2's plain
version on a CPU tensor (the kernel on a CUDA one); ``verify_batch`` and
``parity_only_batch`` give the scrub verdicts.  Each must return the JAX
package's values on the same seeded inputs (the cases of
tests/test_checksum.py), tolerance 0.
"""

import ctypes
import re
import shutil
import sys
import threading

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


# The native library's paths, each called straight through ctypes: the
# dispatching entry, the slice-by-8 table loop and the hardware loop (the
# three-stream rounds of native/crc32c.c's two block sizes, its one-stream
# loop, its bytewise head and tail).
CRC_PATHS = ["ceph_tpu_crc32c", "ceph_tpu_crc32c_table", "ceph_tpu_crc32c_hw"]
HW_BLOCKS = [int(b) for b in re.findall(
    r"#define \w+_BLOCK (\d+)", crc_mod.SOURCE.read_text())]
CRC_LENGTHS = sorted(set(range(65)) | {
    n for b in HW_BLOCKS for n in (3 * b - 1, 3 * b, 3 * b + 7, 6 * b + 1)}
    | {4095, 4096, 65536, 512 << 10, (4 << 20) + 5})


def _native_crc(name):
    """``name`` of the native library as f(seed, buffer, offset, length),
    on a function object of its own (argtypes are per object)."""
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler: the native library is not built")
    if name == "ceph_tpu_crc32c_hw" and crc_mod.native_path() == "table":
        pytest.skip("this CPU has no CRC32 instruction the library can use")
    fn = crc_mod._load_native()[name]
    fn.restype = ctypes.c_uint32
    fn.argtypes = (ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t)
    return lambda seed, buf, off, n: fn(seed, ctypes.addressof(buf) + off, n)


@pytest.mark.parametrize("length,path", [
    pytest.param(n, "crc32c", id=str(n))
    for n in [0, 1, 3, 4095, 4096, 65536]] + [
    pytest.param(n, p, id=f"{p}-{n}") for p in CRC_PATHS
    for n in CRC_LENGTHS])
def test_crc32c_matches_reference(length, path):
    """Each path against the JAX package's crc32c, exactly: seeds 0, all
    ones and random; through ctypes also every start offset 0-7 into the
    buffer (unaligned heads)."""
    rng = np.random.default_rng(length)
    seeds = [0, 0xFFFFFFFF] + [int(s) for s in rng.integers(0, 1 << 32, 3)]
    if path == "crc32c":
        data = rng.integers(0, 256, length, np.uint8).tobytes()
        for seed in seeds:
            assert crc32c(seed, data) == j_crc32c(seed, data)
        return
    crc = _native_crc(path)
    data = rng.integers(0, 256, length + 7, np.uint8).tobytes()
    buf = ctypes.create_string_buffer(data, len(data))
    for off in range(8):
        part = data[off:off + length]
        for seed in seeds:
            assert crc(seed, buf, off, length) == j_crc32c(seed, part)


def test_python_table_loop_matches_native(monkeypatch):
    data = _rows(1, 1000, 5)[0].tobytes()
    native = crc32c(0x1234, data)
    monkeypatch.setattr(crc_mod, "_native", False)
    assert crc_mod.backend() == "python"
    assert crc32c(0x1234, data) == native


@pytest.mark.skipif(shutil.which("gcc") is None,
                    reason="no C compiler: crc32c serves from the Python "
                           "table loop")
def test_crc32c_stats_count_the_path_that_served(monkeypatch):
    path = crc_mod.native_path()
    assert path in ("sse4.2-3way", "armv8-crc", "table")
    served = "table_bytes" if path == "table" else "hw_bytes"
    idle = "hw_bytes" if path == "table" else "table_bytes"
    sizes = [0, 7, 4096, (512 << 10) + 3]
    before = crc_mod.stats()
    for n in sizes:
        crc32c(0, bytes(n))
    after = crc_mod.stats()
    assert after["path"] == path
    assert after[served] - before[served] == sum(sizes)
    assert after[idle] == before[idle]
    assert after["calls"] - before["calls"] == len(sizes)
    # ctypes lets go of the interpreter lock: threads count at once in C
    calls, per = 16, 2000
    before = crc_mod.stats()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda: [
            crc32c(0, bytes(100)) for _ in range(per)]) for _ in range(calls)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    after = crc_mod.stats()
    assert after["calls"] - before["calls"] == calls * per
    assert after[served] - before[served] == calls * per * 100
    monkeypatch.setattr(crc_mod, "_native", False)
    assert crc_mod.native_path() == "python"
    assert crc_mod.stats() == {"path": "python", "hw_bytes": 0,
                               "table_bytes": 0, "calls": 0}


def test_crc32c_seed_chaining():
    a, b = _rows(2, 777, 9)
    whole = crc32c(0xFFFFFFFF, a.tobytes() + b.tobytes())
    assert crc32c(crc32c(0xFFFFFFFF, a.tobytes()), b.tobytes()) == whole
    # splits that fall inside a three-stream block, on every native path
    data = _rows(1, 6 * max(HW_BLOCKS) + 13, 10)[0].tobytes()
    whole = j_crc32c(0xFFFFFFFF, data)
    if shutil.which("gcc") is None:
        return
    paths = CRC_PATHS[:2] if crc_mod.native_path() == "table" else CRC_PATHS
    cuts = [1, 5] + [n for b in HW_BLOCKS
                     for n in (b // 2 + 3, 3 * b + b // 3)]
    buf = ctypes.create_string_buffer(data, len(data))
    for name in paths:
        crc = _native_crc(name)
        for cut in cuts:
            head = crc(0xFFFFFFFF, buf, 0, cut)
            assert crc(head, buf, cut, len(data) - cut) == whole, (name, cut)


# -- the device CRC -----------------------------------------------------------

@pytest.mark.parametrize("length", [1, 3, 17, 96, 4096])
def test_crc_bitmatrix_matches_reference(length):
    assert np.array_equal(cs.crc_bitmatrix(length),
                          j_cs.crc_bitmatrix(length))


def test_crc_constants_cached_per_length():
    assert cs.crc_constants(256) is cs.crc_constants(256)
    plan = cs.crc_constants(256)
    assert (plan.step1.mout, plan.step1.kin) == (4, 16)
    assert plan.seg_folds == [] and plan.launches == 2
    assert cs.crc_constants(256, 64) is not plan
    assert [f for f, _ in cs.crc_constants(256, 64).seg_folds] == [4]


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
    # 300 bytes front-padded to one segment of 304: step 1 over its 19
    # rows of 16 lanes, then the 16 lanes folded over the (16, 4, 7)
    # transpose
    assert seen == [(4, 19, (7, 19, 16)), (4, 64, (1, 64, 7))]


# The split-L form: step 1 over segments of 16 lanes, segment folds, the
# lane fold.  Every (L, B) of the grid against the host crc32c; the JAX
# package's crc_bits_device (its einsum on the CPU) at every point but
# (65536, 768), whose bf16 bit expansion alone is 805 MB.
SPLIT_LENGTHS = [1, 7, 511, 512, 4097, 65536]
SPLIT_BATCHES = [1, 12, 768]


@pytest.mark.parametrize("batch", SPLIT_BATCHES)
@pytest.mark.parametrize("length", SPLIT_LENGTHS)
def test_split_crc_matches_host_and_reference(length, batch):
    streams = _rows(batch, length, 1000 * length + batch)
    bits = cs.crc_bits_device(torch.from_numpy(streams)).numpy()
    assert bits.shape == (batch, 4) and bits.dtype == np.uint8
    assert cs.finalize_crcs(bits, [cs.CRC_SEED] * batch, length) == [
        crc32c(cs.CRC_SEED, r.tobytes()) for r in streams]
    if length * batch < 65536 * 768:
        assert np.array_equal(bits, np.asarray(
            j_cs.crc_bits_device(streams)))


@pytest.mark.parametrize("seg,fan,lanes", [
    (16, 2, (2, 2, 2, 2)), (64, 4, (4, 4)), (256, 16, (16,)),
    (4096, 16, (16,)), (1024, 8, (2, 8))])
def test_split_crc_plans_agree(seg, fan, lanes):
    streams = torch.from_numpy(_rows(5, 4097, seg))
    plan = cs.CrcPlan(4097, seg, fan, lanes)
    assert plan.padded % plan.seg == 0 and plan.pad == plan.padded - 4097
    assert plan.launches == 1 + len(plan.seg_folds) + len(lanes)
    assert torch.equal(plan(streams), cs.crc_bits_plain(streams))


def test_split_crc_plan_refuses_bad_shapes():
    for args in [(0,), (64, 24), (64, 64, 1), (64, 64, 4, (4, 2))]:
        with pytest.raises(ValueError):
            cs.CrcPlan(*args)


@pytest.mark.parametrize("length", [7, 511, 4097])
def test_split_crc_chained_seeds(length):
    """Seeds chain through the host's affine term: three appends of one
    length equal one pass over their concatenation."""
    parts = [_rows(12, length, 40 + j) for j in range(3)]
    seeds = [cs.CRC_SEED] * 12
    for part in parts:
        ref = j_cs.device_crc32c(part, seeds=seeds)
        seeds = cs.device_crc32c(part, seeds=seeds, device="cpu")
        assert seeds == ref
    whole = np.concatenate(parts, axis=1)
    assert seeds == [crc32c(cs.CRC_SEED, r.tobytes()) for r in whole]


def test_fold_matrices_are_shift_powers():
    """A fold of one partial is the identity; A^n composes."""
    assert np.array_equal(cs.fold_bitmatrix(1, 77), np.eye(32, dtype=np.uint8))
    a3 = cs.shift_power(3).astype(np.int64)
    a5 = cs.shift_power(5).astype(np.int64)
    assert np.array_equal((a3 @ a5) & 1, cs.shift_power(8))
    tbl = np.array(crc_mod.table(), np.uint32)
    r = np.uint32(0x12345678)
    step = (r >> np.uint32(8)) ^ tbl[r & np.uint32(0xFF)]
    bits = (r >> np.arange(32, dtype=np.uint32)) & 1
    got = (cs.shift_power(1).astype(np.int64) @ bits) & 1
    assert int((got.astype(np.uint32) << np.arange(32, dtype=np.uint32))
               .sum()) == int(step)


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
