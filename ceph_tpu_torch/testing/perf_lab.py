"""Headline-kernel perf lab on the card (counterpart of
ceph_tpu/testing/perf_lab.py).

The JAX lab's 14 experiments at the jax_rs headline (k=8 m=4, 4 KiB
stripes, 16384-stripe batch: (8, 2^21) int32 words, 64 MiB of data per
call), each named and keyed as in the JAX lab, each through its own kernel:

- ``roof_copy``      ``o = x ^ 1`` through the lab's copy kernel (L1,
                     ``roof_copy_xor``): the card's measured copy ceiling,
                     the denominator of every roofline share
- ``roof_matmul``    the int8 contraction alone on already expanded bits
                     (L3, ``roof_matmul_s8``, mma.sync on the tensor cores):
                     bm32 (128, 256) x bits (256, N4/8) -> int32
- ``unpack_only``    bit expansion and repack with no contraction (L2,
                     ``unpack_repack_words``): int8 planes in shared memory
- ``enc_base``       the production encode step (``encode_words_device``
                     under the "" variant: B1)
- ``enc_row_carry``  the same, the step's carry updating one whole row
- ``enc_tile_<n>``   B1 at tile n = 2048, 4096, 8192, 16384 words per block
                     (``gf2_apply_words(..., tile=n)``)
- ``enc_cmp_expand`` / ``enc_u8_expand`` / ``enc_split2`` /
  ``enc_u8_split2``  the encode variants, through their kernels (B5a, B2,
                     B5b, B5c)
- ``clay_repair``    ``batched_clay_plane_repair_device`` at the CLAY
                     headline repair (k=8 m=4 d=11, lost chunk 3,
                     512 stripes x 64 KiB chunks)

Each experiment is checked bit-identical before it is timed: the encode
steps against the numpy oracle's parity, the variants against the
production kernel B1, ``unpack_only`` against its input, ``roof_matmul``
against the exact product (the plain version), ``clay_repair`` against the
lost chunk.  Timing is the JAX lab's: ``benchmark.device_seconds_per_iter``
runs serial steps on the device (captured into CUDA graphs) and
differences two step counts (64 and 320), so host costs cancel.  Each step
does to its input, in place, what the JAX step does to its carry, and
writes its kernel's output into a preallocated tensor.  Knobs, as in the
JAX lab: ``PERF_LAB_STRIPES`` (a multiple of 64; the CLAY batch is 1/32 of
it) and ``PERF_LAB_BUDGET_S`` (``main``'s watchdog).  With ``device="cpu"``
the experiments run through the plain versions, check bit identity and
skip timing; with no device they run on CUDA, or raise.  Every record
names its device, and on CUDA the nvidia-smi name and power limit.

    python -m ceph_tpu_torch.testing.perf_lab [names...]

prints one JSON line per experiment and writes no file.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ceph_tpu_torch.ec import benchmark
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec import reference

K, M = 8, 4
CHUNK = 512                      # bytes per chunk (4 KiB stripe / 8)
DEFAULT_STRIPES = 16384
CLAY_PROFILE = {"k": "8", "m": "4", "d": "11"}
CLAY_SC, CLAY_LOST = 1024, 3
LAB_SOURCE = "lab_copy"
BITS_SOURCE = "lab_bits"
TILES = (2048, 4096, 8192, 16384)   # the JAX lab's enc_tile_<n> sweep

# Launch counts of the lab's own kernels; only real launches count
# (cuda_kernels.count_launch).
LAUNCHES = {"roof_copy_xor": 0, "unpack_repack_words": 0,
            "roof_matmul_s8": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def stripes() -> int:
    """PERF_LAB_STRIPES, default 16384.  A multiple of 64, as the JAX lab
    requires (its tiles divide N4 = stripes * 128 words)."""
    n = int(os.environ.get("PERF_LAB_STRIPES", DEFAULT_STRIPES))
    if n <= 0 or n % 64:
        raise ValueError(f"PERF_LAB_STRIPES={n} must be a positive "
                         f"multiple of 64")
    return n


# -- L1: the copy roof ---------------------------------------------------------

def roof_copy_xor_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain version of roof_copy_xor: ``words ^ 1``."""
    return words ^ 1


# in, out, n, stream
COPY_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p]


def roof_copy_xor(words: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """L1: int32 ``words ^ 1``, any shape, contiguous.  Launches the copy
    kernel for a CUDA tensor; the plain version for a CPU tensor.

    Its time is the copy ceiling, read against a library call in an eager
    loop, so the enqueue is kept short: the raw current stream, and the
    device switched only when it is not already the current one."""
    if words.dtype != torch.int32:
        raise TypeError(f"expected int32 words, got {words.dtype}")
    dev = words.device
    if dev.type == "cpu":
        res = roof_copy_xor_plain(words)
        if out is None:
            return res
        out.copy_(res)
        return out
    if dev.type != "cuda":
        raise ValueError(f"roof_copy_xor: no kernel for device {dev}")
    if not words.is_contiguous():
        raise ValueError("roof_copy_xor: words must be contiguous")
    if out is None:
        out = torch.empty_like(words)
    if (out.shape != words.shape or out.dtype != torch.int32
            or out.device != dev or not out.is_contiguous()):
        raise ValueError("roof_copy_xor: bad output tensor")
    fn = ck.c_entry(LAB_SOURCE, "roof_copy_xor", COPY_ARGS)
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        rc = fn(words.data_ptr(), out.data_ptr(), words.numel(),
                torch._C._cuda_getCurrentRawStream(dev.index))
    ck.check_rc("roof_copy_xor", rc)
    ck.count_launch(LAUNCHES, "roof_copy_xor")
    return out


# -- L2: bit expansion and repack ---------------------------------------------

_PLAIN_COLS = 1 << 16   # columns per chunk: bounds the plain temporaries


def unpack_repack_words_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain version of unpack_repack_words, the TPU kernel's body
    (ceph_tpu/testing/perf_lab.py:190-193): ``bits = (d[:, None, :] >>
    shift) & 1``, a (rows, 32, n) int32 plane stack, then ``sum(bits <<
    shift, axis=1)``.  Bit 31 enters the sum as -2^31, so every partial sum
    stays in int32."""
    shifts = torch.arange(32, dtype=torch.int32,
                          device=words.device)[None, :, None]
    out = torch.empty_like(words)
    for s in range(0, words.shape[1], _PLAIN_COLS):
        d = words[:, s:s + _PLAIN_COLS]
        bits = (d[:, None, :] >> shifts) & 1
        out[:, s:s + d.shape[1]] = (bits << shifts).sum(dim=1,
                                                        dtype=torch.int32)
    return out


def unpack_repack_words(words: torch.Tensor,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """L2: (rows, n4) int32 -> the same words, expanded to int8 bit planes
    in shared memory and packed back.  Launches csrc/lab_bits.cu's kernel
    for a contiguous CUDA tensor; the plain version for a CPU tensor."""
    if words.dtype != torch.int32 or words.ndim != 2:
        raise TypeError(f"expected 2-D int32 words, got {words.dtype} "
                        f"{tuple(words.shape)}")
    if words.device.type == "cpu":
        res = unpack_repack_words_plain(words)
        if out is None:
            return res
        out.copy_(res)
        return out
    if words.device.type != "cuda":
        raise ValueError(f"unpack_repack_words: no kernel for device "
                         f"{words.device}")
    if not words.is_contiguous():
        raise ValueError("unpack_repack_words: words must be contiguous")
    if out is None:
        out = torch.empty_like(words)
    if (out.shape != words.shape or out.dtype != torch.int32
            or out.device != words.device or not out.is_contiguous()):
        raise ValueError("unpack_repack_words: bad output tensor")
    fn = ck.c_entry(BITS_SOURCE, "unpack_repack_words",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = fn(words.data_ptr(), out.data_ptr(), words.shape[0],
                words.shape[1], stream)
    ck.check_rc("unpack_repack_words", rc)
    ck.count_launch(LAUNCHES, "unpack_repack_words")
    return out


# -- L3: the int8 contraction alone ---------------------------------------------

MM_ROWS, MM_DEPTH = M * 32, K * 32     # bm32 is (128, 256)


def lab_bm32() -> np.ndarray:
    """The JAX lab's bm32 (perf_lab.py:227-229): the lane-expanded GF(2)
    bitmatrix of reed_sol_van k=8 m=4's parity rows, (128, 256) int8."""
    from ceph_tpu_torch.ec import bitmatrix
    from ceph_tpu_torch.ec.matrix import generator_matrix

    return bitmatrix.expand_bitmatrix_lanes(bitmatrix.gf_matrix_to_bitmatrix(
        generator_matrix("reed_sol_van", K, M)[K:])).astype(np.int8)


def roof_matmul_s8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of roof_matmul_s8: the exact integer product of (m, k)
    and (k, n) int8 as (m, n) int32, the TPU kernel's ``jnp.dot(...,
    preferred_element_type=int32)`` (perf_lab.py:236-237).  Contracted in
    float64: every product and partial sum is an integer of magnitude at
    most k * 128 * 128 < 2^53, so it is exact."""
    af = a.to(torch.float64)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=b.device)
    for s in range(0, b.shape[1], _PLAIN_COLS):
        bs = b[:, s:s + _PLAIN_COLS]
        out[:, s:s + bs.shape[1]] = (af @ bs.to(torch.float64)).to(
            torch.int32)
    return out


def roof_matmul_s8(a: torch.Tensor, b: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """L3: C = A . B for A (128, 256) int8 row-major and B (256, n) int8
    with n contiguous, any n, as (128, n) int32.  Launches csrc/
    lab_bits.cu's mma.sync kernel for contiguous CUDA tensors; the plain
    version for CPU tensors."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or b.ndim != 2:
        raise TypeError(f"expected int8 A and 2-D int8 B, got {a.dtype}, "
                        f"{b.dtype} {tuple(b.shape)}")
    if tuple(a.shape) != (MM_ROWS, MM_DEPTH) or b.shape[0] != MM_DEPTH:
        raise ValueError(f"roof_matmul_s8 takes A ({MM_ROWS}, {MM_DEPTH}) "
                         f"and B ({MM_DEPTH}, n), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    shape = (MM_ROWS, b.shape[1])
    if b.device.type == "cpu" and a.device.type == "cpu":
        res = roof_matmul_s8_plain(a, b)
        if out is None:
            return res
        out.copy_(res)
        return out
    if b.device.type != "cuda" or a.device != b.device:
        raise ValueError(f"roof_matmul_s8: no kernel for devices "
                         f"{a.device}, {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("roof_matmul_s8: A and B must be contiguous")
    if a.data_ptr() % 16:
        raise ValueError("roof_matmul_s8: A must be 16-byte aligned")
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=b.device)
    if (tuple(out.shape) != shape or out.dtype != torch.int32
            or out.device != b.device or not out.is_contiguous()):
        raise ValueError("roof_matmul_s8: bad output tensor")
    fn = ck.c_entry(BITS_SOURCE, "roof_matmul_s8",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), b.shape[1],
                stream)
    ck.check_rc("roof_matmul_s8", rc)
    ck.count_launch(LAUNCHES, "roof_matmul_s8")
    return out


# -- the card ------------------------------------------------------------------

def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device; raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the perf lab runs on a CUDA device; pass "
                               "device='cpu' for the bit-identity checks")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def device_record(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"device": str(dev)}
    return {"device": torch.cuda.get_device_name(dev),
            "nvidia_smi": nvidia_smi_line()}


# -- shared set-up -------------------------------------------------------------

def _data(dev: torch.device) -> tuple[np.ndarray, torch.Tensor]:
    """The (8, stripes*512) data streams from seed 0, as numpy and as
    (8, N4) int32 words on ``dev``."""
    data = np.random.default_rng(0).integers(
        0, 256, (K, stripes() * CHUNK), np.uint8)
    return data, ck.bytes_to_words(torch.from_numpy(data).to(dev))


def _codec(dev: torch.device):
    return benchmark.make_codec(
        "jax_rs", ["k=8", "m=4", "technique=reed_sol_van"], dev)


def _gibps(nbytes: int, sec: float) -> float:
    return nbytes / sec / 2**30


@contextlib.contextmanager
def _encode_variant(name: str):
    prev = ck.get_encode_variant()
    ck.set_encode_variant(name)
    try:
        yield
    finally:
        ck.set_encode_variant(prev)


def carry_step(fn):
    """The JAX lab's step ``w.at[0, 0].set(fn(w)[0, 0] ^ i)``, in place on
    the first element of a contiguous input (cast to its type, as the JAX
    step's ``astype``)."""
    i = [0]

    def step(x):
        p = fn(x)
        i[0] += 1
        val = i[0] & 0xFF if x.dtype == torch.uint8 else i[0]
        torch.bitwise_xor(p.reshape(-1)[:1], val, out=x.view(-1)[:1])
    return step


def _check_and_time(step, x, expect: torch.Tensor, got: torch.Tensor,
                    nbytes: int) -> dict:
    """Bit-check an experiment's output, then time its step on the card
    with the device loop (``benchmark.device_seconds_per_iter``, 64 and 320
    steps, as the JAX lab).  Off CUDA the check still runs (plain versions)
    and timing is skipped, as the JAX lab skips it off the TPU."""
    if not torch.equal(expect.to(got.device), got):
        raise AssertionError("experiment output != its reference")
    if x.device.type != "cuda":
        return {"bit_identical": True, "skipped_timing": "non-cuda device"}
    sec = benchmark.device_seconds_per_iter(step, x, lo=64, hi=320)
    return {"sec": sec, "gibps": _gibps(nbytes, sec), "bit_identical": True}


# -- experiments -----------------------------------------------------------------

def exp_roof_copy(dev: torch.device) -> dict:
    """Pure device-memory copy at the headline's working-set size: read and
    write the whole (8, N4) buffer once, ``o = x ^ 1`` (L1)."""
    data, words = _data(dev)
    want = torch.from_numpy(data.view(np.int32) ^ 1)
    out = torch.empty_like(words)
    rec = _check_and_time(
        carry_step(lambda w: roof_copy_xor(w, out=out)), words, want,
        roof_copy_xor(words), data.nbytes)
    if "sec" in rec:
        rec["traffic_gibps"] = _gibps(2 * data.nbytes, rec["sec"])
    return rec


def exp_unpack_only(dev: torch.device) -> dict:
    """Bit expansion and repack with no contraction (L2): the expansion
    half of the int8 formulation alone.  The output must equal the
    input."""
    data, words = _data(dev)
    out = torch.empty_like(words)
    return _check_and_time(
        carry_step(lambda w: unpack_repack_words(w, out=out)), words,
        words.clone(), unpack_repack_words(words), data.nbytes)


def exp_roof_matmul(dev: torch.device) -> dict:
    """The int8 contraction on already expanded bits (L3), the JAX lab's
    shapes: bm32 (128, 256) x bits (256, N4/8) in {0, 1} (seed 1) ->
    (128, N4/8) int32, checked against the exact product.  ``data_gibps``
    counts the data bytes the bits stand for, as the JAX lab does."""
    n4 = stripes() * CHUNK // 4 // 8   # bits are 8x the data: N4/8 columns
    a = torch.from_numpy(lab_bm32()).to(dev)
    bits = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (MM_DEPTH, n4), np.int8)).to(dev)
    out = torch.empty((MM_ROWS, n4), dtype=torch.int32, device=dev)
    rec = _check_and_time(
        carry_step(lambda b: roof_matmul_s8(a, b, out=out)), bits,
        roof_matmul_s8_plain(a, bits), roof_matmul_s8(a, bits), K * n4 * 4)
    if "sec" in rec:
        rec["data_gibps"] = rec.pop("gibps")
        rec["macs_per_sec"] = MM_ROWS * MM_DEPTH * n4 / rec["sec"]
    return rec


def _production_parity(data: np.ndarray) -> torch.Tensor:
    """The numpy oracle's parity of the lab data, as (4, N4) int32."""
    from ceph_tpu_torch.ec.matrix import generator_matrix

    par = reference.encode(generator_matrix("reed_sol_van", K, M), data)[K:]
    return ck.bytes_to_words(torch.from_numpy(np.ascontiguousarray(par)))


def _parity_out(words: torch.Tensor) -> torch.Tensor:
    return torch.empty((M, words.shape[1]), dtype=torch.int32,
                       device=words.device)


def exp_enc_base(dev: torch.device) -> dict:
    """Production headline step: the codec's word entry under the ""
    variant (B1), the step's carry touching one word."""
    data, words = _data(dev)
    ec = _codec(dev)
    out = _parity_out(words)
    with _encode_variant(""):
        return _check_and_time(
            carry_step(lambda w: ec.encode_words_device(w, out=out)), words,
            _production_parity(data), ec.encode_words_device(words),
            data.nbytes)


def exp_enc_row_carry(dev: torch.device) -> dict:
    """The same step with the carry updating one whole row (row 0 ^=
    parity row 0): against enc_base, the cost of a row-sized carry."""
    data, words = _data(dev)
    ec = _codec(dev)
    out = _parity_out(words)

    def step(w):
        w[0].bitwise_xor_(ec.encode_words_device(w, out=out)[0])

    with _encode_variant(""):
        return _check_and_time(step, words, _production_parity(data),
                               ec.encode_words_device(words), data.nbytes)


def _tile_exp(tile: int):
    """enc_tile_<tile>: B1 launched at ``tile`` words of each row per
    block, the JAX lab's ``_pallas_apply_words(..., tile=tile)`` step."""
    def run(dev: torch.device) -> dict:
        data, words = _data(dev)
        consts = ck.ShardApply(_codec(dev).generator[K:]).consts
        out = _parity_out(words)
        rec = _check_and_time(
            carry_step(lambda w: ck.gf2_apply_words(consts, w, out=out,
                                                    tile=tile)),
            words, _production_parity(data),
            ck.gf2_apply_words(consts, words, tile=tile), data.nbytes)
        rec["tile"] = tile
        return rec
    return run


def _variant_exp(wrapper, on_bytes: bool):
    """A variant experiment: its kernel's wrapper on the lab data (words,
    or their bytes for a u8 variant), checked against the production
    kernel B1 on the same data, then timed."""
    def run(dev: torch.device) -> dict:
        data, words = _data(dev)
        consts = ck.ShardApply(_codec(dev).generator[K:]).consts
        expect = ck.gf2_apply_words(consts, words)
        x = ck.words_to_bytes(words) if on_bytes else words
        if on_bytes:
            expect = ck.words_to_bytes(expect)
        out = torch.empty_like(expect)
        return _check_and_time(
            carry_step(lambda v: wrapper(consts, v, out=out)), x, expect,
            wrapper(consts, x), data.nbytes)
    return run


def exp_clay_repair(dev: torch.device) -> dict:
    """CLAY k=8 m=4 d=11 repair of chunk 3 through
    ``batched_clay_plane_repair_device`` (one grouped-kernel launch) over
    PERF_LAB_STRIPES/32 stripes of 64 KiB chunks: 512 at the default, the
    JAX bench's cfg4 batch.  ``gibps`` is recovered chunk data."""
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ec.repair_operator import clay_repair_operator
    from ceph_tpu_torch.parallel.clay_sharding import (
        batched_clay_plane_repair_device,
    )

    ec = ErasureCodePluginRegistry().factory("clay", CLAY_PROFILE,
                                             device=dev)
    b = stripes() // 32
    C = ec.sub_chunk_no * CLAY_SC
    data = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (b, ec.k, C), np.uint8)).to(dev)
    chunks = ec.encode_chunks_device(data)
    R, helpers, planes = clay_repair_operator(ec, CLAY_LOST)
    helper = torch.stack([
        chunks[:, h].reshape(b, ec.sub_chunk_no, CLAY_SC)[:, planes]
        for h in helpers], dim=1).reshape(b, -1, CLAY_SC)
    got = batched_clay_plane_repair_device(ec, R, helper)
    out = torch.empty_like(got)
    return _check_and_time(
        carry_step(lambda x: batched_clay_plane_repair_device(ec, R, x,
                                                              out=out)),
        helper, chunks[:, CLAY_LOST], got, b * C)


EXPERIMENTS = {
    "roof_copy": exp_roof_copy,
    "roof_matmul": exp_roof_matmul,
    "unpack_only": exp_unpack_only,
    "enc_base": exp_enc_base,
    "enc_row_carry": exp_enc_row_carry,
    **{f"enc_tile_{t}": _tile_exp(t) for t in TILES},
    "enc_cmp_expand": _variant_exp(ck.gf2_apply_words_cmp, on_bytes=False),
    "enc_u8_expand": _variant_exp(ck.gf2_apply_u8, on_bytes=True),
    "enc_split2": _variant_exp(ck.gf2_apply_words_split2, on_bytes=False),
    "enc_u8_split2": _variant_exp(ck.gf2_apply_u8_split2, on_bytes=True),
    "clay_repair": exp_clay_repair,
}


def run_experiment(name: str, device=None) -> dict:
    """One experiment's record; raises on an unknown name, a failed check
    or a failed launch."""
    fn = EXPERIMENTS.get(name)
    if fn is None:
        raise KeyError(f"unknown experiment {name!r}; one of "
                       f"{sorted(EXPERIMENTS)}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    result = fn(dev)
    result["wall"] = round(time.perf_counter() - t0, 2)
    return {"exp": name, **result, **device_record(dev),
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}


def main(argv=None) -> int:
    """Run the named experiments (all by default) on CUDA, one JSON line
    each; an experiment that fails prints its error and the rest go on.
    Returns 1 if any failed.  The PERF_LAB_BUDGET_S watchdog (default
    1500 s) ends the process with status 3."""
    names = (argv if argv is not None else sys.argv[1:]) or list(EXPERIMENTS)
    budget = float(os.environ.get("PERF_LAB_BUDGET_S", 1500))
    done = threading.Event()

    def watchdog():
        if not done.wait(budget):
            print(json.dumps({"error": f"budget {budget:.0f}s hit"}),
                  flush=True)
            os._exit(3)

    threading.Thread(target=watchdog, daemon=True).start()
    failed = False
    for name in names:
        try:
            rec = run_experiment(name)
        except Exception as e:      # noqa: BLE001 — record and go on
            failed = True
            rec = {"exp": name, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rec), flush=True)
    done.set()
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
