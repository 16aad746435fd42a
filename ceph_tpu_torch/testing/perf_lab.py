"""Headline-kernel perf lab on the card (counterpart of
ceph_tpu/testing/perf_lab.py).

Experiments at the jax_rs headline (k=8 m=4, 4 KiB stripes, 16384-stripe
batch: (8, 2^21) int32 words, 64 MiB of data per call), each named and
keyed as in the JAX lab:

- ``roof_copy``      ``o = x ^ 1`` through the lab's copy kernel (L1,
                     ``roof_copy_xor``): the card's measured copy ceiling,
                     the denominator of every roofline share
- ``enc_base``       the production encode step (``encode_words_device``
                     under the "" variant: B1)
- ``enc_row_carry``  the same, the step's carry updating one whole row
- ``enc_cmp_expand`` / ``enc_u8_expand`` / ``enc_split2`` /
  ``enc_u8_split2``  the encode variants, through their kernels (B5a, B2,
                     B5b, B5c), each checked bit-identical to the
                     production kernel before it is timed
- ``clay_repair``    ``batched_clay_plane_repair_device`` at the CLAY
                     headline repair (k=8 m=4 d=11, lost chunk 3,
                     512 stripes x 64 KiB chunks)

Not ported yet: ``unpack_only`` (L2), ``roof_matmul`` (L3) and the
``enc_tile_<n>`` sweep, which needs a tile parameter the port's B1 does
not take.

Timing is on the card: CUDA events around back-to-back steps
(``benchmark.cuda_seconds_per_call``), not the JAX lab's serial-loop
differencing.  Each step does to its input, in place, what the JAX step
does to its carry, so the work per step is the same.  Knobs, as in the JAX
lab: ``PERF_LAB_STRIPES`` (a multiple of 64; the CLAY batch is 1/32 of it)
and ``PERF_LAB_BUDGET_S`` (``main``'s watchdog).  With ``device="cpu"``
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

# Launch counts of the lab's own kernel; only real launches count.
LAUNCHES = {"roof_copy_xor": 0}


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


def roof_copy_xor(words: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """L1: int32 ``words ^ 1``, any shape, contiguous.  Launches the copy
    kernel for a CUDA tensor; the plain version for a CPU tensor."""
    if words.dtype != torch.int32:
        raise TypeError(f"expected int32 words, got {words.dtype}")
    if words.device.type == "cpu":
        res = roof_copy_xor_plain(words)
        if out is None:
            return res
        out.copy_(res)
        return out
    if words.device.type != "cuda":
        raise ValueError(f"roof_copy_xor: no kernel for device "
                         f"{words.device}")
    if not words.is_contiguous():
        raise ValueError("roof_copy_xor: words must be contiguous")
    if out is None:
        out = torch.empty_like(words)
    if (out.shape != words.shape or out.dtype != torch.int32
            or out.device != words.device or not out.is_contiguous()):
        raise ValueError("roof_copy_xor: bad output tensor")
    fn = ck.c_entry(LAB_SOURCE, "roof_copy_xor",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_void_p])
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = fn(words.data_ptr(), out.data_ptr(), words.numel(), stream)
    ck.check_rc("roof_copy_xor", rc)
    LAUNCHES["roof_copy_xor"] += 1
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
    the first element of a contiguous input."""
    i = [0]

    def step(x):
        p = fn(x)
        i[0] += 1
        val = i[0] & 0xFF if x.dtype == torch.uint8 else i[0]
        torch.bitwise_xor(p.reshape(-1)[:1], val, out=x.view(-1)[:1])
    return step


def _check_and_time(step, x, expect: torch.Tensor, got: torch.Tensor,
                    nbytes: int) -> dict:
    """Bit-check an experiment's output, then time its step on the card.
    Off CUDA the check still runs (plain versions) and timing is skipped,
    as the JAX lab skips it off the TPU."""
    if not torch.equal(expect.to(got.device), got):
        raise AssertionError("experiment output != its reference")
    if x.device.type != "cuda":
        return {"bit_identical": True, "skipped_timing": "non-cuda device"}
    sec = benchmark.cuda_seconds_per_call(lambda: step(x))
    return {"sec": sec, "gibps": _gibps(nbytes, sec), "bit_identical": True}


# -- experiments -----------------------------------------------------------------

def exp_roof_copy(dev: torch.device) -> dict:
    """Pure device-memory copy at the headline's working-set size: read and
    write the whole (8, N4) buffer once, ``o = x ^ 1`` (L1)."""
    data, words = _data(dev)
    want = torch.from_numpy(data.view(np.int32) ^ 1)
    rec = _check_and_time(carry_step(roof_copy_xor), words, want,
                          roof_copy_xor(words), data.nbytes)
    if "sec" in rec:
        rec["traffic_gibps"] = _gibps(2 * data.nbytes, rec["sec"])
    return rec


def _production_parity(data: np.ndarray) -> torch.Tensor:
    """The numpy oracle's parity of the lab data, as (4, N4) int32."""
    from ceph_tpu_torch.ec.matrix import generator_matrix

    par = reference.encode(generator_matrix("reed_sol_van", K, M), data)[K:]
    return ck.bytes_to_words(torch.from_numpy(np.ascontiguousarray(par)))


def exp_enc_base(dev: torch.device) -> dict:
    """Production headline step: the codec's word entry under the ""
    variant (B1), the step's carry touching one word."""
    data, words = _data(dev)
    ec = _codec(dev)
    with _encode_variant(""):
        return _check_and_time(carry_step(ec.encode_words_device), words,
                               _production_parity(data),
                               ec.encode_words_device(words), data.nbytes)


def exp_enc_row_carry(dev: torch.device) -> dict:
    """The same step with the carry updating one whole row (row 0 ^=
    parity row 0): against enc_base, the cost of a row-sized carry."""
    data, words = _data(dev)
    ec = _codec(dev)

    def step(w):
        w[0].bitwise_xor_(ec.encode_words_device(w)[0])

    with _encode_variant(""):
        return _check_and_time(step, words, _production_parity(data),
                               ec.encode_words_device(words), data.nbytes)


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

        def fn(v):
            return wrapper(consts, v)
        return _check_and_time(carry_step(fn), x, expect, fn(x), data.nbytes)
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
    return _check_and_time(
        lambda x: batched_clay_plane_repair_device(ec, R, x), helper,
        chunks[:, CLAY_LOST], got, b * C)


EXPERIMENTS = {
    "roof_copy": exp_roof_copy,
    "enc_base": exp_enc_base,
    "enc_row_carry": exp_enc_row_carry,
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
