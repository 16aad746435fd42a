#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's erasure-code data path on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit.  It imports ``ceph_tpu_torch`` (never JAX, never ceph_tpu)
and, phase by phase, raising on any failure:

1. builds the CUDA kernels from ``ceph_tpu_torch/csrc`` (nvcc, all sources
   at once) and prints the build seconds and ptxas's register report;
2. prints the card (torch's name, nvidia-smi's name and power limit);
3. holds each kernel against its plain PyTorch version on the card, exact
   (``torch.equal``), at the headline k=8 m=4 encode, a 4-erasure decode
   matrix, a ragged length and the w=16 / w=32 packet matrices;
4. runs the main path with every launch count set to 0: the corpus check
   (every jax_rs / xor archive bit-identical, under both encode variants),
   the exhaustive k=8 m=4 erasure sweep (793 patterns), a 64 MiB object
   split into 16384 stripes, encoded, 4 shards dropped, decoded and merged
   back bit-identical, and the headline encode / 4-erasure decode through
   the word entries; then reads the counts, and fails if a kernel was not
   launched;
5. times each kernel and its plain version at the headline geometry
   (16384 stripes x 4 KiB, k=8 m=4, 64 MiB of data per launch) with CUDA
   events, beside the HBM / int8 bound;
6. prints the ``kernels`` JSON line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero and prints no result without CUDA, or when the package is
not beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 rate and
# int8 tensor-core rate.  A bound is the larger of bytes / rate and
# operations / rate.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

K, M = 8, 4
CHUNK = 512                  # 4 KiB stripes of 8 chunks
STRIPES = 16384              # 64 MiB of data per launch
HEADLINE_LOST = [0, 1, 2, 3]  # the JAX benchmark's --erasures 4 choice
OBJECT_LOST = [1, 4, 8, 10]   # two data shards, one parity, one data
SEED = 20261016


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from ceph_tpu_torch.common import cuda_build
        from ceph_tpu_torch.ec import benchmark, corpus
        from ceph_tpu_torch.ec import cuda_kernels as ck
        from ceph_tpu_torch.ec.bitmatrix import gf_matrix_to_bitmatrix
        from ceph_tpu_torch.ec.plugins.jax_rs import ErasureCodeJaxRS
        from ceph_tpu_torch.osd.ec_util import StripeInfo
    except ImportError as e:
        print(f"chip_smoke: the ceph_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(SEED)

    def rand_u8(shape) -> torch.Tensor:
        return torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    secs = cuda_build.build(cuda_build.SOURCES)
    log(f"[build] {secs} wall {time.perf_counter() - t0:.2f}s")
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 2. the card -------------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] torch: {kind}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 3. kernels vs plain versions ----------------------------------------
    ec = ErasureCodeJaxRS({"k": str(K), "m": str(M)}, device=dev)
    gen = ec.generator
    dec = ec.decode_selection(
        [i for i in range(K + M) if i not in HEADLINE_LOST],
        HEADLINE_LOST)[1]
    w16 = ErasureCodeJaxRS({"k": "5", "m": "3", "technique": "reed_sol_van",
                            "w": "16"}, device=dev)
    w32 = ErasureCodeJaxRS({"k": "4", "m": "2", "technique": "reed_sol_van",
                            "w": "32"}, device=dev)
    packet16 = w16.full_bm[5 * 16:]                    # (48, 80) 0/1
    packet32 = w32.full_bm[4 * 32:]                    # (64, 128) 0/1
    n_bytes = STRIPES * CHUNK                          # per shard row
    cases = [
        # (label, coefficient matrix, words shape, bytes shape)
        ("headline encode k=8 m=4", gen[K:], (K, n_bytes // 4), (K, n_bytes)),
        ("decode 4 erasures", dec, (K, n_bytes // 4), (K, n_bytes)),
        ("ragged length", gen[K:], (K, 1_000_003), (K, 1_000_003)),
        ("w=16 packets", packet16, (80, 65_536), (4096, 80, 256)),
        ("w=32 packets", packet32, (128, 65_536), (1024, 128, 4096 // 32)),
    ]
    errs = {"gf2_apply_words": 0, "gf2_apply_u8": 0}
    for label, coeff, wshape, bshape in cases:
        ap = ck.ShardApply(coeff)
        consts = ap.consts
        words = ck.bytes_to_words(rand_u8(wshape[:-1] + (wshape[-1] * 4,)))
        got = ck.gf2_apply_words(consts, words)
        ref = ck.gf2_apply_words_plain(consts.plain_bm32(dev), words)
        torch.cuda.synchronize()
        err_w = int((got.long() - ref.long()).abs().max())
        data = rand_u8(bshape)
        got8 = ck.gf2_apply_u8(consts, data)
        ref8 = ck.gf2_apply_u8_plain(consts.plain_bm(dev), data)
        torch.cuda.synchronize()
        err_b = int((got8.int() - ref8.int()).abs().max())
        ok = torch.equal(got, ref) and torch.equal(got8, ref8)
        log(f"[exact] {label}: coeff {coeff.shape} words {tuple(wshape)} "
            f"bytes {tuple(bshape)} -> equal={ok}")
        if not ok:
            raise AssertionError(f"kernel != plain version at {label}")
        errs["gf2_apply_words"] = max(errs["gf2_apply_words"], err_w)
        errs["gf2_apply_u8"] = max(errs["gf2_apply_u8"], err_b)

    # -- 4. the main path, counted -------------------------------------------
    ck.reset_launch_counts()

    def counts() -> dict:
        return dict(ck.LAUNCHES)

    for variant in ("", "auto"):
        ck.set_encode_variant(variant)
        before = counts()
        failures = corpus.check(device=dev)
        ported, other = corpus.archives()
        after = counts()
        log(f"[corpus] variant {ck.get_encode_variant()!r}: "
            f"{len(ported)} archives, failures {failures}, launches "
            f"{ {n: after[n] - before[n] for n in after} }")
        if failures or len(ported) != 13:
            raise AssertionError(f"corpus check failed: {failures}")
    for path in other:
        log(f"[corpus] {path.name}: not in this slice (plugin not ported)")

    ck.set_encode_variant("")
    before = counts()
    t0 = time.perf_counter()
    combos = benchmark.verify_all_erasures(ec)
    log(f"[sweep] k=8 m=4 reed_sol_van: {combos} erasure patterns decoded "
        f"in {time.perf_counter() - t0:.1f}s, launches "
        f"{ {n: counts()[n] - before[n] for n in before} }")
    if combos != 793:
        raise AssertionError(f"expected 793 patterns, checked {combos}")

    # The object path under "auto", as an OSD selects it on the card.
    ck.set_encode_variant("auto")
    before = counts()
    info = StripeInfo(k=K, chunk_size=CHUNK)
    obj = rand_u8((64 << 20,))
    chunks = ec.encode_chunks_device(info.split_stripes(obj))
    avail = {i: chunks[:, i] for i in range(K + M) if i not in OBJECT_LOST}
    lost_data = [i for i in OBJECT_LOST if i < K]
    rebuilt = ec.decode_chunks_device(avail, lost_data)
    stripes = chunks[:, :K].clone()
    for j, i in enumerate(lost_data):
        stripes[:, i] = rebuilt[:, j]
    back = info.merge_stripes(stripes)
    torch.cuda.synchronize()
    if not torch.equal(back, obj):
        raise AssertionError("64 MiB object did not round-trip")
    parity_ok = torch.equal(
        ec.decode_chunks_device(avail, [10])[:, 0], chunks[:, 10])
    if not parity_ok:
        raise AssertionError("rebuilt parity shard differs")
    log(f"[object] 64 MiB, {chunks.shape[0]} stripes x {K}+{M} x {CHUNK} B, "
        f"lost {OBJECT_LOST}: bit-identical; launches "
        f"{ {n: counts()[n] - before[n] for n in before} }")

    # The headline word entries once each (the benchmark's path).
    ck.set_encode_variant("")
    data = rng.integers(0, 256, (STRIPES, K, CHUNK), dtype=np.uint8)
    words = benchmark.shard_words(ec, data)
    parity = ec.encode_words_device(words)
    full = torch.cat([words, parity], dim=0)
    surv = [i for i in range(K + M) if i not in HEADLINE_LOST][:K]
    rec = ec.decode_words_device({a: full[a] for a in surv}, HEADLINE_LOST)
    torch.cuda.synchronize()
    if not torch.equal(rec, full[HEADLINE_LOST]):
        raise AssertionError("headline words decode differs")
    main_launches = counts()
    log(f"[main path] launches {main_launches}")
    for name, n in main_launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")

    # -- 5. timing at the headline geometry ----------------------------------
    data_bytes = K * n_bytes
    par_bytes = M * n_bytes
    bm = gf_matrix_to_bitmatrix(gen[K:])
    table_bytes = 4 * 8 * M * K
    bound_bytes_s = (data_bytes + par_bytes + table_bytes) / HBM_BYTES_PER_S
    # the per-byte bit-plane contraction: (8m x 8k) 0/1 matrix x 8k bits per
    # byte column, on int8 tensor cores
    ops = 2 * bm.shape[0] * bm.shape[1] * n_bytes
    bound_ops_s = ops / INT8_OPS_PER_S
    bound_s = max(bound_bytes_s, bound_ops_s)
    bound_by = "bytes" if bound_bytes_s >= bound_ops_s else "operations"
    log(f"[bound] {data_bytes} B in + {par_bytes} B out + {table_bytes} B "
        f"table at {HBM_BYTES_PER_S:.3g} B/s = {bound_bytes_s * 1e6:.2f} us; "
        f"{ops} int8 ops at {INT8_OPS_PER_S:.4g}/s = "
        f"{bound_ops_s * 1e6:.2f} us -> bound {bound_s * 1e6:.2f} us "
        f"({bound_by})")

    enc_ap = ck.ShardApply(gen[K:])
    dec_ap = ck.ShardApply(dec)
    stream = ck.words_to_bytes(words)        # (k, N) bytes view
    dec_words = full[surv]
    dec_stream = ck.words_to_bytes(dec_words)

    def time_it(fn, iterations=20, runs=5):
        return benchmark.cuda_seconds_per_call(fn, iterations, runs)

    rows = [
        ("gf2_apply_words", "encode words", lambda: enc_ap.apply_words(words),
         lambda: ck.gf2_apply_words_plain(enc_ap.consts.plain_bm32(dev),
                                          words)),
        ("gf2_apply_words", "decode 4 erasures words",
         lambda: dec_ap.apply_words(dec_words),
         lambda: ck.gf2_apply_words_plain(dec_ap.consts.plain_bm32(dev),
                                          dec_words)),
        ("gf2_apply_u8", "encode bytes (auto)",
         lambda: ck.gf2_apply_u8(enc_ap.consts, stream),
         lambda: ck.gf2_apply_u8_plain(enc_ap.consts.plain_bm(dev), stream)),
        ("gf2_apply_u8", "decode 4 erasures bytes",
         lambda: ck.gf2_apply_u8(dec_ap.consts, dec_stream),
         lambda: ck.gf2_apply_u8_plain(dec_ap.consts.plain_bm(dev),
                                       dec_stream)),
    ]
    times = {}
    for name, label, kern, plain in rows:
        plain_s = time_it(plain, iterations=2, runs=3)
        kern_s = time_it(kern)
        kern_s2 = time_it(kern)
        plain_s2 = time_it(plain, iterations=2, runs=3)
        k_s, p_s = min(kern_s, kern_s2), min(plain_s, plain_s2)
        times.setdefault(name, (k_s, p_s))
        log(f"[time] {name} {label}: {k_s * 1e6:.2f} us "
            f"({data_bytes / k_s / 2**30:.2f} GiB/s of data; runs "
            f"{kern_s * 1e6:.2f}, {kern_s2 * 1e6:.2f} us), "
            f"bound {bound_s * 1e6:.2f} us = {100 * bound_s / k_s:.1f}% of "
            f"bound; plain {p_s * 1e3:.3f} ms; main-path launches "
            f"{main_launches[name]}")
    # End to end through the codec entries (allocation included).
    entries = [
        ("", "encode_words_device", lambda: ec.encode_words_device(words)),
        ("", "decode_words_device", lambda: ec.decode_words_device(
            {a: full[a] for a in surv}, HEADLINE_LOST)),
        ("auto", "encode_shards_device",
         lambda: ec.encode_shards_device(stream)),
    ]
    for variant, label, fn in entries:
        ck.set_encode_variant(variant)
        s = time_it(fn)
        log(f"[time] entry {label} (variant {ck.get_encode_variant()!r}): "
            f"{s * 1e6:.2f} us, {data_bytes / s / 2**30:.2f} GiB/s of data")
    ck.set_encode_variant("")

    # -- 6. result lines ------------------------------------------------------
    replaces = {"gf2_apply_words": "ceph_tpu/ec/pallas_kernels.py:96",
                "gf2_apply_u8": "ceph_tpu/ec/pallas_kernels.py:199"}
    kernels = []
    for name in ("gf2_apply_words", "gf2_apply_u8"):
        k_s, p_s = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ceph_tpu_torch/csrc/gf2_apply.cu",
            "replaces": replaces[name],
            "launches": main_launches[name],
            "exact": True,          # phase 3 raised on any difference
            "max_abs_err": errs[name],
            "ms": k_s * 1e3, "plain_ms": p_s * 1e3,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
