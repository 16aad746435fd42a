"""Builds of the split2 kernels (B5b, B5c) on the card, side by side.

    python -m ceph_tpu_torch.testing.split2_builds [build ...]

The split2 kernels are ``csrc/gf2_io.cuh``'s field-table kernel with two
units per thread.  Each build here is the committed ``csrc/`` with the
named text edits of ``BUILDS`` applied to a copy, compiled as
``cuda_build`` compiles (nvcc, the same flags) into
``_build/split2_builds/<build>/``; ``kept`` is the committed source.  For
each build it prints one JSON line: ptxas's registers and spills and the
SASS row loop of both kernels (``sass.row_loop``), each kernel checked
equal to its plain version at the jax_rs headline (k=8 m=4, 16384 stripes
x 4 KiB: (8, 2^21) words and (8, 8 MiB) byte streams), and its time:
CUDA events around 20 launches, median of 5, the best over ``ROUNDS``
rounds of one interleaved loop that times B1 and B2 (the committed
library) and every build's two kernels, forward then backward.  Needs a
card and the CUDA toolkit; writes nothing outside ``_build/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ceph_tpu_torch.common import cuda_build
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.ec.matrix import generator_matrix
from ceph_tpu_torch.testing import builds, perf_lab, sass

K, M = 8, 4
N_BYTES = 16384 * 512          # one shard row of the headline batch
ROUNDS = 3
FIELD_LOOP_PRMT = 48           # 3 prmt x 4 words x 4 output rows per row
BUILD_DIR = cuda_build.BUILD_DIR / "split2_builds"

# The committed row loop of the two units (gf2_io.cuh apply_chunk_units):
# both units' next rows loaded at the top of the iteration, then both
# applied.
_LOOP = """\
  uint32_t next[H][VEC];
#pragma unroll
  for (int h = 0; h < H; ++h) load_row<P>(u[h], row(0), next[h]);
#pragma unroll 1
  for (int cc = 0; cc < kc; ++cc) {
    uint32_t w[H][VEC];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int v = 0; v < VEC; ++v) w[h][v] = next[h][v];
    if (cc + 1 < kc)
#pragma unroll
      for (int h = 0; h < H; ++h) load_row<P>(u[h], row(cc + 1), next[h]);
#pragma unroll
    for (int h = 0; h < H; ++h)
      apply_fields(w[h], s_t01 + cc * FIELD_ROWS, s_t2[cc], acc[h]);
  }
"""
# Each unit's next row loaded right after its current row is taken, the
# units one after the other.
_LOOP_PER_UNIT = """\
  uint32_t next[H][VEC];
#pragma unroll
  for (int h = 0; h < H; ++h) load_row<P>(u[h], row(0), next[h]);
#pragma unroll 1
  for (int cc = 0; cc < kc; ++cc) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      uint32_t w[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) w[v] = next[h][v];
      if (cc + 1 < kc) load_row<P>(u[h], row(cc + 1), next[h]);
      apply_fields(w, s_t01 + cc * FIELD_ROWS, s_t2[cc], acc[h]);
    }
  }
"""
# Two rows per iteration, the prefetch registers ping-ponged (B2's
# apply_chunk_pairs for two units).
_LOOP_ROWS2 = """\
  uint32_t x[H][VEC], y[H][VEC];
#pragma unroll
  for (int h = 0; h < H; ++h) load_row<P>(u[h], row(0), x[h]);
  int cc = 0;
#pragma unroll 1
  for (; cc + 1 < kc; cc += 2) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      load_row<P>(u[h], row(cc + 1), y[h]);
      apply_fields(x[h], s_t01 + cc * FIELD_ROWS, s_t2[cc], acc[h]);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (cc + 2 < kc) load_row<P>(u[h], row(cc + 2), x[h]);
      apply_fields(y[h], s_t01 + (cc + 1) * FIELD_ROWS, s_t2[cc + 1],
                   acc[h]);
    }
  }
  if (cc < kc)
#pragma unroll
    for (int h = 0; h < H; ++h)
      apply_fields(x[h], s_t01 + cc * FIELD_ROWS, s_t2[cc], acc[h]);
"""
# Two rows in flight per unit: each unit's row cc+2 is loaded when row cc
# is taken.
_LOOP_DEPTH2 = """\
  uint32_t n1[H][VEC], n2[H][VEC];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    load_row<P>(u[h], row(0), n1[h]);
    if (kc > 1) load_row<P>(u[h], row(1), n2[h]);
  }
#pragma unroll 1
  for (int cc = 0; cc < kc; ++cc) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      uint32_t w[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        w[v] = n1[h][v];
        n1[h][v] = n2[h][v];
      }
      if (cc + 2 < kc) load_row<P>(u[h], row(cc + 2), n2[h]);
      apply_fields(w, s_t01 + cc * FIELD_ROWS, s_t2[cc], acc[h]);
    }
  }
"""
# Two rows in flight per unit, both units' loads at the top.
_LOOP_DEPTH2_FIRST = """\
  uint32_t n1[H][VEC], n2[H][VEC];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    load_row<P>(u[h], row(0), n1[h]);
    if (kc > 1) load_row<P>(u[h], row(1), n2[h]);
  }
#pragma unroll 1
  for (int cc = 0; cc < kc; ++cc) {
    uint32_t w[H][VEC];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        w[h][v] = n1[h][v];
        n1[h][v] = n2[h][v];
      }
    if (cc + 2 < kc)
#pragma unroll
      for (int h = 0; h < H; ++h) load_row<P>(u[h], row(cc + 2), n2[h]);
#pragma unroll
    for (int h = 0; h < H; ++h)
      apply_fields(w[h], s_t01 + cc * FIELD_ROWS, s_t2[cc], acc[h]);
  }
"""
_BOUNDS = ("__launch_bounds__(FIELD_THREADS)\ngf2_words_kernel",
           "__launch_bounds__(FIELD_THREADS, HALVES == 2 ? 3 : 1)\n"
           "gf2_words_kernel")

# build -> [(file in csrc/, old text, new text)], each old text present once
BUILDS = {
    "kept": [],
    "per_unit": [("gf2_io.cuh", _LOOP, _LOOP_PER_UNIT)],
    "rows2": [("gf2_io.cuh", _LOOP, _LOOP_ROWS2)],
    "depth2": [("gf2_io.cuh", _LOOP, _LOOP_DEPTH2)],
    "depth2_first": [("gf2_io.cuh", _LOOP, _LOOP_DEPTH2_FIRST)],
    "bounds3": [("gf2_io.cuh", *_BOUNDS)],
    "rows2_bounds3": [("gf2_io.cuh", _LOOP, _LOOP_ROWS2),
                      ("gf2_io.cuh", *_BOUNDS)],
    # blocks of 128 threads, at most 96 registers: 5 blocks (20 warps) per
    # SM against 2 of 256 (16 warps)
    "threads128_bounds5": [
        ("gf2_io.cuh", "constexpr int FIELD_THREADS = 256;",
         "constexpr int FIELD_THREADS = 128;"),
        ("gf2_io.cuh", _BOUNDS[0],
         "__launch_bounds__(FIELD_THREADS, HALVES == 2 ? 5 : 1)\n"
         "gf2_words_kernel")],
    # B5b with B5c's choice: an interior-only loop when both units are vec
    "words_interior": [("gf2_variants.cu",
                        "launch_fields<WordIO, false, false, 2>",
                        "launch_fields<WordIO, false, true, 2>")],
}


def sources(build: str) -> dict[str, str]:
    """csrc file name -> text of ``build``; raises if an edit's old text is
    not in its file exactly once."""
    return builds.sources(BUILDS[build], build)


def kernel_report(lib: str, log: str) -> dict:
    """Registers, spills and SASS row loop of the two split2 kernels."""
    dump = subprocess.run([sass.cuobjdump_path(), "-sass", lib],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    report = {}
    for label, view in (("B5b", "WordIO"), ("B5c", "ByteIO")):
        name, regs = builds.one_kernel(
            log, label, lambda n: "gf2_words_kernel" in n and view in n)
        loop = sass.row_loop(sass.loops(dump)[name], 2 * FIELD_LOOP_PRMT)
        length, ops = loop if loop else (None, {})
        report[label] = {**regs, "row_loop": length,
                         "PRMT": ops.get("PRMT", 0),
                         "LDG": ops.get("LDG", 0), "CALL": ops.get("CALL", 0)}
    return report


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(BUILDS)
    if not torch.cuda.is_available():
        print("split2_builds: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cuda_build.build(["gf2_apply"])
    libs = builds.compile_builds({b: BUILDS[b] for b in names},
                                 "gf2_variants", BUILD_DIR)
    consts = ck.ShardApply(generator_matrix("reed_sol_van", K, M)[K:]).consts
    fields = consts.fields(dev)
    data = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (K, N_BYTES), dtype=np.uint8)).to(dev)
    words = ck.bytes_to_words(data)
    out_w = torch.empty((M, N_BYTES // 4), dtype=torch.int32, device=dev)
    out_b = torch.empty((M, N_BYTES), dtype=torch.uint8, device=dev)
    want_w = ck.gf2_apply_words_plain(consts.plain_bm32(dev), words)
    want_b = ck.words_to_bytes(want_w)
    stream = torch.cuda.current_stream(dev).cuda_stream
    words_args = (fields.data_ptr(), words.data_ptr(), out_w.data_ptr(), K,
                  M, N_BYTES // 4, words.stride(0), out_w.stride(0), stream)
    bytes_args = (fields.data_ptr(), data.data_ptr(), out_b.data_ptr(), K, M,
                  N_BYTES, 1, data.stride(0), 0, out_b.stride(0), 0, stream)

    def entry(lib, name, argtypes):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    def call(fn, args, out, want, label):
        def run():
            ck.check_rc(label, fn(*args))
        out.zero_()
        run()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{label} != plain version")
        return run

    word_types = ck._WORD_ARGS
    byte_types = ck._BYTE_ARGS
    base = cuda_build.load("gf2_apply")
    kernels = {  # label -> launch, every one checked exact first
        "B1": call(entry(base, "gf2_apply_words", word_types), words_args,
                   out_w, want_w, "B1"),
        "B2": call(entry(base, "gf2_apply_u8", byte_types), bytes_args,
                   out_b, want_b, "B2"),
    }
    reports = {}
    for build, (path, log) in libs.items():
        lib = ctypes.CDLL(path)
        reports[build] = kernel_report(path, log)
        kernels[f"{build} B5b"] = call(
            entry(lib, "gf2_apply_words_split2", word_types), words_args,
            out_w, want_w, f"{build} B5b")
        kernels[f"{build} B5c"] = call(
            entry(lib, "gf2_apply_u8_split2", byte_types), bytes_args, out_b,
            want_b, f"{build} B5c")
    best = {label: min(readings) for label, readings in
            builds.interleaved(kernels, ROUNDS).items()}
    card = perf_lab.nvidia_smi_line()
    print(json.dumps({"card": card, "B1_us": best["B1"] * 1e6,
                      "B2_us": best["B2"] * 1e6}))
    for build in libs:
        print(json.dumps({"build": build, "card": card,
                          "B5b_us": best[f"{build} B5b"] * 1e6,
                          "B5c_us": best[f"{build} B5c"] * 1e6,
                          **reports[build]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
