"""Builds of the lab's copy kernel (L1, ``csrc/lab_copy.cu``) on the card,
side by side.

    python -m ceph_tpu_torch.testing.copy_builds [build ...]

L1 computes ``o = x ^ 1`` over int32 words; its time is the card's measured
copy ceiling.  Each build here is the committed ``csrc/`` with the named
text edits of ``BUILDS`` applied to a copy (``testing/builds.py``),
compiled as ``cuda_build`` compiles into ``_build/copy_builds/<build>/``;
``kept`` is the committed source.  A build other than ``kept`` adds one
design's kernel before the end of ``lab_copy.cu``'s namespace and routes
the entry point's launch to it, so every design shares the committed
split of the words (head, 16-byte units, tail) and its plain one-word path:

- ``_REGS``: threads load 16-byte units into registers, ``U`` per thread
  and iteration, ``blockDim`` apart; ``PERSIST``: a grid of the SMs times
  the blocks that fit on one, walking the units in a grid-stride loop
  whose next loads are issued before its stores (else a grid over all the
  units, one iteration per thread); ``HINT``: 0 ``ld.global.nc`` and plain
  stores, 1 loads that skip L1 and streaming stores, 2 an ``evict_first``
  L2 policy on both, 3 as 1 with a 256-byte L2 prefetch; ``STORE`` false:
  the probe, which XOR-reduces each block's words into one word instead of
  storing them (the read stream alone);
- ``_BULK``: Hopper's bulk asynchronous copies (1-D TMA): a ring of
  ``STAGES`` shared-memory stages of ``STAGE`` bytes per block, one thread
  issuing the bulk loads (completion on an mbarrier) and the bulk stores
  (bulk groups), all threads XORing each stage in place; ``HINT`` 1 gives
  both copies an ``evict_first`` L2 policy.

For each build it prints one JSON line: ptxas's registers and spills of
the kernel it launches, the bytes of loads in flight per SM (bytes in
flight per block times the blocks that fit, from the registers and shared
memory), whether it equals ``roof_copy_xor_plain`` at the headline (8,
2^21) words and at a ragged (8, 1000003) whose input and output start 4
bytes past 16-byte alignment (the probe stores no words and is not
checked), and its time by two timers, each the best over ``ROUNDS``
rounds of one interleaved loop that also times ``torch.bitwise_xor(words,
1)`` and the committed L1 (through its wrapper), forward then backward,
with the rounds in which the build beat ``torch.bitwise_xor``: CUDA
events around 20 eager launches, median of 5 (``us``, the choice of the
kept build), and the lab's device loop (``loop_us``: the JAX lab's step,
the kernel plus its one-word carry, 64 and 320 steps in CUDA graphs,
differenced), which has no host in it.  Needs a card and the CUDA
toolkit; writes nothing outside ``_build/``.
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys

import numpy as np
import torch

from ceph_tpu_torch.common import cuda_build
from ceph_tpu_torch.ec import benchmark
from ceph_tpu_torch.ec import cuda_kernels as ck
from ceph_tpu_torch.testing import builds, perf_lab

SHAPE = (8, 1 << 21)          # the lab's headline words, 64 MiB
RAGGED = (8, 1_000_003)
ROUNDS = 6
BUILD_DIR = cuda_build.BUILD_DIR / "copy_builds"

_END = "}  // namespace\n"
_CALL = "  return launch("

_REGS = r"""
template <int HINT>
__device__ __forceinline__ uint4 sweep_load(const uint4* p, uint64_t pol) {
  uint4 v;
  if (HINT == 0) {
    v = __ldg(p);
  } else if (HINT == 1) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else if (HINT == 2) {
    asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 "
                 "{%0, %1, %2, %3}, [%4], %5;"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p), "l"(pol));
  } else if (HINT == 3) {
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 "
                 "{%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else {
    asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  }
  return v;
}

template <int HINT>
__device__ __forceinline__ void sweep_store(uint4* p, uint4 v, uint64_t pol) {
  if (HINT == 0) {
    *p = v;
  } else if (HINT == 2) {
    asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;"
                 ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol)
                 : "memory");
  } else {
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
  }
}

template <int U, bool PERSIST, int HINT, bool STORE>
__global__ void __launch_bounds__(THREADS)
sweep_regs_kernel(const uint32_t* __restrict__ in,
                  uint32_t* __restrict__ out, const Split s) {
  const long long threads = static_cast<long long>(gridDim.x) * THREADS;
  plain_words(in, out, s, blockIdx.x * static_cast<long long>(THREADS) +
                              threadIdx.x, threads);
  uint64_t pol = 0;
  if (HINT == 2)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(pol));
  const uint4* vin = reinterpret_cast<const uint4*>(in + s.head);
  uint4* vout = reinterpret_cast<uint4*>(out + s.head);
  const long long step = threads * U;
  long long i = blockIdx.x * static_cast<long long>(THREADS * U) +
                threadIdx.x;
  uint32_t acc = 0;
  uint4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (i + u * THREADS < s.units)
      v[u] = sweep_load<HINT>(vin + i + u * THREADS, pol);
  for (; i < s.units; i += step) {
    uint4 next[U];
    if (PERSIST) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + step + u * THREADS < s.units)
          next[u] = sweep_load<HINT>(vin + i + step + u * THREADS, pol);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u * THREADS < s.units) {
        if (STORE)
          sweep_store<HINT>(vout + i + u * THREADS, xor1(v[u]), pol);
        else
          acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
      }
      if (PERSIST) v[u] = next[u];
    }
  }
  if (!STORE) {
#pragma unroll
    for (int d = 16; d > 0; d /= 2) acc ^= __shfl_xor_sync(0xffffffffu, acc, d);
    if (threadIdx.x % 32 == 0) atomicXor(out + blockIdx.x, acc);
  }
}

template <int U, bool PERSIST, int HINT, bool STORE>
int sweep_launch_regs(const uint32_t* in, uint32_t* out, const Split s,
                      cudaStream_t stream) {
  static long long grid_cap = 0;  // resident blocks on the device
  if (PERSIST && grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sweep_regs_kernel<U, PERSIST, HINT, STORE>, THREADS, 0);
    if (err != cudaSuccess) return int(err);
    grid_cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  const long long work = s.units > s.head + s.tail ? s.units
                                                   : s.head + s.tail;
  long long blocks = (work + THREADS * U - 1) / (THREADS * U);
  if (PERSIST && blocks > grid_cap) blocks = grid_cap;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  sweep_regs_kernel<U, PERSIST, HINT, STORE>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(in, out, s);
  return int(cudaGetLastError());
}
"""

_BULK = r"""
template <int STAGE, int STAGES, int HINT>
__global__ void __launch_bounds__(THREADS)
sweep_bulk_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  const Split s, long long nstages) {
  extern __shared__ __align__(128) uint4 ring[];
  __shared__ __align__(8) uint64_t full[STAGES];
  const long long threads = static_cast<long long>(gridDim.x) * THREADS;
  plain_words(in, out, s, blockIdx.x * static_cast<long long>(THREADS) +
                              threadIdx.x, threads);
  const long long bytes = s.units * 16;
  const char* gin = reinterpret_cast<const char*>(in + s.head);
  char* gout = reinterpret_cast<char*>(out + s.head);
  const long long mine =
      blockIdx.x < nstages ? (nstages - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (mine == 0) return;
  uint64_t pol = 0;
  if (HINT)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(pol));
  const uint32_t ring0 = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  if (threadIdx.x == 0) {
    for (int b = 0; b < STAGES; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * b)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // stage k of this block: bytes [off_of(k), off_of(k) + len_of(k)) of the
  // units
  auto off_of = [&](long long k) {
    return (blockIdx.x + k * gridDim.x) * static_cast<long long>(STAGE);
  };
  auto len_of = [&](long long k) {
    const long long r = bytes - off_of(k);
    return static_cast<uint32_t>(r < STAGE ? r : STAGE);
  };
  auto load = [&](long long k) {
    const int b = static_cast<int>(k % STAGES);
    const uint32_t len = len_of(k), bar = bar0 + 8 * b;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(len) : "memory");
    if (HINT)
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                   "::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;"
                   ::"r"(ring0 + b * STAGE), "l"(gin + off_of(k)), "r"(len),
                   "r"(bar), "l"(pol) : "memory");
    else
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                   "::bytes [%0], [%1], %2, [%3];"
                   ::"r"(ring0 + b * STAGE), "l"(gin + off_of(k)), "r"(len),
                   "r"(bar) : "memory");
  };
  if (threadIdx.x == 0)
    for (long long k = 0; k < STAGES && k < mine; ++k) load(k);
  for (long long k = 0; k < mine; ++k) {
    const int b = static_cast<int>(k % STAGES);
    const uint32_t parity = static_cast<uint32_t>((k / STAGES) & 1);
    uint32_t done = 0;
    while (!done)
      asm volatile("{\n .reg .pred p;\n"
                   " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                   " selp.u32 %0, 1, 0, p;\n}"
                   : "=r"(done) : "r"(bar0 + 8 * b), "r"(parity) : "memory");
    const uint32_t len = len_of(k);
    uint4* buf = ring + b * (STAGE / 16);
    for (uint32_t j = threadIdx.x; j < len / 16; j += THREADS)
      buf[j] = xor1(buf[j]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      if (HINT)
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group"
                     ".L2::cache_hint [%0], [%1], %2, %3;"
                     ::"l"(gout + off_of(k)), "r"(ring0 + b * STAGE),
                     "r"(len), "l"(pol) : "memory");
      else
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group "
                     "[%0], [%1], %2;"
                     ::"l"(gout + off_of(k)), "r"(ring0 + b * STAGE),
                     "r"(len) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // stage k - 1's buffer is free once its store has read it
      if (k >= 1 && k - 1 + STAGES < mine) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load(k - 1 + STAGES);
      }
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int STAGE, int STAGES, int HINT, int PER_CTA>
int sweep_launch_bulk(const uint32_t* in, uint32_t* out, const Split s,
                      cudaStream_t stream) {
  constexpr int SMEM = STAGE * STAGES;
  static long long grid_cap = 0;  // resident blocks on the device
  if (grid_cap == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_bulk_kernel<STAGE, STAGES, HINT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sweep_bulk_kernel<STAGE, STAGES, HINT>, THREADS, SMEM);
    if (err != cudaSuccess) return int(err);
    grid_cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  const long long nstages = (s.units * 16 + STAGE - 1) / STAGE;
  const long long plain = (s.head + s.tail + THREADS - 1) / THREADS;
  long long blocks = PER_CTA ? (nstages + PER_CTA - 1) / PER_CTA : nstages;
  if (blocks < plain) blocks = plain;
  if (!PER_CTA && blocks > grid_cap) blocks = grid_cap;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  sweep_bulk_kernel<STAGE, STAGES, HINT>
      <<<static_cast<unsigned>(blocks), THREADS, SMEM, stream>>>(
          in, out, s, nstages);
  return int(cudaGetLastError());
}
"""


def _regs(u: int, persist: bool, hint: int, store: bool = True):
    args = f"{u}, {str(persist).lower()}, {hint}, {str(store).lower()}"
    return [("lab_copy.cu", _END, _REGS + _END),
            ("lab_copy.cu", _CALL, f"  return sweep_launch_regs<{args}>(")]


def _bulk(stage: int, stages: int, hint: int = 0, per_cta: int = 0):
    args = f"{stage}, {stages}, {hint}, {per_cta}"
    return [("lab_copy.cu", _END, _BULK + _END),
            ("lab_copy.cu", _CALL, f"  return sweep_launch_bulk<{args}>(")]


def _threads(n: int):
    return [("lab_copy.cu", "constexpr int THREADS = 1024;",
             f"constexpr int THREADS = {n};")]


T256, T512 = _threads(256), _threads(512)


# build -> [(file in csrc/, old text, new text)], each old text present once
BUILDS = {
    "kept": [],
    # the GF(2) kernels' IO pattern: one 16-byte unit per thread, blocks of
    # 256, a grid over all the data, ld.global.nc and plain stores
    "v1": _regs(1, False, 0) + T256,
    "unroll2": _regs(2, False, 0) + T256,
    "unroll4": _regs(4, False, 0) + T256,
    "threads512": _regs(1, False, 0) + T512,
    "persistent": _regs(1, True, 0) + T256,
    "persistent_unroll4": _regs(4, True, 0) + T256,
    # streaming cache policy; stream_hints_threads1024 is the committed
    # kernel through the sweep's template
    "stream_hints": _regs(1, False, 1) + T256,
    "stream_hints_threads512": _regs(1, False, 1) + T512,
    "stream_hints_threads1024": _regs(1, False, 1),
    "stream_hints_ldcs": _regs(1, False, 4),
    "stream_hints_evict_first": _regs(1, False, 2),
    "stream_hints_prefetch": _regs(1, False, 3),
    "stream_hints_unroll2": _regs(2, False, 1) + T512,
    "stream_hints_persistent_unroll4": _regs(4, True, 1) + T256,
    # a ring of 4 stages of 16 KiB per block on a persistent grid
    "bulk": _bulk(16384, 4) + T256,
    "bulk_evict_first": _bulk(16384, 4, 1) + T256,
    # a grid over the stages, one per block
    "bulk_grid_8k": _bulk(8192, 1, 0, 1) + T256,
    "bulk_grid_16k": _bulk(16384, 1, 0, 1) + T256,
    "bulk_grid_16k_evict_first": _bulk(16384, 1, 1, 1) + T256,
    # the probe: the committed kernel with its stores removed
    "probe_read": _regs(1, False, 1, store=False),
}
PROBES = {"probe_read"}


def _loads(u, threads=1024):
    return (u * 16 * threads, 0, threads)


# build -> (bytes of loads a block keeps in flight, dynamic shared memory,
# threads per block)
IN_FLIGHT = {
    "kept": _loads(1),
    "v1": _loads(1, 256), "unroll2": _loads(2, 256),
    "unroll4": _loads(4, 256), "threads512": _loads(1, 512),
    "persistent": _loads(1, 256), "persistent_unroll4": _loads(4, 256),
    "stream_hints": _loads(1, 256), "stream_hints_threads512": _loads(1, 512),
    "stream_hints_threads1024": _loads(1),
    "stream_hints_ldcs": _loads(1), "stream_hints_evict_first": _loads(1),
    "stream_hints_prefetch": _loads(1),
    "stream_hints_unroll2": _loads(2, 512),
    "stream_hints_persistent_unroll4": _loads(4, 256),
    "bulk": (3 * 16384, 4 * 16384, 256),
    "bulk_evict_first": (3 * 16384, 4 * 16384, 256),
    "bulk_grid_8k": (8192, 8192, 256),
    "bulk_grid_16k": (16384, 16384, 256),
    "bulk_grid_16k_evict_first": (16384, 16384, 256),
    "probe_read": _loads(1),
}


def sources(build: str) -> dict[str, str]:
    """csrc file name -> text of ``build``; raises if an edit's old text is
    not in its file exactly once."""
    return builds.sources(BUILDS[build], build)


def resident_blocks(registers: int, smem: int, threads: int) -> int:
    """Blocks of ``threads`` that fit on one H100 SM: 2048 threads and 32
    blocks, 65,536 registers (allocated per warp in units of 256), 228 KiB
    of shared memory with 1 KiB reserved per block."""
    per_warp = -(-registers * 32 // 256) * 256
    fit = min(2048 // threads, 32, 65536 // (per_warp * (threads // 32)))
    if smem:
        fit = min(fit, 233472 // (smem + 1024))
    return fit


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(BUILDS)
    if not torch.cuda.is_available():
        print("copy_builds: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cuda_build.build(["lab_copy"])
    libs = builds.compile_builds({b: BUILDS[b] for b in names}, "lab_copy",
                                 BUILD_DIR)
    rng = np.random.default_rng(11)

    def words_at(shape, offset):
        """Random int32 words of ``shape`` starting ``offset`` words past a
        16-byte boundary (torch allocations are 16-byte aligned)."""
        n = int(np.prod(shape))
        buf = torch.from_numpy(rng.integers(-2**31, 2**31, n + offset,
                                            dtype=np.int64).astype(np.int32))
        return buf.to(dev)[offset:].view(shape)

    words = words_at(SHAPE, 0)
    out = torch.empty_like(words)
    ragged = words_at(RAGGED, 1)
    ragged_out = words_at(RAGGED, 1)
    # label -> fn(x, out) -> out, launched on the current stream (a graph
    # being captured included)
    kernels = {"torch.bitwise_xor": lambda x, o: torch.bitwise_xor(x, 1),
               "committed L1": lambda x, o: perf_lab.roof_copy_xor(x, out=o)}
    reports = {}
    for build, (path, log) in libs.items():
        fn = ctypes.CDLL(path).roof_copy_xor
        fn.argtypes, fn.restype = perf_lab.COPY_ARGS, ctypes.c_int

        def run(x, o, fn=fn, build=build):
            ck.check_rc(build, fn(x.data_ptr(), o.data_ptr(), x.numel(),
                                  torch._C._cuda_getCurrentRawStream(dev.index)))
            return o

        _, regs = builds.one_kernel(
            log, build, (lambda n: "roof_copy_xor_kernel" in n)
            if build == "kept" else (lambda n: "sweep_" in n))
        equal = None
        if build not in PROBES:
            for x, o in ((words, out), (ragged, ragged_out)):
                o.zero_()
                run(x, o)
                torch.cuda.synchronize()
                if not torch.equal(o, perf_lab.roof_copy_xor_plain(x)):
                    raise AssertionError(f"{build} != plain version")
            equal = True
        per_block, smem, threads = IN_FLIGHT[build]
        reports[build] = {
            **regs, "threads": threads, "dynamic_smem": smem,
            "equal": equal, "in_flight_per_sm": per_block * resident_blocks(
                regs["registers"], smem, threads)}
        kernels[build] = run
    got = builds.interleaved(
        {k: functools.partial(f, words, out) for k, f in kernels.items()},
        ROUNDS)
    loop = builds.interleaved(
        {k: perf_lab.carry_step(lambda x, f=f: f(x, out))
         for k, f in kernels.items()}, ROUNDS,
        lambda step: benchmark.device_seconds_per_iter(step, words))
    nbytes = 2 * words.numel() * 4

    def wins(readings, label):
        return sum(r < x for r, x in zip(readings[label],
                                          readings["torch.bitwise_xor"]))

    def us(readings):
        return [round(r * 1e6, 2) for r in readings]

    card = perf_lab.nvidia_smi_line()
    for label in ("torch.bitwise_xor", "committed L1"):
        print(json.dumps({
            "label": label, "card": card, "rounds": ROUNDS,
            "us": min(got[label]) * 1e6, "readings_us": us(got[label]),
            "loop_us": min(loop[label]) * 1e6,
            "loop_readings_us": us(loop[label]),
            "wins_vs_bitwise_xor": wins(got, label),
            "loop_wins_vs_bitwise_xor": wins(loop, label)}))
    for build in libs:
        best = min(got[build])
        moved = nbytes // 2 if build in PROBES else nbytes
        print(json.dumps({"build": build, "card": card, "us": best * 1e6,
                          "TBps": moved / best / 1e12,
                          "wins_vs_bitwise_xor": wins(got, build),
                          "loop_us": min(loop[build]) * 1e6,
                          "loop_wins_vs_bitwise_xor": wins(loop, build),
                          "probe": build in PROBES,
                          "readings_us": us(got[build]),
                          "loop_readings_us": us(loop[build]),
                          **reports[build]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
