// The perf lab's copy roof for Hopper (sm_90a).
//
// Replaces the Pallas body of exp_roof_copy in ceph_tpu/testing/perf_lab.py
// (:150-151, launched at :155): o = x ^ 1 over (kin, n4) int32 words, a
// pure device-memory read and write with one integer op per word.  Its time
// is the card's best measured copy ceiling, the yardstick the port's kernels
// are read against.  The design is the fastest of the builds that
// ceph_tpu_torch/testing/copy_builds.py times on the card; the GF(2)
// kernels' IO pattern (the same grid, plain loads and stores) is its build
// "v1".
//
// Bound: the bytes, each input word read once and each output word written
// once; at the headline (8, 2^21) words that is 2 x 64 MiB = 134,217,728 B,
// 40.06 us at the H100 SXM data-sheet 3.35 TB/s.
//
// Design: a grid over all the data, one 16-byte unit per thread in blocks
// of 1024, so the block scheduler hands out work as SMs free up (a
// persistent grid, with a fixed share per SM, and a ring of bulk
// asynchronous copies per block were both slower: the SMs do not stream at
// one rate).  The load bypasses L1 and the store streams (the input is read
// once, the output is not read back), which measured faster than
// ld.global.nc and a plain store, as blocks of 1024 did than of 256 or 512.
// The
// words run [0, n) contiguously; the split: head words up to the input's
// first 16-byte boundary, the 16-byte units, then tail words.  Head and
// tail, and every word when the input and output lie at different offsets
// mod 16, take a plain one-word path in the same launch.  The launch runs
// on the caller's stream, allocates nothing, does not synchronise and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;

// [0, n) as head words, 16-byte units from word `head` on, tail words.
struct Split {
  long long head, units, tail;
};

Split split_of(const void* in, const void* out, long long n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(in) % 16;
  if (a != reinterpret_cast<uintptr_t>(out) % 16) return {n, 0, 0};
  long long head = static_cast<long long>((16 - a) % 16 / 4);
  if (head > n) head = n;
  const long long units = (n - head) / 4;
  return {head, units, n - head - 4 * units};
}

// The plain path: thread t of `threads` takes plain words t, t + threads...
// (the head's, then the tail's).
__device__ __forceinline__ void plain_words(const uint32_t* __restrict__ in,
                                            uint32_t* __restrict__ out,
                                            const Split s, long long t,
                                            long long threads) {
  for (long long j = t; j < s.head + s.tail; j += threads) {
    const long long w = j < s.head ? j : j + 4 * s.units;
    out[w] = __ldg(in + w) ^ 1u;
  }
}

__device__ __forceinline__ uint4 xor1(uint4 v) {
  return make_uint4(v.x ^ 1u, v.y ^ 1u, v.z ^ 1u, v.w ^ 1u);
}

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__global__ void __launch_bounds__(THREADS)
roof_copy_xor_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, const Split s) {
  const long long t = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  plain_words(in, out, s, t, static_cast<long long>(gridDim.x) * THREADS);
  if (t < s.units)
    store_stream(reinterpret_cast<uint4*>(out + s.head) + t,
                 xor1(load_stream(reinterpret_cast<const uint4*>(in + s.head) +
                                  t)));
}

int launch(const uint32_t* in, uint32_t* out, const Split s,
           cudaStream_t stream) {
  const long long work = s.units > s.head + s.tail ? s.units
                                                   : s.head + s.tail;
  const long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  roof_copy_xor_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         stream>>>(in, out, s);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int roof_copy_xor(const void* in, void* out, long long n,
                             void* stream) {
  if (n <= 0) return 0;
  return launch(static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
                split_of(in, out, n), static_cast<cudaStream_t>(stream));
}
