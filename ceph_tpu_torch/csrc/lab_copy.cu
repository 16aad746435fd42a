// The perf lab's copy roof for Hopper (sm_90a).
//
// Replaces the Pallas body of exp_roof_copy in ceph_tpu/testing/perf_lab.py
// (:150-151, launched at :155): o = x ^ 1 over (kin, n4) int32 words, a
// pure device-memory read and write with one integer op per word.  Its time
// is the card's measured copy ceiling for the IO pattern every GF(2) kernel
// of the port uses: one thread reads 16 bytes and writes 16 bytes,
// neighbouring threads on neighbouring addresses.
//
// Bound: the bytes, each input word read once and each output word written
// once; at the headline (8, 2^21) words that is 2 x 64 MiB = 134,217,728 B,
// 40.06 us at the H100 SXM data-sheet 3.35 TB/s.
//
// The words are one contiguous run of n (the wrapper checks contiguity); a
// masked tail takes any n.  The launch runs on the caller's stream,
// allocates nothing, does not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
roof_copy_xor_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                     long long n, bool vec_ok) {
  const long long w0 = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4;
  if (w0 >= n) return;
  if (vec_ok && w0 + 4 <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(in + w0));
    *reinterpret_cast<uint4*>(out + w0) =
        make_uint4(v.x ^ 1u, v.y ^ 1u, v.z ^ 1u, v.w ^ 1u);
    return;
  }
  for (long long w = w0; w < n && w < w0 + 4; ++w) out[w] = __ldg(in + w) ^ 1u;
}

}  // namespace

extern "C" int roof_copy_xor(const void* in, void* out, long long n,
                             void* stream) {
  if (n <= 0) return 0;
  const long long blocks = ((n + 3) / 4 + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  const bool vec_ok = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  roof_copy_xor_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n, vec_ok);
  return int(cudaGetLastError());
}
