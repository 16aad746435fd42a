// The encode-variant kernels for Hopper (sm_90a): three more formulations
// of the GF(2) region apply, each the port of one Pallas variant body of
// ceph_tpu/ec/pallas_kernels.py, selected by the encode variant
// (ec_pallas_encode_variant):
//   gf2_apply_words_cmp    <- _kernel_cmp_expand (:166-178), launched by
//                             _pallas_apply_words_variant (:244-264):
//                             enc_cmp_expand, (kin, N4) int32 words.
//   gf2_apply_words_split2 <- _kernel_split2 (:181-196), same launch:
//                             enc_split2, (kin, N4) int32 words.
//   gf2_apply_u8_split2    <- _kernel_u8_split2 (:216-231), launched by
//                             _pallas_apply_u8_variant (:267-288):
//                             enc_u8_split2, (kin, N) byte streams or the
//                             (B, kin, C) stripe batch, any length.
// Each computes exactly what gf2_apply.cu's kernels compute (out[r] =
// XOR_c A[r][c] * in[c] over GF(2^8)), for an unblocked contraction only:
// 32*mout*32*kin <= 1 MiB, i.e. mout*kin <= 1024, the JAX package's
// _pick_kblk(kin, mout) == kin.
//
// cmp (enc_cmp_expand): the TPU variant tests each bit with mask-AND and
// compare-to-zero straight to int8, dropping the shift-and-mask plane.
// Here it is a per-byte sign test: w << (7 - j) moves bit j of every byte
// to that byte's bit 7 (the bits shifted in from the byte below land under
// it and are ignored), and prmt.b32 with selector 0xBA98 replicates each
// byte's bit 7 over the byte: 0xFF where the bit is set, 0x00 elsewhere.
// Two instructions per (word, bit), one for bit 7; __byte_perm does not
// expose prmt's sign-replicate mode, hence the inline PTX, and __vcmpne4,
// the other candidate, is emulated on sm_90.  The mask ANDs the column
// table (cuda_kernels.column_table, GF2Constants.table): one uint4 per
// (input row c, bit j) holding the RB output rows' columns, staged once in
// kin*8*16 bytes of dynamic shared memory (1 KiB at k=8, at most 128 KiB
// at kin = 1024, mout = 1), so a single 16-byte shared load serves all RB
// accumulators.  Per (input word, bit) RB LOP3s plus the expansion.
//
// split2 (enc_split2, enc_u8_split2): the TPU variants run two independent
// half-tiles per grid step so that one half's expansion overlaps the other
// half's contraction.  Here each thread owns two 16-byte units,
// FIELD_THREADS units apart, and issues both loads of an input row before
// either XOR chain that consumes it, so the two chains hide each other's
// load latency: twice B1's bytes in flight per thread.  The arithmetic is
// B1's and B2's: gf2_io.cuh's gf2_words_kernel with HALVES = 2, over the
// field tables (GF2Constants.fields) staged in chunks of FIELD_KC input
// rows, 2 * 16 accumulator registers.  The words kernel keeps one row loop
// that tests each unit per row, as B1 does; the bytes kernel finds each
// unit once (a batch's segment division, once per unit) and picks its path
// once per thread: an interior-only loop, one LDG.128 per unit and row,
// when both units are interior, else one loop over both that tests each
// unit per row (only the data's and the segments' edges reach it).
//
// Bound.  At the jax_rs headline (k=8, m=4, 16384 stripes x 4 KiB):
// 64 MiB read + 32 MiB written + the tables = 30.05 us at the H100 SXM
// data-sheet 3.35 TB/s; bytes-bound, like gf2_apply.cu's kernels.
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W):
// B5b 47.37 us at the headline encode (63.4% of bound; 119 registers, a
// row loop of 394 SASS instructions per two unit-rows), B5c 50.63 us
// (59.3%; 128 registers, an interior loop of 246 with one LDG.128 per
// unit-row), against 65.28 and 67.69 for the bit spread.  Two units take
// the registers to 2 blocks of 256 per SM, so a thread's second load in
// flight buys no more bytes in flight per SM than B1's 4 blocks of one
// unit: in one interleaved loop B5b is 1.036x B1 and B5c 1.119x B2.  The
// builds tried (two rows per iteration, two rows in flight per unit, 3
// blocks per SM, 128-thread blocks, ...) are
// ceph_tpu_torch/testing/split2_builds.py's.
//
// Launches run on the caller's stream, allocate nothing and do not
// synchronise; each entry returns cudaGetLastError() of its launch, or
// cudaErrorInvalidValue for a matrix that needs a blocked contraction.

#include "gf2_io.cuh"

namespace {

using gf2::ByteIO;
using gf2::VEC;
using gf2::WordIO;
using gf2::byte_io;
using gf2::launch_fields;
using gf2::word_io;

constexpr int RB = gf2::FIELD_ROWS;  // output rows per block (uint4 entries)
constexpr int THREADS = 256;
constexpr int MAX_CELLS = 1024;  // mout*kin of an unblocked contraction
constexpr int DEFAULT_SMEM = 48 * 1024;

// 0xFF in each byte of x whose bit 7 is set, 0x00 elsewhere: prmt.b32's
// sign-replicate mode, output byte i <- sign of input byte i.
__device__ __forceinline__ uint32_t sign_bytes(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(0u), "r"(0xBA98u));
  return r;
}

// The cmp expansion: 0xFF in each byte of w whose bit j is set.
__device__ __forceinline__ uint32_t test_bit(uint32_t w, int j) {
  return sign_bytes(w << (7 - j));
}

__global__ void __launch_bounds__(THREADS)
gf2_words_cmp_kernel(const uint32_t* __restrict__ table, WordIO io, int kin,
                     int mout) {
  // s_tab[c * 8 + j] holds the RB rows' columns of input row c, bit j
  // (zero past mout).
  extern __shared__ uint4 s_tab[];
  const int r0 = blockIdx.y * RB;
  for (int i = threadIdx.x; i < kin * 8; i += blockDim.x) {
    uint32_t col[RB];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      const int r = r0 + rr;
      col[rr] = r < mout ? table[(long long)r * kin * 8 + i] : 0u;
    }
    s_tab[i] = make_uint4(col[0], col[1], col[2], col[3]);
  }
  __syncthreads();
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= io.threads_needed()) return;
  const gf2::WordUnit u = io.unit(t);  // the thread's 16 bytes, found once

  uint32_t acc[RB][VEC];
#pragma unroll
  for (int rr = 0; rr < RB; ++rr)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[rr][v] = 0u;

  for (int c = 0; c < kin; ++c) {
    uint32_t w[VEC];
    u.load(c, w);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 col4 = s_tab[c * 8 + j];
      const uint32_t col[RB] = {col4.x, col4.y, col4.z, col4.w};
      uint32_t m[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) m[v] = test_bit(w[v], j);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[rr][v] ^= m[v] & col[rr];
    }
  }
#pragma unroll
  for (int rr = 0; rr < RB; ++rr)
    if (r0 + rr < mout) u.store(r0 + rr, acc[rr]);
}

bool unblocked(int kin, int mout) {
  return (long long)kin * mout <= MAX_CELLS;
}

}  // namespace

// `table`: (mout, kin, 8) uint32, cuda_kernels.column_table.
extern "C" int gf2_apply_words_cmp(const void* table, const void* in,
                                   void* out, int kin, int mout, long long n4,
                                   long long in_stride, long long out_stride,
                                   void* stream) {
  const WordIO io = word_io(in, out, n4, in_stride, out_stride);
  const long long threads = io.threads_needed();
  if (threads <= 0 || kin <= 0 || mout <= 0) return 0;
  if (!unblocked(kin, mout)) return int(cudaErrorInvalidValue);
  const long long blocks = (threads + THREADS - 1) / THREADS;
  const int row_blocks = (mout + RB - 1) / RB;
  if (blocks > 0x7fffffffLL || row_blocks > 65535)
    return int(cudaErrorInvalidConfiguration);
  const int smem = kin * 8 * int(sizeof(uint4));
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        gf2_words_cmp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(row_blocks));
  gf2_words_cmp_kernel<<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), io, kin, mout);
  return int(cudaGetLastError());
}

// `fields`: (mout, kin, 5) uint32, cuda_kernels.field_tables.
extern "C" int gf2_apply_words_split2(const void* fields, const void* in,
                                      void* out, int kin, int mout,
                                      long long n4, long long in_stride,
                                      long long out_stride, void* stream) {
  if (!unblocked(kin, mout)) return int(cudaErrorInvalidValue);
  return launch_fields<WordIO, false, false, 2>(
      fields, word_io(in, out, n4, in_stride, out_stride), kin, mout, 1,
      static_cast<cudaStream_t>(stream));
}

// `fields`: (mout, kin, 5) uint32, cuda_kernels.field_tables.
extern "C" int gf2_apply_u8_split2(const void* fields, const void* in,
                                   void* out, int kin, int mout, long long seg,
                                   long long nseg, long long in_row_stride,
                                   long long in_seg_stride,
                                   long long out_row_stride,
                                   long long out_seg_stride, void* stream) {
  if (!unblocked(kin, mout)) return int(cudaErrorInvalidValue);
  return launch_fields<ByteIO, false, true, 2>(
      fields,
      byte_io(in, out, seg, nseg, in_row_stride, in_seg_stride,
              out_row_stride, out_seg_stride),
      kin, mout, 1, static_cast<cudaStream_t>(stream));
}
