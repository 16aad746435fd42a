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
// XOR_c A[r][c] * in[c] over GF(2^8), from the same byte-replicated column
// table), for an unblocked contraction only: 32*mout*32*kin <= 1 MiB, i.e.
// mout*kin <= 1024, the JAX package's _pick_kblk(kin, mout) == kin.
//
// Design, common to the three:
// - Unblocked means the whole table fits on chip.  A block stages the
//   column table of its RB output rows (blockIdx.y, as in gf2_apply.cu)
//   once, as one uint4 per (input row c, bit j) holding the RB rows'
//   columns, so a single 16-byte shared load serves all RB accumulators;
//   there is no chunk loop over input rows.  kin*8*16 bytes of dynamic
//   shared memory: 1 KiB at k=8, at most 128 KiB (kin = 1024, mout = 1).
// - One thread owns 16 bytes (VEC = 4 words) of every row, per half.
//
// What each carries over from its TPU formulation:
// - cmp (enc_cmp_expand): the TPU variant tests each bit with mask-AND and
//   compare-to-zero straight to int8, dropping the shift-and-mask plane.
//   Here the production spread ((w >> j) & 0x01010101) * 0xFF (gf2_io.cuh)
//   becomes a per-byte sign test: w << (7 - j) moves bit j of every byte to
//   that byte's bit 7 (the bits shifted in from the byte below land under
//   it and are ignored), and prmt.b32 with selector 0xBA98 replicates each
//   byte's bit 7 over the byte: 0xFF where the bit is set, 0x00 elsewhere.
//   Two instructions per (word, bit), one for bit 7, against the spread's
//   shift, AND and multiply.  __byte_perm does not expose prmt's
//   sign-replicate mode, hence the inline PTX; __vcmpne4, the other
//   candidate, is emulated on sm_90.
// - split2 (enc_split2): the TPU variant runs two independent half-tiles
//   per grid step so the second half's expansion overlaps the first half's
//   contraction.  Here each thread owns two 16-byte column groups half a
//   block tile (THREADS groups) apart and issues both loads of an input row
//   before either XOR chain, so two independent dependency chains hide each
//   other's load latency; each half masks its own ragged edge.  Twice the
//   live accumulators: 2*RB*VEC = 32 registers.
// - u8_split2 (enc_u8_split2): split2 over the byte streams as they lie
//   (gf2_io.cuh's ByteIO).  The TPU's (kin, 4, N/4) slot layout is a free
//   view of the (kin, N) stream, and byte lanes never mix, so the kernel
//   takes the streams and the (B, kin, C) batch directly, at any length.
//
// Bound.  At the jax_rs headline (k=8, m=4, 16384 stripes x 4 KiB):
// 64 MiB read + 32 MiB written + 1 KiB of table = 30.05 us at the H100
// SXM data-sheet 3.35 TB/s; bytes-bound, like gf2_apply.cu's kernels.  All
// three stay integer-issue-bound: per (input word, bit) RB LOP3s plus the
// expansion (2 instructions for cmp, 3 for the spread), about 6-7 integer
// instructions against B1's 8 with its four 4-byte shared loads.
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
using gf2::spread;
using gf2::word_io;

constexpr int RB = 4;          // output rows per block (uint4 table entries)
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

// Stage the column table of rows r0..r0+RB-1 (zero past mout) as uint4:
// s_tab[c * 8 + j] holds the RB rows' columns of input row c, bit j.
__device__ __forceinline__ void stage_table(uint4* s_tab,
                                            const uint32_t* __restrict__ table,
                                            int kin, int mout, int r0) {
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
}

// One block's work: HALVES column groups per thread, THREADS apart, each
// with RB row accumulators; CMP picks the sign-test expansion.
template <class IO, bool CMP, int HALVES>
__device__ __forceinline__ void apply_block(const uint4* s_tab, const IO& io,
                                            int kin, int mout, int r0) {
  long long t[HALVES];
  bool live[HALVES];
  const long long first =
      (long long)blockIdx.x * (HALVES * THREADS) + threadIdx.x;
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    t[h] = first + (long long)h * THREADS;
    live[h] = t[h] < io.threads_needed();
  }
  if (!live[0]) return;  // the later halves lie further out

  uint32_t acc[HALVES][RB][VEC];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[h][rr][v] = 0u;

  for (int c = 0; c < kin; ++c) {
    uint32_t w[HALVES][VEC];
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {  // every load before any XOR chain
      if (live[h]) {
        io.load(c, t[h], w[h]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) w[h][v] = 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 col4 = s_tab[c * 8 + j];
      const uint32_t col[RB] = {col4.x, col4.y, col4.z, col4.w};
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        uint32_t m[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          m[v] = CMP ? test_bit(w[h][v], j) : spread(w[h][v], j);
#pragma unroll
        for (int rr = 0; rr < RB; ++rr)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[h][rr][v] ^= m[v] & col[rr];
      }
    }
  }
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    if (!live[h]) continue;
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
      if (r0 + rr < mout) io.store(r0 + rr, t[h], acc[h][rr]);
  }
}

__global__ void __launch_bounds__(THREADS)
gf2_words_cmp_kernel(const uint32_t* __restrict__ table, WordIO io, int kin,
                     int mout) {
  extern __shared__ uint4 s_tab[];
  const int r0 = blockIdx.y * RB;
  stage_table(s_tab, table, kin, mout, r0);
  apply_block<WordIO, true, 1>(s_tab, io, kin, mout, r0);
}

__global__ void __launch_bounds__(THREADS)
gf2_words_split2_kernel(const uint32_t* __restrict__ table, WordIO io, int kin,
                        int mout) {
  extern __shared__ uint4 s_tab[];
  const int r0 = blockIdx.y * RB;
  stage_table(s_tab, table, kin, mout, r0);
  apply_block<WordIO, false, 2>(s_tab, io, kin, mout, r0);
}

__global__ void __launch_bounds__(THREADS)
gf2_u8_split2_kernel(const uint32_t* __restrict__ table, ByteIO io, int kin,
                     int mout) {
  extern __shared__ uint4 s_tab[];
  const int r0 = blockIdx.y * RB;
  stage_table(s_tab, table, kin, mout, r0);
  apply_block<ByteIO, false, 2>(s_tab, io, kin, mout, r0);
}

template <class IO>
int launch(void (*kernel)(const uint32_t*, IO, int, int), int halves,
           const uint32_t* table, const IO& io, long long threads, int kin,
           int mout, cudaStream_t stream) {
  if (threads <= 0 || kin <= 0 || mout <= 0) return 0;
  if ((long long)kin * mout > MAX_CELLS) return int(cudaErrorInvalidValue);
  const long long per_block = (long long)halves * THREADS;
  const long long blocks = (threads + per_block - 1) / per_block;
  const int row_blocks = (mout + RB - 1) / RB;
  if (blocks > 0x7fffffffLL || row_blocks > 65535)
    return int(cudaErrorInvalidConfiguration);
  const int smem = kin * 8 * int(sizeof(uint4));
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(row_blocks));
  kernel<<<grid, THREADS, smem, stream>>>(table, io, kin, mout);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int gf2_apply_words_cmp(const void* table, const void* in,
                                   void* out, int kin, int mout, long long n4,
                                   long long in_stride, long long out_stride,
                                   void* stream) {
  return launch(gf2_words_cmp_kernel, 1, static_cast<const uint32_t*>(table),
                word_io(in, out, n4, in_stride, out_stride),
                (n4 + VEC - 1) / VEC, kin, mout,
                static_cast<cudaStream_t>(stream));
}

extern "C" int gf2_apply_words_split2(const void* table, const void* in,
                                      void* out, int kin, int mout,
                                      long long n4, long long in_stride,
                                      long long out_stride, void* stream) {
  return launch(gf2_words_split2_kernel, 2,
                static_cast<const uint32_t*>(table),
                word_io(in, out, n4, in_stride, out_stride),
                (n4 + VEC - 1) / VEC, kin, mout,
                static_cast<cudaStream_t>(stream));
}

extern "C" int gf2_apply_u8_split2(const void* table, const void* in,
                                   void* out, int kin, int mout, long long seg,
                                   long long nseg, long long in_row_stride,
                                   long long in_seg_stride,
                                   long long out_row_stride,
                                   long long out_seg_stride, void* stream) {
  return launch(gf2_u8_split2_kernel, 2, static_cast<const uint32_t*>(table),
                byte_io(in, out, seg, nseg, in_row_stride, in_seg_stride,
                        out_row_stride, out_seg_stride),
                (seg * nseg + 4 * VEC - 1) / (4 * VEC), kin, mout,
                static_cast<cudaStream_t>(stream));
}
