// GF(2) bitmatrix region apply for Hopper (sm_90a): the erasure-code hot op.
//
// Replaces two Pallas TPU kernels of ceph_tpu/ec/pallas_kernels.py:
//   gf2_apply_words <- _kernel (:96-117) launched by _pallas_apply_words
//                      (:120-141): (kin, N4) int32 lane words -> (mout, N4).
//                      gf2_apply_words_tiled is the same kernel at the
//                      launch's `tile` argument (the perf lab's enc_tile_<n>
//                      sweep); the production entry keeps one column group
//                      of 1024 words per block.
//   gf2_apply_u8    <- _kernel_u8 (:199-213) launched by
//                      _pallas_apply_u8_variant (:267-288): the uint8
//                      formulation.  The TPU needs a (kin, 4, N/4) slot
//                      relayout to feed its vector unit; here a thread reads
//                      16 contiguous bytes of the stream directly, so the
//                      kernel takes plain (kin, N) byte streams (or the
//                      (B, kin, C) stripe batch) of any length.
//
// Function: out[r] = XOR_c  A[r][c] * in[c]  over GF(2^8), for every byte
// column, given the (8 mout x 8 kin) GF(2) bitmatrix BM of the coefficient
// matrix A (packet codes pass their raw 0/1 GF(2) matrix the same way).
// Byte lanes never mix, so each block (r, c) of BM is a linear map M on
// bytes: bit i of M(x) is XOR_j BM[8r+i][8c+j] * bit j of x.
//
// gf2_apply_words: byte tables looked up with prmt.  M is linear, so
// M(x) = M(x & 0x07) ^ M(x & 0x38) ^ M(x & 0xC0): three tables of the bit
// fields 0-2, 3-5 and 6-7 of x, with 8, 8 and 4 byte entries,
//   T0[v] = M(v),  T1[v] = M(v << 3),  T2[v] = M(v << 6)
// (host-built, cuda_kernels.field_tables), in 5 words per (r, c): T0 and T1
// as two words of 4 entries each, T2 as one.  prmt.b32 picks 4 bytes out of
// the 8 of two registers, one per selector nibble, so one prmt looks up 4
// bytes at once.  A field is at most 3 bits, so no selector nibble sets
// prmt's sign-replicate bit (nibble bit 3).  A thread owns VEC = 4
// consecutive words of every row and reads them as two pairs (a, b); per
// pair and field one selector word holds the field of a's byte i in nibble
// 2i and of b's in nibble 2i+1: its low half indexes lanes 0-1 of a and b,
// its high half (>> 16) lanes 2-3.  So per input row, once for all output
// rows, 6 selectors per pair (about 7 integer instructions per input word),
// then per output row 3 prmt and about 2 LOP3 per input word, and 5 shared
// loads of the tables per input row (a 16-byte broadcast each).  The
// accumulators hold the pair interleaved ([a0 b0 a1 b1], [a2 b2 a3 b3]);
// two prmt per pair and output row undo it before the store.  At m = 4
// the inner loop is 167 SASS instructions per 4 input words (the edge
// path's loads included), about 42 per word, against 70 for the bit-spread
// design it replaced (280 per 32 word-bit pairs).  As before,
// each block computes RB output rows (blockIdx.y), the tables are staged
// through shared memory in chunks of KC input rows, so any (kin, mout)
// works (the w=32 packet matrix is 64 x 128), with XOR accumulation in
// registers across chunks (the TPU kernel's kblk blocking, transposed), and
// the next input row's words are loaded while the current one is applied.
//
// gf2_apply_u8 keeps the bit-spread design (gf2_apply_kernel):
//   table[r][c][j] = (sum_i BM[8r+i][8c+j] << i) * 0x01010101   (host-built)
//   spread_j(w)    = ((w >> j) & 0x01010101) * 0xFF
//   acc[r]        ^= spread_j(in[c]) & table[r][c][j]      (one LOP3)
//
// Bound.  Headline encode (k=8, m=4, 16384 stripes x 4 KiB): 64 MiB read +
// 32 MiB written = 100.7 MB, about 30 us at the H100 SXM data-sheet
// 3.35 TB/s; the 4-erasure decode moves the same bytes.  Both kernels are
// bytes-bound on paper and issue-bound in practice: the H100 issues 64
// integer (ALU) lane operations per clock per SM, and the bit-spread design
// spends about 17 instructions per input byte.  The table design spends
// about 10, which brings its issue time under the time its bytes take at
// the measured copy ceiling.
//
// Launches run on the caller's stream, allocate nothing and do not
// synchronise; each entry returns cudaGetLastError() of its launch.

#include "gf2_io.cuh"

namespace {

using gf2::ByteIO;
using gf2::VEC;
using gf2::WordIO;
using gf2::byte_io;
using gf2::spread;
using gf2::word_io;

constexpr int RB = 4;        // output rows per register block
constexpr int KC = 32;       // input rows per shared-memory table chunk
constexpr int THREADS = 256;
constexpr int FIELD_WORDS = 5;  // T0 (2 words), T1 (2), T2 (1) per (r, c)

static_assert(VEC % 2 == 0, "words are read in pairs");

// -- gf2_apply_words: field tables and prmt ----------------------------------

// prmt.b32 in its default mode: byte i of the result is byte nibble_i of
// the 8 bytes {lo, hi} (lo bytes 0-3, hi bytes 4-7); selector bits 16-31
// are ignored.  Inline PTX, because __byte_perm may mask the selector first.
__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

// The selectors of the word pair (a, b): s[2f] indexes field f of lanes
// 0-1 (a's in the even nibbles, b's in the odd), s[2f + 1] of lanes 2-3.
__device__ __forceinline__ void field_selectors(uint32_t a, uint32_t b,
                                                uint32_t (&s)[6]) {
  const uint32_t u0 = (a & 0x07070707u) | ((b << 4) & 0x70707070u);
  const uint32_t u1 = ((a >> 3) & 0x07070707u) | ((b << 1) & 0x70707070u);
  const uint32_t u2 = ((a >> 6) & 0x03030303u) | ((b >> 2) & 0x30303030u);
  s[0] = u0; s[1] = u0 >> 16;
  s[2] = u1; s[3] = u1 >> 16;
  s[4] = u2; s[5] = u2 >> 16;
}

// TILED: a block covers `groups` column groups of THREADS threads (a tile of
// groups * THREADS * VEC words per row, the Pallas kernel's `tile`) and walks
// them in turn; with one table chunk (kin <= KC) it stages the chunk once for
// all of them.  Untiled (the production launch) a block covers one group.
template <bool TILED>
__global__ void __launch_bounds__(THREADS)
gf2_words_kernel(const uint32_t* __restrict__ fields, WordIO io, int kin,
                 int mout, int groups) {
  // s_t01[cc * RB + rr] = (T0 lo, T0 hi, T1 lo, T1 hi) of (r0 + rr, c0 + cc);
  // s_t2[cc] = T2 of the RB rows.  Zero for rows past mout.
  __shared__ uint4 s_t01[KC * RB];
  __shared__ uint4 s_t2[KC];
  const int r0 = blockIdx.y * RB;
  const int ngroups = TILED ? groups : 1;
  for (int g = 0; g < ngroups; ++g) {
    const long long t =
        ((long long)blockIdx.x * ngroups + g) * blockDim.x + threadIdx.x;
    const bool live = t < io.threads_needed();

    // acc[rr][2q + h]: pair q (words 2q, 2q+1), lanes 2h and 2h+1
    uint32_t acc[RB][VEC];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[rr][v] = 0u;

    for (int c0 = 0; c0 < kin; c0 += KC) {
      const int kc = min(KC, kin - c0);
      if (!TILED || g == 0 || kin > KC) {
        __syncthreads();  // previous chunk fully consumed
        for (int i = threadIdx.x; i < kc * RB; i += blockDim.x) {
          const int cc = i / RB, rr = i - cc * RB, r = r0 + rr;
          const uint32_t* f = fields + ((long long)r * kin + c0 + cc) * FIELD_WORDS;
          s_t01[i] = r < mout ? make_uint4(f[0], f[1], f[2], f[3])
                              : make_uint4(0u, 0u, 0u, 0u);
          reinterpret_cast<uint32_t*>(s_t2)[cc * RB + rr] = r < mout ? f[4] : 0u;
        }
        __syncthreads();
      }
      if (!live) continue;
      uint32_t next[VEC];
      io.load(c0, t, next);
#pragma unroll 1
      for (int cc = 0; cc < kc; ++cc) {
        uint32_t w[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) w[v] = next[v];
        if (cc + 1 < kc) io.load(c0 + cc + 1, t, next);
        uint32_t sel[VEC / 2][6];
#pragma unroll
        for (int q = 0; q < VEC / 2; ++q)
          field_selectors(w[2 * q], w[2 * q + 1], sel[q]);
        const uint4 t2v = s_t2[cc];
        const uint32_t t2[RB] = {t2v.x, t2v.y, t2v.z, t2v.w};
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
          const uint4 t01 = s_t01[cc * RB + rr];
#pragma unroll
          for (int q = 0; q < VEC / 2; ++q)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              acc[rr][2 * q + h] ^= prmt(t01.x, t01.y, sel[q][h]) ^
                                    prmt(t01.z, t01.w, sel[q][2 + h]) ^
                                    prmt(t2[rr], t2[rr], sel[q][4 + h]);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        if (r0 + rr >= mout) continue;
        uint32_t o[VEC];
#pragma unroll
        for (int q = 0; q < VEC / 2; ++q) {
          o[2 * q] = __byte_perm(acc[rr][2 * q], acc[rr][2 * q + 1], 0x6420);
          o[2 * q + 1] =
              __byte_perm(acc[rr][2 * q], acc[rr][2 * q + 1], 0x7531);
        }
        io.store(r0 + rr, t, o);
      }
    }
  }
}

// -- gf2_apply_u8: the bit spread ---------------------------------------------

template <class IO>
__global__ void __launch_bounds__(THREADS)
gf2_apply_kernel(const uint32_t* __restrict__ table, IO io, int kin,
                 int mout) {
  __shared__ uint32_t s_tab[RB * KC * 8];
  const int r0 = blockIdx.y * RB;  // this block's output rows
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = t < io.threads_needed();

  uint32_t acc[RB][VEC];
#pragma unroll
  for (int rr = 0; rr < RB; ++rr)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[rr][v] = 0u;

  for (int c0 = 0; c0 < kin; c0 += KC) {
    const int kc = min(KC, kin - c0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < RB * kc * 8; i += blockDim.x) {
      const int rr = i / (kc * 8);
      const int rem = i - rr * (kc * 8);  // cc * 8 + j
      const int r = r0 + rr;
      s_tab[rr * (KC * 8) + rem] =
          r < mout ? table[((long long)r * kin + c0) * 8 + rem] : 0u;
    }
    __syncthreads();
    if (!live) continue;
    for (int cc = 0; cc < kc; ++cc) {
      uint32_t w[VEC];
      io.load(c0 + cc, t, w);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t m[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) m[v] = spread(w[v], j);
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
          const uint32_t col = s_tab[rr * (KC * 8) + cc * 8 + j];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[rr][v] ^= m[v] & col;
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
      if (r0 + rr < mout) io.store(r0 + rr, t, acc[rr]);
  }
}

// The grid of a launch over `threads` threads, `per_block` per block, and
// mout output rows; false when it does not fit.
bool grid_of(long long threads, long long per_block, int mout, dim3* grid) {
  const long long blocks = (threads + per_block - 1) / per_block;
  const int row_blocks = (mout + RB - 1) / RB;
  if (blocks > 0x7fffffffLL || row_blocks > 65535) return false;
  *grid = dim3(static_cast<unsigned>(blocks),
               static_cast<unsigned>(row_blocks));
  return true;
}

// One words launch: `groups` column groups per block when TILED, else one.
template <bool TILED>
int launch_words(const void* fields, const void* in, void* out, int kin,
                 int mout, long long n4, long long in_stride,
                 long long out_stride, int groups, cudaStream_t stream) {
  const WordIO io = word_io(in, out, n4, in_stride, out_stride);
  const long long threads = (n4 + VEC - 1) / VEC;
  if (threads <= 0 || kin <= 0 || mout <= 0) return 0;
  dim3 grid;
  if (!grid_of(threads, (long long)THREADS * groups, mout, &grid))
    return int(cudaErrorInvalidConfiguration);
  gf2_words_kernel<TILED><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(fields), io, kin, mout, groups);
  return int(cudaGetLastError());
}

}  // namespace

// `fields`: (mout, kin, 5) uint32, cuda_kernels.field_tables.
extern "C" int gf2_apply_words(const void* fields, const void* in, void* out,
                               int kin, int mout, long long n4,
                               long long in_stride, long long out_stride,
                               void* stream) {
  return launch_words<false>(fields, in, out, kin, mout, n4, in_stride,
                             out_stride, 1, static_cast<cudaStream_t>(stream));
}

// gf2_apply_words at a given tile: `tile` words of every row per block, a
// positive multiple of THREADS * VEC = 1024 (the Pallas kernel's `tile`
// argument, _pallas_apply_words(..., tile=)).
extern "C" int gf2_apply_words_tiled(const void* fields, const void* in,
                                     void* out, int kin, int mout,
                                     long long n4, long long in_stride,
                                     long long out_stride, int tile,
                                     void* stream) {
  if (tile <= 0 || tile % (THREADS * VEC)) return int(cudaErrorInvalidValue);
  return launch_words<true>(fields, in, out, kin, mout, n4, in_stride,
                            out_stride, tile / (THREADS * VEC),
                            static_cast<cudaStream_t>(stream));
}

// `table`: (mout, kin, 8) uint32, cuda_kernels.column_table.
extern "C" int gf2_apply_u8(const void* table, const void* in, void* out,
                            int kin, int mout, long long seg, long long nseg,
                            long long in_row_stride, long long in_seg_stride,
                            long long out_row_stride, long long out_seg_stride,
                            void* stream) {
  const ByteIO io = byte_io(in, out, seg, nseg, in_row_stride, in_seg_stride,
                            out_row_stride, out_seg_stride);
  const long long threads = (seg * nseg + 4 * VEC - 1) / (4 * VEC);
  if (threads <= 0 || kin <= 0 || mout <= 0) return 0;
  dim3 grid;
  if (!grid_of(threads, THREADS, mout, &grid))
    return int(cudaErrorInvalidConfiguration);
  gf2_apply_kernel<ByteIO><<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), io, kin, mout);
  return int(cudaGetLastError());
}
