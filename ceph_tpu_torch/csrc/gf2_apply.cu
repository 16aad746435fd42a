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
//
// Design (simple and exact; one thread owns VEC=4 consecutive 32-bit words
// = 16 bytes of every row):
//   table[r][c][j] = (sum_i BM[8r+i][8c+j] << i) * 0x01010101   (host-built)
//   spread_j(w)    = ((w >> j) & 0x01010101) * 0xFF  -> 0xFF in each byte
//                    whose bit j is set
//   acc[r]        ^= spread_j(in[c]) & table[r][c][j]      (one LOP3)
// Byte lanes never mix, so the same code serves words and bytes.  Each
// block computes one register block of RB output rows (blockIdx.y), so a
// tall matrix with few columns still fills the card; the table is staged
// through shared memory in chunks of KC input rows, so any (kin, mout)
// works (the w=32 packet matrix is 64 x 128), with XOR accumulation in
// registers across chunks (the TPU kernel's kblk blocking, transposed).
//
// Bound.  Headline encode (k=8, m=4, 16384 stripes x 4 KiB): 64 MiB read +
// 32 MiB written = 100.7 MB, about 30 us at the H100 SXM data-sheet
// 3.35 TB/s; the 4-erasure decode moves the same bytes.  This design spends
// about 3 integer ops per (input word, bit) for the spread plus RB*(1+VEC)
// per (input row, bit) for shared loads and LOP3s: roughly 16 integer
// instructions per input byte at m=4, i.e. 25-35 ops per data byte with
// addressing and the masked edges.  At 64 int32 ops/clk/SM that is
// compute-bound, several times above the memory bound.  An int8 tensor-core
// (mma/wgmma s8->s32) or nibble-table formulation is the later fast design.
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

// TILED: a block covers `groups` column groups of THREADS threads (a tile of
// groups * THREADS * VEC words per row, the Pallas kernel's `tile`) and walks
// them in turn; with one table chunk (kin <= KC) it stages the chunk once for
// all of them.  Untiled (the production launch) a block covers one group.
template <class IO, bool TILED>
__global__ void __launch_bounds__(THREADS)
gf2_apply_kernel(const uint32_t* __restrict__ table, IO io, int kin, int mout,
                 int groups) {
  __shared__ uint32_t s_tab[RB * KC * 8];
  const int r0 = blockIdx.y * RB;  // this block's output rows
  const int ngroups = TILED ? groups : 1;
  for (int g = 0; g < ngroups; ++g) {
    const long long t =
        ((long long)blockIdx.x * ngroups + g) * blockDim.x + threadIdx.x;
    const bool live = t < io.threads_needed();

    uint32_t acc[RB][VEC];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[rr][v] = 0u;

    for (int c0 = 0; c0 < kin; c0 += KC) {
      const int kc = min(KC, kin - c0);
      if (!TILED || g == 0 || kin > KC) {
        __syncthreads();  // previous chunk fully consumed
        for (int i = threadIdx.x; i < RB * kc * 8; i += blockDim.x) {
          const int rr = i / (kc * 8);
          const int rem = i - rr * (kc * 8);  // cc * 8 + j
          const int r = r0 + rr;
          s_tab[rr * (KC * 8) + rem] =
              r < mout ? table[((long long)r * kin + c0) * 8 + rem] : 0u;
        }
        __syncthreads();
      }
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
}

// One launch: `groups` column groups per block when TILED, else one.
template <bool TILED, class IO>
int launch(const uint32_t* table, const IO& io, long long threads, int kin,
           int mout, int groups, cudaStream_t stream) {
  if (threads <= 0 || kin <= 0 || mout <= 0) return 0;
  const long long per_block = (long long)THREADS * (TILED ? groups : 1);
  const long long blocks = (threads + per_block - 1) / per_block;
  const int row_blocks = (mout + RB - 1) / RB;
  if (blocks > 0x7fffffffLL || row_blocks > 65535)
    return int(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(row_blocks));
  gf2_apply_kernel<IO, TILED><<<grid, THREADS, 0, stream>>>(table, io, kin,
                                                            mout, groups);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int gf2_apply_words(const void* table, const void* in, void* out,
                               int kin, int mout, long long n4,
                               long long in_stride, long long out_stride,
                               void* stream) {
  return launch<false>(static_cast<const uint32_t*>(table),
                       word_io(in, out, n4, in_stride, out_stride),
                       (n4 + VEC - 1) / VEC, kin, mout, 1,
                       static_cast<cudaStream_t>(stream));
}

// gf2_apply_words at a given tile: `tile` words of every row per block, a
// positive multiple of THREADS * VEC = 1024 (the Pallas kernel's `tile`
// argument, _pallas_apply_words(..., tile=)).
extern "C" int gf2_apply_words_tiled(const void* table, const void* in,
                                     void* out, int kin, int mout,
                                     long long n4, long long in_stride,
                                     long long out_stride, int tile,
                                     void* stream) {
  if (tile <= 0 || tile % (THREADS * VEC)) return int(cudaErrorInvalidValue);
  return launch<true>(static_cast<const uint32_t*>(table),
                      word_io(in, out, n4, in_stride, out_stride),
                      (n4 + VEC - 1) / VEC, kin, mout, tile / (THREADS * VEC),
                      static_cast<cudaStream_t>(stream));
}

extern "C" int gf2_apply_u8(const void* table, const void* in, void* out,
                            int kin, int mout, long long seg, long long nseg,
                            long long in_row_stride, long long in_seg_stride,
                            long long out_row_stride, long long out_seg_stride,
                            void* stream) {
  return launch<false>(static_cast<const uint32_t*>(table),
                       byte_io(in, out, seg, nseg, in_row_stride,
                               in_seg_stride, out_row_stride, out_seg_stride),
                       (seg * nseg + 4 * VEC - 1) / (4 * VEC), kin, mout, 1,
                       static_cast<cudaStream_t>(stream));
}
