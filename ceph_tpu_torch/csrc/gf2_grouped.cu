// Sparse row-grouped GF(2^8) region apply for Hopper (sm_90a): the repair
// kernels of regenerating (CLAY) and local (LRC) repair operators.
//
// Replaces two Pallas TPU kernels of ceph_tpu/ec/pallas_kernels.py:
//   gf2_apply_grouped        <- _gkernel_fused (:429-451) launched by
//                               _pallas_apply_grouped_fused (:454-475): all
//                               row groups in one launch, each group's
//                               support columns selected from the input.
//   gf2_apply_grouped_paired <- _gkernel (:495-507) launched by
//                               _pallas_apply_grouped (:510-526): each group
//                               over its own host-gathered (cmax, N) rows.
//
// Function.  A sparse (mout x kin) coefficient matrix R is cut into G groups
// of up to 4 rows (GroupedPlan, cuda_kernels.py).  Group g has support
// columns cols[g][0..ncols[g]) and a (4 x cmax) sub-matrix; for each real
// slot s (slot_rows[g][s] >= 0):
//   out[slot_rows[g][s]] = XOR_c  sub[g][s][c] * in[cols[g][c]]   over GF(2^8)
// byte column by byte column.  The paired kernel reads row g*cmax + c of the
// gathered input instead of row cols[g][c].  Each output row belongs to
// exactly one slot, so the kernels write caller rows directly: the TPU
// applier's out[plan.gather_rows] reorder copy is gone, and padding slots
// (short groups, the pair-padding group) write nothing.
//
// Design (the dense kernel's, gf2_apply.cu, per group; one thread owns
// VEC=4 words = 16 bytes of every row):
//   table[g][s][c][j] = (sum_i BM_g[8s+i][8c+j] << i) * 0x01010101
//   acc[s] ^= spread_j(in[col]) & table[g][s][c][j]
// with the group's table staged through shared memory KC columns at a time.
// Padding columns (c >= ncols[g]) are never visited.
//
// Reading the input once.  One block computes one group over one
// 4096-byte column tile, and the grid is ordered group-fastest
// (blockIdx.x = tile * G + g), so the G blocks of a tile are issued
// together and share its rows through L2: the first to touch a helper row
// brings it from HBM, the others read it from L2.  (Looping over groups
// inside a thread would re-read from L2 just the same, but gives the
// headline only 128 blocks for 132 SMs.)  The DRAM bytes actually read are
// not measured (no ncu on the card's machine).
//
// Bound.  Headline CLAY k=8 m=4 d=11 repair of chunk 3, 512 stripes x
// 64 KiB chunks (sc = 1024): R is 64 x 176 with G=16 groups, cmax=24 and
// 272 support columns in all (sum of ncols).  Bytes: 92,274,688 in +
// 33,554,432 out = 37.6 us at 3.35 TB/s.  Operations, counted as the
// grouped bit-plane contraction over the real supports on int8 tensor
// cores: 2 * 32 * 8 * 272 * 524,288 = 7.3e10 = 36.9 us at 1,979 TOP/s.
// So the bound is bytes, 37.6 us (chip_smoke.py computes it from the run).
// This design issues, per (group, support column, bit) and thread, 3*VEC
// integer ops for the spread and GRP*VEC LOP3s, 28 in all: 32,768 threads
// x 272 x 8 x 28 = 2.0e9 integer instructions.  The dense kernel ran at
// about 1.4e13 of them per second (B1 at the jax_rs headline), so:
// Prediction, written before the first run on the card: B3 takes about
// 145 us at the headline, 26% of the 37.6 us bound, issue-bound like the
// dense kernels; the dense kernel on the same R (16 row blocks x 176
// columns, 7.6x the instructions) takes about 1.5 ms.
// B4 at CLAY k=16 m=4 d=19, repair of chunk 16, 1024 stripes x 16 KiB
// chunks (sc = 16): 256 groups, cmax=32, 7936 support columns; the rows
// read are 7936 x 16,384 B = 130,023,424 B, the output 16,777,216 B: 43.8 us
// at 3.35 TB/s; operations 2*32*8*7936*16,384 = 6.7e10 = 33.6 us; bound by
// bytes.  1,024 threads per group x 7936 x 8 x 28 = 1.8e9 instructions:
// prediction, written before the first run: about 130 us, 34% of bound.
// Measured after it (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W):
// B3 154.4 us on the (176, N) bytes, 24.3% of bound (129.8 us on the
// words, 28.9%); the dense kernel on the same R 1396.5 us, 9.0x B3; B4
// 141.6 us, 31.2% of bound.  Issue-bound as predicted, 6-9% slower than
// the instruction count at the dense kernel's rate.
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

constexpr int GRP = 4;       // output rows (slots) per group
constexpr int KC = 32;       // support columns per shared-memory chunk
constexpr int THREADS = 256;

template <class IO, bool GATHERED>
__global__ void __launch_bounds__(THREADS)
gf2_grouped_kernel(const uint32_t* __restrict__ table,   // (G, GRP, cmax, 8)
                   const int* __restrict__ cols,         // (G, cmax)
                   const int* __restrict__ ncols,        // (G,)
                   const int* __restrict__ slot_rows,    // (G, GRP), -1 = none
                   IO io, int G, int cmax) {
  __shared__ uint32_t s_tab[GRP * KC * 8];
  __shared__ int s_row[KC];
  const int g = blockIdx.x % G;
  const long long tile = blockIdx.x / G;
  const long long t = tile * blockDim.x + threadIdx.x;
  const bool live = t < io.threads_needed();
  const int nc = ncols[g];

  uint32_t acc[GRP][VEC];
#pragma unroll
  for (int s = 0; s < GRP; ++s)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[s][v] = 0u;

  for (int c0 = 0; c0 < nc; c0 += KC) {
    const int kc = min(KC, nc - c0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < GRP * kc * 8; i += blockDim.x) {
      const int s = i / (kc * 8);
      const int rem = i - s * (kc * 8);  // cc * 8 + j
      s_tab[s * (KC * 8) + rem] =
          table[((static_cast<long long>(g) * GRP + s) * cmax + c0) * 8 + rem];
    }
    for (int cc = threadIdx.x; cc < kc; cc += blockDim.x)
      s_row[cc] = GATHERED ? g * cmax + c0 + cc : cols[g * cmax + c0 + cc];
    __syncthreads();
    if (!live) continue;
    for (int cc = 0; cc < kc; ++cc) {
      uint32_t w[VEC];
      io.load(s_row[cc], t, w);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t m[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) m[v] = spread(w[v], j);
#pragma unroll
        for (int s = 0; s < GRP; ++s) {
          const uint32_t col = s_tab[s * (KC * 8) + cc * 8 + j];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[s][v] ^= m[v] & col;
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < GRP; ++s) {
      const int r = slot_rows[g * GRP + s];
      if (r >= 0) io.store(r, t, acc[s]);
    }
  }
}

template <bool GATHERED, class IO>
int launch(const void* table, const void* cols, const void* ncols,
           const void* slot_rows, const IO& io, long long threads, int G,
           int cmax, cudaStream_t stream) {
  if (threads <= 0 || G <= 0) return 0;
  const long long tiles = (threads + THREADS - 1) / THREADS;
  if (tiles * G > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  gf2_grouped_kernel<IO, GATHERED>
      <<<static_cast<unsigned>(tiles * G), THREADS, 0, stream>>>(
          static_cast<const uint32_t*>(table), static_cast<const int*>(cols),
          static_cast<const int*>(ncols), static_cast<const int*>(slot_rows),
          io, G, cmax);
  return int(cudaGetLastError());
}

template <bool GATHERED>
int grouped_words(const void* table, const void* cols, const void* ncols,
                  const void* slot_rows, int G, int cmax, const void* in,
                  void* out, long long n4, long long in_stride,
                  long long out_stride, void* stream) {
  const WordIO io = word_io(in, out, n4, in_stride, out_stride);
  return launch<GATHERED>(table, cols, ncols, slot_rows, io,
                          (n4 + VEC - 1) / VEC, G, cmax,
                          static_cast<cudaStream_t>(stream));
}

template <bool GATHERED>
int grouped_u8(const void* table, const void* cols, const void* ncols,
               const void* slot_rows, int G, int cmax, const void* in,
               void* out, long long seg, long long nseg,
               long long in_row_stride, long long in_seg_stride,
               long long out_row_stride, long long out_seg_stride,
               void* stream) {
  const ByteIO io = byte_io(in, out, seg, nseg, in_row_stride, in_seg_stride,
                            out_row_stride, out_seg_stride);
  return launch<GATHERED>(table, cols, ncols, slot_rows, io,
                          (seg * nseg + 4 * VEC - 1) / (4 * VEC), G, cmax,
                          static_cast<cudaStream_t>(stream));
}

}  // namespace

// B3: input rows are the caller's (kin, ...) rows, selected through cols.
extern "C" int gf2_apply_grouped_words(
    const void* table, const void* cols, const void* ncols,
    const void* slot_rows, int G, int cmax, const void* in, void* out,
    long long n4, long long in_stride, long long out_stride, void* stream) {
  return grouped_words<false>(table, cols, ncols, slot_rows, G, cmax, in, out,
                              n4, in_stride, out_stride, stream);
}

extern "C" int gf2_apply_grouped_u8(
    const void* table, const void* cols, const void* ncols,
    const void* slot_rows, int G, int cmax, const void* in, void* out,
    long long seg, long long nseg, long long in_row_stride,
    long long in_seg_stride, long long out_row_stride,
    long long out_seg_stride, void* stream) {
  return grouped_u8<false>(table, cols, ncols, slot_rows, G, cmax, in, out,
                           seg, nseg, in_row_stride, in_seg_stride,
                           out_row_stride, out_seg_stride, stream);
}

// B4: input rows are the gathered (G * cmax, ...) rows, group g at
// rows [g * cmax, (g + 1) * cmax); cols is not read.
extern "C" int gf2_apply_grouped_paired_words(
    const void* table, const void* ncols, const void* slot_rows, int G,
    int cmax, const void* in, void* out, long long n4, long long in_stride,
    long long out_stride, void* stream) {
  return grouped_words<true>(table, nullptr, ncols, slot_rows, G, cmax, in,
                             out, n4, in_stride, out_stride, stream);
}

extern "C" int gf2_apply_grouped_paired_u8(
    const void* table, const void* ncols, const void* slot_rows, int G,
    int cmax, const void* in, void* out, long long seg, long long nseg,
    long long in_row_stride, long long in_seg_stride,
    long long out_row_stride, long long out_seg_stride, void* stream) {
  return grouped_u8<true>(table, nullptr, ncols, slot_rows, G, cmax, in, out,
                          seg, nseg, in_row_stride, in_seg_stride,
                          out_row_stride, out_seg_stride, stream);
}
