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
// Design: the dense kernel's field tables (gf2_apply.cu), per group.  A
// group's (4 x cmax) sub-matrix is a dense 4-row matrix over its support
// rows, so its 8x8 blocks become the 5-word prmt tables of
// cuda_kernels.field_tables ((G, 4, cmax, 5), GroupedPlan.fields), staged
// through shared memory KC support columns at a time in the dense kernel's
// layout; the 4 slots are the dense kernel's RB = 4 output rows.  Per
// support row and thread, the six selectors of each word pair are computed
// once for the 4 slots, then per slot 3 prmt and about 2 LOP3 per word
// (gf2_io.cuh apply_fields), two support rows per iteration, each loaded
// while the one before it is applied (apply_chunk_pairs).  Padding columns
// (c >= ncols[g]) are never visited.  Each thread finds its 16 bytes'
// place once (gf2_io.cuh's unit) and picks its path once: interior units
// run a row loop of one LDG.128 per support row and no byte-by-byte code,
// so the (B, kin, sc) batch's segment arithmetic leaves the loop; the
// ragged or unaligned edge runs its own loop.  Also built and timed on the
// card, and not faster: B1's one loop that tests the unit per row, and
// skipping a slot whose 8x8 block is zero, whose branches cost what the
// skipped lookups saved.
//
// Reading the input once.  One block computes one group over one
// 4096-byte column tile, and the grid is ordered group-fastest
// (blockIdx.x = tile * G + g), so the G blocks of a tile are issued
// together and share its rows through L2: the first to touch a helper row
// brings it from HBM, the others read it from L2.  (Looping over groups
// inside a thread would re-read from L2 just the same, but gives the
// headline only 128 blocks for 132 SMs; it would also need every group's
// accumulators at once.)  The DRAM bytes actually read are not measured
// (no ncu on the card's machine).
//
// Bound.  Headline CLAY k=8 m=4 d=11 repair of chunk 3, 512 stripes x
// 64 KiB chunks (sc = 1024): R is 64 x 176 with G=16 groups, cmax=24 and
// 272 support columns in all (sum of ncols).  Bytes: 92,274,688 in +
// 33,554,432 out = 37.6 us at 3.35 TB/s.  Operations, counted as the
// grouped bit-plane contraction over the real supports on int8 tensor
// cores: 2 * 32 * 8 * 272 * 524,288 = 7.3e10 = 36.9 us at 1,979 TOP/s.
// So the bound is bytes, 37.6 us (chip_smoke.py computes it from the run).
// B4 at CLAY k=16 m=4 d=19, repair of chunk 16, 1024 stripes x 16 KiB
// chunks (sc = 16): 256 groups, cmax=32, 7936 support columns; the rows
// read are 7936 x 16,384 B = 130,023,424 B, the output 16,777,216 B: 43.8 us
// at 3.35 TB/s; operations 2*32*8*7936*16,384 = 6.7e10 = 33.6 us; bound by
// bytes.
// The bit-spread design this replaced issued 3*VEC + GRP*VEC integer
// instructions per (group, support column, bit) and thread, and read each
// row through a per-byte-capable load with a 64-bit division: B3 157.17 us
// on the CLAY k=8 repair's (176, N) streams, 23.9% of bound, B4 143.19 us,
// 30.8% (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W).
// Prediction, written before the first run of this design on the card:
// the unit of (group, support column) is B1's unit of 4 words x 4 output
// rows, 167 SASS instructions in B1's loop (less here, the loop being
// interior-only): 272 x 32,768 threads x 167 / 32 = 46.5 M
// warp-instructions, about 89 us at the 523 G warp-instructions per second
// B1 reached; B3 at the headline batch about 70-90 us, 42-54% of its
// 37.6 us bound, still issue-bound (its bytes take 46 us at the measured
// 2.735 TB/s copy ceiling).  B4: 7936 x 1,024 x 167 / 32 = 42.4 M
// warp-instructions, about 65-85 us.
// Measured after it (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W):
// B3 78.37 us on the (B, 176, sc) batch, 47.9% of bound, and 76.58 us on
// the (176, N) streams the bit spread took 157.17 on (0.487x); the row
// loop is 260 SASS instructions per 2 support rows (32.5 per input word
// and group), 80 registers.  B4 87.16 us, 50.5% of bound, 0.609x: over its
// prediction, and not issue-bound (the same loop issues at 0.82x B3's
// rate there).
//
// Launches run on the caller's stream, allocate nothing and do not
// synchronise; each entry returns cudaGetLastError() of its launch.

#include "gf2_io.cuh"

namespace {

using gf2::ByteIO;
using gf2::FIELD_WORDS;
using gf2::Path;
using gf2::VEC;
using gf2::WordIO;
using gf2::apply_chunk_pairs;
using gf2::byte_io;
using gf2::deinterleave;
using gf2::word_io;

constexpr int GRP = gf2::FIELD_ROWS;  // output rows (slots) per group
constexpr int KC = 32;       // support columns per shared-memory chunk
constexpr int THREADS = 256;

// Support row cc of the current chunk, as staged in shared memory.
struct StagedRows {
  const int* s_row;
  __device__ __forceinline__ int operator()(int cc) const { return s_row[cc]; }
};

template <class IO, bool GATHERED>
__global__ void __launch_bounds__(THREADS)
gf2_grouped_kernel(const uint32_t* __restrict__ fields,  // (G, GRP, cmax, 5)
                   const int* __restrict__ cols,         // (G, cmax)
                   const int* __restrict__ ncols,        // (G,)
                   const int* __restrict__ slot_rows,    // (G, GRP), -1 = none
                   IO io, int G, int cmax) {
  // s_t01[cc * GRP + s] = (T0 lo, T0 hi, T1 lo, T1 hi) of (slot s, support
  // column c0 + cc); s_t2[cc] = T2 of the 4 slots; s_row[cc] its input row.
  __shared__ uint4 s_t01[KC * GRP];
  __shared__ uint4 s_t2[KC];
  __shared__ int s_row[KC];
  const int g = blockIdx.x % G;
  const long long tile = blockIdx.x / G;
  const long long t = tile * blockDim.x + threadIdx.x;
  const bool live = t < io.threads_needed();
  const auto u = io.unit(t);
  const int nc = ncols[g];

  uint32_t acc[GRP][VEC];
#pragma unroll
  for (int s = 0; s < GRP; ++s)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[s][v] = 0u;

  for (int c0 = 0; c0 < nc; c0 += KC) {
    const int kc = min(KC, nc - c0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < kc * GRP; i += blockDim.x) {
      const int cc = i / GRP, s = i - cc * GRP;
      const uint32_t* f =
          fields + ((static_cast<long long>(g) * GRP + s) * cmax + c0 + cc) *
                       FIELD_WORDS;
      s_t01[i] = make_uint4(f[0], f[1], f[2], f[3]);
      reinterpret_cast<uint32_t*>(s_t2)[i] = f[4];
    }
    for (int cc = threadIdx.x; cc < kc; cc += blockDim.x)
      s_row[cc] = GATHERED ? g * cmax + c0 + cc : cols[g * cmax + c0 + cc];
    __syncthreads();
    if (!live) continue;
    const StagedRows rows{s_row};
    if (u.vec) apply_chunk_pairs<Path::kVec>(u, kc, rows, s_t01, s_t2, acc);
    else apply_chunk_pairs<Path::kEdge>(u, kc, rows, s_t01, s_t2, acc);
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < GRP; ++s) {
      const int r = slot_rows[g * GRP + s];
      if (r < 0) continue;
      uint32_t o[VEC];
      deinterleave(acc[s], o);
      u.store(r, o);
    }
  }
}

template <bool GATHERED, class IO>
int launch(const void* fields, const void* cols, const void* ncols,
           const void* slot_rows, const IO& io, int G, int cmax,
           cudaStream_t stream) {
  const long long threads = io.threads_needed();
  if (threads <= 0 || G <= 0) return 0;
  const long long tiles = (threads + THREADS - 1) / THREADS;
  if (tiles * G > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  gf2_grouped_kernel<IO, GATHERED>
      <<<static_cast<unsigned>(tiles * G), THREADS, 0, stream>>>(
          static_cast<const uint32_t*>(fields), static_cast<const int*>(cols),
          static_cast<const int*>(ncols), static_cast<const int*>(slot_rows),
          io, G, cmax);
  return int(cudaGetLastError());
}

template <bool GATHERED>
int grouped_words(const void* fields, const void* cols, const void* ncols,
                  const void* slot_rows, int G, int cmax, const void* in,
                  void* out, long long n4, long long in_stride,
                  long long out_stride, void* stream) {
  const WordIO io = word_io(in, out, n4, in_stride, out_stride);
  return launch<GATHERED>(fields, cols, ncols, slot_rows, io, G, cmax,
                          static_cast<cudaStream_t>(stream));
}

template <bool GATHERED>
int grouped_u8(const void* fields, const void* cols, const void* ncols,
               const void* slot_rows, int G, int cmax, const void* in,
               void* out, long long seg, long long nseg,
               long long in_row_stride, long long in_seg_stride,
               long long out_row_stride, long long out_seg_stride,
               void* stream) {
  const ByteIO io = byte_io(in, out, seg, nseg, in_row_stride, in_seg_stride,
                            out_row_stride, out_seg_stride);
  return launch<GATHERED>(fields, cols, ncols, slot_rows, io, G, cmax,
                          static_cast<cudaStream_t>(stream));
}

}  // namespace

// `fields`: (G, 4, cmax, 5) uint32, GroupedPlan.fields.
// B3: input rows are the caller's (kin, ...) rows, selected through cols.
extern "C" int gf2_apply_grouped_words(
    const void* fields, const void* cols, const void* ncols,
    const void* slot_rows, int G, int cmax, const void* in, void* out,
    long long n4, long long in_stride, long long out_stride, void* stream) {
  return grouped_words<false>(fields, cols, ncols, slot_rows, G, cmax, in, out,
                              n4, in_stride, out_stride, stream);
}

extern "C" int gf2_apply_grouped_u8(
    const void* fields, const void* cols, const void* ncols,
    const void* slot_rows, int G, int cmax, const void* in, void* out,
    long long seg, long long nseg, long long in_row_stride,
    long long in_seg_stride, long long out_row_stride,
    long long out_seg_stride, void* stream) {
  return grouped_u8<false>(fields, cols, ncols, slot_rows, G, cmax, in, out,
                           seg, nseg, in_row_stride, in_seg_stride,
                           out_row_stride, out_seg_stride, stream);
}

// B4: input rows are the gathered (G * cmax, ...) rows, group g at
// rows [g * cmax, (g + 1) * cmax); cols is not read.
extern "C" int gf2_apply_grouped_paired_words(
    const void* fields, const void* ncols, const void* slot_rows, int G,
    int cmax, const void* in, void* out, long long n4, long long in_stride,
    long long out_stride, void* stream) {
  return grouped_words<true>(fields, nullptr, ncols, slot_rows, G, cmax, in,
                             out, n4, in_stride, out_stride, stream);
}

extern "C" int gf2_apply_grouped_paired_u8(
    const void* fields, const void* ncols, const void* slot_rows, int G,
    int cmax, const void* in, void* out, long long seg, long long nseg,
    long long in_row_stride, long long in_seg_stride,
    long long out_row_stride, long long out_seg_stride, void* stream) {
  return grouped_u8<true>(fields, nullptr, ncols, slot_rows, G, cmax, in, out,
                          seg, nseg, in_row_stride, in_seg_stride,
                          out_row_stride, out_seg_stride, stream);
}
