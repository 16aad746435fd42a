// Shared device code of the port's GF(2) region-apply kernels
// (gf2_apply.cu, gf2_grouped.cu, gf2_variants.cu): the two views of the
// data a thread reads and writes 16 bytes at a time, the field-table step
// and the dense field-table kernel (B1, B2 and the split2 variants B5b,
// B5c) built on them.
//
//   WordIO       (rows, n4) int32 lane words, any row stride.
//   ByteIO       (rows, N) byte streams, or a (B, rows, C) stripe batch as
//                B segments of length C, any row and segment strides.
// A view hands each thread its unit (io.unit(t)): where the thread's 16
// bytes lie, found once, before any row is read.  After that a row is one
// c * row_stride away, whatever the layout: the segment arithmetic (one
// 64-bit division for ByteIO) runs once per unit, not once per row.  A
// unit reads and writes rows by index, so a kernel may read rows in any
// order (the grouped kernels read each group's support rows).
//
// Each unit has two paths.  An interior unit (`vec`: all 16 bytes inside
// the data and inside one segment, 16-byte aligned) takes one LDG.128 /
// STG.128 per row and nothing else (load_vec, store_vec).  The ragged
// edge, a segment boundary or an unaligned base takes the edge path
// (load_edge, store_edge): word by word for WordIO; byte by byte for
// ByteIO, walking from the unit's first byte and stepping to the next
// segment's row when it meets the end of one, with no division.  A kernel
// that wants an interior-only row loop picks the path once per thread
// (Path::kVec or kEdge, see load_row); load / store (Path::kAny) test
// `vec` per call, for kernels that keep one loop and for the stores after
// it.
//
//   apply_fields      the field-table step (gf2_apply.cu's header note):
//                     one input row's VEC words looked up with prmt in the
//                     byte tables of 4 output rows, XORed into interleaved
//                     accumulators; deinterleave undoes the interleave.
//   gf2_words_kernel  the dense kernel: tables staged through shared
//                     memory in chunks of FIELD_KC input rows, HALVES units
//                     per thread (1 for B1/B2, 2 for the split2 variants,
//                     FIELD_THREADS units apart), launched by launch_fields.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace gf2 {

constexpr int VEC = 4;          // 32-bit words per thread (16 bytes)
constexpr int FIELD_ROWS = 4;   // output rows of one apply_fields step
constexpr int FIELD_WORDS = 5;  // T0 (2 words), T1 (2), T2 (1) per (r, c)

static_assert(VEC % 2 == 0, "words are read in pairs");

// -- the two views --------------------------------------------------------

// One thread's VEC words of every row of a WordIO view, from word w0.
struct WordUnit {
  const uint32_t* in;  // row 0, word w0
  uint32_t* out;
  long long in_stride;
  long long out_stride;
  int n;               // words of the unit inside the row, at most VEC
  bool vec;            // n == VEC and 16-byte access allowed

  __device__ __forceinline__ void load_vec(int c, uint32_t (&w)[VEC]) const {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(in + c * in_stride));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }

  __device__ __forceinline__ void load_edge(int c, uint32_t (&w)[VEC]) const {
    const uint32_t* p = in + c * in_stride;
#pragma unroll
    for (int v = 0; v < VEC; ++v) w[v] = v < n ? __ldg(p + v) : 0u;
  }

  __device__ __forceinline__ void store_vec(int r, const uint32_t (&w)[VEC]) const {
    *reinterpret_cast<uint4*>(out + r * out_stride) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }

  __device__ __forceinline__ void store_edge(int r, const uint32_t (&w)[VEC]) const {
    uint32_t* p = out + r * out_stride;
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      if (v < n) p[v] = w[v];
  }

  __device__ __forceinline__ void load(int c, uint32_t (&w)[VEC]) const {
    if (vec) load_vec(c, w); else load_edge(c, w);
  }

  __device__ __forceinline__ void store(int r, const uint32_t (&w)[VEC]) const {
    if (vec) store_vec(r, w); else store_edge(r, w);
  }
};

// (rows, n4) int32 words, row stride in words.
struct WordIO {
  const uint32_t* in;
  uint32_t* out;
  long long n4;
  long long in_stride;
  long long out_stride;
  bool vec_ok;  // base pointers 16-byte aligned and strides multiples of 4

  __device__ __forceinline__ WordUnit unit(long long t) const {
    const long long w0 = t * VEC;
    const long long left = n4 - w0;
    WordUnit u;
    u.in = in + w0;
    u.out = out + w0;
    u.in_stride = in_stride;
    u.out_stride = out_stride;
    u.n = left < VEC ? int(left) : VEC;
    u.vec = vec_ok && u.n == VEC;
    return u;
  }

  __host__ __device__ long long threads_needed() const {
    return (n4 + VEC - 1) / VEC;
  }
};

// One thread's 16 bytes of every row of a ByteIO view: virtual columns
// x0 .. x0+15, the first of them byte `off` of segment x0 / seg.
struct ByteUnit {
  const uint8_t* in;   // row 0 of the unit's first byte
  uint8_t* out;
  long long in_row;    // row strides
  long long out_row;
  long long seg;       // segment length and strides, for the edge walk
  long long in_seg;
  long long out_seg;
  long long off;
  int n;               // bytes of the unit before the end of the data
  bool vec;            // whole unit in one segment, 16-byte access allowed

  __device__ __forceinline__ void load_vec(int c, uint32_t (&w)[VEC]) const {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(in + c * in_row));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }

  __device__ __forceinline__ void store_vec(int r, const uint32_t (&w)[VEC]) const {
    *reinterpret_cast<uint4*>(out + r * out_row) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }

  // Byte b of the unit lies at p_b = p_{b-1} + 1 inside a segment; at the
  // end of one the walk goes to the same row of the next segment, whose
  // first byte is p_{b-1} + 1 - seg + seg_stride.  The walk is a loop, not
  // unrolled, and packs the bytes into two 64-bit halves: unrolled, the
  // compiler keeps 16 byte addresses live across the row loop, which
  // doubled the kernels' registers and halved their occupancy.
  __device__ __forceinline__ void load_edge(int c, uint32_t (&w)[VEC]) const {
    const uint8_t* p = in + c * in_row;
    long long o = off;
    unsigned long long lo = 0, hi = 0;
#pragma unroll 1
    for (int b = 0; b < n; ++b) {
      const unsigned long long byte = __ldg(p);
      if (b < 8) lo |= byte << (8 * b);
      else hi |= byte << (8 * (b - 8));
      ++p;
      if (++o == seg) { o = 0; p += in_seg - seg; }
    }
    w[0] = uint32_t(lo); w[1] = uint32_t(lo >> 32);
    w[2] = uint32_t(hi); w[3] = uint32_t(hi >> 32);
  }

  __device__ __forceinline__ void store_edge(int r, const uint32_t (&w)[VEC]) const {
    uint8_t* p = out + r * out_row;
    long long o = off;
    const unsigned long long lo = w[0] | (static_cast<unsigned long long>(w[1]) << 32);
    const unsigned long long hi = w[2] | (static_cast<unsigned long long>(w[3]) << 32);
#pragma unroll 1
    for (int b = 0; b < n; ++b) {
      *p = uint8_t(b < 8 ? lo >> (8 * b) : hi >> (8 * (b - 8)));
      ++p;
      if (++o == seg) { o = 0; p += out_seg - seg; }
    }
  }

  __device__ __forceinline__ void load(int c, uint32_t (&w)[VEC]) const {
    if (vec) load_vec(c, w); else load_edge(c, w);
  }

  __device__ __forceinline__ void store(int r, const uint32_t (&w)[VEC]) const {
    if (vec) store_vec(r, w); else store_edge(r, w);
  }
};

// Byte streams in segments: virtual column x (0 <= x < nseg*seg) is byte
// x % seg of segment x / seg.  Row c of segment s starts at
// in + s*in_seg_stride + c*in_row_stride.  (kin, N) streams are one segment
// of length N; a (B, kin, C) stripe batch is B segments of length C.
struct ByteIO {
  const uint8_t* in;
  uint8_t* out;
  long long seg;
  long long nseg;
  long long in_row_stride;
  long long in_seg_stride;
  long long out_row_stride;
  long long out_seg_stride;
  bool vec_ok;  // 16-byte aligned bases/strides and seg % 16 == 0

  __host__ __device__ long long total() const { return seg * nseg; }

  __device__ __forceinline__ ByteUnit unit(long long t) const {
    const long long x0 = t * (4 * VEC);
    const long long s = x0 / seg;  // the thread's one division
    const long long left = total() - x0;
    ByteUnit u;
    u.off = x0 - s * seg;
    u.in = in + s * in_seg_stride + u.off;
    u.out = out + s * out_seg_stride + u.off;
    u.in_row = in_row_stride;
    u.out_row = out_row_stride;
    u.seg = seg;
    u.in_seg = in_seg_stride;
    u.out_seg = out_seg_stride;
    u.n = left < 4 * VEC ? int(left) : 4 * VEC;
    u.vec = vec_ok && u.n == 4 * VEC;  // seg % 16 == 0: one segment
    return u;
  }

  __host__ __device__ long long threads_needed() const {
    return (total() + 4 * VEC - 1) / (4 * VEC);
  }
};

// Which path a row loop takes through a unit: the interior path only, the
// edge path only, or a test of `vec` per row.
enum class Path { kAny, kVec, kEdge };

template <Path P, class Unit>
__device__ __forceinline__ void load_row(const Unit& u, int c,
                                         uint32_t (&w)[VEC]) {
  if (P == Path::kVec) u.load_vec(c, w);
  else if (P == Path::kEdge) u.load_edge(c, w);
  else u.load(c, w);
}

// -- the field-table step --------------------------------------------------

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

// One input row's words w applied to FIELD_ROWS output rows: t01[rr] =
// (T0 lo, T0 hi, T1 lo, T1 hi) of row rr, t2v = T2 of the 4 rows.
// acc[rr][2q + h] holds pair q (words 2q, 2q+1), lanes 2h and 2h+1.
__device__ __forceinline__ void apply_fields(const uint32_t (&w)[VEC],
                                             const uint4* t01, uint4 t2v,
                                             uint32_t (&acc)[FIELD_ROWS][VEC]) {
  uint32_t sel[VEC / 2][6];
#pragma unroll
  for (int q = 0; q < VEC / 2; ++q)
    field_selectors(w[2 * q], w[2 * q + 1], sel[q]);
  const uint32_t t2[FIELD_ROWS] = {t2v.x, t2v.y, t2v.z, t2v.w};
#pragma unroll
  for (int rr = 0; rr < FIELD_ROWS; ++rr) {
    const uint4 t = t01[rr];
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        acc[rr][2 * q + h] ^= prmt(t.x, t.y, sel[q][h]) ^
                              prmt(t.z, t.w, sel[q][2 + h]) ^
                              prmt(t2[rr], t2[rr], sel[q][4 + h]);
  }
}

// The words of one output row, in order, from its interleaved accumulators.
__device__ __forceinline__ void deinterleave(const uint32_t (&acc)[VEC],
                                             uint32_t (&o)[VEC]) {
#pragma unroll
  for (int q = 0; q < VEC / 2; ++q) {
    o[2 * q] = __byte_perm(acc[2 * q], acc[2 * q + 1], 0x6420);
    o[2 * q + 1] = __byte_perm(acc[2 * q], acc[2 * q + 1], 0x7531);
  }
}

// The rows of one staged table chunk: entry cc reads input row row(cc)
// and applies s_t01[cc * FIELD_ROWS ..] / s_t2[cc]; the next row's words
// are loaded while the current one is applied.
template <Path P, class Unit, class RowOf>
__device__ __forceinline__ void apply_chunk(const Unit& u, int kc, RowOf row,
                                            const uint4* s_t01,
                                            const uint4* s_t2,
                                            uint32_t (&acc)[FIELD_ROWS][VEC]) {
  uint32_t next[VEC];
  load_row<P>(u, row(0), next);
#pragma unroll 1
  for (int cc = 0; cc < kc; ++cc) {
    uint32_t w[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) w[v] = next[v];
    if (cc + 1 < kc) load_row<P>(u, row(cc + 1), next);
    apply_fields(w, s_t01 + cc * FIELD_ROWS, s_t2[cc], acc);
  }
}

// apply_chunk two rows per iteration, ping-ponging the prefetch registers
// instead of copying them: row cc is applied while row cc+1 loads, then
// row cc+1 while cc+2 loads.  The interior-only loops of B2, B3 and B4
// run it (fewer moves and a longer XOR chain per iteration: 130 SASS
// instructions per row against 145 for B3, and 2-4% faster on the card);
// B1's loop, which tests the unit per row, ran 10 us slower with it.
template <Path P, class Unit, class RowOf>
__device__ __forceinline__ void apply_chunk_pairs(
    const Unit& u, int kc, RowOf row, const uint4* s_t01, const uint4* s_t2,
    uint32_t (&acc)[FIELD_ROWS][VEC]) {
  uint32_t x[VEC], y[VEC];
  load_row<P>(u, row(0), x);
  int cc = 0;
#pragma unroll 1
  for (; cc + 1 < kc; cc += 2) {
    load_row<P>(u, row(cc + 1), y);
    apply_fields(x, s_t01 + cc * FIELD_ROWS, s_t2[cc], acc);
    if (cc + 2 < kc) load_row<P>(u, row(cc + 2), x);
    apply_fields(y, s_t01 + (cc + 1) * FIELD_ROWS, s_t2[cc + 1], acc);
  }
  if (cc < kc) apply_fields(x, s_t01 + cc * FIELD_ROWS, s_t2[cc], acc);
}

// apply_chunk over the H units of one thread (the split2 kernels: two
// units FIELD_THREADS apart): per input row, every unit's next row is
// loaded first, then the current row is applied to each unit in turn, so
// each unit's XOR chain covers the others' loads and all loads of a row are
// issued before any chain that consumes it.
template <Path P, int H, class Unit, class RowOf>
__device__ __forceinline__ void apply_chunk_units(
    const Unit (&u)[H], int kc, RowOf row, const uint4* s_t01,
    const uint4* s_t2, uint32_t (&acc)[H][FIELD_ROWS][VEC]) {
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
}

// -- the dense field-table kernel ------------------------------------------

constexpr int FIELD_THREADS = 256;  // threads per block
constexpr int FIELD_KC = 32;        // input rows per shared-memory table chunk

// Input row c0 + cc of the current chunk.
struct ChunkRows {
  int c0;
  __device__ __forceinline__ int operator()(int cc) const { return c0 + cc; }
};

// A thread's units t, t + blockDim.x, ... of a view, built in place as one
// const array: filled element by element, the array cost B1's row loop 5
// instructions (its row-stride product no longer hoisted above the vec /
// edge branch).
template <class Unit, int H>
struct Units {
  Unit u[H];
};

template <class IO, size_t... I>
__device__ __forceinline__ Units<decltype(((IO*)0)->unit(0)), sizeof...(I)>
units_of(const IO& io, long long t, std::index_sequence<I...>) {
  return {{io.unit(t + (long long)I * blockDim.x)...}};
}

// out[r] = XOR_c A[r][c] * in[c] from the (mout, kin, FIELD_WORDS) field
// tables, FIELD_ROWS output rows per block (blockIdx.y).
// TILED: a block covers `groups` column groups of FIELD_THREADS threads (a
// tile of groups * FIELD_THREADS * VEC words per row, the Pallas kernel's
// `tile`) and walks them in turn; with one table chunk (kin <= FIELD_KC) it
// stages the chunk once for all of them.  Untiled a block covers one group.
// HALVES: units per thread.  A group of HALVES * FIELD_THREADS units gives
// thread t units t, t + FIELD_THREADS, ...; a unit past the data is dead
// (no load, no store; the later halves lie further out).
// SPLIT: each thread picks its path once (an interior-only row loop when all
// its units are `vec`, else an edge loop: kEdge for one unit, kAny for
// several, since only the data's and the segments' edges reach it);
// otherwise one loop tests each unit per row.
template <class IO, bool TILED, bool SPLIT, int HALVES>
__global__ void __launch_bounds__(FIELD_THREADS)
gf2_words_kernel(const uint32_t* __restrict__ fields, IO io, int kin,
                 int mout, int groups) {
  // s_t01[cc * FIELD_ROWS + rr] = (T0 lo, T0 hi, T1 lo, T1 hi) of
  // (r0 + rr, c0 + cc); s_t2[cc] = T2 of the FIELD_ROWS rows.  Zero for
  // rows past mout.
  __shared__ uint4 s_t01[FIELD_KC * FIELD_ROWS];
  __shared__ uint4 s_t2[FIELD_KC];
  const int r0 = blockIdx.y * FIELD_ROWS;
  const int ngroups = TILED ? groups : 1;
  for (int g = 0; g < ngroups; ++g) {
    const long long t =
        ((long long)blockIdx.x * ngroups + g) * HALVES * blockDim.x +
        threadIdx.x;
    const auto units = units_of(io, t, std::make_index_sequence<HALVES>{});
    const auto& u = units.u;
    bool live[HALVES];
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
      live[h] = t + h * blockDim.x < io.threads_needed();

    // acc[h][rr][2q + h']: unit h, pair q (words 2q, 2q+1), lanes 2h', 2h'+1
    uint32_t acc[HALVES][FIELD_ROWS][VEC];
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int rr = 0; rr < FIELD_ROWS; ++rr)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[h][rr][v] = 0u;

    for (int c0 = 0; c0 < kin; c0 += FIELD_KC) {
      const int kc = min(FIELD_KC, kin - c0);
      if (!TILED || g == 0 || kin > FIELD_KC) {
        __syncthreads();  // previous chunk fully consumed
        for (int i = threadIdx.x; i < kc * FIELD_ROWS; i += blockDim.x) {
          const int cc = i / FIELD_ROWS, rr = i - cc * FIELD_ROWS,
                    r = r0 + rr;
          const uint32_t* f =
              fields + ((long long)r * kin + c0 + cc) * FIELD_WORDS;
          s_t01[i] = r < mout ? make_uint4(f[0], f[1], f[2], f[3])
                              : make_uint4(0u, 0u, 0u, 0u);
          reinterpret_cast<uint32_t*>(s_t2)[cc * FIELD_ROWS + rr] =
              r < mout ? f[4] : 0u;
        }
        __syncthreads();
      }
      if (!live[0]) continue;
      const ChunkRows rows{c0};
      if constexpr (HALVES == 1) {
        if (!SPLIT)
          apply_chunk<Path::kAny>(u[0], kc, rows, s_t01, s_t2, acc[0]);
        else if (u[0].vec)
          apply_chunk_pairs<Path::kVec>(u[0], kc, rows, s_t01, s_t2, acc[0]);
        else
          apply_chunk_pairs<Path::kEdge>(u[0], kc, rows, s_t01, s_t2, acc[0]);
      } else {
        bool vec = SPLIT;
#pragma unroll
        for (int h = 0; h < HALVES; ++h) vec = vec && u[h].vec;
        if (vec)
          apply_chunk_units<Path::kVec>(u, kc, rows, s_t01, s_t2, acc);
        else
          apply_chunk_units<Path::kAny>(u, kc, rows, s_t01, s_t2, acc);
      }
    }
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      if (!live[h]) continue;
#pragma unroll
      for (int rr = 0; rr < FIELD_ROWS; ++rr) {
        if (r0 + rr >= mout) continue;
        uint32_t o[VEC];
        deinterleave(acc[h][rr], o);
        u[h].store(r0 + rr, o);
      }
    }
  }
}

// The grid of a launch over `threads` units, `per_block` per block, and
// mout output rows; false when it does not fit.
inline bool grid_of(long long threads, long long per_block, int mout,
                    dim3* grid) {
  const long long blocks = (threads + per_block - 1) / per_block;
  const int row_blocks = (mout + FIELD_ROWS - 1) / FIELD_ROWS;
  if (blocks > 0x7fffffffLL || row_blocks > 65535) return false;
  *grid = dim3(static_cast<unsigned>(blocks),
               static_cast<unsigned>(row_blocks));
  return true;
}

// One launch of gf2_words_kernel over `io` on the caller's stream:
// `groups` column groups per block when TILED, else one.  Returns
// cudaGetLastError() of the launch.
template <class IO, bool TILED, bool SPLIT, int HALVES>
int launch_fields(const void* fields, const IO& io, int kin, int mout,
                  int groups, cudaStream_t stream) {
  const long long threads = io.threads_needed();
  if (threads <= 0 || kin <= 0 || mout <= 0) return 0;
  dim3 grid;
  if (!grid_of(threads, (long long)FIELD_THREADS * HALVES * groups, mout,
               &grid))
    return int(cudaErrorInvalidConfiguration);
  gf2_words_kernel<IO, TILED, SPLIT, HALVES><<<grid, FIELD_THREADS, 0,
                                               stream>>>(
      static_cast<const uint32_t*>(fields), io, kin, mout, groups);
  return int(cudaGetLastError());
}

// Host-side builders: vec_ok when bases and strides allow 16-byte access.
inline WordIO word_io(const void* in, void* out, long long n4,
                      long long in_stride, long long out_stride) {
  WordIO io;
  io.in = static_cast<const uint32_t*>(in);
  io.out = static_cast<uint32_t*>(out);
  io.n4 = n4;
  io.in_stride = in_stride;
  io.out_stride = out_stride;
  io.vec_ok = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
              (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
              in_stride % 4 == 0 && out_stride % 4 == 0;
  return io;
}

inline ByteIO byte_io(const void* in, void* out, long long seg,
                      long long nseg, long long in_row_stride,
                      long long in_seg_stride, long long out_row_stride,
                      long long out_seg_stride) {
  ByteIO io;
  io.in = static_cast<const uint8_t*>(in);
  io.out = static_cast<uint8_t*>(out);
  io.seg = seg;
  io.nseg = nseg;
  io.in_row_stride = in_row_stride;
  io.in_seg_stride = in_seg_stride;
  io.out_row_stride = out_row_stride;
  io.out_seg_stride = out_seg_stride;
  io.vec_ok = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
              (reinterpret_cast<uintptr_t>(out) % 16 == 0) && seg % 16 == 0 &&
              in_row_stride % 16 == 0 && out_row_stride % 16 == 0 &&
              in_seg_stride % 16 == 0 && out_seg_stride % 16 == 0;
  return io;
}

}  // namespace gf2
