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
// Both are one kernel, gf2_io.cuh's gf2_words_kernel with one unit per
// thread, over two views of the data (WordIO for the words, ByteIO for the
// bytes); gf2_variants.cu's split2 kernels are the same kernel with two.
//
// Function: out[r] = XOR_c  A[r][c] * in[c]  over GF(2^8), for every byte
// column, given the (8 mout x 8 kin) GF(2) bitmatrix BM of the coefficient
// matrix A (packet codes pass their raw 0/1 GF(2) matrix the same way).
// Byte lanes never mix, so each block (r, c) of BM is a linear map M on
// bytes: bit i of M(x) is XOR_j BM[8r+i][8c+j] * bit j of x.
//
// Design: byte tables looked up with prmt.  M is linear, so
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
// two prmt per pair and output row undo it before the store.  (The step is
// gf2_io.cuh's apply_fields, shared with the grouped kernels.)  As before,
// each block computes FIELD_ROWS output rows (blockIdx.y), the tables are
// staged through shared memory in chunks of FIELD_KC input rows, so any
// (kin, mout) works (the w=32 packet matrix is 64 x 128), with XOR
// accumulation in registers across chunks (the TPU kernel's kblk blocking,
// transposed), and the next input row's words are loaded while the current
// one is applied.
//
// The two views differ only in where a thread's 16 bytes lie.  Each thread
// finds its unit once (gf2_io.cuh); a row is then c * row_stride away.  The
// words launches keep one row loop that tests the unit per row (SPLIT =
// false: builds of B1 with an interior-only loop, or with two rows per
// iteration, measured slower); the bytes launch picks the path once per
// thread (SPLIT = true) and runs its interior units through a loop of two
// rows per iteration (gf2_io.cuh apply_chunk_pairs) that holds one LDG.128
// per row and no byte-by-byte code: a (B, kin, C) batch's segment
// arithmetic, one 64-bit division, runs once per thread instead of on
// every row load and store, as the bit-spread B2 did.
//
// Bound.  Headline encode (k=8, m=4, 16384 stripes x 4 KiB): 64 MiB read +
// 32 MiB written = 100.7 MB, about 30 us at the H100 SXM data-sheet
// 3.35 TB/s; the 4-erasure decode moves the same bytes.  Both kernels are
// bytes-bound on paper and issue-bound in practice: the H100 issues 64
// integer (ALU) lane operations per clock per SM.  The bit-spread design
// spent about 17 instructions per input byte, the table design about 10,
// which brings its issue time under the time its bytes take at the
// measured copy ceiling.
// gf2_apply_words at the headline: 167 SASS instructions per 4 input words
// in its row loop (about 42 per word, against 70 for the bit spread),
// 46.15 us, 65.1% of bound (chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700 W).
// gf2_apply_u8 at the headline bytes ((8, 8 MiB) streams), prediction
// written before its first run on the card: B1's loop and bytes once the
// addressing is hoisted, about 46-52 us, 58-65% of its 30.05 us bound,
// against 82.67 us for the bit spread with per-row segment division.
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W): 45.59 us,
// 65.9% of bound, 0.551x the bit spread, B1 48.96 us in the same run; its
// interior loop is 252 SASS instructions per 2 input rows (31.5 per input
// word), 80 registers.
//
// Launches run on the caller's stream, allocate nothing and do not
// synchronise; each entry returns cudaGetLastError() of its launch.

#include "gf2_io.cuh"

using gf2::ByteIO;
using gf2::FIELD_THREADS;
using gf2::VEC;
using gf2::WordIO;
using gf2::byte_io;
using gf2::launch_fields;
using gf2::word_io;

// `fields`: (mout, kin, 5) uint32, cuda_kernels.field_tables.
extern "C" int gf2_apply_words(const void* fields, const void* in, void* out,
                               int kin, int mout, long long n4,
                               long long in_stride, long long out_stride,
                               void* stream) {
  return launch_fields<WordIO, false, false, 1>(
      fields, word_io(in, out, n4, in_stride, out_stride), kin, mout, 1,
      static_cast<cudaStream_t>(stream));
}

// gf2_apply_words at a given tile: `tile` words of every row per block, a
// positive multiple of FIELD_THREADS * VEC = 1024 (the Pallas kernel's `tile`
// argument, _pallas_apply_words(..., tile=)).
extern "C" int gf2_apply_words_tiled(const void* fields, const void* in,
                                     void* out, int kin, int mout,
                                     long long n4, long long in_stride,
                                     long long out_stride, int tile,
                                     void* stream) {
  if (tile <= 0 || tile % (FIELD_THREADS * VEC))
    return int(cudaErrorInvalidValue);
  return launch_fields<WordIO, true, false, 1>(
      fields, word_io(in, out, n4, in_stride, out_stride), kin, mout,
      tile / (FIELD_THREADS * VEC), static_cast<cudaStream_t>(stream));
}

// `fields`: (mout, kin, 5) uint32, cuda_kernels.field_tables.
extern "C" int gf2_apply_u8(const void* fields, const void* in, void* out,
                            int kin, int mout, long long seg, long long nseg,
                            long long in_row_stride, long long in_seg_stride,
                            long long out_row_stride, long long out_seg_stride,
                            void* stream) {
  return launch_fields<ByteIO, false, true, 1>(
      fields,
      byte_io(in, out, seg, nseg, in_row_stride, in_seg_stride,
              out_row_stride, out_seg_stride),
      kin, mout, 1, static_cast<cudaStream_t>(stream));
}
