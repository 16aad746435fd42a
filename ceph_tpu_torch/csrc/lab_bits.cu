// The perf lab's bit kernels for Hopper (sm_90a): the two halves of the
// int8 formulation of the GF(2) region apply, each alone.
//
//   unpack_repack_words <- the Pallas body of exp_unpack_only in
//       ceph_tpu/testing/perf_lab.py (:189-193, launched at :197): expand
//       every int32 word of a (rows, n4) array to its 32 bits, then pack
//       them back.  The output equals the input; the time is what B1's
//       expansion and B1's repack cost with no contraction between them.
//   roof_matmul_s8      <- the Pallas body of exp_roof_matmul (:235-237,
//       launched at :241): C[128, n] int32 = A[128, 256] int8 . B[256, n]
//       int8, the contraction on bits already expanded (A the lab's bm32,
//       row-major; B k-major, n contiguous, the JAX `bits` layout), with
//       no unpack and no pack.
//
// unpack_repack_words.  A block owns 256 words of 8 rows.  It materialises
// the 0/1 planes as int8 in shared memory, laid out (row*32 + bit, column)
// with a 256-byte pitch: the (k, n) layout of roof_matmul_s8's B operand.
// 8 x 32 x 256 bytes = 64 KiB, dynamic shared memory past the 48 KiB
// default.  A thread takes a (row, 4-word group): one 16-byte load, a 4x4
// byte transpose (8 prmt) so that word b holds byte b of the 4 columns,
// then plane 8b+p = (word_b >> p) & 0x01010101 is one 32-bit store of four
// int8 planes.  After a barrier the planes are read back by the thread of
// the warp 32 lanes away (so the compiler cannot fold a thread's planes
// back into its own words, which would leave a copy), OR-ed with their
// shifts into 4 words, transposed back and stored.  Both loops stay loops
// (unroll 1), so testing/sass.py shows the expansion (32 STS) and the
// repack (32 LDS) bodies.
//
// roof_matmul_s8.  mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on the
// tensor cores, the simple form (wgmma/TMA are later work).  A block of 8
// warps walks column tiles of 64 (grid-stride, one block per resident slot);
// warp w owns output rows 16w..16w+15 of each tile and keeps its A
// fragments for all 8 k-steps in 32 registers for the whole launch; a
// thread's loads of the next tile are in flight while the current one
// computes.  The contraction order is free, so k is permuted: lane quad t
// (lane & 3) holds k in [64t, 64t+64), and for k-step s register r of both
// fragments holds words 16t + 2s + r of the operand's k run.  A's fragments
// are then four 16-byte loads per row, and B's are four 16-byte shared
// loads per 8-column group.  B is staged per tile transposed to n-major with k contiguous (the
// .col fragment: 4 consecutive k per register): a thread loads 16 k-rows x
// 4 bytes and byte-transposes them into four 16-byte chunks.  The chunks of
// a row are swizzled (chunk q at q ^ ((q >> 3) << 1)) and rows padded to 17
// chunks, so the fragment loads are free of bank conflicts.  Inputs are any
// int8, not only 0/1; sums are exact in int32 (|C| <= 256 * 128 * 128).
//
// Bounds at the lab's headline (n = 262,144): unpack_repack_words reads and
// writes (8, 2^21) int32 = 134,217,728 B, 40.06 us at the H100 SXM
// data-sheet 3.35 TB/s.  roof_matmul_s8 reads 67,108,864 B of B and 32,768 B
// of A and writes 134,217,728 B of C: 60.10 us; its 2*128*256*n =
// 1.72e10 int8 ops take 8.68 us at 1,979 TOP/s, so it is bytes-bound.
//
// Launches run on the caller's stream, allocate nothing and do not
// synchronise; each entry returns cudaGetLastError() of its launch.  Each
// entry queries its one-time launch attribute on its first call (before any
// CUDA graph capture of it) and caches it for the process's device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 4x4 byte transpose: out[b] holds byte b of in[0..3] as its bytes 0..3.
__device__ __forceinline__ void transpose4(const uint32_t (&in)[4],
                                           uint32_t (&out)[4]) {
  const uint32_t lo01 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t hi01 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t lo23 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t hi23 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// -- L2: unpack_repack_words ------------------------------------------------

constexpr int UB_THREADS = 256;
constexpr int UB_ROWS = 8;                          // rows per block
constexpr int UB_WORDS = 256;                       // words per row per block
constexpr int UB_GROUPS = UB_WORDS / 4;             // 16-byte groups per row
constexpr int UB_UNITS = UB_ROWS * UB_GROUPS;       // (row, group) units
constexpr int UB_SMEM = UB_ROWS * 32 * UB_WORDS;    // int8 planes: 64 KiB

// Unit u of the block at (r0, c0): row r0 + u / UB_GROUPS, words
// c0 + 4 * (u % UB_GROUPS) .. +3 of a contiguous (rows, n4) array.
struct Units {
  const uint32_t* in;
  uint32_t* out;
  int rows;
  long long n4;
  bool vec_ok;  // 16-byte aligned bases and n4 % 4 == 0

  __device__ __forceinline__ void load(int r0, long long c0, int u,
                                       uint32_t (&w)[4]) const {
    const int row = r0 + u / UB_GROUPS;
    const long long w0 = c0 + 4 * (u % UB_GROUPS);
    const uint32_t* p = in + row * n4 + w0;
    if (row < rows && vec_ok && w0 + 4 <= n4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = (row < rows && w0 + e < n4) ? __ldg(p + e) : 0u;
  }

  __device__ __forceinline__ void store(int r0, long long c0, int u,
                                        const uint32_t (&w)[4]) const {
    const int row = r0 + u / UB_GROUPS;
    const long long w0 = c0 + 4 * (u % UB_GROUPS);
    if (row >= rows) return;
    uint32_t* p = out + row * n4 + w0;
    if (vec_ok && w0 + 4 <= n4) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (w0 + e < n4) p[e] = w[e];
  }
};

__global__ void __launch_bounds__(UB_THREADS)
unpack_repack_kernel(Units io) {
  // int8 plane (row*32 + bit, column) at byte (row*32 + bit)*256 + column,
  // addressed here as words: [(row*32 + bit) * UB_GROUPS + group]
  extern __shared__ uint32_t s_planes[];
  const long long c0 = (long long)blockIdx.x * UB_WORDS;
  const int r0 = blockIdx.y * UB_ROWS;

  // Expansion: units tid and tid + 256, the second's load issued before
  // the first unit's planes are written.
  uint32_t next[4];
  io.load(r0, c0, threadIdx.x, next);
#pragma unroll 1
  for (int u = threadIdx.x; u < UB_UNITS; u += UB_THREADS) {
    const uint32_t w[4] = {next[0], next[1], next[2], next[3]};
    if (u + UB_THREADS < UB_UNITS) io.load(r0, c0, u + UB_THREADS, next);
    uint32_t t[4];
    transpose4(w, t);  // t[b]: byte b of the four words
    uint32_t* planes = s_planes + (u / UB_GROUPS) * 32 * UB_GROUPS +
                       u % UB_GROUPS;
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int p = 0; p < 8; ++p)
        planes[(8 * b + p) * UB_GROUPS] = (t[b] >> p) & 0x01010101u;
  }
  __syncthreads();

  // Repack, each unit by the thread 32 lanes from the one that expanded it.
#pragma unroll 1
  for (int u = threadIdx.x ^ 32; u < UB_UNITS; u += UB_THREADS) {
    const uint32_t* planes = s_planes + (u / UB_GROUPS) * 32 * UB_GROUPS +
                             u % UB_GROUPS;
    uint32_t t[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      uint32_t acc = 0u;
#pragma unroll
      for (int p = 0; p < 8; ++p) acc |= planes[(8 * b + p) * UB_GROUPS] << p;
      t[b] = acc;
    }
    uint32_t w[4];
    transpose4(t, w);
    io.store(r0, c0, u, w);
  }
}

// -- L3: roof_matmul_s8 -----------------------------------------------------

constexpr int MM_M = 128;                 // rows of A and C
constexpr int MM_K = 256;                 // contraction depth
constexpr int MM_NT = 64;                 // columns per block tile
constexpr int MM_THREADS = 32 * MM_M / 16;  // a warp per 16 rows: 256
constexpr int BT_CHUNKS = MM_K / 16 + 1;  // 16-byte k chunks per row, + pad

static_assert(MM_THREADS == (MM_K / 16) * (MM_NT / 4),
              "one staging unit (16 k x 4 columns) per thread");

// Swizzled position of k-chunk q in a staged B row (see the header).
__device__ __forceinline__ int bt_chunk(int q) { return q ^ ((q >> 3) << 1); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This thread's staging unit of the tile at column n0: k rows 16*sk .. +15,
// columns n0 + 4*sq .. +3, as 16 words (lowest column in byte 0; zero past
// n).
__device__ __forceinline__ void load_unit(const uint8_t* __restrict__ b,
                                          long long n, long long n0, int sk,
                                          int sq, bool b_vec,
                                          uint32_t (&rw)[16]) {
  const long long col = n0 + 4 * sq;
  const uint8_t* src = b + (long long)(16 * sk) * n + col;
  if (b_vec && col + 4 <= n) {
#pragma unroll
    for (int r = 0; r < 16; ++r, src += n)
      rw[r] = __ldg(reinterpret_cast<const uint32_t*>(src));
    return;
  }
  for (int r = 0; r < 16; ++r, src += n) {
    uint32_t v = 0u;
    for (int e = 0; e < 4; ++e)
      if (col + e < n) v |= uint32_t(__ldg(src + e)) << (8 * e);
    rw[r] = v;
  }
}

__global__ void __launch_bounds__(MM_THREADS, 2)
roof_matmul_s8_kernel(const uint32_t* __restrict__ a,  // (128, 64) words
                      const uint8_t* __restrict__ b,   // (256, n) bytes
                      int* __restrict__ c,             // (128, n)
                      long long n, bool b_vec, bool c_vec) {
  __shared__ uint4 s_bt[MM_NT * BT_CHUNKS];  // B^T tile: [column][k chunk]
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;      // mma groupID, thread in group
  const int row0 = 16 * (threadIdx.x >> 5) + g;  // C rows row0, row0 + 8

  // A fragments of all 8 k-steps: words 16t .. 16t+15 of rows row0 and
  // row0 + 8; step s, register r <- word 16t + 2s + r (regs 0/2 row0,
  // regs 1/3 row0 + 8).
  uint32_t af[8][4];
  {
    const uint4* ra = reinterpret_cast<const uint4*>(a + row0 * 64 + 16 * t);
    const uint4* rb =
        reinterpret_cast<const uint4*>(a + (row0 + 8) * 64 + 16 * t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 x = __ldg(ra + q), y = __ldg(rb + q);
      af[2 * q][0] = x.x; af[2 * q][2] = x.y;
      af[2 * q + 1][0] = x.z; af[2 * q + 1][2] = x.w;
      af[2 * q][1] = y.x; af[2 * q][3] = y.y;
      af[2 * q + 1][1] = y.z; af[2 * q + 1][3] = y.w;
    }
  }

  // Staging unit of this thread: k rows 16*sk .. +15, tile columns
  // 4*sq .. +3.  The next tile's unit is loaded while this one computes.
  const int sq = threadIdx.x & 15, sk = threadIdx.x >> 4;
  const long long ntiles = (n + MM_NT - 1) / MM_NT;
  uint32_t rw[16];
  if (blockIdx.x < ntiles)
    load_unit(b, n, (long long)blockIdx.x * MM_NT, sk, sq, b_vec, rw);
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long n0 = tile * MM_NT;
    // tr[m][j]: column 4sq + j, k = 16sk + 4m .. +3 (lowest k in byte 0)
    uint32_t tr[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t rows4[4] = {rw[4 * m], rw[4 * m + 1], rw[4 * m + 2],
                                 rw[4 * m + 3]};
      transpose4(rows4, tr[m]);
    }
    __syncthreads();  // the previous tile's fragments are all read
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s_bt[(4 * sq + j) * BT_CHUNKS + bt_chunk(sk)] =
          make_uint4(tr[0][j], tr[1][j], tr[2][j], tr[3][j]);
    __syncthreads();
    if (tile + gridDim.x < ntiles)
      load_unit(b, n, (tile + gridDim.x) * MM_NT, sk, sq, b_vec, rw);

#pragma unroll
    for (int nt = 0; nt < MM_NT / 8; ++nt) {
      // B fragments of column n0 + 8nt + g: k chunks 4t .. 4t+3, i.e.
      // words 16t .. 16t+15 of its k run; step s, register r <- 2s + r.
      const uint4* brow = s_bt + (8 * nt + g) * BT_CHUNKS;
      uint32_t bw[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = brow[bt_chunk(4 * t + q)];
        bw[4 * q] = v.x; bw[4 * q + 1] = v.y;
        bw[4 * q + 2] = v.z; bw[4 * q + 3] = v.w;
      }
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < 8; ++s) mma_s8(acc, af[s], bw[2 * s], bw[2 * s + 1]);
      // acc[0..1]: row0, columns cc, cc+1; acc[2..3]: row0 + 8, the same
      const long long cc = n0 + 8 * nt + 2 * t;
      int* p0 = c + row0 * n + cc;
      int* p1 = c + (row0 + 8) * n + cc;
      if (c_vec && cc + 2 <= n) {
        *reinterpret_cast<int2*>(p0) = make_int2(acc[0], acc[1]);
        *reinterpret_cast<int2*>(p1) = make_int2(acc[2], acc[3]);
      } else {
        if (cc < n) { p0[0] = acc[0]; p1[0] = acc[2]; }
        if (cc + 1 < n) { p0[1] = acc[1]; p1[1] = acc[3]; }
      }
    }
  }
}

}  // namespace

extern "C" int unpack_repack_words(const void* in, void* out, int rows,
                                   long long n4, void* stream) {
  if (rows <= 0 || n4 <= 0) return 0;
  const long long blocks = (n4 + UB_WORDS - 1) / UB_WORDS;
  const int row_blocks = (rows + UB_ROWS - 1) / UB_ROWS;
  if (blocks > 0x7fffffffLL || row_blocks > 65535)
    return int(cudaErrorInvalidConfiguration);
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        unpack_repack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        UB_SMEM);
    if (err != cudaSuccess) return int(err);
    smem_raised = true;
  }
  Units io;
  io.in = static_cast<const uint32_t*>(in);
  io.out = static_cast<uint32_t*>(out);
  io.rows = rows;
  io.n4 = n4;
  io.vec_ok = aligned16(in) && aligned16(out) && n4 % 4 == 0;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(row_blocks));
  unpack_repack_kernel<<<grid, UB_THREADS, UB_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(io);
  return int(cudaGetLastError());
}

extern "C" int roof_matmul_s8(const void* a, const void* b, void* c,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  if (!aligned16(a)) return int(cudaErrorMisalignedAddress);
  static long long grid_cap = 0;  // resident blocks on the device
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, roof_matmul_s8_kernel, MM_THREADS, 0);
    if (err != cudaSuccess) return int(err);
    grid_cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long ntiles = (n + MM_NT - 1) / MM_NT;
  const long long blocks = ntiles < grid_cap ? ntiles : grid_cap;
  const bool b_vec = reinterpret_cast<uintptr_t>(b) % 4 == 0 && n % 4 == 0;
  const bool c_vec = reinterpret_cast<uintptr_t>(c) % 8 == 0 && n % 2 == 0;
  roof_matmul_s8_kernel<<<static_cast<unsigned>(blocks), MM_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<int*>(c), n, b_vec, c_vec);
  return int(cudaGetLastError());
}
