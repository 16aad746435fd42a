// Shared device code of the port's GF(2) region-apply kernels
// (gf2_apply.cu, gf2_grouped.cu): the bit spread and the two views of the
// data a thread reads and writes 16 bytes at a time.
//
//   spread(w, j) = ((w >> j) & 0x01010101) * 0xFF: 0xFF in each byte of w
//                  whose bit j is set, 0x00 elsewhere.
//   WordIO       (rows, n4) int32 lane words, any row stride.
//   ByteIO       (rows, N) byte streams, or a (B, rows, C) stripe batch as
//                B segments of length C, any row and segment strides.
// Both mask the ragged edge; both take row indices, so a kernel may read
// rows in any order (the grouped kernels read each group's support rows).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gf2 {

constexpr int VEC = 4;       // 32-bit words per thread (16 bytes)

__device__ __forceinline__ uint32_t spread(uint32_t w, int j) {
  return ((w >> j) & 0x01010101u) * 0xFFu;
}

// (rows, n4) int32 words, row stride in words.
struct WordIO {
  const uint32_t* in;
  uint32_t* out;
  long long n4;
  long long in_stride;
  long long out_stride;
  bool vec_ok;  // base pointers 16-byte aligned and strides multiples of 4

  __device__ __forceinline__ void load(int c, long long t, uint32_t (&w)[VEC]) const {
    const long long w0 = t * VEC;
    const uint32_t* p = in + c * in_stride + w0;
    if (vec_ok && w0 + VEC <= n4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) w[v] = (w0 + v < n4) ? __ldg(p + v) : 0u;
    }
  }

  __device__ __forceinline__ void store(int r, long long t, const uint32_t (&w)[VEC]) const {
    const long long w0 = t * VEC;
    uint32_t* p = out + r * out_stride + w0;
    if (vec_ok && w0 + VEC <= n4) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        if (w0 + v < n4) p[v] = w[v];
    }
  }

  __device__ __forceinline__ long long threads_needed() const {
    return (n4 + VEC - 1) / VEC;
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

  __device__ __forceinline__ long long total() const { return seg * nseg; }

  __device__ __forceinline__ void load(int c, long long t, uint32_t (&w)[VEC]) const {
    const long long x0 = t * (4 * VEC);
    if (vec_ok && x0 + 4 * VEC <= total()) {
      const long long s = x0 / seg, o = x0 - s * seg;
      const uint8_t* p = in + s * in_seg_stride + c * in_row_stride + o;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      return;
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      uint32_t word = 0;
      for (int b = 0; b < 4; ++b) {
        const long long x = x0 + 4 * v + b;
        if (x < total()) {
          const long long s = x / seg, o = x - s * seg;
          word |= uint32_t(__ldg(in + s * in_seg_stride + c * in_row_stride + o)) << (8 * b);
        }
      }
      w[v] = word;
    }
  }

  __device__ __forceinline__ void store(int r, long long t, const uint32_t (&w)[VEC]) const {
    const long long x0 = t * (4 * VEC);
    if (vec_ok && x0 + 4 * VEC <= total()) {
      const long long s = x0 / seg, o = x0 - s * seg;
      uint8_t* p = out + s * out_seg_stride + r * out_row_stride + o;
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      return;
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      for (int b = 0; b < 4; ++b) {
        const long long x = x0 + 4 * v + b;
        if (x < total()) {
          const long long s = x / seg, o = x - s * seg;
          out[s * out_seg_stride + r * out_row_stride + o] = uint8_t(w[v] >> (8 * b));
        }
      }
    }
  }

  __device__ __forceinline__ long long threads_needed() const {
    return (total() + 4 * VEC - 1) / (4 * VEC);
  }
};

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
