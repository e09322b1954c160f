// Tensor-core and async-copy helpers shared by flash_attention.cu and
// smalls_attention.cu.
//
// - mma.sync wrappers: bf16 m16n8k16 and tf32 m16n8k8, fp32 accumulators.
//   Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 /
//   m16n8k8"), with g = lane / 4 and t = lane % 4:
//     tf32  A 16x8:  a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//           B 8x8:   b0 (k t, n g)             b1 (k t+4, n g)
//     bf16  A 16x16: a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..)
//                    a3 (g+8, 2t+8..)
//           B 16x8:  b0 (k 2t..2t+1, n g)      b1 (k 2t+8..2t+9, n g)
//     C 16x8 (both): c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
//   A bf16 pair holds the lower index in its low 16 bits. The fp32
//   A fragment and the B fragment of Q K^T come by ldmatrix (an 8x8 b16
//   matrix is 8 rows x 4 fp32 words, and lane (g, t) receives word t of
//   row g): one instruction instead of four or two scalar loads.
// - 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both
//   rounded as cvt.rna.tf32.f32 does (to nearest, ties away) but by an
//   integer add and mask on the bits, which give the same bits for finite
//   x: cvt is a conversion instruction, issued at a lower rate than
//   integer ops, and the kernels split every fragment element they load,
//   so the integer form is the faster one. a*b is then taken as
//   lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, each tf32 x tf32 product exact in
//   fp32, only lo_a*lo_b (about 2^-22 of |a*b|) dropped. That keeps fp32
//   accuracy where one tf32 pass (about 2^-11) does not.
// - cp.async of 16, 8 or 4 bytes with zero fill (src-size 0), so rows and
//   columns outside a matrix land in shared memory as 0; 0 bytes means
//   "no copy width divides the row": a synchronous element copy. Each
//   thread steps through its copies with no division per copy: the copies
//   are issued inside the kernels' key loops, where issue slots bind.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace frido {
namespace attn {

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cvt.rna.tf32.f32: add half of the 13 dropped mantissa bits to the
// magnitude, then clear them
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32: the two small terms first, then the large one
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ah[4],
                                           const uint32_t al[4],
                                           const uint32_t bh[2],
                                           const uint32_t bl[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two fp32 values as a bf16 pair, x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two bf16 values as a pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// A fragment (16 rows x one k-step) of a row-major fp32 tile in shared
// memory, split for 3xTF32; p points at (row 0, k 0) of the step. One
// ldmatrix.x4 reads it: each 8x8 b16 matrix is 8 rows x 4 fp32 words, and
// lane (g, t) receives word t of row g of each, i.e. a0..a3. ld (in words)
// and p must keep every row 16-byte aligned.
__device__ __forceinline__ void frag_a_tf32(const float* p, int ld, int g,
                                            int t, uint32_t hi[4],
                                            uint32_t lo[4]) {
  const int lane = 4 * g + t;
  const float* row = p + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
                     4 * (lane >> 4);
  uint32_t x[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(smem_addr(row)));
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// B fragment of Q K^T: p points at (key n0, k 0); keys are rows. One
// ldmatrix.x2 (rows 0-7, words 0-3 and 4-7), as for A.
__device__ __forceinline__ void frag_bt_tf32(const float* p, int ld, int g,
                                             int t, uint32_t hi[2],
                                             uint32_t lo[2]) {
  const int lane = (4 * g + t) & 15;
  uint32_t x[2];
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(x[0]), "=r"(x[1])
               : "r"(smem_addr(p + (lane & 7) * ld + 4 * (lane >> 3))));
  split_tf32(__uint_as_float(x[0]), hi[0], lo[0]);
  split_tf32(__uint_as_float(x[1]), hi[1], lo[1]);
}

// B fragment of P V: p points at (key k0, column n0); keys are rows
__device__ __forceinline__ void frag_b_tf32(const float* p, int ld, int g,
                                            int t, uint32_t hi[2],
                                            uint32_t lo[2]) {
  split_tf32(p[t * ld + g], hi[0], lo[0]);
  split_tf32(p[(t + 4) * ld + g], hi[1], lo[1]);
}

// bf16 fragments; ld in elements, even
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void frag_a_bf16(const __nv_bfloat16* p, int ld,
                                            int g, int t, uint32_t a[4]) {
  a[0] = ld32(p + g * ld + 2 * t);
  a[1] = ld32(p + (g + 8) * ld + 2 * t);
  a[2] = ld32(p + g * ld + 2 * t + 8);
  a[3] = ld32(p + (g + 8) * ld + 2 * t + 8);
}

// A fragment of P from fp32 probabilities already rounded to bf16 (the
// conversion is exact)
__device__ __forceinline__ void frag_a_bf16(const float* p, int ld, int g,
                                            int t, uint32_t a[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  const float2 x1 =
      *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t);
  const float2 x2 = *reinterpret_cast<const float2*>(p + g * ld + 2 * t + 8);
  const float2 x3 =
      *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t + 8);
  a[0] = pack_bf16(x0.x, x0.y);
  a[1] = pack_bf16(x1.x, x1.y);
  a[2] = pack_bf16(x2.x, x2.y);
  a[3] = pack_bf16(x3.x, x3.y);
}

__device__ __forceinline__ void frag_bt_bf16(const __nv_bfloat16* p, int ld,
                                             int g, int t, uint32_t b[2]) {
  b[0] = ld32(p + g * ld + 2 * t);
  b[1] = ld32(p + g * ld + 2 * t + 8);
}

__device__ __forceinline__ void frag_b_bf16(const __nv_bfloat16* p, int ld,
                                            int g, int t, uint32_t b[2]) {
  b[0] = pack_bf16(p[2 * t * ld + g], p[(2 * t + 1) * ld + g]);
  b[1] = pack_bf16(p[(2 * t + 8) * ld + g], p[(2 * t + 9) * ld + g]);
}

// ---------------------------------------------------------------------------
// asynchronous copies

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool valid) {
  const uint32_t s = smem_addr(dst);
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
                 "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// copies of BYTES bytes from rows [row0, row0 + rows) x columns [col0,
// col0 + cols) of a row-major [n, d] matrix to dst (row stride ld), 0
// outside the matrix. Thread tid issues copies tid, tid + nthreads, ...
// (row-major over the tile); it walks their (row, column) by a constant
// step instead of dividing for each one.
template <int BYTES, typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          int row0, int rows, int n,
                                          int col0, int cols, int d, int tid,
                                          int nthreads) {
  constexpr int VEC = BYTES / (int)sizeof(T);
  const int per_row = cols / VEC;
  const int dr = nthreads / per_row;
  const int dc = nthreads - dr * per_row;
  int r = tid / per_row;
  int c = tid - r * per_row;
  while (r < rows) {
    const int col = c * VEC;
    const bool ok = row0 + r < n && col0 + col < d;
    const T* s = ok ? src + (size_t)(row0 + r) * d + col0 + col : src;
    cp_async(dst + r * ld + col, s, BYTES, ok);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// rows [row0, row0 + rows) x columns [col0, col0 + cols) of a row-major
// [n, d] matrix into shared memory at dst (row stride ld), 0 outside the
// matrix. copy_bytes (16, 8 or 4) divides d * sizeof(T), so no copy
// straddles the end of a row; 0 copies element by element. cols is a
// multiple of every copy width in elements. Called by all nthreads
// threads; the caller commits and waits.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src,
                                          int row0, int rows, int n,
                                          int col0, int cols, int d,
                                          int copy_bytes, int tid,
                                          int nthreads) {
  if (copy_bytes == 16)
    copy_rows<16>(dst, ld, src, row0, rows, n, col0, cols, d, tid, nthreads);
  else if (copy_bytes == 8)
    copy_rows<8>(dst, ld, src, row0, rows, n, col0, cols, d, tid, nthreads);
  else if (copy_bytes == 4)
    copy_rows<4>(dst, ld, src, row0, rows, n, col0, cols, d, tid, nthreads);
  else
    for (int i = tid; i < rows * cols; i += nthreads) {
      const int r = i / cols;
      const int c = i - r * cols;
      const bool ok = row0 + r < n && col0 + c < d;
      dst[r * ld + c] = ok ? src[(size_t)(row0 + r) * d + col0 + c] : T(0.f);
    }
}

}  // namespace attn
}  // namespace frido
