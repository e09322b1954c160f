// Single-pass short-sequence attention for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the TPU kernel frido_tpu/ops/pallas/attention.py:282
// `smalls_attention` (`_smalls_forward` :233, `_smalls_kernel` :187): per
// (batch*head) o = softmax(q k^T * scale) v for nk <= 512 keys, with fp32
// scores, an exact (not online) softmax over the whole row, the
// probabilities rounded to v's dtype before the second product (as
// `p.astype(v.dtype)`, attention.py:200-203), that product accumulated in
// fp32, and one rounding of the output.
//
// What bounds it: at the UNet's sites (nq = 256 / 64 / 16 tokens against
// nk = nq or 77, one head of d = 384 / 576 / 960; BERT's 8 heads of d = 64
// over 77 tokens) the two products are 4 * nq * nk * d operations against
// (2 nq + 2 nk) * d elements moved, 100-200 operations per byte: bound by
// arithmetic. The kernel computes on the CUDA cores in fp32.
//
// Design, a plain first version that is right (no wgmma or TMA yet): one
// block of 256 threads per (batch*head, 32-row query tile). The tile's
// full score rows [32, nk <= 512] stay in shared memory (66 KB at nk =
// 512). No [S, d] k or v tile fits beside them at d = 960, so:
// 1. scores: for each 64-key block, q and k are streamed through shared
//    memory in 64-wide d chunks; each thread keeps 8 scores of one row in
//    registers over all chunks, then writes them into the score rows;
// 2. softmax: one warp per row takes the exact max, exp and sum over the
//    whole row, and stores p = exp(s - max) / sum rounded to v's dtype;
// 3. P.V: for each 64-wide chunk of output columns, v is streamed through
//    shared memory in 64-key blocks and each thread accumulates 2 rows x 4
//    columns in fp32 registers.
// Rows past nq and d columns past d are zero-filled and never stored; keys
// past nk take no part in the softmax. Dynamic shared memory is about
// 92 KB, opted in with cudaFuncSetAttribute, so two blocks fit an SM.
//
// Each C entry point returns cudaGetLastError() (or the configuration
// error) as an int; the Python wrapper raises on anything but 0.

#include "group_stats.cuh"

#include <math.h>

namespace {

constexpr int TQ = 32;        // query rows per block
constexpr int KB = 64;        // keys per block of the key loop
constexpr int DC = 64;        // d columns per chunk
constexpr int LD = DC + 4;    // row stride of the q / k / v chunks
constexpr int THREADS = 256;
constexpr int MAX_NK = 512;

// rows [row0, row0 + rows) x columns [col0, col0 + DC) of an [n, d] matrix
// into shared memory as fp32, zero outside the matrix
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, int row0,
                                           int rows, int n, int col0, int d) {
  for (int i = threadIdx.x; i < rows * DC; i += THREADS) {
    const int r = i / DC;
    const int c = i - r * DC;
    float v = 0.f;
    if (row0 + r < n && col0 + c < d)
      v = frido::to_f32(src[(size_t)(row0 + r) * d + col0 + c]);
    dst[r * LD + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
smalls_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int nq, int nk,
              int d, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int nkb = (nk + KB - 1) / KB;
  const int sld = nkb * KB + 1;  // odd row stride of the score rows
  float* srow = smem;            // [TQ][sld]
  float* qs = srow + TQ * sld;   // [TQ][LD]
  float* kv = qs + TQ * LD;      // [KB][LD], k chunks, later v chunks

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const T* qb = q + bh * nq * d;
  const T* kb = k + bh * nk * d;
  const T* vb = v + bh * nk * d;
  T* ob = o + bh * nq * d;
  const int tid = threadIdx.x;

  // 1. scores: row sr, columns sc0 + 8 m of each key block
  const int sr = tid >> 3;
  const int sc0 = tid & 7;
  for (int k0 = 0; k0 < nk; k0 += KB) {
    float s[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) s[m] = 0.f;
    for (int d0 = 0; d0 < d; d0 += DC) {
      __syncthreads();  // the previous chunk is no longer read
      load_chunk(qs, qb, q0, TQ, nq, d0, d);
      load_chunk(kv, kb, k0, KB, nk, d0, d);
      __syncthreads();
      const float* qrow = qs + sr * LD;
#pragma unroll 4
      for (int j = 0; j < DC; j += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qrow + j);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float4 b =
              *reinterpret_cast<const float4*>(kv + (sc0 + 8 * m) * LD + j);
          s[m] = fmaf(a.x, b.x, s[m]);
          s[m] = fmaf(a.y, b.y, s[m]);
          s[m] = fmaf(a.z, b.z, s[m]);
          s[m] = fmaf(a.w, b.w, s[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 8; ++m)
      srow[sr * sld + k0 + sc0 + 8 * m] = s[m] * scale;
  }
  __syncthreads();

  // 2. exact softmax, one warp per row; p rounded to v's dtype
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int r = warp; r < TQ; r += THREADS / 32) {
    float* row = srow + r * sld;
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < nk; j += 32)
      row[j] = frido::to_f32(frido::from_f32<T>(row[j] / sum));
  }

  // 3. o = P v: rows r0, r0 + 1 and columns c4 .. c4 + 3 of each d chunk
  const int r0 = (tid >> 4) * 2;
  const int c4 = (tid & 15) * 4;
  for (int d0 = 0; d0 < d; d0 += DC) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < nk; k0 += KB) {
      __syncthreads();  // softmax done / the previous v chunk is read
      load_chunk(kv, vb, k0, KB, nk, d0, d);
      __syncthreads();
      const int rows = min(KB, nk - k0);
      const float* p0 = srow + r0 * sld + k0;
      const float* p1 = p0 + sld;
      for (int j = 0; j < rows; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(kv + j * LD + c4);
        const float a0 = p0[j];
        const float a1 = p1[j];
        acc[0][0] = fmaf(a0, vv.x, acc[0][0]);
        acc[0][1] = fmaf(a0, vv.y, acc[0][1]);
        acc[0][2] = fmaf(a0, vv.z, acc[0][2]);
        acc[0][3] = fmaf(a0, vv.w, acc[0][3]);
        acc[1][0] = fmaf(a1, vv.x, acc[1][0]);
        acc[1][1] = fmaf(a1, vv.y, acc[1][1]);
        acc[1][2] = fmaf(a1, vv.z, acc[1][2]);
        acc[1][3] = fmaf(a1, vv.w, acc[1][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + i;
      if (row >= nq) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = d0 + c4 + c;
        if (col < d) ob[(size_t)row * d + col] = frido::from_f32<T>(acc[i][c]);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int nq, int nk, int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || nk > MAX_NK || d <= 0)
    return (int)cudaErrorInvalidValue;
  const int nkb = (nk + KB - 1) / KB;
  const size_t smem =
      sizeof(float) * ((size_t)TQ * (nkb * KB + 1) + TQ * LD + KB * LD);
  cudaError_t err = cudaFuncSetAttribute(
      smalls_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + TQ - 1) / TQ, bh);
  smalls_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), nq, nk, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frido_smalls_attention_f32(const void* q, const void* k,
                                          const void* v, void* o, int bh,
                                          int nq, int nk, int d, float scale,
                                          void* stream) {
  return launch<float>(q, k, v, o, bh, nq, nk, d, scale, stream);
}

extern "C" int frido_smalls_attention_bf16(const void* q, const void* k,
                                           const void* v, void* o, int bh,
                                           int nq, int nk, int d, float scale,
                                           void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, nq, nk, d, scale, stream);
}

extern "C" const char* frido_smalls_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
