// Non-causal flash attention for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the TPU kernel frido_tpu/ops/pallas/attention.py:301
// `flash_attention` (`_flash_forward` :127, `_flash_kernel` :49): per
// (batch*head) o = softmax(q k^T * scale) v with an online softmax whose
// running max, sum and accumulator are fp32; kv rows past the end are
// masked; a row whose sum stays 0 is divided by 1.
//
// What bounds it: at the main-path site (VQGAN decoder AttnBlock, one head,
// N = 1024 tokens, d = 512, fp32) the two products are 4*N*N*d flops per
// head against 4*N*d*4 bytes moved, about 256 flops per byte: the kernel is
// bound by arithmetic, not by device memory.
//
// Design, a plain first version that is right (no wgmma or TMA yet):
// - one block of 256 threads per (batch*head, 32-row query tile); the
//   query tile, one 64-row K-or-V tile and the 64x32 probability tile live
//   in dynamic shared memory as fp32 (about 203 KB at d = 512, opted in with
//   cudaFuncSetAttribute); the [32, d] accumulator lives in registers, 8 rows
//   x 8 columns per thread (columns c..c+3 and 256+c..256+c+3);
// - scores: each thread computes 8 entries of one query row by float4 dot
//   products out of shared memory; rows are padded by 4 floats so the eight
//   key rows a warp reads fall on distinct banks;
// - the row max and sum are reduced across the 8 lanes that share a row
//   with warp shuffles, so every lane holds its row's running (m, l);
// - products run on the CUDA cores in fp32, which is why the bound above
//   is the fp32 rate; tensor cores (wgmma) are later work.
//
// Each C entry point returns cudaGetLastError() (or the configuration
// error) as an int; the Python wrapper raises on anything but 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;             // query rows per block
constexpr int BK = 64;             // kv rows per tile
constexpr int THREADS = 256;
constexpr int MAX_D = 512;
constexpr int PT_STRIDE = BQ + 4;  // row stride of the transposed P tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
}

// rows [row0, row0 + rows) of an [n, d] matrix into shared memory with row
// stride ld, as fp32; rows past n are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int n, int d, int ld) {
  const int vecs = d >> 2;
  for (int i = threadIdx.x; i < rows * vecs; i += THREADS) {
    const int r = i / vecs;
    const int c = (i - r * vecs) << 2;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = load4(src + (size_t)(row0 + r) * d + c);
    store4(dst + r * ld + c, val);
  }
}

__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int nq, int nk,
             int d, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* qs = smem;                       // [BQ][ld]
  float* kvs = qs + BQ * ld;              // [BK][ld], K then V
  float* pt = kvs + BK * ld;              // [BK][PT_STRIDE], P transposed
  float* alpha_s = pt + BK * PT_STRIDE;   // [BQ]
  float* l_s = alpha_s + BQ;              // [BQ]

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + bh * nq * d;
  const T* kb = k + bh * nk * d;
  const T* vb = v + bh * nk * d;
  T* ob = o + bh * nq * d;
  const int tid = threadIdx.x;

  // score phase: row sr, columns sc0 + 8 * m
  const int sr = tid >> 3;
  const int sc0 = tid & 7;
  // output phase: rows orow0 .. orow0 + 7, columns oc .. oc + 3 and
  // 256 + oc .. 256 + oc + 3
  const int orow0 = (tid >> 6) * 8;
  const int oc = (tid & 63) * 4;
  const bool has_lo = oc < d;
  const bool has_hi = oc + 256 < d;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  load_tile(qs, qb, q0, BQ, nq, d, ld);

  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // the previous tile's P.V is done with kvs and pt
    load_tile(kvs, kb, k0, BK, nk, d, ld);
    __syncthreads();

    float s[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) s[m] = 0.f;
    const float* qrow = qs + sr * ld;
#pragma unroll 2
    for (int j = 0; j < d; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qrow + j);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float4 b =
            *reinterpret_cast<const float4*>(kvs + (sc0 + 8 * m) * ld + j);
        s[m] = fmaf(a.x, b.x, s[m]);
        s[m] = fmaf(a.y, b.y, s[m]);
        s[m] = fmaf(a.z, b.z, s[m]);
        s[m] = fmaf(a.w, b.w, s[m]);
      }
    }

    // online softmax over this tile; every tile holds >= 1 valid column,
    // so the new max is finite
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      s[m] = (k0 + sc0 + 8 * m < nk) ? s[m] * scale : -INFINITY;
      mx = fmaxf(mx, s[m]);
    }
    mx = group8_max(mx);
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int col = sc0 + 8 * m;
      const float p = (k0 + col < nk) ? expf(s[m] - m_new) : 0.f;
      pt[col * PT_STRIDE + sr] = p;
      sum += p;
    }
    sum = group8_sum(sum);
    l_run = alpha * l_run + sum;
    m_run = m_new;
    if (sc0 == 0) alpha_s[sr] = alpha;
    __syncthreads();  // K fully read; P and alpha visible

    load_tile(kvs, vb, k0, BK, nk, d, ld);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float al = alpha_s[orow0 + r];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= al;
    }
    const int kv_rows = min(BK, nk - k0);
    for (int jj = 0; jj < kv_rows; ++jj) {
      const float4 p0 = *reinterpret_cast<const float4*>(
          pt + jj * PT_STRIDE + orow0);
      const float4 p1 = *reinterpret_cast<const float4*>(
          pt + jj * PT_STRIDE + orow0 + 4);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float* vrow = kvs + jj * ld;
      const float4 v0 = has_lo ? *reinterpret_cast<const float4*>(vrow + oc)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 v1 = has_hi
                            ? *reinterpret_cast<const float4*>(vrow + 256 + oc)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc[r][0] = fmaf(p[r], v0.x, acc[r][0]);
        acc[r][1] = fmaf(p[r], v0.y, acc[r][1]);
        acc[r][2] = fmaf(p[r], v0.z, acc[r][2]);
        acc[r][3] = fmaf(p[r], v0.w, acc[r][3]);
        acc[r][4] = fmaf(p[r], v1.x, acc[r][4]);
        acc[r][5] = fmaf(p[r], v1.y, acc[r][5]);
        acc[r][6] = fmaf(p[r], v1.z, acc[r][6]);
        acc[r][7] = fmaf(p[r], v1.w, acc[r][7]);
      }
    }
  }

  if (sc0 == 0) l_s[sr] = l_run;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + orow0 + r;
    if (row >= nq) continue;
    float l = l_s[orow0 + r];
    l = (l == 0.f) ? 1.f : l;
    T* orow = ob + (size_t)row * d;
    if (has_lo)
      store4(orow + oc, make_float4(acc[r][0] / l, acc[r][1] / l,
                                    acc[r][2] / l, acc[r][3] / l));
    if (has_hi)
      store4(orow + 256 + oc, make_float4(acc[r][4] / l, acc[r][5] / l,
                                          acc[r][6] / l, acc[r][7] / l));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int nq, int nk, int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || d <= 0 || d > MAX_D ||
      (d & 3) != 0)
    return (int)cudaErrorInvalidValue;
  const int ld = d + 4;
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * ld + BK * PT_STRIDE + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + BQ - 1) / BQ, bh);
  flash_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), nq, nk, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frido_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, int bh,
                                         int nq, int nk, int d, float scale,
                                         void* stream) {
  return launch<float>(q, k, v, o, bh, nq, nk, d, scale, stream);
}

extern "C" int frido_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, int bh,
                                          int nq, int nk, int d, float scale,
                                          void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, nq, nk, d, scale, stream);
}

extern "C" const char* frido_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
