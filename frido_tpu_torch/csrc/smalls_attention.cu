// Single-pass short-sequence attention for Hopper (sm_90a) on the tensor
// cores, fp32 and bf16.
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
// over 77 tokens, fp32) the work is small, 0.4 GFLOP at the heaviest site
// against about 3 MB: what bounds it in practice is latency, i.e. how many
// SMs have work and how long each waits on its loads. Products run on the
// tensor cores: bf16 mma, and 3xTF32 for fp32 (attention_mma.cuh).
//
// Design (mma.sync, cp.async; one launch per call):
// - grid (nq / 16 query tiles, d / DO output-column chunks, batch*head),
//   4 warps a block. The host plan (frido_tpu_torch/ops/cuda/attention.py,
//   `smalls_plan`) picks DO in {256, 128, 64, 32} so that the grid covers
//   the 132 SMs where it can (192 blocks at the [4, 256, 256, 384] site);
// - scores: each block computes its 16 whole score rows over all of d
//   (the column chunks recompute them; at most 3x here): q and all nk
//   keys stream through two cp.async stages in d chunks of 32 (fp32) or
//   64 (bf16) columns; warp w owns key tiles w, w + 4, ... of 8 keys, its
//   accumulators (up to 16 x 4 fp32) stay in registers over the chunks;
// - the [16, nk] fp32 score rows go to shared memory; one warp per row
//   takes the exact max, exp and sum, and stores p = exp(s - max) / sum
//   rounded to v's dtype; keys past nk get 0;
// - P.V: v[:, DO columns] streams through the same two stages in 32-key
//   tiles (the first one loads during the softmax); warp w accumulates
//   16 rows x DO/4 columns in fp32;
// - d is zero-padded to the mma depth in shared memory; rows past nq or
//   nk and columns past d are zero-filled by the copies and never stored.
//   Rows of d * itemsize bytes that 16, 8 or 4 does not divide (bf16 at
//   odd d) are copied element by element.
// Shared memory: the score rows (33 KB at nk = 512) and two stages of
// max(q + k chunk, v tile), 185 KB at nk = 512 and 95 KB at nk = 256.
//
// Each C entry point returns cudaGetLastError() (or the configuration
// error) as an int; the Python wrapper raises on anything but 0.

#include "attention_mma.cuh"

#include <math.h>

namespace {

using namespace frido::attn;

constexpr int TQ = 16;       // query rows per block
constexpr int BKV = 32;      // keys per v tile
constexpr int THREADS = 128;
constexpr int MAX_NK = 512;
constexpr int MAX_SMEM = 232448;

template <typename T>
struct Layout {
  static constexpr int DC = sizeof(T) == 4 ? 32 : 64;    // d chunk
  static constexpr int LDC = DC + (sizeof(T) == 4 ? 4 : 8);
  int nkp, sld, ldv;
  size_t stage;  // elements of T in one stage
  __host__ __device__ Layout(int nk, int cols)
      : nkp(round_up(nk, 8)), sld(round_up(nk, BKV) + 4), ldv(cols + 8) {
    const size_t s = (size_t)(TQ + nkp) * LDC;
    const size_t v = (size_t)BKV * ldv;
    stage = s > v ? s : v;
  }
  __host__ __device__ size_t rows_bytes() const {
    return sizeof(float) * TQ * sld;
  }
  __host__ __device__ size_t smem_bytes() const {
    return rows_bytes() + 2 * stage * sizeof(T);
  }
};

__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// one d chunk of S: acc[i] += Q[0..15, chunk] K[key tile w + 4 i, chunk]^T
__device__ __forceinline__ void scores_chunk(const float* qc, const float* kc,
                                             int ntiles, int w, int g, int t,
                                             float acc[16][4]) {
  constexpr int LDC = Layout<float>::LDC;
#pragma unroll
  for (int kk = 0; kk < Layout<float>::DC; kk += 8) {
    uint32_t ah[4], al[4];
    frag_a_tf32(qc + kk, LDC, g, t, ah, al);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (w + 4 * i < ntiles) {
        uint32_t bh[2], bl[2];
        frag_bt_tf32(kc + (w + 4 * i) * 8 * LDC + kk, LDC, g, t, bh, bl);
        mma_3xtf32(acc[i], ah, al, bh, bl);
      }
    }
  }
}

__device__ __forceinline__ void scores_chunk(const __nv_bfloat16* qc,
                                             const __nv_bfloat16* kc,
                                             int ntiles, int w, int g, int t,
                                             float acc[16][4]) {
  constexpr int LDC = Layout<__nv_bfloat16>::LDC;
#pragma unroll
  for (int kk = 0; kk < Layout<__nv_bfloat16>::DC; kk += 16) {
    uint32_t a[4];
    frag_a_bf16(qc + kk, LDC, g, t, a);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (w + 4 * i < ntiles) {
        uint32_t b[2];
        frag_bt_bf16(kc + (w + 4 * i) * 8 * LDC + kk, LDC, g, t, b);
        mma_bf16(acc[i], a, b);
      }
    }
  }
}

// acc[j] += P[0..15, keys of the tile] V[tile, c0 + 8 j ..] for j < nt
__device__ __forceinline__ void pv_tile(const float* p, int sld,
                                        const float* vt, int ldv, int c0,
                                        int nt, int g, int t,
                                        float acc[8][4]) {
#pragma unroll
  for (int kk = 0; kk < BKV; kk += 8) {
    uint32_t ah[4], al[4];
    frag_a_tf32(p + kk, sld, g, t, ah, al);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nt) {
        uint32_t bh[2], bl[2];
        frag_b_tf32(vt + kk * ldv + c0 + 8 * j, ldv, g, t, bh, bl);
        mma_3xtf32(acc[j], ah, al, bh, bl);
      }
    }
  }
}

__device__ __forceinline__ void pv_tile(const float* p, int sld,
                                        const __nv_bfloat16* vt, int ldv,
                                        int c0, int nt, int g, int t,
                                        float acc[8][4]) {
#pragma unroll
  for (int kk = 0; kk < BKV; kk += 16) {
    uint32_t a[4];
    frag_a_bf16(p + kk, sld, g, t, a);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nt) {
        uint32_t b[2];
        frag_b_bf16(vt + kk * ldv + c0 + 8 * j, ldv, g, t, b);
        mma_bf16(acc[j], a, b);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
smalls_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int nq, int nk,
              int d, float scale, int cols, int copy_bytes) {
  using L_ = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const L_ L(nk, cols);
  float* srow = reinterpret_cast<float*>(smem);  // [TQ][sld]
  T* stages = reinterpret_cast<T*>(smem + L.rows_bytes());

  const size_t bh = blockIdx.z;
  const int q0 = blockIdx.x * TQ;
  const int col0 = blockIdx.y * cols;
  const T* qb = q + bh * nq * d;
  const T* kb = k + bh * nk * d;
  const T* vb = v + bh * nk * d;
  T* ob = o + bh * nq * d;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // 1. scores over d chunks, two stages: q chunk [TQ][LDC], k [nkp][LDC]
  const int ntiles = L.nkp / 8;
  const int nchunks = (d + L_::DC - 1) / L_::DC;
  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  auto load_chunk = [&](int c) {
    T* st = stages + (c & 1) * L.stage;
    copy_tile(st, L_::LDC, qb, q0, TQ, nq, c * L_::DC, L_::DC, d, copy_bytes,
              tid, THREADS);
    copy_tile(st + TQ * L_::LDC, L_::LDC, kb, 0, L.nkp, nk, c * L_::DC,
              L_::DC, d, copy_bytes, tid, THREADS);
  };
  load_chunk(0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) load_chunk(c + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* st = stages + (c & 1) * L.stage;
    scores_chunk(st, st + TQ * L_::LDC, ntiles, w, g, t, acc);
    __syncthreads();  // the stage is free for chunk c + 2
  }

  // the first v tile loads during the softmax
  const int nkt = (nk + BKV - 1) / BKV;
  auto load_v = [&](int kt) {
    copy_tile(stages + (kt & 1) * L.stage, L.ldv, vb, kt * BKV, BKV, nk,
              col0, cols, d, copy_bytes, tid, THREADS);
  };
  load_v(0);
  cp_async_commit();

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = (w + 4 * i) * 8 + 2 * t;
    if (w + 4 * i < ntiles) {
      *reinterpret_cast<float2*>(srow + g * L.sld + col) =
          make_float2(acc[i][0] * scale, acc[i][1] * scale);
      *reinterpret_cast<float2*>(srow + (g + 8) * L.sld + col) =
          make_float2(acc[i][2] * scale, acc[i][3] * scale);
    }
  }
  __syncthreads();

  // 2. exact softmax, one warp per row; p rounded to v's dtype, 0 past nk
  for (int r = w; r < TQ; r += THREADS / 32) {
    float* row = srow + r * L.sld;
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
    for (int j = lane; j < nkt * BKV; j += 32)
      row[j] = j < nk ? round_p(row[j] / sum, T(0.f)) : 0.f;
  }

  // 3. o = P v over 32-key tiles: warp w takes columns w * cols / 4 ..
  const int wc = w * (cols / 4);
  const int nt = cols / 32;
  float oacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) load_v(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this v tile and (at kt = 0) P are visible
    pv_tile(srow + kt * BKV, L.sld, stages + (kt & 1) * L.stage, L.ldv, wc,
            nt, g, t, oacc);
    __syncthreads();  // the stage is free for tile kt + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= nt) continue;
    const int c = col0 + wc + 8 * j + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + g + (e >> 1) * 8;
      const int col = c + (e & 1);
      if (row < nq && col < d) store1(ob + (size_t)row * d + col, oacc[j][e]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int nq, int nk, int d, float scale, int grid_x, int grid_y,
           int cols, int copy_bytes, int smem, void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || nk > MAX_NK || d <= 0 ||
      cols < 32 || cols > 256 || cols % 32 != 0 || grid_x <= 0 ||
      grid_y <= 0 || (long long)grid_x * TQ < nq || (grid_x - 1) * TQ >= nq ||
      (long long)grid_y * cols < d || (grid_y - 1) * cols >= d ||
      grid_y > 65535 ||
      (copy_bytes != 0 && copy_bytes != 4 && copy_bytes != 8 &&
       copy_bytes != 16) ||
      (copy_bytes != 0 && (d * (int)sizeof(T)) % copy_bytes != 0) ||
      (size_t)smem < Layout<T>(nk, cols).smem_bytes() || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  // opt in to the card's largest shared memory once per device
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(smalls_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  smalls_kernel<T><<<dim3(grid_x, grid_y, bh), THREADS, smem,
                     (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), nq, nk, d, scale, cols,
      copy_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frido_smalls_attention_f32(const void* q, const void* k,
                                          const void* v, void* o, int bh,
                                          int nq, int nk, int d, float scale,
                                          int grid_x, int grid_y, int cols,
                                          int copy_bytes, int smem,
                                          void* stream) {
  return launch<float>(q, k, v, o, bh, nq, nk, d, scale, grid_x, grid_y, cols,
                       copy_bytes, smem, stream);
}

extern "C" int frido_smalls_attention_bf16(const void* q, const void* k,
                                           const void* v, void* o, int bh,
                                           int nq, int nk, int d, float scale,
                                           int grid_x, int grid_y, int cols,
                                           int copy_bytes, int smem,
                                           void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, nq, nk, d, scale, grid_x,
                               grid_y, cols, copy_bytes, smem, stream);
}

extern "C" const char* frido_smalls_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
