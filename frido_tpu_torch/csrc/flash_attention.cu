// Non-causal flash attention for Hopper (sm_90a) on the tensor cores, fp32
// and bf16 inputs.
//
// Replaces the TPU kernel frido_tpu/ops/pallas/attention.py:301
// `flash_attention` (`_flash_forward` :127, `_flash_kernel` :49): per
// (batch*head) o = softmax(q k^T * scale) v with an online softmax whose
// running max, sum and accumulator are fp32; kv rows past the end are
// masked; a row whose sum stays 0 is divided by 1. In bf16 each key tile's
// un-normalised exp(s - m_new) is rounded to bf16 before P.V, as
// `p.astype(v.dtype)` (attention.py:84), while the row sum takes it in
// fp32.
//
// What bounds it: at the main-path site (VQGAN decoder AttnBlock, one
// head, N = 1024 tokens, d = 512, fp32) the two products are 4*N*N*d
// operations against 4*N*d*4 bytes, about 256 per byte: arithmetic. In
// fp32 the products run as 3xTF32 (attention_mma.cuh: three tf32 mma per
// product, fp32-accurate), so the least time is 3x the operations at the
// TF32 tensor-core rate; bf16 runs one bf16 mma per product. Inside the
// kernel more limits bind: every query tile streams all of K and V from L2
// (2 nk d itemsize bytes per BQ query rows); the [BQ, d] fp32 output
// accumulator must fit the registers; and in fp32 each warp splits every
// fragment element it loads into tf32 hi and lo, the Q tile again for each
// key tile (its hi and lo would not both fit in shared memory), so the
// splits and loads take more issue slots than the mma themselves.
//
// Design (mma.sync, cp.async; one launch per call):
// - one block of 8 warps per (BQ-row query tile, batch*head). BQ is 64
//   where the grid still has a block per SM (the decode chunk of 32,
//   [32, 1024, 512]: 512 blocks), which halves the L2 traffic of BQ = 32;
//   else 32 (the main path's batch of 4: 128 blocks). The host plan
//   (frido_tpu_torch/ops/cuda/attention.py, `flash_plan`) chooses;
// - the accumulator binds: warp w owns rows 16 MH (w % 2) .. (MH = BQ / 32
//   m-tiles) x the columns of one d/4 slab, 64 MH fp32 registers at
//   d = 512;
// - Q stays in shared memory; K and V have a buffer each of BK keys (32,
//   or 16 in fp32 at BQ = 64), filled by cp.async (zero past nk): K of
//   the next tile loads while P.V runs on this one, V of this tile while
//   its scores run. At fp32, d = 512, BQ = 64: Q 132 KB + K 33 + V 33 +
//   partial scores 20 = 219 KB, one block per SM;
// - S = Q K^T [BQ, BK]: warp w takes its MH m-tiles and a quarter of the d
//   steps (split-K, so each K fragment feeds MH mma and each Q fragment
//   BK/8), writes its partial tile to shared memory; the softmax sums the
//   four partials;
// - softmax: 256 / BQ threads per row, running (m, l) kept per thread and
//   reduced with shuffles; P goes back to shared memory. The accumulator
//   is rescaled only where a row's maximum moved (alpha != 1 in the warp);
// - P.V: where a warp's d/4 slab is all 16 column tiles (d = 512) the
//   tiles take no guard: a guard is a branch, and ptxas does not overlap
//   the loads and products of one tile with those of the next across it;
// - d is zero-padded to the mma depth (8 tf32, 16 bf16); row strides are
//   padded so the fragment loads of a warp fall on distinct banks at
//   d = 512 (Q, K: 4 mod 32 words; V: 8 mod 32 words in fp32).
//
// The launcher checks the plan it is given against `Layout::smem_bytes`.
// Each C entry point returns cudaGetLastError() (or the configuration
// error) as an int; the Python wrapper raises on anything but 0.

#include "attention_mma.cuh"

#include <math.h>

namespace {

using namespace frido::attn;

constexpr int THREADS = 256;
constexpr int MAX_D = 512;
constexpr int MAX_SMEM = 232448;

// keys per tile: 32, or 16 in fp32 at BQ = 64, where a 32-key K and V
// would not fit beside the 132 KB Q tile at d = 512
template <typename T, int MH>
struct Tile {
  static constexpr int BQ = 32 * MH;
  static constexpr int KSTEP = sizeof(T) == 4 ? 8 : 16;  // mma depth
  static constexpr int BK = sizeof(T) == 4 && MH == 2 ? 16 : 32;
  static constexpr int SP_LD = BK + 4;  // row stride of the partial scores
};

template <typename T, int MH>
struct Layout {
  using Tl = Tile<T, MH>;
  int dp, ldqk, ldv;
  __host__ __device__ explicit Layout(int d)
      : dp(round_up(d, Tl::KSTEP)),
        ldqk(dp + (sizeof(T) == 4 ? 4 : 8)),
        ldv(dp + 8) {}
  __host__ __device__ size_t tiles_bytes() const {
    return sizeof(T) *
           ((size_t)(Tl::BQ + Tl::BK) * ldqk + (size_t)Tl::BK * ldv);
  }
  __host__ __device__ size_t smem_bytes() const {
    return tiles_bytes() +
           sizeof(float) * (4 * Tl::BQ * Tl::SP_LD + 2 * Tl::BQ);
  }
};

template <int N>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int N>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// partial S over k-steps kq, kq + 4, ... for MH m-tiles from row m0 and
// NT key tiles of 8
template <int MH, int NT>
__device__ __forceinline__ void scores(const float* qs, const float* ks,
                                       int ldqk, int dp, int m0, int kq,
                                       int g, int t, float acc[MH][NT][4]) {
#pragma unroll 2
  for (int kk = kq * 8; kk < dp; kk += 32) {
    uint32_t ah[MH][4], al[MH][4];
#pragma unroll
    for (int m = 0; m < MH; ++m)
      frag_a_tf32(qs + (m0 + 16 * m) * ldqk + kk, ldqk, g, t, ah[m], al[m]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bh[2], bl[2];
      frag_bt_tf32(ks + n * 8 * ldqk + kk, ldqk, g, t, bh, bl);
#pragma unroll
      for (int m = 0; m < MH; ++m)
        mma_3xtf32(acc[m][n], ah[m], al[m], bh, bl);
    }
  }
}

template <int MH, int NT>
__device__ __forceinline__ void scores(const __nv_bfloat16* qs,
                                       const __nv_bfloat16* ks, int ldqk,
                                       int dp, int m0, int kq, int g, int t,
                                       float acc[MH][NT][4]) {
  for (int kk = kq * 16; kk < dp; kk += 64) {
    uint32_t a[MH][4];
#pragma unroll
    for (int m = 0; m < MH; ++m)
      frag_a_bf16(qs + (m0 + 16 * m) * ldqk + kk, ldqk, g, t, a[m]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b[2];
      frag_bt_bf16(ks + n * 8 * ldqk + kk, ldqk, g, t, b);
#pragma unroll
      for (int m = 0; m < MH; ++m) mma_bf16(acc[m][n], a[m], b);
    }
  }
}

// acc[m][j] += P[m0 + 16 m .., tile] V[tile, c0 + 8 j ..] for j < nt;
// FULL: nt is 16, and no column tile takes a guard
template <int MH, bool FULL>
__device__ __forceinline__ void pv(const float* ps, const float* vs, int ldv,
                                   int m0, int c0, int nt, int g, int t,
                                   float acc[MH][16][4]) {
  constexpr int LD = Tile<float, MH>::SP_LD;
#pragma unroll
  for (int kk = 0; kk < Tile<float, MH>::BK; kk += 8) {
    uint32_t ah[MH][4], al[MH][4];
#pragma unroll
    for (int m = 0; m < MH; ++m)
      frag_a_tf32(ps + (m0 + 16 * m) * LD + kk, LD, g, t, ah[m], al[m]);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (FULL || j < nt) {
        uint32_t bh[2], bl[2];
        frag_b_tf32(vs + kk * ldv + c0 + 8 * j, ldv, g, t, bh, bl);
#pragma unroll
        for (int m = 0; m < MH; ++m)
          mma_3xtf32(acc[m][j], ah[m], al[m], bh, bl);
      }
    }
  }
}

template <int MH, bool FULL>
__device__ __forceinline__ void pv(const float* ps, const __nv_bfloat16* vs,
                                   int ldv, int m0, int c0, int nt, int g,
                                   int t, float acc[MH][16][4]) {
  constexpr int LD = Tile<__nv_bfloat16, MH>::SP_LD;
#pragma unroll
  for (int kk = 0; kk < Tile<__nv_bfloat16, MH>::BK; kk += 16) {
    uint32_t a[MH][4];
#pragma unroll
    for (int m = 0; m < MH; ++m)
      frag_a_bf16(ps + (m0 + 16 * m) * LD + kk, LD, g, t, a[m]);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (FULL || j < nt) {
        uint32_t b[2];
        frag_b_bf16(vs + kk * ldv + c0 + 8 * j, ldv, g, t, b);
#pragma unroll
        for (int m = 0; m < MH; ++m) mma_bf16(acc[m][j], a[m], b);
      }
    }
  }
}

template <typename T, int MH>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int nq, int nk,
             int d, float scale, int copy_bytes) {
  constexpr int BQ = Tile<T, MH>::BQ;
  constexpr int BK = Tile<T, MH>::BK;
  constexpr int SP_LD = Tile<T, MH>::SP_LD;
  constexpr int NTS = BK / 8;        // score n-tiles of a warp
  constexpr int TPR = THREADS / BQ;  // softmax threads per row
  constexpr int KPT = BK / TPR;      // keys per softmax thread
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T, MH> L(d);
  T* qs = reinterpret_cast<T*>(smem);           // [BQ][ldqk]
  T* ks = qs + BQ * L.ldqk;                     // [BK][ldqk]
  T* vs = ks + BK * L.ldqk;                     // [BK][ldv]
  float* sp = reinterpret_cast<float*>(smem + L.tiles_bytes());
  float* alpha_s = sp + 4 * BQ * SP_LD;         // [BQ]
  float* l_s = alpha_s + BQ;                    // [BQ]
  float* ps = sp;                               // P overwrites partial 0

  const size_t bh = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + bh * nq * d;
  const T* kb = k + bh * nk * d;
  const T* vb = v + bh * nk * d;
  T* ob = o + bh * nq * d;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // zero the mma padding of d once; the copies never write there
  const int pqk = L.ldqk - d;
  for (int i = tid; i < (BQ + BK) * pqk; i += THREADS)
    qs[(i / pqk) * L.ldqk + d + i % pqk] = T(0.f);  // Q, then K rows
  const int pvd = L.ldv - d;
  for (int i = tid; i < BK * pvd; i += THREADS)
    vs[(i / pvd) * L.ldv + d + i % pvd] = T(0.f);

  copy_tile(qs, L.ldqk, qb, q0, BQ, nq, 0, d, d, copy_bytes, tid, THREADS);
  copy_tile(ks, L.ldqk, kb, 0, BK, nk, 0, d, d, copy_bytes, tid, THREADS);
  cp_async_commit();
  copy_tile(vs, L.ldv, vb, 0, BK, nk, 0, d, d, copy_bytes, tid, THREADS);
  cp_async_commit();

  // S and P.V: rows m0 .. m0 + 16 MH - 1; S: k-steps kq, kq + 4, ...;
  // P.V: columns oc0 + 8 j for j < nt
  const int m0 = (warp & 1) * 16 * MH;
  const int kq = warp >> 1;
  const int slab = (round_up(d, 8) / 8 + 3) / 4 * 8;
  const int oc0 = kq * slab;
  const int nt = max(0, min(slab, round_up(d, 8) - oc0)) / 8;
  // softmax: row sr, keys sc .. sc + KPT - 1
  const int sr = tid / TPR;
  const int sc = (tid % TPR) * KPT;

  float acc[MH][16][4];
#pragma unroll
  for (int m = 0; m < MH; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < nk; k0 += BK) {
    cp_async_wait<1>();  // Q and this K tile are in
    __syncthreads();

    float s[MH][NTS][4];
#pragma unroll
    for (int m = 0; m < MH; ++m)
#pragma unroll
      for (int n = 0; n < NTS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][n][e] = 0.f;
    scores<MH, NTS>(qs, ks, L.ldqk, L.dp, m0, kq, g, t, s);
    float* part = sp + kq * BQ * SP_LD;
#pragma unroll
    for (int m = 0; m < MH; ++m) {
      const int r = m0 + 16 * m + g;
#pragma unroll
      for (int n = 0; n < NTS; ++n) {
        *reinterpret_cast<float2*>(part + r * SP_LD + 8 * n + 2 * t) =
            make_float2(s[m][n][0], s[m][n][1]);
        *reinterpret_cast<float2*>(part + (r + 8) * SP_LD + 8 * n + 2 * t) =
            make_float2(s[m][n][2], s[m][n][3]);
      }
    }
    __syncthreads();  // K read by all; partial scores visible

    if (k0 + BK < nk)
      copy_tile(ks, L.ldqk, kb, k0 + BK, BK, nk, 0, d, d, copy_bytes, tid,
                THREADS);
    cp_async_commit();

    // online softmax over this tile; it holds >= 1 valid key, so the new
    // max is finite
    float x[KPT];
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < KPT; ++e) {
      const int at = sr * SP_LD + sc + e;
      const float sum4 = (sp[at] + sp[BQ * SP_LD + at]) +
                         (sp[2 * BQ * SP_LD + at] + sp[3 * BQ * SP_LD + at]);
      x[e] = (k0 + sc + e < nk) ? sum4 * scale : -INFINITY;
      mx = fmaxf(mx, x[e]);
    }
    mx = group_max<TPR>(mx);
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < KPT; ++e) {
      const float p = (k0 + sc + e < nk) ? expf(x[e] - m_new) : 0.f;
      sum += p;
      ps[sr * SP_LD + sc + e] = round_p(p, T(0.f));
    }
    sum = group_sum<TPR>(sum);
    l_run = alpha * l_run + sum;
    m_run = m_new;
    if (tid % TPR == 0) alpha_s[sr] = alpha;

    cp_async_wait<1>();  // this V tile is in
    __syncthreads();     // P and alpha visible

#pragma unroll
    for (int m = 0; m < MH; ++m) {
      const float a0 = alpha_s[m0 + 16 * m + g];
      const float a1 = alpha_s[m0 + 16 * m + g + 8];
      // once the running maxima settle alpha is 1 in every row of the warp
      if (!__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[m][j][0] *= a0;
        acc[m][j][1] *= a0;
        acc[m][j][2] *= a1;
        acc[m][j][3] *= a1;
      }
    }
    if (nt == 16)
      pv<MH, true>(ps, vs, L.ldv, m0, oc0, nt, g, t, acc);
    else
      pv<MH, false>(ps, vs, L.ldv, m0, oc0, nt, g, t, acc);
    __syncthreads();  // V and P read by all

    if (k0 + BK < nk)
      copy_tile(vs, L.ldv, vb, k0 + BK, BK, nk, 0, d, d, copy_bytes, tid,
                THREADS);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (tid % TPR == 0) l_s[sr] = l_run;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MH; ++m) {
    const int r0 = m0 + 16 * m + g;
    float l0 = l_s[r0];
    float l1 = l_s[r0 + 8];
    l0 = (l0 == 0.f) ? 1.f : l0;
    l1 = (l1 == 0.f) ? 1.f : l1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = oc0 + 8 * j + 2 * t;
      if (j >= nt || col >= d) continue;  // d is even: col + 1 < d too
      if (q0 + r0 < nq)
        store2(ob + (size_t)(q0 + r0) * d + col, acc[m][j][0] / l0,
               acc[m][j][1] / l0);
      if (q0 + r0 + 8 < nq)
        store2(ob + (size_t)(q0 + r0 + 8) * d + col, acc[m][j][2] / l1,
               acc[m][j][3] / l1);
    }
  }
}

// opt in to the card's largest shared memory once per (kernel, device)
template <typename T, int MH>
cudaError_t configure() {
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(flash_kernel<T, MH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured |= 1u << dev;
  }
  return cudaSuccess;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int nq, int nk, int d, float scale, int rows, int grid_x,
           int copy_bytes, int smem, void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || d <= 0 || d > MAX_D ||
      (d & 3) != 0 || (rows != 32 && rows != 64) || grid_x <= 0 ||
      (long long)grid_x * rows < nq || (grid_x - 1) * rows >= nq ||
      (copy_bytes != 16 && copy_bytes != 8 && copy_bytes != 4) ||
      (d * (int)sizeof(T)) % copy_bytes != 0 ||
      (size_t)smem < (rows == 64 ? Layout<T, 2>(d).smem_bytes()
                                 : Layout<T, 1>(d).smem_bytes()) ||
      smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = rows == 64 ? configure<T, 2>() : configure<T, 1>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(grid_x, 1, bh);
  const cudaStream_t s = (cudaStream_t)stream;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  T* to = static_cast<T*>(o);
  if (rows == 64)
    flash_kernel<T, 2><<<grid, THREADS, smem, s>>>(tq, tk, tv, to, nq, nk, d,
                                                   scale, copy_bytes);
  else
    flash_kernel<T, 1><<<grid, THREADS, smem, s>>>(tq, tk, tv, to, nq, nk, d,
                                                   scale, copy_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frido_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, int bh,
                                         int nq, int nk, int d, float scale,
                                         int rows, int grid_x, int copy_bytes,
                                         int smem, void* stream) {
  return launch<float>(q, k, v, o, bh, nq, nk, d, scale, rows, grid_x,
                       copy_bytes, smem, stream);
}

extern "C" int frido_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, int bh,
                                          int nq, int nk, int d, float scale,
                                          int rows, int grid_x,
                                          int copy_bytes, int smem,
                                          void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, nq, nk, d, scale, rows,
                               grid_x, copy_bytes, smem, stream);
}

extern "C" const char* frido_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
