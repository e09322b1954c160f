// Nearest-codebook argmin for Hopper (sm_90a).
//
// Replaces the TPU kernel frido_tpu/ops/pallas/vq_pallas.py:74
// `vq_argmin` (`_vq_kernel` :30): for each of N latent rows z (fp32, D
// values) return the int32 index k minimising |e_k|^2 - 2 z.e_k over a
// [K, D] fp32 codebook (|z|^2 is constant per row and dropped), ties to
// the lowest index. The gather of the chosen rows stays outside.
//
// What bounds it: with D = 4 and K = 8192 (the MS-VQGAN decode lookup) a
// row needs 8192 * (2 * 4 + 1) operations against 20 bytes of input and 4
// of output, so it is bound by arithmetic (fp32 CUDA cores), and the
// [N, K] distance matrix that the plain version writes never exists here.
//
// Arithmetic, in this order: |e|^2 = e0*e0, then fmaf(e_j, e_j, .) for
// j = 1..D-1; the distance is an FMA chain that starts at |e|^2 and adds
// (-2 z_j) * e_j for j = 0..D-1 (-2 z is exact). Every distance of a
// (row, code) pair is computed by this one sequence, so the scan and its
// re-scan below give the same bits.
//
// Design (the host plan, ops/cuda/vq.py `vq_plan`, picks R, the warps a
// CTA and the CTAs a cluster):
//
// - A warp owns 32 * R rows, R (2, 4 or 8) in each thread's registers, so
//   one broadcast read of a code from shared memory serves R rows. The
//   CTAs of one cluster and the warps of each CTA all own the same rows
//   and split the codebook into parts of `ks` codes: part p = rank * warps
//   + warp holds codes [p * ks, (p + 1) * ks). The plan aims at one CTA of
//   8 warps on each of 128 SMs with the longest scans that leaves (at the
//   main path's N = 4096: 64-row tiles, the codebook over clusters of 2,
//   512 codes a thread; at N = 32768: 256-row tiles, no cluster).
// - Each CTA stages its parts of the codebook (with |e|^2 beside each
//   code, computed once per staged code) into shared memory once, behind
//   one barrier; codes past K are staged as e = 0, |e|^2 = +inf and never
//   win. A part larger than the shared memory is staged in rounds of
//   `kr` codes (one round for the repo's codebooks, K = 8192, at every N).
// - The scan keeps, per row, only the running minimum (one fminf per
//   code) and the 16-code chunk where it last went down (strict <, so the
//   earliest chunk); after each round every row re-scans its chunk for the
//   first code whose distance equals the minimum, lanes staggered across
//   the chunk so that their reads do not meet in one bank. That gives the
//   lowest index among equal distances in the part without an index
//   select per code.
// - Merge, lexicographic on (distance, index): the warps' (min, index)
//   pairs in warp order through shared memory (strict <), then the
//   cluster's CTAs in rank order through distributed shared memory, each
//   CTA finishing its share of the rows. Parts in increasing order of
//   code, strict < at each step: the lowest index wins a tie, the same
//   result from run to run, one launch and no atomics.
//
// Each C entry point returns cudaGetLastError() (or the configuration
// error) as an int; the Python wrapper raises on anything but 0.

#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

namespace {

namespace cl = frido::cluster;

constexpr int CHUNK = 16;  // codes between the scan's index updates
constexpr int MAX_SMEM = 232448;
constexpr int MAX_WARPS = 8;
constexpr int MAX_CLUSTER = 8;
constexpr int STAGE = 4;   // codes a thread loads before it stores them

// A staged code: D = 3 packs (e0, e1, e2, |e|^2) in one float4; D = 4
// keeps |e|^2 in a second array.
template <int D>
struct Codes {
  float4* e;
  float* esq;
  __device__ __forceinline__ void put(int i, const float* v) const {
    float s = __fmul_rn(v[0], v[0]);
#pragma unroll
    for (int j = 1; j < D; ++j) s = fmaf(v[j], v[j], s);
    if (D == 3) {
      e[i] = make_float4(v[0], v[1], v[2], s);
    } else {
      e[i] = make_float4(v[0], v[1], v[2], v[3]);
      esq[i] = s;
    }
  }
  __device__ __forceinline__ void pad(int i) const {
    e[i] = make_float4(0.f, 0.f, 0.f, D == 3 ? INFINITY : 0.f);
    if (D == 4) esq[i] = INFINITY;
  }
  // code i as (e0, e1, e2, e3 or |e|^2) and |e|^2
  __device__ __forceinline__ float4 get(int i, float& s) const {
    const float4 v = e[i];
    s = D == 3 ? v.w : esq[i];
    return v;
  }
};

// distance of the row (zm = -2 z) to the code (v, |e|^2 = s)
template <int D>
__device__ __forceinline__ float dist(float4 v, float s, const float* zm) {
  float d = fmaf(zm[0], v.x, s);
  d = fmaf(zm[1], v.y, d);
  d = fmaf(zm[2], v.z, d);
  if (D == 4) d = fmaf(zm[3], v.w, d);
  return d;
}

template <int D>
__host__ __device__ constexpr int code_bytes() {
  return D == 3 ? 16 : 20;
}

template <int D, int R>
__global__ void __launch_bounds__(MAX_WARPS * 32)
vq_kernel(const float* __restrict__ z, const float* __restrict__ e,
          int* __restrict__ idx, int n, int k, int ks, int kr) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ROWS = 32 * R;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned cs = cl::size();
  const unsigned rank = cl::rank();
  const int tile = blockIdx.x / cs;

  const int staged = warps * kr;  // codes staged a round
  Codes<D> codes;
  codes.e = reinterpret_cast<float4*>(smem);
  codes.esq = reinterpret_cast<float*>(codes.e + staged);
  float* mdist = reinterpret_cast<float*>(smem + (size_t)staged *
                                                     code_bytes<D>());
  int* midx = reinterpret_cast<int*>(mdist + warps * ROWS);
  float* cdist = reinterpret_cast<float*>(midx + warps * ROWS);
  int* cidx = reinterpret_cast<int*>(cdist + ROWS);

  float zm[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = tile * ROWS + lane + 32 * r;
#pragma unroll
    for (int j = 0; j < D; ++j)
      zm[r][j] = row < n ? -2.f * z[(size_t)row * D + j] : 0.f;
  }

  const int part = (int)rank * warps + warp;
  const long long lo = (long long)part * ks;  // first code of this part
  float best[R], run[R];
  int bi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best[r] = run[r] = INFINITY;
    bi[r] = (int)min(lo, (long long)k - 1);
  }

  for (int r0 = 0; r0 < ks; r0 += kr) {
    if (r0) __syncthreads();  // the previous round is no longer read
    // STAGE codes a thread at a time: their loads in flight together
    for (int i0 = threadIdx.x; i0 < staged; i0 += STAGE * blockDim.x) {
      float v[STAGE][D];
      long long g[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int i = i0 + u * blockDim.x;
        const int wp = i / kr;
        g[u] = ((long long)rank * warps + wp) * ks + r0 + (i - wp * kr);
        const bool real = i < staged && g[u] < k;
#pragma unroll
        for (int j = 0; j < D; ++j) v[u][j] = real ? e[g[u] * D + j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i >= staged) break;
        if (g[u] < k)
          codes.put(i, v[u]);
        else
          codes.pad(i);
      }
    }
    __syncthreads();

    const int base = warp * kr;
    int bc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) bc[r] = -1;
    for (int c0 = 0; c0 < kr; c0 += CHUNK) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        float s;
        const float4 v = codes.get(base + c0 + j, s);
#pragma unroll
        for (int r = 0; r < R; ++r)
          run[r] = fminf(run[r], dist<D>(v, s, zm[r]));
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (run[r] < best[r]) {
          best[r] = run[r];
          bc[r] = c0;
        }
      }
    }
    // the first code of each improved row's chunk at its minimum
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (bc[r] < 0) continue;
      int first = CHUNK;
      for (int t = 0; t < CHUNK; ++t) {
        const int j = (t + lane) & (CHUNK - 1);
        float s;
        const float4 v = codes.get(base + bc[r] + j, s);
        if (dist<D>(v, s, zm[r]) == best[r] && j < first) first = j;
      }
      bi[r] = (int)(lo + r0 + bc[r] + first);
    }
  }

  // merge the warps' parts in order, then the cluster's CTAs in rank order
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mdist[warp * ROWS + lane + 32 * r] = best[r];
    midx[warp * ROWS + lane + 32 * r] = bi[r];
  }
  __syncthreads();
  for (int row = threadIdx.x; row < ROWS; row += blockDim.x) {
    float bd = mdist[row];
    int bx = midx[row];
    for (int w = 1; w < warps; ++w) {
      const float d = mdist[w * ROWS + row];
      if (d < bd) {
        bd = d;
        bx = midx[w * ROWS + row];
      }
    }
    cdist[row] = bd;
    cidx[row] = bx;
  }
  if (cs > 1) {
    cl::arrive();
    cl::wait();
  } else {
    __syncthreads();
  }
  const int share = ROWS / (int)cs;
  for (int row = (int)rank * share + threadIdx.x;
       row < ((int)rank + 1) * share; row += blockDim.x) {
    float dq[MAX_CLUSTER];
    int xq[MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) {  // all in flight together
      if (cs == 1 && q == 0) {
        dq[0] = cdist[row];
        xq[0] = cidx[row];
      } else if (q < (int)cs) {
        dq[q] = cl::load_remote(&cdist[row], q);
        xq[q] = cl::load_remote(&cidx[row], q);
      }
    }
    float bd = dq[0];
    int bx = xq[0];
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q) {
      if (q < (int)cs && dq[q] < bd) {
        bd = dq[q];
        bx = xq[q];
      }
    }
    const int grow = tile * ROWS + row;
    if (grow < n) idx[grow] = bx;
  }
  if (cs > 1) {  // no CTA exits while another may still read its rows
    cl::arrive();
    cl::wait();
  }
}

template <int D>
int smem_bytes(int warps, int kr, int rows) {
  return warps * kr * code_bytes<D>() + warps * rows * 8 + rows * 8;
}

template <int D, int R>
int launch(const float* z, const float* e, int* idx, int n, int k, int warps,
           int cluster, int ks, int kr, int smem, cudaStream_t s) {
  constexpr int ROWS = 32 * R;
  const long long tiles = (n + ROWS - 1) / ROWS;
  if (warps < 1 || warps > MAX_WARPS || cluster < 1 ||
      cluster > MAX_CLUSTER || ROWS % cluster != 0 || kr < CHUNK ||
      kr % CHUNK != 0 || ks < kr || ks % kr != 0 ||
      (long long)ks * warps * cluster < k ||
      (long long)ks * warps * cluster > 2147483647LL ||
      smem != smem_bytes<D>(warps, kr, ROWS) || smem > MAX_SMEM ||
      tiles * cluster > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  static unsigned configured = 0;
  auto kernel = vq_kernel<D, R>;
  cudaError_t err = cl::configure(kernel, configured, MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  return (int)cl::launch_cluster(kernel, (unsigned)(tiles * cluster),
                                 (unsigned)(warps * 32), (unsigned)smem,
                                 (unsigned)cluster, s, z, e, idx, n, k, ks,
                                 kr);
}

}  // namespace

extern "C" int frido_vq_argmin(const void* z, const void* e, void* idx, int n,
                               int k, int d, int rows, int warps, int cluster,
                               int ks, int kr, int smem, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const float* zf = static_cast<const float*>(z);
  const float* ef = static_cast<const float*>(e);
  int* out = static_cast<int*>(idx);
  cudaStream_t s = (cudaStream_t)stream;
  const int key = d * 10 + rows;  // the embed dims of the repo's configs
  switch (key) {                  // x rows a thread
    case 32: return launch<3, 2>(zf, ef, out, n, k, warps, cluster, ks, kr,
                                 smem, s);
    case 34: return launch<3, 4>(zf, ef, out, n, k, warps, cluster, ks, kr,
                                 smem, s);
    case 42: return launch<4, 2>(zf, ef, out, n, k, warps, cluster, ks, kr,
                                 smem, s);
    case 44: return launch<4, 4>(zf, ef, out, n, k, warps, cluster, ks, kr,
                                 smem, s);
    case 38: return launch<3, 8>(zf, ef, out, n, k, warps, cluster, ks, kr,
                                 smem, s);
    case 48: return launch<4, 8>(zf, ef, out, n, k, warps, cluster, ks, kr,
                                 smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* frido_vq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
