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
// Design: one thread per row keeps its z in registers and scans the whole
// codebook in increasing k with a strict "<", which gives ties to the
// lowest index without any merge. The codebook is staged through shared
// memory in tiles of about 40 KB together with |e|^2 computed once per
// tile; all threads of a warp read the same code at the same time, a
// shared-memory broadcast. 128 threads per block give 256 blocks at
// N = 32768, about two per SM.
//
// Each C entry point returns cudaGetLastError() (or the configuration
// error) as an int; the Python wrapper raises on anything but 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;

template <int D>
struct Tile {
  static constexpr int codes = (40 * 1024) / (4 * (D + 1));
};

template <int D>
__global__ void __launch_bounds__(THREADS)
vq_kernel(const float* __restrict__ z, const float* __restrict__ e,
          int* __restrict__ idx, int n, int k) {
  constexpr int TILE = Tile<D>::codes;
  __shared__ float es[TILE * D];
  __shared__ float esq[TILE];

  const int row = blockIdx.x * THREADS + threadIdx.x;
  float zr[D];
#pragma unroll
  for (int j = 0; j < D; ++j)
    zr[j] = row < n ? z[(size_t)row * D + j] : 0.f;

  float best = INFINITY;
  int best_i = 0;
  for (int t0 = 0; t0 < k; t0 += TILE) {
    const int tn = min(TILE, k - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < tn * D; i += THREADS)
      es[i] = e[(size_t)t0 * D + i];
    __syncthreads();
    for (int i = threadIdx.x; i < tn; i += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) s += es[i * D + j] * es[i * D + j];
      esq[i] = s;
    }
    __syncthreads();
    for (int i = 0; i < tn; ++i) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) dot = fmaf(zr[j], es[i * D + j], dot);
      const float dist = esq[i] - 2.f * dot;
      if (dist < best) {
        best = dist;
        best_i = t0 + i;
      }
    }
  }
  if (row < n) idx[row] = best_i;
}

template <int D>
int launch(const float* z, const float* e, int* idx, int n, int k,
           cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  vq_kernel<D><<<blocks, THREADS, 0, stream>>>(z, e, idx, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frido_vq_argmin(const void* z, const void* e, void* idx, int n,
                               int k, int d, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const float* zf = static_cast<const float*>(z);
  const float* ef = static_cast<const float*>(e);
  int* out = static_cast<int*>(idx);
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {  // the embed dims of the repo's configs
    case 3: return launch<3>(zf, ef, out, n, k, s);
    case 4: return launch<4>(zf, ef, out, n, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* frido_vq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
