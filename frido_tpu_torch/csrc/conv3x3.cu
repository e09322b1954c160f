// 3x3 / stride-1 / pad-1 convolution for Hopper (sm_90a), fp32 and bf16,
// NCHW, with an optional GroupNorm -> SPADE -> SiLU prologue.
//
// Replaces two TPU kernels of frido_tpu/ops/pallas/conv_pallas.py:
// - :177 `conv3x3_pallas` (`_conv_forward` :146, `_conv_kernel` :74):
//   y = conv(x, w) + bias, accumulated in fp32;
// - :376 `conv3x3_norm_silu_pallas` (`_fused_forward` :275,
//   `_fused_kernel` :199): the UNet ResBlock prologue folded into the same
//   conv. Per input element, in fp32: GroupNorm (x - mean) * rstd * w + b
//   (folded here into x * scale_nc + shift_nc), then, with SPADE,
//   * (1 + gamma) + beta with per-pixel gamma and beta, then SiLU, then ONE
//   rounding to the activation dtype (conv_pallas.py:230-236). The zero
//   padding comes after the prologue (`jnp.pad(xn)`, :237): a halo tap
//   reads 0, not prologue(0).
// The bias arrives in the activation dtype and is added in fp32.
//
// What bounds it: at the UNet's sites (M = N*H*W = 64 .. 4096 pixels,
// Cout = 4 .. 960, K = 9*Cin = 36 .. 17280) and the decoder's 256^2 fp32
// sites (M = 262,144, Cout = Cin = 128) the product is 2*M*Cout*K
// operations against a few bytes per output: bound by arithmetic. The
// kernel computes on the CUDA cores in fp32 for both dtypes.
//
// Design, a plain first version that is right (no wgmma or TMA yet): an
// implicit GEMM, C[M, Cout] = A[M, K] B[K, Cout], with A gathered from the
// NCHW input on the fly (k = ci*9 + ky*3 + kx, the order of the
// [Cout, Cin, 3, 3] weight) and B the weight read as [Cout, K]. One block
// of 256 threads per 64-pixel x 64-channel output tile; K goes through
// shared memory 16 at a time; each thread accumulates 4 pixels (strided by
// 16, so stores coalesce) x 4 channels in fp32 registers. Tile edges in
// M, Cout and K are masked, so Cin and Cout of 4 work. The prologue is
// applied as A is staged, so the normalised activation never goes to
// device memory; it is recomputed for each of the 9 taps and each channel
// tile that reads an element.
// The fused op is two launches: a statistics kernel (one block per
// (sample, group), group_stats.cuh) writes scale and shift [N, Cin] in
// fp32, then the conv kernel reads them.
//
// Each C entry point returns cudaGetLastError() (or the configuration
// error) as an int; the Python wrapper raises on anything but 0.

#include "group_stats.cuh"

#include <math.h>

namespace {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // reduction depth per shared-memory stage
constexpr int BLD = BN + 4;   // row stride of the weight stage
constexpr int THREADS = 256;
constexpr int STATS_THREADS = 512;

template <typename T, bool FUSED, bool SPADE>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, const float* __restrict__ nscale,
               const float* __restrict__ nshift, const T* __restrict__ gamma,
               const T* __restrict__ beta, T* __restrict__ y, int n, int cin,
               int h, int wd, int cout) {
  __shared__ __align__(16) float as[BK][BM];
  __shared__ __align__(16) float bs[BK][BLD];
  const int hw = h * wd;
  const int m_total = n * hw;
  const int k_total = cin * 9;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // A staging: this thread's pixel (fixed) and reduction rows a_k + 4 i
  const int a_m = tid % BM;
  const int a_k = tid / BM;
  const int m = m0 + a_m;
  const bool m_ok = m < m_total;
  int img = 0, oy = 0, ox = 0;
  if (m_ok) {
    img = m / hw;
    const int r = m - img * hw;
    oy = r / wd;
    ox = r - oy * wd;
  }
  const size_t img_off = (size_t)img * cin * hw;
  // B staging: reduction row b_k, channels b_n + 16 i
  const int b_k = tid % BK;
  const int b_n = tid / BK;
  // compute: pixels tm + 16 i, channels tn * 4 + j
  const int tm = tid % 16;
  const int tn = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = a_k + 4 * i;
      const int k = k0 + kr;
      float v = 0.f;  // the halo and the ragged edges stay 0
      if (m_ok && k < k_total) {
        const int ci = k / 9;
        const int tap = k - ci * 9;
        const int ky = tap / 3;
        const int iy = oy + ky - 1;
        const int ix = ox + (tap - ky * 3) - 1;
        if (iy >= 0 && iy < h && ix >= 0 && ix < wd) {
          const size_t off = img_off + (size_t)ci * hw + iy * wd + ix;
          v = frido::to_f32(x[off]);
          if (FUSED) {
            const int nc = img * cin + ci;
            v = fmaf(v, nscale[nc], nshift[nc]);
            if (SPADE)
              v = fmaf(v, 1.f + frido::to_f32(gamma[off]),
                       frido::to_f32(beta[off]));
            v = frido::to_f32(frido::from_f32<T>(frido::silu(v)));
          }
        }
      }
      as[kr][a_m] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = b_n + 16 * i;
      const int co = n0 + col;
      const int k = k0 + b_k;
      bs[b_k][col] = (co < cout && k < k_total)
                         ? frido::to_f32(w[(size_t)co * k_total + k])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tn * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = as[kk][tm + 16 * i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mo = m0 + tm + 16 * i;
    if (mo >= m_total) continue;
    const int im = mo / hw;
    const int r = mo - im * hw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tn * 4 + j;
      if (co < cout)
        y[((size_t)im * cout + co) * hw + r] =
            frido::from_f32<T>(acc[i][j] + frido::to_f32(bias[co]));
    }
  }
}

// scale = rstd * w_c and shift = b_c - mean * scale for every (n, c)
template <typename T, bool VEC>
__global__ void __launch_bounds__(STATS_THREADS)
group_affine_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ scale,
                    float* __restrict__ shift, int c, int groups, int hw,
                    float eps) {
  __shared__ float red[64];
  const int ng = blockIdx.x;  // n * groups + g
  const int cg = c / groups;
  const int count = cg * hw;
  const float2 st = frido::group_mean_rstd<T, STATS_THREADS, VEC>(
      x + (size_t)ng * count, count, eps, red);
  const int nc0 = ng * cg;              // n * c + g * cg
  const int c0 = (ng % groups) * cg;
  for (int i = threadIdx.x; i < cg; i += STATS_THREADS) {
    const float a = st.y * w[c0 + i];
    scale[nc0 + i] = a;
    shift[nc0 + i] = b[c0 + i] - st.x * a;
  }
}

int check_dims(int n, int cin, int h, int wd, int cout) {
  if (n <= 0 || cin <= 0 || h <= 0 || wd <= 0 || cout <= 0 ||
      (long long)n * cin * h * wd > 2147483647LL ||
      (long long)n * cout * h * wd > 2147483647LL ||
      (long long)cout * cin * 9 > 2147483647LL ||
      (cout + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, bool FUSED, bool SPADE>
int launch_conv(const void* x, const void* w, const void* b,
                const float* nscale, const float* nshift, const void* gamma,
                const void* beta, void* y, int n, int cin, int h, int wd,
                int cout, cudaStream_t stream) {
  const int m_total = n * h * wd;
  const dim3 grid((m_total + BM - 1) / BM, (cout + BN - 1) / BN);
  conv3x3_kernel<T, FUSED, SPADE><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), nscale, nshift, static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y), n, cin, h, wd, cout);
  return (int)cudaGetLastError();
}

template <typename T>
int conv(const void* x, const void* w, const void* b, void* y, int n, int cin,
         int h, int wd, int cout, void* stream) {
  if (int err = check_dims(n, cin, h, wd, cout)) return err;
  return launch_conv<T, false, false>(x, w, b, nullptr, nullptr, nullptr,
                                      nullptr, y, n, cin, h, wd, cout,
                                      (cudaStream_t)stream);
}

template <typename T>
int conv_norm_silu(const void* x, const void* w, const void* b,
                   const void* norm_w, const void* norm_b, const void* gamma,
                   const void* beta, void* scale, void* shift, void* y, int n,
                   int cin, int h, int wd, int cout, int groups, float eps,
                   void* stream) {
  if (int err = check_dims(n, cin, h, wd, cout)) return err;
  if (groups <= 0 || cin % groups != 0 || (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int hw = h * wd;
  const T* xt = static_cast<const T*>(x);
  const float* nw = static_cast<const float*>(norm_w);
  const float* nb = static_cast<const float*>(norm_b);
  float* sc = static_cast<float*>(scale);
  float* sh = static_cast<float*>(shift);
  if (((cin / groups) * hw) % 4 == 0)
    group_affine_kernel<T, true><<<n * groups, STATS_THREADS, 0, s>>>(
        xt, nw, nb, sc, sh, cin, groups, hw, eps);
  else
    group_affine_kernel<T, false><<<n * groups, STATS_THREADS, 0, s>>>(
        xt, nw, nb, sc, sh, cin, groups, hw, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (gamma != nullptr)
    return launch_conv<T, true, true>(x, w, b, sc, sh, gamma, beta, y, n, cin,
                                      h, wd, cout, s);
  return launch_conv<T, true, false>(x, w, b, sc, sh, nullptr, nullptr, y, n,
                                     cin, h, wd, cout, s);
}

}  // namespace

extern "C" int frido_conv3x3_f32(const void* x, const void* w, const void* b,
                                 void* y, int n, int cin, int h, int wd,
                                 int cout, void* stream) {
  return conv<float>(x, w, b, y, n, cin, h, wd, cout, stream);
}

extern "C" int frido_conv3x3_bf16(const void* x, const void* w, const void* b,
                                  void* y, int n, int cin, int h, int wd,
                                  int cout, void* stream) {
  return conv<__nv_bfloat16>(x, w, b, y, n, cin, h, wd, cout, stream);
}

extern "C" int frido_conv3x3_norm_silu_f32(
    const void* x, const void* w, const void* b, const void* norm_w,
    const void* norm_b, const void* gamma, const void* beta, void* scale,
    void* shift, void* y, int n, int cin, int h, int wd, int cout, int groups,
    float eps, void* stream) {
  return conv_norm_silu<float>(x, w, b, norm_w, norm_b, gamma, beta, scale,
                               shift, y, n, cin, h, wd, cout, groups, eps,
                               stream);
}

extern "C" int frido_conv3x3_norm_silu_bf16(
    const void* x, const void* w, const void* b, const void* norm_w,
    const void* norm_b, const void* gamma, const void* beta, void* scale,
    void* shift, void* y, int n, int cin, int h, int wd, int cout, int groups,
    float eps, void* stream) {
  return conv_norm_silu<__nv_bfloat16>(x, w, b, norm_w, norm_b, gamma, beta,
                                       scale, shift, y, n, cin, h, wd, cout,
                                       groups, eps, stream);
}

extern "C" const char* frido_conv3x3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
