// GroupNorm (+ optional SiLU) for Hopper (sm_90a), fp32 and bf16, NCHW.
//
// Replaces the TPU kernel frido_tpu/ops/pallas/norm_pallas.py:130
// `group_norm_pallas` (`_gn_forward` :85, `_gn_kernel` :38): fp32 one-pass
// statistics per (sample, group), the affine folded into a per-channel
// scale and shift, an optional SiLU in fp32, one rounding to the input
// dtype on store. Unlike the Pallas kernel (norm_pallas.py:58) the variance
// is clamped at 0, as the port's plain version (ops/norm.py) and
// group_norm_jnp do, so a constant group gives finite output (the bias).
//
// What bounds it: a few operations per element against one read and one
// write of the activation, so device-memory bytes. At the decoder's
// [4, 128, 256, 256] fp32 site that is 268 MB moved.
//
// Design, a plain first version that is right: one block of 512 threads
// per (sample, group), whose elements are one contiguous run in NCHW
// (up to 4 * 65536 = 262,144 of them at the decoder). Pass 1 sums x and
// x^2 in fp32 (group_stats.cuh); pass 2 reads the run again (from L2 where
// it fits), applies x * a_c + b_c with a_c = rstd * w_c and
// b_c = bias_c - mean * a_c, the SiLU, and stores. When H*W % 4 == 0 both
// passes move 4-element vectors, which never straddle a channel. C/G may
// be anything (6 at the UNet's 192-channel sites). One launch per call.
// Only N*G blocks are in flight (128 at batch 4), which is the first thing
// to change when it is made faster.
//
// Each C entry point returns cudaGetLastError() (or the configuration
// error) as an int; the Python wrapper raises on anything but 0.

#include "group_stats.cuh"

namespace {

constexpr int THREADS = 512;

template <typename T, bool SILU, bool VEC>
__global__ void __launch_bounds__(THREADS)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y, int c,
                  int groups, int hw, float eps) {
  __shared__ float red[64];
  const int ng = blockIdx.x;  // n * groups + g
  const int cg = c / groups;
  const int c0 = (ng % groups) * cg;
  const int count = cg * hw;
  const size_t base = (size_t)ng * count;
  const float2 st =
      frido::group_mean_rstd<T, THREADS, VEC>(x + base, count, eps, red);
  const T* xg = x + base;
  T* yg = y + base;
  if (VEC) {
    for (int i = threadIdx.x; i < (count >> 2); i += THREADS) {
      const int ch = c0 + (4 * i) / hw;
      const float a = st.y * w[ch];
      const float sh = b[ch] - st.x * a;
      float4 v = frido::load4(xg + 4 * (size_t)i);
      v.x = fmaf(v.x, a, sh);
      v.y = fmaf(v.y, a, sh);
      v.z = fmaf(v.z, a, sh);
      v.w = fmaf(v.w, a, sh);
      if (SILU) {
        v.x = frido::silu(v.x);
        v.y = frido::silu(v.y);
        v.z = frido::silu(v.z);
        v.w = frido::silu(v.w);
      }
      frido::store4(yg + 4 * (size_t)i, v);
    }
  } else {
    for (int i = threadIdx.x; i < count; i += THREADS) {
      const int ch = c0 + i / hw;
      const float a = st.y * w[ch];
      float v = fmaf(frido::to_f32(xg[i]), a, b[ch] - st.x * a);
      if (SILU) v = frido::silu(v);
      yg[i] = frido::from_f32<T>(v);
    }
  }
}

template <typename T, bool SILU>
int launch_silu(const void* x, const float* w, const float* b, void* y, int n,
                int c, int groups, int hw, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const dim3 grid(n * groups);
  if (hw % 4 == 0)
    group_norm_kernel<T, SILU, true>
        <<<grid, THREADS, 0, stream>>>(xt, w, b, yt, c, groups, hw, eps);
  else
    group_norm_kernel<T, SILU, false>
        <<<grid, THREADS, 0, stream>>>(xt, w, b, yt, c, groups, hw, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int n, int c,
           int groups, int hw, float eps, int silu, void* stream) {
  if (n <= 0 || c <= 0 || groups <= 0 || c % groups != 0 || hw <= 0 ||
      (long long)n * groups > 2147483647LL ||
      (long long)(c / groups) * hw > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = (cudaStream_t)stream;
  return silu ? launch_silu<T, true>(x, wf, bf, y, n, c, groups, hw, eps, s)
              : launch_silu<T, false>(x, wf, bf, y, n, c, groups, hw, eps, s);
}

}  // namespace

extern "C" int frido_group_norm_f32(const void* x, const void* w,
                                    const void* b, void* y, int n, int c,
                                    int groups, int hw, float eps, int silu,
                                    void* stream) {
  return launch<float>(x, w, b, y, n, c, groups, hw, eps, silu, stream);
}

extern "C" int frido_group_norm_bf16(const void* x, const void* w,
                                     const void* b, void* y, int n, int c,
                                     int groups, int hw, float eps, int silu,
                                     void* stream) {
  return launch<__nv_bfloat16>(x, w, b, y, n, c, groups, hw, eps, silu,
                               stream);
}

extern "C" const char* frido_group_norm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
