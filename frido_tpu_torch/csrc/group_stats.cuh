// GroupNorm statistics of an NCHW tensor, shared by group_norm.cu and
// conv3x3.cu (the fused prologue's statistics launch).
//
// In NCHW the (sample, group) slice x[n, g*cg:(g+1)*cg, :, :] is one
// contiguous run of cg*H*W elements, so one block reads it front to back.
// Statistics are one-pass, fp32: E[x] and E[x^2] from per-thread fp32
// partial sums reduced by warp shuffles and one shared-memory step; the
// variance E[x^2] - E[x]^2 is clamped at 0 before rsqrt, as the port's
// plain version and the JAX package's group_norm_jnp (ops/norm.py:124) do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace frido {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive elements as fp32; p is 4-element aligned
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// Sum of a and of b over the block; every thread gets both. red holds 64
// floats of shared memory; THREADS is a multiple of 32, at most 1024.
template <int THREADS>
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  a = lane < THREADS / 32 ? red[lane] : 0.f;
  b = lane < THREADS / 32 ? red[32 + lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  return make_float2(a, b);
}

// (mean, rstd) of the count elements at p. VEC: count % 4 == 0 and p is
// 4-element aligned, so the run is read as 4-element vectors.
template <typename T, int THREADS, bool VEC>
__device__ __forceinline__ float2 group_mean_rstd(const T* __restrict__ p,
                                                  int count, float eps,
                                                  float* red) {
  float s = 0.f, ss = 0.f;
  if (VEC) {
    const int n4 = count >> 2;
    for (int i = threadIdx.x; i < n4; i += THREADS) {
      const float4 v = load4(p + 4 * (size_t)i);
      s += (v.x + v.y) + (v.z + v.w);
      ss += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
  } else {
    for (int i = threadIdx.x; i < count; i += THREADS) {
      const float v = to_f32(p[i]);
      s += v;
      ss += v * v;
    }
  }
  const float2 t = block_sum2<THREADS>(s, ss, red);
  const float mean = t.x / count;
  const float var = fmaxf(t.y / count - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

}  // namespace frido
