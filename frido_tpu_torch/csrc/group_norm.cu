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
// [4, 128, 256, 256] fp32 site that is 268 MB moved, 0.080 ms at 3.35 TB/s.
//
// Design: every element is read from device memory once. In NCHW a
// (sample, group) is one contiguous run of count = C/G * H*W elements.
// The host plan (ops/cuda/norm.py `group_norm_plan`) picks one of three
// launches:
//
// - Registers (vpt > 0): a run small enough for one CTA (up to 1024
//   threads x 8 vectors of 4) with H*W % 4 == 0. Each thread loads its
//   vectors with plain 16- or 8-byte loads, all in flight together, sums
//   them, and after the block's reduction normalises them in place and
//   stores them. One CTA per run: the UNet's runs and the decoder's
//   smaller ones.
// - Shared memory (vpt 0): the run is cut into `cluster` slices of
//   `slice` elements (a multiple of 8, at most 64 KB), one CTA per slice,
//   the run's CTAs one thread block cluster (up to 16: the decoder's 1 MB
//   runs). As many clusters as the card holds are launched, and each
//   loops over runs. A CTA copies its slice into shared memory with bulk
//   copies (cp.async.bulk, four pieces, one mbarrier each), summing each
//   piece as it lands; the CTAs add their partials through distributed
//   shared memory after a cluster barrier; each CTA normalises its slice
//   piece by piece from shared memory and, as soon as a piece is read,
//   issues the bulk copy of the same piece of its next run into it, so
//   the next run's loads overlap this run's stores. A run whose size is
//   not a multiple of 16 bytes is copied element by element instead.
// - Streaming (cluster 0): a run over 16 x 64 KB does not fit a cluster's
//   shared memory; one CTA of 512 threads per run reads it twice
//   (statistics, then normalise), as the first version did. No site of
//   the repo's models is that large.
//
// Sums: fp32 x and x^2, per thread in index order over its 4-element
// vectors ((v0 + v1) + (v2 + v3)), a butterfly over each warp and over
// the warps (group_stats.cuh `block_sum2`), then the cluster's CTAs in
// rank order; the variance E[x^2] - E[x]^2 is clamped at 0. Only the order
// differs from the plain version's. A slice may start or end inside a
// channel: the channel is taken per vector from its index in the run.
//
// Each C entry point returns cudaGetLastError() (or the configuration
// error) as an int; the Python wrapper raises on anything but 0.

#include "cluster.cuh"
#include "group_stats.cuh"

namespace {

namespace cl = frido::cluster;

constexpr int PIECES = 4;         // bulk copies (and mbarriers) per slice
constexpr int MAX_SLICE_BYTES = 65536;
constexpr int EXTRA_SMEM = 64;    // the mbarriers and two partials
constexpr int MAX_CLUSTER = 16;
constexpr int STREAM_THREADS = 512;

template <typename T, bool SILU>
__device__ __forceinline__ void norm4(T* dst, float4 v, float a, float sh) {
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
  frido::store4(dst, v);
}

__device__ __forceinline__ float2 mean_rstd(float s1, float s2, int count,
                                            float eps) {
  const float mean = s1 / count;
  const float var = fmaxf(s2 / count - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// (mean, rstd) of the run, in every thread, from the CTA's (sum, sum of
// squares) t. A CTA alone (cs == 1, launched without a cluster) has them
// already. Else t goes to part[0..1]; after a cluster barrier lane r of
// warp 0 reads rank r's (all in flight together), lane 0 adds them in
// rank order and shares the result through *stat.
__device__ __forceinline__ float2 cluster_stats(float2 t, float* part,
                                                int count, float eps,
                                                unsigned cs, float2* stat) {
  if (cs == 1) return mean_rstd(t.x, t.y, count, eps);
  if (threadIdx.x == 0) {
    part[0] = t.x;
    part[1] = t.y;
  }
  cl::arrive();
  cl::wait();
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    float p0 = 0.f, p1 = 0.f;
    if (lane < cs) {
      p0 = cl::load_remote(&part[0], lane);
      p1 = cl::load_remote(&part[1], lane);
    }
    float s1 = 0.f, s2 = 0.f;
    for (unsigned r = 0; r < cs; ++r) {
      s1 += __shfl_sync(0xffffffffu, p0, r);
      s2 += __shfl_sync(0xffffffffu, p1, r);
    }
    if (lane == 0) *stat = mean_rstd(s1, s2, count, eps);
  }
  __syncthreads();
  return *stat;
}

// One CTA per run, the run in registers: VPT 4-element vectors a thread,
// strided over the CTA (H*W % 4 == 0, count <= THREADS * 4 * VPT).
template <typename T, bool SILU, int THREADS, int VPT>
__global__ void __launch_bounds__(THREADS)
group_norm_regs_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ y, int c,
                       int groups, int hw, float eps) {
  __shared__ float red[64];
  const int ng = blockIdx.x;  // n * groups + g
  const int cg = c / groups;
  const int count = cg * hw;
  const int n4 = count >> 2;
  const size_t base = (size_t)ng * count;
  const int tid = threadIdx.x;

  float4 v[VPT];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tid + k * THREADS;
    if (i < n4) {
      v[k] = frido::load4(x + base + 4 * (size_t)i);
      s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
      ss += (v[k].x * v[k].x + v[k].y * v[k].y) +
            (v[k].z * v[k].z + v[k].w * v[k].w);
    }
  }
  const float2 t = frido::block_sum2<THREADS>(s, ss, red);
  const float2 st = mean_rstd(t.x, t.y, count, eps);
  const int c0 = (ng % groups) * cg;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tid + k * THREADS;
    if (i < n4) {
      const int ch = c0 + (4 * i) / hw;
      const float a = st.y * w[ch];
      norm4<T, SILU>(y + base + 4 * (size_t)i, v[k], a, b[ch] - st.x * a);
    }
  }
}

// One CTA per slice of a run, the run's CTAs one cluster; each cluster
// takes runs blockIdx.x / cs, + clusters, ... (as many clusters as the
// card holds at once). VEC: H*W % 4 == 0 (normalise and store 4-element
// vectors).
template <typename T, bool SILU, bool VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
group_norm_cluster_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, T* __restrict__ y,
                          int c, int groups, int hw, int slice, int runs,
                          float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[64];
  __shared__ float2 stat;
  T* xs = reinterpret_cast<T*>(smem);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem + (size_t)slice * sizeof(T));
  float* part = reinterpret_cast<float*>(bar + PIECES);  // [2][2]

  const unsigned cs = cl::size();
  const unsigned rank = cl::rank();
  const int clusters = gridDim.x / cs;
  const int cg = c / groups;
  const int count = cg * hw;
  const int start = (int)rank * slice;
  const int len = max(0, min(slice, count - start));
  const int tid = threadIdx.x;
  // pieces of the slice, whole 16-byte vectors; one piece when the run is
  // copied element by element
  const bool bulk = ((size_t)count * sizeof(T)) % 16 == 0;
  const int pieces = bulk ? PIECES : 1;
  constexpr int VE = 16 / sizeof(T);
  const int piece = bulk ? (len / PIECES + VE - 1) / VE * VE : len;

  if (bulk && tid == 0) {
    for (int p = 0; p < PIECES; ++p) cl::mbar_init(&bar[p]);
    cl::fence_init();
  }
  __syncthreads();
  // thread 0: piece p of run ng's slice -> shared memory
  auto issue = [&](int ng, int p) {
    const int off = p * piece;
    const int ne = min(piece, len - off);
    if (ne > 0)
      cl::bulk_load(xs + off, x + (size_t)ng * count + start + off,
                    ne * (int)sizeof(T), &bar[p]);
  };
  int ng = blockIdx.x / cs;  // n * groups + g
  if (bulk && tid == 0 && ng < runs)
    for (int p = 0; p < PIECES; ++p) issue(ng, p);

  for (int it = 0; ng < runs; ng += clusters, ++it) {
    const size_t base = (size_t)ng * count + start;
    // 1. slice -> shared memory, summed as it lands
    float s = 0.f, ss = 0.f;
    if (bulk) {
      for (int p = 0; p < PIECES; ++p) {
        const int off = p * piece;
        const int ne = min(piece, len - off);
        if (ne <= 0) break;
        cl::mbar_wait(&bar[p], it & 1);
        for (int i = tid; i < (ne >> 2); i += THREADS) {
          const float4 v = frido::load4(xs + off + 4 * i);
          s += (v.x + v.y) + (v.z + v.w);
          ss += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
        }
      }
    } else {
      for (int i = tid; i < len; i += THREADS) {
        const T v = x[base + i];
        xs[i] = v;
        const float f = frido::to_f32(v);
        s += f;
        ss += f * f;
      }
    }

    // 2. CTA partial -> cluster sum in rank order; the partials alternate
    // between two slots, so a slot is written again only after the next
    // cluster barrier, which every CTA passes after its reads of this one
    const float2 st = cluster_stats(frido::block_sum2<THREADS>(s, ss, red),
                                    part + 2 * (it & 1), count, eps, cs,
                                    &stat);
    const int c0 = (ng % groups) * cg;

    // 3. normalise from shared memory piece by piece, store; a piece read
    // takes the same piece of the next run
    const bool next = bulk && ng + clusters < runs;
    for (int p = 0; p < pieces; ++p) {
      const int off = p * piece;
      const int ne = min(piece, len - off);
      if (ne <= 0) break;
      if (VEC) {
        for (int i = tid; i < (ne >> 2); i += THREADS) {
          const int e = off + 4 * i;
          const int ch = c0 + (start + e) / hw;
          const float a = st.y * w[ch];
          norm4<T, SILU>(y + base + e, frido::load4(xs + e), a,
                         b[ch] - st.x * a);
        }
      } else {
        for (int i = tid; i < ne; i += THREADS) {
          const int e = off + i;
          const int ch = c0 + (start + e) / hw;
          const float a = st.y * w[ch];
          float v = fmaf(frido::to_f32(xs[e]), a, b[ch] - st.x * a);
          if (SILU) v = frido::silu(v);
          y[base + e] = frido::from_f32<T>(v);
        }
      }
      __syncthreads();  // piece p is read
      if (next && tid == 0) {
        cl::fence_proxy_async();
        issue(ng + clusters, p);
      }
    }
  }
  if (cs > 1) {  // no CTA exits while another may still read its partial
    cl::arrive();
    cl::wait();
  }
}

// A run too large for a cluster's shared memory: one block of 512 threads
// per run reads it twice, for the statistics (group_stats.cuh) and to
// normalise (from L2 where it fits).
template <typename T, bool SILU, bool VEC>
__global__ void __launch_bounds__(STREAM_THREADS)
group_norm_stream_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, T* __restrict__ y,
                         int c, int groups, int hw, float eps) {
  __shared__ float red[64];
  const int ng = blockIdx.x;  // n * groups + g
  const int cg = c / groups;
  const int c0 = (ng % groups) * cg;
  const int count = cg * hw;
  const size_t base = (size_t)ng * count;
  const float2 st = frido::group_mean_rstd<T, STREAM_THREADS, VEC>(
      x + base, count, eps, red);
  const T* xg = x + base;
  T* yg = y + base;
  if (VEC) {
    for (int i = threadIdx.x; i < (count >> 2); i += STREAM_THREADS) {
      const int ch = c0 + (4 * i) / hw;
      const float a = st.y * w[ch];
      norm4<T, SILU>(yg + 4 * (size_t)i, frido::load4(xg + 4 * (size_t)i), a,
                     b[ch] - st.x * a);
    }
  } else {
    for (int i = threadIdx.x; i < count; i += STREAM_THREADS) {
      const int ch = c0 + i / hw;
      const float a = st.y * w[ch];
      float v = fmaf(frido::to_f32(xg[i]), a, b[ch] - st.x * a);
      if (SILU) v = frido::silu(v);
      yg[i] = frido::from_f32<T>(v);
    }
  }
}

struct Args {
  const void* x;
  const float* w;
  const float* b;
  void* y;
  int n, c, groups, hw;
  float eps;
};

// group_norm_plan's launch: cluster 0 streams; vpt > 0 keeps the run in
// one CTA's registers (vpt vectors a thread); else slices in shared memory
struct Plan {
  int cluster, slice, threads, vpt, smem;
};

template <typename T, bool SILU, bool VEC, int THREADS>
int launch_smem(const Args& a, const Plan& p, cudaStream_t s) {
  static unsigned configured = 0;
  static cl::Occupancy occupancy;
  auto kernel = group_norm_cluster_kernel<T, SILU, VEC, THREADS>;
  cudaError_t err =
      cl::configure(kernel, configured, MAX_SLICE_BYTES + EXTRA_SMEM);
  if (err != cudaSuccess) return (int)err;
  int fit = 0;
  err = cl::max_clusters(kernel, THREADS, p.smem, p.cluster, occupancy, &fit);
  if (err != cudaSuccess) return (int)err;
  const int runs = a.n * a.groups;
  const int clusters = runs < fit ? runs : fit;
  return (int)cl::launch_cluster(
      kernel, (unsigned)(clusters * p.cluster), THREADS, (unsigned)p.smem,
      (unsigned)p.cluster, s, static_cast<const T*>(a.x), a.w, a.b,
      static_cast<T*>(a.y), a.c, a.groups, a.hw, p.slice, runs, a.eps);
}

template <typename T, bool SILU, int THREADS, int VPT>
int launch_regs(const Args& a, cudaStream_t s) {
  group_norm_regs_kernel<T, SILU, THREADS, VPT>
      <<<a.n * a.groups, THREADS, 0, s>>>(
          static_cast<const T*>(a.x), a.w, a.b, static_cast<T*>(a.y), a.c,
          a.groups, a.hw, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, bool SILU, bool VEC>
int launch_plan(const Args& a, const Plan& p, cudaStream_t s) {
  if (p.cluster == 0) {
    group_norm_stream_kernel<T, SILU, VEC>
        <<<a.n * a.groups, STREAM_THREADS, 0, s>>>(
            static_cast<const T*>(a.x), a.w, a.b, static_cast<T*>(a.y), a.c,
            a.groups, a.hw, a.eps);
    return (int)cudaGetLastError();
  }
  if (p.vpt == 0)
    return p.threads == 512 ? launch_smem<T, SILU, VEC, 512>(a, p, s)
                            : launch_smem<T, SILU, VEC, 256>(a, p, s);
  switch (p.threads * 16 + p.vpt) {
    case 256 * 16 + 1: return launch_regs<T, SILU, 256, 1>(a, s);
    case 512 * 16 + 1: return launch_regs<T, SILU, 512, 1>(a, s);
    case 512 * 16 + 4: return launch_regs<T, SILU, 512, 4>(a, s);
    case 512 * 16 + 8: return launch_regs<T, SILU, 512, 8>(a, s);
    case 1024 * 16 + 8: return launch_regs<T, SILU, 1024, 8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The plan must be one group_norm_plan gives for these sizes: slices that
// cover the run and fit the kernel (its shared memory or its registers).
template <typename T>
bool plan_ok(const Args& a, const Plan& p) {
  const long long count = (long long)(a.c / a.groups) * a.hw;
  if (p.cluster == 0)
    return p.slice == 0 && p.threads == STREAM_THREADS && p.vpt == 0 &&
           p.smem == 0;
  if (p.vpt > 0)
    return p.cluster == 1 && p.slice == count && p.smem == 0 &&
           a.hw % 4 == 0 && count <= (long long)p.threads * 4 * p.vpt;
  return p.cluster <= MAX_CLUSTER && p.slice > 0 && p.slice % 8 == 0 &&
         (long long)p.slice * p.cluster >= count &&
         (long long)p.slice * (p.cluster - 1) < count &&
         p.slice * (int)sizeof(T) <= MAX_SLICE_BYTES &&
         p.smem == p.slice * (int)sizeof(T) + EXTRA_SMEM &&
         (p.threads == 256 || p.threads == 512);
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int n, int c,
           int groups, int hw, float eps, int silu, const Plan& p,
           void* stream) {
  if (n <= 0 || c <= 0 || groups <= 0 || c % groups != 0 || hw <= 0 ||
      p.cluster < 0 || (long long)n * groups > 2147483647LL ||
      (long long)(c / groups) * hw > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(w), static_cast<const float*>(b),
               y, n, c, groups, hw, eps};
  if (!plan_ok<T>(a, p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = hw % 4 == 0;
  if (silu)
    return vec ? launch_plan<T, true, true>(a, p, s)
               : launch_plan<T, true, false>(a, p, s);
  return vec ? launch_plan<T, false, true>(a, p, s)
             : launch_plan<T, false, false>(a, p, s);
}

}  // namespace

extern "C" int frido_group_norm_f32(const void* x, const void* w,
                                    const void* b, void* y, int n, int c,
                                    int groups, int hw, float eps, int silu,
                                    int cluster, int slice, int threads,
                                    int vpt, int smem, void* stream) {
  return launch<float>(x, w, b, y, n, c, groups, hw, eps, silu,
                       Plan{cluster, slice, threads, vpt, smem}, stream);
}

extern "C" int frido_group_norm_bf16(const void* x, const void* w,
                                     const void* b, void* y, int n, int c,
                                     int groups, int hw, float eps, int silu,
                                     int cluster, int slice, int threads,
                                     int vpt, int smem, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, y, n, c, groups, hw, eps, silu,
                               Plan{cluster, slice, threads, vpt, smem},
                               stream);
}

extern "C" const char* frido_group_norm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
