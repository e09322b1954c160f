// Thread block cluster and bulk-copy helpers shared by group_norm.cu and
// vq_argmin.cu (sm_90).
//
// - A cluster is the CTAs of one launch that the hardware schedules
//   together on one GPC; each can read the others' shared memory
//   (distributed shared memory, DSMEM). The kernels here are launched as
//   1-D clusters of S CTAs with `launch_cluster`, so blockIdx.x / S names
//   the cluster and blockIdx.x % S is the CTA's rank in it.
// - `cluster_arrive` / `cluster_wait` are the two halves of barrier.cluster
//   (every thread of every CTA of the cluster executes both, in order):
//   arrive releases this thread's shared-memory writes, wait acquires the
//   others'. A CTA whose shared memory another CTA reads must not exit
//   before that read: the kernels end with a wait whose matching arrive
//   follows their last remote read.
// - A bulk copy (cp.async.bulk) moves a contiguous run of global memory
//   into this CTA's shared memory without threads: one thread issues it,
//   and its bytes complete the transaction count of an mbarrier, on which
//   every thread then waits. Source, destination and size are multiples of
//   16 bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace frido {
namespace cluster {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The same shared-memory variable in the CTA of rank r of this cluster.
template <typename T>
__device__ __forceinline__ T load_remote(const T* local, unsigned r) {
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(remote)
      : "r"(smem_addr(local)), "r"(r));
  static_assert(sizeof(T) == 4, "32-bit values only");
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(remote)
               : "memory");
  return *reinterpret_cast<T*>(&v);
}

// mbarrier of one arrival (the issuing thread's expect_tx); call from one
// thread, then fence_init() and __syncthreads() before any use.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Global -> this CTA's shared memory, `bytes` counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the phase of `bar` of this parity to complete (0 for its first
// completion, 1 for its second, and so on alternately).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// Order this thread's earlier generic-proxy accesses of shared memory
// before its later bulk copies into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory and, for more
// than 8 CTAs a cluster, to a non-portable cluster size; once per device
// and kernel (`configured` is the kernel's own bit mask of devices).
template <typename K>
cudaError_t configure(K kernel, unsigned& configured, int max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (configured & (1u << dev)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  configured |= 1u << dev;
  return cudaSuccess;
}

// Launch `kernel` as 1-D clusters of `cluster` CTAs (1: a plain launch,
// without the cluster attribute); returns the launch's error, or the first
// error found after it.
template <typename K, typename... Args>
cudaError_t launch_cluster(K kernel, unsigned grid, unsigned threads,
                           unsigned smem, unsigned cluster,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `cluster` CTAs of `kernel` the device holds at once
// (at least 1), asked once per device, kernel and launch shape and kept
// in `cache` (16 shapes a kernel).
struct Occupancy {
  int n = 0;
  unsigned dev[16], cluster[16], threads[16], smem[16];
  int value[16];
};

template <typename K>
cudaError_t max_clusters(K kernel, unsigned threads, unsigned smem,
                         unsigned cluster, Occupancy& cache, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < cache.n; ++i) {
    if (cache.dev[i] == (unsigned)dev && cache.cluster[i] == cluster &&
        cache.threads[i] == threads && cache.smem[i] == smem) {
      *out = cache.value[i];
      return cudaSuccess;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  if (cache.n < 16) {
    const int i = cache.n++;
    cache.dev[i] = (unsigned)dev;
    cache.cluster[i] = cluster;
    cache.threads[i] = threads;
    cache.smem[i] = smem;
    cache.value[i] = n;
  }
  *out = n;
  return cudaSuccess;
}

}  // namespace cluster
}  // namespace frido
