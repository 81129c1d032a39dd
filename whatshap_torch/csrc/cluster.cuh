// Thread-block clusters on Hopper, shared by the kernels that split one
// instance's state over a cluster of CTAs (geno_cluster.cuh for the
// genotyping kernels, wmec_forward_t.cu): the split cluster barriers, the
// number of CTAs a cluster takes for 2^K states, and the cluster launch,
// which asks the card whether it can schedule such a cluster at all.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace clusters {

constexpr int kThreadBits = 9;  // at most 512 threads a CTA
constexpr int kMaxCtaBits = 4;  // at most 16 CTAs a cluster (non-portable above 8)

// Split cluster barrier (release on arrive, acquire on wait); every thread of
// every CTA of the cluster takes part, and waits before it arrives again.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Launch `kernel` as B clusters of 2^cbits CTAs of max(32, 2^(K - cbits -
// LR)) threads with `smem` bytes of dynamic shared memory.  Returns a CUDA
// error code; cudaErrorInvalidClusterSize where the card cannot schedule one
// such cluster.
template <typename Kernel, typename Args>
int launch_clusters(Kernel kernel, const Args& a, int B, int K, int cbits, int LR, size_t smem,
                    cudaStream_t stream) {
  const int n = 1 << cbits;
  const int threads = K - cbits - LR < 5 ? 32 : 1 << (K - cbits - LR);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (n > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * n);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return (int)cudaErrorInvalidClusterSize;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The CTA bits of an instance's cluster: as many CTAs as leave each 2^9
// states or more, at most 2^kMaxCtaBits.
inline int cluster_bits(int K) {
  const int cbits = K - kThreadBits;
  return cbits < 0 ? 0 : cbits > kMaxCtaBits ? kMaxCtaBits : cbits;
}

}  // namespace clusters
