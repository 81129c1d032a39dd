// Shared pieces of the wide genotyping forward-backward kernels
// (geno_backward_wide.cu, geno_forward_wide.cu): the pedigree and coverage
// shapes past the cluster kernels' envelope (geno_cluster.cuh), whose state
// (T planes of 2^K floats an instance) does not fit on the chip.
//
// The state lives in device memory.  One cooperative launch holds as many
// CTAs as the card keeps resident, and a grid-wide barrier ends each pass
// over the state.  The unit of work is a tile: the coset of lb "tile bits"
// of the state index (2^lb = min(2^K, 4096 / T) states) in all T planes, at
// most 4096 entries, staged in shared memory.  The tile bits are the bits a
// pass folds (a group of the column's fold slots, at most lb of them) and
// the lowest other bits, so that the emission, the T x T transmission
// product, the sum-fold and the partial sums of a column share one trip of
// the state.  A column where more than lb slots fold takes further passes
// that fold the next groups, lb at a time, in ascending slot order, as the
// reference folds them one slot after another (_sum_fold).
//
// A reduction over the grid (the backward's scaling sum, the forward's red)
// is taken in a fixed order: each CTA sums its tiles of an instance in tile
// order into its own row of partials, and after the grid barrier every sum
// runs over the rows of the CTAs that cover the instance, in rank order.  No
// float atomics: two runs on one card give the same bits.  The row of (CTA
// x, instance b) is x + b: a CTA's tiles are one contiguous range, so the
// rows of all pairs that exist are distinct and fewer than G + B.
//
// Every index into the state and the tables is 64-bit (T * 2^K reaches 2^31
// at T = 256, K = 23).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace geno_wide {

namespace cg = cooperative_groups;

constexpr int kMaxK = 23;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;             // entries (plane, state) of a tile
constexpr int kPer = kTile / kThreads;  // entries a thread owns
constexpr int kChunk = 16;              // allele assignments a forward thread sums at once
constexpr int kMeta = 40;               // words: tile bits [0, 32), their mask [32], local fold bits [33]

// The per-column inputs in device memory (instance-major), as the cluster
// kernels take them.
struct In {
  const float* diff;     // (B, C, K, T*P*2)
  const float* base;     // (B, C, T*P*2)
  const float* passign;  // (B, C, T*2^P)
  const float* trans;    // (B, C, T*T), index tj*T + ti
  const uint8_t* flags;  // (B, C, K): birth (backward) or die_next (forward)
  const float* scal;     // (B, C): dup (backward) or scaling (forward)
};

// A tile's geometry, the same on the host and the device.  In shared memory
// plane t of a tile starts at t * ps.  The forward's sums over a plane's
// states run in an owner mapping: thread (t, r), t = tid / tp, owns the E
// states r + tp * k (k < E) of plane t; ps = ns + tp below 32 threads a
// plane keeps the lanes of a warp on distinct banks there.
struct Geo {
  int ns, lb;        // states of a tile, and their bits
  int E, tp, ps, n;  // owned states a thread, threads a plane, plane stride, entries (T * ns)
  size_t S, per;     // states of an instance (2^K), tiles of an instance
};

__host__ __device__ inline Geo geometry(int K, int T) {
  Geo g;
  const int cap = kTile / T;
  g.ns = (1 << K) < cap ? 1 << K : cap;
  g.lb = 0;
  while ((1 << g.lb) < g.ns) ++g.lb;
  g.E = g.ns < kPer ? g.ns : kPer;
  g.tp = g.ns / g.E;
  g.ps = g.ns + (g.tp < 32 ? g.tp : 0);
  g.n = T * g.ns;
  g.S = (size_t)1 << K;
  g.per = g.S / g.ns;
  return g;
}

// Passes a column takes where nf slots fold: one, and one more for each
// further group of lb.
__host__ __device__ inline int passes(int nf, int lb) { return nf > lb ? (nf + lb - 1) / lb : 1; }

// The fold slots of `mask` whose rank among them (ascending) is in [lo, hi).
__device__ __forceinline__ uint32_t slot_range(uint32_t mask, int lo, int hi) {
  uint32_t out = 0;
  int i = 0;
  for (uint32_t m = mask; m != 0 && i < hi; m &= m - 1, ++i) {
    if (i >= lo) out |= m & (0u - m);
  }
  return out;
}

// Shared memory: `planes` arrays of T * ps floats, then the tile's state
// offsets (ns), its tables (kMeta), and the reduction scratch.
struct Smem {
  float* x[3];
  uint32_t* off;
  int* meta;
  float* red;  // [kWarps][kChunk]
  float* bc;   // [kWarps + 1]: block sums, and a broadcast word
};

__host__ __device__ inline size_t smem_words(const Geo& g, int T, int planes) {
  return (size_t)planes * T * g.ps + g.ns + kMeta + kWarps * kChunk + kWarps + 1;
}

__device__ __forceinline__ Smem carve(float* base, const Geo& g, int T, int planes) {
  Smem s;
  for (int p = 0; p < 3; ++p) s.x[p] = base + (size_t)(p < planes ? p : 0) * T * g.ps;
  s.off = reinterpret_cast<uint32_t*>(base + (size_t)planes * T * g.ps);
  s.meta = reinterpret_cast<int*>(s.off + g.ns);
  s.red = reinterpret_cast<float*>(s.meta + kMeta);
  s.bc = s.red + kWarps * kChunk;
  return s;
}

// The tile tables for the fold slots `fold` (at most lb of them): the tile
// bits (`fold`, then the lowest other slots, lb in all), which local bits
// fold, and the state bits of each local index.  Every thread of the CTA
// calls it.
__device__ void build_tile(const Smem& s, const Geo& g, int K, uint32_t fold) {
  __syncthreads();  // the previous tile's tables are no longer read
  if (threadIdx.x == 0) {
    uint32_t bits = fold;
    int need = g.lb - __popc(fold);
    for (int k = 0; need > 0 && k < K; ++k) {
      if (!((bits >> k) & 1)) {
        bits |= 1u << k;
        --need;
      }
    }
    uint32_t qf = 0;
    int q = 0;
    for (int k = 0; k < K; ++k) {
      if ((bits >> k) & 1) {
        s.meta[q] = k;
        if ((fold >> k) & 1) qf |= 1u << q;
        ++q;
      }
    }
    s.meta[32] = (int)bits;
    s.meta[33] = (int)qf;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < g.ns; l += kThreads) {
    uint32_t o = 0;
    for (int q = 0; q < g.lb; ++q)
      if ((l >> q) & 1) o |= 1u << s.meta[q];
    s.off[l] = o;
  }
  __syncthreads();
}

// The state bits of tile f of an instance: f's bits deposited in ascending
// order into the slots that are not tile bits.
__device__ __forceinline__ uint32_t coset_base(uint32_t bits, int K, size_t f) {
  uint32_t base = 0;
  int q = 0;
  for (int k = 0; k < K; ++k) {
    if (!((bits >> k) & 1)) {
      if ((f >> q) & 1) base |= 1u << k;
      ++q;
    }
  }
  return base;
}

// Sum-fold the tile x over its local fold bits qf, in ascending order: both
// partners of a pair take lo + hi, as _sum_fold writes the pair's sum to
// both halves.  Every thread of the CTA calls it; it ends behind a barrier.
__device__ void fold_tile(float* x, const Geo& g, uint32_t qf) {
  const int half = g.n >> 1, hb = g.lb - 1;
  for (int q = 0; q < g.lb; ++q) {
    if (!((qf >> q) & 1)) continue;
    __syncthreads();
    for (int p = threadIdx.x; p < half; p += kThreads) {
      const int t = p >> hb, pl = p & ((1 << hb) - 1);
      const int lo = ((pl >> q) << (q + 1)) | (pl & ((1 << q) - 1));
      float* row = x + (size_t)t * g.ps;
      const float v = row[lo] + row[lo | (1 << q)];
      row[lo] = v;
      row[lo | (1 << q)] = v;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sum of v in a fixed order (threads' own sums, warp shuffles,
// warps in order), in thread 0.  Every thread calls it.
__device__ __forceinline__ float block_sum(const Smem& s, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) s.bc[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += s.bc[w];
  __syncthreads();
  return total;
}

// emission sums of plane t at state i: ab[j] = acc_j + base_j with acc_j =
// sum over the slots k set in i, ascending, of diff[k, t*P2 + j] (the
// reference's bits @ diff), j < 2P.
template <int P>
__device__ __forceinline__ void emission_sums(const float* __restrict__ diff_c, const float* __restrict__ base_c,
                                              int K, int TP2, uint32_t i, int t, float (&ab)[2 * P]) {
  constexpr int P2 = 2 * P;
  float acc[P2];
#pragma unroll
  for (int j = 0; j < P2; ++j) acc[j] = 0.0f;
  const float* d = diff_c + t * P2;
  for (int k = 0; k < K; ++k) {
    if ((i >> k) & 1) {
#pragma unroll
      for (int j = 0; j < P2; ++j) acc[j] += __ldg(d + (size_t)k * TP2 + j);
    }
  }
#pragma unroll
  for (int j = 0; j < P2; ++j) ab[j] = acc[j] + __ldg(base_c + t * P2 + j);
}

// lem of allele assignment a: the sum over p of ab[2p + bit p of a], in
// ascending p, as the reference sums it.
template <int P>
__device__ __forceinline__ float lem_of(const float (&ab)[2 * P], int a) {
  float lem = ab[a & 1];
#pragma unroll
  for (int p = 1; p < P; ++p) lem += ab[2 * p + ((a >> p) & 1)];
  return lem;
}

// The CTA that holds tile t: f0(x) = tiles * x / G <= t < f0(x + 1).
__device__ __forceinline__ int cta_of(size_t t, size_t tiles, int G) {
  int x = (int)((t * (size_t)G) / tiles);
  while (x + 1 < G && tiles * (size_t)(x + 1) / G <= t) ++x;
  while (x > 0 && tiles * (size_t)x / G > t) --x;
  return x;
}

// Prologue of both kernels: a warp a column gathers every instance's fold
// slots there into masks (B, C) and the column's pass count into npass (C),
// the most any instance needs; with skip_first, column 0 folds nothing (the
// backward's state after it is not needed).  A grid barrier must follow.
__device__ void gather_masks(const uint8_t* flags, uint32_t* masks, int* npass, int B, int C, int K, int lb,
                             bool skip_first) {
  const int lane = threadIdx.x & 31;
  const size_t warps = (size_t)gridDim.x * kWarps;
  for (size_t w = ((size_t)blockIdx.x * kThreads + threadIdx.x) >> 5; w < (size_t)C; w += warps) {
    int np = 1;
    for (int b = lane; b < B; b += 32) {
      const size_t col = (size_t)b * C + w;
      uint32_t m = 0;
      if (!(skip_first && w == 0))
        for (int k = 0; k < K; ++k) m |= (flags[col * K + k] ? 1u : 0u) << k;
      masks[col] = m;
      np = max(np, passes(__popc(m), lb));
    }
    np = __reduce_max_sync(0xffffffffu, np);
    if (lane == 0) npass[w] = np;
  }
}

// One cooperative launch of `kernel` with as many CTAs as the card keeps
// resident, no more than the tiles and no more than max_ctas (the rows of
// partials the caller allocated beside B).
template <typename Kernel, typename Args>
int launch_grid(Kernel kernel, const Args& a, size_t tiles, int max_ctas, size_t smem, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1 || max_ctas < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  size_t grid = (size_t)sms * per_sm;
  if (tiles < grid) grid = tiles;
  if ((size_t)max_ctas < grid) grid = (size_t)max_ctas;
  Args args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)grid), dim3(kThreads), params, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The shape checks of both entry points: the wide envelope.
inline bool shape_ok(int B, int C, int K, int T, int P) {
  if (B < 1 || C < 1 || K < 1 || K > kMaxK) return false;
  if (T == 1) return P == 2;
  return (T == 4 || T == 16 || T == 64 || T == 256) && (P == 2 || P == 4 || P == 6 || P == 8);
}

}  // namespace geno_wide
