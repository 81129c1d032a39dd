// Shared pieces of the genotyping forward-backward kernels (geno_backward.cu,
// geno_forward.cu): the layout of an instance's state over a thread-block
// cluster, the staged per-column inputs, the emission sums and the sum-folds
// by level of the state index (the cluster barriers and launch are in
// cluster.cuh).
//
// Layout.  An instance's state is T planes of S = 2^K floats, split over a
// cluster of N = 2^cbits CTAs.  A state index i has, from its low bits up:
//
//   lb lane bits       the thread's lane (lb = min(5, Kc));
//   wb warp bits       the thread's warp (Kc = lb + wb bits index a CTA's
//                      threads);
//   cbits CTA bits     the CTA's rank in the cluster (Ku = Kc + cbits);
//   LR register bits   a thread holds the 2^LR states m << Ku | (its index)
//                      of every plane in registers (x[t][m]).
//
// LR is a template parameter, LR = max(0, K - cbits - 9), so a CTA runs at
// most 512 threads; T * 2^LR <= 32 floats keep the state in registers.
// Below 32 states per CTA the idle lanes of the one warp hold no states.
// The register bits are the top bits so that a state's emission sums keep
// the reference's order (ascending slot k) at O(LR) adds: the part of the
// lane, warp and CTA bits is summed once per thread and column, and the
// register bits, the last in that order, are added per state.  A warp's
// threads hold neighbouring states, so every beta_store row a warp reads or
// writes is 128 contiguous bytes.
//
// The state never leaves the chip: a fold over a warp bit goes through an
// exchange buffer in shared memory, a fold over a CTA bit through the
// partner CTA's exchange buffer (distributed shared memory), one bit at a
// time in ascending order, as the reference folds.  A fold writes a + b to
// both partners, and a + b == b + a in IEEE arithmetic, so both hold the
// same value at every level.

#pragma once

#include "cluster.cuh"

namespace geno {

namespace cg = cooperative_groups;
using clusters::cluster_arrive;
using clusters::cluster_bits;
using clusters::cluster_sync;
using clusters::cluster_wait;
using clusters::kMaxCtaBits;
using clusters::kThreadBits;
using clusters::launch_clusters;

constexpr int kMaxK = 17;
constexpr int kWarps = (1 << kThreadBits) / 32;
constexpr int kPre = 4;  // staged input words a thread prefetches per column

// Largest LR per transmission count, K - kMaxCtaBits - kThreadBits at the
// top K of the envelope (17, 16, 13): T * 2^LR <= 32 registers of state.
__host__ __device__ constexpr int max_lr(int T) { return T == 1 ? 4 : T == 4 ? 3 : 0; }

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// One column's inputs as one float record in shared memory:
//   diff (K*TP2) | base (TP2) | passign (T*NA) | trans (T*T) | flags (K, 0/1) | scalar
// where the scalar is dup (backward) or scaling (forward).
template <int T, int P>
struct Rec {
  static constexpr int P2 = 2 * P, TP2 = T * P2, NA = 1 << P;
  __host__ __device__ static int words(int K) { return K * TP2 + TP2 + T * NA + T * T + K + 1; }
  __device__ static int base(int K) { return K * TP2; }
  __device__ static int pa(int K) { return K * TP2 + TP2; }
  __device__ static int tr(int K) { return pa(K) + T * NA; }
  __device__ static int flag(int K) { return tr(K) + T * T; }
  __device__ static int scal(int K) { return flag(K) + K; }
};

// The per-column input arrays in device memory (instance-major).
struct In {
  const float* diff;     // (B, C, K, T*P*2)
  const float* base;     // (B, C, T*P*2)
  const float* passign;  // (B, C, T*2^P)
  const float* trans;    // (B, C, T*T), index tj*T + ti
  const uint8_t* flags;  // (B, C, K): birth (backward) or die_next (forward)
  const float* scal;     // (B, C): dup (backward) or scaling (forward)
};

template <int T, int P>
__device__ __forceinline__ float load_word(const In& in, size_t col, int K, int j) {
  using R = Rec<T, P>;
  const int nd = K * R::TP2;
  if (j < nd) return __ldg(in.diff + col * nd + j);
  j -= nd;
  if (j < R::TP2) return __ldg(in.base + col * R::TP2 + j);
  j -= R::TP2;
  if (j < T * R::NA) return __ldg(in.passign + col * (T * R::NA) + j);
  j -= T * R::NA;
  if (j < T * T) return __ldg(in.trans + col * (T * T) + j);
  j -= T * T;
  if (j < K) return in.flags[col * K + j] ? 1.0f : 0.0f;
  return __ldg(in.scal + col);
}

// Double-buffered staging of the column records: issue() loads the next
// column's words into registers while the current column computes, commit()
// writes them into the other buffer (words beyond kPre per thread, only at
// small K, are loaded there directly).
template <int T, int P>
struct Stage {
  float pre[kPre];
  __device__ __forceinline__ void issue(const In& in, size_t col, int K, int W, int tid, int nthr) {
#pragma unroll
    for (int s = 0; s < kPre; ++s) {
      const int j = tid + s * nthr;
      if (j < W) pre[s] = load_word<T, P>(in, col, K, j);
    }
  }
  __device__ __forceinline__ void commit(float* dst, const In& in, size_t col, int K, int W, int tid,
                                         int nthr) {
#pragma unroll
    for (int s = 0; s < kPre; ++s) {
      const int j = tid + s * nthr;
      if (j < W) dst[j] = pre[s];
    }
    for (int j = tid + kPre * nthr; j < W; j += nthr) dst[j] = load_word<T, P>(in, col, K, j);
  }
};

// The fold flags of a column record as a bit mask.
__device__ __forceinline__ uint32_t flag_mask(const float* flags, int K) {
  uint32_t m = 0;
  for (int k = 0; k < K; ++k) m |= (flags[k] != 0.0f ? 1u : 0u) << k;
  return m;
}

// u[j] = sum over the bits k < Ku set in the thread's index of diff[k,
// t*P2 + j], ascending k: the part of plane t's emission sums that is
// uniform over the thread's states (lane, warp and CTA bits).
template <int T, int P>
__device__ __forceinline__ void uniform_sums(const float* diff, int Ku, uint32_t gbase, int t,
                                             float (&u)[2 * P]) {
  constexpr int P2 = 2 * P, TP2 = Rec<T, P>::TP2;
#pragma unroll
  for (int j = 0; j < P2; ++j) u[j] = 0.0f;
  for (int k = 0; k < Ku; ++k) {
    if ((gbase >> k) & 1) {
#pragma unroll
      for (int j = 0; j < P2; ++j) u[j] += diff[k * TP2 + t * P2 + j];
    }
  }
}

// ab[j] = acc_j + base_j of plane t at the thread's state m: acc_j is the
// uniform part followed by the register bits set in m, ascending, so the
// sum runs over the state's bits in the reference's order.  lem of allele
// assignment a is then the sum over p of ab[2p + bit p of a], in ascending
// p, as the reference sums it.
template <int T, int P, int LR>
__device__ __forceinline__ void log_sums(const float* diff, const float* base, const float (&u)[2 * P],
                                         int Ku, int m, int t, float (&ab)[2 * P]) {
  constexpr int P2 = 2 * P, TP2 = Rec<T, P>::TP2;
#pragma unroll
  for (int j = 0; j < P2; ++j) {
    float acc = u[j];
#pragma unroll
    for (int r = 0; r < LR; ++r)
      if ((m >> r) & 1) acc += diff[(Ku + r) * TP2 + t * P2 + j];
    ab[j] = acc + base[t * P2 + j];
  }
}

template <int P>
__device__ __forceinline__ float lem_of(const float (&ab)[2 * P], int a) {
  float lem = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) lem += ab[2 * p + ((a >> p) & 1)];
  return lem;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Where the thread sits in the instance's state.
struct Place {
  int K, Ku, Kc, lb;  // state bits, bits below the register bits, thread bits, lane bits
  unsigned rank;      // CTA rank in the cluster
  int tid, nthr;      // thread, threads of the CTA
  bool active;        // the thread holds states
  uint32_t gbase;     // its index below the register bits: rank << Kc | tid
};

template <int LR>
__device__ __forceinline__ Place place(int K, int cbits) {
  Place q;
  q.K = K;
  q.Ku = K - LR;
  q.Kc = q.Ku - cbits;
  q.lb = min(5, q.Kc);
  q.rank = cg::this_cluster().block_rank();
  q.tid = threadIdx.x;
  q.nthr = blockDim.x;
  q.active = q.tid < (1 << q.Kc);
  q.gbase = ((uint32_t)q.rank << q.Kc) | (uint32_t)q.tid;
  return q;
}

// The offset of the thread's state m in a plane of 2^K floats.
__device__ __forceinline__ size_t state_at(const Place& q, int m) {
  return ((size_t)m << q.Ku) | q.gbase;
}

// A CTA's exchange buffer holds x[t][m] of thread tid at (t*R + m)*nthr + tid.
template <int T, int R>
__device__ __forceinline__ void put_state(float* xbuf, float (&x)[T][R], const Place& q) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int m = 0; m < R; ++m) xbuf[(t * R + m) * q.nthr + q.tid] = x[t][m];
}

template <int T, int R>
__device__ __forceinline__ void add_partner(const float* src, float (&x)[T][R], int ptid, const Place& q) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int m = 0; m < R; ++m) x[t][m] = x[t][m] + src[(t * R + m) * q.nthr + ptid];
}

// Sum-fold the state x over every bit p set in mask, in ascending p: the
// partners (i, i ^ 1<<p) both take their sum.  Every thread of every CTA of
// the cluster calls it with the same mask (the flags are the instance's).
template <int T, int LR>
__device__ __forceinline__ void sum_fold(float (&x)[T][1 << LR], uint32_t mask, float* xbuf, const Place& q) {
  constexpr int R = 1 << LR;
  if (!mask) return;
  // lane bits: shuffles
  for (int p = 0; p < q.lb; ++p) {
    if ((mask >> p) & 1) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int m = 0; m < R; ++m) x[t][m] = x[t][m] + __shfl_xor_sync(0xffffffffu, x[t][m], 1 << p);
      }
    }
  }
  // warp bits: through the CTA's exchange buffer
  for (int p = q.lb; p < q.Kc; ++p) {
    if ((mask >> p) & 1) {
      put_state<T, R>(xbuf, x, q);
      __syncthreads();
      add_partner<T, R>(xbuf, x, q.tid ^ (1 << p), q);
      __syncthreads();
    }
  }
  // CTA bits: through the partner CTA's exchange buffer
  for (int p = q.Kc; p < q.Ku; ++p) {
    if ((mask >> p) & 1) {
      put_state<T, R>(xbuf, x, q);
      cluster_sync();
      const float* remote = cg::this_cluster().map_shared_rank(xbuf, q.rank ^ (1u << (p - q.Kc)));
      add_partner<T, R>(remote, x, q.tid, q);
      cluster_sync();
    }
  }
  // register bits: inside the thread
#pragma unroll
  for (int r = 0; r < LR; ++r) {
    if ((mask >> (q.Ku + r)) & 1) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int m = 0; m < R; ++m) {
          if (!((m >> r) & 1)) {
            const float s = x[t][m] + x[t][m | (1 << r)];
            x[t][m] = s;
            x[t][m | (1 << r)] = s;
          }
        }
      }
    }
  }
}

// The shape checks of both C entry points: 1 <= K <= kMaxK and the register
// bits of the layout within max_lr(T).  Returns LR, or -1.
inline int layout_lr(int K, int T) {
  if (K < 1 || K > kMaxK) return -1;
  const int kc = K - cluster_bits(K);
  const int lr = kc > kThreadBits ? kc - kThreadBits : 0;
  return lr <= max_lr(T) ? lr : -1;
}

}  // namespace geno
