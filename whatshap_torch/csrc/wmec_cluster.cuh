// The pieces the two wMEC forward kernels share (wmec_forward_t1.cu at
// T = 1, wmec_forward_t.cu at T > 1), both one thread-block cluster per
// block with the block's state in the cluster's shared memory (cluster.cuh):
// the launch arguments, the staged column record and its double-buffered
// prefetch, the thread's place in the state index (lane | warp | CTA rank |
// loop bits from the bottom up, and the hi rows of the column's sums tables)
// and the tables mode's fold of one pair.

#pragma once

#include "cluster.cuh"

namespace wmec {

namespace cg = cooperative_groups;

constexpr int kInf = 1 << 29;
constexpr int kPre = 4;  // staged input words a thread prefetches per column

enum Mode { kTables, kCarry, kMinOnly };

struct Args {
  const float* wdiff;    // (B, C, K, T*P*2)
  const int* wbase;      // (B, C, T*P*2)
  const float* rankw;    // (B, C, K)        tables and carry modes
  const int* acost;      // (B, C, T*2^P)
  const uint8_t* die;    // (B, C, K)
  const int* rc;         // (B, C), or null (T = 1 does not read it)
  const int* seed;       // (B, T) or null (state starts at 0)
  const int* cost0;      // (B, T, S) or null: carried cost (not with seed)
  const int* jmin0;      // (B, T, S) or null: carried jmin (tables mode)
  const int* key0;       // (B, S) or null: carried tie key (tables mode)
  int* pidx;             // (B, C, T, S)     tables mode
  int* pjmin;            // (B, C, T, S)     tables mode, T > 1
  int* dp_last;          // (B, T, S)        tables and carry modes
  int* jmin_last;        // (B, T, S)        tables and carry modes, T > 1
  int* key_last;         // (B, S)           tables and carry modes
  int* m;                // (B, T)           m-only mode
  int C;
  int K;
  int cbits;
};

__host__ __device__ constexpr int log2_of(int t) { return t <= 1 ? 0 : 1 + log2_of(t >> 1); }
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int ctz_of(int g) { return (g & 1) ? 0 : 1 + ctz_of(g >> 1); }

// One column's inputs as one int record in shared memory:
//   wdiff (K*TP2) | wbase (TP2) | acost (T*NA) | rankw (K) | die (K, 0/1) | rc
template <int T, int P>
struct Rec {
  static constexpr int P2 = 2 * P, TP2 = T * P2, NA = 1 << P;
  __host__ __device__ static int words(int K) { return K * TP2 + TP2 + T * NA + 2 * K + 1; }
  __device__ static int wb(int K) { return K * TP2; }
  __device__ static int ac(int K) { return K * TP2 + TP2; }
  __device__ static int rw(int K) { return ac(K) + T * NA; }
  __device__ static int die(int K) { return rw(K) + K; }
  __device__ static int rc(int K) { return die(K) + K; }
};

template <int T, int P>
__device__ __forceinline__ int load_word(const Args& a, size_t col, int K, int j) {
  using R = Rec<T, P>;
  const int nd = K * R::TP2;
  if (j < nd) return (int)__ldg(a.wdiff + col * nd + j);
  j -= nd;
  if (j < R::TP2) return __ldg(a.wbase + col * R::TP2 + j);
  j -= R::TP2;
  if (j < T * R::NA) return __ldg(a.acost + col * (T * R::NA) + j);
  j -= T * R::NA;
  if (j < K) return a.rankw != nullptr ? (int)__ldg(a.rankw + col * K + j) : 0;
  j -= K;
  if (j < K) return a.die[col * K + j] ? 1 : 0;
  return a.rc != nullptr ? __ldg(a.rc + col) : 0;
}

// Double-buffered staging of the column records: issue() loads the next
// column's words into registers while the current column computes, commit()
// writes them into the other buffer (words beyond kPre per thread are loaded
// there directly).
template <int T, int P>
struct Stage {
  int pre[kPre];
  __device__ __forceinline__ void issue(const Args& a, size_t col, int K, int W) {
#pragma unroll
    for (int s = 0; s < kPre; ++s) {
      const int j = threadIdx.x + s * blockDim.x;
      if (j < W) pre[s] = load_word<T, P>(a, col, K, j);
    }
  }
  __device__ __forceinline__ void commit(int* dst, const Args& a, size_t col, int K, int W) {
#pragma unroll
    for (int s = 0; s < kPre; ++s) {
      const int j = threadIdx.x + s * blockDim.x;
      if (j < W) dst[j] = pre[s];
    }
    for (int j = threadIdx.x + kPre * blockDim.x; j < W; j += blockDim.x) dst[j] = load_word<T, P>(a, col, K, j);
  }
};

// Where the thread sits in its block's state.
struct Place {
  int K, cbits, tb, lb, wb;  // state, CTA, thread, lane and warp bits
  unsigned rank;             // CTA rank in the cluster
  int tid, lane, warp;
  bool active;               // the thread holds states
};

template <int LR>
__device__ __forceinline__ Place place(int K, int cbits) {
  Place q;
  q.K = K;
  q.cbits = cbits;
  q.tb = K - cbits - LR;
  q.lb = min(5, q.tb);
  q.wb = q.tb - q.lb;
  q.rank = cg::this_cluster().block_rank();
  q.tid = threadIdx.x;
  q.lane = q.tid & 31;
  q.warp = q.tid >> 5;
  q.active = q.tid < (1 << q.tb);
  return q;
}

// The block-wide index of the thread's state m, and its slot in the CTA's
// state planes.
__device__ __forceinline__ uint32_t gidx(const Place& q, int m) {
  return ((uint32_t)m << (q.tb + q.cbits)) | ((uint32_t)q.rank << q.tb) | (uint32_t)q.tid;
}
__device__ __forceinline__ int slot(const Place& q, int m) { return (m << q.tb) | q.tid; }
// The thread's row of the hi sums for its state m.
__device__ __forceinline__ int hrow(const Place& q, int m) { return q.warp | (m << q.wb); }

// The state index bits above the lane bits of the states of hi row h: warp
// h & (2^wb - 1), the CTA's rank, loop value h >> wb.
__device__ __forceinline__ uint32_t hi_bits(const Place& q, int h) {
  return ((uint32_t)(h & ((1 << q.wb) - 1)) << q.lb) | ((uint32_t)q.rank << q.tb) |
         ((uint32_t)(h >> q.wb) << (q.tb + q.cbits));
}

// The tables mode's fold of one pair: `low` says the thread's state has bit
// p = 0 (it is a, the partner b); b wins only when strictly better under
// (cost, key), and the winner's cost, key, index and jmin go to both.
__device__ __forceinline__ void merge(int& c, int& k, int& ix, int& j, int pc, int pk, int pix, int pj, bool low) {
  const bool partner = low ? (pc < c || (pc == c && pk < k)) : !(c < pc || (c == pc && k < pk));
  if (partner) {
    c = pc;
    k = pk;
    ix = pix;
    j = pj;
  }
}

// The same without the jmin payload (T = 1).
__device__ __forceinline__ void merge(int& c, int& k, int& ix, int pc, int pk, int pix, bool low) {
  int j = 0;
  merge(c, k, ix, j, pc, pk, pix, 0, low);
}

}  // namespace wmec
