// General-T (pedigree) wMEC forward column scan for Hopper (sm_90a).
//
// Replaces whatshap_tpu/ops/wmec_pallas.py `_make_kernel` for T > 1 in the
// forms the pedigree route and the segmented solve launch:
//
//   tables   pidx/pjmin per column and the final dp, jmin and key, unseeded
//            (forward_scan_pallas, solve_batched_pallas at T = 4/16),
//            seeded from a (T,) vector per block (forward_tables_seeded_pallas)
//            or started from a carried state (forward_tables_pallas);
//   carry    from a carried state (cost, jmin and key of the previous
//            segment's last column), the final state only, no tables
//            (forward_carry_pallas, the checkpoint pass of the segmented
//            solve, whose recompute pass is the tables mode from a carry);
//   m-only   seeded, and only m[t] = min_i dp[t][i] of the last column comes
//            out (forward_m_seeded_pallas, emit_m_only): no tables, no tie
//            key, no transmission argmin (fold winners have equal cost, so m
//            does not depend on them).
//
// Two template flags make the three modes: kTrack keeps the tie key and the
// transmission argmin and writes the final state (tables and carry), kWrite
// emits the tables (tables only).  Without kWrite the fold is a plain min of
// the costs: the winner's cost is the pair's minimum whichever wins a tie,
// and the folded key, index and jmin feed only the tables.
//
// One CTA per block b runs the whole column loop (the TPU's sequential grid
// axis).  The state of bipartition i is, per transmission plane t, its cost
// and its transmission argmin jmin, plus one tie key per i.  Per column c:
//
//   fold   for every slot p that died before c, in each plane t on its own,
//          the pair (i, i | 1<<p) takes the winner under (cost, key) order, b
//          winning only when strictly better; BOTH partners receive the
//          winner's cost, key, source index and jmin.  The key and the index
//          become per-plane during the fold (each plane breaks its own ties),
//          so the planes are folded one after another through one (key,
//          index) pair of scratch arrays;
//   emit   pidx[b, c, t, i] = source index, pjmin[b, c, t, i] = folded jmin;
//   trans  trans[ti] = min_tj min(cost[tj] + min(popcount(ti^tj) * rc', INF),
//          INF) with rc' = min(rc, INF / max popcount), keeping the FIRST
//          strict minimum over tj ascending as the new jmin[ti];
//   cost   per plane t: f_j = sum_k bit_k(i) * wdiff[k, j] over its 2P
//          entries, cp = f + wbase, s0 = sum_p cp[p][0], d_p = cp[p][1] -
//          cp[p][0]; dp[t] = min(min_a min(s0 + sum_{p in a} d_p + acost[t, a],
//          INF) + trans[t], INF);
//   key    inverse Gray code of sum_k bit_k(i) * rankw[k].
//
// All arithmetic is int32, as in the reference (its f32 sums of integer
// weights are exact and equal these).  Table offsets are size_t: at the trio
// cell B*C*T*2^K = 2^31.
//
// Bound: with tables, the two table writes, 8*T*B*C*2^K bytes; the function
// needs (2*T*P + 1 + T^2)*B*C*2^K int32 adds (one per cost sum and per key
// in Gray order, plus the min-plus), 49*B*C*2^K for a trio (T = 4, P = 4),
// so the bytes bound it.  The carry and m-only modes write nearly nothing
// and are bound by their (2*T*P + 1 + T^2) and (2*T*P + T^2)*B*C*2^K adds.
// The design is the simple one: the state ((2T + 3) int32 words per
// bipartition with tables or carry, T in the m-only mode) sits in dynamic
// shared memory while it fits (T = 4: K <= 12 with tables, K <= 13 m-only;
// T = 16: K <= 10 and K <= 11) and in a per-block global
// scratch above, from one templated body; every fold is one pass with a
// barrier after it, and each state's sums are taken over its K bits, K
// times the adds the function needs.  One CTA per block leaves SMs idle
// below 132 blocks.  Splitting a block over a cluster, incremental sums and
// narrower tables are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kMaxK = 16;
constexpr int kThreads = 512;

struct Args {
  const float* wdiff;    // (B, C, K, T*P*2)
  const int* wbase;      // (B, C, T*P*2)
  const float* rankw;    // (B, C, K)        tables and carry modes
  const int* acost;      // (B, C, T*2^P)
  const uint8_t* die;    // (B, C, K)
  const int* rc;         // (B, C)
  const int* seed;       // (B, T) or null (state starts at 0)
  const int* cost0;      // (B, T, S) or null: carried cost (not with seed)
  const int* jmin0;      // (B, T, S) or null: carried jmin
  const int* key0;       // (B, S) or null: carried tie key
  int* pidx;             // (B, C, T, S)     tables mode
  int* pjmin;            // (B, C, T, S)     tables mode
  int* dp_last;          // (B, T, S)        tables and carry modes
  int* jmin_last;        // (B, T, S)        tables and carry modes
  int* key_last;         // (B, S)           tables and carry modes
  int* m;                // (B, T)           m-only mode
  int* scratch;          // (B, words, S), or null: state in shared memory
  int C;
  int K;
};

__host__ __device__ constexpr int log2_of(int t) { return t <= 1 ? 0 : 1 + log2_of(t >> 1); }

template <int T, int P, bool kTrack, bool kWrite>
__global__ void __launch_bounds__(kThreads) forward_t_kernel(Args a) {
  static_assert(kTrack || !kWrite, "the tables mode tracks the full state");
  constexpr int P2 = 2 * P;
  constexpr int TP2 = T * P2;
  constexpr int NA = 1 << P;
  constexpr int kWords = kTrack ? 2 * T + 3 : T;
  // max popcount(ti ^ tj) over T = 4^n values is log2(T)
  constexpr int kMaxPc = log2_of(T) > 0 ? log2_of(T) : 1;

  extern __shared__ int smem[];
  __shared__ int s_wd[kMaxK * TP2];
  __shared__ int s_wb[TP2];
  __shared__ int s_ac[T * NA];
  __shared__ int s_rw[kMaxK];
  __shared__ int s_die[kMaxK];
  __shared__ int s_rc;
  __shared__ int s_red[kThreads / 32];

  const int C = a.C, K = a.K;
  const int S = 1 << K;
  const int b = blockIdx.x;
  int* state = a.scratch == nullptr ? smem : a.scratch + (size_t)b * kWords * S;
  int* cost = state;              // T planes of S
  int* jmin = state + T * S;      // T planes of S (kTrack)
  int* key = state + 2 * T * S;   // S (kTrack)
  int* fkey = key + S;            // S: the fold's per-plane key
  int* fidx = fkey + S;           // S: the fold's per-plane source index

  for (int i = threadIdx.x; i < S; i += blockDim.x) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const size_t at = ((size_t)b * T + t) * S + i;
      cost[t * S + i] = a.cost0 != nullptr ? a.cost0[at] : a.seed != nullptr ? a.seed[b * T + t] : 0;
      if (kTrack) jmin[t * S + i] = a.jmin0 != nullptr ? a.jmin0[at] : 0;
    }
    if (kTrack) key[i] = a.key0 != nullptr ? a.key0[(size_t)b * S + i] : 0;
  }

  for (int c = 0; c < C; ++c) {
    const size_t col = (size_t)b * C + c;
    // ---- stage the column's inputs
    for (int j = threadIdx.x; j < K * TP2; j += blockDim.x) s_wd[j] = (int)a.wdiff[col * K * TP2 + j];
    for (int j = threadIdx.x; j < TP2; j += blockDim.x) s_wb[j] = a.wbase[col * TP2 + j];
    for (int j = threadIdx.x; j < T * NA; j += blockDim.x) s_ac[j] = a.acost[col * T * NA + j];
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      s_die[k] = a.die[col * K + k];
      if (kTrack) s_rw[k] = (int)a.rankw[col * K + k];
    }
    if (threadIdx.x == 0) s_rc = a.rc[col];
    __syncthreads();
    bool any_die = false;
    for (int p = 0; p < K; ++p) any_die |= s_die[p] != 0;

    // ---- fold dying slot bits (s_die is uniform, so are the branches)
    if (kWrite) {
      for (int t = 0; t < T; ++t) {
        int* ct = cost + t * S;
        int* jt = jmin + t * S;
        if (any_die) {
          for (int i = threadIdx.x; i < S; i += blockDim.x) {
            fkey[i] = key[i];
            fidx[i] = i;
          }
          __syncthreads();
          for (int p = 0; p < K; ++p) {
            if (!s_die[p]) continue;
            const int lo = (1 << p) - 1;
            for (int q = threadIdx.x; q < (S >> 1); q += blockDim.x) {
              const int i0 = ((q & ~lo) << 1) | (q & lo);  // bit p = 0
              const int i1 = i0 | (1 << p);                 // bit p = 1
              const int a_c = ct[i0], b_c = ct[i1];
              const int a_k = fkey[i0], b_k = fkey[i1];
              const bool take_b = (b_c < a_c) || (b_c == a_c && b_k < a_k);
              const int w_c = take_b ? b_c : a_c;
              const int w_k = take_b ? b_k : a_k;
              const int w_i = take_b ? fidx[i1] : fidx[i0];
              const int w_j = take_b ? jt[i1] : jt[i0];
              ct[i0] = w_c;
              ct[i1] = w_c;
              fkey[i0] = w_k;
              fkey[i1] = w_k;
              fidx[i0] = w_i;
              fidx[i1] = w_i;
              jt[i0] = w_j;
              jt[i1] = w_j;
            }
            __syncthreads();
          }
        }
        // ---- emit the plane's tables (each thread on its own states, the
        // same ones it initialises for the next plane, so no barrier here)
        const size_t plane = (col * T + t) * (size_t)S;
        for (int i = threadIdx.x; i < S; i += blockDim.x) {
          a.pidx[plane + i] = any_die ? fidx[i] : i;
          a.pjmin[plane + i] = jt[i];
        }
      }
    } else if (any_die) {
      for (int p = 0; p < K; ++p) {
        if (!s_die[p]) continue;
        const int lo = (1 << p) - 1;
        for (int q = threadIdx.x; q < (S >> 1); q += blockDim.x) {
          const int i0 = ((q & ~lo) << 1) | (q & lo);
          const int i1 = i0 | (1 << p);
#pragma unroll
          for (int t = 0; t < T; ++t) {
            const int w = min(cost[t * S + i0], cost[t * S + i1]);
            cost[t * S + i0] = w;
            cost[t * S + i1] = w;
          }
        }
        __syncthreads();
      }
    }

    // ---- transmission min-plus, column cost and key; each thread on its
    // own states
    const int rc_safe = min(s_rc, kInf / kMaxPc);
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      int folded[T];
#pragma unroll
      for (int t = 0; t < T; ++t) folded[t] = cost[t * S + i];
#pragma unroll
      for (int ti = 0; ti < T; ++ti) {
        int best = min(folded[0] + min(__popc(ti) * rc_safe, kInf), kInf);
        int barg = 0;
#pragma unroll
        for (int tj = 1; tj < T; ++tj) {
          const int v = min(folded[tj] + min(__popc(ti ^ tj) * rc_safe, kInf), kInf);
          if (v < best) {
            best = v;
            barg = tj;
          }
        }
        int f[P2];
#pragma unroll
        for (int j = 0; j < P2; ++j) f[j] = 0;
        for (int k = 0; k < K; ++k) {
          if ((i >> k) & 1) {
#pragma unroll
            for (int j = 0; j < P2; ++j) f[j] += s_wd[k * TP2 + ti * P2 + j];
          }
        }
        int s0 = 0;
        int d[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int cp0 = f[2 * p] + s_wb[ti * P2 + 2 * p];
          const int cp1 = f[2 * p + 1] + s_wb[ti * P2 + 2 * p + 1];
          s0 += cp0;
          d[p] = cp1 - cp0;
        }
        // assignment x: bit p of x puts allele 1 on partition p
        int best_a = kInf;
#pragma unroll
        for (int x = 0; x < NA; ++x) {
          int pa = 0;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if ((x >> p) & 1) pa += d[p];
          }
          best_a = min(best_a, min(s0 + pa + s_ac[ti * NA + x], kInf));
        }
        cost[ti * S + i] = min(best_a + best, kInf);
        if (kTrack) jmin[ti * S + i] = barg;
      }
      if (kTrack) {
        int r = 0;
        for (int k = 0; k < K; ++k) {
          if ((i >> k) & 1) r += s_rw[k];
        }
        for (int sh = 1; sh < K; sh <<= 1) r ^= r >> sh;
        key[i] = r;
      }
    }
    __syncthreads();
  }

  if (kTrack) {
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        a.dp_last[((size_t)b * T + t) * S + i] = cost[t * S + i];
        a.jmin_last[((size_t)b * T + t) * S + i] = jmin[t * S + i];
      }
      a.key_last[(size_t)b * S + i] = key[i];
    }
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    for (int t = 0; t < T; ++t) {
      int v = 2 * kInf;
      for (int i = threadIdx.x; i < S; i += blockDim.x) v = min(v, cost[t * S + i]);
      for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) s_red[warp] = v;
      __syncthreads();
      if (threadIdx.x == 0) {
        int w = s_red[0];
        for (int j = 1; j < n_warps; ++j) w = min(w, s_red[j]);
        a.m[b * T + t] = w;
      }
      __syncthreads();
    }
  }
}

template <int T, int P, bool kTrack, bool kWrite>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int kWords = kTrack ? 2 * T + 3 : T;
  const int S = 1 << a.K;
  const int threads = S < kThreads ? (S < 32 ? 32 : S) : kThreads;
  size_t smem = 0;
  if (a.scratch == nullptr) {
    smem = (size_t)kWords * S * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        forward_t_kernel<T, P, kTrack, kWrite>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  forward_t_kernel<T, P, kTrack, kWrite><<<B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kTrack, bool kWrite>
int dispatch(const Args& a, int B, int T, int P, cudaStream_t stream) {
  if (T == 4 && P == 2) return launch<4, 2, kTrack, kWrite>(a, B, stream);
  if (T == 4 && P == 4) return launch<4, 4, kTrack, kWrite>(a, B, stream);
  if (T == 16 && P == 2) return launch<16, 2, kTrack, kWrite>(a, B, stream);
  if (T == 16 && P == 4) return launch<16, 4, kTrack, kWrite>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Tables mode: unseeded, seeded from seed (B, T), or from a carried state
// (cost0, jmin0, key0); seed and carry are exclusive.
extern "C" int wmec_forward_t(const float* wdiff, const int* wbase, const float* rankw,
                              const int* acost, const uint8_t* die, const int* rc,
                              const int* seed, const int* cost0, const int* jmin0,
                              const int* key0, int* pidx, int* pjmin, int* dp_last,
                              int* jmin_last, int* key_last, int* scratch, int B, int C,
                              int K, int T, int P, cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1 || K > kMaxK || (seed != nullptr && cost0 != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{wdiff, wbase, rankw, acost, die, rc, seed, cost0, jmin0, key0, pidx, pjmin, dp_last,
         jmin_last, key_last, nullptr, scratch, C, K};
  return dispatch<true, true>(a, B, T, P, stream);
}

// Carry mode: from the carried state (cost0, jmin0, key0) to the state after
// the last column (dp_last, jmin_last, key_last), no tables.  The outputs
// must not alias the carry: a checkpoint is read again by the tables pass.
extern "C" int wmec_forward_carry_t(const float* wdiff, const int* wbase, const float* rankw,
                                    const int* acost, const uint8_t* die, const int* rc,
                                    const int* cost0, const int* jmin0, const int* key0,
                                    int* dp_last, int* jmin_last, int* key_last, int* scratch,
                                    int B, int C, int K, int T, int P, cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  Args a{wdiff, wbase, rankw, acost, die, rc, nullptr, cost0, jmin0, key0, nullptr, nullptr,
         dp_last, jmin_last, key_last, nullptr, scratch, C, K};
  return dispatch<true, false>(a, B, T, P, stream);
}

extern "C" int wmec_forward_m_t(const float* wdiff, const int* wbase, const int* acost,
                                const uint8_t* die, const int* rc, const int* seed, int* m,
                                int* scratch, int B, int C, int K, int T, int P,
                                cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1 || K > kMaxK || seed == nullptr) return (int)cudaErrorInvalidValue;
  Args a{wdiff, wbase, nullptr, acost, die, rc, seed, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, nullptr, m, scratch, C, K};
  return dispatch<false, false>(a, B, T, P, stream);
}

extern "C" const char* wmec_forward_t_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
