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
//            out (forward_m_seeded_pallas, emit_m_only).
//
// The state of bipartition i is, per transmission plane t, its cost and its
// transmission argmin jmin, plus one tie key per i.  Per column c:
//
//   fold   for every slot p that died before c, in ascending p and in each
//          plane t on its own, the pair (i, i | 1<<p) takes the winner under
//          (cost, key) order, b winning only when strictly better; BOTH
//          partners receive the winner's cost, key, source index and jmin.
//          The key and the index start as key[i] and i in every plane;
//   emit   pidx[b, c, t, i] = source index, pjmin[b, c, t, i] = folded jmin;
//   trans  trans[ti] = min_tj min(cost[tj] + min(popcount(ti^tj) * rc', INF),
//          INF) with rc' = min(rc, INF / max popcount), keeping the FIRST
//          strict minimum over tj ascending as the new jmin[ti];
//   cost   per plane t: f_j = sum_k bit_k(i) * wdiff[k, t*2P + j] over its 2P
//          entries, cp = f + wbase, s0 = sum_p cp[p][0], d_p = cp[p][1] -
//          cp[p][0]; dp[t] = min(min_a min(s0 + sum_{p in a} d_p + acost[t, a],
//          INF) + trans[t], INF);
//   key    inverse Gray code of sum_k bit_k(i) * rankw[k].
//
// Without tables the fold is a plain min of the costs: the winner's cost is
// the pair's minimum whichever wins a tie.  The key and jmin are overwritten
// for every state in every column and, under the min fold, never feed back
// into a cost, so the carry and m-only modes keep only the T costs of a
// state; the carry mode computes jmin and the key at its last column.  All
// arithmetic is int32, as in the reference (its f32 sums of integer weights
// are exact and equal these), so any order of the sums gives its bits.
// Table offsets are size_t: at the trio cell B*C*T*2^K = 2^31.
//
// Bound: with tables, the two table writes, 8*T*B*C*2^K bytes; the function
// needs (2*T*P + 1 + T^2)*B*C*2^K int32 adds (one per cost sum and per key
// in Gray order, plus the min-plus), so the bytes bound it at a trio.  The
// carry and m-only modes write nearly nothing and are bound by their adds.
//
// Design (the pieces shared with the T = 1 kernel, wmec_forward_t1.cu, are in
// wmec_cluster.cuh).  One thread-block cluster of N = 2^cbits CTAs per block
// (16 from K = 13, fewer below so that each CTA keeps 2^9 states;
// cluster.cuh), each
// CTA of up to 512 threads.  A state index is, from its low bits up: lane |
// warp | CTA rank | loop bits (LR = K - cbits - 9 when positive): thread tid
// of CTA r holds the states m << (tb + cbits) | r << tb | tid, m < 2^LR, so a
// warp writes each table row in 128 contiguous bytes.  The layout is a fixed
// function of K (wmec_cuda.forward_t_layout mirrors it, shared bytes
// included).  The state lives in the shared memory of the cluster's CTAs
// ((2T + 3) words a state with tables: cost, jmin, key and the fold's key
// and index; T words without), at every shape of the envelope, and in
// registers while a thread works on it.  A fold goes by the level of its
// bit: shuffles (lane), the CTA's shared memory between two barriers
// (warp), the partner CTA's shared memory between two cluster barriers
// (CTA rank), inside the thread (loop bits); a fold over a CTA bit moves the
// payload (index, jmin) with the cost and key.  The sums are O(1) a state:
// per column each CTA tabulates the part of every f_j and of the rank sum
// that the lane bits give (lo, 32 rows) and the part of the warp, rank and
// loop bits (hi, one row per warp and loop value), so a state's f_j is
// lo + hi.  The next column's inputs are loaded while a column computes.

#include "wmec_cluster.cuh"

namespace {

using namespace wmec;
using clusters::cluster_sync;
using clusters::kThreadBits;

constexpr int kMaxK = 16;
constexpr int kWarps = (1 << kThreadBits) / 32;

// Largest LR per transmission count, at the top K of the envelope (16, 13).
__host__ __device__ constexpr int max_lr(int T) { return T == 4 ? 3 : 0; }

// The sum over the bits k set in `bits` of w[k * stride], one add a set bit.
__device__ __forceinline__ int bit_sum(const int* w, int stride, uint32_t bits) {
  int v = 0;
  for (; bits != 0; bits &= bits - 1) v += w[(__ffs(bits) - 1) * stride];
  return v;
}

// The column's sums tables: lo[j*32 + l] = sum over the lane bits k set in l
// of wdiff[k, j]; hi[h*TP2 + j] = the same over the bits hi_bits(q, h); lr
// and hr the same of rankw, when with_key.
template <int T, int P, int LR>
__device__ __forceinline__ void build_sums(const int* rec, int* lo, int* hi, int* lr, int* hr, bool with_key,
                                           const Place& q) {
  constexpr int TP2 = Rec<T, P>::TP2;
  const int hbits = q.wb + LR;
  const int* rw = rec + Rec<T, P>::rw(q.K);
  const uint32_t lane_mask = (1u << q.lb) - 1;
  for (int e = q.tid; e < TP2 * 32; e += blockDim.x) {
    const int j = e >> 5;
    lo[e] = bit_sum(rec + j, TP2, (uint32_t)e & lane_mask);
  }
  const int n_hi = TP2 << hbits;
  for (int e = q.tid; e < n_hi; e += blockDim.x) {
    const int h = e / TP2, j = e - h * TP2;
    hi[e] = bit_sum(rec + j, TP2, hi_bits(q, h));
  }
  if (with_key) {
    for (int l = q.tid; l < 32; l += blockDim.x) lr[l] = bit_sum(rw, 1, (uint32_t)l & lane_mask);
    for (int h = q.tid; h < (1 << hbits); h += blockDim.x) hr[h] = bit_sum(rw, 1, hi_bits(q, h));
  }
}

template <int T, int P, int LR, int kMode>
__global__ void __launch_bounds__(1 << kThreadBits, 1) forward_t_kernel(Args a) {
  using Rc = Rec<T, P>;
  constexpr bool kTab = kMode == kTables;
  constexpr int R = 1 << LR, P2 = Rc::P2, TP2 = Rc::TP2, NA = Rc::NA;
  // max popcount(ti ^ tj) over T = 4^n values is log2(T)
  constexpr int kMaxPc = log2_of(T) > 0 ? log2_of(T) : 1;

  extern __shared__ int4 smem4[];
  const int K = a.K, C = a.C;
  const Place q = place<LR>(K, a.cbits);
  cg::cluster_group cluster = cg::this_cluster();
  const size_t S = (size_t)1 << K;
  const int Sl = 1 << (K - q.cbits);  // states of a CTA
  const int b = blockIdx.x >> q.cbits;
  const int W = Rc::words(K), Wp = round4(W);
  const int hbits = q.wb + LR;

  int* cost = reinterpret_cast<int*>(smem4);  // [T][Sl]
  int* jmin = cost + T * Sl;                  // [T][Sl]  tables mode
  int* key = jmin + T * Sl;                   // [Sl]     tables mode
  int* fkey = key + Sl;                       // [Sl]     tables mode: the fold's key
  int* fidx = fkey + Sl;                      // [Sl]     tables mode: the fold's index
  int* rec0 = cost + (kTab ? 2 * T + 3 : T) * Sl;  // [2][Wp] column records
  int* lo = rec0 + 2 * Wp;                    // [TP2][32]
  int* hi = lo + TP2 * 32;                    // [2^hbits][TP2]
  int* lr = hi + (TP2 << hbits);              // [32]
  int* hr = lr + 32;                          // [2^hbits]
  int* red = hr + (1 << hbits);               // [kWarps][T], then [T]  m-only mode

  const size_t col0 = (size_t)b * C;
  Stage<T, P> st;
  st.issue(a, col0, K, W);
  st.commit(rec0, a, col0, K, W);
  if (q.active) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int s = slot(q, m);
      const uint32_t i = gidx(q, m);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const size_t at = ((size_t)b * T + t) * S + i;
        cost[t * Sl + s] = a.cost0 != nullptr ? a.cost0[at] : a.seed != nullptr ? a.seed[b * T + t] : 0;
        if (kTab) jmin[t * Sl + s] = a.jmin0 != nullptr ? a.jmin0[at] : 0;
      }
      if (kTab) key[s] = a.key0 != nullptr ? a.key0[(size_t)b * S + i] : 0;
    }
  }
  __syncthreads();

  int mn[T];  // m-only: the thread's minimum of each plane at the last column
#pragma unroll
  for (int t = 0; t < T; ++t) mn[t] = 2 * kInf;

  for (int c = 0; c < C; ++c) {
    const int* rec = rec0 + (c & 1) * Wp;
    const size_t col = col0 + c;
    const bool last = c == C - 1;
    if (!last) st.issue(a, col + 1, K, W);
    const bool with_key = kTab || (kMode == kCarry && last);
    build_sums<T, P, LR>(rec, lo, hi, lr, hr, with_key, q);
    __syncthreads();
    uint32_t mask = 0;
    for (int k = 0; k < K; ++k) mask |= (uint32_t)(rec[Rc::die(K) + k] != 0) << k;
    const int ctab = q.tb + q.cbits;  // the lowest loop bit

    // ---- fold and emit; `mask` is the block's, so every thread of the
    // cluster takes the same branches
    int x[kTab ? 1 : T][R];  // the folded costs, min modes
    if constexpr (kTab) {
      for (int t = 0; t < T; ++t) {
        int* ct = cost + t * Sl;
        int* jt = jmin + t * Sl;
        int cv[R], jv[R], kv[R], iv[R];
#pragma unroll
        for (int m = 0; m < R; ++m) {
          iv[m] = (int)gidx(q, m);
          cv[m] = jv[m] = kv[m] = 0;
          if (q.active) {
            const int s = slot(q, m);
            cv[m] = ct[s];
            jv[m] = jt[s];
            kv[m] = key[s];
          }
        }
        if (mask) {
          for (int p = 0; p < q.lb; ++p) {
            if (!((mask >> p) & 1)) continue;
            const bool low = !((q.lane >> p) & 1);
#pragma unroll
            for (int m = 0; m < R; ++m) {
              const int pc = __shfl_xor_sync(0xffffffffu, cv[m], 1 << p);
              const int pk = __shfl_xor_sync(0xffffffffu, kv[m], 1 << p);
              const int pi = __shfl_xor_sync(0xffffffffu, iv[m], 1 << p);
              const int pj = __shfl_xor_sync(0xffffffffu, jv[m], 1 << p);
              merge(cv[m], kv[m], iv[m], jv[m], pc, pk, pi, pj, low);
            }
          }
          for (int p = q.lb; p < K; ++p) {
            if (!((mask >> p) & 1) || p >= ctab) continue;
            const bool cta_bit = p >= q.tb;
            if (q.active) {
#pragma unroll
              for (int m = 0; m < R; ++m) {
                const int s = slot(q, m);
                ct[s] = cv[m];
                jt[s] = jv[m];
                fkey[s] = kv[m];
                fidx[s] = iv[m];
              }
            }
            if (cta_bit) {
              cluster_sync();
            } else {
              __syncthreads();
            }
            const unsigned pr = cta_bit ? q.rank ^ (1u << (p - q.tb)) : q.rank;
            const int* rct = cta_bit ? cluster.map_shared_rank(ct, pr) : ct;
            const int* rjt = cta_bit ? cluster.map_shared_rank(jt, pr) : jt;
            const int* rfk = cta_bit ? cluster.map_shared_rank(fkey, pr) : fkey;
            const int* rfi = cta_bit ? cluster.map_shared_rank(fidx, pr) : fidx;
            const bool low = cta_bit ? !((q.rank >> (p - q.tb)) & 1) : !((q.tid >> p) & 1);
            if (q.active) {
#pragma unroll
              for (int m = 0; m < R; ++m) {
                const int ps = cta_bit ? slot(q, m) : slot(q, m) ^ (1 << p);
                merge(cv[m], kv[m], iv[m], jv[m], rct[ps], rfk[ps], rfi[ps], rjt[ps], low);
              }
            }
            if (cta_bit) {
              cluster_sync();
            } else {
              __syncthreads();
            }
          }
#pragma unroll
          for (int r = 0; r < LR; ++r) {
            if (!((mask >> (ctab + r)) & 1)) continue;
#pragma unroll
            for (int m = 0; m < R; ++m) {
              if ((m >> r) & 1) continue;
              const int m1 = m | (1 << r);
              merge(cv[m], kv[m], iv[m], jv[m], cv[m1], kv[m1], iv[m1], jv[m1], true);
              cv[m1] = cv[m];
              kv[m1] = kv[m];
              iv[m1] = iv[m];
              jv[m1] = jv[m];
            }
          }
        }
        if (q.active) {
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const size_t at = (col * T + t) * S + gidx(q, m);
            a.pidx[at] = iv[m];
            a.pjmin[at] = jv[m];
            ct[slot(q, m)] = cv[m];
          }
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int m = 0; m < R; ++m) x[t][m] = q.active ? cost[t * Sl + slot(q, m)] : 0;
      if (mask) {
        for (int p = 0; p < q.lb; ++p) {
          if (!((mask >> p) & 1)) continue;
#pragma unroll
          for (int t = 0; t < T; ++t)
#pragma unroll
            for (int m = 0; m < R; ++m) x[t][m] = min(x[t][m], __shfl_xor_sync(0xffffffffu, x[t][m], 1 << p));
        }
        for (int p = q.lb; p < K; ++p) {
          if (!((mask >> p) & 1) || p >= ctab) continue;
          const bool cta_bit = p >= q.tb;
          if (q.active) {
#pragma unroll
            for (int t = 0; t < T; ++t)
#pragma unroll
              for (int m = 0; m < R; ++m) cost[t * Sl + slot(q, m)] = x[t][m];
          }
          if (cta_bit) {
            cluster_sync();
          } else {
            __syncthreads();
          }
          const int* src = cta_bit ? cluster.map_shared_rank(cost, q.rank ^ (1u << (p - q.tb))) : cost;
          if (q.active) {
#pragma unroll
            for (int m = 0; m < R; ++m) {
              const int ps = cta_bit ? slot(q, m) : slot(q, m) ^ (1 << p);
#pragma unroll
              for (int t = 0; t < T; ++t) x[t][m] = min(x[t][m], src[t * Sl + ps]);
            }
          }
          if (cta_bit) {
            cluster_sync();
          } else {
            __syncthreads();
          }
        }
#pragma unroll
        for (int r = 0; r < LR; ++r) {
          if (!((mask >> (ctab + r)) & 1)) continue;
#pragma unroll
          for (int t = 0; t < T; ++t)
#pragma unroll
            for (int m = 0; m < R; ++m) {
              if ((m >> r) & 1) continue;
              const int w = min(x[t][m], x[t][m | (1 << r)]);
              x[t][m] = w;
              x[t][m | (1 << r)] = w;
            }
        }
      }
    }

    // ---- transmission min-plus, column cost and key; each thread on its
    // own states
    const int* wbase = rec + Rc::wb(K);
    const int* ac = rec + Rc::ac(K);
    const int rc_safe = min(rec[Rc::rc(K)], kInf / kMaxPc);
    int rt[kMaxPc + 1];
#pragma unroll
    for (int pc = 0; pc <= kMaxPc; ++pc) rt[pc] = min(pc * rc_safe, kInf);
    if (q.active) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int s = slot(q, m);
        const uint32_t i = gidx(q, m);
        const int* hrw = hi + hrow(q, m) * TP2;
        int fo[T];
#pragma unroll
        for (int t = 0; t < T; ++t) fo[t] = kTab ? cost[t * Sl + s] : x[kTab ? 0 : t][m];
#pragma unroll
        for (int ti = 0; ti < T; ++ti) {
          int best = min(fo[0] + rt[__popc(ti)], kInf);
          int barg = 0;
#pragma unroll
          for (int tj = 1; tj < T; ++tj) {
            const int v = min(fo[tj] + rt[__popc(ti ^ tj)], kInf);
            if (v < best) {
              best = v;
              barg = tj;
            }
          }
          int s0 = 0;
          int d[P];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int j0 = ti * P2 + 2 * p;
            const int cp0 = lo[j0 * 32 + q.lane] + hrw[j0] + wbase[j0];
            const int cp1 = lo[(j0 + 1) * 32 + q.lane] + hrw[j0 + 1] + wbase[j0 + 1];
            s0 += cp0;
            d[p] = cp1 - cp0;
          }
          // assignment x: bit p of x puts allele 1 on partition p; the x
          // in Gray order, so each partial sum pa takes one add, and
          // min_x min(s0 + pa + acost, INF) = min(s0 + min_x (pa + acost),
          // INF) (no sum comes near the int32 range)
          int pa = 0, best_pa = ac[ti * NA];
#pragma unroll
          for (int g = 1; g < NA; ++g) {
            const int p = ctz_of(g), xa = g ^ (g >> 1);
            pa += ((xa >> p) & 1) ? d[p] : -d[p];
            best_pa = min(best_pa, pa + ac[ti * NA + xa]);
          }
          const int best_a = min(s0 + best_pa, kInf);
          const int nc = min(best_a + best, kInf);
          if (kMode == kMinOnly) {
            if (last) {
              mn[ti] = min(mn[ti], nc);
            } else {
              cost[ti * Sl + s] = nc;
            }
          } else if (last) {
            const size_t at = ((size_t)b * T + ti) * S + i;
            a.dp_last[at] = nc;
            a.jmin_last[at] = barg;
          } else {
            cost[ti * Sl + s] = nc;
            if (kTab) jmin[ti * Sl + s] = barg;
          }
        }
        if (with_key) {
          int r = lr[q.lane] + hr[hrow(q, m)];
          for (int sh = 1; sh < K; sh <<= 1) r ^= r >> sh;
          if (last) {
            a.key_last[(size_t)b * S + i] = r;
          } else {
            key[s] = r;
          }
        }
      }
    }
    if (!last) st.commit(rec0 + ((c + 1) & 1) * Wp, a, col + 1, K, W);
    __syncthreads();
  }

  if (kMode == kMinOnly) {
    // m[b, t]: warp shuffles, the CTA's warps, then CTA 0 over the cluster
    const int n_warps = (blockDim.x + 31) >> 5;
    int* cred = red + kWarps * T;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      int v = mn[t];
      for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (q.lane == 0) red[q.warp * T + t] = v;
    }
    __syncthreads();
    if (q.tid < T) {
      int v = red[q.tid];
      for (int w = 1; w < n_warps; ++w) v = min(v, red[w * T + q.tid]);
      cred[q.tid] = v;
    }
    cluster_sync();
    if (q.rank == 0 && q.tid < T) {
      int v = cred[q.tid];
      for (unsigned r = 1; r < (1u << q.cbits); ++r) v = min(v, *cluster.map_shared_rank(cred + q.tid, r));
      a.m[b * T + q.tid] = v;
    }
    cluster_sync();  // no CTA leaves while CTA 0 reads its shared memory
  }
}

// The layout of a block's state, a fixed function of (K, T, P, mode) that
// forward_t_layout in whatshap_torch/ops/wmec_cuda.py computes the same way:
// the CTA bits are clusters::cluster_bits(K), layout_lr the loop bits (-1
// where the shape is not supported), smem_bytes a CTA's shared memory.
int layout_lr(int K, int T) {
  if (K < 1 || K > kMaxK) return -1;
  const int kl = K - clusters::cluster_bits(K);
  const int lr = kl > kThreadBits ? kl - kThreadBits : 0;
  return lr <= max_lr(T) ? lr : -1;
}

size_t smem_bytes(int K, int T, int P, bool tables) {
  const int cbits = clusters::cluster_bits(K);
  const int kl = K - cbits;
  const int tb = kl < kThreadBits ? kl : kThreadBits;
  const int lr = kl - tb;
  const int lb = tb < 5 ? tb : 5;
  const int hbits = tb - lb + lr;
  const int tp2 = T * 2 * P;
  const size_t state = (size_t)(tables ? 2 * T + 3 : T) << kl;
  const size_t rec = 2 * (size_t)round4(K * tp2 + tp2 + (T << P) + 2 * K + 1);
  const size_t sums = (size_t)tp2 * 32 + ((size_t)tp2 << hbits) + 32 + ((size_t)1 << hbits);
  const size_t red = (size_t)kWarps * T + T;
  return (state + rec + sums + red) * sizeof(int);
}

template <int T, int P, int LR, int kMode>
int launch(const Args& a, int B, cudaStream_t stream) {
  return clusters::launch_clusters(forward_t_kernel<T, P, LR, kMode>, a, B, a.K, a.cbits, LR,
                                   smem_bytes(a.K, T, P, kMode == kTables), stream);
}

template <int T, int P, int LR, int kMode>
int by_lr(const Args& a, int B, int lr, cudaStream_t stream) {
  if (lr == LR) return launch<T, P, LR, kMode>(a, B, stream);
  if constexpr (LR > 0) {
    return by_lr<T, P, LR - 1, kMode>(a, B, lr, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

template <int kMode>
int dispatch(const Args& a, int B, int T, int P, cudaStream_t stream) {
  const int lr = layout_lr(a.K, T);
  if (B < 1 || a.C < 1 || lr < 0) return (int)cudaErrorInvalidValue;
  if (T == 4 && P == 2) return by_lr<4, 2, max_lr(4), kMode>(a, B, lr, stream);
  if (T == 4 && P == 4) return by_lr<4, 4, max_lr(4), kMode>(a, B, lr, stream);
  if (T == 16 && P == 2) return by_lr<16, 2, max_lr(16), kMode>(a, B, lr, stream);
  if (T == 16 && P == 4) return by_lr<16, 4, max_lr(16), kMode>(a, B, lr, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Tables mode: unseeded, seeded from seed (B, T), or from a carried state
// (cost0, jmin0, key0); seed and carry are exclusive.
extern "C" int wmec_forward_t(const float* wdiff, const int* wbase, const float* rankw,
                              const int* acost, const uint8_t* die, const int* rc,
                              const int* seed, const int* cost0, const int* jmin0,
                              const int* key0, int* pidx, int* pjmin, int* dp_last,
                              int* jmin_last, int* key_last, int B, int C, int K, int T, int P,
                              cudaStream_t stream) {
  if (seed != nullptr && cost0 != nullptr) return (int)cudaErrorInvalidValue;
  Args a{wdiff, wbase, rankw, acost, die, rc, seed, cost0, jmin0, key0, pidx, pjmin, dp_last,
         jmin_last, key_last, nullptr, C, K, clusters::cluster_bits(K)};
  return dispatch<kTables>(a, B, T, P, stream);
}

// Carry mode: from the carried state to the state after the last column
// (dp_last, jmin_last, key_last), no tables.  Only the carried cost0 is
// read: jmin0 and key0 are overwritten in the first column before the min
// fold could read them (they stay in the signature, which is the tables
// mode's).  The outputs must not alias the carry: a checkpoint is read
// again by the tables pass.
extern "C" int wmec_forward_carry_t(const float* wdiff, const int* wbase, const float* rankw,
                                    const int* acost, const uint8_t* die, const int* rc,
                                    const int* cost0, const int* jmin0, const int* key0,
                                    int* dp_last, int* jmin_last, int* key_last, int B, int C,
                                    int K, int T, int P, cudaStream_t stream) {
  (void)jmin0;
  (void)key0;
  Args a{wdiff, wbase, rankw, acost, die, rc, nullptr, cost0, nullptr, nullptr, nullptr, nullptr,
         dp_last, jmin_last, key_last, nullptr, C, K, clusters::cluster_bits(K)};
  return dispatch<kCarry>(a, B, T, P, stream);
}

// m-only mode: seeded from seed (B, T); writes m (B, T).
extern "C" int wmec_forward_m_t(const float* wdiff, const int* wbase, const int* acost,
                                const uint8_t* die, const int* rc, const int* seed, int* m, int B,
                                int C, int K, int T, int P, cudaStream_t stream) {
  if (seed == nullptr) return (int)cudaErrorInvalidValue;
  Args a{wdiff, wbase, nullptr, acost, die, rc, seed, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, m, C, K, clusters::cluster_bits(K)};
  return dispatch<kMinOnly>(a, B, T, P, stream);
}

extern "C" const char* wmec_forward_t_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
