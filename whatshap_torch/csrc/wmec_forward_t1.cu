// T=1 wMEC forward column scan for Hopper (sm_90a).
//
// Replaces whatshap_tpu/ops/wmec_pallas.py `_make_kernel` at T=1 in the
// forms the single-sample routes launch:
//
//   tables   the projection table of every column and the final state, from
//            a zero state (solve_batched_pallas) or from a carried state
//            (forward_tables_pallas, the recompute pass of the segmented
//            solve): entry point wmec_forward_t1;
//   carry    the final state only, no table (forward_carry_pallas, the
//            checkpoint pass of the segmented solve): wmec_forward_carry_t1.
//
// The state starts as the carry (cost0, key0), or zero where those pointers
// are null.  Per column c, over the 2^K bipartitions i of the block's read
// slots:
//
//   fold  for every slot p that died before c, in ascending p, the pair
//         (i, i | 1<<p) takes the winner under (cost, tie key) order, b
//         winning only when it is strictly better; BOTH partners receive the
//         winner's cost, key and source index (the reference's forward
//         projection).  The index starts as i in every column.  The carry
//         mode keeps no table, and the winner's cost is the pair's minimum
//         whichever wins a tie, so there the fold is a min of the costs;
//   emit  pidx[b, c, i] = source index, the backtrace table (tables mode);
//   cost  f_j = sum_k bit_k(i) * wdiff[k, j] (j = 2p + allele), cp = f + wbase,
//         s0 = cp[0][0] + cp[1][0], d_p = cp[p][1] - cp[p][0];
//         dp = min(min_a min(s0 + sum_{p in a} d_p + acost_a, INF) + folded, INF);
//   key   inverse Gray code of sum_k bit_k(i) * rankw[k].
//
// T = 1 has no transmission state, so the recombination cost plays no part.
// All arithmetic is int32, as in the reference (the weights are integers, so
// the reference's f32 sums are exact and equal these, in any order).  The
// key and the index never feed back into a cost under the min fold, so the
// carry mode keeps only the cost of a state and computes the key at its last
// column.
//
// Bound: in the tables mode the table write, B*C*2^K*4 bytes.  The function
// needs about 5*B*C*2^K int32 adds besides: the four cost sums and the key
// sum change by one slot's weight from a state to its Gray-order neighbour.
// At the slice's K = 15 (B = 256, C = 512) that is 17.2 GB written (5.1 ms at
// 3.35 TB/s) against 21.5 G adds (1.3 ms at 64 int32 lanes per SM), so the
// bytes bound it.  The carry mode writes only the final state, so the same
// adds bound it (a 2048-column segment at K = 15: 0.34 G adds, 0.02 ms).
//
// Design, the general-T kernel's (wmec_forward_t.cu; the shared pieces are in
// wmec_cluster.cuh).  One thread-block cluster of N = 2^cbits CTAs per block
// (cluster.cuh), each CTA of up to 512 threads: 16 CTAs from K = 13, fewer
// below so that each CTA keeps 2^9 states, in a launch of up to 8 blocks;
// clusters of 4 CTAs (8 at K = 16) in a wider one, so that more blocks run at
// once and a column's fixed work is spread over 4x the states a thread.  A
// state index is, from its low bits up: lane | warp | CTA rank | loop bits (LR
// = K - cbits - 9 when positive, up to 4), so a warp writes each table row in
// 128 contiguous bytes.  The layout is a fixed function of (K, B)
// (wmec_cuda.forward_t1_layout mirrors it, shared bytes included).  The state
// stays on chip at every K <= 17: a thread keeps its states' cost and key in
// registers from column to column, and a fold over a warp or CTA bit exchanges
// them through the CTA's shared memory (cost, key and the fold's index, 12
// bytes a state, in the tables mode; the cost alone, 4 bytes, in the carry
// mode).  A fold goes by the level of its bit: shuffles (lane), the CTA's
// shared memory between two barriers (warp), the partner CTA's shared memory
// after a cluster barrier (CTA rank), inside the thread (loop bits).  Cluster
// barriers are paid only in columns where a CTA-bit slot dies, and a CTA-bit
// fold's closing barrier is split: arrived at after the partner's planes are
// read, waited on only before the planes are written again.  The sums are O(1)
// a state: per column each CTA tabulates s0, d_0, d_1 and the rank sum over
// the lane bits (lo, base costs included) and over the warp, rank and loop
// bits (hi), so a state's are lo + hi, and the assignment minimum is min(s0 +
// min_a x_a, INF).  A column builds the next column's sums while it folds and
// loads the inputs of the column after that, so it needs one CTA barrier; the
// mask of dying slots is one warp vote.  Where its states fit (min_ctas), a
// thread is held to 64 registers, so that two CTAs share an SM.

#include "wmec_cluster.cuh"

namespace {

using namespace wmec;
using clusters::cluster_sync;
using clusters::kThreadBits;

constexpr int kMaxK = 17;
constexpr int kMaxLR = 4;  // loop bits at K = 17: 17 - 4 CTA bits - 9 thread bits
using Rc = Rec<1, 2>;

constexpr int kWideB = 8;  // blocks a launch takes in narrow clusters at most

// The CTA bits of a block's cluster.  A launch of up to kWideB blocks, about
// as many clusters of 16 CTAs as the card holds at once at K = 15, takes the
// narrow layout: 16 CTAs from K = 13, fewer below so that each CTA keeps 2^9
// states.  A wider launch takes clusters of 4 CTAs, and of as few more as the
// loop bits allow above K = 15: up to 16 states a thread, fewer CTA-bit folds
// and cluster barriers, more clusters at once.
int cta_bits(int K, int B) {
  const int narrow = clusters::cluster_bits(K);
  if (B <= kWideB) return narrow;
  const int wide = K - kThreadBits - kMaxLR > 2 ? K - kThreadBits - kMaxLR : 2;
  return narrow < wide ? narrow : wide;
}

// The column's sums table, one int4 row per lane value l (32 lo rows) and
// per hi row h (2^hbits hi rows): over the bits k of the row (those of l
// among the lane bits; hi_bits(q, h)), {sum f_0 + f_2, sum f_1 - f_0,
// sum f_3 - f_2, sum rankw}, f_j = wdiff[k, j]; a lo row also holds the base
// costs and two assignment costs (wb_0 + wb_2, wb_1 - wb_0 + acost_1,
// wb_3 - wb_2 + acost_2), so a state's s0, d_0 + acost_1, d_1 + acost_2 and
// rank sum are its lo row plus its hi row.
__device__ __forceinline__ void build_sums(const int* rec, int4* tab, int hbits, const Place& q) {
  const int4* wd = reinterpret_cast<const int4*>(rec);
  const int* wb = rec + Rc::wb(q.K);
  const int* ac = rec + Rc::ac(q.K);
  const int* rw = rec + Rc::rw(q.K);
  const uint32_t lane_mask = (1u << q.lb) - 1;
  for (int e = q.tid; e < 32 + (1 << hbits); e += blockDim.x) {
    const bool lo = e < 32;
    uint32_t bits = lo ? (uint32_t)e & lane_mask : hi_bits(q, e - 32);
    int4 v = make_int4(0, 0, 0, 0);
    if (lo) v = make_int4(wb[0] + wb[2], wb[1] - wb[0] + ac[1], wb[3] - wb[2] + ac[2], 0);
    for (; bits != 0; bits &= bits - 1) {
      const int k = __ffs(bits) - 1;
      const int4 w = wd[k];
      v.x += w.x + w.z;
      v.y += w.y - w.x;
      v.z += w.w - w.z;
      v.w += rw[k];
    }
    tab[e] = v;
  }
}

// A column's dying slots (one warp vote: uniform over the cluster, so every
// thread takes the same branches), acost_0 and acost_3 - acost_1 - acost_2.
__device__ __forceinline__ void column_flags(const int* rec, int K, const Place& q, uint32_t& mask, int2& ac) {
  const int* a = rec + Rc::ac(K);
  mask = __ballot_sync(0xffffffffu, q.lane < K && rec[Rc::die(K) + q.lane] != 0);
  ac = make_int2(a[0], a[3] - a[1] - a[2]);
}

// CTAs an SM is to hold: two (64 registers a thread) where a thread's states
// fit them without spilling, up to two loop bits with tables and one in the
// carry mode.
template <int LR, int kMode>
constexpr int min_ctas() {
  return LR <= (kMode == kTables ? 2 : 1) ? 2 : 1;
}

template <int LR, int kMode>
__global__ void __launch_bounds__(1 << kThreadBits, min_ctas<LR, kMode>()) forward_t1_kernel(Args a) {
  constexpr bool kTab = kMode == kTables;
  constexpr int R = 1 << LR;

  extern __shared__ int4 smem4[];
  const int K = a.K, C = a.C;
  const Place q = place<LR>(K, a.cbits);
  cg::cluster_group cluster = cg::this_cluster();
  const size_t S = (size_t)1 << K;
  const int Sl = 1 << (K - q.cbits);  // states of a CTA
  const int b = blockIdx.x >> q.cbits;
  const int W = Rc::words(K), Wp = round4(W);
  const int hbits = q.wb + LR;
  const int ctab = q.tb + q.cbits;  // the lowest loop bit

  int* cost = reinterpret_cast<int*>(smem4);  // [Sl]     fold exchange: cost
  int* key = cost + Sl;                       // [Sl]     tables mode: key
  int* idx = key + Sl;                        // [Sl]     tables mode: index
  int* rec0 = cost + round4((kTab ? 3 : 1) * Sl);  // [2][Wp] column records
  int4* tab0 = reinterpret_cast<int4*>(rec0 + 2 * Wp);  // [2][32 + 2^hbits] sums
  const int ntab = 32 + (1 << hbits);

  // the thread's states, in registers across the columns: cost, tie key
  int cv[R], kv[R];
  const size_t col0 = (size_t)b * C;
  Stage<1, 2> st;
  st.issue(a, col0, K, W);
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const size_t at = (size_t)b * S + gidx(q, m);
    cv[m] = q.active && a.cost0 != nullptr ? a.cost0[at] : 0;
    kv[m] = kTab && q.active && a.key0 != nullptr ? a.key0[at] : 0;
  }
  st.commit(rec0, a, col0, K, W);
  if (C > 1) {
    st.issue(a, col0 + 1, K, W);
    st.commit(rec0 + Wp, a, col0 + 1, K, W);
  }
  __syncthreads();
  // column c reads the sums, dying slots and assignment costs that column
  // c - 1 (here the prologue) took from its record, and the record of column
  // c + 2 goes where column c's was: one barrier a column
  uint32_t mask;
  int2 ac;
  build_sums(rec0, tab0, hbits, q);
  column_flags(rec0, K, q, mask, ac);
  __syncthreads();

  // a CTA-bit fold's closing cluster barrier is arrived at and waited on
  // only before the exchange planes are written again, so the partner's
  // reads overlap the work in between
  bool pending = false;
  for (int c = 0; c < C; ++c) {
    const size_t col = col0 + c;
    const bool last = c == C - 1;
    const int4* tab = tab0 + (c & 1) * ntab;
    if (c + 2 < C) st.issue(a, col + 2, K, W);
    uint32_t mask_n = 0;
    int2 ac_n = make_int2(0, 0);
    if (!last) {
      const int* rec_n = rec0 + ((c + 1) & 1) * Wp;
      build_sums(rec_n, tab0 + ((c + 1) & 1) * ntab, hbits, q);
      column_flags(rec_n, K, q, mask_n, ac_n);
    }

    // ---- fold
    int iv[R];
#pragma unroll
    for (int m = 0; m < R; ++m) iv[m] = (int)gidx(q, m);
    if (mask) {
      for (int p = 0; p < q.lb; ++p) {
        if (!((mask >> p) & 1)) continue;
        const bool low = !((q.lane >> p) & 1);
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const int pc = __shfl_xor_sync(0xffffffffu, cv[m], 1 << p);
          if (kTab) {
            const int pk = __shfl_xor_sync(0xffffffffu, kv[m], 1 << p);
            const int pi = __shfl_xor_sync(0xffffffffu, iv[m], 1 << p);
            merge(cv[m], kv[m], iv[m], pc, pk, pi, low);
          } else {
            cv[m] = min(cv[m], pc);
          }
        }
      }
      for (int p = q.lb; p < ctab; ++p) {
        if (!((mask >> p) & 1)) continue;
        const bool cta_bit = p >= q.tb;
        if (pending) {
          clusters::cluster_wait();
          pending = false;
        }
        if (q.active) {
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const int s = slot(q, m);
            cost[s] = cv[m];
            if (kTab) {
              key[s] = kv[m];
              idx[s] = iv[m];
            }
          }
        }
        if (cta_bit) {
          cluster_sync();
        } else {
          __syncthreads();
        }
        const unsigned pr = cta_bit ? q.rank ^ (1u << (p - q.tb)) : q.rank;
        const int* rc = cta_bit ? cluster.map_shared_rank(cost, pr) : cost;
        const int* rk = cta_bit ? cluster.map_shared_rank(key, pr) : key;
        const int* ri = cta_bit ? cluster.map_shared_rank(idx, pr) : idx;
        const bool low = cta_bit ? !((q.rank >> (p - q.tb)) & 1) : !((q.tid >> p) & 1);
        if (q.active) {
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const int ps = cta_bit ? slot(q, m) : slot(q, m) ^ (1 << p);
            if (kTab) {
              merge(cv[m], kv[m], iv[m], rc[ps], rk[ps], ri[ps], low);
            } else {
              cv[m] = min(cv[m], rc[ps]);
            }
          }
        }
        if (cta_bit) {
          clusters::cluster_arrive();
          pending = true;
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
          if (kTab) {
            merge(cv[m], kv[m], iv[m], cv[m1], kv[m1], iv[m1], true);
            kv[m1] = kv[m];
            iv[m1] = iv[m];
          } else {
            cv[m] = min(cv[m], cv[m1]);
          }
          cv[m1] = cv[m];
        }
      }
    }

    // ---- emit, then cost and key; each thread on its own states.  With
    // x_a = sum_{p in a} d_p + acost_a, min_a min(s0 + x_a, INF) =
    // min(s0 + min_a x_a, INF), and x_3 = x_1 + x_2 + acost_3 - acost_1 -
    // acost_2 (int32 sums: exact wherever the reference's are)
    if (q.active) {
      const int4 lo = tab[q.lane];
      int* prow = kTab ? a.pidx + col * S + gidx(q, 0) : nullptr;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (kTab) prow[(size_t)m << ctab] = iv[m];
        const int4 hi = tab[32 + hrow(q, m)];
        const int x1 = lo.y + hi.y, x2 = lo.z + hi.z;
        const int x = min(min(ac.x, x1), min(x2, x1 + x2 + ac.y));
        cv[m] = min(min(lo.x + hi.x + x, kInf) + cv[m], kInf);
        if (kTab || last) {
          int r = lo.w + hi.w;  // inverse Gray code of the rank sum
#pragma unroll
          for (int sh = 1; sh < 32; sh <<= 1) {
            if (sh < K) r ^= r >> sh;
          }
          kv[m] = r;
        }
        if (last) {
          const size_t at = (size_t)b * S + gidx(q, m);
          a.dp_last[at] = cv[m];
          a.key_last[at] = kv[m];
        }
      }
    }
    if (c + 2 < C) st.commit(rec0 + (c & 1) * Wp, a, col + 2, K, W);
    __syncthreads();
    mask = mask_n;
    ac = ac_n;
  }
  if (pending) clusters::cluster_wait();  // no CTA leaves while its planes are read
}

// The layout of a block's state, a fixed function of (K, B) that
// forward_t1_layout in whatshap_torch/ops/wmec_cuda.py computes the same way:
// cta_bits(K, B) CTA bits, layout_lr the loop bits, smem_bytes a CTA's shared
// memory (the fold's exchange planes, two staged column records, two
// columns' sums tables).
int layout_lr(int K, int B) {
  const int kl = K - cta_bits(K, B);
  return kl > kThreadBits ? kl - kThreadBits : 0;
}

size_t smem_bytes(int K, int B, bool tables) {
  const int kl = K - cta_bits(K, B);
  const int tb = kl < kThreadBits ? kl : kThreadBits;
  const int lb = tb < 5 ? tb : 5;
  const int hbits = tb - lb + layout_lr(K, B);
  const size_t state = (size_t)round4((tables ? 3 : 1) << kl);
  const size_t rec = 2 * (size_t)round4(Rc::words(K));
  const size_t sums = 2 * 4 * (32 + ((size_t)1 << hbits));
  return (state + rec + sums) * sizeof(int);
}

template <int LR, int kMode>
int by_lr(const Args& a, int B, int lr, cudaStream_t stream) {
  if (lr == LR) {
    return clusters::launch_clusters(forward_t1_kernel<LR, kMode>, a, B, a.K, a.cbits, LR,
                                     smem_bytes(a.K, B, kMode == kTables), stream);
  }
  if constexpr (LR > 0) {
    return by_lr<LR - 1, kMode>(a, B, lr, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

template <int kMode>
int dispatch(const Args& a, int B, cudaStream_t stream) {
  if (B < 1 || a.C < 1 || a.K < 1 || a.K > kMaxK) return (int)cudaErrorInvalidValue;
  return by_lr<kMaxLR, kMode>(a, B, layout_lr(a.K, B), stream);
}

}  // namespace

// Tables mode.  cost0 and key0 (B, 2^K) carry a state in, or are null for a
// zero state.
extern "C" int wmec_forward_t1(const float* wdiff, const int* wbase, const float* rankw,
                               const int* acost, const uint8_t* die, const int* cost0,
                               const int* key0, int* pidx, int* dp_last, int* key_last, int B,
                               int C, int K, cudaStream_t stream) {
  Args a{wdiff, wbase, rankw, acost, die, nullptr, nullptr, cost0, nullptr, key0, pidx, nullptr,
         dp_last, nullptr, key_last, nullptr, C, K, cta_bits(K, B)};
  return dispatch<kTables>(a, B, stream);
}

// Carry mode: no table; dp_last and key_last are the carry after the last
// column, and must not alias cost0 and key0 (a checkpoint is read again).
// Only the carried cost0 is read: key0 breaks fold ties, which the min fold
// does not need (it stays in the signature, which is the tables mode's).
extern "C" int wmec_forward_carry_t1(const float* wdiff, const int* wbase, const float* rankw,
                                     const int* acost, const uint8_t* die, const int* cost0,
                                     const int* key0, int* dp_last, int* key_last, int B, int C,
                                     int K, cudaStream_t stream) {
  (void)key0;
  Args a{wdiff, wbase, rankw, acost, die, nullptr, nullptr, cost0, nullptr, nullptr, nullptr,
         nullptr, dp_last, nullptr, key_last, nullptr, C, K, cta_bits(K, B)};
  return dispatch<kCarry>(a, B, stream);
}

extern "C" const char* wmec_forward_t1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
