// General-T (pedigree) wMEC forward column scan for Hopper (sm_90a) with the
// block's T planes in device memory, for pedigree shapes past the
// thread-block cluster kernel's envelope (wmec_forward_t.cu: T = 4 with K <=
// 16, T = 16 with K <= 13, P <= 4).
//
// Replaces the reference's XLA scan at T > 1 where its Pallas kernel refuses
// the shape: whatshap_tpu/ops/wmec.py `_forward_scan_impl` (with `_fold_dying`
// and the transmission min-plus), as `solve_batched` and `_solve_scan` run it
// with tables, as the pedigree route's two passes run it (`forward_m_batched`,
// m-only and seeded; `solve_seeded_batched`, seeded with tables) and as the
// segmented `solve_scan_segmented` runs it (`_forward_carry_scan`, no tables;
// `_forward_tables_scan`, tables from a carry).  The modes of
// wmec_forward_t.cu, at T = 4, 16, 64 or 256, P = 2, 4, 6 or 8 and any
// 1 <= K <= 23:
//
//   tables   pidx and pjmin of every column and the final dp, jmin and key,
//            from zero, a seed (B, T) or a carry (cost0, jmin0, key0):
//            entry point wmec_forward_t_wide;
//   carry    from a carry, the final state only, no tables:
//            wmec_forward_carry_t_wide;
//   m-only   seeded, m[b, t] = min_i dp[t][i] of the last column only:
//            wmec_forward_m_t_wide.
//
// What it computes is wmec_forward_t.cu's function (its header states it):
// per column, fold every slot that died before it, in ascending slot order and
// in each plane t on its own under the tie key shared by the planes (the
// partner winning only when strictly better, both partners receiving the
// winner's cost, key, source index and jmin); emit pidx = the source index and
// pjmin = the folded jmin; the transmission min-plus trans[ti] = min_tj
// min(cost[tj] + popcount(ti ^ tj) * rc', INF), rc' = min(rc, INF / log2 T),
// keeping the first strict minimum over tj as the new jmin; add the column
// cost of each plane; the new key is the inverse Gray code of the rank sum.
// Without tables the fold is a min of the costs.  All int32, as the
// reference's (its f32 sums of integer weights are exact).
//
// Bound: with tables, the two table writes, 8*B*C*T*2^K bytes (1 GiB a block
// at T = 64, K = 15 and 64 columns); the carry and m-only modes write nearly
// nothing and are bound by their operations, per state and plane a fold
// compare, log2 T lexicographic compares of the min-plus and the column cost,
// 2P + 1 sums and 2^P assignments.
//
// Design: simple and right, row 13's (wmec_forward_t1_wide.cu) taken to T
// planes.  The state lives in device memory: the cost planes (B, T, 2^K) are
// the dp_last output (scratch in the m-only mode), updated in place, and the
// jmin planes the jmin_last output.  The tie key is not stored: before column
// c's fold it is the inverse Gray code of the rank sum over column c - 1's
// slots at the state index (the carried key0 at column 0), and a fold moves it
// with the winner's source index, so a folded entry's key is that function at
// its index, in every plane.  Likewise the folded jmin is the jmin plane at
// the source index, gathered once on the fold's last pass.  One cooperative
// launch holds as many CTAs as the card keeps resident; grid-wide barriers
// separate the passes.  A column is its fold passes, then one min-plus pass:
//
//   fold     max over the launch's blocks of ceil(|D| / 4) passes (none where
//            no slot dies): a pass folds up to 4 dying slots of one plane, a
//            thread holding the 2^g states of each of its cosets of those g
//            slots in registers, so both partners of a pair come from the
//            same generation; tiles of 4096 states of one plane.  A block's
//            passes end with the column's last one.  Between passes the
//            source index rides in the pidx row.
//   min-plus a tile is 4096 / T consecutive states of one block in all T
//            planes, in shared memory.  The min-plus is the per-bit distance
//            transform: log2 T passes of x[t] = lexmin(x[t], x[t ^ bit] +
//            (rc', 0)) over (cost, source t) pairs, T log2 T compares instead
//            of T^2, with the same minimum and the same smallest argmin; where
//            the minimum reaches INF every candidate saturates, the
//            reference's argmin is 0, and so is jmin here.  Then the column
//            cost of each plane: its sums from a table of the tile's common
//            high state bits (one row a plane) and one of the low bits (one
//            row a low bit and plane), the assignments in Gray order.  A
//            block where no slot died writes its identity tables here.
//
// Every index into the state and the tables is 64-bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxK = 23;
constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;
constexpr int kPer = 16;                // states a thread takes in a fold tile
constexpr int kTile = kThreads * kPer;  // states of a fold tile, and T x states of a min-plus tile
constexpr int kGroup = 4;               // dying slots a fold pass takes at most (2^4 = kPer)
constexpr int kChunk = 8;               // state index bits a rank table covers
constexpr int kRows = 1 << kChunk;

enum Mode { kTables = 0, kCarry = 1, kMinOnly = 2 };

struct Args {
  const float* wdiff;    // (B, C, K, T*P*2)
  const int* wbase;      // (B, C, T, P, 2)
  const float* rankw;    // (B, C, K)
  const int* acost;      // (B, C, T, 2^P)
  const uint8_t* die;    // (B, C, K)
  const int* rc;         // (B, C)
  const int* seed;       // (B, T) or null
  const int* cost0;      // (B, T, S) or null: carried cost
  const int* jmin0;      // (B, T, S) or null: carried jmin (tables mode)
  const int* key0;       // (B, S) or null: carried tie key (tables mode)
  int* pidx;             // (B, C, T, S)  tables mode
  int* pjmin;            // (B, C, T, S)  tables mode
  int* cost;             // (B, T, S)     the cost planes: dp_last, or scratch (m-only)
  int* jmin;             // (B, T, S)     jmin_last (every column with tables, the last one in the carry mode)
  int* key_last;         // (B, S)        tables and carry modes
  int* m;                // (B, T)        m-only mode
  int* masks;            // (B, C)        scratch: the dying slots of each column
  int* npass;            // (C,)          scratch: the fold passes of each column
  int B, C, K, T, lt;    // lt = log2 T
};

// The min-plus tile's states and the dynamic shared memory's layout (the same
// on the host and the device).
__host__ __device__ inline int tile_states(int K, int lt) {
  const int ns = kTile >> lt;
  return K < 30 && (1 << K) < ns ? 1 << K : ns;
}

__host__ __device__ inline int log2_of(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

struct Layout {
  int ns, lb;            // states a min-plus tile, and their bits
  int rank, xc, lw, hs, rw, red, xs;  // word offsets; xs a byte array
  size_t bytes;
};

__host__ __device__ inline Layout layout(int K, int T, int lt, int P) {
  Layout l;
  l.ns = tile_states(K, lt);
  l.lb = log2_of(l.ns);
  const int row = P + 1;
  l.rank = 0;                          // [3][kRows] rank sums of column c - 1 (fold keys)
  l.xc = l.rank + 3 * kRows;           // [T][ns] min-plus costs
  l.lw = l.xc + kTile;                 // [lb][T][P + 1] low-bit sums (s0, d_0 .. d_{P-1})
  l.hs = l.lw + l.lb * T * row;        // [T][P + 1] the tile's high-bit sums, wbase included
  l.rw = l.hs + T * row;               // [32] rank weights of the column (keys)
  l.red = l.rw + 32;                   // [T] m-only reduction
  l.xs = l.red + T;                    // bytes: [T][ns] min-plus sources
  l.bytes = (size_t)l.xs * sizeof(int) + kTile;
  return l;
}

__device__ __forceinline__ int inverse_gray(int r, int K) {
#pragma unroll
  for (int sh = 1; sh < 32; sh <<= 1) {
    if (sh < K) r ^= r >> sh;
  }
  return r;
}

__device__ __forceinline__ size_t col_of(const Args& a, int b, int c) { return (size_t)b * a.C + c; }

// The tie-key tables of the fold at column c > 0 of block b: rank sums of
// column c - 1 over each 8 bits of the state index.  Every thread of the CTA
// calls it (two barriers).
__device__ void build_rank(const Args& a, int* rank, int b, int c) {
  const int K = a.K;
  __syncthreads();  // the tables of the previous block are no longer read
  const float* rw = a.rankw + (col_of(a, b, c) - 1) * K;
  const uint32_t all = (1u << K) - 1;
  for (int e = threadIdx.x; e < 3 * kRows; e += kThreads) {
    const int j = e / kRows, v = e % kRows;
    int r = 0;
    for (uint32_t bits = ((uint32_t)v << (kChunk * j)) & all; bits != 0; bits &= bits - 1) {
      r += (int)__ldg(rw + __ffs(bits) - 1);
    }
    rank[e] = r;
  }
  __syncthreads();
}

// One fold tile: the cosets of the pass's g = G slots pos[0] < ... < pos[G-1]
// in 4096 states of plane t of block b; a thread takes kPer >> G cosets of 2^G
// states (loaded before any is folded), folds them in registers and writes
// them back, and in the tables mode the source index into the pidx row; on the
// block's last fold pass of the column (`last`) also the pjmin row, the jmin
// plane at the source index.  `first`: the block's first fold pass of the
// column (the index is the identity; at column 0 the state is the seed, the
// carry or zero).
template <int G, int kMode>
__device__ void fold_tile(const Args& a, const int* rank, int b, int t, int c, size_t tile, const int* pos_in,
                          bool first, bool last) {
  constexpr bool kTab = kMode == kTables;
  constexpr int M = 1 << G;
  constexpr int NC = kPer >> G;
  const int K = a.K;
  const size_t S = (size_t)1 << K;
  const size_t n_cos = S >> G;
  const size_t u0 = tile * (size_t)(kTile >> G);
  const size_t plane_at = ((size_t)b * a.T + t) * S;
  int* plane = a.cost + plane_at;
  const size_t row_at = (col_of(a, b, c) * a.T + t) * S;
  int* row = kTab ? a.pidx + row_at : nullptr;
  const bool from_src = c == 0 && first;

  int pos[G];
  uint32_t off[M];
#pragma unroll
  for (int j = 0; j < G; ++j) pos[j] = pos_in[j];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    uint32_t o = 0;
#pragma unroll
    for (int j = 0; j < G; ++j) o |= (uint32_t)((m >> j) & 1) << pos[j];
    off[m] = o;
  }
  uint32_t st[kPer];
  bool ok[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const size_t u = u0 + threadIdx.x + (size_t)i * kThreads;
    ok[i] = u < n_cos;
    // the coset's lowest state: u with a zero bit inserted at each slot
    uint32_t base = (uint32_t)u;
#pragma unroll
    for (int j = 0; j < G; ++j) base = ((base >> pos[j]) << (pos[j] + 1)) | (base & ((1u << pos[j]) - 1));
#pragma unroll
    for (int m = 0; m < M; ++m) st[i * M + m] = base | off[m];
  }
  int cv[kPer], kv[kPer], iv[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    cv[e] = kv[e] = iv[e] = 0;
    if (!ok[e / M]) continue;
    const uint32_t s = st[e];
    if (from_src) {
      cv[e] = a.cost0 != nullptr ? __ldg(a.cost0 + plane_at + s)
              : a.seed != nullptr ? __ldg(a.seed + (size_t)b * a.T + t) : 0;
    } else {
      cv[e] = __ldcg(plane + s);
    }
    if (kTab) {
      iv[e] = first ? (int)s : __ldcg(row + s);
      const uint32_t src = (uint32_t)iv[e];
      if (c > 0) {
        kv[e] = inverse_gray(rank[src & (kRows - 1)] + rank[kRows + ((src >> kChunk) & (kRows - 1))] +
                                 rank[2 * kRows + (src >> (2 * kChunk))],
                             K);
      } else if (a.key0 != nullptr) {
        kv[e] = __ldg(a.key0 + (size_t)b * S + src);
      }
    }
  }
  // slot by slot in ascending order: (m, m | 2^j) is the pair (s, s |
  // 2^pos[j]); the partner wins only when strictly better
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if ((m >> j) & 1) continue;
        const int e = i * M + m, e1 = e | (1 << j);
        if (kTab) {
          const bool partner = cv[e1] < cv[e] || (cv[e1] == cv[e] && kv[e1] < kv[e]);
          if (partner) {
            cv[e] = cv[e1];
            kv[e] = kv[e1];
            iv[e] = iv[e1];
          } else {
            cv[e1] = cv[e];
            kv[e1] = kv[e];
            iv[e1] = iv[e];
          }
        } else {
          cv[e] = cv[e1] = min(cv[e], cv[e1]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (!ok[e / M]) continue;
    const uint32_t s = st[e];
    plane[s] = cv[e];
    if (!kTab) continue;
    if (!last) {
      row[s] = iv[e];
      continue;
    }
    __stcs(row + s, iv[e]);
    const size_t src = plane_at + (uint32_t)iv[e];
    const int jv = c > 0 ? __ldcg(a.jmin + src) : a.jmin0 != nullptr ? __ldg(a.jmin0 + src) : 0;
    __stcs(a.pjmin + row_at + s, jv);
  }
}

template <int kMode>
__device__ __forceinline__ void dispatch_fold(int g, const Args& a, const int* rank, int b, int t, int c,
                                              size_t tile, const int* pos, bool first, bool last) {
  switch (g) {
    case 1: fold_tile<1, kMode>(a, rank, b, t, c, tile, pos, first, last); break;
    case 2: fold_tile<2, kMode>(a, rank, b, t, c, tile, pos, first, last); break;
    case 3: fold_tile<3, kMode>(a, rank, b, t, c, tile, pos, first, last); break;
    default: fold_tile<4, kMode>(a, rank, b, t, c, tile, pos, first, last); break;
  }
}

// The low-bit sums of column c of block b: lw[k][t] = (sum_p w[k,t,p,0],
// w[k,t,p,1] - w[k,t,p,0] for each p) for the tile's low bits k < lb, and
// the column's rank weights (for the keys after the last column).  Every
// thread of the CTA calls it (two barriers).
template <int P>
__device__ void build_low(const Args& a, const Layout& l, int* sm, int b, int c) {
  const int T = a.T, K = a.K, tp2 = T * P * 2;
  __syncthreads();  // the tables of the previous block are no longer read
  const size_t col = col_of(a, b, c);
  const float* wd = a.wdiff + col * K * tp2;
  int* lw = sm + l.lw;
  const int n = l.lb * T * (P + 1);
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int j = e % (P + 1), kt = e / (P + 1), t = kt % T, k = kt / T;
    const float* w = wd + (size_t)k * tp2 + t * 2 * P;
    int v = 0;
    if (j == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) v += (int)__ldg(w + 2 * p);
    } else {
      v = (int)__ldg(w + 2 * (j - 1) + 1) - (int)__ldg(w + 2 * (j - 1));
    }
    lw[e] = v;
  }
  if (a.rankw != nullptr) {  // the m-only mode keeps no key
    for (int k = threadIdx.x; k < K; k += kThreads) sm[l.rw + k] = (int)__ldg(a.rankw + col * K + k);
  }
  __syncthreads();
}

// One min-plus tile: the ns states from s0 of block b in all T planes.
template <int P, int kMode>
__device__ void minplus_tile(const Args& a, const Layout& l, int* sm, int b, int c, size_t s0, bool folded,
                             int rc, bool last_col) {
  constexpr bool kTab = kMode == kTables;
  const int T = a.T, K = a.K, lb = l.lb, ns = l.ns, n = T * ns;
  const size_t S = (size_t)1 << K;
  const size_t col = col_of(a, b, c);
  const size_t state_at = (size_t)b * T * S;
  int* xc = sm + l.xc;
  uint8_t* xs = reinterpret_cast<uint8_t*>(sm + l.xs);
  int* hs = sm + l.hs;
  const int* lw = sm + l.lw;
  int* red = sm + l.red;
  const bool from_src = c == 0 && !folded;

  __syncthreads();  // the previous tile's shared memory is no longer read
  // the high-bit sums of the tile, wbase included: one row a plane
  {
    const int tp2 = T * P * 2;
    const float* wd = a.wdiff + col * K * tp2;
    const int* wb = a.wbase + col * T * P * 2;
    const uint32_t hi = (uint32_t)(s0 >> lb) << lb;
    for (int e = threadIdx.x; e < T * (P + 1); e += kThreads) {
      const int j = e % (P + 1), t = e / (P + 1);
      int v = 0;
      if (j == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p) v += __ldg(wb + t * 2 * P + 2 * p);
      } else {
        v = __ldg(wb + t * 2 * P + 2 * (j - 1) + 1) - __ldg(wb + t * 2 * P + 2 * (j - 1));
      }
      for (uint32_t bits = hi; bits != 0; bits &= bits - 1) {
        const float* w = wd + (size_t)(__ffs(bits) - 1) * tp2 + t * 2 * P;
        if (j == 0) {
#pragma unroll
          for (int p = 0; p < P; ++p) v += (int)__ldg(w + 2 * p);
        } else {
          v += (int)__ldg(w + 2 * (j - 1) + 1) - (int)__ldg(w + 2 * (j - 1));
        }
      }
      hs[e] = v;
    }
    if (kMode == kMinOnly && last_col) {
      for (int t = threadIdx.x; t < T; t += kThreads) red[t] = kInf;
    }
  }
  // the projected costs (the fold's output, or at column 0 the state the scan
  // starts from) and their sources; a block where no slot died writes its
  // identity tables
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int t = e >> lb;
    const size_t s = s0 + (e & (ns - 1));
    const size_t at = state_at + (size_t)t * S + s;
    int v;
    if (from_src) {
      v = a.cost0 != nullptr ? __ldg(a.cost0 + at) : a.seed != nullptr ? __ldg(a.seed + (size_t)b * T + t) : 0;
    } else {
      v = __ldcg(a.cost + at);
    }
    xc[e] = v;
    xs[e] = (uint8_t)t;
    if (kTab && !folded) {
      const size_t tab = (col * T + t) * S + s;
      __stcs(a.pidx + tab, (int)s);
      __stcs(a.pjmin + tab, c > 0 ? __ldcg(a.jmin + at) : a.jmin0 != nullptr ? __ldg(a.jmin0 + at) : 0);
    }
  }
  // the distance transform over the bits of t: lexicographic (cost, source)
  // minima; the two sources of a pair come from disjoint sets, so never tie
  for (int j = 0; j < a.lt; ++j) {
    __syncthreads();
    for (int q = threadIdx.x; q < n / 2; q += kThreads) {
      const int tq = q >> lb;
      const int tlo = ((tq >> j) << (j + 1)) | (tq & ((1 << j) - 1));
      const int e0 = (tlo << lb) | (q & (ns - 1)), e1 = e0 | (1 << (j + lb));
      const int c0 = xc[e0], c1 = xc[e1];
      if (kMode == kMinOnly) {
        xc[e0] = min(c0, c1 + rc);
        xc[e1] = min(c1, c0 + rc);
      } else {
        const int s0_ = xs[e0], s1_ = xs[e1];
        const int n0 = c1 + rc, n1 = c0 + rc;
        if (n0 < c0 || (n0 == c0 && s1_ < s0_)) {
          xc[e0] = n0;
          xs[e0] = (uint8_t)s1_;
        }
        if (n1 < c1 || (n1 == c1 && s0_ < s1_)) {
          xc[e1] = n1;
          xs[e1] = (uint8_t)s0_;
        }
      }
    }
  }
  __syncthreads();
  // the column cost of each plane, and the new state
  const int* ac0 = a.acost + (col * T << P);
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int t = e >> lb, sl = e & (ns - 1);
    const size_t s = s0 + sl;
    const size_t at = state_at + (size_t)t * S + s;
    const int* h = hs + t * (P + 1);
    int s0v = h[0];
    int d[P];
#pragma unroll
    for (int p = 0; p < P; ++p) d[p] = h[1 + p];
    for (uint32_t bits = (uint32_t)sl; bits != 0; bits &= bits - 1) {
      const int* w = lw + ((__ffs(bits) - 1) * T + t) * (P + 1);
      s0v += w[0];
#pragma unroll
      for (int p = 0; p < P; ++p) d[p] += w[1 + p];
    }
    // assignment x: bit p of x puts allele 1 on partition p; the x in Gray
    // order, so each partial sum pa takes one add, and min_x min(s0 + pa +
    // acost, INF) = min(s0 + min_x (pa + acost), INF)
    const int* ac = ac0 + ((size_t)t << P);
    int pa = 0, best = __ldg(ac);
#pragma unroll
    for (int g = 1; g < (1 << P); ++g) {
      const int p = __ffs(g) - 1, xa = g ^ (g >> 1);
      pa += ((xa >> p) & 1) ? d[p] : -d[p];
      best = min(best, pa + __ldg(ac + xa));
    }
    const int x = xc[e];
    const int nc = min(min(s0v + best, kInf) + min(x, kInf), kInf);
    if (kMode == kMinOnly) {
      if (last_col) {
        atomicMin(red + t, nc);
      } else {
        a.cost[at] = nc;
      }
    } else {
      a.cost[at] = nc;
      if (kTab || last_col) a.jmin[at] = x >= kInf ? 0 : (int)xs[e];
    }
  }
  if (last_col && kMode != kMinOnly) {
    for (int sl = threadIdx.x; sl < ns; sl += kThreads) {
      int r = 0;
      for (uint32_t bits = (uint32_t)(s0 + sl); bits != 0; bits &= bits - 1) r += sm[l.rw + __ffs(bits) - 1];
      a.key_last[(size_t)b * S + s0 + sl] = inverse_gray(r, K);
    }
  }
  if (kMode == kMinOnly && last_col) {
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += kThreads) atomicMin(a.m + (size_t)b * T + t, red[t]);
  }
}

// Two CTAs an SM: a thread is held to 128 registers (a fold tile's 16 states
// with their keys and indices, as in row 13).
template <int P, int kMode>
__global__ void __launch_bounds__(kThreads, 2) forward_t_wide_kernel(Args a) {
  extern __shared__ int4 smem4[];
  int* sm = reinterpret_cast<int*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, C = a.C, K = a.K, T = a.T;
  const size_t S = (size_t)1 << K;
  const Layout l = layout(K, T, a.lt, P);

  // prologue: a warp a column gathers every block's dying slots there and
  // the column's fold passes, the most any block needs; m starts at INF
  const int lane = threadIdx.x & 31;
  const size_t warps = (size_t)gridDim.x * (kThreads / 32);
  for (size_t w = grid.thread_rank() / 32; w < (size_t)C; w += warps) {
    int np = 0;
    for (int b = lane; b < B; b += 32) {
      const uint8_t* d = a.die + ((size_t)b * C + w) * K;
      int m = 0;
      for (int k = 0; k < K; ++k) m |= d[k] ? 1 << k : 0;
      a.masks[(size_t)b * C + w] = m;
      np = max(np, (__popc(m) + kGroup - 1) / kGroup);
    }
    np = __reduce_max_sync(0xffffffffu, np);
    if (lane == 0) a.npass[w] = np;
  }
  if (kMode == kMinOnly) {
    for (size_t i = grid.thread_rank(); i < (size_t)B * T; i += (size_t)gridDim.x * kThreads) a.m[i] = kInf;
  }
  grid.sync();

  // fold tiles: (block, plane, 4096 states); min-plus tiles: (block, ns states)
  const size_t per_plane = (S + kTile - 1) / kTile;
  const size_t n_fold = (size_t)B * T * per_plane;
  const size_t f0 = n_fold * blockIdx.x / gridDim.x, f1 = n_fold * (blockIdx.x + 1) / gridDim.x;
  const size_t per_block = S / l.ns;
  const size_t n_mp = (size_t)B * per_block;
  const size_t m0 = n_mp * blockIdx.x / gridDim.x, m1 = n_mp * (blockIdx.x + 1) / gridDim.x;
  // max popcount(ti ^ tj) over T = 4^n values is log2 T
  const int rc_cap = kInf / a.lt;
  int pos[kGroup];
  for (int c = 0; c < C; ++c) {
    const int np = __ldcg(a.npass + c);
    int built = -1;  // the block whose column-c rank tables the CTA holds
    for (int p = 0; p < np; ++p) {
      for (size_t f = f0; f < f1; ++f) {
        const size_t bt = f / per_plane;
        const int b = (int)(bt / T), t = (int)(bt % T);
        const uint32_t mask = (uint32_t)__ldcg(a.masks + (size_t)b * C + c);
        const int groups = (__popc(mask) + kGroup - 1) / kGroup;
        const int gi = p - (np - groups);  // the block's passes end with the column's
        if (gi < 0) continue;
        int g = 0, skip = kGroup * gi;
        for (uint32_t m = mask; m != 0 && g < kGroup; m &= m - 1) {
          if (skip > 0) {
            --skip;
          } else {
            pos[g++] = __ffs(m) - 1;
          }
        }
        if (kMode == kTables && c > 0 && b != built) {
          build_rank(a, sm + l.rank, b, c);
          built = b;
        }
        dispatch_fold<kMode>(g, a, sm + l.rank, b, t, c, f % per_plane, pos, gi == 0, gi == groups - 1);
      }
      grid.sync();
    }
    built = -1;  // the block whose column-c low-bit sums the CTA holds
    for (size_t f = m0; f < m1; ++f) {
      const int b = (int)(f / per_block);
      if (b != built) {
        build_low<P>(a, l, sm, b, c);
        built = b;
      }
      const int rc = min(__ldg(a.rc + (size_t)b * C + c), rc_cap);
      const bool folded = __ldcg(a.masks + (size_t)b * C + c) != 0;
      minplus_tile<P, kMode>(a, l, sm, b, c, (f % per_block) * l.ns, folded, rc, c == C - 1);
    }
    grid.sync();
  }
}

template <int P, int kMode>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = forward_t_wide_kernel<P, kMode>;
  const Layout l = layout(a.K, a.T, a.lt, P);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.bytes);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, l.bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // as many CTAs as the card keeps resident, and no more than the tiles
  const size_t S = (size_t)1 << a.K;
  const size_t fold_tiles = (size_t)a.B * a.T * ((S + kTile - 1) / kTile);
  const size_t mp_tiles = (size_t)a.B * (S / l.ns);
  const size_t tiles = fold_tiles > mp_tiles ? fold_tiles : mp_tiles;
  const size_t resident = (size_t)sms * per_sm;
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  Args args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), params, l.bytes, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int kMode>
int dispatch(Args a, int P, cudaStream_t stream) {
  const int T = a.T;
  if (a.B < 1 || a.C < 1 || a.K < 1 || a.K > kMaxK) return (int)cudaErrorInvalidValue;
  if (T != 4 && T != 16 && T != 64 && T != 256) return (int)cudaErrorInvalidValue;
  a.lt = log2_of(T);
  switch (P) {
    case 2: return launch<2, kMode>(a, stream);
    case 4: return launch<4, kMode>(a, stream);
    case 6: return launch<6, kMode>(a, stream);
    case 8: return launch<8, kMode>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Tables mode: from zero, seeded from seed (B, T), or from a carried state
// (cost0, jmin0, key0 (B, T, 2^K) / (B, 2^K)); seed and carry are exclusive.
// scratch holds B*C + C ints (any contents).
extern "C" int wmec_forward_t_wide(const float* wdiff, const int* wbase, const float* rankw,
                                   const int* acost, const uint8_t* die, const int* rc, const int* seed,
                                   const int* cost0, const int* jmin0, const int* key0, int* pidx,
                                   int* pjmin, int* dp_last, int* jmin_last, int* key_last, int* scratch,
                                   int B, int C, int K, int T, int P, cudaStream_t stream) {
  if (seed != nullptr && cost0 != nullptr) return (int)cudaErrorInvalidValue;
  Args a{wdiff, wbase, rankw, acost, die, rc, seed, cost0, jmin0, key0, pidx, pjmin, dp_last, jmin_last,
         key_last, nullptr, scratch, scratch + (size_t)B * C, B, C, K, T, 0};
  return dispatch<kTables>(a, P, stream);
}

// Carry mode: from the carried state to the state after the last column
// (dp_last, jmin_last, key_last), no tables.  Only the carried cost0 is read:
// jmin0 and key0 would feed only the tables and the fold's ties, which the
// min fold does not need (they stay in the signature, which is the tables
// mode's).  The outputs must not alias the carry: a checkpoint is read again.
extern "C" int wmec_forward_carry_t_wide(const float* wdiff, const int* wbase, const float* rankw,
                                         const int* acost, const uint8_t* die, const int* rc,
                                         const int* cost0, const int* jmin0, const int* key0, int* dp_last,
                                         int* jmin_last, int* key_last, int* scratch, int B, int C, int K,
                                         int T, int P, cudaStream_t stream) {
  (void)jmin0;
  (void)key0;
  if (cost0 == nullptr) return (int)cudaErrorInvalidValue;
  Args a{wdiff, wbase, rankw, acost, die, rc, nullptr, cost0, nullptr, nullptr, nullptr, nullptr, dp_last,
         jmin_last, key_last, nullptr, scratch, scratch + (size_t)B * C, B, C, K, T, 0};
  return dispatch<kCarry>(a, P, stream);
}

// m-only mode: seeded from seed (B, T); writes m (B, T).  cost is scratch of
// B*T*2^K ints, scratch of B*C + C ints (any contents).
extern "C" int wmec_forward_m_t_wide(const float* wdiff, const int* wbase, const int* acost,
                                     const uint8_t* die, const int* rc, const int* seed, int* m, int* cost,
                                     int* scratch, int B, int C, int K, int T, int P, cudaStream_t stream) {
  if (seed == nullptr) return (int)cudaErrorInvalidValue;
  Args a{wdiff, wbase, nullptr, acost, die, rc, seed, nullptr, nullptr, nullptr, nullptr, nullptr, cost,
         nullptr, nullptr, m, scratch, scratch + (size_t)B * C, B, C, K, T, 0};
  return dispatch<kMinOnly>(a, P, stream);
}

extern "C" const char* wmec_forward_t_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
