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
// wmec_forward_t.cu, at T = 4, 16, 64, 256 or 1024 (five trios), P = 2, 4,
// 6, 8 or 10 (five founders) and any 1 <= K <= 23:
//
//   tables   pidx and pjmin of every column and the final dp, jmin and key,
//            from zero, a seed (B, T) or a carry (cost0, jmin0, key0):
//            entry point wmec_forward_t_wide;
//   carry    from a carry, the final state only, no tables:
//            wmec_forward_carry_t_wide;
//   m-only   R seeds a block (B, R, T), m[b, r, t] = min_i dp[t][i] of the
//            last column only: wmec_forward_m_t_wide.  The R scans of a
//            block share its inputs: the seam pass's coset seeds.
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
// nothing and are bound by their operations: per state and plane a fold
// compare for each pair a dying slot folds and log2 T compares of the
// min-plus, for each scan (each seed), and the column cost, 2P + 2^P sums
// and assignments, once per block.
//
// Design.  The state lives in device memory: the cost planes (B, R, T, 2^K)
// (dp_last, or scratch in the m-only mode) and the jmin planes (jmin_last),
// updated in place.  The tie key is not stored: before column c's fold it is
// the inverse Gray code of the rank sum over column c - 1's slots at the
// state's source index (the carried key0 at column 0), computed where two
// costs tie.  One cooperative launch holds as many CTAs as the card keeps
// resident and a grid-wide barrier ends each pass.  The unit of work is a
// tile: the coset of lb "tile bits" of the state index (2^lb = 4096 / T
// states, or all 2^K) in all T planes, 4096 entries in shared memory (4
// states at T = 1024).  A column is one pass over every block's tiles:
//
//   the tile bits are the column's dying slots (the highest lb of them) and
//   the lowest other bits; a tile loads its entries (cost, and with tables
//   the source index and the carried jmin), folds its dying slots in shared
//   memory (both partners of a pair lie in the tile), writes pidx and pjmin,
//   runs the min-plus as a per-bit distance transform over (cost, source t)
//   pairs (log2 T passes of x[t] = lexmin(x[t], x[t ^ bit] + (rc', 0)), the
//   same minimum and smallest argmin as the reference's T x T one, three
//   bits of t a pass in registers; where the minimum reaches INF every
//   candidate saturates and jmin is 0), adds the column cost and writes the
//   new state: one trip of the state a column.  Without tables the fold is
//   the minimum over each coset of the fold bits, one pass.  The column
//   cost of the tile goes to shared memory first: sums from a table of the
//   tile's common bits (one row a plane) and one of its tile bits (one row
//   a tile bit and plane), 16 states of a plane a thread in Gray order, the
//   2^P assignments in Gray order (at P = 10 in 64 runs of 16, the step
//   between runs on a bit chosen at run time).
//
//   In the m-only mode the tile's column cost serves the block's R seeds in
//   turn, each seed's entries loaded while the previous seed's are
//   computed.  Its cost planes are scratch: at T = 1024 they are kept
//   state-major (tile_entry), where a tile's 4 states of each plane would
//   be 16-byte pieces 4 * 2^K bytes apart.
//
//   A column where more than lb slots die in some block first folds the
//   others, lb at a time from the lowest, in pre-passes over tiles of the
//   same shape that write the folded state back (with tables the source
//   index into the pidx row and the carried jmin into the jmin plane); a
//   block's pre-passes end with the column's last one.
//
// Every index into the state and the tables is 64-bit.  The min-plus sources
// and the carried jmin are transmission values, a byte each up to T = 256
// and two bytes at T = 1024 (the `Src` type).  At T = 1024 and P = 10 a
// tile's shared memory (the tables of its rows) is ~203 KB: one CTA an SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxK = 23;
constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;
constexpr int kTile = 4096;             // entries (state, plane) of a tile
constexpr int kPer = kTile / kThreads;  // entries a thread loads
constexpr int kChunk = 8;               // state index bits a rank table covers
constexpr int kRows = 1 << kChunk;
constexpr int kMeta = 72;               // words: tile bits [0, 32), fold bits [32, 64), their count [64] and mask [65]

enum Mode { kTables = 0, kCarry = 1, kMinOnly = 2 };

struct Args {
  const float* wdiff;    // (B, C, K, T*P*2)
  const int* wbase;      // (B, C, T, P, 2)
  const float* rankw;    // (B, C, K)
  const int* acost;      // (B, C, T, 2^P)
  const uint8_t* die;    // (B, C, K)
  const int* rc;         // (B, C)
  const int* seed;       // (B, R, T) or null
  const int* cost0;      // (B, T, S) or null: carried cost
  const int* jmin0;      // (B, T, S) or null: carried jmin (tables mode)
  const int* key0;       // (B, S) or null: carried tie key (tables mode)
  int* pidx;             // (B, C, T, S)  tables mode
  int* pjmin;            // (B, C, T, S)  tables mode
  int* cost;             // (B, R, T, S)  the cost planes: dp_last, or scratch (m-only)
  int* jmin;             // (B, T, S)     jmin_last (every column with tables, the last one in the carry mode)
  int* key_last;         // (B, S)        tables and carry modes
  int* m;                // (B, R, T)     m-only mode
  int* masks;            // (B, C)        scratch: the dying slots of each column
  int* npass;            // (C,)          scratch: the pre-passes of each column
  int B, C, K, T, R, lt; // R = 1 but in the m-only mode; lt = log2 T
};

__host__ __device__ inline int log2_of(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// The tile's states and the dynamic shared memory's layout (the same on the
// host and the device); sb is the bytes of a transmission value (Src).
struct Layout {
  int ns, lb, n;         // states a tile, their bits, and entries (T * ns)
  int xc, cc, xi, lw, hs, off, rank, rw, red, meta, xs, xj;  // word offsets; xs and xj Src arrays
  size_t bytes;
};

__host__ __device__ inline Layout layout(int K, int T, int lt, int P, int mode, int sb) {
  Layout l;
  const int ns = kTile >> lt;
  l.ns = K < 30 && (1 << K) < ns ? 1 << K : ns;
  l.lb = log2_of(l.ns);
  l.n = T * l.ns;
  const bool tab = mode == kTables, mo = mode == kMinOnly;
  const int row = P + 1;
  l.xc = 0;                                   // [T][ns] costs
  l.cc = l.xc + l.n;                          // [T][ns] column costs
  l.xi = l.cc + l.n;                          // [T][ns] source indices (tables)
  l.lw = l.xi + (tab ? l.n : 0);              // [lb][T][P + 1] tile-bit sums (s0, d_0 .. d_{P-1})
  l.hs = l.lw + l.lb * T * row;               // [T][P + 1] the tile's common-bit sums, wbase included
  l.off = l.hs + T * row;                     // [ns] a local index's state bits
  l.rank = l.off + l.ns;                      // [3][kRows] rank sums of column c - 1 (tables)
  l.rw = l.rank + (tab ? 3 * kRows : 0);      // [32] rank weights of the column (keys)
  l.red = l.rw + 32;                          // [T] m-only reduction
  l.meta = l.red + T;                         // [kMeta] tile bits and fold bits
  l.xs = l.meta + kMeta;                      // Src: [T][ns] min-plus sources (tables, carry)
  l.xj = l.xs + (mo ? 0 : l.n * sb / 4);      // Src: [T][ns] carried jmin (tables)
  l.bytes = (size_t)l.xj * sizeof(int) + (tab ? l.n * sb : 0);
  return l;
}

// Pre-passes a block takes at a column where nd slots die: the fold of all
// but the highest lb, lb at a time.
__host__ __device__ inline int pre_passes(int nd, int lb) { return nd > lb ? (nd - 1) / lb : 0; }

__device__ __forceinline__ int inverse_gray(int r, int K) {
#pragma unroll
  for (int sh = 1; sh < 32; sh <<= 1) {
    if (sh < K) r ^= r >> sh;
  }
  return r;
}

// The dying slots of `mask` whose rank among them (ascending) is in [lo, hi).
__device__ __forceinline__ uint32_t slot_range(uint32_t mask, int lo, int hi) {
  uint32_t out = 0;
  int i = 0;
  for (uint32_t m = mask; m != 0 && i < hi; m &= m - 1, ++i) {
    if (i >= lo) out |= m & (0u - m);
  }
  return out;
}

// A tile's tables for block b at column c: its tile bits (the slots `fold`,
// then the lowest other bits, lb in all, ascending), which of them fold, the
// state bits of each local index, with tables (c > 0) the rank sums of column
// c - 1 over each 8 bits of the state index (the fold's tie keys), and for the
// column's last pass (`final_pass`) the tile-bit sums of column c and its rank
// weights.  Every thread of the CTA calls it (three barriers).
template <int P, int kMode>
__device__ void build_tile(const Args& a, const Layout& l, int* sm, int b, int c, uint32_t fold, bool final_pass) {
  const int K = a.K, T = a.T, lb = l.lb;
  const size_t col = (size_t)b * a.C + c;
  int* meta = sm + l.meta;
  __syncthreads();  // the tables of the previous tile are no longer read
  if (threadIdx.x == 0) {
    uint32_t bits = fold;
    int need = lb - __popc(fold);
    for (int k = 0; need > 0; ++k) {
      if (!((fold >> k) & 1)) {
        bits |= 1u << k;
        --need;
      }
    }
    int j = 0, nf = 0;
    for (uint32_t m = bits; m != 0; m &= m - 1, ++j) {
      const int p = __ffs(m) - 1;
      meta[j] = p;
      if ((fold >> p) & 1) meta[32 + nf++] = j;
    }
    meta[64] = nf;
    meta[65] = 0;
    for (int f = 0; f < nf; ++f) meta[65] |= 1 << meta[32 + f];
  }
  __syncthreads();
  for (int sl = threadIdx.x; sl < l.ns; sl += kThreads) {
    uint32_t o = 0;
    for (int j = 0; j < lb; ++j) o |= (uint32_t)((sl >> j) & 1) << meta[j];
    sm[l.off + sl] = (int)o;
  }
  if (final_pass) {
    const int tp2 = T * P * 2;
    const float* wd = a.wdiff + col * K * tp2;
    const int n = lb * T * (P + 1);
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int j = e % (P + 1), kt = e / (P + 1), t = kt % T, k = kt / T;
      const float* w = wd + (size_t)meta[k] * tp2 + t * 2 * P;
      int v = 0;
      if (j == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p) v += (int)__ldg(w + 2 * p);
      } else {
        v = (int)__ldg(w + 2 * (j - 1) + 1) - (int)__ldg(w + 2 * (j - 1));
      }
      sm[l.lw + e] = v;
    }
    if (kMode != kMinOnly) {  // the m-only mode keeps no key
      for (int k = threadIdx.x; k < K; k += kThreads) sm[l.rw + k] = (int)__ldg(a.rankw + col * K + k);
    }
  }
  if (kMode == kTables && c > 0) {
    const float* rw = a.rankw + (col - 1) * K;
    const uint32_t all = (1u << K) - 1;
    for (int e = threadIdx.x; e < 3 * kRows; e += kThreads) {
      const int j = e / kRows, v = e % kRows;
      int r = 0;
      for (uint32_t bits = ((uint32_t)v << (kChunk * j)) & all; bits != 0; bits &= bits - 1) {
        r += (int)__ldg(rw + __ffs(bits) - 1);
      }
      sm[l.rank + e] = r;
    }
  }
  __syncthreads();
}

// The column cost of every entry of a tile into cc, min(s0 + min_x (pa +
// acost), INF): a thread takes 16 consecutive local states of one plane (all
// the local states where the tile has fewer than 16), their sums from the
// common-bit row of the plane and the rows of the set tile bits, then from
// one state to the next in Gray order of the low 4 local bits one row added
// or taken away; the assignments x in Gray order (bit p of x puts allele 1
// on partition p), so each partial sum pa takes one add, and at P <= 4 the
// plane's 2^P assignment costs in registers.  At P = 10 the assignments go
// in runs of 16 (their low 4 bits unrolled, the step between runs on bit 4
// + ctz(run) picked from d by selects), so the loop is not unrolled 1,023
// times.  Not inlined: its registers do not add to those live around it.
template <int P>
__device__ __noinline__ void tile_cost(const Layout& l, int* sm, const int* ac0, int T) {
  constexpr int kA = (1 << P) <= 16 ? 1 << P : 1;
  const int lb = l.lb, ns = l.ns, gb = lb < 4 ? lb : 4, per = 1 << gb;
  const int* hs = sm + l.hs;
  const int* lw = sm + l.lw;
  int* cc = sm + l.cc;
  for (int task = threadIdx.x; task < (l.n >> gb); task += kThreads) {
    const int e0 = task << gb, t = e0 >> lb, sl0 = e0 & (ns - 1);
    const int* h = hs + t * (P + 1);
    int s0v = h[0];
    int d[P];
#pragma unroll
    for (int p = 0; p < P; ++p) d[p] = h[1 + p];
    for (uint32_t bits = (uint32_t)sl0; bits != 0; bits &= bits - 1) {
      const int* w = lw + ((__ffs(bits) - 1) * T + t) * (P + 1);
      s0v += w[0];
#pragma unroll
      for (int p = 0; p < P; ++p) d[p] += w[1 + p];
    }
    const int* ac = ac0 + ((size_t)t << P);
    int acr[kA];
    if ((1 << P) <= 16) {
#pragma unroll
      for (int x = 0; x < kA; ++x) acr[x] = __ldg(ac + x);
    }
#pragma unroll 1
    for (int g = 0; g < per; ++g) {
      const int gs = g ^ (g >> 1);
      if (g > 0) {
        const int q = __ffs(g) - 1;  // the local bit flipped from the previous state
        const int* w = lw + (q * T + t) * (P + 1);
        const int sg = (gs >> q) & 1 ? 1 : -1;
        s0v += sg * w[0];
#pragma unroll
        for (int p = 0; p < P; ++p) d[p] += sg * w[1 + p];
      }
      int pa = 0, best = (1 << P) <= 16 ? acr[0] : __ldg(ac);
      if constexpr (P <= 8) {
#pragma unroll
        for (int x = 1; x < (1 << P); ++x) {
          const int p = __ffs(x) - 1, xa = x ^ (x >> 1);
          pa += ((xa >> p) & 1) ? d[p] : -d[p];
          best = min(best, pa + ((1 << P) <= 16 ? acr[xa & (kA - 1)] : __ldg(ac + xa)));
        }
      } else {
#pragma unroll 1
        for (int h = 0; h < (1 << (P - 4)); ++h) {
          // the step into this run flips bit 4 + ctz(h)
          const int ph = 4 + __ffs(h) - 1;
          int dh = d[4];
#pragma unroll
          for (int q = 5; q < P; ++q) dh = ph == q ? d[q] : dh;
#pragma unroll
          for (int lo = 0; lo < 16; ++lo) {
            if (lo == 0 && h == 0) continue;
            const int x = (h << 4) | lo, xa = x ^ (x >> 1);
            const int p = lo != 0 ? __ffs(lo) - 1 : ph;
            const int dv = lo != 0 ? d[__ffs(lo | 16) - 1] : dh;
            pa += ((xa >> p) & 1) ? dv : -dv;
            best = min(best, pa + __ldg(ac + xa));
          }
        }
      }
      cc[e0 + gs] = min(s0v + best, kInf);
    }
  }
}

// The min-plus's distance transform over bits j0 .. j0 + G - 1 of t: a thread
// takes the 2^G entries of a state and the other bits of t into registers and
// runs the G passes there, each as the reference's pass over that bit, in
// order: lexicographic (cost, source) minima where the sources are kept (the
// two sources of a pair come from disjoint sets, so never tie), plain minima
// in the m-only mode.
template <int G, bool kSrc, typename Src>
__device__ __forceinline__ void minplus_bits(int* xc, Src* xs, int n, int lb, int j0, int rc) {
  constexpr int M = 1 << G;
  const int sh = j0 + lb;
  for (int q = threadIdx.x; q < (n >> G); q += kThreads) {
    const int e0 = ((q >> sh) << (sh + G)) | (q & ((1 << sh) - 1));
    int v[M], sv[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      v[m] = xc[e0 | (m << sh)];
      sv[m] = kSrc ? xs[e0 | (m << sh)] : 0;
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if ((m >> j) & 1) continue;
        const int m1 = m | (1 << j);
        const int c0 = v[m], c1 = v[m1];
        if (kSrc) {
          const int s0_ = sv[m], s1_ = sv[m1];
          const int n0 = c1 + rc, n1 = c0 + rc;
          if (n0 < c0 || (n0 == c0 && s1_ < s0_)) {
            v[m] = n0;
            sv[m] = s1_;
          }
          if (n1 < c1 || (n1 == c1 && s0_ < s1_)) {
            v[m1] = n1;
            sv[m1] = s0_;
          }
        } else {
          v[m] = min(c0, c1 + rc);
          v[m1] = min(c1, c0 + rc);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      xc[e0 | (m << sh)] = v[m];
      if (kSrc) xs[e0 | (m << sh)] = (Src)sv[m];
    }
  }
}

// The state of entry e (plane e >> lb) of a tile whose common bits are base.
__device__ __forceinline__ uint32_t entry_state(const int* off, uint32_t base, int ns, int e) {
  return base | (uint32_t)off[e & (ns - 1)];
}

// The tile entry e (plane-major in shared memory, e = t * ns + sl) that a
// thread moves as its i-th (i * kThreads + threadIdx.x < n), and in o its
// offset in a scan's state: plane-major (t * 2^K + state), the layout of the
// outputs and the tables; or with kSM, the m-only mode's cost scratch at T =
// 1024, state-major (state * T + t), so that a warp moves 32 planes of one
// state, 128 contiguous bytes, not 16 bytes of each of 8 planes 4 * 2^K bytes
// apart (a tile holds 4 states there).
template <bool kSM>
__device__ __forceinline__ int tile_entry(int i, const int* off, uint32_t base, int ns, int lb, int lt, int K,
                                          size_t& o) {
  const int q = threadIdx.x + i * kThreads;
  if (kSM) {
    const int t = q & ((1 << lt) - 1), sl = q >> lt;
    o = ((size_t)entry_state(off, base, ns, sl) << lt) + t;
    return (t << lb) | sl;
  }
  o = ((size_t)(q >> lb) << K) + entry_state(off, base, ns, q);
  return q;
}

// The costs of scan r of block b at a tile's entries, the thread's i-th
// (tile_entry) into pre[i]: from the cost planes, or (from_src) from the
// carry, the seed or zero.
template <bool kSM>
__device__ __forceinline__ void load_costs(int (&pre)[kPer], const Args& a, const int* off, uint32_t base, int ns,
                                           int lb, int n, int b, int R, int r, bool from_src) {
  const size_t planes = ((size_t)b * R + r) * a.T << a.K;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if ((int)threadIdx.x + i * kThreads >= n) continue;
    size_t o;
    const int e = tile_entry<kSM>(i, off, base, ns, lb, a.lt, a.K, o);
    if (from_src) {
      pre[i] = a.cost0 != nullptr ? __ldg(a.cost0 + planes + o)
               : a.seed != nullptr ? __ldg(a.seed + ((size_t)b * R + r) * a.T + (e >> lb)) : 0;
    } else {
      pre[i] = __ldcg(a.cost + planes + o);
    }
  }
}

// The fold's tie key of a source index at column c of block b: column c - 1's
// inverse Gray rank (from the rank tables), or the carried key at column 0.
__device__ __forceinline__ int tie_key(const Args& a, const int* rank, int b, int c, int src) {
  const uint32_t v = (uint32_t)src;
  if (c > 0) {
    return inverse_gray(rank[v & (kRows - 1)] + rank[kRows + ((v >> kChunk) & (kRows - 1))] +
                            rank[2 * kRows + (v >> (2 * kChunk))],
                        a.K);
  }
  return a.key0 != nullptr ? __ldg(a.key0 + ((size_t)b << a.K) + v) : 0;
}

// One tile u of block b at column c, for each of the block's R scans (R = 1
// but in the m-only mode): load, fold the tile's fold bits, then either write
// the folded state back (a pre-pass) or, on the column's last pass, write the
// tables, run the min-plus and write the new state.  `first`: the block's
// first pass of the column (the state is the previous column's, or at column
// 0 the seed, the carry or zero, and the source index the identity).
template <int P, int kMode, typename Src>
__device__ void run_tile(const Args& a, const Layout& l, int* sm, int b, int c, size_t u, bool first,
                         bool final_pass, int rc, bool last_col) {
  constexpr bool kTab = kMode == kTables;
  constexpr bool kMin = kMode == kMinOnly;
  constexpr bool kSM = kMin && sizeof(Src) == 2;  // the m-only scratch state-major at T = 1024
  const int T = a.T, K = a.K, lb = l.lb, ns = l.ns, n = l.n;
  const int R = kMin ? a.R : 1;
  const size_t S = (size_t)1 << K;
  const size_t col = (size_t)b * a.C + c;
  const int* meta = sm + l.meta;
  const int* off = sm + l.off;
  int* xc = sm + l.xc;
  int* cc = sm + l.cc;
  int* xi = sm + l.xi;
  int* hs = sm + l.hs;
  int* red = sm + l.red;
  Src* xs = reinterpret_cast<Src*>(sm + l.xs);
  Src* xj = reinterpret_cast<Src*>(sm + l.xj);
  const int nf = meta[64];
  const bool from_src = c == 0 && first;

  // the tile's common bits: u with a zero inserted at each tile bit
  uint32_t base = (uint32_t)u;
  for (int j = 0; j < lb; ++j) {
    const int p = meta[j];
    base = ((base >> p) << (p + 1)) | (base & ((1u << p) - 1));
  }
  if (final_pass) {
    // the common-bit sums of the tile, wbase included: one row a plane
    __syncthreads();  // the previous tile's sums and costs are no longer read
    const int tp2 = T * P * 2;
    const float* wd = a.wdiff + col * K * tp2;
    const int* wb = a.wbase + col * T * P * 2;
    for (int e = threadIdx.x; e < T * (P + 1); e += kThreads) {
      const int j = e % (P + 1), t = e / (P + 1);
      int v = 0;
      if (j == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p) v += __ldg(wb + t * 2 * P + 2 * p);
      } else {
        v = __ldg(wb + t * 2 * P + 2 * (j - 1) + 1) - __ldg(wb + t * 2 * P + 2 * (j - 1));
      }
      for (uint32_t bits = base; bits != 0; bits &= bits - 1) {
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
    // the column cost, once for all the block's seeds
    __syncthreads();
    tile_cost<P>(l, sm, a.acost + (col * T << P), T);
  }

  const int* rank = sm + l.rank;
  int pre[kPer];  // the costs of the next scan, loaded while this one is computed
  load_costs<kSM>(pre, a, off, base, ns, lb, n, b, R, 0, from_src);
  for (int r = 0; r < R; ++r) {
    const size_t planes = ((size_t)b * R + r) * T * S;
    __syncthreads();  // the previous scan's (or tile's) entries are no longer read
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if ((int)threadIdx.x + i * kThreads >= n) continue;
      size_t o;
      const int e = tile_entry<kSM>(i, off, base, ns, lb, a.lt, K, o);
      xc[e] = pre[i];
      if (!kMin) xs[e] = (Src)(e >> lb);
      if (kTab) {
        xi[e] = first ? (int)entry_state(off, base, ns, e) : __ldcg(a.pidx + col * T * S + o);
        xj[e] = (Src)(from_src ? (a.jmin0 != nullptr ? __ldg(a.jmin0 + planes + o) : 0)
                               : __ldcg(a.jmin + planes + o));
      }
    }
    if (kMin && last_col) {
      for (int t = threadIdx.x; t < T; t += kThreads) red[t] = kInf;
    }
    if (kMin && r + 1 < R) load_costs<kSM>(pre, a, off, base, ns, lb, n, b, R, r + 1, from_src);

    if (kTab) {
      // the fold, slot by slot in ascending order: (e0, e1) is the pair (s,
      // s | 2^slot) of a plane; the partner wins only when strictly better
      for (int f = 0; f < nf; ++f) {
        const int j = meta[32 + f];
        __syncthreads();
        for (int q = threadIdx.x; q < n / 2; q += kThreads) {
          const int e0 = ((q >> j) << (j + 1)) | (q & ((1 << j) - 1)), e1 = e0 | (1 << j);
          const int c0 = xc[e0], c1 = xc[e1];
          const int i0 = xi[e0], i1 = xi[e1];
          const bool partner = c1 < c0 || (c1 == c0 && tie_key(a, rank, b, c, i1) < tie_key(a, rank, b, c, i0));
          if (partner) {
            xc[e0] = c1;
            xi[e0] = i1;
            xj[e0] = xj[e1];
          } else {
            xc[e1] = c0;
            xi[e1] = i0;
            xj[e1] = xj[e0];
          }
        }
      }
    } else if (nf > 0) {
      // without tables the fold is the minimum over each coset of the fold
      // bits in a plane, in one pass
      const uint32_t fm = (uint32_t)meta[65];
      __syncthreads();
      for (int q = threadIdx.x; q < (n >> nf); q += kThreads) {
        int e0 = q;
        for (int f = 0; f < nf; ++f) {
          const int j = meta[32 + f];
          e0 = ((e0 >> j) << (j + 1)) | (e0 & ((1 << j) - 1));
        }
        int v = xc[e0];
        for (uint32_t sub = fm; sub != 0; sub = (sub - 1) & fm) v = min(v, xc[e0 | sub]);
        uint32_t sub = 0;
        do {
          xc[e0 | sub] = v;
          sub = (sub - fm) & fm;
        } while (sub != 0);
      }
    }
    __syncthreads();

    if (!final_pass) {
      // a pre-pass: the folded state back to the planes
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if ((int)threadIdx.x + i * kThreads >= n) continue;
        size_t o;
        const int e = tile_entry<kSM>(i, off, base, ns, lb, a.lt, K, o);
        a.cost[planes + o] = xc[e];
        if (kTab) {
          a.pidx[col * T * S + o] = xi[e];
          a.jmin[planes + o] = xj[e];
        }
      }
      continue;
    }
    if (kTab) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = threadIdx.x + i * kThreads;
        if (e >= n) continue;
        const size_t tab = col * T * S + (((size_t)(e >> lb) << K) + entry_state(off, base, ns, e));
        __stcs(a.pidx + tab, xi[e]);
        __stcs(a.pjmin + tab, (int)xj[e]);
      }
    }

    // the min-plus over the bits of t, three at a time
    for (int j = 0; j < a.lt; j += 3) {
      if (j > 0) __syncthreads();
      if (a.lt - j >= 3) {
        minplus_bits<3, !kMin, Src>(xc, xs, n, lb, j, rc);
      } else if (a.lt - j == 2) {
        minplus_bits<2, !kMin, Src>(xc, xs, n, lb, j, rc);
      } else {
        minplus_bits<1, !kMin, Src>(xc, xs, n, lb, j, rc);
      }
    }
    __syncthreads();

    // the column cost of each plane, and the new state (partly unrolled: the
    // next scan's costs are in flight in registers)
#pragma unroll 4
    for (int i = 0; i < kPer; ++i) {
      if ((int)threadIdx.x + i * kThreads >= n) continue;
      size_t o;
      const int e = tile_entry<kSM>(i, off, base, ns, lb, a.lt, K, o);
      const int x = xc[e];
      const int nc = min(cc[e] + min(x, kInf), kInf);
      if (kMin && last_col) {
        atomicMin(red + (e >> lb), nc);
        continue;
      }
      a.cost[planes + o] = nc;
      if (kTab || (!kMin && last_col)) a.jmin[planes + o] = x >= kInf ? 0 : (int)xs[e];
    }
    if (last_col && !kMin) {
      for (int sl = threadIdx.x; sl < ns; sl += kThreads) {
        const uint32_t st = base | (uint32_t)off[sl];
        int rs = 0;
        for (uint32_t bits = st; bits != 0; bits &= bits - 1) rs += sm[l.rw + __ffs(bits) - 1];
        a.key_last[(size_t)b * S + st] = inverse_gray(rs, K);
      }
    }
    if (kMin && last_col) {
      __syncthreads();
      for (int t = threadIdx.x; t < T; t += kThreads) atomicMin(a.m + ((size_t)b * R + r) * T + t, red[t]);
    }
  }
}

// Two CTAs an SM: at most 128 registers a thread (one where a tile's
// tables take more than half the SM's shared memory).
template <int P, int kMode, typename Src>
__global__ void __launch_bounds__(kThreads, 2) forward_t_wide_kernel(Args a) {
  extern __shared__ int4 smem4[];
  int* sm = reinterpret_cast<int*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, C = a.C, K = a.K;
  const size_t S = (size_t)1 << K;
  const Layout l = layout(K, a.T, a.lt, P, kMode, (int)sizeof(Src));
  const int lb = l.lb;

  // prologue: a warp a column gathers every block's dying slots there and
  // the column's pre-passes, the most any block needs; m starts at INF
  const int lane = threadIdx.x & 31;
  const size_t warps = (size_t)gridDim.x * (kThreads / 32);
  for (size_t w = grid.thread_rank() / 32; w < (size_t)C; w += warps) {
    int np = 0;
    for (int b = lane; b < B; b += 32) {
      const uint8_t* d = a.die + ((size_t)b * C + w) * K;
      int m = 0;
      for (int k = 0; k < K; ++k) m |= d[k] ? 1 << k : 0;
      a.masks[(size_t)b * C + w] = m;
      np = max(np, pre_passes(__popc(m), lb));
    }
    np = __reduce_max_sync(0xffffffffu, np);
    if (lane == 0) a.npass[w] = np;
  }
  if (kMode == kMinOnly) {
    const size_t nm = (size_t)B * a.R * a.T;
    for (size_t i = grid.thread_rank(); i < nm; i += (size_t)gridDim.x * kThreads) a.m[i] = kInf;
  }
  grid.sync();

  // tiles: (block, coset of the tile bits), the same split in every pass
  const size_t per_block = S >> lb;
  const size_t n_tiles = (size_t)B * per_block;
  const size_t f0 = n_tiles * blockIdx.x / gridDim.x, f1 = n_tiles * (blockIdx.x + 1) / gridDim.x;
  // max popcount(ti ^ tj) over T = 4^n values is log2 T
  const int rc_cap = kInf / a.lt;
  for (int c = 0; c < C; ++c) {
    const int np = __ldcg(a.npass + c);
    for (int p = 0; p < np; ++p) {
      int built = -1;  // the block whose pass-p tables the CTA holds
      for (size_t f = f0; f < f1; ++f) {
        const int b = (int)(f / per_block);
        const uint32_t mask = (uint32_t)__ldcg(a.masks + (size_t)b * C + c);
        const int nd = __popc(mask), groups = pre_passes(nd, lb);
        const int gi = p - (np - groups);  // the block's pre-passes end with the column's
        if (gi < 0) continue;
        if (b != built) {
          build_tile<P, kMode>(a, l, sm, b, c, slot_range(mask, gi * lb, min((gi + 1) * lb, nd - lb)), false);
          built = b;
        }
        run_tile<P, kMode, Src>(a, l, sm, b, c, f % per_block, gi == 0, false, 0, false);
      }
      grid.sync();
    }
    int built = -1;  // the block whose column-c tables the CTA holds
    for (size_t f = f0; f < f1; ++f) {
      const int b = (int)(f / per_block);
      const uint32_t mask = (uint32_t)__ldcg(a.masks + (size_t)b * C + c);
      const int nd = __popc(mask);
      if (b != built) {
        build_tile<P, kMode>(a, l, sm, b, c, slot_range(mask, max(nd - lb, 0), nd), true);
        built = b;
      }
      const int rc = min(__ldg(a.rc + (size_t)b * C + c), rc_cap);
      run_tile<P, kMode, Src>(a, l, sm, b, c, f % per_block, nd <= lb, true, rc, c == C - 1);
    }
    grid.sync();
  }
}

template <int P, int kMode, typename Src>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = forward_t_wide_kernel<P, kMode, Src>;
  const Layout l = layout(a.K, a.T, a.lt, P, kMode, (int)sizeof(Src));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.bytes);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, l.bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // as many CTAs as the card keeps resident, and no more than the tiles
  const size_t tiles = (size_t)a.B * (((size_t)1 << a.K) >> l.lb);
  const size_t resident = (size_t)sms * per_sm;
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  Args args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), params, l.bytes, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int kMode, typename Src>
int dispatch_p(const Args& a, int P, cudaStream_t stream) {
  switch (P) {
    case 2: return launch<2, kMode, Src>(a, stream);
    case 4: return launch<4, kMode, Src>(a, stream);
    case 6: return launch<6, kMode, Src>(a, stream);
    case 8: return launch<8, kMode, Src>(a, stream);
    case 10: return launch<10, kMode, Src>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int kMode>
int dispatch(Args a, int P, cudaStream_t stream) {
  const int T = a.T;
  if (a.B < 1 || a.C < 1 || a.R < 1 || a.K < 1 || a.K > kMaxK) return (int)cudaErrorInvalidValue;
  if (T != 4 && T != 16 && T != 64 && T != 256 && T != 1024) return (int)cudaErrorInvalidValue;
  a.lt = log2_of(T);
  // a transmission value takes a byte up to T = 256, two at T = 1024
  return T <= 256 ? dispatch_p<kMode, uint8_t>(a, P, stream) : dispatch_p<kMode, uint16_t>(a, P, stream);
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
         key_last, nullptr, scratch, scratch + (size_t)B * C, B, C, K, T, 1, 0};
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
         jmin_last, key_last, nullptr, scratch, scratch + (size_t)B * C, B, C, K, T, 1, 0};
  return dispatch<kCarry>(a, P, stream);
}

// m-only mode: R scans a block over the block's inputs, seeded from seed (B,
// R, T); writes m (B, R, T).  cost is scratch of B*R*T*2^K ints, scratch of
// B*C + C ints (any contents).
extern "C" int wmec_forward_m_t_wide(const float* wdiff, const int* wbase, const int* acost,
                                     const uint8_t* die, const int* rc, const int* seed, int* m, int* cost,
                                     int* scratch, int B, int C, int K, int T, int P, int R, cudaStream_t stream) {
  if (seed == nullptr) return (int)cudaErrorInvalidValue;
  Args a{wdiff, wbase, nullptr, acost, die, rc, seed, nullptr, nullptr, nullptr, nullptr, nullptr, cost,
         nullptr, nullptr, m, scratch, scratch + (size_t)B * C, B, C, K, T, R, 0};
  return dispatch<kMinOnly>(a, P, stream);
}

extern "C" const char* wmec_forward_t_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
