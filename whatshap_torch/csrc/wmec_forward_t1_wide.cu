// T=1 wMEC forward column scan for Hopper (sm_90a) with the state in device
// memory, for blocks past the thread-block cluster's envelope (K 18 to 23).
//
// Replaces the reference's XLA scan at T = 1 where its Pallas kernel refuses
// the shape: whatshap_tpu/ops/wmec.py `_forward_scan_impl` (with `_fold_dying`
// and `_col_cost`), as `solve_batched` and `_solve_scan` run it with tables
// and as the segmented `solve_scan_segmented` runs it in its two passes,
// `_forward_carry_scan` (no tables) and `_forward_tables_scan` (tables from a
// carry).  The same two modes as wmec_forward_t1.cu, at any 1 <= K <= 23:
//
//   tables   the projection table of every column and the final state, from
//            a zero state or from a carried one (cost0, key0; null for zero):
//            entry point wmec_forward_t1_wide;
//   carry    the final state only, no table: wmec_forward_carry_t1_wide.
//
// What it computes, per column c over the 2^K bipartitions s of the block's
// read slots (the function of wmec_forward_t1.cu, which its header states):
// fold every slot that died before c, in ascending slot order, the pair (s,
// s | 1 << p) taking the winner under (cost, tie key), the partner winning
// only when strictly better, BOTH receiving the winner's cost, key and source
// index (the carry mode keeps no index, and there the fold is a min of the
// costs); pidx[b, c, s] = the source index (the identity in a column where
// nothing dies); then add the column cost, min over the four allele
// assignments of min(s0 + d + acost, INF), to the folded cost, saturating at
// INF = 1 << 29; the new tie key is the inverse Gray code of the rank sum.
// All int32, as the reference's (its f32 sums of integer weights are exact).
//
// Bound: in the tables mode the table write, B*C*2^K*4 bytes (2 GiB a block
// at K = 23 and 64 columns), against about 5*B*C*2^K int32 adds; the bytes
// bound it (wmec_forward_t1.cu's reckoning).  The carry mode writes only the
// final state and is bound by the adds.  Beside them the state (one cost
// plane, 4 * 2^K bytes a block, 32 MiB at K = 23) makes a trip each time it
// leaves the SMs: read, and written back.
//
// Design.  The cost plane lives in device memory (dp_last, updated in place).
// The tie key is not stored: before column c's fold it is the inverse Gray
// code of the rank sum over column c - 1's slots at the state's source index
// (the carried key0 at column 0), compared only where two costs tie.  Folding
// the slots of a coset in ascending order, the partner winning only when
// strictly better, leaves every state of the coset the least entry under
// (cost, key, source index): a tie of cost and key goes to the lower index.
// So a coset folds in any order, as a reduction under that order.
//
//   One cooperative launch holds as many CTAs as the card keeps resident.
//   The unit of work is a tile: the coset of 12 "tile bits" of the
//   state index (4096 states, or all 2^K), 16 states a thread in registers;
//   the lowest other bits are the lanes, so a warp reads 32 neighbouring
//   states.  The columns go in windows, a grid-wide barrier after each:
//
//   - the window path: as many columns (up to kWin) as keep every block's
//     union of their dying slots within the 4 bits of a thread's 16 states.
//     The tile bits are those slots and the lowest other bits.  A tile loads
//     its costs once, then for each column folds in registers (the source a
//     4-bit index among the thread's states, its tie key from per-column
//     tables of the thread's and the tile's parts), writes its table row
//     with streaming stores and adds the column cost; it writes its costs
//     back after the window's last column: one trip of the state a window;
//   - the general path, one column (where some block has more than 4 slots
//     dying there): tiles whose bits are the column's dying slots, those
//     past a thread's 4 bits folded across threads through shared memory,
//     and where more than 12 die, the lowest first in a pre-pass that
//     writes the folded state back (the source index through the pidx row);
//     a block's pre-pass ends with the column's.
//
//   The sums of a state's column cost come in three parts, from tables of
//   each column in shared memory: the tile's common bits (three tables of
//   16 rows, one a 4-bit chunk of the tile index), the thread's bits (two,
//   its index's low and high 4 bits) and its 16 states' bits (one, acost
//   folded in), so no part loops over bits.  The blocks are swept in groups whose cost
//   planes fit a share of the L2 (kL2Share: three blocks at K = 20, one from
//   K = 21): every CTA takes the group's tiles, window by window, then the
//   next group, so the state's trips stay largely in the L2.
//
//   Tried on an H100 and not kept: tiles copied in by the bulk copy engine
//   (many small runs where a dying slot is low), the next tile's costs
//   loaded ahead into registers (the tables mode spilled), evict-last hints
//   on the state; profile_forward_t1_wide.py times three CTAs an SM (spills)
//   and larger L2 shares, which do not pay either.
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
constexpr int kPer = 16;        // states a thread takes in a tile
constexpr int kTileBits = 12;   // log2(kThreads * kPer)
constexpr int kLaneBits = 8;    // log2(kThreads)
constexpr int kRegBits = kTileBits - kLaneBits;  // tile bits on a thread's states
constexpr int kWin = 16;        // columns a window takes at most
constexpr int kChunk = 8;       // state index bits a rank table covers
constexpr int kRows = 1 << kChunk;
// The L2 share (of the H100's 50 MB) that a group's cost planes may take.
constexpr size_t kL2Share = (size_t)12 << 20;

struct Args {
  const float* wdiff;    // (B, C, K, 4)
  const int* wbase;      // (B, C, 1, 2, 2)
  const float* rankw;    // (B, C, K)
  const int* acost;      // (B, C, 1, 4)
  const uint8_t* die;    // (B, C, K)
  const int* cost0;      // (B, S) or null: carried cost
  const int* key0;       // (B, S) or null: carried tie key (tables mode)
  int* pidx;             // (B, C, S)  tables mode
  int* cost;             // (B, S)     the state, and dp_last after the last column
  int* key_last;         // (B, S)
  int* masks;            // (B, C)     scratch: the dying slots of each column
  int* npass;            // (C,)       scratch: the pre-passes of each column
  int B, C, K;
};

// The shared memory of a CTA: the tables of one block at one window (the
// columns c0 .. c0 + win - 1, entry w of a column table for column c0 + w -
// 1: entry 0 is the column before the window, whose rank sums give the first
// column's tie keys) or at one pass of a column (the general path).
struct Smem {
  int4 bit[kWin + 1][kMaxK];  // slot k's terms of the sums {s0, d_0, d_1, rank}
  int4 h4[kWin + 1][kPer];    // a thread's state i: its bits' part of each assignment's cost, acost included
  int hrank[kWin + 1][kPer];  // and of the rank sum
  int4 lo4[kWin + 1][2][16];  // the thread index's part of the sums, wbase included: its low and high 4 bits
  int4 nt4[kWin + 1][3][16];  // the tile index's part (over the bits that are no tile bit), 4 bits a row
  int4 wb[kWin + 1], ac[kWin + 1];
  uint32_t dmask[kWin + 1];   // the dying slots of each column, as bits of a thread's state index
  int hoff[kPer];             // the state bits of a thread's state i
  int lbit[kTileBits];        // the state bit of each local bit of a tile
  int rank_prev[3][kRows];    // the general path: column c - 1's rank sums over each 8 bits (tie keys)
  int red_c[kThreads], red_i[kThreads];  // the general path's fold across threads
  uint32_t nontile;           // the state bits that are no tile bit
  int ntoff[3][16];           // the tile index's 4-bit chunks spread over them
  int nfold, nreg;            // slots the pass folds; of them in a thread's registers
  uint32_t tmask;             // the thread-index bits that fold
  int win, windowed;          // the window's columns, and whether it takes the window path
};

// Blocks a group of the L2 sweep: as many cost planes as fit kL2Share, at
// least one, at most B.
__host__ __device__ inline int blocks_a_group(int K, int B) {
  int group = (int)(kL2Share >> (K + 2));
  return group < 1 ? 1 : group > B ? B : group;
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

// The order of inverse_gray(r1, K) against inverse_gray(r0, K): -1, 0 or 1.
// Past K = 16 the inverse Gray code of a nonnegative r is the prefix XOR of
// its bits from the top, so the two differ first at the highest bit h where
// r1 and r0 do, and there the one whose bits from h up have even parity is
// the lesser; elsewhere both codes are computed.
__device__ __forceinline__ int gray_order(int r1, int r0, int K) {
  if (K > 16 && (r1 | r0) >= 0) {
    const uint32_t d = (uint32_t)(r1 ^ r0);
    if (d == 0) return 0;
    return (__popc((uint32_t)r1 >> (31 - __clz(d))) & 1) ? 1 : -1;
  }
  const int k1 = inverse_gray(r1, K), k0 = inverse_gray(r0, K);
  return k1 < k0 ? -1 : k1 > k0 ? 1 : 0;
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

// The bits of v spread over the set bits of mask, in ascending order.
__device__ __forceinline__ uint32_t deposit(uint32_t v, uint32_t mask) {
  uint32_t out = 0;
  for (uint32_t m = mask; m != 0; m &= m - 1, v >>= 1) {
    if (v & 1) out |= m & (0u - m);
  }
  return out;
}

__device__ __forceinline__ int4 add4(int4 x, int4 y) { return make_int4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w); }

// Thread 0: the tile bits of a pass or window that folds the slots `fold`,
// the first kRegBits of them on the local bits of a thread's states
// (kLaneBits up), the rest on the thread index's from the top down, the
// lowest other bits on the free local bits in ascending order.
__device__ void layout(Smem& sm, int K, uint32_t fold) {
  const int lb = K < kTileBits ? K : kTileBits, nl = lb < kLaneBits ? lb : kLaneBits, nh = lb - nl;
  const int nf = __popc(fold);
  uint32_t used = 0, others = 0;
  for (int k = 0, need = lb - nf; need > 0; ++k) {
    if (!((fold >> k) & 1)) {
      others |= 1u << k;
      --need;
    }
  }
  int f = 0;
  for (uint32_t m = fold; m != 0; m &= m - 1, ++f) {
    const int loc = f < nh ? kLaneBits + f : nl - 1 - (f - nh);
    sm.lbit[loc] = __ffs(m) - 1;
    used |= 1u << loc;
  }
  int loc = 0;
  for (uint32_t m = others; m != 0; m &= m - 1, ++loc) {
    while ((used >> loc) & 1) ++loc;
    sm.lbit[loc] = __ffs(m) - 1;
  }
  sm.nontile = (uint32_t)(((uint64_t)1 << K) - 1) & ~(fold | others);
  sm.nfold = nf;
  sm.nreg = nf < nh ? nf : nh;
  const int nt = nf - sm.nreg;
  sm.tmask = ((1u << nt) - 1) << (nl - nt);
}

// Columns c_first .. c_first + n - 1 of block b into entries w_first ..
// w_first + n - 1 of the column tables: slot terms, wbase and acost, each
// thread's loads issued together.
__device__ __forceinline__ void stage_columns(const Args& a, Smem& sm, int b, int c_first, int w_first, int n) {
  const int K = a.K;
  const size_t col0 = (size_t)b * a.C + c_first;
  for (int e = threadIdx.x; e < n * K; e += kThreads) {
    const int w = e / K, k = e - w * K;
    const float* wd = a.wdiff + ((col0 + w) * K + k) * 4;
    const int w0 = (int)__ldg(wd), w1 = (int)__ldg(wd + 1), w2 = (int)__ldg(wd + 2), w3 = (int)__ldg(wd + 3);
    sm.bit[w_first + w][k] = make_int4(w0 + w2, w1 - w0, w3 - w2, (int)__ldg(a.rankw + (col0 + w) * K + k));
  }
  for (int w = threadIdx.x; w < n; w += kThreads) {
    const int* wb = a.wbase + (col0 + w) * 4;
    const int b0 = __ldg(wb), b1 = __ldg(wb + 1), b2 = __ldg(wb + 2), b3 = __ldg(wb + 3);
    sm.wb[w_first + w] = make_int4(b0 + b2, b1 - b0, b3 - b2, 0);
    const int* ac = a.acost + (col0 + w) * 4;
    sm.ac[w_first + w] = make_int4(__ldg(ac), __ldg(ac + 1), __ldg(ac + 2), __ldg(ac + 3));
  }
}

// The tables of entry w for the tile layout in sm.lbit and sm.nontile, task
// r of kTasks: the 16 thread's-state rows (r < 16), the 16 rows of the
// thread index's low and high 4 bits, and the 16 rows of each 4 bits of the
// tile index.
constexpr int kTasks = 6 * kPer;
__device__ __forceinline__ void column_tables(Smem& sm, int lb, int w, int r) {
  const int nl = lb < kLaneBits ? lb : kLaneBits, nh = lb - nl;
  int4 x = make_int4(0, 0, 0, 0);
  if (r < kPer) {
    for (int j = 0; j < nh; ++j) {
      if ((r >> j) & 1) x = add4(x, sm.bit[w][sm.lbit[kLaneBits + j]]);
    }
    const int4 ac = sm.ac[w];
    sm.h4[w][r] = make_int4(x.x + ac.x, x.x + x.y + ac.y, x.x + x.z + ac.z, x.x + x.y + x.z + ac.w);
    sm.hrank[w][r] = x.w;
    return;
  }
  if (r >= 3 * kPer) {
    const int q = (r - 3 * kPer) >> 4;
    for (uint32_t m = deposit((uint32_t)(r & 15) << (4 * q), sm.nontile); m != 0; m &= m - 1) {
      x = add4(x, sm.bit[w][__ffs(m) - 1]);
    }
    sm.nt4[w][q][r & 15] = x;
    return;
  }
  const int half = (r - kPer) >> 4, v = r & 15;
  if (half == 0) x = sm.wb[w];
  for (int j = 0; j < 4; ++j) {
    if (((v >> j) & 1) && 4 * half + j < nl) x = add4(x, sm.bit[w][sm.lbit[4 * half + j]]);
  }
  sm.lo4[w][half][v] = x;
}

// The general path's tables for one pass of column c of block b that folds
// the slots `fold` (entry 1 of the column tables), and where the fold meets
// ties (tie_keys) column c - 1's rank tables.  Every thread of the CTA calls
// it (three barriers).
__device__ void build(const Args& a, Smem& sm, int b, int c, uint32_t fold, bool tie_keys) {
  const int K = a.K, tid = threadIdx.x, lb = K < kTileBits ? K : kTileBits;
  __syncthreads();  // the tables of the previous tiles are no longer read
  stage_columns(a, sm, b, c, 1, 1);
  if (tie_keys) {
    for (int k = tid; k < K; k += kThreads) sm.bit[0][k].w = (int)__ldg(a.rankw + ((size_t)b * a.C + c - 1) * K + k);
  }
  if (tid == 0) layout(sm, K, fold);
  __syncthreads();
  if (tid < kTasks) column_tables(sm, lb, 1, tid);
  if (tid < 48) sm.ntoff[tid >> 4][tid & 15] = (int)deposit((uint32_t)(tid & 15) << (4 * (tid >> 4)), sm.nontile);
  if (tid < kPer) {
    uint32_t o = 0;
    for (int j = 0; j < lb - kLaneBits; ++j) o |= (uint32_t)((tid >> j) & 1) << sm.lbit[kLaneBits + j];
    sm.hoff[tid] = (int)o;
  }
  if (tie_keys) {
    const uint32_t all = (uint32_t)(((uint64_t)1 << K) - 1);
    for (int e = tid; e < 3 * kRows; e += kThreads) {
      const int j = e / kRows, v = e % kRows;
      int r = 0;
      for (uint32_t bits = ((uint32_t)v << (kChunk * j)) & all; bits != 0; bits &= bits - 1) {
        r += sm.bit[0][__ffs(bits) - 1].w;
      }
      sm.rank_prev[j][v] = r;
    }
  }
  __syncthreads();
}

// The window path's tables for block b at the window's columns c0 .. c0 +
// win - 1: each column's (and, with tables past column 0, the one before's),
// the tile bits (the window's dying slots, all on a thread's states) and
// each column's dying slots as bits of a thread's state index.  Every thread
// of the CTA calls it (four barriers).
template <bool kTab>
__device__ void build_window(const Args& a, Smem& sm, int b, int c0, int win) {
  const int K = a.K, tid = threadIdx.x, lb = K < kTileBits ? K : kTileBits;
  __syncthreads();  // the tables of the previous tiles are no longer read
  const int w0 = kTab && c0 > 0 ? 0 : 1;
  stage_columns(a, sm, b, c0 + w0 - 1, w0, win + 1 - w0);
  if (tid < win) sm.dmask[tid + 1] = (uint32_t)__ldcg(a.masks + (size_t)b * a.C + c0 + tid);
  __syncthreads();
  if (tid == 0) {
    uint32_t fold = 0;
    for (int w = 1; w <= win; ++w) fold |= sm.dmask[w];
    layout(sm, K, fold);
    for (int w = 1; w <= win; ++w) {
      uint32_t d = 0;
      for (int j = 0; j < sm.nfold; ++j) d |= ((sm.dmask[w] >> sm.lbit[kLaneBits + j]) & 1) << j;
      sm.dmask[w] = d;
    }
  }
  __syncthreads();
  for (int e = tid; e < (win + 1 - w0) * kTasks; e += kThreads) column_tables(sm, lb, w0 + e / kTasks, e % kTasks);
  if (tid < 48) sm.ntoff[tid >> 4][tid & 15] = (int)deposit((uint32_t)(tid & 15) << (4 * (tid >> 4)), sm.nontile);
  if (tid < kPer) {
    uint32_t o = 0;
    for (int j = 0; j < lb - kLaneBits; ++j) o |= (uint32_t)((tid >> j) & 1) << sm.lbit[kLaneBits + j];
    sm.hoff[tid] = (int)o;
  }
  __syncthreads();
}

// The thread's state bits (the tile's low local bits) after a build.
__device__ __forceinline__ uint32_t lane_off(const Smem& sm, int nl) {
  uint32_t o = 0;
  for (int j = 0; j < nl; ++j) o |= (uint32_t)((threadIdx.x >> j) & 1) << sm.lbit[j];
  return o;
}

// The state bits of tile u that are no tile bit (at most 11: K <= 23).
__device__ __forceinline__ uint32_t tile_base(const Smem& sm, uint32_t u) {
  return (uint32_t)(sm.ntoff[0][u & 15] | sm.ntoff[1][(u >> 4) & 15] | sm.ntoff[2][(u >> 8) & 15]);
}

// The sums {s0, d_0, d_1, rank} of entry w over the thread's bits and the
// common bits of tile u.
__device__ __forceinline__ int4 common_sums(const Smem& sm, int w, uint32_t u) {
  const int4 x = add4(sm.lo4[w][0][threadIdx.x & 15], sm.lo4[w][1][(threadIdx.x >> 4) & 15]);
  return add4(add4(x, sm.nt4[w][0][u & 15]), add4(sm.nt4[w][1][(u >> 4) & 15], sm.nt4[w][2][(u >> 8) & 15]));
}

// The new cost of a state: the column cost, min over the four assignments of
// the common part a4 plus the state's h (acost included), saturated at INF,
// added to the folded cost.
__device__ __forceinline__ int new_cost(int4 a4, int4 h, int cv) {
  const int cc = min(min(min(a4.x + h.x, a4.y + h.y), min(a4.z + h.z, a4.w + h.w)), kInf);
  return min(cc + min(cv, kInf), kInf);
}

__device__ __forceinline__ int4 assignments(int4 x) { return make_int4(x.x, x.x + x.y, x.x + x.z, x.x + x.y + x.z); }

// The general path's rank sum of a source index over column c - 1's rank
// weights (its tie key is the inverse Gray code of it).
__device__ __forceinline__ int rank_sum(const Smem& sm, uint32_t src) {
  return sm.rank_prev[0][src & (kRows - 1)] + sm.rank_prev[1][(src >> kChunk) & (kRows - 1)] +
         sm.rank_prev[2][src >> (2 * kChunk)];
}

// The order of the carried tie keys at two states (column 0; 0 for both
// without a carry): -1, 0 or 1.
__device__ __forceinline__ int key0_order(const Args& a, size_t boff, uint32_t s1, uint32_t s0) {
  if (a.key0 == nullptr) return 0;
  const int k1 = __ldg(a.key0 + boff + s1), k0 = __ldg(a.key0 + boff + s0);
  return k1 < k0 ? -1 : k1 > k0 ? 1 : 0;
}

// Whether (c1, i1) comes before (c0, i0) under (cost, tie key, source index),
// the keys compared only where the costs tie: column c - 1's inverse Gray
// rank of the source index, or the carried key at column 0.
__device__ __forceinline__ bool before(const Args& a, const Smem& sm, size_t boff, int c, int c1, int i1, int c0,
                                       int i0) {
  if (c1 != c0) return c1 < c0;
  const int o = c > 0 ? gray_order(rank_sum(sm, (uint32_t)i1), rank_sum(sm, (uint32_t)i0), a.K)
                      : key0_order(a, boff, (uint32_t)i1, (uint32_t)i0);
  return o != 0 ? o < 0 : i1 < i0;
}

// The window path's costs of a tile at the window's start (the thread's
// states base | hoff[i]): the previous column's, or at column 0 the carry or
// zero.
__device__ __forceinline__ void load_window(const Args& a, const Smem& sm, size_t boff, int c0, uint32_t base,
                                            int ni, int (&cv)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (i >= ni) continue;
    const uint32_t s = base | (uint32_t)sm.hoff[i];
    cv[i] = c0 > 0 ? __ldcg(a.cost + boff + s) : a.cost0 != nullptr ? __ldg(a.cost0 + boff + s) : 0;
  }
}

// The source of a thread's state i in the window path: 4 bits a state.
__device__ __forceinline__ int nib(uint64_t v, int i) { return (int)((v >> (4 * i)) & 15); }
__device__ __forceinline__ uint64_t set_nib(uint64_t v, int i, int x) {
  return (v & ~((uint64_t)15 << (4 * i))) | ((uint64_t)x << (4 * i));
}

// The window path: the tile of block b whose thread's states are base |
// hoff[i], costs cv (loaded), through the window's columns, the costs in
// registers from the first column's fold to the last column's cost.  A
// column folds its dying slots among a thread's 16 states; the source of
// state i is the thread's state nib(iv, i), its tie key the inverse Gray
// rank of column c - 1 there, from the common part (xr) and the state's
// (hrank), or the carried key at column 0.
template <bool kTab>
__device__ __forceinline__ void run_window(const Args& a, const Smem& sm, int b, int c0, int win, uint32_t u,
                                           uint32_t base, int ni, int (&cv)[kPer]) {
  const int K = a.K;
  const size_t S = (size_t)1 << K, boff = (size_t)b * S;
  int xr = kTab && c0 > 0 && sm.dmask[1] != 0 ? common_sums(sm, 0, u).w : 0;
  for (int w = 1; w <= win; ++w) {
    const int c = c0 + w - 1;
    const uint32_t dm = sm.dmask[w];
    uint64_t iv = 0xfedcba9876543210ull;  // the identity
    if (dm != 0) {
#pragma unroll
      for (int j = 0; j < kRegBits; ++j) {
        if (!((dm >> j) & 1)) continue;
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          if (((m >> j) & 1) || m >= ni) continue;
          const int m1 = m | (1 << j);
          if (kTab) {
            const int i0 = nib(iv, m), i1 = nib(iv, m1);
            bool partner = cv[m1] < cv[m];
            if (cv[m1] == cv[m]) {
              const int h1 = sm.hoff[i1], h0 = sm.hoff[i0];
              const int o = c > 0 ? gray_order(xr + sm.hrank[w - 1][i1], xr + sm.hrank[w - 1][i0], K)
                                  : key0_order(a, boff, base | (uint32_t)h1, base | (uint32_t)h0);
              partner = o != 0 ? o < 0 : h1 < h0;
            }
            if (partner) {
              cv[m] = cv[m1];
              iv = set_nib(iv, m, i1);
            } else {
              cv[m1] = cv[m];
              iv = set_nib(iv, m1, i0);
            }
          } else {
            cv[m] = cv[m1] = min(cv[m], cv[m1]);
          }
        }
      }
    }
    const int4 x = common_sums(sm, w, u);
    const int4 a4 = assignments(x);
    int* row = kTab ? a.pidx + ((size_t)b * a.C + c) * S : nullptr;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i >= ni) continue;
      if (kTab) __stcs(row + (base | (uint32_t)sm.hoff[i]), (int)(base | (uint32_t)sm.hoff[nib(iv, i)]));
      cv[i] = new_cost(a4, sm.h4[w][i], cv[i]);
    }
    xr = x.w;
  }
  const bool last = c0 + win == a.C;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (i >= ni) continue;
    const uint32_t s = base | (uint32_t)sm.hoff[i];
    __stcg(a.cost + boff + s, cv[i]);
    if (last) a.key_last[boff + s] = inverse_gray(xr + sm.hrank[win][i], K);
  }
}

// The general path: one tile u of block b at one pass of column c (a column
// where some block folds more slots than a thread's states hold, across
// threads through shared memory, or more than a tile's, in a pre-pass
// first): load, fold, then either write the folded state back (a pre-pass)
// or, on the column's last pass (final_pass), write the table row, add the
// column cost and write the new state, and after the last column the key.
// `first`: the block's first pass of the column (the state is the previous
// column's, or at column 0 the carry or zero, and the source index the
// identity).
template <bool kTab>
__device__ __forceinline__ void run_tile(const Args& a, Smem& sm, int b, int c, size_t u, bool first,
                                         bool final_pass, uint32_t lane_bits) {
  const int K = a.K, tid = threadIdx.x;
  const size_t S = (size_t)1 << K, boff = (size_t)b * S;
  const int lb = K < kTileBits ? K : kTileBits, nl = lb < kLaneBits ? lb : kLaneBits;
  const int ni = 1 << (lb - nl);            // states a thread holds
  const bool active = tid < (1 << nl);      // the thread holds states
  int* plane = a.cost + boff;
  int* row = kTab ? a.pidx + ((size_t)b * a.C + c) * S : nullptr;
  const bool from_src = c == 0 && first;  // the state is still cost0 (or zero)
  const int* cost0 = a.cost0 != nullptr ? a.cost0 + boff : nullptr;
  const uint32_t base = tile_base(sm, (uint32_t)u) | lane_bits;

  // a thread's state i is base | hoff[i] (not kept: registers are scarce)
  int cv[kPer], iv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (!active || i >= ni) continue;
    const uint32_t s = base | (uint32_t)sm.hoff[i];
    cv[i] = from_src ? (cost0 != nullptr ? __ldg(cost0 + s) : 0) : __ldcg(plane + s);
    if (kTab) iv[i] = first ? (int)s : __ldcg(row + s);
  }
  const int nf = sm.nfold;
  if (nf > 0) {
    // the fold over the slots on a thread's states, in registers: both
    // partners of each pair take the one that comes first
    const int nreg = sm.nreg;
    if (active) {
#pragma unroll
      for (int j = 0; j < kRegBits; ++j) {
        if (j >= nreg) break;
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          if (((m >> j) & 1) || m >= ni) continue;
          const int m1 = m | (1 << j);
          if (kTab) {
            if (before(a, sm, boff, c, cv[m1], iv[m1], cv[m], iv[m])) {
              cv[m] = cv[m1];
              iv[m] = iv[m1];
            } else {
              cv[m1] = cv[m];
              iv[m1] = iv[m];
            }
          } else {
            cv[m] = cv[m1] = min(cv[m], cv[m1]);
          }
        }
      }
    }
    // the slots on the thread index (where more die than a thread's states
    // hold, whose fold left all its states equal): the least over the
    // threads of the coset, through shared memory
    const uint32_t tm = sm.tmask;
    if (tm != 0) {
      __syncthreads();  // the previous tile's values are no longer read
      if (active) {
        sm.red_c[tid] = cv[0];
        if (kTab) sm.red_i[tid] = iv[0];
      }
      __syncthreads();
      if (active) {
        int bc = cv[0], bi = kTab ? iv[0] : 0;
        const uint32_t own = (uint32_t)tid & ~tm;
        for (uint32_t sub = tm;; sub = (sub - 1) & tm) {
          const int t2 = (int)(own | sub);
          if (t2 != tid) {
            const int c2 = sm.red_c[t2];
            if (kTab) {
              const int i2 = sm.red_i[t2];
              if (before(a, sm, boff, c, c2, i2, bc, bi)) {
                bc = c2;
                bi = i2;
              }
            } else {
              bc = min(bc, c2);
            }
          }
          if (sub == 0) break;
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          cv[i] = bc;
          if (kTab) iv[i] = bi;
        }
      }
    }
  }
  if (!active) return;
  if (!final_pass) {
    // a pre-pass: the folded state back to the plane, the source index to
    // the table row
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i >= ni) continue;
      const uint32_t s = base | (uint32_t)sm.hoff[i];
      __stcg(plane + s, cv[i]);
      if (kTab) __stcg(row + s, iv[i]);
    }
    return;
  }
  const int4 x = common_sums(sm, 1, (uint32_t)u);
  const int4 a4 = assignments(x);
  const bool last = c == a.C - 1;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (i >= ni) continue;
    const uint32_t s = base | (uint32_t)sm.hoff[i];
    if (kTab) __stcs(row + s, iv[i]);
    __stcg(plane + s, new_cost(a4, sm.h4[1][i], cv[i]));
    if (last) a.key_last[boff + s] = inverse_gray(x.w + sm.hrank[1][i], K);
  }
}

// Warp 0: the window that starts at column c0 for the group's blocks g0 ..
// g0 + nb - 1 into sm.win and sm.windowed.  It takes the window path where
// every block's dying slots at c0 fit a thread's register bits (nh), and
// then as many columns (up to kWin) as keep each block's union of them
// there; otherwise c0 alone takes the general path.
__device__ void next_window(const Args& a, Smem& sm, int g0, int nb, int c0, int nh) {
  const int lane = threadIdx.x & 31, C = a.C;
  uint32_t m[kWin];
#pragma unroll
  for (int w = 0; w < kWin; ++w) {
    m[w] = lane < nb && c0 + w < C ? (uint32_t)__ldcg(a.masks + (size_t)(g0 + lane) * C + c0 + w) : 0;
  }
  const bool windowed = __all_sync(0xffffffffu, nb <= 32 && __popc(m[0]) <= nh);
  int win = 1;
  if (windowed) {
    uint32_t fold = m[0];
#pragma unroll
    for (int w = 1; w < kWin; ++w) {
      if (c0 + w >= C || !__all_sync(0xffffffffu, __popc(fold | m[w]) <= nh)) break;
      fold |= m[w];
      win = w + 1;
    }
  }
  if (lane == 0) {
    sm.win = win;
    sm.windowed = windowed;
  }
}

// Two CTAs an SM: a thread is held to 128 registers.
template <bool kTab>
__global__ void __launch_bounds__(kThreads, 2) forward_t1_wide_kernel(Args a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, C = a.C, K = a.K;
  const int lb = K < kTileBits ? K : kTileBits, nl = lb < kLaneBits ? lb : kLaneBits;

  // prologue: a warp a column gathers every block's dying slots there and
  // the column's pre-passes, the most any block needs
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
  grid.sync();

  // the groups of the L2 sweep; in each, every window of columns over the
  // group's tiles (block, coset of the tile bits), the same split in each
  const size_t per_block = (size_t)1 << (K - lb);
  const int group = blocks_a_group(K, B);
  for (int g0 = 0; g0 < B; g0 += group) {
    const int nb = min(group, B - g0);
    const size_t n_tiles = (size_t)nb * per_block;
    const size_t t0 = n_tiles * blockIdx.x / gridDim.x, t1 = n_tiles * (blockIdx.x + 1) / gridDim.x;
    for (int c0 = 0; c0 < C;) {
      if (threadIdx.x < 32) next_window(a, sm, g0, nb, c0, lb - nl);
      __syncthreads();
      const int win = sm.win;
      if (sm.windowed) {
        int built = -1;  // the block whose tables the CTA holds
        uint32_t lane_bits = 0;
        for (size_t t = t0; t < t1; ++t) {
          const int b = g0 + (int)(t / per_block);
          if (b != built) {
            build_window<kTab>(a, sm, b, c0, win);
            built = b;
            lane_bits = lane_off(sm, nl);
          }
          if (threadIdx.x >= (1 << nl)) continue;  // the thread holds no state
          const uint32_t u = (uint32_t)(t % per_block), base = tile_base(sm, u) | lane_bits;
          int cv[kPer];
          load_window(a, sm, (size_t)b << K, c0, base, 1 << (lb - nl), cv);
          run_window<kTab>(a, sm, b, c0, win, u, base, 1 << (lb - nl), cv);
        }
        grid.sync();
        c0 += win;
        continue;
      }
      // the general path: column c0 in its passes
      const int c = c0++;
      const int np = __ldcg(a.npass + c);
      for (int p = 0; p <= np; ++p) {
        const bool final_pass = p == np;
        int built = -1, seen = -1;  // the block whose tables the CTA holds; whose mask
        uint32_t mask = 0, lane_bits = 0;
        for (size_t t = t0; t < t1; ++t) {
          const int b = g0 + (int)(t / per_block);
          if (b != seen) {
            mask = (uint32_t)__ldcg(a.masks + (size_t)b * C + c);
            seen = b;
          }
          const int nd = __popc(mask), pre = pre_passes(nd, lb);
          uint32_t fold;
          bool first;
          if (final_pass) {
            fold = slot_range(mask, max(nd - lb, 0), nd);
            first = pre == 0;
          } else {
            const int gi = p - (np - pre);  // the block's pre-passes end with the column's
            if (gi < 0) continue;
            fold = slot_range(mask, gi * lb, min((gi + 1) * lb, nd - lb));
            first = gi == 0;
          }
          if (b != built) {
            build(a, sm, b, c, fold, kTab && c > 0 && fold != 0);
            built = b;
            lane_bits = lane_off(sm, nl);
          }
          run_tile<kTab>(a, sm, b, c, t % per_block, first, final_pass, lane_bits);
        }
        grid.sync();
      }
    }
  }
}

template <bool kTab>
int launch(const Args& a, cudaStream_t stream) {
  if (a.B < 1 || a.C < 1 || a.K < 1 || a.K > kMaxK) return (int)cudaErrorInvalidValue;
  auto kernel = forward_t1_wide_kernel<kTab>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // as many CTAs as the card keeps resident, and no more than a group's tiles
  const int lb = a.K < kTileBits ? a.K : kTileBits;
  const size_t tiles = (size_t)blocks_a_group(a.K, a.B) << (a.K - lb);
  const size_t resident = (size_t)sms * per_sm;
  const size_t grid = tiles < resident ? tiles : resident;
  Args args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)grid), dim3(kThreads), params, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Tables mode.  cost0 and key0 (B, 2^K) carry a state in, or are null for a
// zero state.  scratch holds B*C + C ints (any contents).
extern "C" int wmec_forward_t1_wide(const float* wdiff, const int* wbase, const float* rankw,
                                    const int* acost, const uint8_t* die, const int* cost0,
                                    const int* key0, int* pidx, int* dp_last, int* key_last,
                                    int* scratch, int B, int C, int K, cudaStream_t stream) {
  Args a{wdiff, wbase, rankw, acost, die, cost0, key0, pidx, dp_last, key_last,
         scratch, scratch + (size_t)B * C, B, C, K};
  return launch<true>(a, stream);
}

// Carry mode: no table; dp_last and key_last are the carry after the last
// column, and must not alias cost0 and key0 (a checkpoint is read again).
// Only the carried cost0 is read: key0 breaks fold ties, which the min fold
// does not need (it stays in the signature, which is the tables mode's).
extern "C" int wmec_forward_carry_t1_wide(const float* wdiff, const int* wbase, const float* rankw,
                                          const int* acost, const uint8_t* die, const int* cost0,
                                          const int* key0, int* dp_last, int* key_last, int* scratch,
                                          int B, int C, int K, cudaStream_t stream) {
  (void)key0;
  Args a{wdiff, wbase, rankw, acost, die, cost0, nullptr, nullptr, dp_last, key_last,
         scratch, scratch + (size_t)B * C, B, C, K};
  return launch<false>(a, stream);
}

// Blocks a group of the L2 sweep at K in a launch of B blocks
// (wmec_cuda.forward_t1_wide_group mirrors it).
extern "C" int wmec_forward_t1_wide_group(int K, int B) {
  return K < 1 || K > kMaxK || B < 1 ? 0 : blocks_a_group(K, B);
}

extern "C" const char* wmec_forward_t1_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
