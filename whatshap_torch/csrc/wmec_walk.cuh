// The wMEC backtrace walk for Hopper (sm_90a), shared by the T=1 walk
// (wmec_backtrace_t1.cu) and the general-T walk (wmec_backtrace_t.cu).
//
// A walk goes from column C-1 down to 0 over one block's tables.  Its state
// entering column c is (v, vt, pt): the bipartition index, the transmission
// recorded at c, and the preceding transmission the step reads.  It records
// path[c] = v and tpath[c] = vt, then steps
//
//   v <- pidx[c, pt, v],  vt <- pt,  pt <- pjmin[c, vt, v]
//
// (T = 1: one transmission plane, pt = vt = 0 and no pjmin), and ends with
// the state after the step through column 0.  Each step's gather depends on
// the one before, so the first draft (one thread a walk, a gather a column,
// two at T > 1) was a chain of C memory latencies.
//
// What the forward fold guarantees (wmec.py _fold_dying; the reference's
// pedigreedptable.cpp:316-326): pidx[c, t, v] differs from v only in the
// bits of the slots that die before column c, the mask die[c], and pjmin[c,
// t, .] is constant along those bits.  So the state carries over every
// column where no slot dies and about half of those where one does; where
// it changes, the new index is v with a subset of die[c] flipped, most often
// one bit.  On this card a dependent gather costs ~150 ns from L2 and ~300
// ns from device memory (profile_backtrace.py), and every instruction that
// waits on a gather or on another lane (a ballot, a shuffle) costs a lone
// warp tens of cycles, so a round must guess several columns with few such
// instructions.  (Enumerating every state of the next columns, a first
// design, needed ~0.18 round trips a column but ~1.5 us of bit manipulation
// a round, and lost to the first draft; so did four gathers a lane, and a
// CTA of 8 warps a walk.)  The design:
//
//   - A warp walks one path, a CTA of one warp each; one gather a lane a
//     round.
//   - Row 0: lane i < kRow0 gathers column c - i at the current state,
//     guessing that it carries over.  The columns up to the first change
//     are exact (one ballot finds it).  A column where no slot dies never
//     ends the guess: it costs nothing.
//   - T = 1, guessed rows: kGuesses rows of kRowCols lanes guess the state
//     after a change in one of the next columns (kGuessO, kGuessJ: a column
//     of the round and a subset of its mask's two lowest bits, the likeliest
//     first) and gather the columns below it at that state; where the row 0
//     change is one a row guessed, the round goes on to that row's first
//     change.  The rows' gathers take other registers than row 0's, so that
//     the warp never waits on row 0's gather to issue them.
//     At T > 1, where a gather is two loads, guessed rows lost on the card,
//     so the general-T walk guesses row 0 alone and reads no masks.
//   - Exact on any table.  Each gather up to a row's first change is at the
//     true state, so at T = 1 nothing rests on an assumption.  At T > 1 the
//     state after an index change takes pjmin before the step (the fold
//     makes it equal to the entry after it); the next round checks it with
//     one more load, issued with its gathers, before it writes anything, and
//     goes back if it differs.  The masks only choose the guesses.
//   - Coalesced stores: a round's path (and tpath) entries are contiguous,
//     written by the lanes that gathered them.
//
// Bound: each column needs one table entry (two at T > 1) read and one path
// entry (two) written, a few bytes a column; the gather latency times the
// rounds a column bounds the walk (chip_smoke.py prints both).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wmec_walk {

constexpr int kNarrowWalks = 8;   // launches of at most this many walks take the narrow layout
constexpr int kRowCols = 4;       // columns of a guessed row (T = 1)
constexpr int kGuesses = 4;       // guessed rows (T = 1)
// guessed row r: a change at the (kGuessO >> 2r & 3)-th column of the round
// to v with subset (kGuessJ >> 2r & 3) of the column's mask flipped (1: its
// lowest bit, 2: the next, 3: both), the likeliest first
constexpr unsigned kGuessO = 0b10'00'01'00;  // rows 3..0: o = 2, 0, 1, 0
constexpr unsigned kGuessJ = 0b01'10'01'01;  // rows 3..0: j = 1, 2, 1, 1
constexpr unsigned kFull = 0xffffffffu;

// The lanes of row 0: at T = 1 six (and the guessed rows); at T > 1, where
// a gather is two, eight in a narrow launch and three in a wide one (more
// than kNarrowWalks walks, which share the card's memory system), as
// profile_backtrace.py measured them.
__host__ __device__ constexpr int row0_lanes(bool t1, bool wide) { return t1 ? 6 : (wide ? 3 : 8); }

// Subset j (1, 2 or 3) of the two lowest bits of a mask, 0 if it has not
// those bits.
__device__ __forceinline__ unsigned subset(unsigned D, int j) {
  const unsigned low1 = D & (0u - D), low2 = (D ^ low1) & (0u - (D ^ low1));
  if (j > 1 && !low2) return 0u;
  return (j & 1 ? low1 : 0u) | (j & 2 ? low2 : 0u);
}

// One walk by one warp.  pidx/pjmin point at the walk's block's tables (C,
// T, 2^K), die at its masks (C), path/tpath at its outputs (C); (v, vt, pt)
// is the state entering column C - 1, and leaves as the state after the
// step through column 0.
template <bool kT1, bool kWide>
__device__ void walk(const int* __restrict__ pidx, const int* __restrict__ pjmin,
                     const int* __restrict__ die, int* __restrict__ path, int* __restrict__ tpath,
                     int C, int K, int lt, int& v, int& vt, int& pt) {
  constexpr int kRow0 = row0_lanes(kT1, kWide);
  static_assert(kRow0 + kGuesses * kRowCols <= 32, "the guesses fill one warp");
  const int lane = threadIdx.x & 31;
  // this lane's guessed row (T = 1), its place in it, and its guess
  const int g = kT1 && lane >= kRow0 ? (lane - kRow0) / kRowCols : -1;
  const bool guesser = g >= 0 && g < kGuesses;
  const int e = lane < kRow0 ? lane : (lane - kRow0) % kRowCols;
  const int go = guesser ? (kGuessO >> 2 * g) & 3 : 0, gj = guesser ? (kGuessJ >> 2 * g) & 3 : 0;
  auto entry = [&](int col, int t, unsigned u) -> size_t {
    return ((((size_t)col << lt) + t) << K) + u;
  };
  // the masks of two runs of 32 columns in registers, [lo, lo + 32) and the
  // run below (T = 1)
  int lo = (C - 1) & ~31;
  unsigned mA = kT1 && lo + lane < C ? (unsigned)__ldg(die + lo + lane) : 0u;
  unsigned mB = kT1 && lo >= 32 ? (unsigned)__ldg(die + lo - 32 + lane) : 0u;
  // T > 1: the index change whose pt was read before the step, to check
  int chk_col = -1, chk_t = 0, chk_v = 0, chk_b = 0;
  int c = C - 1;
  while (c >= 0) {
    while (kT1 && c < lo) {
      lo -= 32;
      mA = mB;
      mB = lo >= 32 ? (unsigned)__ldg(die + lo - 32 + lane) : 0u;
    }
    // ---- row 0 first: lane i < kRow0 gathers column c - i at the state
    const unsigned V = (unsigned)v;
    int a0 = 0, b0 = 0;  // row 0's gathers (registers of their own)
    if (lane < kRow0 && c - lane >= 0) {
      const size_t at = entry(c - lane, pt, V);
      a0 = __ldg(pidx + at);
      if (!kT1) b0 = __ldg(pjmin + at);
    }
    // T > 1: the last round's index change took pjmin before the step; the
    // entry after it, read in the same round trip
    const int got =
        !kT1 && chk_col >= 0 ? __ldg(pjmin + entry(chk_col, chk_t, (unsigned)chk_v)) : 0;
    // ---- then (T = 1) the lanes of guessed row g: the columns below its
    // change column c - go at v ^ subset gj of that column's mask
    const int dg = c - go;
    unsigned sub = 0;
    int a = 0;
    if (kT1) {
      const int x = dg - lo;
      const unsigned mhi = __shfl_sync(kFull, mA, x & 31), mlo = __shfl_sync(kFull, mB, x & 31);
      sub = guesser && dg >= 1 ? subset(x >= 0 ? mhi : mlo, gj) : 0u;
    }
    const bool on = guesser ? sub && dg - 1 - e >= 0 : lane < kRow0 && c - lane >= 0;
    if (guesser && on) a = __ldg(pidx + entry(dg - 1 - e, 0, V ^ sub));
    // ---- row 0's columns up to the first change are exact
    const unsigned ch0 = __ballot_sync(kFull, lane < kRow0 && on && (a0 != v || (!kT1 && b0 != pt)));
    if (!kT1 && chk_col >= 0) {
      // if the entry after the last change differs, take it and guess again
      chk_col = -1;
      if (got != chk_b) {
        pt = got;
        continue;
      }
    }
    const int n0 = ch0 ? __ffs(ch0) : min(kRow0, c + 1);
    if (lane < n0) {
      path[c - lane] = v;
      if (!kT1) tpath[c - lane] = lane == 0 ? vt : pt;
    }
    if (!kT1) vt = pt;
    if (!ch0) {
      c -= n0;
      continue;
    }
    const int f = n0 - 1, d = c - f;  // the change, at column d
    const int a1 = __shfl_sync(kFull, a0, f), b1 = __shfl_sync(kFull, b0, f);
    c = d - 1;
    if (!kT1) {
      if (a1 != v) chk_col = d, chk_t = pt, chk_v = a1, chk_b = b1;
      v = a1;
      pt = b1;
      continue;
    }
    // ---- T = 1: the row that guessed this change, if any, and its
    // columns up to its own first change
    const bool match = guesser && go == f && dg >= 1 && sub && sub == (unsigned)(a1 ^ v);
    const unsigned rows = __ballot_sync(kFull, match && e == 0);
    const unsigned chg = __ballot_sync(kFull, match && on && a != a1);
    const int base = rows ? __ffs(rows) - 1 : 0;
    if (!rows) {  // no row guessed it: the round ends after the change
      v = a1;
      continue;
    }
    const unsigned ch1 = (chg >> base) & ((1u << kRowCols) - 1);
    const int n1 = ch1 ? __ffs(ch1) : min(kRowCols, d);
    if (match && e < n1) path[d - 1 - e] = a1;
    c = d - 1 - n1;
    v = a1;
    if (!ch1) continue;
    v = __shfl_sync(kFull, a, base + n1 - 1);
  }
  if (!kT1 && chk_col >= 0) {
    const int got = __ldg(pjmin + entry(chk_col, chk_t, (unsigned)chk_v));
    if (got != chk_b) pt = got;
  }
}

}  // namespace wmec_walk
