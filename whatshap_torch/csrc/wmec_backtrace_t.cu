// General-T (pedigree) wMEC backtrace for Hopper (sm_90a).
//
// Replaces whatshap_tpu/ops/wmec_pallas.py `_make_backtrace_kernel_t`, as
// backtrace_pallas_t (one walk per block) and backtrace_pallas_t_multi (M
// walks per block over the same tables: the head and T seam walks of the
// pedigree route) launch it.  Walk w of a flat B*M grid reads the tables of
// block w / M.  From its start (v, vt, prev_t) it goes from column C-1 down
// to 0, writing path[w, c] = v and tpath[w, c] = vt, then stepping
//
//   v <- pidx[b, c, prev_t, v],  vt <- prev_t,  prev_t <- pjmin[b, c, vt, v]
//
// and writes the triple after the step through column 0 to final[w] (its
// middle element is the transmission before the block's first column, which
// the host stitch of the pedigree route chains on).  die[b, c] holds the
// slots that die before column c (bit k: slot k).  T is any power of two up
// to 1024 (five trios): the walk takes the transmission's log2 T bits into
// its 64-bit table offsets (wmec_walk.cuh), which hold C * T * 2^K entries
// at T = 1024 and K = 23 with room to spare.  The pedigree route's pass 2
// launches T + 1 walks a block: 1,025 warps a block at T = 1024.
//
// Bound: the walk needs two table entries and two path entries a column,
// B*M*C*16 bytes, but each gather depends on the one before (two a column),
// so what bounds it is the card's gather latency times the dependent round
// trips.  Design (the walk itself is in wmec_walk.cuh): a warp a walk;
// pidx and pjmin gathered in the same round trip at the state before the
// step; each round guesses that (index, transmission) carries over for the
// next 8 columns (3 in a launch of more than 8 walks), so that a round trip
// resolves the columns up to the first change, and the pjmin entry after an
// index change is checked by one more load of the next round; path and
// tpath stored as the lanes resolve them, a round's entries contiguous.
// The masks `die` are taken as the T=1 walk takes them, but no guess here
// reads them: guessing the state after a change did not pay at T > 1.

#include "wmec_walk.cuh"

namespace {

using namespace wmec_walk;

template <bool kWide>
__global__ void __launch_bounds__(32)
    backtrace_t_kernel(const int* __restrict__ init,   // (W, 3)
                       const int* __restrict__ pidx,   // (B, C, T, S)
                       const int* __restrict__ pjmin,  // (B, C, T, S)
                       const int* __restrict__ die,    // (B, C)
                       int* __restrict__ path,         // (W, C)
                       int* __restrict__ tpath,        // (W, C)
                       int* __restrict__ final_state,  // (W, 3)
                       int M, int C, int lt, int K) {
  const int w = blockIdx.x;
  const size_t blk = (size_t)(w / M) * C;
  const size_t table = (blk << lt) << K;
  int v = init[3 * w], vt = init[3 * w + 1], pt = init[3 * w + 2];
  walk<false, kWide>(pidx + table, pjmin + table, die + blk, path + (size_t)w * C,
                     tpath + (size_t)w * C, C, K, lt, v, vt, pt);
  if (threadIdx.x == 0) {
    final_state[3 * w] = v;
    final_state[3 * w + 1] = vt;
    final_state[3 * w + 2] = pt;
  }
}

}  // namespace

extern "C" int wmec_backtrace_t(const int* init, const int* pidx, const int* pjmin, const int* die,
                                int* path, int* tpath, int* final_state, int B, int M, int C, int T,
                                int K, cudaStream_t stream) {
  if (B < 1 || M < 1 || C < 1 || T < 2 || T > 1024 || (T & (T - 1)) || K < 1 || K > 30)
    return (int)cudaErrorInvalidValue;
  const int W = B * M, lt = __builtin_ctz(T);
  if (W <= kNarrowWalks)
    backtrace_t_kernel<false><<<W, 32, 0, stream>>>(
        init, pidx, pjmin, die, path, tpath, final_state, M, C, lt, K);
  else
    backtrace_t_kernel<true><<<W, 32, 0, stream>>>(
        init, pidx, pjmin, die, path, tpath, final_state, M, C, lt, K);
  return (int)cudaGetLastError();
}

extern "C" const char* wmec_backtrace_t_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
