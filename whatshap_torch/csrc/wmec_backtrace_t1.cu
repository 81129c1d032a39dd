// T=1 wMEC backtrace for Hopper (sm_90a).
//
// Replaces whatshap_tpu/ops/wmec_pallas.py `_make_backtrace_kernel` (launched
// through backtrace_pallas).  From the selected last-column bipartition
// opt[b], walk v <- pidx[b, c, v] from column C-1 down to 0, writing
// path[b, c] = v before each step, and the state after the step through
// column 0 to final[b] (the segmented solve chains segments on it).  die[b,
// c] holds the slots that die before column c (bit k: slot k), the mask the
// forward fold of column c used; it guides the walk and never changes its
// result.
//
// Bound: the walk needs one table entry and one path entry a column, B*C*8
// bytes, but each gather depends on the one before, so what bounds it is the
// card's gather latency times the dependent round trips.  Design (the walk
// itself is in wmec_walk.cuh): a warp a walk; each round gathers the next 6
// columns guessing that the index carries over, and 4 columns after each of
// the 4 likeliest changes among the next three columns (a subset of the
// dying slots flipped), so that a round trip resolves the columns up to the
// first change, and where it was guessed, up to the second; the path is
// stored as the lanes resolve it, a round's entries contiguous.

#include "wmec_walk.cuh"

namespace {

using namespace wmec_walk;

__global__ void __launch_bounds__(32)
    backtrace_t1_kernel(const int* __restrict__ opt,   // (B,)
                        const int* __restrict__ pidx,  // (B, C, S)
                        const int* __restrict__ die,   // (B, C)
                        int* __restrict__ path,        // (B, C)
                        int* __restrict__ final_state, // (B,)
                        int C, int K) {
  const int b = blockIdx.x;
  int v = opt[b], vt = 0, pt = 0;
  // T = 1 takes one layout whatever the launch's width (row0_lanes)
  walk<true, false>(pidx + ((size_t)b * C << K), nullptr, die + (size_t)b * C, path + (size_t)b * C,
                    nullptr, C, K, 0, v, vt, pt);
  if (threadIdx.x == 0) final_state[b] = v;
}

}  // namespace

extern "C" int wmec_backtrace_t1(const int* opt, const int* pidx, const int* die, int* path,
                                 int* final_state, int B, int C, int K, cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1 || K > 30) return (int)cudaErrorInvalidValue;
  backtrace_t1_kernel<<<B, 32, 0, stream>>>(opt, pidx, die, path, final_state, C, K);
  return (int)cudaGetLastError();
}

extern "C" const char* wmec_backtrace_t1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
