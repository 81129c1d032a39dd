// T=1 wMEC backtrace for Hopper (sm_90a).
//
// Replaces whatshap_tpu/ops/wmec_pallas.py `_make_backtrace_kernel` (launched
// through backtrace_pallas).  From the selected last-column bipartition
// opt[b], walk v <- pidx[b, c, v] from column C-1 down to 0, writing
// path[b, c] = v before each step, and the state after the step through
// column 0 to final[b] (the segmented solve chains segments on it).
//
// Bound: the walk moves B*C*8 bytes (one gathered table entry and one path
// entry per column), but each gather depends on the one before, so a block's
// walk is a chain of C memory latencies.  One thread walks one block and all
// B walks run at once; nothing else is worth doing in a first kernel, as the
// walk is a sliver of the forward scan's time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void backtrace_t1_kernel(const int* __restrict__ opt,   // (B,)
                                    const int* __restrict__ pidx,  // (B, C, S)
                                    int* __restrict__ path,        // (B, C)
                                    int* __restrict__ final_state, // (B,)
                                    int B, int C, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t S = (size_t)1 << K;
  const int* table = pidx + (size_t)b * C * S;
  int* out = path + (size_t)b * C;
  int v = opt[b];
  for (int c = C - 1; c >= 0; --c) {
    out[c] = v;
    v = __ldg(table + (size_t)c * S + v);
  }
  final_state[b] = v;
}

}  // namespace

extern "C" int wmec_backtrace_t1(const int* opt, const int* pidx, int* path, int* final_state,
                                 int B, int C, int K, cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1 || K > 30) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  backtrace_t1_kernel<<<blocks, kThreads, 0, stream>>>(opt, pidx, path, final_state, B, C, K);
  return (int)cudaGetLastError();
}

extern "C" const char* wmec_backtrace_t1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
