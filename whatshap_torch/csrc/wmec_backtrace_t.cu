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
// the host stitch of the pedigree route chains on).
//
// Bound: the walk moves B*M*C*16 bytes (two gathered table entries and two
// path entries per column), but each gather depends on the one before, so a
// walk is a chain of 2*C memory latencies.  One thread walks one path and all
// B*M walks run at once, as in the T=1 backtrace.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void backtrace_t_kernel(const int* __restrict__ init,   // (W, 3)
                                   const int* __restrict__ pidx,   // (B, C, T, S)
                                   const int* __restrict__ pjmin,  // (B, C, T, S)
                                   int* __restrict__ path,         // (W, C)
                                   int* __restrict__ tpath,        // (W, C)
                                   int* __restrict__ final_state,  // (W, 3)
                                   int W, int M, int C, int T, int K) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const size_t S = (size_t)1 << K;
  const size_t block = (size_t)(w / M) * C * T * S;
  const int* pi = pidx + block;
  const int* pj = pjmin + block;
  int* out = path + (size_t)w * C;
  int* tout = tpath + (size_t)w * C;
  int v = init[3 * w], vt = init[3 * w + 1], pt = init[3 * w + 2];
  for (int c = C - 1; c >= 0; --c) {
    out[c] = v;
    tout[c] = vt;
    const size_t col = (size_t)c * T;
    v = __ldg(pi + (col + pt) * S + v);
    vt = pt;
    pt = __ldg(pj + (col + vt) * S + v);
  }
  final_state[3 * w] = v;
  final_state[3 * w + 1] = vt;
  final_state[3 * w + 2] = pt;
}

}  // namespace

extern "C" int wmec_backtrace_t(const int* init, const int* pidx, const int* pjmin, int* path,
                                int* tpath, int* final_state, int B, int M, int C, int T, int K,
                                cudaStream_t stream) {
  if (B < 1 || M < 1 || C < 1 || T < 1 || K < 1 || K > 30) return (int)cudaErrorInvalidValue;
  const int W = B * M;
  const int blocks = (W + kThreads - 1) / kThreads;
  backtrace_t_kernel<<<blocks, kThreads, 0, stream>>>(init, pidx, pjmin, path, tpath,
                                                      final_state, W, M, C, T, K);
  return (int)cudaGetLastError();
}

extern "C" const char* wmec_backtrace_t_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
