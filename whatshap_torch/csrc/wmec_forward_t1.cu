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
// One CTA per block b runs the whole column loop: the TPU's sequential grid
// axis becomes that loop, since CTAs run in no order.  The state starts as
// the carry (cost0, key0), or zero where those pointers are null.  Per
// column c, over the 2^K bipartitions i of the block's read slots:
//
//   fold  for every slot p that died before c, the pair (i, i | 1<<p) takes
//         the winner under (cost, tie key) order, b winning only when it is
//         strictly better; BOTH partners receive the winner's cost, key and
//         source index (the reference's forward projection).  The carry mode
//         keeps no table, and the winner's cost is the pair's minimum
//         whichever wins a tie, so there the fold is a min of the costs;
//   emit  pidx[b, c, i] = source index, the backtrace table (tables mode);
//   cost  f_j = sum_k bit_k(i) * wdiff[k, j] (j = 2p + allele), cp = f + wbase,
//         s0 = cp[0][0] + cp[1][0], d_p = cp[p][1] - cp[p][0];
//         dp = min(min_a min(s0 + sum_{p in a} d_p + acost_a, INF) + folded, INF);
//   key   inverse Gray code of sum_k bit_k(i) * rankw[k].
//
// T = 1 has no transmission state, so the recombination cost plays no part.
// All arithmetic is int32, as in the reference (the weights are integers, so
// the reference's f32 sums are exact and equal these).
//
// Bound: in the tables mode the table write, B*C*2^K*4 bytes.  The function
// needs about 5*B*C*2^K int32 adds besides: the four cost sums and the key
// sum change by one slot's weight from a state to its Gray-order neighbour.
// At the slice's K = 15 (B = 256, C = 512) that is 17.2 GB written (5.1 ms at
// 3.35 TB/s) against 21.5 G adds (1.3 ms at 64 int32 lanes per SM), so the
// bytes bound it.  The carry mode writes only the final state, so the same
// adds bound it (a 2048-column segment at K = 15: 0.34 G adds, 0.02 ms).
// The design is the simple one: the state (cost, key, idx: 12 * 2^K bytes)
// sits in dynamic shared memory up to K = 14 (192 KB) and in a per-block
// global scratch above it, up to K = 17 (1.5 MB); every fold is one pass over
// the state with a barrier after it; each state's sums are taken over its K
// bits, K times the adds the function needs.  Warp-shuffle folds for the low
// bits, cluster shared memory for K = 15-17 and incremental (Gray-order) sums
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kMaxK = 17;
constexpr int kSmemMaxK = 14;
constexpr int kThreads = 512;

template <bool kShared, bool kTables>
__global__ void __launch_bounds__(kThreads) forward_t1_kernel(
    const float* __restrict__ wdiff,   // (B, C, K, 4)
    const int* __restrict__ wbase,     // (B, C, 4)
    const float* __restrict__ rankw,   // (B, C, K)
    const int* __restrict__ acost,     // (B, C, 4)
    const uint8_t* __restrict__ die,   // (B, C, K)
    const int* __restrict__ cost0,     // (B, S) or null: the carried cost
    const int* __restrict__ key0,      // (B, S) or null: the carried tie key
    int* __restrict__ pidx,            // (B, C, S), tables mode
    int* __restrict__ dp_last,         // (B, S)
    int* __restrict__ key_last,        // (B, S)
    int* __restrict__ scratch,         // (B, 3, S), used when !kShared
    int C, int K) {
  extern __shared__ int smem[];
  __shared__ int s_wd[kMaxK * 4];
  __shared__ int s_rw[kMaxK];
  __shared__ int s_die[kMaxK];
  __shared__ int s_wb[4];
  __shared__ int s_ac[4];

  const int S = 1 << K;
  const int b = blockIdx.x;
  int* state = kShared ? smem : scratch + (size_t)b * 3 * S;
  int* cost = state;
  int* key = state + S;
  int* idx = state + 2 * S;

  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    cost[i] = cost0 != nullptr ? cost0[(size_t)b * S + i] : 0;
    key[i] = key0 != nullptr ? key0[(size_t)b * S + i] : 0;
  }

  for (int c = 0; c < C; ++c) {
    const size_t col = (size_t)b * C + c;
    // ---- stage the column's inputs; the projection index starts as identity
    for (int t = threadIdx.x; t < 4 * K; t += blockDim.x) s_wd[t] = (int)wdiff[col * 4 * K + t];
    for (int t = threadIdx.x; t < K; t += blockDim.x) {
      s_rw[t] = (int)rankw[col * K + t];
      s_die[t] = die[col * K + t];
    }
    if (threadIdx.x < 4) {
      s_wb[threadIdx.x] = wbase[col * 4 + threadIdx.x];
      s_ac[threadIdx.x] = acost[col * 4 + threadIdx.x];
    }
    if (kTables) {
      for (int i = threadIdx.x; i < S; i += blockDim.x) idx[i] = i;
    }
    __syncthreads();

    // ---- fold dying slot bits (s_die is uniform, so is the branch)
    for (int p = 0; p < K; ++p) {
      if (!s_die[p]) continue;
      const int lo = (1 << p) - 1;
      for (int q = threadIdx.x; q < (S >> 1); q += blockDim.x) {
        const int i0 = ((q & ~lo) << 1) | (q & lo);  // bit p = 0
        const int i1 = i0 | (1 << p);                 // bit p = 1
        const int a_c = cost[i0], b_c = cost[i1];
        if (kTables) {
          const int a_k = key[i0], b_k = key[i1];
          const bool take_b = (b_c < a_c) || (b_c == a_c && b_k < a_k);
          const int w_c = take_b ? b_c : a_c;
          const int w_k = take_b ? b_k : a_k;
          const int w_i = take_b ? idx[i1] : idx[i0];
          cost[i0] = w_c;
          cost[i1] = w_c;
          key[i0] = w_k;
          key[i1] = w_k;
          idx[i0] = w_i;
          idx[i1] = w_i;
        } else {
          // the folded key and index feed only the table: the cost is the min
          const int w_c = min(a_c, b_c);
          cost[i0] = w_c;
          cost[i1] = w_c;
        }
      }
      __syncthreads();
    }

    // ---- emit the table, then cost and key; each thread on its own states
    int* pidx_col = kTables ? pidx + col * S : nullptr;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      if (kTables) pidx_col[i] = idx[i];
      int f0 = 0, f1 = 0, f2 = 0, f3 = 0, r = 0;
      for (int k = 0; k < K; ++k) {
        if ((i >> k) & 1) {
          f0 += s_wd[4 * k + 0];
          f1 += s_wd[4 * k + 1];
          f2 += s_wd[4 * k + 2];
          f3 += s_wd[4 * k + 3];
          r += s_rw[k];
        }
      }
      const int cp00 = f0 + s_wb[0];  // partition 0, allele 0
      const int cp01 = f1 + s_wb[1];  // partition 0, allele 1
      const int cp10 = f2 + s_wb[2];  // partition 1, allele 0
      const int cp11 = f3 + s_wb[3];  // partition 1, allele 1
      const int s0 = cp00 + cp10;
      const int d0 = cp01 - cp00;
      const int d1 = cp11 - cp10;
      // assignment a: bit p of a puts allele 1 on partition p
      const int t0 = min(s0 + s_ac[0], kInf);
      const int t1 = min(s0 + d0 + s_ac[1], kInf);
      const int t2 = min(s0 + d1 + s_ac[2], kInf);
      const int t3 = min(s0 + (d0 + d1) + s_ac[3], kInf);
      const int best = min(min(t0, t1), min(t2, t3));
      cost[i] = min(best + cost[i], kInf);
      int n = r;
      for (int sh = 1; sh < K; sh <<= 1) n ^= n >> sh;
      key[i] = n;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    dp_last[(size_t)b * S + i] = cost[i];
    key_last[(size_t)b * S + i] = key[i];
  }
}

template <bool kTables>
int launch(const float* wdiff, const int* wbase, const float* rankw, const int* acost,
           const uint8_t* die, const int* cost0, const int* key0, int* pidx, int* dp_last,
           int* key_last, int* scratch, int B, int C, int K, cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const int S = 1 << K;
  const int threads = S < kThreads ? (S < 32 ? 32 : S) : kThreads;
  if (K <= kSmemMaxK) {
    const int smem = 3 * S * (int)sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        forward_t1_kernel<true, kTables>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    forward_t1_kernel<true, kTables><<<B, threads, smem, stream>>>(
        wdiff, wbase, rankw, acost, die, cost0, key0, pidx, dp_last, key_last, nullptr, C, K);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    forward_t1_kernel<false, kTables><<<B, threads, 0, stream>>>(
        wdiff, wbase, rankw, acost, die, cost0, key0, pidx, dp_last, key_last, scratch, C, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Tables mode.  cost0 and key0 (B, 2^K) carry a state in, or are null for a
// zero state.
extern "C" int wmec_forward_t1(const float* wdiff, const int* wbase, const float* rankw,
                               const int* acost, const uint8_t* die, const int* cost0,
                               const int* key0, int* pidx, int* dp_last, int* key_last,
                               int* scratch, int B, int C, int K, cudaStream_t stream) {
  return launch<true>(wdiff, wbase, rankw, acost, die, cost0, key0, pidx, dp_last, key_last,
                      scratch, B, C, K, stream);
}

// Carry mode: no table; dp_last and key_last are the carry after the last
// column, and must not alias cost0 and key0 (a checkpoint is read again).
extern "C" int wmec_forward_carry_t1(const float* wdiff, const int* wbase, const float* rankw,
                                     const int* acost, const uint8_t* die, const int* cost0,
                                     const int* key0, int* dp_last, int* key_last, int* scratch,
                                     int B, int C, int K, cudaStream_t stream) {
  return launch<false>(wdiff, wbase, rankw, acost, die, cost0, key0, nullptr, dp_last, key_last,
                       scratch, B, C, K, stream);
}

extern "C" const char* wmec_forward_t1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
