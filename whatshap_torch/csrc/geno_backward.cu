// Genotyping forward-backward HMM, backward pass, for Hopper (sm_90a).
//
// Replaces whatshap_tpu/ops/genotyping_pallas.py `_make_bwd_kernel` (with
// `_make_emission` and `_sum_fold`), the first pallas_call of
// forward_backward_pallas.
//
// One CTA per instance b walks its columns from C-1 down to 0 (the TPU's
// sequential grid axis).  The state is the scaled beta, T planes of S = 2^K
// floats, all ones before column C-1.  Per column c:
//
//   scale    the planes still carry the previous column's fold; they are
//            multiplied by that column's inv = 1 / scaling (none before the
//            first column) and summed over every state and plane:
//            scaling[c] = (sum / dup[c]) * nA, inv = 1 / scaling[c];
//   emit     em[t, a](i) = exp(sum_p (acc_j(i) + base_j)), j = (t*P + p)*2 +
//            bit p of a, acc_j(i) = sum_k bit_k(i) * diff[k, j]; computed in
//            registers per state and never stored;
//   weight   weighted[t](i) = beta[t](i) * sum_a em[t, a](i) * passign[t, a];
//   store    beta_store[c, t](i) = beta[t](i) * inv;
//   trans    beta[tj](i) = sum_ti weighted[ti](i) * trans[tj*T + ti];
//   fold     for every slot p born entering c, both partners of the pair
//            (i, i | 1<<p) take their sum, so the state is constant along p.
//
// The arithmetic is float32 and follows the Pallas kernel's order of
// operations step by step, except the sums over states (a block reduction
// here) and expf; NaN (a column whose allele-assignment prior sums to 0) is
// carried through, as the reference does.
//
// Bound: the kernel writes beta_store, 4*B*C*T*2^K bytes, and per state and
// column needs K*T*P*2 f32 adds for the emission sums and T*2^P exps (SFU);
// which term is largest depends on K, T and P (chip_smoke.py computes it).
// The design is the simple one: the state sits in dynamic shared memory
// while it fits (SMEM_STATE_BYTES in genotyping_cuda.py: T = 1 up to K = 15,
// T = 4 up to K = 13, T = 16 up to K = 11) and in a per-instance global
// scratch above, from one templated body; each state's emission sums run
// over its K bits; one barrier per folded bit.  At the production shape
// (B = 1, one chromosome per family) one CTA runs on one of 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Args {
  const float* diff;     // (B, C, K, T*P*2)
  const float* base;     // (B, C, T*P*2)
  const float* passign;  // (B, C, T*2^P)
  const float* trans;    // (B, C, T*T), index tj*T + ti
  const uint8_t* birth;  // (B, C, K)
  const float* dup;      // (B, C)
  float* beta_store;     // (B, C, T, S)
  float* scaling;        // (B, C)
  float* scratch;        // (B, T, S), or null: state in shared memory
  int C;
  int K;
};

template <int T, int P>
__global__ void __launch_bounds__(kThreads) geno_backward_kernel(Args a) {
  constexpr int P2 = 2 * P;
  constexpr int TP2 = T * P2;
  constexpr int NA = 1 << P;

  extern __shared__ float smem[];
  __shared__ float s_diff[kMaxK * TP2];
  __shared__ float s_base[TP2];
  __shared__ float s_pa[T * NA];
  __shared__ float s_tr[T * T];
  __shared__ int s_birth[kMaxK];
  __shared__ float s_red[kWarps];

  const int C = a.C, K = a.K;
  const int S = 1 << K;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* beta = a.scratch == nullptr ? smem : a.scratch + (size_t)b * T * S;

  for (int i = threadIdx.x; i < T * S; i += blockDim.x) beta[i] = 1.0f;
  float pinv = 1.0f;
  bool scaled = false;  // whether beta still needs the previous column's inv

  for (int c = C - 1; c >= 0; --c) {
    const size_t col = (size_t)b * C + c;
    __syncthreads();  // the previous column is done with the staged inputs
    for (int j = threadIdx.x; j < K * TP2; j += blockDim.x) s_diff[j] = a.diff[col * K * TP2 + j];
    for (int j = threadIdx.x; j < TP2; j += blockDim.x) s_base[j] = a.base[col * TP2 + j];
    for (int j = threadIdx.x; j < T * NA; j += blockDim.x) s_pa[j] = a.passign[col * T * NA + j];
    for (int j = threadIdx.x; j < T * T; j += blockDim.x) s_tr[j] = a.trans[col * T * T + j];
    for (int k = threadIdx.x; k < K; k += blockDim.x) s_birth[k] = a.birth[col * K + k];

    // ---- scale by the previous column's inv and sum
    float part = 0.0f;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float v = beta[t * S + i];
        if (scaled) {
          v *= pinv;
          beta[t * S + i] = v;
        }
        part += v;
      }
    }
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) s_red[warp] = part;
    __syncthreads();
    float total = 0.0f;
    for (int w = 0; w < n_warps; ++w) total += s_red[w];
    const float scaling = (total / a.dup[col]) * (float)NA;
    const float inv = 1.0f / scaling;
    if (threadIdx.x == 0) a.scaling[col] = scaling;

    // ---- emission, weighting, store and transmission; each thread on its
    // own states
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      float weighted[T];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float acc[P2];
#pragma unroll
        for (int j = 0; j < P2; ++j) acc[j] = 0.0f;
        for (int k = 0; k < K; ++k) {
          if ((i >> k) & 1) {
#pragma unroll
            for (int j = 0; j < P2; ++j) acc[j] += s_diff[k * TP2 + t * P2 + j];
          }
        }
        float wsum = 0.0f;
#pragma unroll
        for (int x = 0; x < NA; ++x) {
          float lem = 0.0f;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int j = 2 * p + ((x >> p) & 1);
            lem += acc[j] + s_base[t * P2 + j];
          }
          wsum += expf(lem) * s_pa[t * NA + x];
        }
        const float bt = beta[t * S + i];
        weighted[t] = bt * wsum;
        a.beta_store[(col * T + t) * (size_t)S + i] = bt * inv;
      }
#pragma unroll
      for (int tj = 0; tj < T; ++tj) {
        float contrib;
        if (T == 1) {
          contrib = weighted[0] * s_tr[0];
        } else {
          contrib = 0.0f;
#pragma unroll
          for (int ti = 0; ti < T; ++ti) contrib += weighted[ti] * s_tr[tj * T + ti];
        }
        beta[tj * S + i] = contrib;
      }
    }
    __syncthreads();

    // ---- sum-fold the slot bits born entering c (s_birth is uniform, so
    // are the branches)
    for (int p = 0; p < K; ++p) {
      if (!s_birth[p]) continue;
      const int lo = (1 << p) - 1;
      for (int q = threadIdx.x; q < (S >> 1); q += blockDim.x) {
        const int i0 = ((q & ~lo) << 1) | (q & lo);  // bit p = 0
        const int i1 = i0 | (1 << p);                 // bit p = 1
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const float s = beta[t * S + i0] + beta[t * S + i1];
          beta[t * S + i0] = s;
          beta[t * S + i1] = s;
        }
      }
      __syncthreads();
    }
    pinv = inv;
    scaled = true;
  }
}

template <int T, int P>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int S = 1 << a.K;
  const int threads = S < kThreads ? (S < 32 ? 32 : S) : kThreads;
  size_t smem = 0;
  if (a.scratch == nullptr) {
    smem = (size_t)T * S * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        geno_backward_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  geno_backward_kernel<T, P><<<B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int geno_backward(const float* diff, const float* base, const float* passign,
                             const float* trans, const uint8_t* birth, const float* dup,
                             float* beta_store, float* scaling, float* scratch, int B, int C,
                             int K, int T, int P, cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  Args a{diff, base, passign, trans, birth, dup, beta_store, scaling, scratch, C, K};
  if (T == 1 && P == 2) return launch<1, 2>(a, B, stream);
  if (T == 4 && P == 2) return launch<4, 2>(a, B, stream);
  if (T == 4 && P == 4) return launch<4, 4>(a, B, stream);
  if (T == 16 && P == 2) return launch<16, 2>(a, B, stream);
  if (T == 16 && P == 4) return launch<16, 4>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* geno_backward_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
