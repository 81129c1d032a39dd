// Genotyping forward-backward HMM, forward pass, for Hopper (sm_90a).
//
// Replaces whatshap_tpu/ops/genotyping_pallas.py `_make_fwd_kernel` (with
// `_make_emission` and `_sum_fold`), the second pallas_call of
// forward_backward_pallas.
//
// One CTA per instance b walks its columns from 0 to C-1.  The state is the
// scaled alpha, T planes of S = 2^K floats.  Per column c, with inv =
// 1 / scaling[c] from the backward pass:
//
//   trans    sum_prev[ti](i) = 1 at c = 0, else sum_tj alpha[tj](i) *
//            trans[tj*T + ti], written in place over alpha;
//   emit     em[t, a](i) as in geno_backward.cu, in registers;
//   fwd      fwd[t, a](i) = sum_prev[t](i) * em[t, a](i) * (passign[t, a] *
//            inv); alpha[t](i) = sum_a fwd[t, a](i);
//   red      red[c, t*nA + a] = sum_i fwd[t, a](i) * beta_store[c, t](i),
//            with an identity beta at the last column: per thread over its
//            states, then over the warp by shuffles, then over the warps in
//            a fixed order;
//   fold     for every slot p that dies after c (die_next[c]), both partners
//            of the pair (i, i | 1<<p) take their sum.
//
// The planes are walked one after another (t outer, states inner), so a
// thread keeps only nA partial red sums in registers.  Arithmetic is float32
// in the Pallas kernel's order, except the sums over states and expf; NaN
// is carried through.
//
// Bound: the kernel reads beta_store, 4*B*C*T*2^K bytes, and needs per state
// and column K*T*P*2 f32 adds and T*2^P exps, as the backward pass.  The
// design is the backward kernel's: state in dynamic shared memory while it
// fits, else a per-instance global scratch; one CTA per instance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Args {
  const float* diff;        // (B, C, K, T*P*2)
  const float* base;        // (B, C, T*P*2)
  const float* passign;     // (B, C, T*2^P)
  const float* trans;       // (B, C, T*T), index tj*T + ti
  const uint8_t* die;       // (B, C, K): die_next
  const float* scaling;     // (B, C)
  const float* beta_store;  // (B, C, T, S)
  float* red;               // (B, C, T*2^P)
  float* scratch;           // (B, T, S), or null: state in shared memory
  int C;
  int K;
};

template <int T, int P>
__global__ void __launch_bounds__(kThreads) geno_forward_kernel(Args a) {
  constexpr int P2 = 2 * P;
  constexpr int TP2 = T * P2;
  constexpr int NA = 1 << P;

  extern __shared__ float smem[];
  __shared__ float s_diff[kMaxK * TP2];
  __shared__ float s_base[TP2];
  __shared__ float s_pa[T * NA];
  __shared__ float s_tr[T * T];
  __shared__ int s_die[kMaxK];
  __shared__ float s_part[kWarps * T * NA];

  const int C = a.C, K = a.K;
  const int S = 1 << K;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* alpha = a.scratch == nullptr ? smem : a.scratch + (size_t)b * T * S;

  // sum_prev of column 0: ones
  for (int i = threadIdx.x; i < T * S; i += blockDim.x) alpha[i] = 1.0f;

  for (int c = 0; c < C; ++c) {
    const size_t col = (size_t)b * C + c;
    __syncthreads();  // the previous column is done with the staged inputs
    for (int j = threadIdx.x; j < K * TP2; j += blockDim.x) s_diff[j] = a.diff[col * K * TP2 + j];
    for (int j = threadIdx.x; j < TP2; j += blockDim.x) s_base[j] = a.base[col * TP2 + j];
    for (int j = threadIdx.x; j < T * NA; j += blockDim.x) s_pa[j] = a.passign[col * T * NA + j];
    for (int j = threadIdx.x; j < T * T; j += blockDim.x) s_tr[j] = a.trans[col * T * T + j];
    for (int k = threadIdx.x; k < K; k += blockDim.x) s_die[k] = a.die[col * K + k];
    __syncthreads();
    const float inv = 1.0f / a.scaling[col];
    const bool last = c == C - 1;

    // ---- sum_prev through the transmission matrix (each thread on its own
    // states)
    if (c > 0) {
      for (int i = threadIdx.x; i < S; i += blockDim.x) {
        float prev[T];
#pragma unroll
        for (int t = 0; t < T; ++t) prev[t] = alpha[t * S + i];
#pragma unroll
        for (int ti = 0; ti < T; ++ti) {
          float v;
          if (T == 1) {
            v = prev[0] * s_tr[0];
          } else {
            v = 0.0f;
#pragma unroll
            for (int tj = 0; tj < T; ++tj) v += prev[tj] * s_tr[tj * T + ti];
          }
          alpha[ti * S + i] = v;
        }
      }
    }

    // ---- per plane: emission, fwd, the new alpha and the red sums
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      float part[NA];
#pragma unroll
      for (int x = 0; x < NA; ++x) part[x] = 0.0f;
      const float* beta_t = a.beta_store + (col * T + t) * (size_t)S;
      for (int i = threadIdx.x; i < S; i += blockDim.x) {
        float acc[P2];
#pragma unroll
        for (int j = 0; j < P2; ++j) acc[j] = 0.0f;
        for (int k = 0; k < K; ++k) {
          if ((i >> k) & 1) {
#pragma unroll
            for (int j = 0; j < P2; ++j) acc[j] += s_diff[k * TP2 + t * P2 + j];
          }
        }
        const float sp = alpha[t * S + i];
        const float bf = last ? 1.0f : beta_t[i];
        float alpha_acc = 0.0f;
#pragma unroll
        for (int x = 0; x < NA; ++x) {
          float lem = 0.0f;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int j = 2 * p + ((x >> p) & 1);
            lem += acc[j] + s_base[t * P2 + j];
          }
          const float fwd = sp * expf(lem) * (s_pa[t * NA + x] * inv);
          alpha_acc += fwd;
          part[x] += fwd * bf;
        }
        alpha[t * S + i] = alpha_acc;
      }
#pragma unroll
      for (int x = 0; x < NA; ++x) {
        float v = part[x];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) s_part[warp * T * NA + t * NA + x] = v;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < T * NA; j += blockDim.x) {
      float v = 0.0f;
      for (int w = 0; w < n_warps; ++w) v += s_part[w * T * NA + j];
      a.red[col * T * NA + j] = v;
    }

    // ---- sum-fold the slot bits dying after c (s_die is uniform, so are
    // the branches)
    for (int p = 0; p < K; ++p) {
      if (!s_die[p]) continue;
      const int lo = (1 << p) - 1;
      for (int q = threadIdx.x; q < (S >> 1); q += blockDim.x) {
        const int i0 = ((q & ~lo) << 1) | (q & lo);  // bit p = 0
        const int i1 = i0 | (1 << p);                 // bit p = 1
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const float s = alpha[t * S + i0] + alpha[t * S + i1];
          alpha[t * S + i0] = s;
          alpha[t * S + i1] = s;
        }
      }
      __syncthreads();
    }
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
        geno_forward_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  geno_forward_kernel<T, P><<<B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int geno_forward(const float* diff, const float* base, const float* passign,
                            const float* trans, const uint8_t* die, const float* scaling,
                            const float* beta_store, float* red, float* scratch, int B, int C,
                            int K, int T, int P, cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  Args a{diff, base, passign, trans, die, scaling, beta_store, red, scratch, C, K};
  if (T == 1 && P == 2) return launch<1, 2>(a, B, stream);
  if (T == 4 && P == 2) return launch<4, 2>(a, B, stream);
  if (T == 4 && P == 4) return launch<4, 4>(a, B, stream);
  if (T == 16 && P == 2) return launch<16, 2>(a, B, stream);
  if (T == 16 && P == 4) return launch<16, 4>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* geno_forward_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
