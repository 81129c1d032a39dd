// Genotyping forward-backward HMM, forward pass, for Hopper (sm_90a).
//
// Replaces whatshap_tpu/ops/genotyping_pallas.py `_make_fwd_kernel` (with
// `_make_emission` and `_sum_fold`), the second pallas_call of
// forward_backward_pallas.
//
// Each instance b walks its columns from 0 to C-1.  The state is the scaled
// alpha, T planes of S = 2^K floats.  Per column c, with inv = 1 /
// scaling[c] from the backward pass:
//
//   trans    sum_prev[ti](i) = 1 at c = 0, else sum_tj alpha[tj](i) *
//            trans[tj*T + ti];
//   emit     em[t, a](i) as in geno_backward.cu;
//   fwd      fwd[t, a](i) = sum_prev[t](i) * em[t, a](i) * (passign[t, a] *
//            inv); alpha[t](i) = sum_a fwd[t, a](i);
//   red      red[c, t*nA + a] = sum_i fwd[t, a](i) * beta_store[c, t](i),
//            with an identity beta at the last column;
//   fold     for every slot p that dies after c (die_next[c]), both partners
//            of the pair (i, i | 1<<p) take their sum.
//
// Arithmetic is float32 with expf, in the Pallas kernel's order within a
// state; NaN is carried through.
//
// Bound: the kernel reads beta_store, 4*B*C*T*2^K bytes, and needs per state
// and column T*2^P exps and T*P*2 f32 adds, as the backward pass.  Design:
// the backward kernel's (geno_cluster.cuh: a cluster of N CTAs per
// instance, the state in registers, folds by level, emission sums of
// O(LR) adds per state).  The red sums go thread, warp shuffles, warps in
// order, then CTAs in rank order: each CTA leaves its T * 2^P partials in
// shared memory behind a split cluster barrier, and CTA 0 adds them up in
// the next column, so no column waits on the barrier.  A thread's
// beta_store entries of column c + 1 are loaded as soon as column c is done
// with its own, in 128-byte rows per warp.  At B = 1 the kernel runs on N of
// the card's 132 SMs.

#include "geno_cluster.cuh"

namespace {

using namespace geno;

struct Args {
  In in;                    // flags = die_next, scal = scaling
  const float* beta_store;  // (B, C, T, S)
  float* red;               // (B, C, T*2^P)
  int C;
  int K;
  int cbits;
};

template <int T, int P, int LR>
__global__ void __launch_bounds__(1 << kThreadBits, 1) geno_forward_kernel(Args a) {
  using Rc = Rec<T, P>;
  constexpr int R = 1 << LR, P2 = Rc::P2, NA = Rc::NA, TNA = T * NA;

  extern __shared__ float4 smem4[];
  const int K = a.K, C = a.C;
  const Place q = place<LR>(K, a.cbits);
  const int N = 1 << a.cbits;
  const int lane = q.tid & 31, warp = q.tid >> 5, n_warps = (q.nthr + 31) >> 5;
  const size_t S = (size_t)1 << K;
  const int b = blockIdx.x >> a.cbits;
  const int W = Rc::words(K), Wp = round4(W);

  float* s_in = reinterpret_cast<float*>(smem4);  // [2][Wp] column records
  float* s_part = s_in + 2 * Wp;                  // [kWarps][T * NA]
  float* s_cpart = s_part + kWarps * TNA;         // [2][T * NA], by column parity
  float* xbuf = s_cpart + 2 * TNA;                // [T * R][nthr] fold exchange

  float x[T][R];  // alpha; sum_prev of column 0 is ones
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int m = 0; m < R; ++m) x[t][m] = 1.0f;

  const size_t col0 = (size_t)b * C;
  Stage<T, P> st;
  st.issue(a.in, col0, K, W, q.tid, q.nthr);
  st.commit(s_in, a.in, col0, K, W, q.tid, q.nthr);
  float bt[T][R];  // the thread's beta_store entries of the column
  if (C > 1 && q.active) {
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int m = 0; m < R; ++m) bt[t][m] = a.beta_store[(col0 * T + t) * S + state_at(q, m)];
  }
  __syncthreads();

  bool pending = false;  // a column's CTA partials wait for CTA 0
  for (int c = 0; c < C; ++c) {
    const int cur = c & 1;
    const float* rec = s_in + cur * Wp;
    const size_t col = col0 + c;
    const bool last = c == C - 1;
    if (!last) st.issue(a.in, col + 1, K, W, q.tid, q.nthr);
    const float inv = 1.0f / rec[Rc::scal(K)];

    // ---- sum_prev through the transmission matrix
    if (c > 0) {
      const float* tr = rec + Rc::tr(K);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        float prev[T];
#pragma unroll
        for (int t = 0; t < T; ++t) prev[t] = x[t][m];
#pragma unroll
        for (int ti = 0; ti < T; ++ti) {
          float v;
          if (T == 1) {
            v = prev[0] * tr[0];
          } else {
            v = 0.0f;
#pragma unroll
            for (int tj = 0; tj < T; ++tj) v += prev[tj] * tr[tj * T + ti];
          }
          x[ti][m] = v;
        }
      }
    }

    // ---- per plane: emission, fwd, the new alpha and the red partials
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float u[P2];
      uniform_sums<T, P>(rec, q.Ku, q.gbase, t, u);
      float part[NA];
#pragma unroll
      for (int x_ = 0; x_ < NA; ++x_) part[x_] = 0.0f;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        float ab[P2];
        log_sums<T, P, LR>(rec, rec + Rc::base(K), u, q.Ku, m, t, ab);
        const float sp = x[t][m];
        const float bf = last ? 1.0f : bt[t][m];
        float alpha_acc = 0.0f;
#pragma unroll
        for (int x_ = 0; x_ < NA; ++x_) {
          const float fwd = sp * expf(lem_of<P>(ab, x_)) * (rec[Rc::pa(K) + t * NA + x_] * inv);
          alpha_acc += fwd;
          part[x_] += fwd * bf;
        }
        x[t][m] = alpha_acc;
      }
#pragma unroll
      for (int x_ = 0; x_ < NA; ++x_) {
        const float v = warp_sum(q.active ? part[x_] : 0.0f);
        if (lane == 0) s_part[warp * TNA + t * NA + x_] = v;
      }
    }
    // the next column's beta_store entries (the identity at the last)
    if (c + 1 < C - 1 && q.active) {
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int m = 0; m < R; ++m) bt[t][m] = a.beta_store[((col + 1) * T + t) * S + state_at(q, m)];
    }
    __syncthreads();  // s_part

    // ---- CTA 0 adds up the previous column's CTA partials in rank order
    if (pending) {
      cluster_wait();
      pending = false;
      if (q.rank == 0) {
        cg::cluster_group cluster = cg::this_cluster();
        for (int j = q.tid; j < TNA; j += q.nthr) {
          float v = 0.0f;
          for (int r = 0; r < N; ++r) v += *cluster.map_shared_rank(s_cpart + (cur ^ 1) * TNA + j, r);
          a.red[(col - 1) * TNA + j] = v;
        }
      }
    }
    for (int j = q.tid; j < TNA; j += q.nthr) {
      float v = 0.0f;
      for (int w = 0; w < n_warps; ++w) v += s_part[w * TNA + j];
      if (N == 1) {
        a.red[col * TNA + j] = v;
      } else {
        s_cpart[cur * TNA + j] = v;
      }
    }

    // ---- sum-fold the slot bits dying after c
    sum_fold<T, LR>(x, flag_mask(rec + Rc::flag(K), K), xbuf, q);

    if (N > 1) {
      cluster_arrive();
      pending = true;
    }
    if (!last) st.commit(s_in + (cur ^ 1) * Wp, a.in, col + 1, K, W, q.tid, q.nthr);
    __syncthreads();
  }
  if (pending) {
    cluster_wait();
    if (q.rank == 0) {
      cg::cluster_group cluster = cg::this_cluster();
      const int cur = (C - 1) & 1;
      for (int j = q.tid; j < TNA; j += q.nthr) {
        float v = 0.0f;
        for (int r = 0; r < N; ++r) v += *cluster.map_shared_rank(s_cpart + cur * TNA + j, r);
        a.red[(col0 + C - 1) * TNA + j] = v;
      }
    }
    cluster_sync();  // no CTA leaves while CTA 0 reads its shared memory
  }
}

template <int T, int P, int LR>
int launch(const Args& a, int B, cudaStream_t stream) {
  using Rc = Rec<T, P>;
  const int Kc = a.K - a.cbits;
  const int threads = Kc - LR < 5 ? 32 : 1 << (Kc - LR);
  const int tna = T << P;
  const size_t floats = 2 * round4(Rc::words(a.K)) + kWarps * tna + 2 * tna +
                        (size_t)T * threads * (1 << LR);
  return launch_clusters(geno_forward_kernel<T, P, LR>, a, B, a.K, a.cbits, LR,
                         floats * sizeof(float), stream);
}

template <int T, int P, int LR>
int by_lr(const Args& a, int B, int lr, cudaStream_t stream) {
  if (lr == LR) return launch<T, P, LR>(a, B, stream);
  if constexpr (LR > 0) {
    return by_lr<T, P, LR - 1>(a, B, lr, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int geno_forward(const float* diff, const float* base, const float* passign,
                            const float* trans, const uint8_t* die, const float* scaling,
                            const float* beta_store, float* red, int B, int C, int K, int T, int P,
                            cudaStream_t stream) {
  const int lr = geno::layout_lr(K, T);
  if (B < 1 || C < 1 || lr < 0) return (int)cudaErrorInvalidValue;
  Args a{{diff, base, passign, trans, die, scaling}, beta_store, red, C, K, geno::cluster_bits(K)};
  if (T == 1 && P == 2) return by_lr<1, 2, geno::max_lr(1)>(a, B, lr, stream);
  if (T == 4 && P == 2) return by_lr<4, 2, geno::max_lr(4)>(a, B, lr, stream);
  if (T == 4 && P == 4) return by_lr<4, 4, geno::max_lr(4)>(a, B, lr, stream);
  if (T == 16 && P == 2) return by_lr<16, 2, geno::max_lr(16)>(a, B, lr, stream);
  if (T == 16 && P == 4) return by_lr<16, 4, geno::max_lr(16)>(a, B, lr, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* geno_forward_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
