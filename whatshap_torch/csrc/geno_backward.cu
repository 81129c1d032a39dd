// Genotyping forward-backward HMM, backward pass, for Hopper (sm_90a).
//
// Replaces whatshap_tpu/ops/genotyping_pallas.py `_make_bwd_kernel` (with
// `_make_emission` and `_sum_fold`), the first pallas_call of
// forward_backward_pallas.
//
// Each instance b walks its columns from C-1 down to 0 (the TPU's sequential
// grid axis).  The state is the scaled beta, T planes of S = 2^K floats, all
// ones before column C-1.  Per column c:
//
//   scale    the planes still carry the previous column's fold; they are
//            multiplied by that column's inv = 1 / scaling (none before the
//            first column) and summed over every state and plane:
//            scaling[c] = (sum / dup[c]) * nA, inv = 1 / scaling[c];
//   emit     em[t, a](i) = exp(sum_p (acc_j(i) + base_j)), j = (t*P + p)*2 +
//            bit p of a, acc_j(i) = sum_k bit_k(i) * diff[k, j];
//   weight   weighted[t](i) = beta[t](i) * sum_a em[t, a](i) * passign[t, a];
//   store    beta_store[c, t](i) = beta[t](i) * inv;
//   trans    beta[tj](i) = sum_ti weighted[ti](i) * trans[tj*T + ti];
//   fold     for every slot p born entering c, both partners of the pair
//            (i, i | 1<<p) take their sum, so the state is constant along p.
//
// The arithmetic is float32 with expf (no fast math), in the Pallas kernel's
// order within a state; NaN (a column whose allele-assignment prior sums to
// 0) is carried through, as the reference does.
//
// Bound: the kernel writes beta_store, 4*B*C*T*2^K bytes, and per state and
// column needs T*2^P exps and T*P*2 f32 adds (chip_smoke.py takes the larger
// of bytes, exps and adds over their peak rates; at the genotype cells the
// bytes bound it).  Design (geno_cluster.cuh): one thread-block cluster of N
// = 2^cbits CTAs (up to 16) per instance, the state split over the CTAs and
// held in registers, 2^LR states of every plane per thread, so nothing of it
// goes to device memory; per state the emission sums add only the register
// bits to a part summed once per thread and column (T*P*2*(1 + LR/2) adds
// on average, not K*T*P*2), in the reference's order; folds by shuffles,
// through shared memory, through the partner CTA's shared memory or inside
// the thread, by the level of the bit; the scaling sum over the cluster in a
// fixed order (thread, warp shuffles, warps, CTAs by rank) behind a split
// cluster barrier whose latency the emission hides; the next column's
// inputs are loaded while this one computes, and each warp writes
// beta_store in 128-byte rows.  At the production shape (B = 1, one
// chromosome per family) the kernel runs on N of the card's 132 SMs.

#include "geno_cluster.cuh"

namespace {

using namespace geno;

struct Args {
  In in;              // flags = birth, scal = dup
  float* beta_store;  // (B, C, T, S)
  float* scaling;     // (B, C)
  int C;
  int K;
  int cbits;
};

template <int T, int P, int LR>
__global__ void __launch_bounds__(1 << kThreadBits, 1) geno_backward_kernel(Args a) {
  using Rc = Rec<T, P>;
  constexpr int R = 1 << LR, P2 = Rc::P2, NA = Rc::NA;

  extern __shared__ float4 smem4[];
  const int K = a.K, C = a.C;
  const Place q = place<LR>(K, a.cbits);
  const int N = 1 << a.cbits;
  const int lane = q.tid & 31, warp = q.tid >> 5, n_warps = (q.nthr + 31) >> 5;
  const size_t S = (size_t)1 << K;
  const int b = blockIdx.x >> a.cbits;
  const int W = Rc::words(K), Wp = round4(W);

  float* s_in = reinterpret_cast<float*>(smem4);  // [2][Wp] column records
  float* s_warp = s_in + 2 * Wp;                  // [kWarps]
  float* s_cta = s_warp + kWarps;                 // [2], by column parity
  float* xbuf = s_cta + 2;                        // [T * R][nthr] fold exchange

  float x[T][R];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int m = 0; m < R; ++m) x[t][m] = 1.0f;

  const size_t col0 = (size_t)b * C;
  Stage<T, P> st;
  st.issue(a.in, col0 + C - 1, K, W, q.tid, q.nthr);
  st.commit(s_in, a.in, col0 + C - 1, K, W, q.tid, q.nthr);
  __syncthreads();

  float pinv = 1.0f;
  bool scaled = false;  // whether x still needs the previous column's inv
  for (int c = C - 1, it = 0; c >= 0; --c, ++it) {
    const int cur = it & 1;
    const float* rec = s_in + cur * Wp;
    const size_t col = col0 + c;
    if (c > 0) st.issue(a.in, col - 1, K, W, q.tid, q.nthr);

    // ---- scale by the previous column's inv and sum: thread, warp, warps,
    // then CTAs behind the split barrier
    float part = 0.0f;
#pragma unroll
    for (int m = 0; m < R; ++m) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (scaled) x[t][m] *= pinv;
        part += x[t][m];
      }
    }
    part = warp_sum(q.active ? part : 0.0f);
    if (lane == 0) s_warp[warp] = part;
    __syncthreads();  // s_warp
    float total = 0.0f;
    for (int w = 0; w < n_warps; ++w) total += s_warp[w];
    if (N > 1) {
      if (q.tid == 0) s_cta[cur] = total;
      cluster_arrive();
    }

    // ---- emission weights of every state, while the barrier completes
    float wsum[T][R];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float u[P2];
      uniform_sums<T, P>(rec, q.Ku, q.gbase, t, u);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        float ab[P2];
        log_sums<T, P, LR>(rec, rec + Rc::base(K), u, q.Ku, m, t, ab);
        float ws = 0.0f;
#pragma unroll
        for (int x_ = 0; x_ < NA; ++x_) ws += expf(lem_of<P>(ab, x_)) * rec[Rc::pa(K) + t * NA + x_];
        wsum[t][m] = ws;
      }
    }

    // ---- the column's scaling (the same sum, in rank order, in every CTA)
    if (N > 1) {
      cluster_wait();
      cg::cluster_group cluster = cg::this_cluster();
      total = 0.0f;
      for (int r = 0; r < N; ++r) total += *cluster.map_shared_rank(s_cta + cur, r);
    }
    const float scaling = (total / rec[Rc::scal(K)]) * (float)NA;
    const float inv = 1.0f / scaling;
    if (q.rank == 0 && q.tid == 0) a.scaling[col] = scaling;

    // ---- store, weight and transmission
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float* row = a.beta_store + (col * T + t) * S;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (q.active) row[state_at(q, m)] = x[t][m] * inv;
        x[t][m] = x[t][m] * wsum[t][m];
      }
    }
    const float* tr = rec + Rc::tr(K);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      float w[T];
#pragma unroll
      for (int t = 0; t < T; ++t) w[t] = x[t][m];
#pragma unroll
      for (int tj = 0; tj < T; ++tj) {
        float contrib;
        if (T == 1) {
          contrib = w[0] * tr[0];
        } else {
          contrib = 0.0f;
#pragma unroll
          for (int ti = 0; ti < T; ++ti) contrib += w[ti] * tr[tj * T + ti];
        }
        x[tj][m] = contrib;
      }
    }

    // ---- sum-fold the slot bits born entering c
    sum_fold<T, LR>(x, flag_mask(rec + Rc::flag(K), K), xbuf, q);

    if (c > 0) st.commit(s_in + (cur ^ 1) * Wp, a.in, col - 1, K, W, q.tid, q.nthr);
    __syncthreads();
    pinv = inv;
    scaled = true;
  }
  if (N > 1) cluster_sync();  // no CTA leaves while another reads its shared memory
}

template <int T, int P, int LR>
int launch(const Args& a, int B, cudaStream_t stream) {
  using Rc = Rec<T, P>;
  const int Kc = a.K - a.cbits;
  const int threads = Kc - LR < 5 ? 32 : 1 << (Kc - LR);
  const size_t floats = 2 * round4(Rc::words(a.K)) + kWarps + 2 + (size_t)T * threads * (1 << LR);
  return launch_clusters(geno_backward_kernel<T, P, LR>, a, B, a.K, a.cbits, LR,
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

extern "C" int geno_backward(const float* diff, const float* base, const float* passign,
                             const float* trans, const uint8_t* birth, const float* dup,
                             float* beta_store, float* scaling, int B, int C, int K, int T,
                             int P, cudaStream_t stream) {
  const int lr = geno::layout_lr(K, T);
  if (B < 1 || C < 1 || lr < 0) return (int)cudaErrorInvalidValue;
  Args a{{diff, base, passign, trans, birth, dup}, beta_store, scaling, C, K, geno::cluster_bits(K)};
  if (T == 1 && P == 2) return by_lr<1, 2, geno::max_lr(1)>(a, B, lr, stream);
  if (T == 4 && P == 2) return by_lr<4, 2, geno::max_lr(4)>(a, B, lr, stream);
  if (T == 4 && P == 4) return by_lr<4, 4, geno::max_lr(4)>(a, B, lr, stream);
  if (T == 16 && P == 2) return by_lr<16, 2, geno::max_lr(16)>(a, B, lr, stream);
  if (T == 16 && P == 4) return by_lr<16, 4, geno::max_lr(16)>(a, B, lr, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* geno_backward_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
