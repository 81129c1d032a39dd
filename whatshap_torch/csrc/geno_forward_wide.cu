// Genotyping forward-backward HMM, forward pass, for Hopper (sm_90a), with
// the state in device memory: the shapes past the cluster kernel's envelope
// (geno_forward.cu), as geno_backward_wide.cu for the backward pass.
//
// Replaces the reference's XLA forward scan past its Pallas envelope:
// whatshap_tpu/ops/genotyping_jax.py `_forward_backward` (`fwd_step` and its
// lax.scan, with `_sum_fold`), as `_forward_backward_batched` runs it.  What
// it computes is geno_forward.cu's function: per instance, from column 0 up,
// with the state alpha (T planes of 2^K floats):
//
//   sum_prev[ti](i) = sum_tj alpha[tj](i) * trans[tj*T + ti] (ones at c = 0);
//   fwd[t, a](i) = (sum_prev[t](i) * em[t, a](i)) * (passign[t, a] / scaling[c]),
//            float32 with expf (no fast math);
//   red[c, t*2^P + a] = sum_i fwd[t, a](i) * beta_store[c, t](i) (the last
//            column has no beta: the sum of fwd);
//   alpha = sum_a fwd, sum-folded over the slots dying after c.
//
// Bound: the kernel reads beta_store once, 4*B*C*T*2^K bytes, and per
// state, plane and column takes 2^P exps.
//
// Design (geno_wide.cuh).  alpha lives in device memory (B, T, 2^K), updated
// in place.  A column is one pass over every instance's tiles, each the
// coset of the column's dying slots in all T planes: load alpha and the
// tile's beta_store, the transmission product in shared memory (one thread
// an entry), then the emissions in the owner mapping, each thread over its
// states of one plane for up to 16 allele assignments at a time (a sum of
// fwd * beta in a register for each, folded over the plane's threads by
// shuffles and added to the CTA's partial row of red), the fold of sum_a
// fwd and the new alpha: one trip of the state.  Where more slots die than
// a tile has bits, further passes fold the next groups in place.  After
// the column's barrier every warp of the grid takes outputs of red and sums
// the partial rows of the CTAs that cover its instance in rank order.

#include "geno_wide.cuh"

namespace {

using namespace geno_wide;

struct Args {
  In in;                   // flags = die_next, scal = scaling
  const float* beta_store; // (B, C, T, S)
  float* red;              // (B, C, T*2^P)
  float* alpha;            // (B, T, S) scratch: the state
  uint32_t* masks;         // (B, C) scratch: the dying slots of each column
  int* npass;              // (C,)   scratch: the passes of each column
  float* part;             // (2, G + B, T*2^P) scratch: partial rows of red, by column parity
  int B, C, K, T;
};

// red of column c from the partial rows of parity c & 1: a warp an output,
// its lanes over the covering CTAs' rows in rank order, then shuffles.
template <int P>
__device__ void reduce_red(const Args& a, const Geo& g, int c, size_t tiles) {
  const int G = gridDim.x, TA = a.T << P, lane = threadIdx.x & 31;
  const size_t warps = (size_t)G * kWarps, outs = (size_t)a.B * TA;
  const float* rows = a.part + (size_t)(c & 1) * (G + a.B) * TA;
  for (size_t w = ((size_t)blockIdx.x * kThreads + threadIdx.x) >> 5; w < outs; w += warps) {
    const int b = (int)(w / TA), j = (int)(w % TA);
    const int lo = cta_of((size_t)b * g.per, tiles, G), hi = cta_of((size_t)(b + 1) * g.per - 1, tiles, G);
    float v = 0.0f;
    for (int x = lo + lane; x <= hi; x += 32) v += __ldcg(rows + (size_t)(x + b) * TA + j);
    v = warp_sum(v);
    if (lane == 0) a.red[((size_t)b * a.C + c) * TA + j] = v;
  }
}

// The first pass of column c over tile f of instance b: red's sums into the
// CTA's partial row `prow` and, before the last column, the new alpha,
// folded over this pass's dying slots.
template <int P>
__device__ void main_tile(const Args& a, const Smem& s, const Geo& g, int b, int c, size_t f, float* prow) {
  constexpr int NA = 1 << P, NC = NA < kChunk ? NA : kChunk;
  const int K = a.K, T = a.T, TP2 = T * 2 * P;
  const size_t S = g.S, col = (size_t)b * a.C + c;
  const uint32_t base = coset_base((uint32_t)s.meta[32], K, f);
  const bool first = c == 0, has_beta = c < a.C - 1;
  float* alpha = a.alpha + (size_t)b * T * S;
  const float* beta = a.beta_store + col * T * S;
  float* A = s.x[0];   // alpha in, then sum_a fwd
  float* Bt = s.x[1];  // the tile's beta_store
  float* SP = s.x[2];  // sum_prev

  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    const size_t at = (size_t)t * S + (base | s.off[l]);
    if (!first) A[t * g.ps + l] = __ldcg(alpha + at);
    if (has_beta) Bt[t * g.ps + l] = __ldg(beta + at);
  }
  __syncthreads();
  if (!first) {
    // sum_prev[ti](l) = sum_tj A[tj](l) * trans[tj*T + ti]
    const float* tr = a.in.trans + col * T * T;
    for (int e = threadIdx.x; e < g.n; e += kThreads) {
      const int ti = e >> g.lb, l = e & (g.ns - 1);
      float acc = 0.0f;
      for (int tj = 0; tj < T; ++tj) acc += A[tj * g.ps + l] * __ldg(tr + (size_t)tj * T + ti);
      SP[ti * g.ps + l] = acc;
    }
    __syncthreads();
  }

  // the owner mapping: thread (t, r) over the states r + tp*k of plane t
  const int t = threadIdx.x / g.tp, r = threadIdx.x % g.tp;
  const bool active = t < T;
  const float inv = 1.0f / __ldg(a.in.scal + col);
  const float* diff_c = a.in.diff + col * K * TP2;
  const float* base_c = a.in.base + col * TP2;
  const float* pa = a.in.passign + col * T * NA + (active ? t : 0) * NA;
  float fsum[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) fsum[k] = 0.0f;
  for (int a0 = 0; a0 < NA; a0 += NC) {
    float acc[NC];
#pragma unroll
    for (int x = 0; x < NC; ++x) acc[x] = 0.0f;
    if (active) {
#pragma unroll 1
      for (int k = 0; k < g.E; ++k) {
        const int l = r + g.tp * k;
        const float sp = first ? 1.0f : SP[t * g.ps + l];
        const float bt = has_beta ? Bt[t * g.ps + l] : 1.0f;
        float ab[2 * P];
        emission_sums<P>(diff_c, base_c, K, TP2, base | s.off[l], t, ab);
        float fs = 0.0f;
#pragma unroll
        for (int x = 0; x < NC; ++x) {
          const float fv = (sp * expf(lem_of<P>(ab, a0 + x))) * (__ldg(pa + a0 + x) * inv);
          fs += fv;
          acc[x] += has_beta ? fv * bt : fv;
        }
        // sum_a fwd in ascending a, across the chunks
#pragma unroll
        for (int kk = 0; kk < kPer; ++kk)
          if (kk == k) fsum[kk] += fs;
      }
    }
    // fold acc over the plane's threads and add it to the CTA's row
    if (g.tp <= 32) {
      for (int o = g.tp >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int x = 0; x < NC; ++x) acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], o);
      }
      if (active && r == 0) {
#pragma unroll
        for (int x = 0; x < NC; ++x) prow[t * NA + a0 + x] += acc[x];
      }
    } else {
      const int warp = threadIdx.x >> 5, wpp = g.tp >> 5;  // warps a plane
#pragma unroll
      for (int x = 0; x < NC; ++x) acc[x] = warp_sum(acc[x]);
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int x = 0; x < NC; ++x) s.red[warp * kChunk + x] = acc[x];
      }
      __syncthreads();
      if ((int)threadIdx.x < T * NC) {  // T * tp <= kThreads
        const int pl = threadIdx.x / NC, x = threadIdx.x % NC;
        float v = 0.0f;
        for (int w = 0; w < wpp; ++w) v += s.red[(pl * wpp + w) * kChunk + x];
        prow[pl * NA + a0 + x] += v;
      }
      __syncthreads();
    }
  }
  if (!has_beta) return;  // no state after the last column

  // the new alpha: sum_a fwd, folded over this pass's dying slots
  if (active) {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k < g.E) A[t * g.ps + r + g.tp * k] = fsum[k];
  }
  fold_tile(A, g, (uint32_t)s.meta[33]);
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int tt = e >> g.lb, l = e & (g.ns - 1);
    alpha[(size_t)tt * S + (base | s.off[l])] = A[tt * g.ps + l];
  }
}

// A further pass of column c over tile f of instance b: fold this pass's
// dying slots of alpha in place.
__device__ void fold_pass_tile(const Args& a, const Smem& s, const Geo& g, int b, size_t f) {
  const size_t S = g.S;
  const uint32_t base = coset_base((uint32_t)s.meta[32], a.K, f);
  float* alpha = a.alpha + (size_t)b * a.T * S;
  float* X = s.x[0];
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    X[t * g.ps + l] = __ldcg(alpha + (size_t)t * S + (base | s.off[l]));
  }
  fold_tile(X, g, (uint32_t)s.meta[33]);
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    alpha[(size_t)t * S + (base | s.off[l])] = X[t * g.ps + l];
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads) geno_forward_wide_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const Geo g = geometry(a.K, a.T);
  const Smem s = carve(reinterpret_cast<float*>(smem4), g, a.T, 3);
  const int G = gridDim.x, cta = blockIdx.x, C = a.C, TA = a.T << P;
  const size_t tiles = (size_t)a.B * g.per;
  const size_t f0 = tiles * cta / G, f1 = tiles * (cta + 1) / G;
  const int b_lo = (int)(f0 / g.per), b_hi = (int)((f1 - 1) / g.per);

  gather_masks(a.in.flags, a.masks, a.npass, a.B, C, a.K, g.lb, false);
  grid.sync();

  for (int c = 0; c < C; ++c) {
    if (c > 0) reduce_red<P>(a, g, c - 1, tiles);
    // this CTA's partial rows of column c
    float* rows = a.part + ((size_t)(c & 1) * (G + a.B) + cta) * TA;
    for (size_t j = threadIdx.x; j < (size_t)(b_hi - b_lo + 1) * TA; j += kThreads)
      rows[(size_t)b_lo * TA + j] = 0.0f;
    const int np = __ldcg(a.npass + c);
    for (int p = 0; p < np; ++p) {
      int built = -1;  // the instance whose pass-p tables the CTA holds
      for (size_t f = f0; f < f1; ++f) {
        const int b = (int)(f / g.per);
        const uint32_t mask = __ldcg(a.masks + (size_t)b * C + c);
        const int nf = __popc(mask);
        if (p >= passes(nf, g.lb)) continue;
        if (b != built) {
          build_tile(s, g, a.K, slot_range(mask, p * g.lb, min((p + 1) * g.lb, nf)));
          built = b;
        }
        if (p == 0) {
          main_tile<P>(a, s, g, b, c, f - (size_t)b * g.per, rows + (size_t)b * TA);
        } else {
          fold_pass_tile(a, s, g, b, f - (size_t)b * g.per);
        }
        __syncthreads();  // the tile's shared memory is free again
      }
      grid.sync();
    }
  }
  reduce_red<P>(a, g, C - 1, tiles);
}

template <int P>
int launch(const Args& a, int max_ctas, cudaStream_t stream) {
  const Geo g = geometry(a.K, a.T);
  const size_t smem = smem_words(g, a.T, 3) * sizeof(float);
  return launch_grid(geno_forward_wide_kernel<P>, a, (size_t)a.B * g.per, max_ctas, smem, stream);
}

}  // namespace

// alpha holds B*T*2^K floats, masks B*C words, npass C, part 2 * (max_ctas +
// B) * T * 2^P floats (any contents); the launch takes at most max_ctas CTAs.
extern "C" int geno_forward_wide(const float* diff, const float* base, const float* passign, const float* trans,
                                 const uint8_t* die_next, const float* scaling, const float* beta_store, float* red,
                                 float* alpha, uint32_t* masks, int* npass, float* part, int B, int C, int K, int T,
                                 int P, int max_ctas, cudaStream_t stream) {
  if (!geno_wide::shape_ok(B, C, K, T, P)) return (int)cudaErrorInvalidValue;
  Args a{{diff, base, passign, trans, die_next, scaling}, beta_store, red, alpha, masks, npass, part, B, C, K, T};
  switch (P) {
    case 2: return launch<2>(a, max_ctas, stream);
    case 4: return launch<4>(a, max_ctas, stream);
    case 6: return launch<6>(a, max_ctas, stream);
    case 8: return launch<8>(a, max_ctas, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* geno_forward_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
