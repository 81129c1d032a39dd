// Genotyping forward-backward HMM, backward pass, for Hopper (sm_90a), with
// the state in device memory: the shapes past the cluster kernel's envelope
// (geno_backward.cu: T = 1 to K = 17, T = 4 to 16, T = 16 to 13, P <= 4).
//
// Replaces the reference's XLA backward scan past its Pallas envelope:
// whatshap_tpu/ops/genotyping_jax.py `_forward_backward` (`bwd_step` and its
// lax.scan, with `_sum_fold`), as `_forward_backward_batched` runs it for
// stacked instances, at T = 1 (P = 2) or T = 4, 16, 64, 256 with P = 2, 4,
// 6, 8, and any 1 <= K <= 23.  What it computes is geno_backward.cu's
// function: per instance, from column C-1 down to 0, with the scaled beta
// (T planes of 2^K floats, all ones before column C-1):
//
//   scaling[c] = (sum of beta / dup[c]) * 2^P, inv = 1 / scaling[c];
//   beta_store[c] = beta * inv;
//   weighted[t](i) = beta[t](i) * sum_a em[t, a](i) * passign[t, a], em the
//            exp of the emission sums (geno_wide.cuh emission_sums, lem_of),
//            float32 with expf (no fast math);
//   beta[tj](i) = sum_ti weighted[ti](i) * trans[tj*T + ti], sum-folded over
//            the slots born entering c, times inv: the next column's state.
//
// NaN (a column whose allele-assignment prior sums to 0) is carried through,
// as the reference does.
//
// Bound: the kernel writes beta_store, 4*B*C*T*2^K bytes (and reads it back
// once: it is also the state), and per state, plane and column takes 2^P
// exps (chip_smoke.py takes the larger of bytes, exps and f32 adds over
// their peak rates).
//
// Design (geno_wide.cuh).  The state is kept in beta_store itself: column c
// reads its incoming beta from beta_store[c] (written by column c + 1),
// writes it back scaled, and writes the next state unscaled into
// beta_store[c - 1], so nothing beyond the output holds a plane.  A column
// is one pass over every instance's tiles, each the coset of the column's
// birth slots in all T planes: load, store scaled, the emission weights
// (one thread an entry), the T x T product in shared memory, the fold, and
// the next state with its partial sum, one trip of the state.  Where more
// slots are born than a tile has bits, further passes fold the next groups
// in place in beta_store[c - 1]; the last one scales and sums.  The scaling
// of column c is the fixed-order sum of the partials the previous column's
// last pass left (column C - 1: T * 2^K).

#include "geno_wide.cuh"

namespace {

using namespace geno_wide;

struct Args {
  In in;              // flags = birth, scal = dup
  float* beta_store;  // (B, C, T, S)
  float* scaling;     // (B, C)
  uint32_t* masks;    // (B, C) scratch: the birth slots of each column
  int* npass;         // (C,)   scratch: the passes of each column
  float* part;        // (2, G + B) scratch: partial sums of the state, by column parity
  int B, C, K, T;
};

// inv of instance b at column c, in every thread: the fixed-order sum of
// the partials of the CTAs that cover b (warp 0: lanes over the rows in
// rank order, then shuffles), over dup[c] times 2^P.  Every thread calls it.
template <int P>
__device__ float instance_scaling(const Args& a, const Smem& s, const Geo& g, int b, int c, size_t tiles) {
  const int G = gridDim.x;
  if (threadIdx.x < 32) {
    float total;
    if (c == a.C - 1) {
      total = (float)a.T * (float)g.S;  // the sum of the all-ones state
    } else {
      const int lo = cta_of((size_t)b * g.per, tiles, G), hi = cta_of((size_t)(b + 1) * g.per - 1, tiles, G);
      const float* row = a.part + (size_t)(c & 1) * (G + a.B) + b;
      float v = 0.0f;
      for (int x = lo + (int)threadIdx.x; x <= hi; x += 32) v += __ldcg(row + x);
      total = warp_sum(v);
    }
    if (threadIdx.x == 0) s.bc[kWarps] = (total / __ldg(a.in.scal + (size_t)b * a.C + c)) * (float)(1 << P);
  }
  __syncthreads();
  const float scaling = s.bc[kWarps];
  __syncthreads();
  return scaling;
}

// The first pass of column c > 0 or c == 0 over tile f of instance b:
// store the scaled beta and, at c > 0, write the next state's entries (the
// transmission product and the fold of this pass's birth slots) into
// beta_store[c - 1]; `last` scales them and adds their sum to the CTA's
// partial row.
template <int P>
__device__ void main_tile(const Args& a, const Smem& s, const Geo& g, int b, int c, size_t f, float inv, bool last,
                          float* part_row) {
  constexpr int NA = 1 << P;
  const int K = a.K, T = a.T, TP2 = T * 2 * P;
  const size_t S = g.S, col = (size_t)b * a.C + c;
  const uint32_t base = coset_base((uint32_t)s.meta[32], K, f);
  float* cur = a.beta_store + col * T * S;
  const float* diff_c = a.in.diff + col * K * TP2;
  const float* base_c = a.in.base + col * TP2;
  const float* pa = a.in.passign + col * T * NA;
  float* X = s.x[0];
  float* W = s.x[1];

  // load the incoming beta, store it scaled, and weight it by the emissions
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    const size_t at = (size_t)t * S + (base | s.off[l]);
    const float x = c == a.C - 1 ? 1.0f : __ldcg(cur + at);
    cur[at] = x * inv;
    if (c > 0) {
      float ab[2 * P];
      emission_sums<P>(diff_c, base_c, K, TP2, base | s.off[l], t, ab);
      float ws = 0.0f;
      for (int x_ = 0; x_ < NA; ++x_) ws += expf(lem_of<P>(ab, x_)) * __ldg(pa + t * NA + x_);
      W[t * g.ps + l] = x * ws;
    }
  }
  if (c == 0) return;
  __syncthreads();

  // the transmission product: X[tj](l) = sum_ti W[ti](l) * trans[tj*T + ti]
  const float* tr = a.in.trans + col * T * T;
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int tj = e >> g.lb, l = e & (g.ns - 1);
    const float* trow = tr + (size_t)tj * T;
    float acc = 0.0f;
    for (int ti = 0; ti < T; ++ti) acc += W[ti * g.ps + l] * __ldg(trow + ti);
    X[tj * g.ps + l] = acc;
  }
  fold_tile(X, g, (uint32_t)s.meta[33]);

  float* prev = cur - (size_t)T * S;
  float sum = 0.0f;
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    float v = X[t * g.ps + l];
    if (last) {
      v *= inv;
      sum += v;
    }
    prev[(size_t)t * S + (base | s.off[l])] = v;
  }
  if (last) {
    sum = block_sum(s, sum);
    if (threadIdx.x == 0) *part_row += sum;
  }
}

// A further pass of column c over tile f of instance b: fold this pass's
// birth slots of the next state in place in beta_store[c - 1]; `last`
// scales and sums as main_tile does.
__device__ void fold_pass_tile(const Args& a, const Smem& s, const Geo& g, int b, int c, size_t f, float inv,
                               bool last, float* part_row) {
  const size_t S = g.S, col = (size_t)b * a.C + c;
  const uint32_t base = coset_base((uint32_t)s.meta[32], a.K, f);
  float* prev = a.beta_store + (col - 1) * a.T * S;
  float* X = s.x[0];
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    X[t * g.ps + l] = __ldcg(prev + (size_t)t * S + (base | s.off[l]));
  }
  fold_tile(X, g, (uint32_t)s.meta[33]);
  float sum = 0.0f;
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    float v = X[t * g.ps + l];
    if (last) {
      v *= inv;
      sum += v;
    }
    prev[(size_t)t * S + (base | s.off[l])] = v;
  }
  if (last) {
    sum = block_sum(s, sum);
    if (threadIdx.x == 0) *part_row += sum;
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads) geno_backward_wide_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const Geo g = geometry(a.K, a.T);
  const Smem s = carve(reinterpret_cast<float*>(smem4), g, a.T, 2);
  const int G = gridDim.x, cta = blockIdx.x, C = a.C;
  const size_t tiles = (size_t)a.B * g.per;
  const size_t f0 = tiles * cta / G, f1 = tiles * (cta + 1) / G;
  const int b_lo = (int)(f0 / g.per), b_hi = (int)((f1 - 1) / g.per);

  gather_masks(a.in.flags, a.masks, a.npass, a.B, C, a.K, g.lb, true);
  grid.sync();

  for (int c = C - 1; c >= 0; --c) {
    // this CTA's partial rows of the next state's sums
    float* part_next = a.part + (size_t)((c + 1) & 1) * (G + a.B) + cta;
    if (threadIdx.x == 0 && c > 0)
      for (int b = b_lo; b <= b_hi; ++b) part_next[b] = 0.0f;
    const int np = __ldcg(a.npass + c);
    for (int p = 0; p < np; ++p) {
      int built = -1;  // the instance whose pass-p tables the CTA holds
      float inv = 0.0f;
      for (size_t f = f0; f < f1; ++f) {
        const int b = (int)(f / g.per);
        const uint32_t mask = __ldcg(a.masks + (size_t)b * C + c);
        const int nf = __popc(mask), nps = passes(nf, g.lb);
        if (p >= nps) continue;
        if (b != built) {
          build_tile(s, g, a.K, slot_range(mask, p * g.lb, min((p + 1) * g.lb, nf)));
          const float scaling = instance_scaling<P>(a, s, g, b, c, tiles);
          inv = 1.0f / scaling;
          if (p == 0 && threadIdx.x == 0 && f0 <= (size_t)b * g.per && (size_t)b * g.per < f1)
            a.scaling[(size_t)b * C + c] = scaling;
          built = b;
        }
        const bool last = p == nps - 1;
        if (p == 0) {
          main_tile<P>(a, s, g, b, c, f - (size_t)b * g.per, inv, last, part_next + b);
        } else {
          fold_pass_tile(a, s, g, b, c, f - (size_t)b * g.per, inv, last, part_next + b);
        }
        __syncthreads();  // the tile's shared memory is free again
      }
      grid.sync();
    }
  }
}

template <int P>
int launch(const Args& a, int max_ctas, cudaStream_t stream) {
  const Geo g = geometry(a.K, a.T);
  const size_t smem = smem_words(g, a.T, 2) * sizeof(float);
  return launch_grid(geno_backward_wide_kernel<P>, a, (size_t)a.B * g.per, max_ctas, smem, stream);
}

}  // namespace

// masks holds B*C words, npass C, part 2 * (max_ctas + B) floats (any
// contents); the launch takes at most max_ctas CTAs.
extern "C" int geno_backward_wide(const float* diff, const float* base, const float* passign, const float* trans,
                                  const uint8_t* birth, const float* dup, float* beta_store, float* scaling,
                                  uint32_t* masks, int* npass, float* part, int B, int C, int K, int T, int P,
                                  int max_ctas, cudaStream_t stream) {
  if (!geno_wide::shape_ok(B, C, K, T, P)) return (int)cudaErrorInvalidValue;
  Args a{{diff, base, passign, trans, birth, dup}, beta_store, scaling, masks, npass, part, B, C, K, T};
  switch (P) {
    case 2: return launch<2>(a, max_ctas, stream);
    case 4: return launch<4>(a, max_ctas, stream);
    case 6: return launch<6>(a, max_ctas, stream);
    case 8: return launch<8>(a, max_ctas, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* geno_backward_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
