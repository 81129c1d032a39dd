// Genotyping forward-backward HMM, backward pass, for Hopper (sm_90a), with
// the state in device memory: the shapes past the cluster kernel's envelope
// (geno_backward.cu: T = 1 to K = 17, T = 4 to 16, T = 16 to 13, P <= 4).
//
// Replaces the reference's XLA backward scan past its Pallas envelope:
// whatshap_tpu/ops/genotyping_jax.py `_forward_backward` (`bwd_step` and its
// lax.scan, with `_sum_fold`), as `_forward_backward_batched` runs it for
// stacked instances, at T = 1 (P = 2) or T = 4, 16, 64, 256, 1024 with P =
// 2, 4, 6, 8, 10, and any 1 <= K <= 23.  What it computes is geno_backward.cu's
// function: per instance, from column C-1 down to 0, with the scaled beta
// (T planes of 2^K floats, all ones before column C-1):
//
//   scaling[c] = (sum of beta / dup[c]) * 2^P, inv = 1 / scaling[c];
//   beta_store[c] = beta * inv;
//   weighted[t](i) = beta[t](i) * sum_a em[t, a](i) * passign[t, a], em the
//            exp of the emission sums (geno_wide.cuh Emis), float32 with
//            expf (no fast math);
//   beta[tj](i) = sum_ti weighted[ti](i) * trans[tj*T + ti], sum-folded over
//            the slots born entering c, times inv: the next column's state.
//
// NaN (a column whose allele-assignment prior sums to 0) is carried through,
// as the reference does.
//
// Bound: the kernel writes beta_store, 4*B*C*T*2^K bytes, and per state,
// plane and column takes 2P exps, the 2^P multiply-adds of em against
// passign and the T multiply-adds of the transmission product
// (chip_smoke.py time_geno_wide takes the larger of bytes and operations
// over their peak rates).  At T = 64 the operations bound it, at T = 1 the
// bytes.
//
// Design (geno_wide.cuh: tiles, windows, emission tables, the product).  The
// state is kept in beta_store itself: a window of columns c0, c0 - 1, ...
// reads its start state from beta_store[c0] and writes its end state,
// unscaled, into beta_store[c0 - W]; nothing beyond the output holds a
// plane.  scaling[c] is a sum over the whole instance, settled only after a
// grid barrier, so a window of W > 1 columns takes two phases over its
// tiles:
//
//   1. the sums: each tile runs the window's first W - 1 columns from the
//      start state without scaling (the state is linear in its start),
//      kept near 1 by exact powers of two of its own, and adds the sum of
//      each state, times its power of two, to its CTA's row of that column
//      in double (a window's columns may take the state far out of
//      float32's range).  After the barrier the scaling of window column w
//      is the fixed-order sum of the rows times the earlier columns'
//      inverse scalings: the same sums as one column at a time up to
//      rounding;
//   2. the store: the same columns again with the settled scalings, storing
//      beta_store, the arithmetic of one column at a time, and the end
//      state with its sums (the next window's start scaling).
//
// The window cap is the launch's (genotyping_cuda.wide_window_cap): a
// window of one column has no first phase, which is what the backward
// takes where the operations bound the pass (the second phase repeats
// them).  A column where more slots are born than a tile has bits folds the
// next groups in further passes in place in beta_store[c - 1]; the last one
// scales and sums.

#include "geno_wide.cuh"

namespace {

using namespace geno_wide;

struct Args {
  In in;              // flags = birth, scal = dup
  float* beta_store;  // (B, C, T, S)
  float* scaling;     // (B, C)
  uint32_t* masks;    // (B, C) scratch: the birth slots of each column
  uint32_t* uq;       // (C,)   scratch: their union over the instances, by pass order
  int* npass;         // (C,)   scratch: the passes of each column, by pass order
  int* win;           // (C,)   scratch: the windows, by pass order
  float* part;        // scratch: start sums by window parity (2, G + B), then the first phase's (wcap, G + B) doubles
  int B, C, K, T, wcap;
};

// The scalings of instance b at the window's columns c0 - w (w < W) into
// s.bc[kWarps + 2 + w], and with `out` into the scaling output: the start
// column's from the rows `start` (the sum of the all-ones state at C - 1),
// column w's from the first phase's rows w - 1 (the sum of the state run
// from the start without scaling, in double) times the product of the
// earlier columns' inverse scalings.  Every thread calls it.
template <int P>
__device__ void window_scalings(const Args& a, const Smem& s, const Geo& g, int b, int c0, int W, size_t tiles,
                                const float* start, const double* p1, bool out) {
  const size_t rs = (size_t)gridDim.x + a.B;
  const float* dup = a.in.scal + (size_t)b * a.C;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float total = c0 == a.C - 1 ? (float)a.T * (float)g.S : rows_sum(start, 1, b, g, tiles);
    float sw = (total / __ldg(dup + c0)) * (float)(1 << P);
    float mine = sw;
    double q = 1.0;
    for (int w = 1; w < W; ++w) {
      q *= (double)(1.0f / sw);
      const double sum = rows_sum(p1 + (size_t)(w - 1) * rs, 1, b, g, tiles);
      sw = (float)(((sum * q) / (double)__ldg(dup + c0 - w)) * (double)(1 << P));
      if (lane == w) mine = sw;
    }
    if (lane < W) {
      s.bc[kWarps + 2 + lane] = mine;
      if (out) a.scaling[(size_t)b * a.C + c0 - lane] = mine;
    }
  }
  __syncthreads();
}

// weighted = X * sum_a em * passign, in the owner mapping (the emission
// sums of geno_wide.cuh EmRows for the tile of coset base cbase), into Wt;
// at T = 1 times trans (the product of one plane: the same rounding), into
// X.  Thread (t, r) of plane t.
template <int T, int P>
__device__ __forceinline__ void weigh_plane(const Smem& s, const Geo& g, float* X, float* Wt, const float* __restrict__ diff_c,
                            const float* __restrict__ base_c, const float* __restrict__ pa_c, uint32_t cbase,
                            int t, int r) {
  constexpr int NA = 1 << P, NL = NA < 16 ? NA : 16, NH = NA / NL;
  EmRows<T, P> rows;
  rows.load(s, g, diff_c, base_c, cbase, t, r);
  const float* pa = pa_c + t * NA;
  float pv[NL];
  if constexpr (NH == 1) {
#pragma unroll
    for (int x = 0; x < NL; ++x) pv[x] = __ldg(pa + x);
  }
#pragma unroll 2  // two states a step: two chains of exps in flight
  for (int k = 0; k < g.E; ++k) {
    const int l = r + g.tp * k;
    float ab[2 * P];
    rows.sums(k, ab);
    Emis<P> em;
    em.from(ab);
    float ws;
    if constexpr (NH == 1) {
      ws = em.dot(pv);
    } else {
      ws = 0.0f;
#pragma unroll 1
      for (int ah = 0; ah < NH; ++ah) {
#pragma unroll
        for (int x = 0; x < NL; ++x) pv[x] = __ldg(pa + ah * NL + x);
        ws = fmaf(em.hi(ah), em.dot(pv), ws);
      }
    }
    if (T == 1) {
      X[l] = fmaf(X[l] * ws, s.mat[0], 0.0f);
    } else {
      Wt[t * g.ps + l] = X[t * g.ps + l] * ws;
    }
  }
}

// weigh_plane for every plane of the tile: thread (t, r) takes plane t =
// threadIdx.x / tp and, at T = 1024 (tp = 1: the owner mapping's 1,024
// threads), the planes kThreads apart from it (a loop only there: up to T
// = 256 a thread has one plane and no loop keeps its registers live).
template <int T, int P>
__device__ void weigh(const Smem& s, const Geo& g, float* X, float* Wt, const float* __restrict__ diff_c,
                      const float* __restrict__ base_c, const float* __restrict__ pa_c, uint32_t cbase) {
  const int r = threadIdx.x % g.tp;
  if constexpr (T <= kThreads) {
    const int t = threadIdx.x / g.tp;
    if (t < T) weigh_plane<T, P>(s, g, X, Wt, diff_c, base_c, pa_c, cbase, t, r);
  } else {
#pragma unroll 1
    for (int t = threadIdx.x / g.tp; t < T; t += kThreads / g.tp)
      weigh_plane<T, P>(s, g, X, Wt, diff_c, base_c, pa_c, cbase, t, r);
  }
}

// The tile's sum in a fixed order: each thread's own (entries in order), the
// warp's by shuffles into s.red[warp * kWin + slot]; see flush_sums.
__device__ __forceinline__ void keep_sum(const Smem& s, float v, int slot) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) s.red[(threadIdx.x >> 5) * kWin + slot] = v;
}

// The CTA's sums of slots [0, n) (warps in order) added to rows[slot * rs]
// (stored where `first`: the CTA's first tile of the instance).  The caller
// synced after the last keep_sum.
__device__ __forceinline__ void flush_sums(const Smem& s, float* rows, size_t rs, int n, bool first) {
  if ((int)threadIdx.x < n) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += s.red[w * kWin + threadIdx.x];
    float* at = rows + (size_t)threadIdx.x * rs;
    *at = first ? total : *at + total;
  }
}

// One tile (coset base cbase) of instance b through the window's columns c0,
// c0 - 1, ..., c0 - W + 1 (tables built for them; the scalings in s.bc).
// kStore: the second phase (store beta_store, scale each column by its own
// scaling, write the end state and its sum into `rows`, unscaled where not
// scale_end: a further fold pass follows).  Else the first phase: the
// columns to c0 - W + 2 without scaling, the tile's state kept near 1 by
// exact powers of two, 2^-E in all; the sum of each state times 2^E goes,
// in double, into the rows `drows` [w].
template <int T, int P, bool kStore>
__device__ void run_tile(const Args& a, const Smem& s, const Geo& g, int b, uint32_t cbase, int c0, int W,
                         bool scale_end, float* rows, double* drows, bool first) {
  constexpr int TP2 = T * 2 * P;
  const size_t S = g.S, TS = (size_t)T * S, rs = (size_t)gridDim.x + a.B;
  const int C = a.C;
  float* X = s.x[0];
  float* Wt = s.x[1];
  const float* start = a.beta_store + ((size_t)b * C + c0) * TS;
  __syncthreads();  // the previous tile is no longer read
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    X[t * g.ps + l] = c0 == C - 1 ? 1.0f : __ldcg(start + (size_t)t * S + (cbase | s.off[l]));
  }
  int E = 0;
  const int steps = kStore ? W : W - 1;
  for (int w = 0; w < steps; ++w) {
    const int c = c0 - w;
    const size_t col = (size_t)b * C + c;
    const float inv = 1.0f / s.bc[kWarps + 2 + w];
    __syncthreads();  // X complete; the previous column's trans is no longer read
    // this column's trans and emission rows, staged under the store
    const float* tr = a.in.trans + col * T * T;
    const float* diff_c = a.in.diff + col * a.K * TP2;
    const float* base_c = a.in.base + col * TP2;
    if (c > 0) {
      if (T * T <= kMatWords) stage_mat<T>(s.mat, tr, 0, true);
      stage_slice<T, P>(s, a.K, diff_c, base_c);
    }
    if (kStore) {
      float* cur = a.beta_store + col * TS;
      for (int e = threadIdx.x; e < g.n; e += kThreads) {
        const int t = e >> g.lb, l = e & (g.ns - 1);
        __stcs(cur + (size_t)t * S + (cbase | s.off[l]), X[t * g.ps + l] * inv);
      }
      if (c == 0) return;
    }
    cp_async_wait_all();
    __syncthreads();
    weigh<T, P>(s, g, X, Wt, diff_c, base_c, a.in.passign + col * (T << P), cbase);
    __syncthreads();
    if (T > 1) {
      mat_product<T>(X, Wt, s, g, tr, true);
      __syncthreads();
    }
    fold_tile(X, g, (uint32_t)s.meta[32 + w]);
    __syncthreads();
    if (!kStore) {
      float sum = 0.0f;
      for (int e = threadIdx.x; e < g.n; e += kThreads) sum += X[(e >> g.lb) * g.ps + (e & (g.ns - 1))];
      const float total = block_total(s, sum);
      if (threadIdx.x == 0) s.dsum[w] = (double)total * ldexp(1.0, E);
      const int e2 = isfinite(total) && total != 0.0f ? max(-126, min(126, ilogbf(total))) : 0;
      if (e2 != 0) {
        const float f = ldexpf(1.0f, -e2);
        E += e2;
        for (int e = threadIdx.x; e < g.n; e += kThreads) X[(e >> g.lb) * g.ps + (e & (g.ns - 1))] *= f;
      }
      continue;
    }
    const bool end = w == W - 1;
    const bool scale = !end || scale_end;
    float sum = 0.0f;
    for (int e = threadIdx.x; e < g.n; e += kThreads) {
      const int t = e >> g.lb, l = e & (g.ns - 1);
      float v = X[t * g.ps + l];
      if (scale) {
        v *= inv;
        sum += v;
      }
      if (end) {
        __stcg(a.beta_store + (col - 1) * TS + (size_t)t * S + (cbase | s.off[l]), v);
      } else {
        X[t * g.ps + l] = v;
      }
    }
    if (end && scale_end) keep_sum(s, sum, 0);
  }
  if (!kStore) {
    __syncthreads();
    if ((int)threadIdx.x < W - 1) {
      double* at = drows + (size_t)threadIdx.x * rs;
      *at = first ? s.dsum[threadIdx.x] : *at + s.dsum[threadIdx.x];
    }
  } else if (scale_end) {
    __syncthreads();
    flush_sums(s, rows, rs, 1, first);
  }
}

// A further pass of column c over the tile (coset base cbase) of instance
// b: fold this pass's birth slots of the next state in place in
// beta_store[c - 1]; `last` scales them and adds their sum to `row`.
__device__ void fold_pass_tile(const Args& a, const Smem& s, const Geo& g, int b, uint32_t cbase, int c, bool last,
                               float* row, bool first) {
  const size_t S = g.S;
  float* prev = a.beta_store + ((size_t)b * a.C + c - 1) * a.T * S;
  float* X = s.x[0];
  const float inv = 1.0f / s.bc[kWarps + 2];
  __syncthreads();  // the previous tile is no longer read
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    X[t * g.ps + l] = __ldcg(prev + (size_t)t * S + (cbase | s.off[l]));
  }
  __syncthreads();
  fold_tile(X, g, (uint32_t)s.meta[32]);
  __syncthreads();
  float sum = 0.0f;
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    float v = X[t * g.ps + l];
    if (last) {
      v *= inv;
      sum += v;
    }
    __stcg(prev + (size_t)t * S + (cbase | s.off[l]), v);
  }
  if (last) {
    keep_sum(s, sum, 0);
    __syncthreads();
    flush_sums(s, row, 0, 1, first);
  }
}

template <int T, int P>
__global__ void __launch_bounds__(kThreads, 2) geno_backward_wide_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const Geo g = geometry(a.K, T);
  const Smem s = carve(reinterpret_cast<float*>(smem4), g, a.K, T, P, 2);
  const int G = gridDim.x, cta = blockIdx.x, C = a.C;
  const size_t tiles = (size_t)a.B * g.per, rs = (size_t)G + a.B;
  const size_t f0 = tiles * cta / G, f1 = tiles * (cta + 1) / G;

  prologue(grid, a.in.flags, a.masks, a.uq, a.npass, a.win, a.B, C, a.K, g.lb, a.wcap, true);

  int q = 0, j = 0, W = __ldcg(a.win);
  while (q < C) {
    const int Wn = q + W < C ? __ldcg(a.win + q + W) : 0;
    const int c0 = C - 1 - q;
    const int np = __ldcg(a.npass + q);
    float* start = a.part + (size_t)(j & 1) * rs;     // sums of the window's start state
    float* next = a.part + (size_t)((j + 1) & 1) * rs;  // sums of its end state
    double* p1 = reinterpret_cast<double*>(a.part + 2 * rs);  // the first phase's, a row a column
    for (int phase = W > 1 ? 0 : 1; phase < 2; ++phase) {
      int built = -1;
      for (size_t f = f0; f < f1; ++f) {
        const int b = (int)(f / g.per);
        const size_t fl = f - (size_t)b * g.per;
        const bool first = f == f0 || fl == 0;
        const uint32_t* mrow = a.masks + (size_t)b * C;
        const uint32_t m = __ldcg(mrow + c0);
        const int nps = passes(__popc(m), g.lb);
        if (b != built) {
          uint32_t fold = m;
          if (np > 1) {
            fold = slot_range(m, 0, min(g.lb, __popc(m)));
          } else {
            for (int w = 1; w < W; ++w) fold |= __ldcg(mrow + c0 - w);
          }
          build_tile(s, g, a.K, fold, np > 1 ? nullptr : mrow, c0, -1, W);
          window_scalings<P>(a, s, g, b, c0, phase == 0 ? 1 : W, tiles, start, p1,
                             phase == 1 && f0 <= (size_t)b * g.per);
          built = b;
        }
        const uint32_t cbase = coset_base((uint32_t)s.meta[24], a.K, fl);
        if (phase == 0) {
          run_tile<T, P, false>(a, s, g, b, cbase, c0, W, true, nullptr, p1 + b + cta, first);
        } else {
          run_tile<T, P, true>(a, s, g, b, cbase, c0, W, nps == 1, next + b + cta, nullptr, first);
        }
      }
      grid.sync();
    }
    // further passes of a column where more slots are born than a tile has bits
    for (int p = 1; p < np; ++p) {
      int built = -1;
      for (size_t f = f0; f < f1; ++f) {
        const int b = (int)(f / g.per);
        const size_t fl = f - (size_t)b * g.per;
        const uint32_t m = __ldcg(a.masks + (size_t)b * C + c0);
        const int nf = __popc(m), nps = passes(nf, g.lb);
        if (p >= nps) continue;
        if (b != built) {
          build_tile(s, g, a.K, slot_range(m, p * g.lb, min((p + 1) * g.lb, nf)), nullptr, c0, -1, 1);
          window_scalings<P>(a, s, g, b, c0, 1, tiles, start, p1, false);
          built = b;
        }
        const bool first = f == f0 || fl == 0;
        fold_pass_tile(a, s, g, b, coset_base((uint32_t)s.meta[24], a.K, fl), c0, p == nps - 1, next + b + cta,
                       first);
      }
      grid.sync();
    }
    q += W;
    W = Wn;
    ++j;
  }
}

template <int T, int P>
int launch(const Args& a, int max_ctas, cudaStream_t stream) {
  const Geo g = geometry(a.K, T);
  const size_t smem = smem_words(g, a.K, T, P, 2) * sizeof(float);
  return launch_grid(geno_backward_wide_kernel<T, P>, a, (size_t)a.B * g.per, max_ctas, smem, stream);
}

template <int T>
int launch_t(const Args& a, int P, int max_ctas, cudaStream_t stream) {
  switch (P) {
    case 2: return launch<T, 2>(a, max_ctas, stream);
    case 4: return launch<T, 4>(a, max_ctas, stream);
    case 6: return launch<T, 6>(a, max_ctas, stream);
    case 8: return launch<T, 8>(a, max_ctas, stream);
    case 10: return launch<T, 10>(a, max_ctas, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// masks holds B*C words, uq, npass and win C each, part (2 + 2 * wcap) *
// (max_ctas + B) + 1 floats (any contents); the launch takes at most
// max_ctas CTAs and windows of at most wcap columns.
extern "C" int geno_backward_wide(const float* diff, const float* base, const float* passign, const float* trans,
                                  const uint8_t* birth, const float* dup, float* beta_store, float* scaling,
                                  uint32_t* masks, uint32_t* uq, int* npass, int* win, float* part, int B, int C,
                                  int K, int T, int P, int wcap, int max_ctas, cudaStream_t stream) {
  if (!geno_wide::shape_ok(B, C, K, T, P, wcap)) return (int)cudaErrorInvalidValue;
  Args a{{diff, base, passign, trans, birth, dup}, beta_store, scaling, masks, uq, npass, win, part, B, C, K, T, wcap};
  switch (T) {
    case 1: return launch<1, 2>(a, max_ctas, stream);
    case 4: return launch_t<4>(a, P, max_ctas, stream);
    case 16: return launch_t<16>(a, P, max_ctas, stream);
    case 64: return launch_t<64>(a, P, max_ctas, stream);
    case 256: return launch_t<256>(a, P, max_ctas, stream);
    case 1024: return launch_t<1024>(a, P, max_ctas, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The window rule of both wide genotyping kernels on the host, for a check
// against its mirror (genotyping_cuda.wide_windows): win[q] for the
// pass-order unions uq (C) at tile bits lb and window cap wcap.
extern "C" int geno_wide_windows(const uint32_t* uq, int C, int lb, int wcap, int* win) {
  if (C < 1 || lb < 1 || wcap < 1) return (int)cudaErrorInvalidValue;
  for (int lo = 0; lo < C; lo += wcap) geno_wide::window_rule(uq, lo, lo + wcap < C ? lo + wcap : C, lb, win);
  return 0;
}

extern "C" const char* geno_backward_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
