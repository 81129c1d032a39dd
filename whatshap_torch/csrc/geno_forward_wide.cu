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
// state, plane and column takes 2P exps, the 2^P multiply-adds of red and
// the T multiply-adds of the transmission product.
//
// Design (geno_wide.cuh: tiles, windows, emission tables, the product).
// alpha lives in device memory (B, T, 2^K).  scaling is an input and red an
// output only, so nothing inside a window waits on the grid: a tile loads
// its alpha at the window's start, then for each column stages its
// beta_store tile (asynchronous copies, under the product), the product
// sum_prev = alpha x trans, the emissions in the owner mapping (each thread
// over its states of one plane for up to 16 allele assignments at a time: a
// sum of fwd * beta in a register for each, folded over the plane's threads
// by shuffles and added to the CTA's partial row of red for that window
// column) and the fold of sum_a fwd, the new alpha; it writes alpha back
// after the window's last column: one trip of the state a window.  Where
// more slots die than a tile has bits, further passes fold the next groups
// in place.  After a window's barrier every warp of the grid takes outputs
// of its red and sums the partial rows of the CTAs that cover its instance
// in rank order (rows by window parity, a row of T * 2^P a CTA, instance
// and window column: genotyping_cuda.wide_window_cap bounds the columns,
// and where a row is large, 1 MiB at T = 256, P = 10 and 4 MiB at T = 1024,
// P = 10, genotyping_cuda.wide_max_ctas the CTAs, so that the rows stay
// within WIDE_RED_BYTES).  The shapes: T = 1 (P = 2) or T = 4, 16, 64, 256,
// 1024 with P = 2, 4, 6, 8, 10, and any 1 <= K <= 23.

#include "geno_wide.cuh"

namespace {

using namespace geno_wide;

struct Args {
  In in;                   // flags = die_next, scal = scaling
  const float* beta_store; // (B, C, T, S)
  float* red;              // (B, C, T*2^P)
  float* alpha;            // (B, T, S) scratch: the state
  uint32_t* masks;         // (B, C) scratch: the dying slots of each column
  uint32_t* uq;            // (C,)   scratch: their union over the instances
  int* npass;              // (C,)   scratch: the passes of each column
  int* win;                // (C,)   scratch: the windows
  float* part;             // (2, wcap, G + B, T*2^P) scratch: partial rows of red
  int B, C, K, T, wcap;
};

// red of the W columns from c0 from the partial rows of parity par: a warp
// an output, its lanes over the covering CTAs' rows in rank order, then
// shuffles.
__device__ void reduce_red(const Args& a, const Geo& g, int c0, int W, int par, int TA, size_t tiles) {
  const size_t rs = (size_t)gridDim.x + a.B;
  const size_t warps = (size_t)gridDim.x * kWarps, outs = (size_t)W * a.B * TA;
  for (size_t o = ((size_t)blockIdx.x * kThreads + threadIdx.x) >> 5; o < outs; o += warps) {
    const int j = (int)(o % TA), b = (int)((o / TA) % a.B), w = (int)(o / ((size_t)TA * a.B));
    const float* rows = a.part + ((size_t)par * a.wcap + w) * rs * TA + j;
    const float v = rows_sum(rows, TA, b, g, tiles);
    if ((threadIdx.x & 31) == 0) a.red[((size_t)b * a.C + c0 + w) * TA + j] = v;
  }
}

// The emission step of column c for the tile (coset base cbase): red's sums
// into the CTA's partial row `prow` (stored where `first`) and sum_a fwd
// into A, fwd = (sp * em) * (passign / scaling) as the reference
// associates it (its range: sp * beta can fall below float32's).  Thread
// (t, r) takes its states of plane t (none where t >= T).
template <int T, int P>
__device__ __forceinline__ void emit_planes(const Smem& s, const Geo& g, float* A, const float* SP, const float* Bt, bool first_col,
                            bool has_beta, float inv, const float* __restrict__ diff_c,
                            const float* __restrict__ base_c, const float* __restrict__ pa_c, uint32_t cbase,
                            float* prow, bool first, int t) {
  constexpr int NA = 1 << P, NC = NA < kChunk ? NA : kChunk;
  const int r = threadIdx.x % g.tp;
  const bool active = t < T;
  const float* pa = pa_c + (active ? t : 0) * NA;
  EmRows<T, P> rows;
  if (active) rows.load(s, g, diff_c, base_c, cbase, t, r);
  for (int ch = 0; ch < NA / NC; ++ch) {
    const int a0 = ch * NC;
    float pinv[NC], acc[NC];
#pragma unroll
    for (int x = 0; x < NC; ++x) {
      pinv[x] = __ldg(pa + a0 + x) * inv;
      acc[x] = 0.0f;
    }
    if (active) {
#pragma unroll 2  // two states a step: two chains of exps in flight
      for (int k = 0; k < g.E; ++k) {
        const int l = r + g.tp * k;
        const float sp = first_col ? 1.0f : T == 1 ? fmaf(A[l], s.mat[0], 0.0f) : SP[t * g.ps + l];
        const float bt = has_beta ? Bt[t * g.ps + l] : 1.0f;
        float ab[2 * P];
        rows.sums(k, ab);
        Emis<P> em;
        em.from(ab);
        const float fs = em.fwd(ch, sp, bt, has_beta, pinv, acc);
        A[t * g.ps + l] = ch == 0 ? fs : A[t * g.ps + l] + fs;
      }
    }
    // this chunk's row entries so far, loaded under the folds by the threads that add to them
    float old[NC];
    const bool adder = g.tp <= 32 ? active && r == 0 : (int)threadIdx.x < T * NC;
#pragma unroll
    for (int x = 0; x < NC; ++x) old[x] = 0.0f;
    if (!first && adder) {
      if (g.tp <= 32) {
#pragma unroll
        for (int x = 0; x < NC; ++x) old[x] = __ldcg(prow + t * NA + a0 + x);
      } else {
        old[0] = __ldcg(prow + (threadIdx.x / NC) * NA + a0 + threadIdx.x % NC);
      }
    }
    // fold acc over the plane's threads and add it to the CTA's row
    if (g.tp <= 32) {
      for (int o = g.tp >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int x = 0; x < NC; ++x) acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], o);
      }
      if (adder) {
#pragma unroll
        for (int x = 0; x < NC; ++x) prow[t * NA + a0 + x] = old[x] + acc[x];
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
      if (adder) {  // T * tp <= kThreads
        const int pl = threadIdx.x / NC, x = threadIdx.x % NC;
        float v = 0.0f;
        for (int w = 0; w < wpp; ++w) v += s.red[(pl * wpp + w) * kChunk + x];
        prow[pl * NA + a0 + x] = old[0] + v;
      }
      __syncthreads();
    }
  }
}

// emit_planes over the tile's planes: thread (t, r) takes plane t =
// threadIdx.x / tp and, at T = 1024 (tp = 1: the owner mapping's 1,024
// threads), the planes kThreads apart from it, one pass each (a loop only
// there, where tp = 1 and a pass has no barrier; up to T = 256 one pass).
template <int T, int P>
__device__ void emit(const Smem& s, const Geo& g, float* A, const float* SP, const float* Bt, bool first_col,
                     bool has_beta, float inv, const float* __restrict__ diff_c, const float* __restrict__ base_c,
                     const float* __restrict__ pa_c, uint32_t cbase, float* prow, bool first) {
  if constexpr (T <= kThreads) {
    emit_planes<T, P>(s, g, A, SP, Bt, first_col, has_beta, inv, diff_c, base_c, pa_c, cbase, prow, first,
                      (int)threadIdx.x / g.tp);
  } else {
#pragma unroll 1
    for (int t = (int)threadIdx.x / g.tp; t < T; t += kThreads / g.tp)
      emit_planes<T, P>(s, g, A, SP, Bt, first_col, has_beta, inv, diff_c, base_c, pa_c, cbase, prow, first, t);
  }
}

// One tile (coset base cbase) of instance b through the window's columns
// c0, ..., c0 + W - 1 (tables built for them): red's partial rows of
// parity par, and alpha after the window.
template <int T, int P>
__device__ void run_tile(const Args& a, const Smem& s, const Geo& g, int b, uint32_t cbase, int c0, int W, int par,
                         bool first) {
  constexpr int TP2 = T * 2 * P, TA = T << P;
  const size_t S = g.S, TS = (size_t)T * S, rs = (size_t)gridDim.x + a.B;
  const int C = a.C;
  float* alpha = a.alpha + (size_t)b * TS;
  float* A = s.x[0];   // alpha, then sum_a fwd
  float* SP = s.x[1];  // sum_prev
  float* Bt = s.x[2];  // the tile's beta_store
  __syncthreads();  // the previous tile is no longer read
  if (c0 > 0) {
    for (int e = threadIdx.x; e < g.n; e += kThreads) {
      const int t = e >> g.lb, l = e & (g.ns - 1);
      A[t * g.ps + l] = __ldcg(alpha + (size_t)t * S + (cbase | s.off[l]));
    }
  }
  for (int w = 0; w < W; ++w) {
    const int c = c0 + w;
    const size_t col = (size_t)b * C + c;
    const bool first_col = c == 0, has_beta = c < C - 1;
    __syncthreads();  // A complete; the previous column's trans and beta tile are no longer read
    if (has_beta) {
      const float* beta = a.beta_store + col * TS;
      for (int e = threadIdx.x; e < g.n; e += kThreads) {
        const int t = e >> g.lb, l = e & (g.ns - 1);
        cp_async4(Bt + t * g.ps + l, beta + (size_t)t * S + (cbase | s.off[l]));
      }
    }
    const float* tr = a.in.trans + col * T * T;
    const float* diff_c = a.in.diff + col * a.K * TP2;
    const float* base_c = a.in.base + col * TP2;
    if (!first_col && T * T <= kMatWords) stage_mat<T>(s.mat, tr, 0, false);
    stage_slice<T, P>(s, a.K, diff_c, base_c);
    cp_async_wait_all();
    __syncthreads();
    if (!first_col && T > 1) {
      mat_product<T>(SP, A, s, g, tr, false);
      __syncthreads();
    }
    float* prow = a.part + (((size_t)par * a.wcap + w) * rs + blockIdx.x + b) * TA;
    emit<T, P>(s, g, A, SP, Bt, first_col, has_beta, 1.0f / __ldg(a.in.scal + col), diff_c, base_c,
               a.in.passign + col * TA, cbase, prow, first);
    if (has_beta) {
      __syncthreads();
      fold_tile(A, g, (uint32_t)s.meta[32 + w]);
    }
  }
  if (c0 + W - 1 < C - 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < g.n; e += kThreads) {
      const int t = e >> g.lb, l = e & (g.ns - 1);
      __stcg(alpha + (size_t)t * S + (cbase | s.off[l]), A[t * g.ps + l]);
    }
  }
}

// A further pass of column c over the tile (coset base cbase) of instance
// b: fold this pass's dying slots of alpha in place.
__device__ void fold_pass_tile(const Args& a, const Smem& s, const Geo& g, int b, uint32_t cbase) {
  const size_t S = g.S;
  float* alpha = a.alpha + (size_t)b * a.T * S;
  float* X = s.x[0];
  __syncthreads();
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    X[t * g.ps + l] = __ldcg(alpha + (size_t)t * S + (cbase | s.off[l]));
  }
  __syncthreads();
  fold_tile(X, g, (uint32_t)s.meta[32]);
  __syncthreads();
  for (int e = threadIdx.x; e < g.n; e += kThreads) {
    const int t = e >> g.lb, l = e & (g.ns - 1);
    __stcg(alpha + (size_t)t * S + (cbase | s.off[l]), X[t * g.ps + l]);
  }
}

template <int T, int P>
__global__ void __launch_bounds__(kThreads, 2) geno_forward_wide_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const Geo g = geometry(a.K, T);
  const Smem s = carve(reinterpret_cast<float*>(smem4), g, a.K, T, P, 3);
  const int G = gridDim.x, C = a.C, TA = T << P;
  const size_t tiles = (size_t)a.B * g.per;
  const size_t f0 = tiles * blockIdx.x / G, f1 = tiles * (blockIdx.x + 1) / G;

  prologue(grid, a.in.flags, a.masks, a.uq, a.npass, a.win, a.B, C, a.K, g.lb, a.wcap, false);

  int q = 0, j = 0, W = __ldcg(a.win), Wp = 0;
  while (q < C) {
    const int Wn = q + W < C ? __ldcg(a.win + q + W) : 0;
    if (j > 0) reduce_red(a, g, q - Wp, Wp, (j - 1) & 1, TA, tiles);
    const int c0 = q, np = __ldcg(a.npass + q);
    int built = -1;
    for (size_t f = f0; f < f1; ++f) {
      const int b = (int)(f / g.per);
      const size_t fl = f - (size_t)b * g.per;
      const uint32_t* mrow = a.masks + (size_t)b * C;
      if (b != built) {
        uint32_t fold = __ldcg(mrow + c0);
        if (np > 1) {
          fold = slot_range(fold, 0, min(g.lb, __popc(fold)));
        } else {
          for (int w = 1; w < W; ++w) fold |= __ldcg(mrow + c0 + w);
        }
        build_tile(s, g, a.K, fold, np > 1 ? nullptr : mrow, c0, 1, W);
        built = b;
      }
      run_tile<T, P>(a, s, g, b, coset_base((uint32_t)s.meta[24], a.K, fl), c0, W, j & 1, f == f0 || fl == 0);
    }
    grid.sync();
    // further passes of a column where more slots die than a tile has bits
    for (int p = 1; p < np; ++p) {
      built = -1;
      for (size_t f = f0; f < f1; ++f) {
        const int b = (int)(f / g.per);
        const size_t fl = f - (size_t)b * g.per;
        const uint32_t m = __ldcg(a.masks + (size_t)b * C + c0);
        const int nf = __popc(m);
        if (p >= passes(nf, g.lb)) continue;
        if (b != built) {
          build_tile(s, g, a.K, slot_range(m, p * g.lb, min((p + 1) * g.lb, nf)), nullptr, c0, 1, 1);
          built = b;
        }
        fold_pass_tile(a, s, g, b, coset_base((uint32_t)s.meta[24], a.K, fl));
      }
      grid.sync();
    }
    Wp = W;
    q += W;
    W = Wn;
    ++j;
  }
  reduce_red(a, g, q - Wp, Wp, (j - 1) & 1, TA, tiles);
}

template <int T, int P>
int launch(const Args& a, int max_ctas, cudaStream_t stream) {
  const Geo g = geometry(a.K, T);
  const size_t smem = smem_words(g, a.K, T, P, 3) * sizeof(float);
  return launch_grid(geno_forward_wide_kernel<T, P>, a, (size_t)a.B * g.per, max_ctas, smem, stream);
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

// alpha holds B*T*2^K floats, masks B*C words, uq, npass and win C each,
// part 2 * wcap * (max_ctas + B) * T * 2^P floats (any contents); the launch
// takes at most max_ctas CTAs and windows of at most wcap columns.
extern "C" int geno_forward_wide(const float* diff, const float* base, const float* passign, const float* trans,
                                 const uint8_t* die_next, const float* scaling, const float* beta_store, float* red,
                                 float* alpha, uint32_t* masks, uint32_t* uq, int* npass, int* win, float* part,
                                 int B, int C, int K, int T, int P, int wcap, int max_ctas, cudaStream_t stream) {
  if (!geno_wide::shape_ok(B, C, K, T, P, wcap)) return (int)cudaErrorInvalidValue;
  Args a{{diff, base, passign, trans, die_next, scaling}, beta_store, red, alpha, masks, uq, npass, win, part,
         B, C, K, T, wcap};
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

extern "C" const char* geno_forward_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
