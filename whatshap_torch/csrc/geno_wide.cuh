// Shared pieces of the wide genotyping forward-backward kernels
// (geno_backward_wide.cu, geno_forward_wide.cu): the pedigree and coverage
// shapes past the cluster kernels' envelope (geno_cluster.cuh), whose state
// (T planes of 2^K floats an instance) does not fit on the chip.
//
// The state lives in device memory.  One cooperative launch holds as many
// CTAs as the card keeps resident (fewer where that gives no CTA a tile
// less: the tiles are shared out evenly), and a grid-wide barrier ends each
// pass over the state.  The unit of work is a tile: the coset of lb "tile
// bits" of the state index (2^lb = min(2^K, 4096 / T) states) in all T
// planes, at most 4096 entries, staged in shared memory (4 states of each
// of the 1,024 planes at T = 1024).
//
// Windows.  The columns go in windows, in the pass's order: as many columns
// (at most the launch's window cap, and never across a multiple of it) as
// keep the union of every instance's fold slots there within lb bits.  A
// tile's bits are then that union and the lowest other slots, so each of
// the window's columns (emissions, the T x T transmission product, the
// sum-fold, the partial sums) runs on the tile in shared memory: one trip
// of the state and one grid barrier a window.  A column where more than lb
// slots fold is a window of its own and takes further passes that fold the
// next groups, lb at a time, in ascending slot order, as the reference
// folds them one slot after another (_sum_fold).  window_rule below is the
// rule; genotyping_cuda.wide_windows mirrors it.
//
// Emissions in registers.  The emission sums of an entry are base + the
// diff rows of its set slots.  In the emission step thread (t, r) owns the
// states r + tp * k of plane t (k < E): they share the coset's slots and
// r's tile bits, so the thread sums base and those rows once a tile and
// column (loaded together, 16 bytes a load) and keeps the rows of k's
// tile bits in registers; a state's sums are the first plus its k bits'
// rows.  At P >= 4 an entry takes the 2P exps and products of them (em[t,
// a] is the product over p of exp(ab[2p + bit p of a])), factored by bit
// halves so that the sums against passign and red take a multiply-add an
// assignment; at P = 2 the exp of each lem sum, as many exps.
//
// The transmission product is a (T x T) by (T x ns) matrix product per
// tile, trans staged in shared memory (in slices of 16 rows at T = 256 and
// 1024), each thread holding a 4 x 4 block of outputs in registers fed by
// two 16-byte loads a step, each sum in ascending order of the inner index.
// At T = 1024 a thread owns four planes in the emission step (the owner
// mapping takes 1,024 threads there), and a tile of 4 states reads all of
// trans, 4 MiB a column: the product is dense T^2 multiply-adds a state.
//
// A reduction over the grid (the backward's scaling sum, the forward's red)
// is taken in a fixed order: each CTA sums its tiles of an instance in tile
// order into its own row of partials, and after the grid barrier every sum
// runs over the rows of the CTAs that cover the instance, in rank order.  No
// float atomics: two runs on one card give the same bits.  The row of (CTA
// x, instance b) is x + b: a CTA's tiles are one contiguous range, so the
// rows of all pairs that exist are distinct and fewer than G + B.
//
// Every index into the state and the tables is 64-bit (T * 2^K reaches 2^31
// at T = 256, K = 23, and 2^33 at T = 1024).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace geno_wide {

namespace cg = cooperative_groups;

constexpr int kMaxK = 23;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;     // entries (plane, state) of a tile
constexpr int kPer = 16;        // states of a plane a thread owns in the emission step
constexpr int kChunk = 16;      // allele assignments a forward thread sums at once
constexpr int kWin = 16;        // columns a window takes at most
constexpr int kMatWords = 4096; // floats of trans staged at once (at least 16 rows past T = 64)
constexpr int kSliceWords = 8192;  // floats of a column's base and diff rows staged at most
constexpr int kMeta = 64;       // ints: tile bit slots [0, 24), tile bits [24], fold bits per window column [32, 48)

// The per-column inputs in device memory (instance-major), as the cluster
// kernels take them.
struct In {
  const float* diff;     // (B, C, K, T*P*2)
  const float* base;     // (B, C, T*P*2)
  const float* passign;  // (B, C, T*2^P)
  const float* trans;    // (B, C, T*T), index tj*T + ti
  const uint8_t* flags;  // (B, C, K): birth (backward) or die_next (forward)
  const float* scal;     // (B, C): dup (backward) or scaling (forward)
};

__host__ __device__ inline int popc32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// A tile's geometry, the same on the host and the device.  In shared memory
// plane t of a tile starts at t * ps.  The emission step runs in an owner
// mapping: thread (t, r), t = tid / tp, owns the E states r + tp * k (k < E)
// of plane t; the padding of ps keeps a warp's lanes on distinct banks there
// and the rows 16-byte aligned for the product.  The emission tables split
// the lb tile bits into the h low ones (nlo rows) and the others (nhi rows).
struct Geo {
  int ns, lb, h, nlo, nhi;  // states of a tile and their bits; the tables' split
  int E, tp, ps, n;         // owned states a thread, threads a plane, plane stride, entries (T * ns)
  size_t S, per;            // states of an instance (2^K), tiles of an instance
};

__host__ __device__ inline Geo geometry(int K, int T) {
  Geo g;
  const int cap = kTile / T;
  g.ns = (1 << K) < cap ? 1 << K : cap;
  g.lb = 0;
  while ((1 << g.lb) < g.ns) ++g.lb;
  g.h = (g.lb + 1) / 2;
  g.nlo = 1 << g.h;
  g.nhi = 1 << (g.lb - g.h);
  g.E = g.ns < kPer ? g.ns : kPer;
  g.tp = g.ns / g.E;
  g.ps = g.ns + (g.tp < 4 ? 4 : g.tp < 32 ? g.tp : 0);
  g.n = T * g.ns;
  g.S = (size_t)1 << K;
  g.per = g.S / g.ns;
  return g;
}

// Passes a column takes where nf slots fold: one, and one more for each
// further group of lb.
__host__ __device__ inline int passes(int nf, int lb) { return nf > lb ? (nf + lb - 1) / lb : 1; }

// The window rule over the pass-order columns [q_lo, q_hi) of one block (q_lo
// a multiple of the window cap, q_hi = min(q_lo + cap, C)), given uq, the
// union over the instances of each column's fold slots: a window starts at
// q_lo and after each window; it takes the next column while the union of
// its columns' slots stays within lb bits.  win[q] is the length of the
// window that starts at q, 0 inside a window.
__host__ __device__ inline void window_rule(const uint32_t* uq, int q_lo, int q_hi, int lb, int* win) {
  int q = q_lo;
  while (q < q_hi) {
    uint32_t u = uq[q];
    int len = 1;
    if (popc32(u) <= lb) {
      while (q + len < q_hi && popc32(u | uq[q + len]) <= lb) {
        u |= uq[q + len];
        ++len;
      }
    }
    win[q] = len;
    for (int j = 1; j < len; ++j) win[q + j] = 0;
    q += len;
  }
}

// The fold slots of `mask` whose rank among them (ascending) is in [lo, hi).
__device__ __forceinline__ uint32_t slot_range(uint32_t mask, int lo, int hi) {
  uint32_t out = 0;
  int i = 0;
  for (uint32_t m = mask; m != 0 && i < hi; m &= m - 1, ++i) {
    if (i >= lo) out |= m & (0u - m);
  }
  return out;
}

// The bits of v deposited in ascending order into the set bits of mask.
__device__ __forceinline__ uint32_t deposit(uint32_t v, uint32_t mask) {
  uint32_t out = 0;
  for (uint32_t m = mask; m != 0 && v != 0; m &= m - 1, v >>= 1)
    if (v & 1) out |= m & (0u - m);
  return out;
}

// The bits of m at the set bits of mask, packed in ascending order.
__device__ __forceinline__ uint32_t compress(uint32_t m, uint32_t mask) {
  uint32_t out = 0;
  int q = 0;
  for (uint32_t b = mask; b != 0; b &= b - 1, ++q)
    if (m & b & (0u - b)) out |= 1u << q;
  return out;
}

// Shared memory, in floats: `planes` arrays of T * ps, trans (a slice of at
// most kMatWords), the tile's state offsets (ns), its tables (kMeta), the
// reduction scratch and the broadcast words.  Every region starts at a
// multiple of 4 floats.
struct Smem {
  float* x[3];
  float* mat;
  float* sl;      // the column's base and diff rows ((K + 1) * T*2P), where they fit kSliceWords; else null
  uint32_t* off;
  int* meta;
  float* red;     // [kWarps][kWin]
  float* bc;      // [kWarps + 2 + kWin]: block sums, broadcast words, the window's scalings
  double* dsum;   // [kWin]: a tile's sums of the backward's first phase
};

__host__ __device__ inline size_t up4(size_t n) { return (n + 3) & ~(size_t)3; }

// Rows of trans staged at once: all of it up to T = 64, else kMatWords
// floats but never fewer than 16 rows (64 KB at T = 1024).
__host__ __device__ constexpr int mat_rows(int T) {
  return T * T <= kMatWords ? T : (kMatWords / T < 16 ? 16 : kMatWords / T);
}

// The floats of a column's base and diff rows, staged in shared memory
// where they fit kSliceWords (else 0: read from the cache).
__host__ __device__ inline int slice_words(int K, int T, int P) {
  const int w = (K + 1) * T * 2 * P;
  return w <= kSliceWords ? w : 0;
}

__host__ __device__ inline size_t smem_words(const Geo& g, int K, int T, int P, int planes) {
  return up4((size_t)planes * T * g.ps) + up4((size_t)mat_rows(T) * T) + slice_words(K, T, P) + up4(g.ns) + kMeta +
         up4(kWarps * kWin + kWarps + 2 + kWin) + 2 * kWin;
}

__device__ __forceinline__ Smem carve(float* base, const Geo& g, int K, int T, int P, int planes) {
  Smem s;
  const size_t plane = (size_t)T * g.ps;
  for (int p = 0; p < 3; ++p) s.x[p] = base + (p < planes ? p : 0) * plane;
  float* at = base + up4(planes * plane);
  s.mat = at;
  at += up4((size_t)mat_rows(T) * T);
  const int sw = slice_words(K, T, P);
  s.sl = sw ? at : nullptr;
  at += sw;
  s.off = reinterpret_cast<uint32_t*>(at);
  at += up4(g.ns);
  s.meta = reinterpret_cast<int*>(at);
  s.red = at + kMeta;
  s.bc = s.red + kWarps * kWin;
  s.dsum = reinterpret_cast<double*>(s.red + up4(kWarps * kWin + kWarps + 2 + kWin));
  return s;
}

// The tile tables for the fold slots `fold` (at most lb of them): the tile
// bits (`fold`, then the lowest other slots, lb in all) with their slots in
// meta[0, lb) and the state bits of each local index in off.  The local fold
// bits of the window's columns go to meta[32 + w]: mrow (the instance's
// masks by column) at columns c0 + dir * w for w < W, or `fold` itself where
// mrow is null.  Every thread of the CTA calls it; it returns the tile bits.
__device__ uint32_t build_tile(const Smem& s, const Geo& g, int K, uint32_t fold, const uint32_t* mrow, int c0,
                               int dir, int W) {
  uint32_t bits = fold;
  int need = g.lb - __popc(fold);
  for (int k = 0; need > 0 && k < K; ++k) {
    if (!((bits >> k) & 1)) {
      bits |= 1u << k;
      --need;
    }
  }
  __syncthreads();  // the previous tile's tables are no longer read
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane < g.lb) s.meta[lane] = __fns(bits, 0, lane + 1);
    if (lane < W) s.meta[32 + lane] = (int)compress(mrow ? __ldcg(mrow + c0 + dir * lane) : fold, bits);
    if (lane == 0) s.meta[24] = (int)bits;
  }
  for (int l = threadIdx.x; l < g.ns; l += kThreads) s.off[l] = deposit((uint32_t)l, bits);
  __syncthreads();
  return bits;
}

// The state bits of tile f of an instance: f's bits deposited in ascending
// order into the slots that are not tile bits.
__device__ __forceinline__ uint32_t coset_base(uint32_t bits, int K, size_t f) {
  return deposit((uint32_t)f, ~bits & ((1u << K) - 1));
}

// An asynchronous 4-byte copy from device memory into shared memory, and
// the wait for all of a thread's copies (a barrier must follow).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Stage a column's base row and K diff rows (T*2P floats each) into s.sl,
// by asynchronous 16-byte copies (cp_async_wait_all and a barrier follow);
// nothing where they are read from the cache.
template <int T, int P>
__device__ __forceinline__ void stage_slice(const Smem& s, int K, const float* __restrict__ diff_c,
                                            const float* __restrict__ base_c) {
  constexpr int TP2 = T * 2 * P;
  if (s.sl == nullptr) return;
  for (int i = threadIdx.x; i < (K + 1) * (TP2 / 4); i += kThreads) {
    const int row = i / (TP2 / 4), q = i % (TP2 / 4);
    cp_async16(s.sl + row * TP2 + 4 * q, (row == 0 ? base_c : diff_c + (size_t)(row - 1) * TP2) + 4 * q);
  }
}

// Stage trans rows [r0, r0 + mat_rows) of column tr (index tj*T + ti) as
// mat[(r - r0)*T + o] by asynchronous copies (cp_async_wait_all and a
// barrier follow): the product's inner index r is ti and its output o is
// tj in the backward (transpose), r = tj and o = ti in the forward.
template <int T>
__device__ __forceinline__ void stage_mat(float* mat, const float* __restrict__ tr, int r0, bool transpose) {
  constexpr int R = mat_rows(T);
  if (T >= 1024 && transpose) {
    // read along trans's rows (r contiguous at tr[o * T + r]): four
    // consecutive r of one o a thread, a 16-byte load, stored as one word
    // in each of mat's rows r (synchronous: the caller's barrier follows)
    for (int i = threadIdx.x; i < R * T / 4; i += kThreads) {
      const int o = i / (R / 4), rq = i % (R / 4);
      const float4 v = __ldg(reinterpret_cast<const float4*>(tr + (size_t)o * T + r0 + 4 * rq));
      float* m = mat + (size_t)(4 * rq) * T + o;
      m[0] = v.x;
      m[T] = v.y;
      m[2 * T] = v.z;
      m[3 * T] = v.w;
    }
    return;
  }
  for (int i = threadIdx.x; i < R * T; i += kThreads) {
    const int r = r0 + i / T, o = i % T;
    cp_async4(mat + i, tr + (transpose ? o * T + r : r * T + o));
  }
}

// out[o](l) = sum_r in[r](l) * M[r, o] over the tile's planes, r ascending,
// with M staged in s.mat (all of it where T*T <= kMatWords; else staged
// here slice by slice from tr).  Every thread calls it; it ends behind a
// barrier where it staged slices, else the caller syncs.
template <int T>
__device__ void mat_product(float* out, const float* in, const Smem& s, const Geo& g, const float* __restrict__ tr,
                            bool transpose) {
  if (T == 1) {
    const float m = s.mat[0];
    for (int l = threadIdx.x; l < g.ns; l += kThreads) out[l] = fmaf(in[l], m, 0.0f);
    return;
  }
  if (g.ns < 4) {  // K = 1: one entry a thread, trans from the cache
    for (int e = threadIdx.x; e < g.n; e += kThreads) {
      const int o = e / g.ns, l = e % g.ns;
      float acc = 0.0f;
      for (int r = 0; r < T; ++r) acc = fmaf(in[r * g.ps + l], __ldg(tr + (transpose ? o * T + r : r * T + o)), acc);
      out[o * g.ps + l] = acc;
    }
    return;
  }
  constexpr int R = mat_rows(T);
  const int nlb = g.ns >> 2;
  const int ob = threadIdx.x / nlb, lq = threadIdx.x % nlb;
  const bool active = ob < T / 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int r0 = 0; r0 < T; r0 += R) {
    if (R < T) {
      __syncthreads();
      stage_mat<T>(s.mat, tr, r0, transpose);
      cp_async_wait_all();
      __syncthreads();
    }
    if (active) {
      const float* ip = in + (size_t)r0 * g.ps + 4 * lq;
      const float* mp = s.mat + 4 * ob;
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
        const float4 w = *reinterpret_cast<const float4*>(ip + (size_t)r * g.ps);
        const float4 m = *reinterpret_cast<const float4*>(mp + r * T);
        const float wv[4] = {w.x, w.y, w.z, w.w}, mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[j], mv[i], acc[i][j]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(out + (size_t)(4 * ob + i) * g.ps + 4 * lq) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if (R < T) __syncthreads();
}

// The emission sums of thread (t, r) in the owner mapping for one tile
// (coset base cbase) and column.  A state's sums are the diff rows of its
// set slots, then base, as the reference sums them (bits @ diff + base):
// here the rows of r's tile bits (state bits off[r]), of k's tile bits
// (the local bits log2(tp) + i, i < kb) and of the coset's slots, each
// part in ascending slot order (ascending over all the slots where no
// fold slot lies above a coset slot), then base.  The first, third and
// fourth parts are summed once a tile and column into registers (rpart,
// cpart, base_ab; rows loaded together, 16 bytes a load), the rows of k's
// bits read as they are added.  The rows come from the column's slice in
// shared memory (stage_slice) or, where it does not fit, from the cache.
template <int T, int P>
struct EmRows {
  static constexpr int J = 2 * P, J4 = J / 4, KB = 4;  // KB = log2(kPer)
  float rpart[J], cpart[J], base_ab[J];
  const float* rows[KB];
  int kb;

  __device__ __forceinline__ static float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

  // acc = the rows of m's slots of the plane's columns col (row stride T*2P), ascending
  __device__ __forceinline__ static void add_rows(float (&acc)[J], uint32_t m, const float* col) {
    constexpr int TP2 = T * J, NB = P <= 4 ? 4 : 2;  // rows a batch, loaded together
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = 0.0f;
    while (m != 0) {
      float4 v[NB][J4];
      uint32_t mm = m;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int k = mm != 0 ? __ffs(mm) - 1 : 0;
#pragma unroll
        for (int j = 0; j < J4; ++j) v[i][j] = mm != 0 ? ld4(col + (size_t)k * TP2 + 4 * j) : make_float4(0, 0, 0, 0);
        mm &= mm - 1;
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        if (m != 0) {
#pragma unroll
          for (int j = 0; j < J4; ++j) {
            acc[4 * j] += v[i][j].x;
            acc[4 * j + 1] += v[i][j].y;
            acc[4 * j + 2] += v[i][j].z;
            acc[4 * j + 3] += v[i][j].w;
          }
          m &= m - 1;
        }
      }
    }
  }

  __device__ __forceinline__ void load(const Smem& s, const Geo& g, const float* __restrict__ diff_c,
                                       const float* __restrict__ base_c, uint32_t cbase, int t, int r) {
    constexpr int TP2 = T * J;
    const float* col = (s.sl ? s.sl + TP2 : diff_c) + t * J;
    const float* bs = (s.sl ? s.sl : base_c) + t * J;
#pragma unroll
    for (int j = 0; j < J4; ++j) {
      const float4 b = ld4(bs + 4 * j);
      base_ab[4 * j] = b.x;
      base_ab[4 * j + 1] = b.y;
      base_ab[4 * j + 2] = b.z;
      base_ab[4 * j + 3] = b.w;
    }
    add_rows(rpart, s.off[r], col);
    add_rows(cpart, cbase, col);
    kb = g.lb - (31 - __clz(g.tp));
#pragma unroll
    for (int i = 0; i < KB; ++i) rows[i] = i < kb ? col + (size_t)(__ffs(s.off[g.tp << i]) - 1) * TP2 : col;
  }

  // ab of the thread's state k
  __device__ __forceinline__ void sums(int k, float (&ab)[J]) const {
#pragma unroll
    for (int j = 0; j < J; ++j) ab[j] = rpart[j];
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      if (i < kb && ((k >> i) & 1)) {
#pragma unroll
        for (int j = 0; j < J4; ++j) {
          const float4 d = ld4(rows[i] + 4 * j);
          ab[4 * j] += d.x;
          ab[4 * j + 1] += d.y;
          ab[4 * j + 2] += d.z;
          ab[4 * j + 3] += d.w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) ab[j] = (ab[j] + cpart[j]) + base_ab[j];
  }
};

// The emissions of one entry.  At P = 2: em[a] = exp of lem(a) = ab[bit 0
// of a] + ab[2 + bit 1 of a], a < 4.  At P >= 4: the exps e[j] = exp(ab[j]),
// em[a] = q0[a & 3] * q1[(a >> 2) & 3] * hi(a >> 4), q0 and q1 the products
// over p < 2 and 2 <= p < 4 and hi over p >= 4 (1 at P = 4); the backward's
// sum against passign factored by those halves (a multiply-add an
// assignment).
template <int P>
struct Emis {
  float q0[4], q1[4];
  float eh[P > 4 ? 2 * P - 8 : 1];

  __device__ __forceinline__ void from(const float (&ab)[2 * P]) {
    if constexpr (P == 2) {
#pragma unroll
      for (int a = 0; a < 4; ++a) q0[a] = expf(ab[a & 1] + ab[2 + ((a >> 1) & 1)]);
    } else {
      float e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = expf(ab[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q0[i] = e[i & 1] * e[2 + (i >> 1)];
        q1[i] = e[4 + (i & 1)] * e[6 + (i >> 1)];
      }
      if constexpr (P > 4) {
#pragma unroll
        for (int j = 0; j < 2 * P - 8; ++j) eh[j] = expf(ab[8 + j]);
      }
    }
  }
  // the product over p >= 4 for the assignments a_hi * 16 + x (selects: a_hi
  // known at run time)
  __device__ __forceinline__ float hi(int a_hi) const {
    if constexpr (P <= 4) {
      return 1.0f;
    } else {
      float v = (a_hi & 1) ? eh[1] : eh[0];
#pragma unroll
      for (int p = 1; p < P - 4; ++p) v *= ((a_hi >> p) & 1) ? eh[2 * p + 1] : eh[2 * p];
      return v;
    }
  }
  // sum over x < NL (16, or 4 at P = 2) of em(a_hi * 16 + x) * w[x], without hi
  template <int NL>
  __device__ __forceinline__ float dot(const float (&w)[NL]) const {
    if constexpr (P == 2) {
      float v = 0.0f;
#pragma unroll
      for (int x = 0; x < 4; ++x) v = fmaf(q0[x], w[x], v);
      return v;
    } else {
      float v = 0.0f;
#pragma unroll
      for (int xh = 0; xh < 4; ++xh) {
        float inner = 0.0f;
#pragma unroll
        for (int xl = 0; xl < 4; ++xl) inner = fmaf(q0[xl], w[4 * xh + xl], inner);
        v = fmaf(q1[xh], inner, v);
      }
      return v;
    }
  }
  // The forward's step for assignments a_hi * 16 + x (x < NL): fwd = (sp *
  // em) * pinv[x], acc[x] += fwd * bt (bt = 1 without beta); returns the
  // sum of fwd over x, ascending.
  template <int NL>
  __device__ __forceinline__ float fwd(int a_hi, float sp, float bt, bool has_beta, const float (&pinv)[NL],
                                       float (&acc)[NL]) const {
    const float h = hi(a_hi);
    float fs = 0.0f;
#pragma unroll
    for (int x = 0; x < NL; ++x) {
      float e = P == 2 ? q0[x] : q0[x & 3] * q1[x >> 2];
      if (P > 4) e *= h;
      const float f = (sp * e) * pinv[x];
      fs += f;
      acc[x] = has_beta ? fmaf(f, bt, acc[x]) : acc[x] + f;
    }
    return fs;
  }
};

// Sum-fold the tile x over its local fold bits qf, in ascending order: both
// partners of a pair take lo + hi, as _sum_fold writes the pair's sum to
// both halves.  Every thread of the CTA calls it; the caller syncs before
// and after (a barrier between two bits).
__device__ void fold_tile(float* x, const Geo& g, uint32_t qf) {
  const int half = g.n >> 1, hb = g.lb - 1;
  for (uint32_t m = qf; m != 0; m &= m - 1) {
    const int q = __ffs(m) - 1;
    if (m != qf) __syncthreads();
    for (int p = threadIdx.x; p < half; p += kThreads) {
      const int t = p >> hb, pl = p & ((1 << hb) - 1);
      const int lo = ((pl >> q) << (q + 1)) | (pl & ((1 << q) - 1));
      float* row = x + (size_t)t * g.ps;
      const float v = row[lo] + row[lo | (1 << q)];
      row[lo] = v;
      row[lo | (1 << q)] = v;
    }
  }
}

template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sum of v in a fixed order (threads' own sums, warp shuffles,
// warps in order), in every thread.  Every thread calls it.
__device__ __forceinline__ float block_total(const Smem& s, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) s.bc[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kWarps; ++w) total += s.bc[w];
  __syncthreads();
  return total;
}

// The CTA that holds tile t: f0(x) = tiles * x / G <= t < f0(x + 1).
__device__ __forceinline__ int cta_of(size_t t, size_t tiles, int G) {
  int x = (int)((t * (size_t)G) / tiles);
  while (x + 1 < G && tiles * (size_t)(x + 1) / G <= t) ++x;
  while (x > 0 && tiles * (size_t)x / G > t) --x;
  return x;
}

// The fixed-order sum of the partial rows rows[x] of the CTAs x that cover
// instance b (lanes over the rows in rank order, then shuffles), in every
// lane of the calling warp.
template <typename F>
__device__ __forceinline__ F rows_sum(const F* rows, size_t stride, int b, const Geo& g, size_t tiles) {
  const int G = gridDim.x, lane = threadIdx.x & 31;
  const int lo = cta_of((size_t)b * g.per, tiles, G), hi = cta_of((size_t)(b + 1) * g.per - 1, tiles, G);
  F v = 0;
  for (int x = lo + lane; x <= hi; x += 32) v += __ldcg(rows + (size_t)(x + b) * stride);
  return warp_sum(v);
}

// Prologue of both kernels.  A warp a column gathers every instance's fold
// slots there into masks (B, C), and by pass order q (the column c = q, or C
// - 1 - q for the backward) their union over the instances into uq and the
// column's pass count into npass (the most any instance needs); with
// `backward`, column 0 folds nothing (the state after it is not needed).
// Then a thread a block of wcap columns takes the window rule into win.
// Ends behind a grid barrier.
__device__ void prologue(cg::grid_group& grid, const uint8_t* flags, uint32_t* masks, uint32_t* uq, int* npass,
                         int* win, int B, int C, int K, int lb, int wcap, bool backward) {
  const int lane = threadIdx.x & 31;
  const size_t warps = (size_t)gridDim.x * kWarps;
  for (size_t w = ((size_t)blockIdx.x * kThreads + threadIdx.x) >> 5; w < (size_t)C; w += warps) {
    int np = 1;
    uint32_t u = 0;
    for (int b = lane; b < B; b += 32) {
      const size_t col = (size_t)b * C + w;
      uint32_t m = 0;
      if (!(backward && w == 0))
        for (int k = 0; k < K; ++k) m |= (flags[col * K + k] ? 1u : 0u) << k;
      masks[col] = m;
      u |= m;
      np = max(np, passes(__popc(m), lb));
    }
    np = __reduce_max_sync(0xffffffffu, np);
    u = __reduce_or_sync(0xffffffffu, u);
    const size_t q = backward ? (size_t)C - 1 - w : w;
    if (lane == 0) {
      npass[q] = np;
      uq[q] = u;
    }
  }
  grid.sync();
  const size_t threads = (size_t)gridDim.x * kThreads;
  for (size_t blk = (size_t)blockIdx.x * kThreads + threadIdx.x; blk * wcap < (size_t)C; blk += threads) {
    const int lo = (int)(blk * wcap);
    window_rule(uq, lo, min(C, lo + wcap), lb, win);
  }
  grid.sync();
}

// One cooperative launch of `kernel` over `tiles` tiles: as many CTAs as the
// card keeps resident, no more than max_ctas (the rows of partials the
// caller allocated beside B), and then the fewest that give no CTA more
// tiles (the tiles of CTA x are [tiles * x / G, tiles * (x + 1) / G)).
template <typename Kernel, typename Args>
int launch_grid(Kernel kernel, const Args& a, size_t tiles, int max_ctas, size_t smem, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1 || max_ctas < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  size_t grid = (size_t)sms * per_sm;
  if (tiles < grid) grid = tiles;
  if ((size_t)max_ctas < grid) grid = (size_t)max_ctas;
  const size_t most = (tiles + grid - 1) / grid;  // tiles of the busiest CTA
  grid = (tiles + most - 1) / most;
  Args args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)grid), dim3(kThreads), params, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The shape checks of both entry points: the wide envelope.
inline bool shape_ok(int B, int C, int K, int T, int P, int wcap) {
  if (B < 1 || C < 1 || K < 1 || K > kMaxK || wcap < 1 || wcap > kWin) return false;
  if (T == 1) return P == 2;
  return (T == 4 || T == 16 || T == 64 || T == 256 || T == 1024) && (P == 2 || P == 4 || P == 6 || P == 8 || P == 10);
}

}  // namespace geno_wide
