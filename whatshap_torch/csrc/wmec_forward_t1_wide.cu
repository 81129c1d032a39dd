// T=1 wMEC forward column scan for Hopper (sm_90a) with the state in device
// memory, for blocks past the thread-block cluster's envelope (K 18 to 23).
//
// Replaces the reference's XLA scan at T = 1 where its Pallas kernel refuses
// the shape: whatshap_tpu/ops/wmec.py `_forward_scan_impl` (with `_fold_dying`
// and `_col_cost`), as `solve_batched` and `_solve_scan` run it with tables
// and as the segmented `solve_scan_segmented` runs it in its two passes,
// `_forward_carry_scan` (no tables) and `_forward_tables_scan` (tables from a
// carry).  The same two modes as wmec_forward_t1.cu, at any 1 <= K <= 23:
//
//   tables   the projection table of every column and the final state, from
//            a zero state or from a carried one (cost0, key0; null for zero):
//            entry point wmec_forward_t1_wide;
//   carry    the final state only, no table: wmec_forward_carry_t1_wide.
//
// What it computes, per column c over the 2^K bipartitions s of the block's
// read slots (the function of wmec_forward_t1.cu, which its header states):
// fold every slot that died before c, in ascending slot order, the pair (s,
// s | 1 << p) taking the winner under (cost, tie key), the partner winning
// only when strictly better, BOTH receiving the winner's cost, key and source
// index (the carry mode keeps no index, and there the fold is a min of the
// costs); pidx[b, c, s] = the source index (the identity in a column where
// nothing dies); then add the column cost, min over the four allele
// assignments of min(s0 + d + acost, INF), to the folded cost, saturating at
// INF = 1 << 29; the new tie key is the inverse Gray code of the rank sum.
// All int32, as the reference's (its f32 sums of integer weights are exact).
//
// Bound: in the tables mode the table write, B*C*2^K*4 bytes (2 GiB a block
// at K = 23 and 64 columns), against about 5*B*C*2^K int32 adds; the bytes
// bound it (wmec_forward_t1.cu's reckoning).  The carry mode writes only the
// final state and is bound by the adds.
//
// Design: simple and right.  A block's state at K = 23 is 8M states, 32 MiB a
// plane, beyond any cluster's shared memory, so it lives in device memory:
// the cost plane is the output dp_last itself, updated in place.  The tie key
// is not stored: before column c's fold it is a function of the state index
// (the inverse Gray code of the rank sum over column c - 1's slots, or the
// carried key0 at column 0), and a fold moves it with the winner's source
// index, so a folded entry's key is that function at its index.  One
// cooperative launch holds as many CTAs as the card keeps resident; grid-wide
// barriers separate the passes.  A column is max(1, ceil(|D| / 4)) passes,
// |D| the most slots that die before it in any block of the launch: a pass
// folds up to 4 dying slots (the next 4 in ascending order), a thread holding
// the 2^g states of each of its cosets of those g slots in registers, so a
// pair never straddles two threads and both partners come from the same
// generation of the plane; the last pass of the column also adds the column
// cost (and in the tables mode writes the column's table row, which the
// earlier passes used to carry the source index).  A block's passes end with
// the column's last pass, so a block where fewer slots die waits out the
// first ones.  A pass walks the blocks' states in tiles of 4096 (16 a thread,
// all loaded before any is folded), each CTA a contiguous run of tiles; the column sums come from three tables
// of 256 int4 in shared memory, one per 8 bits of the state index (the sums
// over those bits of s0, d_0, d_1 and the rank weight; base costs in the
// lowest), rebuilt where a CTA's tiles pass into another block.  Every index
// into the state and the tables is 64-bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxK = 23;
constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;
constexpr int kPer = 16;                   // states a thread takes in a tile
constexpr int kTile = kThreads * kPer;     // states a tile
constexpr int kGroup = 4;                  // dying slots a pass folds at most (2^4 = kPer)
constexpr int kChunk = 8;                  // state index bits a sums table covers
constexpr int kRows = 1 << kChunk;

struct Args {
  const float* wdiff;    // (B, C, K, 4)
  const int* wbase;      // (B, C, 1, 2, 2)
  const float* rankw;    // (B, C, K)
  const int* acost;      // (B, C, 1, 4)
  const uint8_t* die;    // (B, C, K)
  const int* cost0;      // (B, S) or null: carried cost
  const int* key0;       // (B, S) or null: carried tie key (tables mode)
  int* pidx;             // (B, C, S)  tables mode
  int* cost;             // (B, S)     the state, and dp_last after the last column
  int* key_last;         // (B, S)
  int* masks;            // (B, C)     scratch: the dying slots of each column
  int* npass;            // (C,)       scratch: the passes of each column
  int B, C, K;
};

// The shared memory of a CTA: the column's staged record and its sums tables
// (column c's cost sums and rank sums, column c - 1's rank sums for the keys).
struct Smem {
  int4 sums[3][kRows];   // {s0, d_0, d_1, rank} over the bits of each chunk
  int rank_prev[3][kRows];
  int4 wd[kMaxK];        // wdiff of the column, as int
  int rw[kMaxK], rw_prev[kMaxK];
  int wb[4], ac[4];
};

__device__ __forceinline__ int inverse_gray(int r, int K) {
#pragma unroll
  for (int sh = 1; sh < 32; sh <<= 1) {
    if (sh < K) r ^= r >> sh;
  }
  return r;
}

// Stage column c of block b and build its sums tables.  Every thread of the
// CTA calls it (two barriers).
__device__ void build_tables(const Args& a, Smem& sm, int b, int c) {
  const int K = a.K, tid = threadIdx.x;
  const size_t col = (size_t)b * a.C + c;
  __syncthreads();  // the tables of the previous tile are no longer read
  for (int e = tid; e < 4 * K; e += kThreads) {
    reinterpret_cast<int*>(sm.wd)[e] = (int)__ldg(a.wdiff + col * 4 * K + e);
  }
  for (int e = tid; e < K; e += kThreads) {
    sm.rw[e] = (int)__ldg(a.rankw + col * K + e);
    sm.rw_prev[e] = c > 0 ? (int)__ldg(a.rankw + (col - 1) * K + e) : 0;
  }
  if (tid < 4) {
    sm.wb[tid] = __ldg(a.wbase + col * 4 + tid);
    sm.ac[tid] = __ldg(a.acost + col * 4 + tid);
  }
  __syncthreads();
  const uint32_t all = (1u << K) - 1;
  for (int e = tid; e < 3 * kRows; e += kThreads) {
    const int j = e / kRows, v = e % kRows;
    uint32_t bits = ((uint32_t)v << (kChunk * j)) & all;
    int4 x = j == 0 ? make_int4(sm.wb[0] + sm.wb[2], sm.wb[1] - sm.wb[0], sm.wb[3] - sm.wb[2], 0)
                    : make_int4(0, 0, 0, 0);
    int rp = 0;
    for (; bits != 0; bits &= bits - 1) {
      const int k = __ffs(bits) - 1;
      const int4 w = sm.wd[k];
      x.x += w.x + w.z;
      x.y += w.y - w.x;
      x.z += w.w - w.z;
      x.w += sm.rw[k];
      rp += sm.rw_prev[k];
    }
    sm.sums[j][v] = x;
    sm.rank_prev[j][v] = rp;
  }
  __syncthreads();
}

__device__ __forceinline__ int4 sums_of(const Smem& sm, uint32_t s) {
  const int4 lo = sm.sums[0][s & (kRows - 1)], mid = sm.sums[1][(s >> kChunk) & (kRows - 1)],
             hi = sm.sums[2][s >> (2 * kChunk)];
  return make_int4(lo.x + mid.x + hi.x, lo.y + mid.y + hi.y, lo.z + mid.z + hi.z, lo.w + mid.w + hi.w);
}

// One tile's cosets of the pass's g = G slots pos[0] < ... < pos[G-1]: a
// thread takes kPer >> G cosets of 2^G states (kPer states, loaded before any
// is folded), folds them in registers and writes them back; on the column's
// last pass it also writes the table row (tables mode) and the new cost, and
// after the last column the key.
template <int G, bool kTab>
__device__ void run_tile(const Args& a, const Smem& sm, int b, int c, size_t tile, const int* pos_in,
                         bool first, bool last_pass) {
  constexpr int M = 1 << G;
  constexpr int NC = kPer >> G;
  const int K = a.K;
  const size_t S = (size_t)1 << K;
  const size_t n_cos = S >> G;
  const size_t u0 = tile * (size_t)(kTile >> G);
  int* plane = a.cost + (size_t)b * S;
  int* row = kTab ? a.pidx + ((size_t)b * a.C + c) * S : nullptr;
  const bool from_carry = c == 0 && first;  // the state is still cost0 (or zero)
  const int* cost0 = a.cost0 != nullptr ? a.cost0 + (size_t)b * S : nullptr;
  const int* key0 = a.key0 != nullptr ? a.key0 + (size_t)b * S : nullptr;

  int pos[G > 0 ? G : 1];
  uint32_t off[M];
#pragma unroll
  for (int j = 0; j < G; ++j) pos[j] = pos_in[j];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    uint32_t o = 0;
#pragma unroll
    for (int j = 0; j < G; ++j) o |= (uint32_t)((m >> j) & 1) << pos[j];
    off[m] = o;
  }
  uint32_t st[kPer];
  bool ok[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const size_t u = u0 + threadIdx.x + (size_t)i * kThreads;
    ok[i] = u < n_cos;
    // the coset's lowest state: u with a zero bit inserted at each slot
    uint32_t base = (uint32_t)u;
#pragma unroll
    for (int j = 0; j < G; ++j) base = ((base >> pos[j]) << (pos[j] + 1)) | (base & ((1u << pos[j]) - 1));
#pragma unroll
    for (int m = 0; m < M; ++m) st[i * M + m] = base | off[m];
  }
  int cv[kPer], kv[kPer], iv[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (!ok[e / M]) continue;
    const uint32_t s = st[e];
    cv[e] = from_carry ? (cost0 != nullptr ? __ldg(cost0 + s) : 0) : __ldcg(plane + s);
    iv[e] = (int)s;
    kv[e] = 0;
    if (kTab && G > 0) {
      if (!first) iv[e] = __ldcg(row + s);
      const uint32_t src = (uint32_t)iv[e];
      if (c > 0) {
        kv[e] = inverse_gray(sm.rank_prev[0][src & (kRows - 1)] + sm.rank_prev[1][(src >> kChunk) & (kRows - 1)] +
                                 sm.rank_prev[2][src >> (2 * kChunk)],
                             K);
      } else if (key0 != nullptr) {
        kv[e] = __ldg(key0 + src);
      }
    }
  }
  // the folds, slot by slot in ascending order: (m, m | 2^j) is the pair
  // (s, s | 2^pos[j]); the partner wins only when strictly better
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if ((m >> j) & 1) continue;
        const int e = i * M + m, e1 = e | (1 << j);
        if (kTab) {
          const bool partner = cv[e1] < cv[e] || (cv[e1] == cv[e] && kv[e1] < kv[e]);
          if (partner) {
            cv[e] = cv[e1];
            kv[e] = kv[e1];
            iv[e] = iv[e1];
          } else {
            cv[e1] = cv[e];
            kv[e1] = kv[e];
            iv[e1] = iv[e];
          }
        } else {
          cv[e] = cv[e1] = min(cv[e], cv[e1]);
        }
      }
    }
  }
  const bool last_col = c == a.C - 1;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (!ok[e / M]) continue;
    const uint32_t s = st[e];
    if (!last_pass) {
      plane[s] = cv[e];
      if (kTab) row[s] = iv[e];
      continue;
    }
    if (kTab) __stcs(row + s, iv[e]);
    const int4 x = sums_of(sm, s);
    const int s0 = x.x, d0 = x.y, d1 = x.z;
    const int cc = min(min(min(s0 + sm.ac[0], kInf), min(s0 + d0 + sm.ac[1], kInf)),
                       min(min(s0 + d1 + sm.ac[2], kInf), min(s0 + d0 + d1 + sm.ac[3], kInf)));
    plane[s] = min(cc + min(cv[e], kInf), kInf);
    if (last_col) a.key_last[(size_t)b * S + s] = inverse_gray(x.w, K);
  }
}

template <bool kTab>
__device__ __forceinline__ void dispatch_tile(int g, const Args& a, const Smem& sm, int b, int c, size_t tile,
                                              const int* pos, bool first, bool last_pass) {
  switch (g) {
    case 0: run_tile<0, kTab>(a, sm, b, c, tile, pos, first, last_pass); break;
    case 1: run_tile<1, kTab>(a, sm, b, c, tile, pos, first, last_pass); break;
    case 2: run_tile<2, kTab>(a, sm, b, c, tile, pos, first, last_pass); break;
    case 3: run_tile<3, kTab>(a, sm, b, c, tile, pos, first, last_pass); break;
    default: run_tile<4, kTab>(a, sm, b, c, tile, pos, first, last_pass); break;
  }
}

// Two CTAs an SM: a thread is held to 128 registers, which its 16 states
// (cost, key, index and place) take without spilling (168 unbounded, one CTA
// an SM: 1.6x slower in the tables mode at 16 blocks x 64 columns at K = 20
// on an H100).
template <bool kTab>
__global__ void __launch_bounds__(kThreads, 2) forward_t1_wide_kernel(Args a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, C = a.C, K = a.K;
  const size_t S = (size_t)1 << K;

  // prologue: a warp a column gathers every block's dying slots there and
  // the column's passes, the most any block needs
  const int lane = threadIdx.x & 31;
  const size_t warps = (size_t)gridDim.x * (kThreads / 32);
  for (size_t w = grid.thread_rank() / 32; w < (size_t)C; w += warps) {
    int np = 1;
    for (int b = lane; b < B; b += 32) {
      const uint8_t* d = a.die + ((size_t)b * C + w) * K;
      int m = 0;
      for (int k = 0; k < K; ++k) m |= d[k] ? 1 << k : 0;
      a.masks[(size_t)b * C + w] = m;
      np = max(np, (__popc(m) + kGroup - 1) / kGroup);
    }
    np = __reduce_max_sync(0xffffffffu, np);
    if (lane == 0) a.npass[w] = np;
  }
  grid.sync();

  const size_t per_block = (S + kTile - 1) / kTile;  // tiles a block
  const size_t n_tiles = (size_t)B * per_block;
  const size_t t0 = n_tiles * blockIdx.x / gridDim.x, t1 = n_tiles * (blockIdx.x + 1) / gridDim.x;
  int pos[kGroup];
  for (int c = 0; c < C; ++c) {
    const int np = __ldcg(a.npass + c);
    int built = -1;  // the block whose column-c tables the CTA holds
    for (int p = 0; p < np; ++p) {
      for (size_t t = t0; t < t1; ++t) {
        const int b = (int)(t / per_block);
        const uint32_t mask = (uint32_t)__ldcg(a.masks + (size_t)b * C + c);
        const int groups = max(1, (__popc(mask) + kGroup - 1) / kGroup);
        const int gi = p - (np - groups);  // the block's passes end with the column's
        if (gi < 0) continue;
        int g = 0, skip = kGroup * gi;
        for (uint32_t m = mask; m != 0 && g < kGroup; m &= m - 1) {
          if (skip > 0) {
            --skip;
          } else {
            pos[g++] = __ffs(m) - 1;
          }
        }
        if (b != built) {
          build_tables(a, sm, b, c);
          built = b;
        }
        dispatch_tile<kTab>(g, a, sm, b, c, t % per_block, pos, gi == 0, p == np - 1);
      }
      grid.sync();
    }
  }
}

template <bool kTab>
int launch(const Args& a, cudaStream_t stream) {
  if (a.B < 1 || a.C < 1 || a.K < 1 || a.K > kMaxK) return (int)cudaErrorInvalidValue;
  auto kernel = forward_t1_wide_kernel<kTab>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // as many CTAs as the card keeps resident, and no more than the tiles
  const size_t tiles = (size_t)a.B * ((((size_t)1 << a.K) + kTile - 1) / kTile);
  const size_t resident = (size_t)sms * per_sm;
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  Args args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), params, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Tables mode.  cost0 and key0 (B, 2^K) carry a state in, or are null for a
// zero state.  scratch holds B*C + C ints (any contents).
extern "C" int wmec_forward_t1_wide(const float* wdiff, const int* wbase, const float* rankw,
                                    const int* acost, const uint8_t* die, const int* cost0,
                                    const int* key0, int* pidx, int* dp_last, int* key_last,
                                    int* scratch, int B, int C, int K, cudaStream_t stream) {
  Args a{wdiff, wbase, rankw, acost, die, cost0, key0, pidx, dp_last, key_last,
         scratch, scratch + (size_t)B * C, B, C, K};
  return launch<true>(a, stream);
}

// Carry mode: no table; dp_last and key_last are the carry after the last
// column, and must not alias cost0 and key0 (a checkpoint is read again).
// Only the carried cost0 is read: key0 breaks fold ties, which the min fold
// does not need (it stays in the signature, which is the tables mode's).
extern "C" int wmec_forward_carry_t1_wide(const float* wdiff, const int* wbase, const float* rankw,
                                          const int* acost, const uint8_t* die, const int* cost0,
                                          const int* key0, int* dp_last, int* key_last, int* scratch,
                                          int B, int C, int K, cudaStream_t stream) {
  (void)key0;
  Args a{wdiff, wbase, rankw, acost, die, cost0, nullptr, nullptr, dp_last, key_last,
         scratch, scratch + (size_t)B * C, B, C, K};
  return launch<false>(a, stream);
}

extern "C" const char* wmec_forward_t1_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
