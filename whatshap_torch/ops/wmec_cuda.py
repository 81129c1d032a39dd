"""
Hand-written CUDA kernels of the wMEC/PedMEC solve, with their wrappers and
plain torch versions.

Replaces whatshap_tpu/ops/wmec_pallas.py:

- forward_t1 launches csrc/wmec_forward_t1.cu, the forward column scan that
  replaces _make_kernel in its T=1, table-emitting form, from a zero state
  (as solve_batched_pallas launches it) or from a carried one
  (forward_tables_pallas); forward_carry_t1 launches its carry mode, the
  final state without tables (forward_carry_pallas); each launch runs one
  thread-block cluster per block with the block's state on chip
  (forward_t1_layout), up to K = MAX_K;
- forward_t1_wide and forward_carry_t1_wide launch
  csrc/wmec_forward_t1_wide.cu, the same two modes with the block's state in
  device memory (one cooperative launch; windows of columns over tiles of
  the state held in registers, a grid-wide barrier after each; the blocks
  in groups whose state fits a share of the L2, forward_t1_wide_group), at
  any K up to MAX_K_WIDE: the T=1 XLA scan the
  reference runs past its Pallas envelope (whatshap_tpu/ops/wmec.py
  _forward_scan_impl, through solve_batched, _solve_scan and the segmented
  solve_scan_segmented); forward_t1 and forward_carry_t1 hand K above
  MAX_K to them;
- backtrace_t1 launches csrc/wmec_backtrace_t1.cu, the index-path walk that
  replaces _make_backtrace_kernel (via backtrace_pallas): a warp a walk,
  several columns a memory round trip (csrc/wmec_walk.cuh), guided by the
  columns' dying masks (pack_die; backtrace_layout and backtrace_rounds
  mirror its rounds);
- forward_t and forward_m_t launch csrc/wmec_forward_t.cu, the general-T
  (pedigree) forward scan that replaces _make_kernel for T > 1: with tables,
  unseeded, seeded or from a carry (forward_scan_pallas, solve_batched_pallas
  at T = 4/16, forward_tables_seeded_pallas, forward_tables_pallas), and in
  the seeded m-only mode of the seam pass (forward_m_seeded_pallas);
  forward_carry_t launches its carry mode (forward_carry_pallas); each
  launch runs one thread-block cluster per block with the block's state in
  the cluster's shared memory (forward_t_layout);
- forward_t_wide, forward_m_t_wide and forward_carry_t_wide launch
  csrc/wmec_forward_t_wide.cu, the general-T modes with the block's T planes
  in device memory (one cooperative launch, a grid-wide barrier after each
  column's pass over tiles of the state in shared memory), at T up to 1024
  (five trios), P up to 10 (five founders) and K up to MAX_K_WIDE: the XLA
  scan the reference runs for
  pedigrees past its Pallas envelope (whatshap_tpu/ops/wmec.py
  _forward_scan_impl, through solve_batched, forward_m_batched,
  solve_seeded_batched and the segmented solve_scan_segmented); the m-only
  mode takes R seeds a block (B, R, T) over the blocks' inputs, the seam
  pass's coset seeds, with the column cost computed once for all R;
  forward_t, forward_m_t and forward_carry_t hand them the shapes past the
  cluster kernel's envelope (cluster_supported);
- backtrace_t launches csrc/wmec_backtrace_t.cu, the general-T walk of
  (index, transmission, preceding transmission) that replaces
  _make_backtrace_kernel_t, M walks per block over its tables
  (backtrace_pallas_t at M = 1, backtrace_pallas_t_multi at M = T + 1), on
  the same walk;
- _select_optimum picks the tie-broken optimum between them, in torch ops,
  as the JAX side leaves it to XLA;
- solve_batched_cuda is forward -> select -> backtrace, the mirror of
  solve_batched_pallas; forward_m_t (as forward_m_seeded_pallas) and
  solve_seeded_batched_cuda (the mirror of solve_seeded_batched_pallas) are
  the two passes of the pedigree route; solve_segmented_cuda is the
  segmented solve (the mirror of wmec_pallas.solve_segmented): the host loop
  wmec.solve_segmented over the carry kernels, the tables kernels from a
  carry and the backtraces.

A wrapper checks its inputs, then runs its plain torch version on CPU
tensors and its kernel on CUDA tensors; it never falls back from the one to
the other.  `launches` on a wrapper counts its kernel launches, nothing else.
The kernels are built with nvcc at first use (ops/_build.py), never when this
module is imported.
"""

import ctypes

import torch

from . import _build

#: Largest K the T=1 cluster kernel (csrc/wmec_forward_t1.cu) is built and
#: checked for (the reference kernel's own ceiling, wmec_pallas.MAX_K).
MAX_K = 17
#: Largest K of the T=1 kernel with its state in device memory
#: (csrc/wmec_forward_t1_wide.cu), which takes T = 1 above MAX_K: the
#: reference CLI's ceiling (--internal-downsampling <= 23).
MAX_K_WIDE = 23
#: Largest K of the general-T cluster kernel (csrc/wmec_forward_t.cu) per
#: transmission count T (P <= 4, as the reference's kernel): its state and
#: tables grow with T * 2^K.
MAX_K_T = {4: 16, 16: 13}
#: Founder partition counts the general-T cluster kernel is built for.
PEDIGREE_P = (2, 4)
#: Transmission counts (4^trios, up to five trios) and founder partition
#: counts (2 * founders, up to five founders) of the general-T kernel with
#: its state in device memory (csrc/wmec_forward_t_wide.cu), at any K up to
#: MAX_K_WIDE; the route gives it the shapes past the cluster kernel's.  Six
#: trios (T = 4096) or six founders (P = 12) stay past it: the reference's
#: XLA scan holds an (S, T, T) term, 64 MiB a state at T = 4096.
WIDE_T = (4, 16, 64, 256, 1024)
WIDE_P = (2, 4, 6, 8, 10)
ENVELOPE = (
    f"T = 1, P = 2, K <= {MAX_K_WIDE}; T in {WIDE_T}, P in {WIDE_P}, K <= {MAX_K_WIDE} "
    "(the cluster kernels: T = 1 to K = " + f"{MAX_K}; "
    + "; ".join(f"T = {t}, P in {PEDIGREE_P}, K <= {k}" for t, k in MAX_K_T.items()) + ")"
)


def kernel_supported(K: int, T: int, P: int) -> bool:
    """Shapes the CUDA kernels of this module take: one individual (T == 1,
    P == 2) with 1 <= K <= MAX_K_WIDE slots (the cluster kernel up to MAX_K,
    the wide kernel above), or a pedigree of T in WIDE_T transmission values
    with P in WIDE_P and 1 <= K <= MAX_K_WIDE (the cluster kernel where
    cluster_supported, the wide kernel elsewhere)."""
    if T == 1:
        return P == 2 and 1 <= K <= MAX_K_WIDE
    return T in WIDE_T and P in WIDE_P and 1 <= K <= MAX_K_WIDE


def cluster_supported(K: int, T: int, P: int) -> bool:
    """Shapes the thread-block cluster kernels take (the state on chip):
    T = 1 up to MAX_K, T = 4 or 16 with P in PEDIGREE_P up to MAX_K_T[T].
    Past them, within kernel_supported, run the wide kernels."""
    if T == 1:
        return P == 2 and 1 <= K <= MAX_K
    return T in MAX_K_T and P in PEDIGREE_P and 1 <= K <= MAX_K_T[T]


def state_bytes(K: int, T: int = 1, P: int = 2, seeds: int = None) -> int:
    """Device memory a forward kernel needs per block beyond its tables.
    The cluster kernels keep the block's state in the shared memory of its
    cluster (forward_t1_layout, forward_t_layout): nothing.  The wide
    kernels keep it in device memory: at T = 1 in its final-state outputs,
    the cost plane, which it updates in place, and the key plane, 8 * 2^K
    bytes a block; at T > 1 the T cost planes, the T jmin planes and the key
    plane, (2T + 1) * 4 * 2^K bytes a block, and in the m-only mode with
    `seeds` scans a block only their cost planes, seeds * T * 4 * 2^K bytes.
    The scratch of 4 * (C + 1) bytes a block, the columns' dying masks and
    passes, is left out."""
    if not kernel_supported(K, T, P) or cluster_supported(K, T, P):
        return 0
    if T == 1:
        return 8 << K
    return (2 * T + 1 if seeds is None else seeds * T) * 4 << K


#: Launches of the T=1 forward kernel above this many blocks take its wide
#: layout (forward_t1_layout).
T1_WIDE_B = 8


def _cluster_bits(K: int, cta_bits: int = None) -> dict:
    """The state index bits of one block in the forward kernels, as their
    layout functions compute them: 2^cta_bits CTAs (by default
    clusters::cluster_bits: 16 from K = 13, fewer below so that each CTA
    keeps 2^9 states), 2^thread_bits threads holding states in `threads` a
    CTA, 2^loop_bits states a thread, and hi_bits, the warp and loop bits
    (the rows of the column's hi sums table)."""
    if cta_bits is None:
        cta_bits = min(max(K - 9, 0), 4)
    kl = K - cta_bits
    thread_bits = min(kl, 9)
    loop_bits = kl - thread_bits
    return {
        "cta_bits": cta_bits,
        "thread_bits": thread_bits,
        "threads": 1 << max(thread_bits, 5),
        "loop_bits": loop_bits,
        "hi_bits": thread_bits - min(5, thread_bits) + loop_bits,
    }


def _record_words(K: int, tp2: int, n_acost: int) -> int:
    """Two staged column records (wdiff, wbase, acost, rankw, die, rc),
    each rounded up to 4 words."""
    return 2 * (-(-(K * tp2 + tp2 + n_acost + 2 * K + 1) // 4) * 4)


def forward_t1_layout(K: int, B: int, tables: bool = True) -> dict:
    """The layout of one block's state in csrc/wmec_forward_t1.cu in a launch
    of B blocks, computed as its C entries compute it (cta_bits, layout_lr
    and smem_bytes there): a cluster of 2^cta_bits CTAs, `threads` threads a
    CTA of which 2^thread_bits hold states, and 2^loop_bits states a thread
    (at most 4 loop bits); a state index is lane | warp | CTA rank | loop bits
    from the bottom up.  Up to T1_WIDE_B blocks take the narrow layout (16
    CTAs from K = 13, fewer below so that each CTA keeps 2^9 states); more
    take clusters of 4 CTAs, or as few more as 4 loop bits allow (8 at K =
    16).  smem_bytes is a CTA's shared memory: its states' words (cost, key
    and the fold's index with tables, the cost alone in the carry mode,
    tables=False; the fold's exchange planes, rounded up to 4 words), two
    staged column records and two columns' sums tables (32 + 2^hi_bits rows
    of 4 words each)."""
    narrow = min(max(K - 9, 0), 4)
    lay = _cluster_bits(K, narrow if B <= T1_WIDE_B else min(narrow, max(K - 9 - 4, 2)))
    hbits = lay.pop("hi_bits")
    state = -(-((3 if tables else 1) << (K - lay["cta_bits"])) // 4) * 4
    sums = 2 * 4 * (32 + (1 << hbits))
    return {**lay, "smem_bytes": 4 * (state + _record_words(K, 4, 4) + sums)}


def forward_t_layout(K: int, T: int, P: int, tables: bool) -> dict:
    """The layout of one block's state in csrc/wmec_forward_t.cu, computed as
    its C entries compute it (clusters::cluster_bits, layout_lr and
    smem_bytes there), in forward_t1_layout's terms.  smem_bytes is a CTA's
    shared memory: its states' words ((2T + 3) with tables, T in the carry
    and m-only modes, tables=False), two staged column records, the column's
    sums tables and the m-only reduction."""
    lay = _cluster_bits(K)
    hbits = lay.pop("hi_bits")
    tp2 = T * 2 * P
    state = (2 * T + 3 if tables else T) << (K - lay["cta_bits"])
    sums = tp2 * 32 + (tp2 << hbits) + 32 + (1 << hbits)
    red = 16 * T + T
    return {**lay, "smem_bytes": 4 * (state + _record_words(K, tp2, T << P) + sums + red)}


#: The backtraces' rounds (csrc/wmec_walk.cuh: kNarrowWalks, kRowCols,
#: kGuessO/kGuessJ, row0_lanes): launches of at most BT_NARROW_WALKS walks
#: take the narrow layout; a T = 1 round's guessed rows, (o, j): a change at
#: the o-th column of the round to the index with subset j of the column's
#: mask flipped (1 its lowest bit, 2 the next, 3 both), BT_ROW_COLS columns
#: each.
BT_NARROW_WALKS = 8
BT_ROW_COLS = 4
BT_GUESSES = ((0, 1), (1, 1), (0, 2), (2, 1))


def backtrace_layout(W: int, T: int = 1) -> dict:
    """The layout of a backtrace launch of W walks (a warp a walk), as the C
    entries and csrc/wmec_walk.cuh compute it: `row0` lanes gather the next
    columns at the state each round (6 at T = 1; at T > 1 8 in a narrow
    launch, 3 in a wide one), and at T = 1 the BT_GUESSES rows guess the
    state after a change."""
    row0 = 6 if T == 1 else (8 if W <= BT_NARROW_WALKS else 3)
    return {"row0": row0, "guessed_rows": len(BT_GUESSES) if T == 1 else 0}


def _subset(D: int, j: int) -> int:
    low1 = D & -D
    low2 = (D ^ low1) & -(D ^ low1)
    if j > 1 and not low2:
        return 0
    return (low1 if j & 1 else 0) | (low2 if j & 2 else 0)


def backtrace_rounds(path, tpath, final, die, T: int, W: int = 1) -> int:
    """The memory round trips the backtrace kernels take for one walk of a
    launch of W walks, as csrc/wmec_walk.cuh's rounds go over it: a round
    resolves the columns up to the first change of the state within its
    first `row0` (backtrace_layout) and, at T = 1 where a guessed row
    (BT_GUESSES) guessed that change, the next BT_ROW_COLS columns up to the
    next change; at T > 1 a last change of the index is checked with one
    more load after the last round.  The walk is given by its outputs:
    path, tpath (C,) and final (3,) (T = 1: final (1,) or an int), die (C,)
    its masks (pack_die); the tables are taken to have the forward's shape
    (no check fails)."""
    path = [int(x) for x in path]
    C = len(path)
    tpath = [int(x) for x in tpath] if T > 1 else [0] * C
    fin = [int(x) for x in (final if hasattr(final, "__len__") else [final])] + [0, 0]
    die = [int(x) for x in die]

    def state_after(x):  # (index, preceding transmission) after column x
        if x == 0:
            return fin[0], fin[2] if T > 1 else 0
        return path[x - 1], (tpath[x - 2] if x >= 2 else fin[1]) if T > 1 else 0

    def pt_entering(x):
        return (tpath[x - 1] if x >= 1 else fin[1]) if T > 1 else 0

    row0 = backtrace_layout(W, T)["row0"]
    rounds, pending, c = 0, False, C - 1
    while c >= 0:
        rounds += 1
        pending = False
        v, pt = path[c], pt_entering(c)
        n0 = min(row0, c + 1)
        f = next((i for i in range(n0) if state_after(c - i) != (v, pt)), None)
        if f is None:
            c -= n0
            continue
        d = c - f
        v1, pt1 = state_after(d)
        c = d - 1
        s = v1 ^ v
        if T > 1 or not (d >= 1 and s and any(o == f and _subset(die[d], j) == s for o, j in BT_GUESSES)):
            pending = T > 1 and s != 0
            continue
        n1 = min(BT_ROW_COLS, d)
        e = next((e for e in range(n1) if state_after(d - 1 - e)[0] != v1), None)
        c = d - 1 - (n1 if e is None else e + 1)
    return rounds + pending


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wmec_forward_t1": [_P] * 10 + [_I] * 3 + [_P],
    "wmec_forward_carry_t1": [_P] * 9 + [_I] * 3 + [_P],
    "wmec_forward_t1_wide": [_P] * 11 + [_I] * 3 + [_P],
    "wmec_forward_carry_t1_wide": [_P] * 10 + [_I] * 3 + [_P],
    "wmec_backtrace_t1": [_P] * 5 + [_I] * 3 + [_P],
    "wmec_forward_t": [_P] * 15 + [_I] * 5 + [_P],
    "wmec_forward_carry_t": [_P] * 12 + [_I] * 5 + [_P],
    "wmec_forward_m_t": [_P] * 7 + [_I] * 5 + [_P],
    "wmec_backtrace_t": [_P] * 7 + [_I] * 5 + [_P],
    "wmec_forward_t_wide": [_P] * 16 + [_I] * 5 + [_P],
    "wmec_forward_carry_t_wide": [_P] * 13 + [_I] * 5 + [_P],
    "wmec_forward_m_t_wide": [_P] * 9 + [_I] * 6 + [_P],
    "geno_backward": [_P] * 8 + [_I] * 5 + [_P],
    "geno_forward": [_P] * 8 + [_I] * 5 + [_P],
    "geno_backward_wide": [_P] * 13 + [_I] * 7 + [_P],
    "geno_forward_wide": [_P] * 14 + [_I] * 7 + [_P],
}


def _launch(lib_name: str, *args, fn_name: str = None) -> None:
    """Call the C entry point `fn_name` (default: `lib_name`) of the library
    built from csrc/<lib_name>.cu on the current stream; raise if it reports
    a CUDA error."""
    fn_name = fn_name or lib_name
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[fn_name]
        fn.restype = ctypes.c_int
        err_fn = getattr(lib, lib_name + "_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = getattr(lib, lib_name + "_error_string")(err).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {err}: {msg}")


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def _check_device(*tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _check_carry(carry, B, T, S):
    """Check a carried state (cost (B, T, S), jmin (B, T, S), key (B, S)),
    or at T = 1 (cost (B, S), key (B, S)); returns its tensors."""
    if T == 1:
        cost0, key0 = carry
        _check(cost0, "carry cost", torch.int32, (B, S))
        _check(key0, "carry key", torch.int32, (B, S))
        return [cost0, key0]
    cost0, jmin0, key0 = carry
    _check(cost0, "carry cost", torch.int32, (B, T, S))
    _check(jmin0, "carry jmin", torch.int32, (B, T, S))
    _check(key0, "carry key", torch.int32, (B, S))
    return [cost0, jmin0, key0]


def _check_t1_inputs(name, K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry):
    """Shape checks shared by the T=1 forward wrappers; returns the device.
    carry may be None (zero state)."""
    B, C = wdiff.shape[0], wdiff.shape[1]
    if not kernel_supported(K, 1, P):
        raise ValueError(f"{name}: unsupported shape K={K}, P={P}")
    _check(wdiff, "wdiff", torch.float32, (B, C, K, 2 * P))
    _check(wbase, "wbase", torch.int32, (B, C, 1, P, 2))
    _check(rankw, "rankw", torch.float32, (B, C, K))
    _check(acost, "acost", torch.int32, (B, C, 1, 1 << P))
    _check(die_prev, "die_prev", torch.bool, (B, C, K))
    _check(rc, "rc", torch.int32, (B, C))
    tensors = [wdiff, wbase, rankw, acost, die_prev, rc]
    if carry is not None:
        tensors += _check_carry(carry, B, 1, 1 << K)
    return _check_device(*tensors)


def _t1_carry0(carry):
    """A T=1 carry (cost (B, S), key (B, S)) as forward_scan's carry0."""
    return None if carry is None else (carry[0][..., None], None, carry[1])


def forward_t1_plain(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry=None):
    """Plain torch version of the T=1 forward scan: the torch mirror
    (wmec.forward_scan) at T = 1, in forward_t1's output layout."""
    from .wmec import forward_scan

    dp_last, _jmin, key_last, proj_idx, _pj = forward_scan(
        K, 1, P, wdiff, wbase, rankw, acost, die_prev, rc, carry0=_t1_carry0(carry)
    )
    return proj_idx[:, :, 0], dp_last[..., 0], key_last


def forward_t1(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry=None):
    """T=1 forward column scan over stacked blocks.

    Inputs as wmec.forward_scan with T = 1: wdiff (B, C, K, 2P) f32, wbase
    (B, C, 1, P, 2) i32, rankw (B, C, K) f32, acost (B, C, 1, 2^P) i32,
    die_prev (B, C, K) bool, rc (B, C) i32 (T = 1 has no recombination term,
    so the kernel does not read it), and the optional carry (cost (B, 2^K),
    key (B, 2^K)) i32 the scan starts from (without it, from zero).  Returns
    pidx (B, C, 2^K), the projection table of every column, and the final
    state dp_last (B, 2^K) and key_last (B, 2^K), all int32.  Above MAX_K it
    hands CUDA tensors to forward_t1_wide, which counts that launch.
    """
    dev = _check_t1_inputs("forward_t1", K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)
    if dev.type == "cpu":
        return forward_t1_plain(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)
    if K > MAX_K:
        return forward_t1_wide(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)

    B, C, S = wdiff.shape[0], wdiff.shape[1], 1 << K
    cost0, key0 = carry if carry is not None else (None, None)
    pidx = torch.empty((B, C, S), dtype=torch.int32, device=dev)
    dp_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    key_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_forward_t1",
            wdiff.data_ptr(), wbase.data_ptr(), rankw.data_ptr(), acost.data_ptr(),
            die_prev.data_ptr(), _ptr(cost0), _ptr(key0),
            pidx.data_ptr(), dp_last.data_ptr(), key_last.data_ptr(),
            B, C, K,
        )
    forward_t1.launches += 1
    return pidx, dp_last, key_last


forward_t1.launches = 0


def forward_carry_t1_plain(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry):
    """Plain torch version of the T=1 carry mode: wmec.forward_scan in its
    carry mode at T = 1."""
    from .wmec import forward_scan

    dp_last, _jmin, key_last, _pi, _pj = forward_scan(
        K, 1, P, wdiff, wbase, rankw, acost, die_prev, rc, carry0=_t1_carry0(carry), mode="carry"
    )
    return dp_last[..., 0], key_last


def forward_carry_t1(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry):
    """T=1 forward scan in the carry mode (the checkpoint pass of the
    segmented solve): inputs as forward_t1 with the carry (cost (B, 2^K), key
    (B, 2^K)) i32 required; writes no table and returns the carry after the
    last column, (dp_last (B, 2^K), key_last (B, 2^K)) i32, in new tensors
    (a checkpoint is read again).  Above MAX_K it hands CUDA tensors to
    forward_carry_t1_wide, which counts that launch."""
    if carry is None:
        raise ValueError("forward_carry_t1: the carry mode needs a carry (cost, key)")
    dev = _check_t1_inputs("forward_carry_t1", K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)
    if dev.type == "cpu":
        return forward_carry_t1_plain(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)
    if K > MAX_K:
        return forward_carry_t1_wide(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)

    B, C, S = wdiff.shape[0], wdiff.shape[1], 1 << K
    dp_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    key_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_forward_t1",
            wdiff.data_ptr(), wbase.data_ptr(), rankw.data_ptr(), acost.data_ptr(),
            die_prev.data_ptr(), carry[0].data_ptr(), carry[1].data_ptr(),
            dp_last.data_ptr(), key_last.data_ptr(),
            B, C, K,
            fn_name="wmec_forward_carry_t1",
        )
    forward_carry_t1.launches += 1
    return dp_last, key_last


forward_carry_t1.launches = 0


def _wide_scratch(B, C, dev):
    """The wide kernels' scratch: the columns' dying masks (B, C) and the
    passes of each column (C,), int32, written by the kernel itself."""
    return torch.empty(B * C + C, dtype=torch.int32, device=dev)


def forward_t1_wide(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry=None):
    """forward_t1 on csrc/wmec_forward_t1_wide.cu, the T=1 forward scan with
    the block's state in device memory, at any 1 <= K <= MAX_K_WIDE (the
    route gives it K above MAX_K, where the cluster kernel stops).  Inputs
    and outputs as forward_t1; its plain version on CPU tensors is
    forward_t1_plain."""
    dev = _check_t1_inputs("forward_t1_wide", K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)
    if dev.type == "cpu":
        return forward_t1_plain(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)

    B, C, S = wdiff.shape[0], wdiff.shape[1], 1 << K
    cost0, key0 = carry if carry is not None else (None, None)
    pidx = torch.empty((B, C, S), dtype=torch.int32, device=dev)
    dp_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    key_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_forward_t1_wide",
            wdiff.data_ptr(), wbase.data_ptr(), rankw.data_ptr(), acost.data_ptr(),
            die_prev.data_ptr(), _ptr(cost0), _ptr(key0),
            pidx.data_ptr(), dp_last.data_ptr(), key_last.data_ptr(),
            _wide_scratch(B, C, dev).data_ptr(),
            B, C, K,
        )
    forward_t1_wide.launches += 1
    return pidx, dp_last, key_last


forward_t1_wide.launches = 0


def forward_carry_t1_wide(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry):
    """forward_carry_t1 on csrc/wmec_forward_t1_wide.cu (its carry mode), at
    any 1 <= K <= MAX_K_WIDE.  Inputs and outputs as forward_carry_t1; its
    plain version on CPU tensors is forward_carry_t1_plain."""
    if carry is None:
        raise ValueError("forward_carry_t1_wide: the carry mode needs a carry (cost, key)")
    dev = _check_t1_inputs(
        "forward_carry_t1_wide", K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry
    )
    if dev.type == "cpu":
        return forward_carry_t1_plain(K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)

    B, C, S = wdiff.shape[0], wdiff.shape[1], 1 << K
    dp_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    key_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_forward_t1_wide",
            wdiff.data_ptr(), wbase.data_ptr(), rankw.data_ptr(), acost.data_ptr(),
            die_prev.data_ptr(), carry[0].data_ptr(), carry[1].data_ptr(),
            dp_last.data_ptr(), key_last.data_ptr(), _wide_scratch(B, C, dev).data_ptr(),
            B, C, K,
            fn_name="wmec_forward_carry_t1_wide",
        )
    forward_carry_t1_wide.launches += 1
    return dp_last, key_last


forward_carry_t1_wide.launches = 0

#: The L2 share (bytes) that the cost planes of one group of blocks may take
#: in csrc/wmec_forward_t1_wide.cu's sweep (its kL2Share).
T1_WIDE_L2_SHARE = 12 << 20


def forward_t1_wide_group(K: int, B: int) -> int:
    """Blocks a group of forward_t1_wide's L2 sweep at K in a launch of B
    blocks: as many 4 * 2^K-byte cost planes as fit T1_WIDE_L2_SHARE, at
    least one, at most B (the kernel's blocks_a_group, which its C entry
    wmec_forward_t1_wide_group returns)."""
    return max(1, min(B, T1_WIDE_L2_SHARE >> (K + 2)))


def pack_die(die_prev):
    """The dying masks the backtraces take: die_prev (B, C, K) bool packed
    into (B, C) int32, bit k set where slot k dies before column c (the
    slots the forward fold of column c visits)."""
    K = die_prev.shape[-1]
    weights = torch.tensor([1 << k for k in range(K)], dtype=torch.int32, device=die_prev.device)
    return (die_prev * weights).sum(dim=-1, dtype=torch.int32)


def backtrace_t1_plain(opt_idx, pidx, die=None):
    """Plain torch version of the T=1 backtrace (see backtrace_t1): the torch
    mirror's walk (wmec._backtrace_from) with no transmission state, then the
    step through column 0.  The dying masks `die` are not read."""
    from .wmec import _backtrace_from

    zero = torch.zeros_like(opt_idx)
    path, _trans, _seam = _backtrace_from(opt_idx, zero, zero, pidx[:, :, None], None)
    rows = torch.arange(pidx.shape[0], device=pidx.device)
    return path, pidx[rows, 0, path[:, 0].long()]


def backtrace_t1(opt_idx, pidx, die):
    """T=1 backtrace.  opt_idx (B,) i32 is the selected last-column
    bipartition, pidx (B, C, 2^K) i32 the tables from forward_t1, die (B, C)
    i32 the dying masks of the columns (pack_die).  Walks v <- pidx[b, c, v]
    from the last column to the first, recording v at each column before the
    step.  Returns the index paths (B, C) i32 and the state one step through
    column 0, final (B,) i32, as backtrace_pallas does (the segmented solve
    chains on it).  The masks only guide the kernel's guesses: the result is
    the walk of pidx whatever they hold."""
    B, C = pidx.shape[0], pidx.shape[1]
    S = pidx.shape[2] if pidx.dim() == 3 else 0
    if S < 2 or S & (S - 1) or not 1 <= S.bit_length() - 1 <= MAX_K_WIDE:
        raise ValueError(f"backtrace_t1: pidx must be (B, C, 2^K) with 1 <= K <= {MAX_K_WIDE}")
    _check(opt_idx, "opt_idx", torch.int32, (B,))
    _check(pidx, "pidx", torch.int32, (B, C, S))
    _check(die, "die", torch.int32, (B, C))
    dev = _check_device(opt_idx, pidx, die)
    if dev.type == "cpu":
        return backtrace_t1_plain(opt_idx, pidx, die)

    path = torch.empty((B, C), dtype=torch.int32, device=dev)
    final = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_backtrace_t1",
            opt_idx.data_ptr(),
            pidx.data_ptr(),
            die.data_ptr(),
            path.data_ptr(),
            final.data_ptr(),
            B,
            C,
            S.bit_length() - 1,
        )
    backtrace_t1.launches += 1
    return path, final


backtrace_t1.launches = 0


def _select_optimum(K: int, T: int, dp_last, key_last):
    """Batched final-optimum selection with the reference's tie-break: min
    cost, then min Gray key, then min transmission, then min index.
    dp_last (B, T, S) or (B, T*S), key_last (B, S).  Returns (costs, opt_trans,
    opt_idx), each (B,) int32."""
    S = 1 << K
    B = dp_last.shape[0]
    dp = dp_last.reshape(B, T, S)
    key = key_last.reshape(B, S)
    big = 2**30
    m = dp.amin(dim=(1, 2))
    cand = dp == m[:, None, None]
    keyb = torch.where(cand, key[:, None, :], big)
    km = keyb.amin(dim=(1, 2))
    cand = cand & (keyb == km[:, None, None])
    comb = (
        torch.arange(T, dtype=torch.int32, device=dp.device)[:, None] * S
        + torch.arange(S, dtype=torch.int32, device=dp.device)[None, :]
    )
    best = torch.where(cand, comb[None], big).amin(dim=(1, 2))
    return m, best // S, best % S


def _check_pedigree_inputs(
    name, K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0, carry=None, seeds=False
):
    """Shape checks shared by the general-T forward wrappers; returns the
    device.  dp0 and carry may be None (unseeded); they are exclusive, as in
    the reference's kernel.  dp0 is (B, T), or with `seeds` (the m-only
    mode) (B, T) or (B, R, T): R seeds a block."""
    B, C = wdiff.shape[0], wdiff.shape[1]
    if T == 1 or not kernel_supported(K, T, P):
        raise ValueError(f"{name}: unsupported shape K={K}, T={T}, P={P} ({ENVELOPE})")
    if dp0 is not None and carry is not None:
        raise ValueError(f"{name}: a seed (dp0) and a carry are exclusive")
    _check(wdiff, "wdiff", torch.float32, (B, C, K, T * P * 2))
    _check(wbase, "wbase", torch.int32, (B, C, T, P, 2))
    _check(rankw, "rankw", torch.float32, (B, C, K))
    _check(acost, "acost", torch.int32, (B, C, T, 1 << P))
    _check(die_prev, "die_prev", torch.bool, (B, C, K))
    _check(rc, "rc", torch.int32, (B, C))
    tensors = [wdiff, wbase, rankw, acost, die_prev, rc]
    if dp0 is not None:
        _check(dp0, "dp0", torch.int32, (B, dp0.shape[1], T) if seeds and dp0.dim() == 3 else (B, T))
        tensors.append(dp0)
    if carry is not None:
        tensors += _check_carry(carry, B, T, 1 << K)
    return _check_device(*tensors)


def forward_t_plain(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0=None, carry=None):
    """Plain torch version of the general-T forward scan with tables: the
    torch mirror (wmec.forward_scan), in forward_t's output layout."""
    from .wmec import _planes, forward_scan

    dp_last, jmin_last, key_last, pidx, pjmin = forward_scan(
        K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0=dp0,
        carry0=None if carry is None else _planes(carry),
    )
    return (
        pidx, pjmin,
        dp_last.transpose(1, 2).contiguous(), jmin_last.transpose(1, 2).contiguous(),
        key_last,
    )


def forward_t(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0=None, carry=None):
    """General-T (pedigree) forward column scan with tables over stacked
    blocks.

    Inputs as wmec.forward_scan: wdiff (B, C, K, T*P*2) f32, wbase (B, C, T,
    P, 2) i32, rankw (B, C, K) f32, acost (B, C, T, 2^P) i32, die_prev (B, C,
    K) bool, rc (B, C) i32, and what the state starts from: the seed dp0
    (B, T) i32, or the carry (cost (B, T, 2^K), jmin (B, T, 2^K), key
    (B, 2^K)) i32 of a preceding segment, or (neither) zero.  Returns pidx
    and pjmin (B, C, T, 2^K), the projection index and transmission-argmin
    tables of every column, and the final state dp_last and jmin_last (B, T,
    2^K) and key_last (B, 2^K), all int32.  Past the cluster kernel's
    envelope (cluster_supported) it hands CUDA tensors to forward_t_wide,
    which counts that launch.
    """
    dev = _check_pedigree_inputs(
        "forward_t", K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0, carry
    )
    if dev.type == "cpu":
        return forward_t_plain(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0, carry)
    if not cluster_supported(K, T, P):
        return forward_t_wide(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0, carry)

    B, C, S = wdiff.shape[0], wdiff.shape[1], 1 << K
    cost0, jmin0, key0 = carry if carry is not None else (None, None, None)
    pidx = torch.empty((B, C, T, S), dtype=torch.int32, device=dev)
    pjmin = torch.empty_like(pidx)
    dp_last = torch.empty((B, T, S), dtype=torch.int32, device=dev)
    jmin_last = torch.empty_like(dp_last)
    key_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_forward_t",
            wdiff.data_ptr(), wbase.data_ptr(), rankw.data_ptr(), acost.data_ptr(),
            die_prev.data_ptr(), rc.data_ptr(), _ptr(dp0), _ptr(cost0), _ptr(jmin0), _ptr(key0),
            pidx.data_ptr(), pjmin.data_ptr(), dp_last.data_ptr(), jmin_last.data_ptr(),
            key_last.data_ptr(),
            B, C, K, T, P,
        )
    forward_t.launches += 1
    return pidx, pjmin, dp_last, jmin_last, key_last


forward_t.launches = 0


def forward_carry_t_plain(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry):
    """Plain torch version of the general-T carry mode: the mirror's
    checkpoint pass, wmec.forward_carry (forward_scan in its carry mode)."""
    from .wmec import forward_carry

    return forward_carry(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)


def forward_carry_t(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry):
    """General-T forward scan in the carry mode (the checkpoint pass of the
    segmented solve): inputs as forward_t with the carry (cost (B, T, 2^K),
    jmin (B, T, 2^K), key (B, 2^K)) i32 required; writes no tables and
    returns the carry after the last column, (dp_last (B, T, 2^K), jmin_last
    (B, T, 2^K), key_last (B, 2^K)) i32, in new tensors (a checkpoint is
    read again).  Past the cluster kernel's envelope it hands CUDA tensors
    to forward_carry_t_wide, which counts that launch."""
    if carry is None:
        raise ValueError("forward_carry_t: the carry mode needs a carry (cost, jmin, key)")
    dev = _check_pedigree_inputs(
        "forward_carry_t", K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, None, carry
    )
    if dev.type == "cpu":
        return forward_carry_t_plain(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)
    if not cluster_supported(K, T, P):
        return forward_carry_t_wide(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)

    B, C, S = wdiff.shape[0], wdiff.shape[1], 1 << K
    dp_last = torch.empty((B, T, S), dtype=torch.int32, device=dev)
    jmin_last = torch.empty_like(dp_last)
    key_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_forward_t",
            wdiff.data_ptr(), wbase.data_ptr(), rankw.data_ptr(), acost.data_ptr(),
            die_prev.data_ptr(), rc.data_ptr(),
            carry[0].data_ptr(), carry[1].data_ptr(), carry[2].data_ptr(),
            dp_last.data_ptr(), jmin_last.data_ptr(), key_last.data_ptr(),
            B, C, K, T, P,
            fn_name="wmec_forward_carry_t",
        )
    forward_carry_t.launches += 1
    return dp_last, jmin_last, key_last


forward_carry_t.launches = 0


def forward_m_t_plain(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0):
    """Plain torch version of the m-only forward scan: wmec.forward_m_batched
    (with seeds (B, R, T) its R scans a block share the block's column
    cost)."""
    from .wmec import forward_m_batched

    return forward_m_batched(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0)


def forward_m_t(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0):
    """General-T forward scan in the seeded m-only mode of the seam pass:
    inputs as forward_t with the seeds dp0 required, (B, T) or (B, R, T) (R
    scans a block over the block's inputs); returns only m, (B, T) or (B, R,
    T) i32, the final cost of each transmission plane minimised over the
    bipartitions.  No tables, no tie key and no transmission argmin are kept
    (fold winners have equal cost, so m does not depend on them).  Past the
    cluster kernel's envelope it hands CUDA tensors to forward_m_t_wide,
    which counts that launch; inside it the cluster kernel takes each seed
    as a block of its own."""
    if dp0 is None:
        raise ValueError("forward_m_t: the m-only mode is seeded: dp0 (B, T) is required")
    dev = _check_pedigree_inputs(
        "forward_m_t", K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0, seeds=True
    )
    if dev.type == "cpu":
        return forward_m_t_plain(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0)
    if not cluster_supported(K, T, P):
        return forward_m_t_wide(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0)
    if dp0.dim() == 3:
        B, R = dp0.shape[0], dp0.shape[1]
        ins = (wdiff, wbase, rankw, acost, die_prev, rc)
        rep = ins if R == 1 else [x.repeat_interleave(R, dim=0) for x in ins]
        return forward_m_t(K, T, P, *rep, dp0.reshape(B * R, T)).reshape(B, R, T)

    B, C = wdiff.shape[0], wdiff.shape[1]
    m = torch.empty((B, T), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_forward_t",
            wdiff.data_ptr(), wbase.data_ptr(), acost.data_ptr(), die_prev.data_ptr(),
            rc.data_ptr(), dp0.data_ptr(), m.data_ptr(),
            B, C, K, T, P,
            fn_name="wmec_forward_m_t",
        )
    forward_m_t.launches += 1
    return m


forward_m_t.launches = 0


def forward_t_wide(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0=None, carry=None):
    """forward_t on csrc/wmec_forward_t_wide.cu, the general-T forward scan
    with tables and the block's T planes in device memory, at any shape of
    kernel_supported with T > 1 (the route gives it the shapes past the
    cluster kernel's).  Inputs and outputs as forward_t; its plain version
    on CPU tensors is forward_t_plain."""
    dev = _check_pedigree_inputs(
        "forward_t_wide", K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0, carry
    )
    if dev.type == "cpu":
        return forward_t_plain(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0, carry)

    B, C, S = wdiff.shape[0], wdiff.shape[1], 1 << K
    cost0, jmin0, key0 = carry if carry is not None else (None, None, None)
    pidx = torch.empty((B, C, T, S), dtype=torch.int32, device=dev)
    pjmin = torch.empty_like(pidx)
    dp_last = torch.empty((B, T, S), dtype=torch.int32, device=dev)
    jmin_last = torch.empty_like(dp_last)
    key_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_forward_t_wide",
            wdiff.data_ptr(), wbase.data_ptr(), rankw.data_ptr(), acost.data_ptr(),
            die_prev.data_ptr(), rc.data_ptr(), _ptr(dp0), _ptr(cost0), _ptr(jmin0), _ptr(key0),
            pidx.data_ptr(), pjmin.data_ptr(), dp_last.data_ptr(), jmin_last.data_ptr(),
            key_last.data_ptr(), _wide_scratch(B, C, dev).data_ptr(),
            B, C, K, T, P,
        )
    forward_t_wide.launches += 1
    return pidx, pjmin, dp_last, jmin_last, key_last


forward_t_wide.launches = 0


def forward_carry_t_wide(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry):
    """forward_carry_t on csrc/wmec_forward_t_wide.cu (its carry mode), at
    any shape of kernel_supported with T > 1.  Inputs and outputs as
    forward_carry_t; its plain version on CPU tensors is
    forward_carry_t_plain."""
    if carry is None:
        raise ValueError("forward_carry_t_wide: the carry mode needs a carry (cost, jmin, key)")
    dev = _check_pedigree_inputs(
        "forward_carry_t_wide", K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, None, carry
    )
    if dev.type == "cpu":
        return forward_carry_t_plain(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)

    B, C, S = wdiff.shape[0], wdiff.shape[1], 1 << K
    dp_last = torch.empty((B, T, S), dtype=torch.int32, device=dev)
    jmin_last = torch.empty_like(dp_last)
    key_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_forward_t_wide",
            wdiff.data_ptr(), wbase.data_ptr(), rankw.data_ptr(), acost.data_ptr(),
            die_prev.data_ptr(), rc.data_ptr(),
            carry[0].data_ptr(), carry[1].data_ptr(), carry[2].data_ptr(),
            dp_last.data_ptr(), jmin_last.data_ptr(), key_last.data_ptr(),
            _wide_scratch(B, C, dev).data_ptr(),
            B, C, K, T, P,
            fn_name="wmec_forward_carry_t_wide",
        )
    forward_carry_t_wide.launches += 1
    return dp_last, jmin_last, key_last


forward_carry_t_wide.launches = 0


def forward_m_t_wide(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0):
    """forward_m_t on csrc/wmec_forward_t_wide.cu (its m-only mode), at any
    shape of kernel_supported with T > 1: with seeds dp0 (B, R, T) one
    launch runs the R scans of each block over the block's inputs, which it
    reads once (the column cost of a state serves all R), and returns m (B,
    R, T); with dp0 (B, T), R = 1 and m (B, T).  The R * T cost planes of a
    block are scratch it allocates.  Its plain version on CPU tensors is
    forward_m_t_plain."""
    if dp0 is None:
        raise ValueError("forward_m_t_wide: the m-only mode is seeded: dp0 (B, T) is required")
    dev = _check_pedigree_inputs(
        "forward_m_t_wide", K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0, seeds=True
    )
    if dev.type == "cpu":
        return forward_m_t_plain(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0)

    B, C = wdiff.shape[0], wdiff.shape[1]
    R = dp0.shape[1] if dp0.dim() == 3 else 1
    m = torch.empty(dp0.shape, dtype=torch.int32, device=dev)
    planes = torch.empty((B, R, T, 1 << K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_forward_t_wide",
            wdiff.data_ptr(), wbase.data_ptr(), acost.data_ptr(), die_prev.data_ptr(),
            rc.data_ptr(), dp0.data_ptr(), m.data_ptr(), planes.data_ptr(),
            _wide_scratch(B, C, dev).data_ptr(),
            B, C, K, T, P, R,
            fn_name="wmec_forward_m_t_wide",
        )
    forward_m_t_wide.launches += 1
    return m


forward_m_t_wide.launches = 0


def backtrace_t_plain(init, pidx, pjmin, die=None):
    """Plain torch version of the general-T backtrace (see backtrace_t): the
    torch mirror's walk (wmec._backtrace_from), walk w on block w // M, then
    the step through column 0.  The dying masks `die` are not read."""
    from .wmec import _backtrace_from

    B, M = init.shape[0], init.shape[1]
    flat = init.reshape(B * M, 3).long()
    block = torch.arange(B * M, device=init.device) // M
    path, tpath, seam = _backtrace_from(flat[:, 0], flat[:, 1], flat[:, 2], pidx, pjmin, block)
    v = pidx[block, 0, seam.long(), path[:, 0].long()]
    final = torch.stack([v, seam, pjmin[block, 0, seam.long(), v.long()]], dim=1)
    C = pidx.shape[1]
    return path.reshape(B, M, C), tpath.reshape(B, M, C), final.reshape(B, M, 3)


def backtrace_t(init, pidx, pjmin, die):
    """General-T backtrace, M walks per block over the block's tables.

    init (B, M, 3) i32 holds each walk's start (index v, transmission vt,
    preceding transmission prev_t); pidx and pjmin (B, C, T, 2^K) i32 are
    forward_t's tables, die (B, C) i32 the dying masks of the columns
    (pack_die; the kernel's guesses at T > 1 read none of them, so they
    cannot change the result).  From column C-1 down to 0 each walk records
    (v, vt), then steps v <- pidx[c, prev_t, v], vt <- prev_t, prev_t <-
    pjmin[c, vt, v].  Returns the index paths and transmission paths (B, M, C) and the
    triple after the step through column 0, final (B, M, 3), all int32, as
    backtrace_pallas_t (M = 1) and backtrace_pallas_t_multi do."""
    B, C = pidx.shape[0], pidx.shape[1]
    if pidx.dim() != 4:
        raise ValueError("backtrace_t: pidx must be (B, C, T, 2^K)")
    T, S = pidx.shape[2], pidx.shape[3]
    K = S.bit_length() - 1
    if S & (S - 1) or T not in WIDE_T or not 1 <= K <= MAX_K_WIDE:
        raise ValueError(f"backtrace_t: unsupported table shape T={T}, 2^K={S} ({ENVELOPE})")
    M = init.shape[1] if init.dim() == 3 else 0
    _check(init, "init", torch.int32, (B, M, 3))
    _check(pidx, "pidx", torch.int32, (B, C, T, S))
    _check(pjmin, "pjmin", torch.int32, (B, C, T, S))
    _check(die, "die", torch.int32, (B, C))
    if M < 1:
        raise ValueError("backtrace_t: needs at least one walk per block")
    dev = _check_device(init, pidx, pjmin, die)
    if dev.type == "cpu":
        return backtrace_t_plain(init, pidx, pjmin, die)

    path = torch.empty((B, M, C), dtype=torch.int32, device=dev)
    tpath = torch.empty_like(path)
    final = torch.empty((B, M, 3), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_backtrace_t",
            init.data_ptr(), pidx.data_ptr(), pjmin.data_ptr(), die.data_ptr(),
            path.data_ptr(), tpath.data_ptr(), final.data_ptr(),
            B, M, C, T, K,
        )
    backtrace_t.launches += 1
    return path, tpath, final


backtrace_t.launches = 0


def _head_init(K, T, dp_last, jmin_last, key_last):
    """The head walk's start per block: the selected optimum (opt_idx,
    opt_trans) and the jmin entry there.  Returns (costs (B,), init (B, 3))."""
    m, opt_trans, opt_idx = _select_optimum(K, T, dp_last, key_last)
    rows = torch.arange(dp_last.shape[0], device=dp_last.device)
    prev = jmin_last[rows, opt_trans.long(), opt_idx.long()]
    return m, torch.stack([opt_idx, opt_trans, prev], dim=1)


def solve_batched_cuda(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc):
    """End-to-end batched solve: forward kernel, optimum selection, backtrace
    kernel (T = 1: forward_t1 and backtrace_t1; T > 1: forward_t and
    backtrace_t with one walk per block).  Returns (costs (B,), index paths
    (B, C), transmission paths (B, C)), int32, matching wmec.solve_batched."""
    if T == 1:
        pidx, dp_last, key_last = forward_t1(K, P, wdiff, wbase, rankw, acost, die_prev, rc)
        m, _opt_trans, opt_idx = _select_optimum(K, 1, dp_last, key_last)
        index_path, _final = backtrace_t1(opt_idx.contiguous(), pidx, pack_die(die_prev))
        return m, index_path, torch.zeros_like(index_path)
    pidx, pjmin, dp_last, jmin_last, key_last = forward_t(
        K, T, P, wdiff, wbase, rankw, acost, die_prev, rc
    )
    m, init = _head_init(K, T, dp_last, jmin_last, key_last)
    index_path, trans_path, _final = backtrace_t(
        init[:, None].contiguous(), pidx, pjmin, pack_die(die_prev)
    )
    return m, index_path[:, 0], trans_path[:, 0]


def solve_seeded_batched_cuda(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0, die_next):
    """Pass 2 of the pedigree route, the mirror of
    solve_seeded_batched_pallas: the seeded forward kernel with tables, the
    head's optimum selection, the seam fold with the next block's die flags
    die_next (B, K) (torch ops, as the reference leaves it to XLA), then the
    head walk and the T seam walks in ONE backtrace launch over the shared
    tables.  Returns wmec.solve_seeded_batched's 8 outputs."""
    from .wmec import _seam_fold

    pidx, pjmin, dp_last, jmin_last, key_last = forward_t(
        K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0
    )
    cost_head, head = _head_init(K, T, dp_last, jmin_last, key_last)
    m, s_star, jmin_star = _seam_fold(
        K, T, dp_last.transpose(1, 2), key_last, jmin_last.transpose(1, 2), die_next
    )
    B = dp_last.shape[0]
    t_ids = torch.arange(T, dtype=torch.int32, device=dp_last.device).expand(B, T)
    inits = torch.cat([head[:, None], torch.stack([s_star, t_ids, jmin_star], dim=2)], dim=1)
    ips, tps, fins = backtrace_t(inits.contiguous(), pidx, pjmin, pack_die(die_prev))
    # the walk's final triple is one step through column 0: its middle
    # element is the transmission before the block's first column
    return (
        cost_head, m, ips[:, 0], tps[:, 0], fins[:, 0, 1].contiguous(),
        ips[:, 1:], tps[:, 1:], fins[:, 1:, 1].contiguous(),
    )


def _carry_pass(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry):
    """wmec.forward_carry's signature on the carry kernels (forward_carry_t1
    or forward_carry_t).  At T = 1 the carry's jmin planes are zeros and pass
    through unchanged."""
    if T == 1:
        B, S = carry[2].shape
        dp, key = forward_carry_t1(
            K, P, wdiff, wbase, rankw, acost, die_prev, rc, (carry[0].view(B, S), carry[2])
        )
        return dp.view(B, 1, S), carry[1], key
    return forward_carry_t(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)


def _tables_pass(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry):
    """wmec.forward_tables's signature on the tables kernels from a carry
    (forward_t1 or forward_t with carry=)."""
    if T == 1:
        B, S = carry[2].shape
        pidx = forward_t1(
            K, P, wdiff, wbase, rankw, acost, die_prev, rc, carry=(carry[0].view(B, S), carry[2])
        )[0]
        return pidx[:, :, None], None
    return forward_t(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry=carry)[:2]


def _walk(state, pidx, pjmin, die_prev):
    """wmec.walk_segment's signature on the backtrace kernels: backtrace_t1
    at T = 1 (pjmin None), backtrace_t with one walk per block above, both
    given the segment's dying masks.  Their `final` is the state one step
    through the segment's first column."""
    die = pack_die(die_prev)
    if pjmin is None:
        path, final = backtrace_t1(state[:, 0].contiguous(), pidx[:, :, 0], die)
        zero = torch.zeros_like(final)
        return path, torch.zeros_like(path), torch.stack([final, zero, zero], dim=1)
    ip, tp, final = backtrace_t(state[:, None].contiguous(), pidx, pjmin, die)
    return ip[:, 0], tp[:, 0], final[:, 0]


def solve_segmented_cuda(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, seg):
    """The segmented solve on the kernels, the mirror of
    wmec_pallas.solve_segmented: the host loop wmec.solve_segmented over the
    carry kernels (kernel row 9), the tables kernels from a carry (row 10),
    past the cluster kernels' envelope their wide counterparts (rows 13 and
    14), and the backtraces (rows 2 and 5).  On CUDA tensors it launches only
    kernels and never waits for the device.  Returns (costs (B,), index
    paths (B, C), transmission paths (B, C)), int32, matching
    solve_batched_cuda."""
    from .wmec import solve_segmented

    return solve_segmented(
        K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, seg, _carry_pass, _tables_pass, _walk
    )
