"""
Hand-written CUDA kernels of the genotyping forward-backward HMM, with their
wrappers and plain torch versions.

Replaces whatshap_tpu/ops/genotyping_pallas.py forward_backward_pallas:

- backward launches csrc/geno_backward.cu, the scaled backward pass that
  replaces _make_bwd_kernel: per column the scaled beta table and the
  scaling sum;
- forward launches csrc/geno_forward.cu, the scaled forward pass that
  replaces _make_fwd_kernel: per column the T * 2^P state-summed
  forward * beta products `red`, from which the host takes the genotype
  marginals (genotyping.likelihoods_from_red).

Both keep an instance's state on the chip (one thread-block cluster each),
inside ENVELOPE.  Past it, backward_wide and forward_wide launch
csrc/geno_backward_wide.cu and csrc/geno_forward_wide.cu, the same two
passes with the state in device memory (one cooperative launch over tiles
of the state in shared memory, the columns in windows with one grid-wide
barrier each, csrc/geno_wide.cuh; wide_windows mirrors the window rule),
at T = 1 or T up to 1024 (five trios) with P up to 10 (five founders) and K
up to 23 (WIDE_ENVELOPE): they
replace the XLA forward-backward the reference runs past its Pallas
envelope (whatshap_tpu/ops/genotyping_jax.py _forward_backward,
_forward_backward_batched).  backward and forward hand them every shape
past kernel_supported, by shape alone.

Both take the per-column tables of genotyping.prepare_genotyping_batch in
float32, flattened per column as the Pallas kernels take them: diff (B, C, K,
T*P*2), base (B, C, T*P*2), passign (B, C, T*2^P), trans (B, C, T*T) with
index tj*T + ti, birth and die_next (B, C, K) bool, dup and scaling (B, C).

A wrapper checks its inputs, then runs its plain torch version on CPU tensors
(float32 or float64) and its kernel on CUDA tensors (float32, inside the
kernels' envelope); it never falls back from the one to the other.
`launches` on a wrapper counts its kernel launches, nothing else.  The plain
versions follow the Pallas kernels' arithmetic step by step, in the dtype of
their inputs, with the column loop in Python: in float64 they are the CPU
route, in float32 the yardstick the kernels are held against.
"""

import numpy as np
import torch

from .wmec_cuda import MAX_K_WIDE, WIDE_P, WIDE_T, _check, _check_device, _launch

#: Largest K of the kernels per transmission count T, and the founder
#: partition counts they are built for.  T = 1 reaches K = 17, the
#: reference kernel's ceiling (genotyping_pallas.MAX_K, T * 2^P * 2^K <=
#: 2^19).
MAX_K_T = {1: 17, 4: 16, 16: 13}
P_OF_T = {1: (2,), 4: (2, 4), 16: (2, 4)}
ENVELOPE = "; ".join(f"T = {t}, P in {P_OF_T[t]}, K <= {k}" for t, k in MAX_K_T.items())
#: Most CTAs of a cluster as a power of two (16 is Hopper's non-portable
#: cluster size), and most threads of a CTA as a power of two
#: (csrc/geno_cluster.cuh kMaxCtaBits, kThreadBits).
MAX_CTA_BITS = 4
THREAD_BITS = 9
#: The wide kernels' envelope, that of the wide wMEC kernels
#: (wmec_cuda.WIDE_T, WIDE_P, MAX_K_WIDE): one sample (T = 1, P = 2), or a
#: pedigree of T in WIDE_T transmission values with P in WIDE_P, at any K up
#: to MAX_K_WIDE, the ceiling of the phase CLI.
WIDE_ENVELOPE = f"T = 1, P = 2, K <= {MAX_K_WIDE}; T in {WIDE_T}, P in {WIDE_P}, K <= {MAX_K_WIDE}"
#: A wide kernel's tile: at most WIDE_TILE entries (plane, state), the coset
#: of min(K, log2(WIDE_TILE / T)) state bits in all T planes; CTAs of 256
#: threads, at most WIDE_MAX_CTAS_PER_SM of them resident on an SM (2048
#: threads), which bounds the rows of partial sums a launch needs
#: (csrc/geno_wide.cuh).
WIDE_TILE = 4096
WIDE_MAX_CTAS_PER_SM = 8
#: The most columns a wide kernel's window takes (csrc/geno_wide.cuh
#: kWin), and the most floats of red's partial rows a forward window keeps
#: a CTA and instance (its columns times T * 2^P).
WIDE_WINDOW = 16
WIDE_RED_WORDS = 16384
#: The most bytes of red's partial rows a wide forward launch holds (two
#: rows of T * 2^P floats a window column for each CTA and instance): where
#: a row is large (1 MiB at T = 256, P = 10; 4 MiB at T = 1024, P = 10) the
#: launch takes fewer CTAs (wide_max_ctas), so that the rows stay within it.
WIDE_RED_BYTES = 1 << 30


def kernel_supported(K: int, T: int, P: int) -> bool:
    """Shapes the kernels take: T in MAX_K_T, P in P_OF_T[T], 1 <= K <=
    MAX_K_T[T]."""
    return T in MAX_K_T and P in P_OF_T[T] and 1 <= K <= MAX_K_T[T]


def wide_supported(K: int, T: int, P: int) -> bool:
    """Shapes the wide kernels take: T == 1 with P == 2, or T in WIDE_T with
    P in WIDE_P, and 1 <= K <= MAX_K_WIDE."""
    if T == 1:
        return P == 2 and 1 <= K <= MAX_K_WIDE
    return T in WIDE_T and P in WIDE_P and 1 <= K <= MAX_K_WIDE


def wide_tiles(K: int, T: int) -> int:
    """Tiles of one instance in the wide kernels: 2^K over the states of a
    tile, min(2^K, WIDE_TILE / T)."""
    return (1 << K) // min(1 << K, WIDE_TILE // T)


def wide_lb(K: int, T: int) -> int:
    """Tile bits of the wide kernels: log2 of min(2^K, WIDE_TILE / T)."""
    return min(K, (WIDE_TILE // T).bit_length() - 1)


def wide_window_cap(T: int, P: int, backward: bool) -> int:
    """The most columns a window of the wide kernels takes.  The forward:
    WIDE_WINDOW, fewer where red's partial rows of a window (its columns
    times T * 2^P floats a CTA and instance) would pass WIDE_RED_WORDS.
    The backward settles each column's scaling after a barrier, so a window
    of W > 1 columns runs its first W - 1 columns twice (the sums, then
    the store): it takes windows at T = 1, where a column's tile work is
    short against a barrier, and one column a window past it, where the
    operations bound the pass."""
    if backward:
        return WIDE_WINDOW if T == 1 else 1
    return max(1, min(WIDE_WINDOW, WIDE_RED_WORDS // (T << P)))


def wide_unions(flags, backward: bool) -> np.ndarray:
    """The union over the instances of each column's fold slots, by the
    pass's order (the backward from the last column down, its column 0
    folding nothing), as the wide kernels' prologue gathers it from the
    fold flags (B, C, K): uint32 (C,)."""
    f = np.asarray(flags.cpu() if isinstance(flags, torch.Tensor) else flags, dtype=bool)
    masks = (f.astype(np.uint64) << np.arange(f.shape[2], dtype=np.uint64)).sum(axis=2)
    u = np.bitwise_or.reduce(masks, axis=0).astype(np.uint32)
    if backward:
        u[0] = 0
        u = u[::-1].copy()
    return u


def wide_windows(uq, lb: int, wcap: int) -> list:
    """The wide kernels' window rule (csrc/geno_wide.cuh window_rule) over
    the pass-order unions uq (wide_unions) at lb tile bits and window cap
    wcap: windows never cross a multiple of wcap; each starts after the
    previous one and takes the next column while the union of its columns'
    slots stays within lb bits (a column past lb alone: further fold
    passes).  Returns win (C,): the length of the window that starts at q,
    0 inside a window."""
    uq = [int(u) for u in uq]
    C = len(uq)
    win = [0] * C
    for lo in range(0, C, wcap):
        hi = min(C, lo + wcap)
        q = lo
        while q < hi:
            u, n = uq[q], 1
            if bin(u).count("1") <= lb:
                while q + n < hi and bin(u | uq[q + n]).count("1") <= lb:
                    u |= uq[q + n]
                    n += 1
            win[q] = n
            q += n
    return win


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def wide_red_rows(T: int, P: int) -> int:
    """Rows of red's partial sums (one a CTA or an instance, each two rows of
    T * 2^P floats a window column) that fit WIDE_RED_BYTES."""
    return WIDE_RED_BYTES // (2 * wide_window_cap(T, P, backward=False) * (T * 4 << P))


def wide_max_ctas(dev: torch.device, B: int, K: int, T: int, P: int = None) -> int:
    """The most CTAs a wide launch over B instances takes: no more than its
    tiles, nor than the card keeps resident; with P, the forward's, whose
    partial rows of red (one a CTA and one an instance) stay within
    wide_red_rows (at least one CTA)."""
    n = min(B * wide_tiles(K, T), WIDE_MAX_CTAS_PER_SM * _sm_count(dev))
    return n if P is None else max(1, min(n, wide_red_rows(T, P) - B))


def cluster_layout(K: int):
    """The kernels' launch for one instance of K slots, whatever its T:
    (cta_bits, reg_bits, threads), a cluster of 2^cta_bits CTAs of `threads`
    threads, each thread holding 2^reg_bits states of every plane in
    registers.  A state index holds, from its low bits up, the thread's
    lane and warp, the CTA's rank and the register bits
    (csrc/geno_cluster.cuh); the state never leaves the chip.  A cluster
    has as many CTAs as leave each 2^9 states or more, at most 16."""
    cta_bits = min(MAX_CTA_BITS, max(0, K - THREAD_BITS))
    kc = K - cta_bits
    reg_bits = max(0, kc - THREAD_BITS)
    return cta_bits, reg_bits, 1 << max(5, kc - reg_bits)


def fold_levels(K: int, flags) -> set:
    """The levels of the state index at which the fold flags (B, C, K)
    fold a bit in the kernels' cluster layout: "lane", "warp", "cta" and
    "register", and "top" where the top CTA-rank bit folds."""
    cta_bits, reg_bits, _threads = cluster_layout(K)
    kc = K - cta_bits - reg_bits  # thread bits; the register bits are the top ones
    levels = set()
    for p in np.flatnonzero(flags.cpu().numpy().any(axis=(0, 1))).tolist():
        levels.add("lane" if p < min(5, kc) else "warp" if p < kc else "cta" if p < K - reg_bits else "register")
        if cta_bits and p == K - reg_bits - 1:
            levels.add("top")
    return levels


def _sum_fold(x, K: int, bits, any_bits):
    """Sum out the flagged slot bits of the state x (B, S, T), writing the
    pair's sum to both partners; bits (B, K) bool, per instance, and
    any_bits (K,) their union on the host."""
    B, S, T = x.shape
    for p in range(K):
        if not any_bits[p]:
            continue
        flag = bits[:, p]
        view = x.reshape(B, S >> (p + 1), 2, (1 << p) * T)
        total = view[:, :, 0] + view[:, :, 1]
        folded = torch.stack([total, total], dim=2).reshape(B, S, T)
        x = torch.where(flag[:, None, None], folded, x)
    return x


def _emission(bits, diff_c, base_c, T: int, P: int):
    """exp(sum_p (acc_j + base_j)) with acc = bits @ diff over the slot axis
    and j = (t*P + p)*2 + bit p of a; bits (S, K), diff_c (B, K, T*P*2),
    base_c (B, T*P*2).  Returns (B, S, T, nA).  The sums over p are taken in
    ascending order, as the reference sums them, built up a bit at a time
    (the assignments with bit p clear, then those with it set): 2^P adds a
    state and plane, not P * 2^P gathers and adds (the route at P = 10 on
    the CPU)."""
    B, S = diff_c.shape[0], bits.shape[0]
    logcp = (torch.matmul(bits, diff_c) + base_c[:, None, :]).reshape(B, S, T, P, 2)
    lem = logcp[:, :, :, 0, :]
    for p in range(1, P):
        lem = torch.cat([lem + logcp[:, :, :, p, :1], lem + logcp[:, :, :, p, 1:]], dim=-1)
    return torch.exp(lem)


def _bits(K: int, dtype, device):
    """The slot bits of every state, (2^K, K) in `dtype`."""
    idx = torch.arange(1 << K, device=device)
    return ((idx[:, None] >> torch.arange(K, device=device)[None, :]) & 1).to(dtype)


def backward_plain(K, T, P, diff, base, passign, trans, birth, dup):
    """Plain torch version of the backward pass (see backward), in the dtype
    of its inputs; base, passign and trans may also come unflattened
    ((B, C, T, P, 2), (B, C, T, nA), (B, C, T, T))."""
    B, C = diff.shape[0], diff.shape[1]
    S, nA = 1 << K, 1 << P
    base = base.reshape(B, C, T * P * 2)
    passign = passign.reshape(B, C, T, nA)
    trans = trans.reshape(B, C, T, T)
    bits = _bits(K, diff.dtype, diff.device)
    any_birth = birth.any(dim=0).cpu().tolist()
    beta = torch.ones((B, S, T), dtype=diff.dtype, device=diff.device)
    beta_store = torch.empty((B, C, T, S), dtype=diff.dtype, device=diff.device)
    scaling = torch.empty((B, C), dtype=diff.dtype, device=diff.device)
    for c in range(C - 1, -1, -1):
        em = _emission(bits, diff[:, c], base[:, c], T, P)
        scaling[:, c] = (beta.sum(dim=(1, 2)) / dup[:, c]) * nA
        inv = (1.0 / scaling[:, c])[:, None, None]
        weighted = beta * (em * passign[:, c, None]).sum(dim=3)  # (B, S, T_i)
        beta_store[:, c] = (beta * inv).transpose(1, 2)
        contrib = torch.matmul(weighted, trans[:, c].transpose(1, 2))  # (B, S, T_j)
        beta = _sum_fold(contrib, K, birth[:, c], any_birth[c]) * inv
    return beta_store, scaling


def forward_plain(K, T, P, diff, base, passign, trans, die_next, scaling, beta_store):
    """Plain torch version of the forward pass (see forward), in the dtype of
    its inputs; returns red (B, C, T * 2^P)."""
    B, C = diff.shape[0], diff.shape[1]
    S, nA = 1 << K, 1 << P
    base = base.reshape(B, C, T * P * 2)
    passign = passign.reshape(B, C, T, nA)
    trans = trans.reshape(B, C, T, T)
    bits = _bits(K, diff.dtype, diff.device)
    any_die = die_next.any(dim=0).cpu().tolist()
    red = torch.empty((B, C, T, nA), dtype=diff.dtype, device=diff.device)
    alpha = None
    for c in range(C):
        em = _emission(bits, diff[:, c], base[:, c], T, P)
        inv = 1.0 / scaling[:, c]
        if c == 0:
            sum_prev = torch.ones((B, S, T), dtype=diff.dtype, device=diff.device)
        else:
            sum_prev = torch.matmul(alpha, trans[:, c])  # sum_tj alpha[tj] * trans[tj, ti]
        fwd = sum_prev[..., None] * em * (passign[:, c] * inv[:, None, None])[:, None]
        if c == C - 1:  # the last column has no successor: identity beta
            red[:, c] = fwd.sum(dim=1)
        else:
            red[:, c] = (fwd * beta_store[:, c].transpose(1, 2)[..., None]).sum(dim=1)
        alpha = _sum_fold(fwd.sum(dim=3), K, die_next[:, c], any_die[c])
    return red.reshape(B, C, T * nA)


def _check_inputs(name, K, T, P, diff, base, passign, trans, flags, per_col, wide_only=False):
    """Shape checks shared by the wrappers: float32, or float64 on the CPU,
    and on CUDA a shape one of the kernels takes (with wide_only, the wide
    kernels); returns the device."""
    B, C = diff.shape[0], diff.shape[1]
    dev = _check_device(diff, base, passign, trans, flags, per_col)
    ok = wide_supported(K, T, P) or (not wide_only and kernel_supported(K, T, P))
    if dev.type == "cuda" and not ok:
        envelope = WIDE_ENVELOPE if wide_only else f"{ENVELOPE}; wide: {WIDE_ENVELOPE}"
        raise ValueError(f"{name}: unsupported shape K={K}, T={T}, P={P} ({envelope})")
    if B < 1 or C < 1:
        raise ValueError(f"{name}: needs at least one instance and one column")
    nA = 1 << P
    dtype = torch.float64 if dev.type == "cpu" and diff.dtype == torch.float64 else torch.float32
    _check(diff, "diff", dtype, (B, C, K, T * P * 2))
    _check(base, "base", dtype, (B, C, T * P * 2))
    _check(passign, "passign", dtype, (B, C, T * nA))
    _check(trans, "trans", dtype, (B, C, T * T))
    _check(flags, "fold flags", torch.bool, (B, C, K))
    _check(per_col, "per-column scale", dtype, (B, C))
    return dev


def _run(dev, name, *args) -> None:
    with torch.cuda.device(dev):
        _launch(name, *args)


def backward(K, T, P, diff, base, passign, trans, birth, dup):
    """Scaled backward pass over stacked instances: birth (B, C, K) flags the
    slot bits born entering each column, dup (B, C) is each column's
    inactive-bit duplicate factor 2^(K - active).  Returns beta_store (B, C,
    T, 2^K), the incoming beta of every column scaled by its sum, and scaling
    (B, C), in the inputs' dtype, as the Pallas backward kernel does.  On
    CUDA each instance runs as one cluster of CTAs (cluster_layout) where
    kernel_supported, and the shapes past it go to backward_wide."""
    dev = _check_inputs("backward", K, T, P, diff, base, passign, trans, birth, dup)
    if dev.type == "cpu":
        return backward_plain(K, T, P, diff, base, passign, trans, birth, dup)
    if not kernel_supported(K, T, P):
        return backward_wide(K, T, P, diff, base, passign, trans, birth, dup)

    B, C, S = diff.shape[0], diff.shape[1], 1 << K
    beta_store = torch.empty((B, C, T, S), dtype=torch.float32, device=diff.device)
    scaling = torch.empty((B, C), dtype=torch.float32, device=diff.device)
    _run(
        dev, "geno_backward",
        diff.data_ptr(), base.data_ptr(), passign.data_ptr(), trans.data_ptr(),
        birth.data_ptr(), dup.data_ptr(), beta_store.data_ptr(), scaling.data_ptr(),
        B, C, K, T, P,
    )
    backward.launches += 1
    return beta_store, scaling


backward.launches = 0


def backward_wide(K, T, P, diff, base, passign, trans, birth, dup):
    """backward with the state in device memory (csrc/geno_backward_wide.cu),
    at any shape of WIDE_ENVELOPE, inside the cluster kernel's envelope too;
    the same function and outputs.  The kernel keeps its state in
    beta_store itself; beside it a few words a column (the fold masks and
    the windows) and rows of partial sums a CTA and instance (two, and a
    float64 one a column of a window: wide_window_cap)."""
    dev = _check_inputs("backward_wide", K, T, P, diff, base, passign, trans, birth, dup, wide_only=True)
    if dev.type == "cpu":
        return backward_plain(K, T, P, diff, base, passign, trans, birth, dup)

    B, C, S = diff.shape[0], diff.shape[1], 1 << K
    beta_store = torch.empty((B, C, T, S), dtype=torch.float32, device=diff.device)
    scaling = torch.empty((B, C), dtype=torch.float32, device=diff.device)
    max_ctas = wide_max_ctas(dev, B, K, T)
    wcap = wide_window_cap(T, P, backward=True)
    masks = torch.empty((B, C), dtype=torch.int32, device=diff.device)
    cols = torch.empty((3, C), dtype=torch.int32, device=diff.device)
    part = torch.empty(((2 + 2 * wcap) * (max_ctas + B) + 1,), dtype=torch.float32, device=diff.device)
    _run(
        dev, "geno_backward_wide",
        diff.data_ptr(), base.data_ptr(), passign.data_ptr(), trans.data_ptr(),
        birth.data_ptr(), dup.data_ptr(), beta_store.data_ptr(), scaling.data_ptr(),
        masks.data_ptr(), cols[0].data_ptr(), cols[1].data_ptr(), cols[2].data_ptr(), part.data_ptr(),
        B, C, K, T, P, wcap, max_ctas,
    )
    backward_wide.launches += 1
    return beta_store, scaling


backward_wide.launches = 0


def forward(K, T, P, diff, base, passign, trans, die_next, scaling, beta_store):
    """Scaled forward pass over stacked instances, from backward's outputs:
    die_next (B, C, K) flags the slot bits that die after each column.
    Returns red (B, C, T * 2^P) in the inputs' dtype: red[b, c, t*nA + a] is the sum over
    the bipartitions of forward * beta of transmission t and allele
    assignment a, as the Pallas forward kernel emits it.  On CUDA each
    instance runs as one cluster of CTAs where kernel_supported, and the
    shapes past it go to forward_wide, as in backward."""
    dev = _check_inputs("forward", K, T, P, diff, base, passign, trans, die_next, scaling)
    B, C, S = diff.shape[0], diff.shape[1], 1 << K
    _check(beta_store, "beta_store", diff.dtype, (B, C, T, S))
    _check_device(diff, beta_store)
    if dev.type == "cpu":
        return forward_plain(K, T, P, diff, base, passign, trans, die_next, scaling, beta_store)
    if not kernel_supported(K, T, P):
        return forward_wide(K, T, P, diff, base, passign, trans, die_next, scaling, beta_store)

    red = torch.empty((B, C, T << P), dtype=torch.float32, device=diff.device)
    _run(
        dev, "geno_forward",
        diff.data_ptr(), base.data_ptr(), passign.data_ptr(), trans.data_ptr(),
        die_next.data_ptr(), scaling.data_ptr(), beta_store.data_ptr(), red.data_ptr(),
        B, C, K, T, P,
    )
    forward.launches += 1
    return red


forward.launches = 0


def forward_wide(K, T, P, diff, base, passign, trans, die_next, scaling, beta_store):
    """forward with the state in device memory (csrc/geno_forward_wide.cu),
    at any shape of WIDE_ENVELOPE, inside the cluster kernel's envelope too;
    the same function and output.  Its scratch: the state alpha (B, T, 2^K)
    and two rows of partial sums of red (T * 2^P) for each CTA, instance
    and column of a window (wide_window_cap), at most WIDE_RED_BYTES of them
    (wide_max_ctas)."""
    dev = _check_inputs("forward_wide", K, T, P, diff, base, passign, trans, die_next, scaling, wide_only=True)
    B, C, S = diff.shape[0], diff.shape[1], 1 << K
    _check(beta_store, "beta_store", diff.dtype, (B, C, T, S))
    _check_device(diff, beta_store)
    if dev.type == "cpu":
        return forward_plain(K, T, P, diff, base, passign, trans, die_next, scaling, beta_store)

    red = torch.empty((B, C, T << P), dtype=torch.float32, device=diff.device)
    max_ctas = wide_max_ctas(dev, B, K, T, P)
    wcap = wide_window_cap(T, P, backward=False)
    alpha = torch.empty((B, T, S), dtype=torch.float32, device=diff.device)
    masks = torch.empty((B, C), dtype=torch.int32, device=diff.device)
    cols = torch.empty((3, C), dtype=torch.int32, device=diff.device)
    part = torch.empty((2, wcap, max_ctas + B, T << P), dtype=torch.float32, device=diff.device)
    _run(
        dev, "geno_forward_wide",
        diff.data_ptr(), base.data_ptr(), passign.data_ptr(), trans.data_ptr(),
        die_next.data_ptr(), scaling.data_ptr(), beta_store.data_ptr(), red.data_ptr(),
        alpha.data_ptr(), masks.data_ptr(), cols[0].data_ptr(), cols[1].data_ptr(), cols[2].data_ptr(),
        part.data_ptr(), B, C, K, T, P, wcap, max_ctas,
    )
    forward_wide.launches += 1
    return red


forward_wide.launches = 0
