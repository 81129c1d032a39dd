"""
Genotyping forward-backward HMM of the PyTorch port: host preparation of the
per-column tables, the plain torch forward-backward, and the route onto the
CUDA kernels.

Mirrors whatshap_tpu/ops/genotyping_jax.py (host preparation, f64 scan) and
ops/genotyping_pallas.py (kernel launch and marginals); the HMM is the one
of src/genotypedptable.cpp: the state of a column is the 2^K bipartitions of
its read slots times T transmission values, emissions are built in log space
as base + bits @ diff summed over the founder partitions, the slot bits born
or dying between columns are sum-folded, and every column is rescaled by its
scaling sum.

Three parts:

- host preparation (_transition_tables_f64, _prepare_inputs,
  prepare_genotyping_batch): numpy float64, copied from the reference
  package so that the port imports nothing of it;
- forward_backward_plain: the plain torch versions of both passes in one
  call (genotyping_cuda.backward_plain, forward_plain), the float64
  yardstick of the route on any device;
- the route (run_genotyping, run_genotyping_batched, launch_genotyping,
  forward_backward): through genotyping_cuda's wrappers, so on a CUDA
  device every instance goes to the float32 kernels (the cluster kernels,
  or past their envelope the wide kernels with the state in device
  memory), and what neither can take raises NotImplementedError instead
  of leaving the card; on the CPU the wrappers run the plain versions in
  float64.
"""

from typing import Optional

import numpy as np
import torch

from ..core.pedigree_model import Pedigree
from . import genotyping_cuda, wmec


def _transition_tables_f64(packed: "wmec.PackedProblem", pedigree: Pedigree):
    """Per-column transmission transition matrix trans (C, T, T) and
    allele-assignment prior passign (C, T, nA), float64, and the genotype
    index gt_idx (T, nA, n_ind) of each allele assignment
    (transitionprobabilitycomputer.cpp).  A column whose prior sums to 0
    gets NaN, as in the reference."""
    C, T, P = packed.n_cols, packed.T, packed.P
    n_ind = len(pedigree)
    nA = 1 << P
    tc = pedigree.triple_count
    pcmat = wmec._popcount_matrix(T).astype(np.int64)

    recomb_prob = 10.0 ** (-packed.rc.astype(np.float64) / 10.0)  # (C,)
    i_arr = np.arange(2 * tc + 1, dtype=np.float64)
    bern = recomb_prob[:, None] ** i_arr[None, :] * (1 - recomb_prob[:, None]) ** (
        2 * tc - i_arr[None, :]
    )  # (C, 2tc+1)
    m = bern[:, pcmat]  # (C, T, T)
    trans = m / m.sum(axis=2, keepdims=True)

    # gt_idx[t, a, ind]
    gt_idx = np.zeros((T, nA, max(n_ind, 1)), dtype=np.int64)
    a_arr = np.arange(nA)
    for t in range(T):
        for ind in range(n_ind):
            a0 = (a_arr >> packed.h2p[t, ind, 0]) & 1
            a1 = (a_arr >> packed.h2p[t, ind, 1]) & 1
            gt_idx[t, :, ind] = a0 + a1

    # per-column GLs (C, n_ind, 3)
    gl = np.zeros((C, max(n_ind, 1), 3), dtype=np.float64)
    for ind in range(n_ind):
        row = pedigree._genotype_likelihoods[ind]
        gl[:, ind, :] = np.asarray([g._gl[:3] for g in row[:C]], dtype=np.float64)

    passign = np.ones((C, T, nA), dtype=np.float64)
    for t in range(T):
        probs = np.ones((C, nA), dtype=np.float64)
        for ind in range(n_ind):
            probs *= gl[:, ind, gt_idx[t, :, ind]]
        keys = [tuple(gt_idx[t, a]) for a in range(nA)]
        counts: dict = {}
        for k in keys:
            counts[k] = counts.get(k, 0) + 1
        mult = np.array([counts[k] for k in keys], dtype=np.float64)
        probs = probs / mult[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            passign[:, t, :] = probs / probs.sum(axis=1, keepdims=True)
    return trans, passign, gt_idx


def _prepare_inputs(packed: "wmec.PackedProblem", pedigree: Pedigree):
    """Host-side packing of the per-column HMM tables (float64 numpy)."""
    C, K, T, P = packed.n_cols, packed.K, packed.T, packed.P
    nA = 1 << P

    trans, passign, gt_idx = _transition_tables_f64(packed, pedigree)

    # log q per (column, slot, hap allele); inactive/blank slots contribute 0
    live = packed.active & (packed.allele != 2)
    w = packed.weight.astype(np.float64)
    proba = np.where(w == 0, 0.9999, 10.0 ** (-w / 10.0))
    q0 = np.where(packed.allele == 0, 1 - proba, proba)
    q1 = np.where(packed.allele == 0, proba, 1 - proba)
    with np.errstate(divide="ignore", invalid="ignore"):
        qlog = np.where(
            live[:, :, None],
            np.log(np.stack([q0, q1], axis=-1)),
            0.0,
        )  # (C, K, 2)
    slot_ind = np.where(
        packed.slot_read >= 0,
        packed.read_source[np.maximum(packed.slot_read, 0)]
        if packed.read_source.size
        else 0,
        0,
    )  # (C, K)

    # log-emission as base + Bits @ diff over (t, p, al): one-hot scatter of
    # each live slot's qlog onto its bit-0/bit-1 partition
    base = np.zeros((C, T, P, 2), dtype=np.float64)
    diff = np.zeros((C, K, T, P, 2), dtype=np.float64)
    p_range = np.arange(P)
    for t in range(T):
        p_bit0 = packed.h2p[t, slot_ind, 1]  # (C, K)
        p_bit1 = packed.h2p[t, slot_ind, 0]
        oh0 = (p_bit0[:, :, None] == p_range[None, None, :]).astype(np.float64)
        oh1 = (p_bit1[:, :, None] == p_range[None, None, :]).astype(np.float64)
        base[:, t] = np.einsum("ckp,cka->cpa", oh0, qlog)
        diff[:, :, t] = (oh1 - oh0)[:, :, :, None] * qlog[:, :, None, :]

    # fold masks: bits born entering column c (backward) / dying after c-1
    # (forward projection uses die_prev of the NEXT column)
    birth = np.zeros((C, K), dtype=bool)
    prev_active = np.zeros(K, dtype=bool)
    for c in range(C):
        birth[c] = packed.active[c] & (~prev_active | packed.die_prev[c])
        prev_active = packed.active[c].copy()
    die_next = np.zeros((C, K), dtype=bool)
    if C > 1:
        die_next[:-1] = packed.die_prev[1:]

    k_active = packed.active.sum(axis=1)
    dup = np.float64(2.0) ** (K - k_active)  # inactive-bit duplicate factor

    # genotype masks per individual: (n_ind, T, nA, 3)
    n_ind = max(len(pedigree), 1)
    gmask = np.zeros((n_ind, T, nA, 3), dtype=np.float64)
    for ind in range(gt_idx.shape[2]):
        for g in range(3):
            gmask[ind, :, :, g] = gt_idx[:, :, ind] == g

    return dict(
        trans=trans,
        passign=passign,
        base=base,
        diff=diff.reshape(C, K, T * P * 2),
        birth=birth,
        die_next=die_next,
        dup=dup,
        gmask=gmask,
    )


def prepare_genotyping_batch(packed_list, pedigree):
    """Host-side packing of same-shaped instances for one batched launch.
    Returns (static (K, T, P, n_ind), stacked numpy arrays in the order trans,
    passign, base, diff, birth, die_next, dup, gmask, each with a leading
    instance axis)."""
    shapes = {(p.n_cols, p.K, p.T, p.P) for p in packed_list}
    assert len(shapes) == 1, "instances must share one padded shape"
    inputs = [_prepare_inputs(p, pedigree) for p in packed_list]
    keys = list(inputs[0])
    n_ind = max(len(pedigree), 1)
    first = packed_list[0]
    static = (first.K, first.T, first.P, n_ind)
    stacked = [np.stack([inp[k] for inp in inputs]) for k in keys]
    return static, stacked


def forward_backward_plain(K, T, P, diff, base, passign, trans, birth, die_next, dup):
    """The plain torch forward-backward over stacked instances, in the dtype
    of its inputs (prepare_genotyping_batch's layout as tensors): the
    backward pass, then the forward pass.  Returns (red (B, C, T, nA),
    scaling (B, C))."""
    beta_store, scaling = genotyping_cuda.backward_plain(
        K, T, P, diff, base, passign, trans, birth, dup
    )
    red = genotyping_cuda.forward_plain(
        K, T, P, diff, base, passign, trans, die_next, scaling, beta_store
    )
    B, C = diff.shape[0], diff.shape[1]
    return red.reshape(B, C, T, 1 << P), scaling


def likelihoods_from_red(red: np.ndarray, gmask: np.ndarray) -> np.ndarray:
    """Genotype marginals (B, C, n_ind, 3) float64 from red (B, C, T, nA)
    and the genotype masks gmask (n_ind, T, nA, 3): each individual's
    genotype sums of red, normalised per column (dup cancels)."""
    red = np.asarray(red, dtype=np.float64)
    marg = np.einsum("bcta,itag->bcig", red, gmask)
    norm = red.sum(axis=(2, 3))[:, :, None, None]
    return marg / norm


def _unsupported(K: int, T: int, P: int) -> NotImplementedError:
    return NotImplementedError(
        f"no CUDA genotyping kernel for K={K}, T={T}, P={P} yet: shapes beyond the "
        f"kernels' envelopes ({genotyping_cuda.ENVELOPE}; wide: {genotyping_cuda.WIDE_ENVELOPE}; "
        "six or more trios, T >= 4096, or six or more founders, P >= 12) need kernels with "
        "a wider envelope, ROADMAP Queue 1 item 5"
    )


def _over_budget(K: int, T: int, need: int, budget: int) -> NotImplementedError:
    return NotImplementedError(
        f"one genotyping instance of K={K}, T={T} needs {need} bytes on the card (its beta "
        "table, and past the cluster kernels the wide kernels' scratch), above the table "
        f"budget of {budget} bytes: an instance beyond the memory budget needs the "
        "checkpointed genotyping pass, ROADMAP Queue 1 item 4"
    )


def to_device(stacked, device: torch.device):
    """The stacked host arrays as tensors on `device`, in one copy each:
    float64 on the CPU (the plain route), float32 elsewhere (the kernels'
    dtype), per column flattened as the kernels take them.  Returns (diff,
    base, passign, trans, birth, die_next, dup)."""
    trans, passign, base, diff, birth, die_next, dup, _gmask = stacked
    B, C = diff.shape[0], diff.shape[1]
    dtype = np.float64 if device.type == "cpu" else np.float32

    def put(x, shape=None):
        x = np.ascontiguousarray(x, dtype=x.dtype if x.dtype == np.bool_ else dtype)
        return torch.from_numpy(x.reshape(shape or x.shape)).to(device)

    return (
        put(diff), put(base, (B, C, -1)), put(passign, (B, C, -1)), put(trans, (B, C, -1)),
        put(birth), put(die_next), put(dup),
    )


def instance_bytes(C: int, K: int, T: int, P: int) -> int:
    """Device bytes one instance of C columns takes in the forward-backward:
    its beta table (C * T * 2^K float32), its inputs' copy on the card and
    red (input_bytes) and, past the cluster kernels' envelope, what the wide
    kernels allocate for it beside the table: the forward's state alpha (T *
    2^K float32), its two rows of partial sums of red (T * 2^P float32) for
    each column of a window (genotyping_cuda.wide_window_cap), the
    backward's rows of partial sums (two float32 and a float64 a window
    column) and four words a column (the fold masks and the windows)."""
    table = (C * T * 4 << K) + input_bytes(C, K, T, P)
    if genotyping_cuda.kernel_supported(K, T, P):
        return table
    return table + (T * 4 << K) + _wide_rows_bytes(T, P) + 16 * C


def input_bytes(C: int, K: int, T: int, P: int) -> int:
    """Device bytes of one instance's inputs (to_device) and of its output
    red: a column's diff (K * T * 2P), base (T * 2P), passign and red (T *
    2^P each) and trans (T * T: 4 MiB a column at T = 1024) in float32, its
    birth and die_next flags (K bytes each), dup and scaling."""
    return C * (4 * (K * T * 2 * P + T * 2 * P + 2 * (T << P) + T * T) + 2 * K + 8)


def _wide_rows_bytes(T: int, P: int, forward: bool = True) -> int:
    """Bytes of the wide kernels' rows of partial sums for one CTA or one
    instance: the forward's 2 * window cap rows of T * 2^P float32 (left
    out with forward=False), the backward's two float32 and a float64 a
    window column."""
    fwd = 2 * genotyping_cuda.wide_window_cap(T, P, backward=False) * (T * 4 << P) if forward else 0
    return fwd + 8 * (1 + genotyping_cuda.wide_window_cap(T, P, backward=True))


def chunk_bytes(device: torch.device, K: int, T: int, P: int) -> int:
    """Device bytes a chunk of instances takes once, whatever its size:
    past the cluster kernels' envelope on CUDA, the wide kernels' rows of
    partial sums (_wide_rows_bytes) for each CTA they may launch, the
    forward's for at most genotyping_cuda.wide_red_rows CTAs."""
    if device.type != "cuda" or genotyping_cuda.kernel_supported(K, T, P):
        return 0
    ctas = genotyping_cuda.wide_max_ctas(device, 1 << 30, K, T)
    fwd = _wide_rows_bytes(T, P) - _wide_rows_bytes(T, P, forward=False)
    return ctas * _wide_rows_bytes(T, P) - max(0, ctas - genotyping_cuda.wide_red_rows(T, P)) * fwd


def forward_backward(K, T, P, diff, base, passign, trans, birth, die_next, dup):
    """The route's forward-backward on the device its tensors lie on (from
    to_device): genotyping_cuda.backward, then forward, which launch the
    float32 kernels on CUDA (the cluster kernels inside their envelope, the
    wide kernels past it) and run the plain versions on the CPU.  The
    instances are split into sequential chunks whose bytes (instance_bytes
    each, chunk_bytes once) stay under wmec's table budget.  Returns red
    (B, C, T, nA)."""
    B, C = diff.shape[0], diff.shape[1]
    supported = genotyping_cuda.kernel_supported(K, T, P) or genotyping_cuda.wide_supported(K, T, P)
    if diff.is_cuda and not supported:
        raise _unsupported(K, T, P)
    per_instance = instance_bytes(C, K, T, P)
    fixed = chunk_bytes(diff.device, K, T, P)
    budget = wmec._table_budget(diff.device)
    max_b = B if budget is None else (budget - fixed) // per_instance
    if max_b < 1:
        raise _over_budget(K, T, per_instance + fixed, budget)
    arrays = (diff, base, passign, trans, birth, die_next, dup)
    reds = []
    for lo in range(0, B, max_b):
        d, b_, pa, tr, bi, dn, du = (a[lo : lo + max_b] for a in arrays)
        beta_store, scaling = genotyping_cuda.backward(K, T, P, d, b_, pa, tr, bi, du)
        red = genotyping_cuda.forward(K, T, P, d, b_, pa, tr, dn, scaling, beta_store)
        del beta_store
        reds.append(red.reshape(d.shape[0], C, T, 1 << P))
    return torch.cat(reds) if len(reds) > 1 else reds[0]


def launch_genotyping(static, stacked, device: torch.device) -> np.ndarray:
    """Run prepared instances (prepare_genotyping_batch) on `device`: one
    copy to it, the forward-backward, one copy of red back, the marginals on
    the host.  Returns (B, C, n_ind, 3) float64 likelihoods."""
    K, T, P, _n_ind = static
    red = forward_backward(K, T, P, *to_device(stacked, device))
    red = red.to("cpu", torch.float64).numpy()
    return likelihoods_from_red(red, stacked[7][0])


def run_genotyping_batched(packed_list, pedigree: Pedigree, device=None) -> Optional[np.ndarray]:
    """Genotype likelihoods (B, C, n_ind, 3) float64 of same-shaped packed
    instances (the same C, K, T and P, one pedigree) on `device` (default
    "cuda", see wmec.resolve_device), in one batched forward-backward: the
    reference's run_genotyping_jax_batched
    (whatshap_tpu/ops/genotyping_jax.py:322) and
    run_genotyping_pallas_batched (genotyping_pallas.py:340).  The instances
    are chunked along B under the table budget (forward_backward).  Returns
    None for an empty list; raises ValueError when the shapes differ."""
    device = wmec.resolve_device(device)
    if not packed_list:
        return None
    shapes = sorted({(p.n_cols, p.K, p.T, p.P) for p in packed_list})
    if len(shapes) != 1:
        raise ValueError(
            f"run_genotyping_batched: instances must share one shape (C, K, T, P); got {shapes}"
        )
    static, stacked = prepare_genotyping_batch(packed_list, pedigree)
    return launch_genotyping(static, stacked, device)


def run_genotyping(
    packed: "wmec.PackedProblem", pedigree: Pedigree, device=None
) -> Optional[np.ndarray]:
    """Genotype likelihoods (C, n_ind, 3) float64 of one packed instance on
    `device`, or None for an instance without columns: run_genotyping_batched
    of one instance."""
    if packed.n_cols == 0:
        return None
    return run_genotyping_batched([packed], pedigree, device)[0]
