"""
wMEC/PedMEC solver core of the PyTorch port: host packing, the plain torch
mirror of the column DP, and the route onto the CUDA kernels.

Mirrors whatshap_tpu/ops/wmec.py.  The DP is the same: the 2^K bipartitions
of a column are scored all at once (cost = wbase + bits @ wdiff), the bits of
dying read slots are min-folded with the reference's Gray-order tie-break,
and the backtrace walks the emitted projection tables.  That module's
docstring derives it.

Three parts:

- host packing (pack_problem, connected_column_ranges, extract_*): numpy,
  copied from the reference package so that the port imports nothing of it;
- the plain torch mirror (forward_scan, solve_batched) for any T, with the
  column loop in Python: the CPU path, and the yardstick that the CUDA
  kernels are held against;
- the route (run_dp, run_dp_batched, solve_batched_auto): on a CUDA device
  every instance goes to the hand-written kernels of wmec_cuda, and what
  they cannot take raises NotImplementedError instead of leaving the card.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.pedigree_model import Pedigree, PedigreePartitions
from ..core.readset import ReadSet
from . import wmec_cuda

# "Infinity" cost sentinel.  Chosen so that INF + INF still fits in int32
# (the reference uses uint32 max with explicit overflow guards,
# pedigreedptable.cpp:262-290).
INF = 1 << 29


class MendelianConflictError(RuntimeError):
    def __init__(self):
        super().__init__("Error: Mendelian conflict")


@dataclass
class PackedProblem:
    """A wMEC/PedMEC instance packed into dense per-column arrays."""

    n_cols: int
    K: int  # number of slots (= max coverage)
    T: int  # number of transmission configurations (4^#trios)
    P: int  # number of founder partitions (2*(#individuals - #trios))
    n_reads: int
    positions: np.ndarray  # (C,) genomic positions
    active: np.ndarray  # (C, K) bool
    slot_read: np.ndarray  # (C, K) int32, read index or -1
    allele: np.ndarray  # (C, K) int8  (0/1; 2=blank/inactive)
    weight: np.ndarray  # (C, K) int32 phred
    rank: np.ndarray  # (C, K) int8, rank among active reads (read-id order), -1
    die_prev: np.ndarray  # (C, K) bool: slots that died after column c-1
    rc: np.ndarray  # (C,) int32 recombination cost
    wdiff: np.ndarray  # (C, K, T, P, 2) int32
    wbase: np.ndarray  # (C, T, P, 2) int32
    acost: np.ndarray  # (C, T, 2^P) int32 (INF = incompatible assignment)
    read_slot: np.ndarray  # (R,) int32 slot of each read (-1 if never active)
    read_first_col: np.ndarray  # (R,) int32 first active column (-1)
    h2p: np.ndarray  # (T, I, 2) int32 haplotype -> partition map
    read_source: np.ndarray  # (R,) int32 individual index per read
    # Transmission-relabeling symmetries: XOR masks d such that relabeling
    # one founder's haplotypes maps the DP onto itself with t -> t ^ d and
    # every cost preserved (see pack_problem).  The seam-matrix pass of the
    # batched pedigree route seeds one scan per coset instead of per t.
    t_sym_masks: Tuple[int, ...] = ()


def pack_problem(
    readset: ReadSet,
    recombcost: Sequence[int],
    pedigree: Pedigree,
    distrust_genotypes: bool = False,
    positions: Optional[Sequence[int]] = None,
    check_conflicts: bool = True,
    emission_tables: bool = True,
) -> PackedProblem:
    """Convert a ReadSet + Pedigree into dense arrays for the device DP.

    Mirrors the column semantics of src/columniterator.cpp:10-169 (active
    read tracking, blank entries) and the per-column data consumed by
    src/pedigreecolumncostcomputer.cpp:14-114.
    """
    readset.reassign_read_ids()
    n_reads = len(readset)
    if positions is None:
        cols = readset.get_positions()
    else:
        cols = list(positions)
    C = len(cols)
    pos_to_col = {p: i for i, p in enumerate(cols)}

    n_ind = len(pedigree)
    n_trios = pedigree.triple_count
    T = 4 ** n_trios
    P = 2 * (n_ind - n_trios) if n_ind else 2

    # read -> individual index (direct slot access: this function is the
    # packing hot path for every solver, so Variant-object construction and
    # per-entry method calls are avoided throughout)
    reads = list(readset)
    read_source = np.zeros(n_reads, dtype=np.int32)
    for i, read in enumerate(reads):
        read_source[i] = pedigree.id_to_index(read.sample_id)

    # Per-read active column ranges; all first/last positions must be columns
    # (asserted by the reference's ColumnIterator constructor).
    first_col = np.full(n_reads, -1, dtype=np.int32)
    last_col = np.full(n_reads, -1, dtype=np.int32)
    for i, read in enumerate(reads):
        rpos = read._positions
        if not rpos:
            continue
        fc = pos_to_col.get(rpos[0])
        lc = pos_to_col.get(rpos[-1])
        if fc is None or lc is None:
            raise ValueError(
                "ColumnIterator: read end positions must be contained in the "
                "column position set"
            )
        first_col[i] = fc
        last_col[i] = lc

    # Slot assignment: greedy lowest-free-slot over activation order.
    # Event-driven: reads visited by (start column, read id); before each
    # assignment every slot whose occupant died strictly before that column
    # is freed.  Identical assignment to a per-column sweep (the lowest
    # free slot does not depend on the order slots were freed in).
    import heapq

    read_slot = np.full(n_reads, -1, dtype=np.int32)
    free_slots: List[int] = []
    deaths: List[Tuple[int, int]] = []  # (first column after death, slot)
    next_slot = 0
    for i in np.argsort(first_col, kind="stable").tolist():
        fc = first_col[i]
        if fc < 0:
            continue
        while deaths and deaths[0][0] <= fc:
            heapq.heappush(free_slots, heapq.heappop(deaths)[1])
        if free_slots:
            s = heapq.heappop(free_slots)
        else:
            s = next_slot
            next_slot += 1
        read_slot[i] = s
        heapq.heappush(deaths, (last_col[i] + 1, s))
    K = max(next_slot, 1)

    active = np.zeros((C, K), dtype=bool)
    slot_read = np.full((C, K), -1, dtype=np.int32)
    allele = np.full((C, K), 2, dtype=np.int8)
    weight = np.zeros((C, K), dtype=np.int32)
    rank = np.full((C, K), -1, dtype=np.int8)
    die = np.zeros((C, K), dtype=bool)  # slot dies AFTER column c

    # Per-read entry maps.  Entry lookups are flattened into one scatter:
    # collect (col, slot, allele, quality) for every variant that lands on a
    # column, then assign in bulk.
    flat_pos: List[int] = []
    flat_slot: List[int] = []
    flat_read: List[int] = []
    flat_allele: List[int] = []
    flat_weight: List[int] = []
    for i, read in enumerate(reads):
        if first_col[i] < 0:
            continue
        s = read_slot[i]
        active[first_col[i] : last_col[i] + 1, s] = True
        slot_read[first_col[i] : last_col[i] + 1, s] = i
        die[last_col[i], s] = True
        rpos = read._positions
        flat_pos.extend(rpos)
        flat_slot.extend([s] * len(rpos))
        flat_read.extend([i] * len(rpos))
        flat_allele.extend(read._alleles)
        flat_weight.extend(read._qualities)
    if flat_pos:
        fp_arr = np.asarray(flat_pos, dtype=np.int64)
        cols_arr = np.asarray(cols, dtype=np.int64)
        sorted_cols = C > 1 and bool(np.all(cols_arr[1:] > cols_arr[:-1])) or C <= 1
        if sorted_cols:
            ci = np.searchsorted(cols_arr, fp_arr)
            fl_read = np.asarray(flat_read, dtype=np.int64)
            ok = (
                (ci < C)
                & (cols_arr[np.minimum(ci, C - 1)] == fp_arr)
                & (ci >= first_col[fl_read])
                & (ci <= last_col[fl_read])
            )
        else:  # unsorted position list: fall back to the dict
            ci = np.asarray([pos_to_col.get(p, -1) for p in flat_pos], dtype=np.int64)
            fl_read = np.asarray(flat_read, dtype=np.int64)
            # keep the per-variant active-span guard of the column iterator
            ok = (
                (ci >= 0)
                & (ci >= first_col[fl_read])
                & (ci <= last_col[fl_read])
            )
        ci_ok = ci[ok]
        sl_ok = np.asarray(flat_slot, dtype=np.int64)[ok]
        allele[ci_ok, sl_ok] = np.asarray(flat_allele, dtype=np.int8)[ok]
        weight[ci_ok, sl_ok] = np.asarray(flat_weight, dtype=np.int32)[ok]

    # rank among active reads in read-id order, vectorized over columns:
    # stable-argsort the (inactive -> +inf) read ids per row, then scatter
    # 0..n_active-1 back through the ordering
    sort_key = np.where(active, slot_read, np.iinfo(np.int32).max)
    order_all = np.argsort(sort_key, axis=1, kind="stable")  # (C, K)
    n_act = active.sum(axis=1)
    rank_vals = np.where(
        np.arange(K)[None, :] < n_act[:, None], np.arange(K)[None, :], -1
    ).astype(np.int8)
    np.put_along_axis(rank, order_all, rank_vals, axis=1)

    die_prev = np.zeros((C, K), dtype=bool)
    if C > 1:
        die_prev[1:] = die[:-1]

    # Transmission-dependent partition maps
    h2p = np.zeros((T, max(n_ind, 1), 2), dtype=np.int32)
    for t in range(T):
        pp = PedigreePartitions(pedigree, t)
        for i in range(n_ind):
            h2p[t, i, 0] = pp.haplotype_to_partition(i, 0)
            h2p[t, i, 1] = pp.haplotype_to_partition(i, 1)

    # Transmission-relabeling symmetries.  Relabeling a FOUNDER's two
    # haplotypes (founder = never a child in a triple; its partition pair is
    # free, pedigreepartitions.cpp:7-28) and simultaneously flipping the
    # transmission bit of every triple that selects from it (bit 2t = father
    # side, 2t+1 = mother side, pedigreepartitions.cpp:39-52) is a
    # cost-preserving bijection of the whole DP: reads of that founder swap
    # partition side inside the min-fold, every descendant's h2p entry is
    # unchanged, genotype/GL costs are symmetric in the haplotype pair, and
    # recombination cost is Hamming on t (XOR-invariant).  Hence
    # G[a][b] == G[a^d][b^d] for every d in the XOR-span of these masks.
    triples = pedigree.triples
    child_of = {c for _f, _m, c in triples}
    t_sym_masks = []
    for i in range(n_ind):
        if i in child_of:
            continue
        mask = 0
        for ti, (fa, mo, _c) in enumerate(triples):
            if fa == i:
                mask |= 1 << (2 * ti)
            if mo == i:
                mask |= 1 << (2 * ti + 1)
        if mask:
            t_sym_masks.append(mask)

    if not emission_tables:
        # caller consumes only the structural arrays (the genotyping HMM
        # builds its own probability-space emission from allele/weight):
        # skip the wMEC cost-table construction below entirely
        rc = np.asarray(list(recombcost), dtype=np.int32)
        if C > 0 and len(rc) < C:
            rc = np.concatenate([rc, np.full(C - len(rc), INF, dtype=np.int32)])
        empty32 = np.zeros(0, dtype=np.int32)
        return PackedProblem(
            n_cols=C,
            K=K,
            T=T,
            P=P,
            n_reads=n_reads,
            positions=np.asarray(cols, dtype=np.int64),
            active=active,
            slot_read=slot_read,
            allele=allele,
            weight=weight,
            rank=rank,
            die_prev=die_prev,
            rc=rc[:C] if C > 0 else rc,
            wdiff=empty32.reshape(0, K, T, P, 2),
            wbase=empty32.reshape(0, T, P, 2),
            acost=empty32.reshape(0, T, 1 << P),
            read_slot=read_slot,
            read_first_col=first_col,
            h2p=h2p,
            read_source=read_source,
            t_sym_masks=tuple(t_sym_masks),
        )

    # Column cost weights.
    # c_s(a) = weight if allele in {0,1} and allele != a else 0
    # (pedigreecolumncostcomputer.cpp:53-76: a REF entry adds its phred to
    # cost_partition[p][1], an ALT entry to cost_partition[p][0]).
    contra = np.zeros((C, K, 2), dtype=np.int32)
    is_ref = allele == 0
    is_alt = allele == 1
    contra[:, :, 0] = np.where(is_alt, weight, 0)
    contra[:, :, 1] = np.where(is_ref, weight, 0)

    if n_reads > 0:
        ind_of_slot = np.where(slot_read >= 0, read_source[np.maximum(slot_read, 0)], 0)
    else:
        ind_of_slot = np.zeros((C, K), dtype=np.int32)
    # partition index per (column, slot, transmission, bit)
    p_of_bit0 = h2p[:, :, 0][np.arange(T)[:, None, None], ind_of_slot[None]]  # (T,C,K)
    p_of_bit1 = h2p[:, :, 1][np.arange(T)[:, None, None], ind_of_slot[None]]
    # one-hot over partitions
    sel0 = (p_of_bit0[..., None] == np.arange(P)[None, None, None, :])  # (T,C,K,P)
    sel1 = (p_of_bit1[..., None] == np.arange(P)[None, None, None, :])
    # wbase[c,t,p,a] = sum_s sel0 * c_s(a); wdiff = (sel1 - sel0) * c_s(a)
    wbase = np.einsum("tckp,cka->ctpa", sel0.astype(np.int64), contra.astype(np.int64))
    wdiff = (
        (sel1.astype(np.int64) - sel0.astype(np.int64)).transpose(1, 2, 0, 3)[
            ..., None
        ]
        * contra[:, :, None, None, :].astype(np.int64)
    )  # (C,K,T,P,2)

    # Genotype-compatible allele assignments per (column, transmission):
    # acost[c,t,i] = sum of (truncated) GL costs, or INF if incompatible
    # (pedigreecolumncostcomputer.cpp:25-49).
    nA = 1 << P
    acost = np.zeros((C, T, nA), dtype=np.int64)
    assign_idx = np.arange(nA)
    # per-individual genotype data is transmission-independent: extract once
    ind_gl_cols: List[Optional[np.ndarray]] = []
    ind_gt_idx: List[Optional[np.ndarray]] = []
    for ind in range(n_ind):
        if distrust_genotypes:
            gl_cols = np.zeros((C, 3), dtype=np.int64)
            gl_row = pedigree._genotype_likelihoods[ind]
            for c in range(C):
                gls = gl_row[c]  # IndexError on short rows, like the getter
                if gls is None:
                    raise RuntimeError(
                        "genotype likelihoods required with distrust_genotypes"
                    )
                # unsigned-int truncation per addition, as in the C++
                vec = gls._gl
                gl_cols[c, 0] = int(vec[0])
                gl_cols[c, 1] = int(vec[1])
                gl_cols[c, 2] = int(vec[2])
            ind_gl_cols.append(gl_cols)
            ind_gt_idx.append(None)
        else:
            gt_row = pedigree._genotypes[ind]
            gt_list = []
            for c in range(C):
                als = gt_row[c]._alleles  # IndexError on short rows, like the getter
                if len(als) == 2 and als[0] in (0, 1) and als[1] in (0, 1):
                    gt_list.append(als[0] + als[1])
                else:
                    gt_list.append(-1)
            ind_gl_cols.append(None)
            ind_gt_idx.append(np.asarray(gt_list, dtype=np.int64))
    for t in range(T):
        for ind in range(n_ind):
            part0 = h2p[t, ind, 0]
            part1 = h2p[t, ind, 1]
            a0 = (assign_idx >> part0) & 1  # (nA,)
            a1 = (assign_idx >> part1) & 1
            gt_of_assign = a0 + a1  # canonical diploid biallelic index
            if distrust_genotypes:
                acost[:, t, :] += ind_gl_cols[ind][:, gt_of_assign]
            else:
                ok = gt_of_assign[None, :] == ind_gt_idx[ind][:, None]  # (C, nA)
                acost[:, t, :] += np.where(ok, 0, np.int64(INF) * 4)
    acost = np.minimum(acost, INF).astype(np.int32)

    if C > 0 and check_conflicts:
        # Mendelian conflict check: a column where no (t, assignment) is
        # compatible (pedigreedptable.cpp:301-303)
        if bool(np.any(np.all(acost >= INF, axis=(1, 2)))):
            raise MendelianConflictError()

    rc = np.asarray(list(recombcost), dtype=np.int32)
    if C > 0 and len(rc) < C:
        # The reference indexes recombcost[column] without a bounds check
        # (pedigreedptable.cpp:287): reading past the end is UB there.  We
        # instead pad with a prohibitive cost, which keeps the transmission
        # vector constant across the unspecified tail — the behavior the
        # reference tests rely on.
        rc = np.concatenate([rc, np.full(C - len(rc), INF, dtype=np.int32)])

    return PackedProblem(
        n_cols=C,
        K=K,
        T=T,
        P=P,
        n_reads=n_reads,
        positions=np.asarray(cols, dtype=np.int64),
        active=active,
        slot_read=slot_read,
        allele=allele,
        weight=weight,
        rank=rank,
        die_prev=die_prev,
        rc=rc[:C] if C > 0 else rc,
        wdiff=wdiff.astype(np.int32),
        wbase=wbase.astype(np.int32),
        acost=acost,
        read_slot=read_slot,
        read_first_col=first_col,
        h2p=h2p,
        read_source=read_source,
        t_sym_masks=tuple(t_sym_masks),
    )


# ---------------------------------------------------------------------------
# Plain torch mirror of the device DP (any T)
# ---------------------------------------------------------------------------


def _assign_bits(P: int) -> np.ndarray:
    idx = np.arange(1 << P, dtype=np.uint32)
    return ((idx[:, None] >> np.arange(P)[None, :]) & 1).astype(np.int32)


def _popcount_matrix(T: int) -> np.ndarray:
    i = np.arange(T)
    x = i[:, None] ^ i[None, :]
    pc = np.zeros_like(x)
    while np.any(x):
        pc += x & 1
        x >>= 1
    return pc.astype(np.int32)


def _inverse_gray(n: torch.Tensor, K: int) -> torch.Tensor:
    """Inverse Gray code (rank of bipartition in Gray iteration order)."""
    shift = 1
    while shift < max(K, 1):
        n = n ^ (n >> shift)
        shift <<= 1
    return n


def _fold_dying(K: int, T: int, die_c, cost, key_vec, jmin=None, bits=None):
    """Fold dying bits of a batched (B, S, T) dp state (forward projection,
    pedigreedptable.cpp:316-326) with Gray-order tie-breaking.

    die_c (B, K) bool holds the dying slots of each block; key_vec (B, S) is
    the tie-break key of the folded column; jmin (B, S, T) the transmission
    argmin, or None where it is identically zero (T == 1).  `bits` lists the
    slot bits to visit (default: all K); a bit that no block folds is an
    identity and may be left out.  Returns (cost, key, idx, jmin), each
    (B, S, T): per surviving row, the winning value / key / source
    bipartition index / source transmission argmin.  Both partners of a
    folded pair receive the winner, so the state becomes constant along the
    dying bit.
    """
    B, S = cost.shape[0], 1 << K
    key = key_vec[:, :, None].expand(B, S, T)
    idx = torch.arange(S, dtype=torch.int32, device=cost.device)[None, :, None].expand(B, S, T)
    for p in range(K) if bits is None else bits:
        # view (B, hi_dims, 2, lo_dims, T) over bit p
        view = (B, S >> (p + 1), 2, 1 << p, T)
        c_v, k_v, i_v = cost.reshape(view), key.reshape(view), idx.reshape(view)
        a_c, b_c = c_v[:, :, 0], c_v[:, :, 1]
        a_k, b_k = k_v[:, :, 0], k_v[:, :, 1]
        take_b = (b_c < a_c) | ((b_c == a_c) & (b_k < a_k))
        die = die_c[:, p].view(B, 1, 1, 1, 1)

        def both(pair):
            w = torch.where(take_b, pair[:, :, 1], pair[:, :, 0])
            return torch.where(die, w.unsqueeze(2).expand(view), pair).reshape(B, S, T)

        cost, key, idx = both(c_v), both(k_v), both(i_v)
        if jmin is not None:
            jmin = both(jmin.reshape(view))
    return cost, key, idx, jmin


def _col_cost(bits, abits, wdiff_c, wbase_c, acost_c, T: int, P: int):
    """Column cost of every bipartition, min over the 2^P allele assignments:
    (B, S, T) int32.  f = bits @ wdiff is taken in float64, which is exact for
    the integer weights (the reference's f32 is exact below 2^24)."""
    B, S = wdiff_c.shape[0], bits.shape[0]
    f = torch.matmul(bits, wdiff_c)  # (B, S, T*P*2)
    cp = f.to(torch.int32).reshape(B, S, T, P, 2) + wbase_c[:, None]
    s0 = cp[..., 0].sum(dim=-1, dtype=torch.int32)  # (B, S, T)
    d = cp[..., 1] - cp[..., 0]  # (B, S, T, P)
    # per-assignment partition cost, exact int32 (P is tiny: unrolled)
    pa = torch.zeros((B, S, T, 1 << P), dtype=torch.int32, device=bits.device)
    for p in range(P):
        pa = pa + torch.where(abits[:, p] == 1, d[..., p : p + 1], 0)
    total = torch.clamp(s0[..., None] + pa + acost_c[:, None], max=INF)
    return total.amin(dim=-1)


def forward_scan(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc):
    """Plain torch mirror of the reference's _forward_scan_impl, with a
    leading block axis written out.

    Inputs are the stacked block tensors of parallel.blocks (one device):
    wdiff (B, C, K, T*P*2) f32, wbase (B, C, T, P, 2) i32, rankw (B, C, K)
    f32, acost (B, C, T, 2^P) i32, die_prev (B, C, K) bool, rc (B, C) i32.
    Returns dp_last (B, S, T), jmin_last (B, S, T), key_last (B, S),
    proj_idx (B, C, S, T) and proj_jmin (B, C, S, T); proj_jmin is None for
    T == 1, where it is identically zero.  All int32.
    """
    B, C = wdiff.shape[0], wdiff.shape[1]
    S = 1 << K
    dev = wdiff.device
    idx = torch.arange(S, dtype=torch.int64, device=dev)
    bits = ((idx[:, None] >> torch.arange(K, device=dev)[None, :]) & 1).to(torch.float64)
    abits = torch.as_tensor(_assign_bits(P), device=dev)
    pcmat_np = _popcount_matrix(T)
    max_pc = max(int(pcmat_np.max()), 1)
    # clamp rc so pcmat * rc cannot overflow int32 (pcmat max is static)
    rc_safe = torch.clamp(rc, max=INF // max_pc)
    recomb = torch.clamp(
        torch.as_tensor(pcmat_np, device=dev)[None, None] * rc_safe[:, :, None, None], max=INF
    )  # (B, C, T, T)
    wdiff64 = wdiff.to(torch.float64)
    rankw64 = rankw.to(torch.float64)
    # slots that die before each column in at least one block: folding any
    # other bit is an identity, so the Python loop skips it
    die_any = die_prev.any(dim=0).cpu().numpy()

    dp = torch.zeros((B, S, T), dtype=torch.int32, device=dev)
    jmin = torch.zeros_like(dp) if T > 1 else None
    key = torch.zeros((B, S), dtype=torch.int32, device=dev)
    proj_idx = torch.empty((B, C, S, T), dtype=torch.int32, device=dev)
    proj_jmin = torch.empty_like(proj_idx) if T > 1 else None
    for c in range(C):
        # ---- fold dying bits of the previous column (forward projection)
        proj_cost, _key, p_idx, p_jmin = _fold_dying(
            K, T, die_prev[:, c], dp, key, jmin, np.nonzero(die_any[c])[0].tolist()
        )
        proj_idx[:, c] = p_idx
        if proj_jmin is not None:
            proj_jmin[:, c] = p_jmin

        # ---- transmission min-plus (pedigreedptable.cpp:262-300); the
        # argmin keeps the first strict minimum over tj
        trans_term = torch.clamp(proj_cost[:, :, None, :] + recomb[:, c, None], max=INF)
        trans_min = trans_term[..., 0]
        jmin_new = torch.zeros_like(trans_min)
        for tj in range(1, T):
            take = trans_term[..., tj] < trans_min
            trans_min = torch.where(take, trans_term[..., tj], trans_min)
            jmin_new = torch.where(take, tj, jmin_new)

        # ---- current column cost over all bipartitions
        cc = _col_cost(bits, abits, wdiff64[:, c], wbase[:, c], acost[:, c], T, P)
        dp = torch.clamp(cc + trans_min, max=INF)
        if jmin is not None:
            jmin = jmin_new

        # ---- tie-break key for this column
        r = torch.matmul(bits, rankw64[:, c, :, None])[..., 0]
        key = _inverse_gray(r.to(torch.int32), K)

    jmin_last = jmin if jmin is not None else torch.zeros_like(dp)
    return dp, jmin_last, key, proj_idx, proj_jmin


def _backtrace_from(start_idx, start_trans, prev_trans, proj_idx, proj_jmin):
    """Walk the projection tables backwards from the last-column states
    (start_idx, start_trans) (B,) whose preceding transmission is prev_trans.
    Returns (index_path (B, C), trans_path (B, C), seam_prev (B,)), where
    seam_prev is the transmission value of the column BEFORE the first one.
    proj_jmin None stands for an all-zero table (T == 1)."""
    B, C = proj_idx.shape[0], proj_idx.shape[1]
    rows = torch.arange(B, device=proj_idx.device)
    index_path = torch.empty((B, C), dtype=torch.int32, device=proj_idx.device)
    trans_path = torch.empty_like(index_path)
    v, vt, pt = start_idx.long(), start_trans.long(), prev_trans.long()
    index_path[:, C - 1] = v
    trans_path[:, C - 1] = vt
    for c in range(C - 1, 0, -1):
        # backtrace tables of column c-1 were emitted at scan step c
        v = proj_idx[rows, c, v, pt].long()
        vt = pt
        pt = proj_jmin[rows, c, v, vt].long() if proj_jmin is not None else pt
        index_path[:, c - 1] = v
        trans_path[:, c - 1] = vt
    return index_path, trans_path, pt.to(torch.int32)


def _backtrace_impl(K, T, dp_last, jmin_last, key_last, proj_idx, proj_jmin):
    """Pick the reference's optimum per block (min cost, then min Gray key,
    then min transmission, then min index) and walk the tables back.
    Returns (costs (B,), index_path (B, C), trans_path (B, C), seam (B,))."""
    B = dp_last.shape[0]
    m, opt_trans, opt_idx = wmec_cuda._select_optimum(K, T, dp_last.transpose(1, 2), key_last)
    rows = torch.arange(B, device=dp_last.device)
    prev_trans = jmin_last[rows, opt_idx.long(), opt_trans.long()]
    index_path, trans_path, seam = _backtrace_from(
        opt_idx, opt_trans, prev_trans, proj_idx, proj_jmin
    )
    return m, index_path, trans_path, seam


def solve_batched(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc):
    """Batched end-to-end solve on the torch mirror (leading block axis):
    forward scan plus backtrace per block.  Returns (costs (B,), index paths
    (B, C), transmission paths (B, C)), int32, as the reference's
    solve_batched."""
    dp_last, jmin_last, key_last, proj_idx, proj_jmin = forward_scan(
        K, T, P, wdiff, wbase, rankw, acost, die_prev, rc
    )
    return _backtrace_impl(K, T, dp_last, jmin_last, key_last, proj_idx, proj_jmin)[:3]


# ---------------------------------------------------------------------------
# Route
# ---------------------------------------------------------------------------

#: Share of the device's free memory that one batched launch may fill with
#: backtrace tables and kernel scratch; batches beyond it are split into
#: sequential chunks.
TABLE_BUDGET_FRACTION = 0.5


def _table_budget(device: torch.device) -> Optional[int]:
    """Bytes one launch may hold in tables, or None for no limit (the
    CPU)."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        # memory the caching allocator holds but does not use is free too
        cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        return int((free + cached) * TABLE_BUDGET_FRACTION)
    return None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for, by name or by default, and none
    is available: the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "whatshap_torch runs on a CUDA device by default, and none is "
            "available; pass device='cpu' to run the plain torch path"
        )
    return dev


def _unsupported(K: int, T: int, P: int) -> NotImplementedError:
    if T != 1 or P != 2:
        what = "pedigree instances (T > 1 or P != 2) need the pedigree route, ROADMAP Queue 1 item 4"
    else:
        what = (
            f"K > {wmec_cuda.MAX_K} or tables beyond the memory budget need the "
            "segmented solve, ROADMAP Queue 1 item 5"
        )
    return NotImplementedError(f"no CUDA kernel for K={K}, T={T}, P={P} yet: {what}")


def _launch_batched(solve, K, T, P, arrays, per_block_bytes: int):
    """One batched solve, split along the block axis into sequential chunks
    so that one chunk's tables and scratch stay under the table budget."""
    B = arrays[0].shape[0]
    budget = _table_budget(arrays[0].device)
    if budget is None or B * per_block_bytes <= budget:
        return solve(K, T, P, *arrays)
    max_b = budget // per_block_bytes
    if max_b < 1:
        raise _unsupported(K, T, P)
    parts = [solve(K, T, P, *(a[i : i + max_b] for a in arrays)) for i in range(0, B, max_b)]
    return tuple(torch.cat(xs) for xs in zip(*parts))


def solve_batched_auto(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc):
    """Batched solve of stacked blocks on the device they lie on.

    Shapes the kernels take (wmec_cuda.kernel_supported) go through
    wmec_cuda.solve_batched_cuda: its kernels on a CUDA device, their plain
    versions on the CPU.  Other shapes run the torch mirror on the CPU and
    raise NotImplementedError on CUDA."""
    dev = wdiff.device
    supported = wmec_cuda.kernel_supported(K, T, P)
    if supported:
        solve = wmec_cuda.solve_batched_cuda
    elif dev.type == "cpu":
        solve = solve_batched
    else:
        raise _unsupported(K, T, P)
    C = wdiff.shape[1]
    per_block = C * T * (1 << K) * 4 * (2 if T > 1 else 1)  # index (+ trans) tables
    if solve is wmec_cuda.solve_batched_cuda:
        per_block += wmec_cuda.state_bytes(K)
    return _launch_batched(
        solve, K, T, P, (wdiff, wbase, rankw, acost, die_prev, rc), per_block
    )


@dataclass
class DPResult:
    optimal_cost: int
    index_path: np.ndarray  # (C,) slot-space bipartition index per column
    trans_path: np.ndarray  # (C,) transmission value per column


def _next_pow2(n: int, lo: int = 8) -> int:
    v = lo
    while v < n:
        v <<= 1
    return v


def connected_column_ranges(packed: PackedProblem) -> List[Tuple[int, int]]:
    """Split the column axis into maximal ranges not crossed by any read.

    A new range starts at column c when no slot is occupied by the same
    read in both c-1 and c (i.e. every occupant either died or the slot was
    re-assigned).  Within the DP, such boundaries fold the whole state away,
    so the ranges are independent subproblems — for T == 1 exactly (there is
    no transmission state to couple them).
    """
    C = packed.n_cols
    if C <= 1:
        return [(0, C)] if C else []
    crossing = (
        packed.active[:-1] & packed.active[1:] & ~packed.die_prev[1:]
    ).any(axis=1)
    starts = [0] + list(np.nonzero(~crossing)[0] + 1)
    return list(zip(starts, starts[1:] + [C]))


def _slice_ranges(packed: PackedProblem, ranges):
    """Slice each read-connected column range out of a packed problem as an
    independent padded block with its own launch-bucket shape.

    c_pad is the range length rounded up to a power of two (at least 64);
    k_b is the range's highest active slot + 1.  The greedy lowest-free-slot
    assignment keeps a range's occupied slots dense at the bottom, so each
    range gets its own 2^k state space: one high-coverage range must not
    make every sparse range pay its exponent.  K stays exact (the kernels
    have no lane minimum, and buckets are not merged across K).

    die_prev of a block's first column may keep stale True flags; folding a
    fresh uniform state is a no-op, so they are harmless.

    Yields (c_pad, k_b, PaddedArrays) in range order.
    """
    from ..parallel.blocks import PaddedArrays

    C, K, T, P = packed.n_cols, packed.K, packed.T, packed.P
    rankw_full = np.where(
        packed.rank >= 0, (1 << np.maximum(packed.rank, 0).astype(np.int64)), 0
    ).astype(np.float32)
    wdiff_full = packed.wdiff.reshape(C, K, T * P * 2).astype(np.float32)

    for a, b in ranges:
        n = b - a
        c_pad = _next_pow2(n, lo=64)
        act = np.nonzero(packed.active[a:b].any(axis=0))[0]
        k_b = int(act[-1]) + 1 if act.size else 1
        arrs = PaddedArrays(
            wdiff=np.zeros((c_pad, k_b, T * P * 2), dtype=np.float32),
            wbase=np.zeros((c_pad, T, P, 2), dtype=np.int32),
            rankw=np.zeros((c_pad, k_b), dtype=np.float32),
            acost=np.zeros((c_pad, T, 1 << P), dtype=np.int32),
            die_prev=np.zeros((c_pad, k_b), dtype=bool),
            rc=np.full(c_pad, INF, dtype=np.int32),
            n_cols=n,
        )
        arrs.wdiff[:n] = wdiff_full[a:b, :k_b]
        arrs.wbase[:n] = packed.wbase[a:b]
        arrs.rankw[:n] = rankw_full[a:b, :k_b]
        arrs.acost[:n] = packed.acost[a:b]
        arrs.die_prev[:n] = packed.die_prev[a:b, :k_b]
        arrs.rc[:n] = packed.rc[a:b]
        if c_pad > n:
            arrs.rankw[n:] = rankw_full[b - 1, :k_b]
        yield c_pad, k_b, arrs


def run_dp_batched(
    packed: PackedProblem, device: torch.device, solve=solve_batched_auto
) -> Optional[DPResult]:
    """Solve a single-sample (T == 1) instance by splitting it into
    read-connected blocks, bucketing the blocks by padded (C, K) and solving
    each bucket as one batched launch (`solve`, solve_batched_auto unless the
    caller hands in another function of the same signature).

    Each bucket reaches the device in one host-to-device copy
    (blocks.to_device); every bucket is launched before anything is fetched,
    and the costs and index paths of all buckets come back in one
    device-to-host copy.  Costs, partitionings and superreads are identical
    to the monolithic solve.

    Returns None when the instance has transmission state (T > 1) or only
    one block: callers solve it as one block.
    """
    from ..parallel.blocks import stack_blocks, to_device

    C, T, P = packed.n_cols, packed.T, packed.P
    if C == 0 or T != 1:
        return None
    ranges = connected_column_ranges(packed)
    if len(ranges) <= 1:
        return None

    buckets: dict = {}  # (c_pad, k_b) -> list of (range_index, PaddedArrays)
    for ri, (c_pad, k_b, arrs) in enumerate(_slice_ranges(packed, ranges)):
        buckets.setdefault((c_pad, k_b), []).append((ri, arrs))
    stacked = {key: stack_blocks([arrs for _, arrs in m]) for key, m in buckets.items()}

    pending = []
    for (c_pad, k_b), members in buckets.items():
        arrays = to_device(stacked[(c_pad, k_b)], device)
        costs, index_paths, _trans = solve(k_b, T, P, *arrays)
        pending.append((members, c_pad, costs, index_paths))

    # one fetch for every bucket: costs first, then the index paths
    flat = torch.cat(
        [x.reshape(-1) for _m, _c, costs, ip in pending for x in (costs, ip)]
    ).cpu().numpy()

    total_cost = 0
    index_path = np.zeros(C, dtype=np.int64)
    off = 0
    for members, c_pad, _costs, _ip in pending:
        nb = len(members)
        costs = flat[off : off + nb]
        paths = flat[off + nb : off + nb + nb * c_pad].reshape(nb, c_pad)
        off += nb + nb * c_pad
        for bi, (ri, _arrs) in enumerate(members):
            a, b = ranges[ri]
            total_cost += int(costs[bi])
            index_path[a:b] = paths[bi, : b - a]
    return DPResult(total_cost, index_path, np.zeros(C, dtype=np.int64))


def run_dp(packed: PackedProblem, device=None, solve=solve_batched_auto) -> Optional[DPResult]:
    """Run the forward scan + backtrace on `device` (default "cuda", see
    resolve_device).  Returns None for empty problems.

    A single-sample instance that splits into several read-connected ranges
    takes the batched route (run_dp_batched).  A single range, or a
    pedigree, is solved as one block (B = 1) padded to a power-of-two column
    count.  On a CUDA device every instance runs in the kernels of
    wmec_cuda, and one that they cannot take raises NotImplementedError.
    `solve` (solve_batched_auto's signature) solves each stack of blocks; a
    check can hand in the torch mirror to run the same route without the
    kernels.
    """
    from ..parallel.blocks import pad_block, stack_blocks, to_device

    device = resolve_device(device)
    C, K, T, P = packed.n_cols, packed.K, packed.T, packed.P
    if C == 0:
        return None
    result = run_dp_batched(packed, device, solve)
    if result is not None:
        return result

    c_pad = _next_pow2(C)
    arrays = to_device(stack_blocks([pad_block(packed, c_pad)]), device)
    costs, index_paths, trans_paths = solve(K, T, P, *arrays)
    flat = torch.cat([costs, index_paths[0], trans_paths[0]]).cpu().numpy().astype(np.int64)
    return DPResult(int(flat[0]), flat[1 : 1 + C], flat[1 + c_pad : 1 + c_pad + C])


# ---------------------------------------------------------------------------
# Output extraction (host, numpy)
# ---------------------------------------------------------------------------


def extract_partitioning(packed: PackedProblem, result: Optional[DPResult]) -> List[int]:
    """Per-read partition (0 or 1).

    The C++ marks reads with bit==0 as ``true`` (pedigreedptable.cpp:391-406)
    and the Cython wrapper inverts that back (core.pyx:410-416:
    ``0 if x else 1``), so the exposed value equals the bipartition bit; reads
    never active in any column default to 1.
    """
    out = [1] * packed.n_reads
    if result is None:
        return out
    for r in range(packed.n_reads):
        s = packed.read_slot[r]
        c = packed.read_first_col[r]
        if s < 0 or c < 0:
            continue
        out[r] = (int(result.index_path[c]) >> int(s)) & 1
    return out


def extract_alleles(
    packed: PackedProblem, result: DPResult, pedigree: Pedigree
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-column, per-individual optimal alleles + qualities.

    Replicates PedigreeColumnCostComputer::get_alleles
    (pedigreecolumncostcomputer.cpp:117-175) at the traced-back optimum,
    including its exact tie handling: the LAST assignment attaining the
    minimum cost wins (``cost <= best_cost``), the reported quality is the
    gap for haplotype 1, and an allele becomes EQUAL_SCORES (3) when its
    haplotype's two allele costs tie.

    Returns (allele0, allele1, quality) of shape (C, n_individuals).
    """
    C, K, T, P = packed.n_cols, packed.K, packed.T, packed.P
    n_ind = len(pedigree)
    nA = 1 << P

    b = (
        (result.index_path[:, None] >> np.arange(K)[None, :]) & 1
    ).astype(np.int64)  # (C, K)
    t_sel = result.trans_path  # (C,)
    # cost_partition[c, p, a] at the optimum
    wdiff_sel = packed.wdiff[np.arange(C), :, t_sel]  # (C, K, P, 2)
    wbase_sel = packed.wbase[np.arange(C), t_sel]  # (C, P, 2)
    cp = wbase_sel + np.einsum("ck,ckpa->cpa", b, wdiff_sel.astype(np.int64))

    assign_idx = np.arange(nA)
    abits = ((assign_idx[:, None] >> np.arange(P)[None, :]) & 1).astype(np.int64)
    acost_sel = packed.acost[np.arange(C), t_sel].astype(np.int64)  # (C, nA)
    # total[c, a] = acost + sum_p cp[c, p, bit_p(a)]
    cp0 = cp[:, :, 0]  # (C, P)
    cp1 = cp[:, :, 1]
    total = (
        acost_sel
        + cp0.sum(axis=1)[:, None]
        + (cp1 - cp0) @ abits.T  # (C, nA)
    )
    total = np.minimum(total, INF)

    compatible = acost_sel < INF  # (C, nA)
    total_masked = np.where(compatible, total, np.int64(1) << 60)
    best_cost = total_masked.min(axis=1)  # (C,)
    if np.any(best_cost >= INF):
        raise MendelianConflictError()
    # last argmin among compatible assignments ("cost <= best_cost")
    is_best = total_masked == best_cost[:, None]
    last_best = nA - 1 - np.argmax(is_best[:, ::-1], axis=1)  # (C,)

    allele0 = np.zeros((C, n_ind), dtype=np.int64)
    allele1 = np.zeros((C, n_ind), dtype=np.int64)
    quality = np.zeros((C, n_ind), dtype=np.int64)
    for ind in range(n_ind):
        part0 = packed.h2p[t_sel, ind, 0]  # (C,)
        part1 = packed.h2p[t_sel, ind, 1]
        a0_of_assign = (assign_idx[None, :] >> part0[:, None]) & 1  # (C, nA)
        a1_of_assign = (assign_idx[None, :] >> part1[:, None]) & 1
        a0 = a0_of_assign[np.arange(C), last_best]
        a1 = a1_of_assign[np.arange(C), last_best]
        # best cost for forcing each haplotype to each allele
        big = np.int64(1) << 60
        bc = np.where(compatible, total, big)
        bcfa00 = np.where(a0_of_assign == 0, bc, big).min(axis=1)
        bcfa01 = np.where(a0_of_assign == 1, bc, big).min(axis=1)
        bcfa10 = np.where(a1_of_assign == 0, bc, big).min(axis=1)
        bcfa11 = np.where(a1_of_assign == 1, bc, big).min(axis=1)
        q0 = np.abs(bcfa00 - bcfa01)
        q1 = np.abs(bcfa10 - bcfa11)
        # reference quirk: quality is overwritten by the haplotype-1 value
        quality[:, ind] = q1
        allele0[:, ind] = np.where(q0 == 0, 3, a0)
        allele1[:, ind] = np.where(q1 == 0, 3, a1)
    return allele0, allele1, quality
