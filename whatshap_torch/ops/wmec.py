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
- the plain torch mirror (forward_scan, solve_batched, forward_m_batched,
  solve_seeded_batched) for any T, with the
  column loop in Python: the CPU path, and the yardstick that the CUDA
  kernels are held against;
- the route (run_dp, run_dp_batched, run_dp_batched_pedigree and the
  *_auto solvers): on a CUDA device every instance goes to the hand-written
  kernels of wmec_cuda, and what they cannot take raises
  NotImplementedError instead of leaving the card.
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


def _popcount_matrix(T: int) -> np.ndarray:
    i = np.arange(T)
    x = i[:, None] ^ i[None, :]
    pc = np.zeros_like(x)
    while np.any(x):
        pc += x & 1
        x >>= 1
    return pc.astype(np.int32)


#: Most int32 entries of the (scans, states, T, T) min-plus term that
#: forward_scan holds at once: it takes the min-plus of a column in chunks of
#: scans, or of one scan's states, under this (64 MiB of terms on the CPU,
#: 512 MiB on a card, where fewer larger chunks run faster), so that its
#: memory stays bounded at any T (a state's term is 4 MiB at T = 1024).
MINPLUS_CHUNK = 1 << 24
MINPLUS_CHUNK_CUDA = 1 << 27


def _minplus(cost, pcmat, rc_c, R: int, want_jmin: bool = True):
    """The transmission min-plus of one column (pedigreedptable.cpp:262-300)
    over the scans' folded costs cost (B*R, S, T), scan b*R + r taking block
    b's recombination cost rc_c[b] (rc_c (B,) int32, clamped so that pcmat *
    rc_c fits int32): trans_min[.., ti] = min over tj of min(cost[.., tj] +
    pcmat[ti, tj] * rc_c, INF), and jmin the first tj reaching it (torch.min's
    index is the first one, as the reference's jnp.argmin).  The term is
    taken in chunks of at most MINPLUS_CHUNK entries (MINPLUS_CHUNK_CUDA on
    a card; of whole scans, or of one scan's states where a scan alone
    passes it): the same elementwise sums and minima, so the same results,
    in bounded memory.  Returns (trans_min, jmin), int32 (B*R, S, T).

    Without want_jmin (the m-only mode keeps no argmin) the minimum is taken
    as a distance transform over the bits of t instead: log2 T passes of
    v[t] = min(v[t], v[t ^ bit] + rc), then the clamp at INF.  pcmat * rc is
    the shortest path over the hypercube of t with edges of rc, and no sum
    passes 2 * INF, so the minimum is the T x T one exactly, at T log2 T
    work (the seam pass's 256 coset seeds at T = 1024 on the plain route);
    jmin is None."""
    BR, S, T = cost.shape
    if not want_jmin:
        rc_rows = rc_c.repeat_interleave(BR // rc_c.shape[0])[:, None, None]
        v, bit = cost, 1
        while bit < T:
            partner = v.reshape(BR, S, T // (2 * bit), 2, bit).flip(3).reshape(BR, S, T)
            v = torch.minimum(v, partner + rc_rows)
            bit <<= 1
        return torch.clamp(v, max=INF), None
    limit = MINPLUS_CHUNK if cost.device.type == "cpu" else MINPLUS_CHUNK_CUDA
    recomb = torch.clamp(pcmat[None] * rc_c[:, None, None], max=INF)  # (B, T, T)
    trans_min = torch.empty_like(cost)
    jmin = torch.empty_like(cost)
    scan_terms = S * T * T
    rows = max(1, limit // scan_terms)
    states = S if rows > 1 or scan_terms <= limit else max(1, limit // (T * T))
    for r0 in range(0, BR, rows):
        r1 = min(BR, r0 + rows)
        rec = recomb[torch.arange(r0, r1, device=cost.device) // R]
        for s0 in range(0, S, states):
            s1 = min(S, s0 + states)
            mn, am = (cost[r0:r1, s0:s1, None, :] + rec[:, None]).clamp_(max=INF).min(dim=-1)
            trans_min[r0:r1, s0:s1] = mn
            jmin[r0:r1, s0:s1] = am.to(torch.int32)
    return trans_min, jmin


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


def _col_cost(bits, wdiff_c, wbase_c, acost_c, T: int, P: int):
    """Column cost of every bipartition, min over the 2^P allele assignments:
    (B, S, T) int32.  f = bits @ wdiff is taken in float64, which is exact for
    the integer weights (the reference's f32 is exact below 2^24)."""
    B, S = wdiff_c.shape[0], bits.shape[0]
    f = torch.matmul(bits, wdiff_c)  # (B, S, T*P*2)
    cp = f.to(torch.int32).reshape(B, S, T, P, 2) + wbase_c[:, None]
    s0 = cp[..., 0].sum(dim=-1, dtype=torch.int32)  # (B, S, T)
    d = cp[..., 1] - cp[..., 0]  # (B, S, T, P)
    # min over the assignments x of pa[x] + acost[x], pa[x] the sum of d[p]
    # over the bits p of x (exact int32), the x in Gray order so that each
    # pa takes one add; min(s0 + pa + acost, INF) is min(s0 + its minimum, INF)
    ac = acost_c[:, None]  # (B, 1, T, 2^P)
    pa = torch.zeros_like(s0)
    best = ac[..., 0] + pa
    for g in range(1, 1 << P):
        p, x = (g & -g).bit_length() - 1, g ^ (g >> 1)
        pa = pa + d[..., p] if (x >> p) & 1 else pa - d[..., p]
        best = torch.minimum(best, pa + ac[..., x])
    return torch.clamp(s0 + best, max=INF)


def forward_scan(
    K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0=None, carry0=None, mode="tables"
):
    """Plain torch mirror of the reference's _forward_scan_impl, with a
    leading block axis written out.

    Inputs are the stacked block tensors of parallel.blocks (one device):
    wdiff (B, C, K, T*P*2) f32, wbase (B, C, T, P, 2) i32, rankw (B, C, K)
    f32, acost (B, C, T, 2^P) i32, die_prev (B, C, K) bool, rc (B, C) i32.
    Returns dp_last (B, S, T), jmin_last (B, S, T), key_last (B, S),
    proj_idx (B, C, T, S) and proj_jmin (B, C, T, S); proj_jmin is None for
    T == 1, where it is identically zero.  All int32.  The tables keep the
    CUDA kernels' layout, (column, transmission, bipartition); the
    reference's is (column, bipartition, transmission).

    The state starts at zero, or as one of:
    - dp0 (B, T) i32, the seed of the reference's _seeded_carry: the cost is
      dp0 broadcast over the bipartitions, jmin and key start at zero;
    - carry0 = (dp (B, S, T), jmin (B, S, T), key (B, S)), the state after
      a preceding segment's last column (the reference's carry0); at T == 1
      jmin is not read and may be None.
    The two are exclusive.  `mode` picks what is kept:
    - "tables": the full state and the tables;
    - "carry": the full state (cost, jmin and tie key) without tables, both
      table outputs None: the checkpoint pass of the segmented solve;
    - "m": the m-only mode of the seam pass: no tables, and neither the tie
      key nor jmin is tracked (key_last and jmin_last come back zero); fold
      winners have equal cost, so dp_last is the same.  Here dp0 may also be
      (B, R, T): R scans a block, rows b * R + r of dp_last (B * R, S, T),
      sharing the block's column cost.
    """
    if dp0 is not None and carry0 is not None:
        raise ValueError("forward_scan: a seed (dp0) and a carry (carry0) are exclusive")
    if mode not in ("tables", "carry", "m"):
        raise ValueError(f"forward_scan: unknown mode {mode!r}")
    track, emit_tables = mode != "m", mode == "tables"
    B, C = wdiff.shape[0], wdiff.shape[1]
    S = 1 << K
    dev = wdiff.device
    idx = torch.arange(S, dtype=torch.int64, device=dev)
    bits = ((idx[:, None] >> torch.arange(K, device=dev)[None, :]) & 1).to(torch.float64)
    pcmat_np = _popcount_matrix(T)
    max_pc = max(int(pcmat_np.max()), 1)
    pcmat = torch.as_tensor(pcmat_np, device=dev)
    # clamp rc so pcmat * rc cannot overflow int32 (pcmat max is static)
    rc_safe = torch.clamp(rc, max=INF // max_pc)
    wdiff64 = wdiff.to(torch.float64)
    rankw64 = rankw.to(torch.float64)
    # slots that die before each column in at least one block: folding any
    # other bit is an identity, so the Python loop skips it
    die_any = die_prev.any(dim=0).cpu().numpy()
    R = 1
    if dp0 is not None and dp0.dim() == 3:
        if track:
            raise ValueError("forward_scan: R seeds a block (dp0 (B, R, T)) only in the m-only mode")
        # each scan takes its block's fold and recombination; the column cost
        # is the block's
        R = dp0.shape[1]
        die_prev = die_prev.repeat_interleave(R, dim=0)
        dp0 = dp0.reshape(B * R, T)

    jmin = None
    if carry0 is not None:
        dp = carry0[0].to(torch.int32).contiguous()
        if T > 1 and track:
            jmin = carry0[1].to(torch.int32)
        key = carry0[2].to(torch.int32)
    else:
        if dp0 is None:
            dp = torch.zeros((B, S, T), dtype=torch.int32, device=dev)
        else:
            dp = dp0.to(torch.int32)[:, None, :].expand(B * R, S, T).contiguous()
        if T > 1 and track:
            jmin = torch.zeros_like(dp)
        key = torch.zeros((B * R, S), dtype=torch.int32, device=dev)
    proj_idx = proj_jmin = None
    if emit_tables:
        proj_idx = torch.empty((B, C, T, S), dtype=torch.int32, device=dev)
        proj_jmin = torch.empty_like(proj_idx) if T > 1 else None
    for c in range(C):
        # ---- fold dying bits of the previous column (forward projection)
        proj_cost, _key, p_idx, p_jmin = _fold_dying(
            K, T, die_prev[:, c], dp, key, jmin, np.nonzero(die_any[c])[0].tolist()
        )
        if proj_idx is not None:
            proj_idx[:, c] = p_idx.transpose(1, 2)
        if proj_jmin is not None:
            proj_jmin[:, c] = p_jmin.transpose(1, 2)

        # ---- transmission min-plus, in chunks of bounded memory
        trans_min, jmin_new = _minplus(proj_cost, pcmat, rc_safe[:, c], R, track)

        # ---- current column cost over all bipartitions
        cc = _col_cost(bits, wdiff64[:, c], wbase[:, c], acost[:, c], T, P)
        dp = torch.clamp((cc if R == 1 else cc.repeat_interleave(R, dim=0)) + trans_min, max=INF)
        if jmin is not None:
            jmin = jmin_new

        # ---- tie-break key for this column (the m-only mode keeps none)
        if track:
            r = torch.matmul(bits, rankw64[:, c, :, None])[..., 0]
            key = _inverse_gray(r.to(torch.int32), K)

    jmin_last = jmin if jmin is not None else torch.zeros_like(dp)
    return dp, jmin_last, key, proj_idx, proj_jmin


def _backtrace_from(start_idx, start_trans, prev_trans, proj_idx, proj_jmin, block=None):
    """Walk the projection tables (B, C, T, S) backwards from the last-column
    states (start_idx, start_trans) (W,) whose preceding transmission is
    prev_trans; walk w reads the tables of block block[w] (default: w).
    Returns (index_path (W, C), trans_path (W, C), seam_prev (W,)), where
    seam_prev is the transmission value of the column BEFORE the first one.
    proj_jmin None stands for an all-zero table (T == 1)."""
    W, C = start_idx.shape[0], proj_idx.shape[1]
    dev = proj_idx.device
    rows = torch.arange(W, device=dev) if block is None else block
    index_path = torch.empty((W, C), dtype=torch.int32, device=dev)
    trans_path = torch.empty_like(index_path)
    v, vt, pt = start_idx.long(), start_trans.long(), prev_trans.long()
    index_path[:, C - 1] = v
    trans_path[:, C - 1] = vt
    for c in range(C - 1, 0, -1):
        # backtrace tables of column c-1 were emitted at scan step c
        v = proj_idx[rows, c, pt, v].long()
        vt = pt
        pt = proj_jmin[rows, c, vt, v].long() if proj_jmin is not None else pt
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


def forward_m_batched(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0):
    """Seeded forward scan, folded final cost only (the reference's
    forward_m_batched): per block, m (T,) = min over bipartitions of the
    final dp of a scan started from dp0 (B, T).  With a unit seed this is
    one row of the block's T x T seam matrix.  Returns m (B, T) int32.
    Seeds (B, R, T) run R scans a block over the block's inputs (the
    reference's route repeats the block once per seed; the scans here share
    its column cost) and return m (B, R, T)."""
    dp_last = forward_scan(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0=dp0, mode="m")[0]
    return dp_last.amin(dim=1).reshape(dp0.shape)


def _seam_fold(K, T, dp_last, key_last, jmin_last, die_next):
    """The seam fold of a block's final state (B, S, T) with the NEXT block's
    first-column die flags die_next (B, K): all slots active at the block's
    last column die there, so row 0 of the fold holds, per transmission t,
    the folded cost m[t], the winning bipartition s*(t) and its jmin.
    Returns (m (B, T), s_star (B, T), jmin_star (B, T))."""
    fc, _fk, fi, fj = _fold_dying(K, T, die_next, dp_last, key_last, jmin_last)
    return fc[:, 0], fi[:, 0], fj[:, 0]


def solve_seeded_batched(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0, die_next):
    """Seeded solve of the pedigree block chain (the reference's
    solve_seeded_batched, T > 1): per block, seeded with its incoming seam
    vector dp0 (B, T), the head solve from the global optimum, the seam fold
    with die_next (B, K), and one walk per transmission value t from the
    fold's winner (s*(t), t) with the folded jmin as the preceding
    transmission.  Returns (cost_head (B,), m (B, T), ip_head (B, C),
    tp_head (B, C), seam_head (B,), ips (B, T, C), tps (B, T, C), seams
    (B, T)), int32."""
    B = wdiff.shape[0]
    dp_last, jmin_last, key_last, pi, pj = forward_scan(
        K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0=dp0
    )
    cost_head, ip_head, tp_head, seam_head = _backtrace_impl(
        K, T, dp_last, jmin_last, key_last, pi, pj
    )
    m, s_star, jmin_star = _seam_fold(K, T, dp_last, key_last, jmin_last, die_next)
    dev = wdiff.device
    t_ids = torch.arange(T, dtype=torch.int32, device=dev).repeat(B)
    block = torch.arange(B, device=dev).repeat_interleave(T)
    ips, tps, seams = _backtrace_from(
        s_star.reshape(-1), t_ids, jmin_star.reshape(-1), pi, pj, block
    )
    C = pi.shape[1]
    return (
        cost_head, m, ip_head, tp_head, seam_head,
        ips.reshape(B, T, C), tps.reshape(B, T, C), seams.reshape(B, T),
    )


def _planes(carry):
    """A carry in the kernels' layout (cost (B, T, S), jmin (B, T, S), key
    (B, S)) as forward_scan's carry0 ((B, S, T) planes)."""
    return carry[0].transpose(1, 2), carry[1].transpose(1, 2), carry[2]


def forward_carry(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry):
    """The checkpoint pass of the segmented solve on the torch mirror:
    forward_scan in its carry mode from `carry` (cost (B, T, S), jmin (B, T,
    S), key (B, S), the kernels' layout; jmin is zero at T == 1).  Returns
    the carry after the last column, in the same layout."""
    dp, jmin, key, _pi, _pj = forward_scan(
        K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry0=_planes(carry), mode="carry"
    )
    return dp.transpose(1, 2).contiguous(), jmin.transpose(1, 2).contiguous(), key


def forward_tables(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry):
    """The recompute pass of the segmented solve on the torch mirror:
    forward_scan with tables from `carry` (as forward_carry).  Returns
    (pidx (B, C, T, S), pjmin (B, C, T, S), None at T == 1)."""
    return forward_scan(
        K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry0=_planes(carry)
    )[3:]


def walk_segment(state, pidx, pjmin, die_prev=None):
    """The backtrace of one segment on the torch mirror.  state (B, 3) holds
    each block's (index, transmission, preceding transmission) at the
    segment's last column; pidx and pjmin (pjmin None at T == 1) are the
    segment's tables; die_prev, the segment's dying slots, is not read (the
    kernels' walk takes it as a guide).  Returns the index and transmission paths (B, seg) and
    the state one step through the segment's first column: the state at the
    preceding segment's last column, where its walk starts."""
    ip, tp, seam = _backtrace_from(state[:, 0], state[:, 1], state[:, 2], pidx, pjmin)
    rows = torch.arange(state.shape[0], device=state.device)
    v = pidx[rows, 0, seam.long(), ip[:, 0].long()]
    prev = pjmin[rows, 0, seam.long(), v.long()] if pjmin is not None else torch.zeros_like(v)
    return ip, tp, torch.stack([v, seam, prev], dim=1)


def solve_segmented(
    K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, seg,
    carry_pass=forward_carry, tables_pass=forward_tables, walk=walk_segment,
):
    """The segmented (checkpoint and recompute) solve of stacked blocks, the
    mirror of the reference's wmec_pallas.solve_segmented: the reference
    C++'s sqrt(n) trick (pedigreedptable.cpp:104,127-173).  C must be a
    multiple of `seg`.

      1. `carry_pass` runs over the nseg segments in turn without tables,
         keeping the carry at every segment boundary: nseg + 1 checkpoints
         of (2T + 1) * 2^K int32 per block, on the device (2 * 2^K at T = 1
         on the kernels, whose carry pass hands the one zeros jmin plane on);
      2. the optimum of the last carry (wmec_cuda._head_init: min cost,
         Gray key, transmission, index) and its jmin entry start the walk;
      3. from the last segment to the first, `tables_pass` re-runs the
         segment from its checkpoint with tables and `walk` backtraces it
         (given the segment's die_prev), handing on its state at the
         preceding segment's last column.

    One segment's tables live at a time.  The functions (by default the
    torch mirror: forward_carry, forward_tables, walk_segment) take the
    kernels' layout; wmec_cuda.solve_segmented_cuda hands in the kernels.
    Nothing here waits for the device.  Returns (costs (B,), index paths
    (B, C), transmission paths (B, C)), int32, equal to solve_batched's."""
    B, C = wdiff.shape[0], wdiff.shape[1]
    if seg < 1 or C % seg:
        raise ValueError(f"solve_segmented: C={C} is not a multiple of seg={seg}")
    arrays = (wdiff, wbase, rankw, acost, die_prev, rc)

    def seg_args(i):
        return tuple(a[:, i * seg : (i + 1) * seg].contiguous() for a in arrays)

    dev, S = wdiff.device, 1 << K
    zeros = torch.zeros((B, T, S), dtype=torch.int32, device=dev)
    checkpoints = [(zeros, zeros, torch.zeros((B, S), dtype=torch.int32, device=dev))]
    for i in range(C // seg):
        checkpoints.append(carry_pass(K, T, P, *seg_args(i), checkpoints[-1]))
    m, state = wmec_cuda._head_init(K, T, *checkpoints.pop())

    ips, tps = [], []
    for i in reversed(range(C // seg)):
        args = seg_args(i)
        pidx, pjmin = tables_pass(K, T, P, *args, checkpoints.pop())
        ip, tp, state = walk(state, pidx, pjmin, args[4])
        del pidx, pjmin  # free this segment's tables before the next one's
        ips.append(ip)
        tps.append(tp)
    return m, torch.cat(ips[::-1], dim=1), torch.cat(tps[::-1], dim=1)


def coset_representatives(T: int, t_sym_masks: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Transmission-symmetry cosets: for every XOR mask d in the span of
    t_sym_masks, G[a][b] == G[a^d][b^d] for each block's seam matrix G
    (founder haplotype relabeling, see pack_problem), so one seeded scan per
    coset representative recovers all of G:
        G[a][b] = G[rep(a)][b ^ a ^ rep(a)].
    Returns (rep_of (T,), the index of each t's representative, and reps
    (R,), the representatives); R = 1 for a trio."""
    span = {0}
    for g in t_sym_masks:
        span |= {d ^ g for d in span}
    rep_of = np.full(T, -1, dtype=np.int64)
    reps: List[int] = []
    for a in range(T):
        if rep_of[a] >= 0:
            continue
        for d in span:
            if rep_of[a ^ d] < 0:
                rep_of[a ^ d] = len(reps)
        reps.append(a)
    return rep_of, np.asarray(reps, dtype=np.int64)


def chain_seams(parts, nb: int, rep_of: np.ndarray, reps: np.ndarray) -> np.ndarray:
    """The exact min-plus seam chain on the host.  `parts` lists pass 1's
    output per bucket, (block indices (n,), m (n, R, T)): each block's
    folded minima from its R coset seeds, block after block.  Puts the rows
    in block order, expands each block's seam matrix G from its coset rows,
    then chains m_j = minplus(m_{j-1}, G_j) with INF saturation, in int64.
    Returns m_in (nb, T): the incoming seam vector of each block (zeros for
    block 0)."""
    R, T = len(reps), len(rep_of)
    m_rows = np.zeros((nb, R, T), dtype=np.int64)
    for idxs, m in parts:
        m_rows[np.asarray(idxs)] = np.asarray(m).reshape(len(idxs), R, T)
    a_idx = np.arange(T)[:, None]
    b_idx = np.arange(T)[None, :]
    row_sel = rep_of[a_idx]  # (T, 1)
    col_sel = b_idx ^ a_idx ^ reps[rep_of[a_idx]]  # (T, T)
    G = m_rows[:, row_sel, col_sel]  # (nb, T, T)
    m_in = np.zeros((nb, T), dtype=np.int64)
    m_cur = np.minimum(G[0].min(axis=0), INF)
    for j in range(1, nb):
        m_in[j] = m_cur
        m_cur = np.minimum((m_cur[:, None] + G[j]).min(axis=0), INF)
    return m_in


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
    return NotImplementedError(
        f"no CUDA kernel for K={K}, T={T}, P={P} yet: shapes beyond the kernels' envelope "
        f"({wmec_cuda.ENVELOPE}; six or more trios, T >= 4096, or six or more founders, "
        "P >= 12) need kernels with a wider envelope, ROADMAP Queue 1 item 5"
    )


def _over_budget(K: int, T: int, P: int, need: int, budget: int) -> NotImplementedError:
    return NotImplementedError(
        f"one block of K={K}, T={T}, P={P} needs {need} bytes of tables and state on the "
        f"card, above the table budget of {budget} bytes: the segmented solve takes only "
        "an instance of one read-connected range (and then one segment and the checkpoints "
        "must fit); an over-budget range among several is ROADMAP Queue 1 item 6"
    )


#: The devices that batched launches split their blocks over.  None: every
#: visible card when the launch's tensors lie on a CUDA device, else their
#: device alone.  A list of two or more devices (the same one may repeat, as
#: in parallel/dryrun.py) shards every launch of B > 1 blocks over them.
MESH_DEVICES: Optional[Sequence] = None

#: Shape records of the most recent batched launches, (K, T, C, B, B_padded,
#: n_devices) as the reference's wmec.LAUNCH_STATS; B_padded is B (the
#: kernels take B at launch, so no replica pads a shard).  Bounded so that
#: long runs do not grow it.
LAUNCH_STATS: List[Tuple[int, int, int, int, int, int]] = []
_LAUNCH_STATS_CAP = 4096


def _record_launch(K, T, C, B, B_padded, n_dev):
    if len(LAUNCH_STATS) < _LAUNCH_STATS_CAP:
        LAUNCH_STATS.append((K, T, C, B, B_padded, n_dev))


def _mesh_devices(device: torch.device) -> List[torch.device]:
    """The devices a launch whose tensors lie on `device` may shard over."""
    if MESH_DEVICES is not None:
        return [torch.device(d) for d in MESH_DEVICES]
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _cat(parts, device: torch.device):
    """Put the outputs of consecutive block chunks (each a tensor or a tuple
    of tensors) together on `device`, in block order."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    return tuple(torch.cat([x.to(device) for x in xs]) for xs in zip(*parts))


def _launch_chunked(solve, K, T, P, arrays, per_block_bytes: int):
    """One batched call of `solve` on the device its arrays lie on, split
    along the block axis into sequential chunks so that one chunk's tables
    and scratch stay under that device's table budget."""
    B = arrays[0].shape[0]
    budget = _table_budget(arrays[0].device)
    if budget is None or B * per_block_bytes <= budget:
        return solve(K, T, P, *arrays)
    max_b = budget // per_block_bytes
    if max_b < 1:
        raise _over_budget(K, T, P, per_block_bytes, budget)
    parts = [solve(K, T, P, *(a[i : i + max_b] for a in arrays)) for i in range(0, B, max_b)]
    return _cat(parts, arrays[0].device)


def _launch_sharded(solve, K, T, P, arrays, per_block_bytes: int, devices):
    """The counterpart of the reference's _launch_sharded: the block axis
    split into contiguous shards (tensor_split: uneven shards where B is not
    a multiple of the devices, none empty), each copied to its device and
    chunked against that device's own table budget.  Every shard is
    launched before anything waits for a device; the outputs come back to
    the launch device in block order.  Blocks are independent, so the
    result is the unsharded launch's."""
    home = arrays[0].device
    n = min(len(devices), arrays[0].shape[0])
    # every shard reaches its device before any is launched: a copy out of
    # the launch device waits for the work queued there, so a shard launched
    # there first would hold back the copies of the shards after it
    shards = [
        tuple(a.to(dev) for a in shard)
        for dev, shard in zip(devices, zip(*(torch.tensor_split(a, n) for a in arrays)))
    ]
    parts = [_launch_chunked(solve, K, T, P, shard, per_block_bytes) for shard in shards]
    return _cat(parts, home)


def _launch_batched(solve, K, T, P, arrays, per_block_bytes: int):
    """One batched call of `solve` (a tensor or a tuple of tensors with a
    leading block axis): sharded over the devices of _mesh_devices when
    there are two or more and B > 1, each shard (or the whole batch)
    chunked under its device's table budget.  Records the launch in
    LAUNCH_STATS."""
    B, C = arrays[0].shape[0], arrays[0].shape[1]
    devices = _mesh_devices(arrays[0].device)
    n_dev = min(len(devices), B)
    _record_launch(K, T, C, B, B, n_dev)
    if n_dev > 1:
        return _launch_sharded(solve, K, T, P, arrays, per_block_bytes, devices)
    return _launch_chunked(solve, K, T, P, arrays, per_block_bytes)


def _pick(K, T, P, device, kernel_route, mirror):
    """The kernel route for shapes the kernels take (its plain versions on
    CPU tensors), the torch mirror for other shapes on the CPU; on CUDA
    other shapes raise."""
    if wmec_cuda.kernel_supported(K, T, P):
        return kernel_route
    if device.type == "cpu":
        return mirror
    raise _unsupported(K, T, P)


def solve_batched_auto(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc):
    """Batched solve of stacked blocks on the device they lie on, through
    wmec_cuda.solve_batched_cuda where the kernels take the shape (_pick)."""
    solve = _pick(K, T, P, wdiff.device, wmec_cuda.solve_batched_cuda, solve_batched)
    C = wdiff.shape[1]
    per_block = C * T * (1 << K) * 4 * (2 if T > 1 else 1)  # index (+ trans) tables
    if solve is wmec_cuda.solve_batched_cuda:
        per_block += wmec_cuda.state_bytes(K, T, P)
    return _launch_batched(
        solve, K, T, P, (wdiff, wbase, rankw, acost, die_prev, rc), per_block
    )


def forward_m_auto(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0):
    """Pass 1 of the pedigree route, forward_m_batched's signature (seeds
    (B, T) or (B, R, T)), through the m-only kernel wmec_cuda.forward_m_t
    where it takes the shape, chunked along the blocks under the table
    budget counting the wide kernel's cost planes of every seed.  A block's
    seeds stay in one launch where their planes fit the budget; where they
    do not (a family of five children: 256 coset seeds of 64 MiB each at T =
    1024, K = 14), the seeds are split into launches of as many as fit, each
    chunked along the blocks in turn, and m is put together along the seed
    axis: each seed's scan is its own, so the result is the unsplit one."""
    fwd = _pick(K, T, P, wdiff.device, wmec_cuda.forward_m_t, forward_m_batched)
    R = dp0.shape[1] if dp0.dim() == 3 else 1
    arrays = (wdiff, wbase, rankw, acost, die_prev, rc)
    if fwd is forward_m_batched:
        return _launch_batched(fwd, K, T, P, arrays + (dp0,), 0)
    per_seed = wmec_cuda.state_bytes(K, T, P, seeds=1)
    budget = _table_budget(wdiff.device)
    if budget is None or R * per_seed <= budget:
        return _launch_batched(fwd, K, T, P, arrays + (dp0,), R * per_seed)
    r_max = budget // per_seed
    if r_max < 1:
        raise _over_budget(K, T, P, per_seed, budget)
    parts = []
    for r0 in range(0, R, r_max):
        seeds = dp0[:, r0 : r0 + r_max].contiguous()
        parts.append(_launch_batched(fwd, K, T, P, arrays + (seeds,), seeds.shape[1] * per_seed))
    return torch.cat(parts, dim=1)


def solve_seeded_auto(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, dp0, die_next):
    """Pass 2 of the pedigree route, solve_seeded_batched's signature,
    through wmec_cuda.solve_seeded_batched_cuda where the kernels take the
    shape, chunked under the table budget."""
    solve = _pick(
        K, T, P, wdiff.device, wmec_cuda.solve_seeded_batched_cuda, solve_seeded_batched
    )
    per_block = wdiff.shape[1] * T * (1 << K) * 4 * 2  # index and trans tables
    if solve is not solve_seeded_batched:
        per_block += wmec_cuda.state_bytes(K, T, P)
    return _launch_batched(
        solve, K, T, P, (wdiff, wbase, rankw, acost, die_prev, rc, dp0, die_next), per_block
    )


def _zero_carry(K: int, T: int, B: int, device: torch.device):
    """The scan's initial state in the kernels' carry layout: cost and jmin
    (B, T, 2^K) and key (B, 2^K), int32 zeros (cost and jmin one tensor:
    the carry mode reads both and writes neither)."""
    zeros = torch.zeros((B, T, 1 << K), dtype=torch.int32, device=device)
    return zeros, zeros, torch.zeros((B, 1 << K), dtype=torch.int32, device=device)


def _forward_cost(carry_pass):
    """`carry_pass` (forward_carry's signature) from the scan's initial
    state, in solve_batched's signature."""

    def run(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc):
        carry = _zero_carry(K, T, wdiff.shape[0], wdiff.device)
        return carry_pass(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, carry)

    return run


def forward_cost_batched_plain(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc):
    """Plain torch version of forward_cost_batched: the mirror's carry pass
    (forward_carry) from a zero carry, on the device the inputs lie on, in
    one launch."""
    return _forward_cost(forward_carry)(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc)


def forward_cost_batched(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc):
    """The batched forward scan from the initial state, final costs only:
    the reference's forward_cost_batched (whatshap_tpu/ops/wmec.py:916), the
    scale-out step whose block axis shards over several devices
    (parallel/mesh.py run_blocks_sharded).

    Inputs are stacked blocks as forward_scan's, on the device they lie on.
    Returns (dp_last (B, T, 2^K), jmin_last (B, T, 2^K), key_last (B,
    2^K)), int32, in the kernels' carry layout: the reference's dp_last and
    jmin_last are (B, 2^K, T), their transposes.  jmin_last is zero at T ==
    1, as the reference's.  On CUDA it runs the carry kernels from a zero
    carry (wmec_cuda._carry_pass: forward_carry_t1 at T = 1, forward_carry_t
    above, their wide kernels past the cluster kernels' envelope) and
    raises for shapes past them; on the CPU their plain versions, and the
    torch mirror's forward_carry for shapes past the kernels.  Launched
    through _launch_batched: chunked under the table budget counting the
    kernel's state and the carry in and out, and sharded over
    MESH_DEVICES."""
    carry_pass = _pick(K, T, P, wdiff.device, wmec_cuda._carry_pass, forward_carry)
    per_block = (3 * T + 2) * 4 << K  # the zero carry in, the carry out
    if carry_pass is wmec_cuda._carry_pass:
        per_block += wmec_cuda.state_bytes(K, T, P)
    return _launch_batched(
        _forward_cost(carry_pass), K, T, P, (wdiff, wbase, rankw, acost, die_prev, rc), per_block
    )


#: Bytes of backtrace tables the reference's segment length is sized for
#: (whatshap_tpu/ops/wmec.py:59); on the CPU, where there is no table
#: budget, the single-range route segments above twice this, as the
#: reference does (wmec.py:1892).
SEGMENT_TABLE_BUDGET = 1 << 30


def _table_bytes_per_col(K: int, T: int) -> int:
    """Bytes of backtrace tables per column and block: the index table, and
    at T > 1 the transmission table."""
    return (T * 4 << K) * (2 if T > 1 else 1)


def _segment_length(K: int, T: int) -> int:
    """The reference's segment length (wmec.py:1889-1890): one segment's
    tables near SEGMENT_TABLE_BUDGET / 2, a power of two in [256, 2048]
    (2048 at T = 1, K = 15; 512 at T = 4, K = 15; 1024 at T = 1, K = 17)."""
    per_col = _table_bytes_per_col(K, T)
    return max(256, min(2048, _next_pow2(SEGMENT_TABLE_BUDGET // per_col, lo=256) >> 1))


def _xla_segment_length(C: int) -> int:
    """The reference's segment length on its XLA scan route, the shapes its
    Pallas kernels refuse (whatshap_tpu/ops/wmec.py:1903-1905): about
    sqrt(C) columns, a power of two in [64, 2048], so that the checkpoints
    and one segment's tables grow alike."""
    return max(64, min(2048, _next_pow2(int(np.sqrt(C)), lo=64)))


def _single_range_segment(
    C: int, K: int, T: int, device: torch.device, P: Optional[int] = None
) -> Optional[int]:
    """The segment length for a single-range instance of C columns that the
    unsegmented solve cannot hold, else None.  On CUDA that is exactly where
    the unsegmented launch would raise: its tables (C padded to a power of
    two) plus the kernel's state exceed the table budget, so every instance
    that fits keeps its route.  On the CPU, which has no budget, the
    reference's rule: tables above 2 * SEGMENT_TABLE_BUDGET.  Past the
    cluster kernels' envelope (wmec_cuda.cluster_supported: T = 1 above
    MAX_K, and the pedigree shapes past T = 4 at K 16, T = 16 at K 13 or P
    4), where the reference runs its XLA scan, the segments follow that
    route's rule on every device, about sqrt(C) columns
    (_xla_segment_length), and on the CPU its threshold, tables above
    SEGMENT_TABLE_BUDGET.  P defaults to a single sample's 2 and a
    pedigree's 4."""
    if P is None:
        P = 2 if T == 1 else 4
    tables = _next_pow2(C) * _table_bytes_per_col(K, T)
    budget = _table_budget(device)
    wide = not wmec_cuda.cluster_supported(K, T, P)
    if budget is None:
        fits = tables <= (1 if wide else 2) * SEGMENT_TABLE_BUDGET
    else:
        fits = tables + wmec_cuda.state_bytes(K, T, P) <= budget
    if fits:
        return None
    return _xla_segment_length(C) if wide else _segment_length(K, T)


def solve_segmented_auto(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, seg):
    """The segmented solve of stacked blocks on the device they lie on:
    wmec_cuda.solve_segmented_cuda where the kernels take the shape (its
    plain versions on CPU tensors), the torch mirror's solve_segmented for
    other shapes on the CPU; on CUDA other shapes raise, and so does a
    segment whose tables, kernel state and checkpoints exceed the table
    budget."""
    solve = _pick(K, T, P, wdiff.device, wmec_cuda.solve_segmented_cuda, solve_segmented)
    budget = _table_budget(wdiff.device)
    if budget is not None:
        B, C, S = wdiff.shape[0], wdiff.shape[1], 1 << K
        # cost, jmin and key per block; at T = 1 the jmin plane is the one
        # zeros tensor that every checkpoint shares (solve_segmented)
        checkpoint = (2 if T == 1 else 2 * T + 1) * 4 * S
        need = seg * _table_bytes_per_col(K, T) + wmec_cuda.state_bytes(K, T, P)
        need += (C // seg + 1) * checkpoint
        if B * need > budget:
            raise _over_budget(K, T, P, need, budget)
    return solve(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc, seg)


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
        pending += [costs, index_paths]
    fetched = _fetch(pending)  # one copy for every bucket

    total_cost = 0
    index_path = np.zeros(C, dtype=np.int64)
    for members, costs, paths in zip(buckets.values(), fetched[::2], fetched[1::2]):
        for bi, (ri, _arrs) in enumerate(members):
            a, b = ranges[ri]
            total_cost += int(costs[bi])
            index_path[a:b] = paths[bi, : b - a]
    return DPResult(total_cost, index_path, np.zeros(C, dtype=np.int64))


def _fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Bring int32 device tensors to the host in ONE device-to-host copy:
    numpy arrays of the same shapes, in order."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        out.append(flat[off : off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out


def run_dp_batched_pedigree(
    packed: PackedProblem,
    device: torch.device,
    forward_m=forward_m_auto,
    solve_seeded=solve_seeded_auto,
) -> Optional[DPResult]:
    """Solve a pedigree (T > 1) instance exactly by splitting it into
    read-connected blocks, after the reference's run_dp_batched_pedigree.

    The blocks are coupled only through the transmission chain, and the DP
    is min-plus linear in its incoming folded state, so:

      1. pass 1 (`forward_m`, forward_m_auto): each bucket of blocks runs
         unit-seeded table-free scans, one per transmission-symmetry coset
         (R seeds (B, R, T) a block, over the block's inputs), giving the
         rows of each block's T x T seam matrix; all m come back in one
         fetch;
      2. the host chains the seam vectors in exact int64 min-plus
         (chain_seams, with the coset expansion);
      3. pass 2 (`solve_seeded`, solve_seeded_auto): each bucket re-runs
         seeded with its incoming seam vectors, giving the head solve and
         one walk per seam transmission value; every bucket's outputs come
         back in one fetch, and the host stitches right to left.

    Each bucket's arrays reach the device in one copy, die flags of the
    next block's first column (die_next) included.  Returns None for T == 1
    or a single range: callers solve it as one block.
    """
    from ..parallel.blocks import stack_blocks, to_device

    C, T, P = packed.n_cols, packed.T, packed.P
    if C == 0 or T == 1:
        return None
    ranges = connected_column_ranges(packed)
    nb = len(ranges)
    if nb <= 1:
        return None

    buckets: dict = {}  # (c_pad, k_b) -> ([range index], [PaddedArrays], [die_next])
    for ri, (c_pad, k_b, arrs) in enumerate(_slice_ranges(packed, ranges)):
        dn = np.zeros(k_b, dtype=bool)
        if ri + 1 < nb:
            nxt = packed.die_prev[ranges[ri + 1][0]]
            kk = min(len(nxt), k_b)
            dn[:kk] = nxt[:kk]
        idxs, members, dnext = buckets.setdefault((c_pad, k_b), ([], [], []))
        idxs.append(ri)
        members.append(arrs)
        dnext.append(dn)

    rep_of, reps = coset_representatives(T, packed.t_sym_masks)
    R = len(reps)
    unit_seeds = np.full((R, T), INF, dtype=np.int32)
    unit_seeds[np.arange(R), reps] = 0
    seeds = torch.from_numpy(unit_seeds).to(device)

    # ---- pass 1: unit-seeded forwards, one launch per bucket
    on_device = {}
    pending = []
    for (c_pad, k_b), (idxs, members, dnext) in buckets.items():
        arrays = to_device(stack_blocks(members) + (np.stack(dnext),), device)
        on_device[(c_pad, k_b)] = arrays
        pending.append(forward_m(k_b, T, P, *arrays[:6], seeds.expand(len(idxs), R, T).contiguous()))
    parts = [(idxs, m) for (idxs, _m, _d), m in zip(buckets.values(), _fetch(pending))]

    # ---- host chain: the incoming seam vector of every block
    m_in = torch.from_numpy(chain_seams(parts, nb, rep_of, reps).astype(np.int32)).to(device)

    # ---- pass 2: seeded solves with per-seam walks, one fetch for all
    pending = []
    for key, (idxs, _m, _d) in buckets.items():
        arrays = on_device[key]
        dp0 = m_in[torch.as_tensor(idxs, device=device)]
        pending += solve_seeded(key[1], T, P, *arrays[:6], dp0, arrays[6])
    fetched = _fetch(pending)
    per_block = [None] * nb
    for bi_bucket, (idxs, _m, _d) in enumerate(buckets.values()):
        outs = fetched[8 * bi_bucket : 8 * bi_bucket + 8]
        for bi, ri in enumerate(idxs):
            per_block[ri] = tuple(x[bi] for x in outs)

    # ---- host stitch, right to left
    index_path = np.zeros(C, dtype=np.int64)
    trans_path = np.zeros(C, dtype=np.int64)
    cost_head, _m, ip_head, tp_head, seam_head, _ips, _tps, _seams = per_block[-1]
    a, b = ranges[-1]
    index_path[a:b] = ip_head[: b - a]
    trans_path[a:b] = tp_head[: b - a]
    prev_t = int(seam_head)
    for j in range(nb - 2, -1, -1):
        _c, _m, _iph, _tph, _sh, ips, tps, seams = per_block[j]
        a, b = ranges[j]
        index_path[a:b] = ips[prev_t][: b - a]
        trans_path[a:b] = tps[prev_t][: b - a]
        prev_t = int(seams[prev_t])
    return DPResult(int(cost_head), index_path, trans_path)


def run_dp(
    packed: PackedProblem,
    device=None,
    solve=solve_batched_auto,
    forward_m=forward_m_auto,
    solve_seeded=solve_seeded_auto,
    solve_segmented=solve_segmented_auto,
) -> Optional[DPResult]:
    """Run the forward scan + backtrace on `device` (default "cuda", see
    resolve_device).  Returns None for empty problems.

    An instance that splits into several read-connected ranges takes the
    batched route: run_dp_batched for a single sample, run_dp_batched_pedigree
    for a pedigree (T > 1), on every device.  A single range is solved as
    one block (B = 1) padded to a power-of-two column count, or, where its
    tables would not fit (_single_range_segment), by the segmented solve,
    padded to a multiple of the segment length.  On a CUDA device every
    instance runs in the kernels of wmec_cuda, and one that they cannot take
    raises NotImplementedError.  `solve`, `forward_m`, `solve_seeded` and
    `solve_segmented` (the signatures of solve_batched_auto, forward_m_auto,
    solve_seeded_auto and solve_segmented_auto) solve each stack of blocks;
    a check can hand in the torch mirror (solve_batched, forward_m_batched,
    solve_seeded_batched, solve_segmented) to run the same route without the
    kernels.
    """
    from ..parallel.blocks import pad_block, stack_blocks, to_device

    device = resolve_device(device)
    C, K, T, P = packed.n_cols, packed.K, packed.T, packed.P
    if C == 0:
        return None
    if T == 1:
        result = run_dp_batched(packed, device, solve)
    else:
        result = run_dp_batched_pedigree(packed, device, forward_m, solve_seeded)
    if result is not None:
        return result

    seg = _single_range_segment(C, K, T, device, P)
    c_pad = _next_pow2(C) if seg is None else -(-C // seg) * seg
    arrays = to_device(stack_blocks([pad_block(packed, c_pad)]), device)
    if seg is None:
        costs, index_paths, trans_paths = solve(K, T, P, *arrays)
    else:
        costs, index_paths, trans_paths = solve_segmented(K, T, P, *arrays, seg)
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
