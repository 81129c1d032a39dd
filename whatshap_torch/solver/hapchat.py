"""
HapCHAT solver: adaptive-k column-wise MEC under the all-heterozygous
assumption.

Behavior parity with the reference's src/hapchat/ (hapchatcore.cpp,
combinations.h, binomialcoefficient.cpp, balancedcombinations.cpp,
hapchatcolumniterator.cpp) as wrapped by whatshap/core.pyx HapChatCore.

Because the reference hard-disables the homozygous transformation
(insert_col_and_update sets homo_cost to MAX_COVERAGE+1, hapchatcore.cpp),
its window parameter MAX_L always collapses to 2, so the recurrence only
ever links adjacent columns:

  D[j][B_j] = w(B_j) + min over predecessor masks of column j-1 whose
              projection onto the shared reads is consistent with B_j
              (directly, or complemented = swapped haplotypes),
  or        = w(B_j) + OPT[j-1] when no reads are shared (new block).

Masks B_j flip at most k_j entries of the column, where k_j comes from the
binomial tail bound with alpha=0.01, err=0.05 over the column's NON-gap
count, growing via k <- k + log2(k) + 1 whenever a column admits no
solution.  Note that the reference stores gap (BLANK) entries as REF with
phred 0 before the DP reads the column back (insert_col_and_update), so its
gap-specific enumeration machinery is dead: gaps are ordinary zero-weight
entries that still count toward k when flipped.  The
enumeration order (popcount-ascending, colex within each popcount; gap
subsets as ascending integers in the inner loop) and the strict-improvement
updates reproduce the reference's tie-breaking exactly, which is what fixes
the 1|0 orientation and the phasing of equal-score sites.

Caveat: the reference's own tie behavior is not fully deterministic — its
reconstruct_haplotypes reads backtrace entries that were never written
(Backtrace1 default jump=-1, basictypes.h:68-76; indexing at
hapchatcore.cpp:1437-1470 is an out-of-bounds read), so on cost-tied
instances it occasionally emits garbage-dependent allele flips.  This
implementation is deterministic and reproduces the reference's common-case
output; the oracle fuzz test retries the oracle to absorb the UB.
"""

import logging
from math import floor, log2
from typing import Dict, List, Tuple

from ..core import Read, ReadSet

logger = logging.getLogger(__name__)

INF = float("inf")
MAX_COVERAGE = 64

# ---------------------------------------------------------------------------
# binomials / colex subset ranking (binomialcoefficient.cpp)

_BINOM: List[List[int]] = []
_CUM_BINOM: List[List[int]] = []


def _init_binomials(n: int = MAX_COVERAGE) -> None:
    global _BINOM, _CUM_BINOM
    if _BINOM:
        return
    _BINOM = [[0] * (n + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        for j in range(i + 1):
            if i == 0 or j == 0 or j == i:
                _BINOM[i][j] = 1
            else:
                _BINOM[i][j] = _BINOM[i - 1][j - 1] + _BINOM[i - 1][j]
    _CUM_BINOM = [[0] * (n + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        for j in range(n + 1):
            _CUM_BINOM[i][j] = sum(_BINOM[i][x] for x in range(min(j, i) + 1))


def _binom(n: int, k: int) -> int:
    if k < 0 or n < 0 or n < k:
        return 0
    return _BINOM[n][k]


def _colex_index(mask: int) -> int:
    """Colex rank of a subset among subsets of its size
    (BinomialCoefficient::indexof)."""
    k = 0
    c_k = 0
    result = 0
    while mask:
        ffs = (mask & -mask).bit_length()  # 1-based position of lowest bit
        c_k += ffs
        k += 1
        result += _binom(c_k - 1, k)
        mask >>= ffs
    return result


def _cumulative_index(mask: int, n_elements: int) -> int:
    """Rank among all subsets of size <= popcount
    (BinomialCoefficient::cumulative_indexof)."""
    k = bin(mask).count("1")
    result = _colex_index(mask)
    for i in range(k):
        result += _binom(n_elements, i)
    return result


def _enumerate_masks(n: int, max_k: int):
    """All subsets of {0..n-1} with popcount 0..max_k, popcount-major,
    colex (= ascending numeric) within each popcount — exactly the order of
    Combinations::initialize_cumulative + next()."""
    yield 0
    for t in range(1, min(max_k, n) + 1):
        mask = (1 << t) - 1
        top = 1 << n
        while mask < top:
            yield mask
            # Gosper's hack: next same-popcount mask in ascending order
            c = mask & -mask
            r = mask + c
            mask = (((r ^ mask) >> 2) // c) | r


# ---------------------------------------------------------------------------
# adaptive k table (hapchatcore.cpp computeK; static table like the C++)

_KS_TABLE: List[int] = []


def _compute_k_table(cov: int = MAX_COVERAGE, alpha: float = 0.01, error_rate: float = 0.05):
    global _KS_TABLE
    if _KS_TABLE:
        return
    ks = [0] * (cov + 1)
    for i in range(1, cov + 1):
        k = 0
        cumulative = (1.0 - error_rate) ** i
        while not (1.0 - cumulative <= alpha) and k < i:
            k += 1
            cumulative += _binom(i, k) * (error_rate**k) * ((1.0 - error_rate) ** (i - k))
        ks[i] = k
    _KS_TABLE = ks


def _compute_k(cov: int) -> int:
    return _KS_TABLE[min(cov, len(_KS_TABLE) - 1)]


# ---------------------------------------------------------------------------
# column materialization (ColumnIterator semantics, columniterator.cpp:91-139)


class _Column:
    __slots__ = ("rids", "alleles", "gaps", "weights", "cov", "num_gaps", "gap_mask")

    def __init__(self):
        self.rids: List[int] = []
        self.alleles = 0  # bit i set iff entry i is ALT (gaps count as REF)
        self.gap_mask = 0  # bit i set iff entry i is a gap (BLANK)
        self.weights: List[int] = []
        self.cov = 0
        self.num_gaps = 0


def _materialize_columns(reads: List, positions: List[int]) -> List[_Column]:
    """One column per position; entry per read covering the position
    (BLANK/gap when the read spans but does not define it), in read order.
    Reads must be sorted by first position; read id := index."""
    first = [r[0].position for r in reads]
    last = [r[len(r) - 1].position for r in reads]
    var_of = [dict((v.position, (v.allele, v.quality)) for v in r) for r in reads]
    columns = []
    active: List[int] = []
    next_read = 0
    for pos in positions:
        active = [i for i in active if last[i] >= pos]
        while next_read < len(reads) and first[next_read] <= pos:
            if last[next_read] >= pos:
                active.append(next_read)
            next_read += 1
        col = _Column()
        for i in active:
            entry = var_of[i].get(pos)
            idx = col.cov
            col.rids.append(i)
            if entry is None:
                col.gap_mask |= 1 << idx
                col.num_gaps += 1
                col.weights.append(0)
            else:
                allele, quality = entry
                if allele == 1:
                    col.alleles |= 1 << idx
                col.weights.append(int(quality))
            col.cov += 1
        columns.append(col)
    return columns


def _intersect(col_q: _Column, col_j: _Column):
    """Shared-read index lists: positions in q and in j (hapchatcore.cpp
    intersect; its pos_gaps outputs are always empty because stored columns
    have no BLANK entries left)."""
    forw: List[int] = []
    back: List[int] = []
    i = j = 0
    while i < col_q.cov and j < col_j.cov:
        if col_q.rids[i] == col_j.rids[j]:
            forw.append(i)
            back.append(j)
            i += 1
            j += 1
        elif col_q.rids[i] < col_j.rids[j]:
            i += 1
        else:
            j += 1
    return forw, back


# ---------------------------------------------------------------------------


class HapChatCore:
    """Single-individual MEC solver with the HapCHAT DP; API parity with
    whatshap.core.HapChatCore (core.pyx:621-649)."""

    def __init__(self, readset: ReadSet):
        _init_binomials()
        _compute_k_table()
        self._readset = readset
        self._sample_id = readset[0].sample_id if len(readset) > 0 else 0
        self._optimal = 0
        self._superreads: List[Tuple[Read, Read]] = []
        self._run()

    # --- public API ---

    def get_length(self) -> int:
        return max(1, len(self._superreads))

    def get_super_reads(self):
        results = []
        for r0, r1 in self._superreads:
            rs = ReadSet()
            rs.add(r0)
            rs.add(r1)
            results.append(rs)
        return results, None

    def get_optimal_cost(self) -> int:
        return self._optimal

    def get_optimal_partitioning(self):
        return ["*" for _ in range(len(self._readset))]

    # --- core ---

    def _run(self) -> None:
        read0 = Read("superread_0_0", -1, -1, self._sample_id)
        read1 = Read("superread_1_0", -1, -1, self._sample_id)
        self._superreads.append((read0, read1))

        all_reads = [self._readset[i] for i in range(len(self._readset))]
        if not all_reads:
            return

        # interval-overlap blocks in input order, merging into the first
        # matching block (hapchatcolumniterator.cpp set_block, including the
        # minn==0 merge sentinel)
        mins: List[int] = []
        maxs: List[int] = []
        vblock: List[List] = []
        for read in all_reads:
            minn = read[0].position
            maxx = read[len(read) - 1].position
            if not mins:
                mins.append(minn)
                maxs.append(maxx)
                vblock.append([read])
            else:
                for j in range(len(mins)):
                    overflag = minn < mins[j] and maxx > maxs[j]
                    if (
                        (mins[j] <= minn <= maxs[j])
                        or (mins[j] <= maxx <= maxs[j])
                        or overflag
                    ):
                        mins[j] = min(mins[j], minn)
                        maxs[j] = max(maxs[j], maxx)
                        vblock[j].append(read)
                        minn = 0
                        break
                if minn != 0:
                    mins.append(minn)
                    maxs.append(maxx)
                    vblock.append([read])

        if not vblock:
            return

        # sort block 0 like the reference (ReadSet::sort on the block subset)
        from ..core.readset import _readset_sort_key

        block_reads = sorted(vblock[0], key=_readset_sort_key)
        block_positions = sorted({v.position for r in block_reads for v in r})

        native = self._dp_native(block_reads, block_positions)
        if native is not None:
            hap1, hap2, opt = native
        else:
            columns = _materialize_columns(block_reads, block_positions)
            hap1, hap2, opt = self._dp(columns)

        all_positions = sorted({v.position for r in all_reads for v in r})
        self._optimal = opt
        for i, pos in enumerate(all_positions):
            a1 = 1 if (i < len(hap1) and hap1[i]) else 0
            a2 = 1 if (i < len(hap2) and hap2[i]) else 0
            read0.add_variant(pos, a1, 30)
            read1.add_variant(pos, a2, 30)

    def _dp_native(self, block_reads, block_positions):
        """Dispatch to the C++ engine (csrc/host/hapchatlib.cpp), an
        operation-identical port of _dp below; None where
        hostlib.hapchatlib is None (the Python path)."""
        from ..hostlib import hapchatlib

        if hapchatlib is None or not block_positions:
            return None
        col_of = {p: i for i, p in enumerate(block_positions)}
        var_off, var_pos, var_allele, var_qual = [0], [], [], []
        for read in block_reads:
            for v in read:
                var_pos.append(col_of[v.position])
                var_allele.append(v.allele)
                var_qual.append(int(v.quality))
            var_off.append(len(var_pos))
        result = hapchatlib.solve(
            len(block_reads), len(block_positions), var_off, var_pos, var_allele, var_qual
        )
        if result is None:
            return None
        hap1, hap2, cost = result
        return hap1, hap2, int(cost)

    def _dp(self, columns: List[_Column]) -> Tuple[List[bool], List[bool], int]:
        n = len(columns)
        if n == 0:
            return [], [], 0

        k_j = [_compute_k(col.cov - col.num_gaps) for col in columns]

        OPT_prev = 0  # OPT of the dummy empty column 0
        # projection state from the previous column towards the current one
        prev_proj: Dict[int, int] = {}
        # backtrace per column: index -> (prev_index, haplotypes, new_block)
        bt: List[Dict[int, Tuple[int, bool, bool]]] = [dict() for _ in range(n + 1)]
        best1_index = [0] * (n + 1)
        best2_h = [False] * (n + 1)
        best2_nb = [False] * (n + 1)

        j = 0  # 0-based column being processed; step = j + 1
        while j < n:
            col = columns[j]
            prev_col = columns[j - 1] if j > 0 else _Column()

            # shared reads with the previous / next column
            forw, back = _intersect(prev_col, col)
            has_prev = len(forw) > 0
            if j + 1 < n:
                forw_n, back_n = _intersect(columns[j + 1], col)
                has_next = len(forw_n) > 0
            else:
                has_next = False

            # per-shared-entry XOR pattern of stored alleles (gaps are REF)
            diff_bits = 0
            for a in range(len(forw)):
                if ((prev_col.alleles >> forw[a]) & 1) != ((col.alleles >> back[a]) & 1):
                    diff_bits |= 1 << a

            solution_existence = False
            current_best = INF
            OPT_cur = INF
            next_proj: Dict[int, int] = {}
            step = j + 1
            active_qj = len(forw)
            full = (1 << active_qj) - 1

            for mask in _enumerate_masks(col.cov, k_j[j]):
                weight_mask = 0
                mm = mask
                while mm:
                    low = mm & -mm
                    weight_mask += col.weights[low.bit_length() - 1]
                    mm ^= low

                current_cost = INF
                temp_index = 0
                temp_haplotypes = False
                temp_new_block = False

                if has_prev:
                    # induced mask on the previous column's shared reads
                    # (extract_common_mask): bit a set iff correcting is
                    # needed there to keep the partitions consistent
                    mask_bits = 0
                    for a in range(len(back)):
                        mask_bits |= ((mask >> back[a]) & 1) << a
                    mask_qj = diff_bits ^ mask_bits
                    corrected = bin(mask_qj).count("1")

                    if corrected <= k_j[j - 1]:
                        index = _cumulative_index(mask_qj, active_qj)
                        temp = prev_proj.get(index, INF) + weight_mask
                        if temp < current_cost:
                            current_cost = temp
                            solution_existence = True
                            temp_index = index
                            temp_haplotypes = bt[step - 1][index][1]
                            temp_new_block = False

                    if (active_qj - corrected) <= k_j[j - 1]:
                        index = _cumulative_index(mask_qj ^ full, active_qj)
                        temp = prev_proj.get(index, INF) + weight_mask
                        if temp < current_cost:
                            current_cost = temp
                            solution_existence = True
                            temp_index = index
                            temp_haplotypes = not bt[step - 1][index][1]
                            temp_new_block = False
                else:
                    # new block: previous OPT plus this mask's weight
                    temp = OPT_prev + weight_mask
                    if temp < current_cost:
                        current_cost = temp
                        solution_existence = True
                        temp_index = 0
                        temp_haplotypes = False
                        temp_new_block = True

                # prevision for the next column
                if has_next and current_cost < INF:
                    cut_mask = 0
                    for a in range(len(back_n)):
                        cut_mask |= ((mask >> back_n[a]) & 1) << a
                    index = _cumulative_index(cut_mask, len(back_n))
                    if current_cost < next_proj.get(index, INF):
                        next_proj[index] = current_cost
                        bt[step][index] = (temp_index, temp_haplotypes, temp_new_block)

                if current_cost < current_best:
                    current_best = current_cost
                    best1_index[step] = temp_index
                    best2_h[step] = temp_haplotypes
                    best2_nb[step] = temp_new_block

                if current_cost < OPT_cur:
                    OPT_cur = current_cost

            if solution_existence:
                OPT_prev = OPT_cur
                prev_proj = next_proj
                j += 1
            else:
                # INC-K: grow k for this column and re-run it
                old_k = k_j[j]
                k_inc = old_k
                if k_inc <= 0:
                    k_inc = 1
                else:
                    k_inc = k_inc + log2(k_inc) + 1
                k_j[j] = floor(k_inc)
                logger.debug("HapChat: increment k from %d to %d at column %d", old_k, k_j[j], j)
                if k_j[j] <= old_k:  # safety against non-progress
                    k_j[j] = old_k + 1

        # backtracking (hapchatcore.cpp reconstruct_haplotypes; the
        # homozygous branches are dead because homo_cost is overridden)
        hap1 = [False] * n
        hap2 = [False] * n
        col = n
        while col > 0:
            back_index = best1_index[col]
            b_h = best2_h[col]
            b_nb = best2_nb[col]
            flag = col > 0
            while flag:
                if b_h:
                    hap1[col - 1] = False
                    hap2[col - 1] = True
                else:
                    hap1[col - 1] = True
                    hap2[col - 1] = False
                col -= 1
                if b_nb or col == 0:
                    flag = False
                else:
                    prev_index, h_, nb_ = bt[col][back_index]
                    b_h = h_
                    b_nb = nb_
                    back_index = prev_index

        return hap1, hap2, int(OPT_prev)
