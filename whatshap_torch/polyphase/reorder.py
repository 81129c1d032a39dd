"""
Reordering stage of the polyploid phaser (counterpart of
whatshap/polyphase/reorder.py): detect ambiguous switch breakpoints, solve
collapsed-region sub-instances recursively, pick the thread permutation for
every block (greedy on linkage likelihoods, or exactly via ILP/chain-DP
when a prephasing constrains the blocks) and attach confidences to the
breakpoints.
"""

import itertools as it
import logging
from bisect import bisect_right
from collections import defaultdict
from math import exp, log, prod
from typing import Dict, List, Tuple

from . import (
    Cluster,
    ClusterId,
    Haplotype,
    PhaseBreakpoint,
    PolyphaseResult,
    Position,
    Threading,
    get_ilp_solver,
)
from .solver import AlleleMatrix

logger = logging.getLogger(__name__)


ThreadId = int
SubInstance = Tuple[ClusterId, List[ThreadId], AlleleMatrix]
ThreadPermutation = Tuple[int]


# ---------------------------------------------------------------------------
# collapsed regions


def find_subinstances(
    allele_matrix: AlleleMatrix,
    clustering: List[Cluster],
    threads: Threading,
    haplotypes: List[Haplotype],
) -> List[SubInstance]:
    """Regions where >= 2 threads run through one cluster with differing
    alleles are "collapsed": the threading could not separate them.  Each
    maximal such region becomes (cluster id, thread ids, submatrix of its
    het positions), to be re-phased recursively."""
    open_snps = defaultdict(list)  # cluster -> positions of the open region
    open_threads = defaultdict(list)  # cluster -> thread set of the open region
    regions = []

    for pos, row in enumerate(threads):
        members = defaultdict(list)  # cluster -> threads inside it here
        seen_alleles = defaultdict(set)
        for hid, cid in enumerate(row):
            members[cid].append(hid)
            seen_alleles[cid].add(haplotypes[hid][pos])
        for cid, alleles in seen_alleles.items():
            if len(alleles) < 2:
                continue
            if open_threads[cid] != members[cid]:
                # different thread subset: close the running region
                if open_snps[cid]:
                    regions.append((cid, open_threads[cid], open_snps[cid]))
                open_threads[cid] = members[cid]
                open_snps[cid] = []
            open_snps[cid].append(pos)

    for cid, snps in open_snps.items():
        if snps:
            assert len(open_threads[cid]) > 0
            regions.append((cid, open_threads[cid], snps))

    sub_instances = []
    num_vars = len(allele_matrix.getPositions())
    ploidy = len(haplotypes)
    for cid, thread_set, snps in regions:
        if len(snps) == num_vars and len(thread_set) == ploidy:
            continue  # the whole instance is collapsed: recursion would loop
        submatrix = allele_matrix.extractSubMatrix(snps, clustering[cid], True)
        assert len(submatrix.getPositions()) > 0
        if len(submatrix) > 0:
            sub_instances.append((cid, thread_set, submatrix))
    return sub_instances


def integrate_sub_results(
    allele_matrix: AlleleMatrix,
    threads: Threading,
    haplotypes: List[Haplotype],
    sub_instances: List[SubInstance],
    sub_results: List[PolyphaseResult],
) -> List[PhaseBreakpoint]:
    """Copy sub-instance haplotypes back into the global ones; pool global
    and sub-instance breakpoints, fusing same-position duplicates."""
    breakpoints = find_breakpoints(threads)
    for (cid, thread_set, submatrix), result in zip(sub_instances, sub_results):
        local = [allele_matrix.globalToLocal(g) for g in submatrix.getPositions()]
        assert all(0 <= pos < allele_matrix.getNumPositions() for pos in local)
        for i, pos in enumerate(local):
            for j, hap in enumerate(thread_set):
                haplotypes[hap][pos] = result.haplotypes[j][i]
        for bp in result.breakpoints:
            pos = allele_matrix.globalToLocal(submatrix.localToGlobal(bp.position))
            breakpoints.append(
                PhaseBreakpoint(pos, [thread_set[i] for i in bp.haplotypes], bp.confidence)
            )

    breakpoints.sort(key=lambda bp: bp.position)
    fused: List[PhaseBreakpoint] = []
    for _, group_iter in it.groupby(breakpoints, key=lambda bp: bp.position):
        group = list(group_iter)
        if len(group) == 1:
            fused.append(group[0])
            continue
        merged = group[0]
        merged.haplotypes = sorted({h for bp in group for h in bp.haplotypes})
        merged.confidence = prod(bp.confidence for bp in group)
        fused.append(merged)
    for a, b in zip(fused, fused[1:]):
        assert a.position != b.position
    return fused


# ---------------------------------------------------------------------------
# breakpoint detection and scoring


def find_breakpoints(threads: Threading) -> List[PhaseBreakpoint]:
    """Positions where two or more threads leave their clusters at once
    (or a collapsed group splits) — thread linkage is ambiguous there."""
    ploidy = len(threads[0])
    breakpoints = []
    for i in range(1, len(threads)):
        switched = {j for j in range(ploidy) if threads[i - 1][j] != threads[i][j]}
        source_clusters = {threads[i - 1][j] for j in switched}
        ambiguous = sorted(
            j for j in range(ploidy) if threads[i - 1][j] in source_clusters
        )
        if len(ambiguous) >= 2:
            breakpoints.append(PhaseBreakpoint(i, ambiguous, 0.0))
    return breakpoints


def get_heterozygous_pos_for_haps(
    haplotypes: List[Haplotype], subset: List[ThreadId], pivot_pos: int, limit: int = 0
) -> Tuple[List[Position], List[Position]]:
    """Up to ``limit`` positions on each side of the pivot where the given
    haplotypes disagree (left side excludes, right side includes the
    pivot)."""

    def disagree(j):
        return len({haplotypes[h][j] for h in subset}) > 1

    left = [j for j in range(pivot_pos - 1, -1, -1) if disagree(j)][:limit][::-1]
    right = []
    for j in range(pivot_pos, len(haplotypes[0])):
        if len(right) >= limit:
            break
        if disagree(j):
            right.append(j)
    return left, right


def _read_llh_per_haplotype(read, both_pos, haplotypes, pivot, error_rate, ploidy):
    """For one read: log likelihood of its left / right half under each
    haplotype."""
    left_llh, right_llh = [], []
    log_match, log_err = log(1 - error_rate), log(error_rate)
    for h in range(ploidy):
        counts = {True: [0, 0], False: [0, 0]}  # is_left -> [overlap, errors]
        for j, allele in read:
            p = both_pos[j]
            side = counts[p < pivot]
            side[0] += 1
            side[1] += allele != haplotypes[h][p]
        l_olp, l_err = counts[True]
        r_olp, r_err = counts[False]
        left_llh.append(log_match * (l_olp - l_err) + log_err * l_err)
        right_llh.append(log_match * (r_olp - r_err) + log_err * r_err)
    return left_llh, right_llh


def compute_link_likelihoods(
    threads: Threading,
    haplotypes: List[Haplotype],
    breakpoints: List[PhaseBreakpoint],
    clustering: List[Cluster],
    allele_matrix: AlleleMatrix,
    error_rate: float,
) -> List[Dict[ThreadPermutation, float]]:
    """Per breakpoint: permutation of affected threads -> log likelihood of
    the local reads when the left block links to the right block that way."""
    ploidy = len(threads[0])
    all_scores = []
    for bp in breakpoints:
        pos, affected = bp.position, bp.haplotypes
        left_pos, right_pos = get_heterozygous_pos_for_haps(haplotypes, affected, pos, 32)
        both_pos = sorted(left_pos + right_pos)

        nearby_clusters = {threads[pos][h] for h in affected}
        if pos > 0:
            nearby_clusters |= {threads[pos - 1][h] for h in affected}
        spanning = [
            r
            for cid in nearby_clusters
            for r in clustering[cid]
            if allele_matrix.getFirstPos(r) < pos <= allele_matrix.getLastPos(r)
        ]
        submatrix = allele_matrix.extractSubMatrix(both_pos, spanning, True)

        per_read = [
            _read_llh_per_haplotype(read, both_pos, haplotypes, pos, error_rate, ploidy)
            for read in submatrix
        ]

        scores = {}
        for perm in it.permutations(affected):
            right_of = {left: perm[k] for k, left in enumerate(affected)}
            total = 0.0
            for left_llh, right_llh in per_read:
                total += max(
                    left_llh[left] + right_llh[right_of[left]] for left in affected
                )
            scores[perm] = total
        assert max(scores.values()) > -float("inf")
        all_scores.append(scores)

    assert len(all_scores) == len(breakpoints)
    return all_scores


def compute_phase_affiliation(
    allele_matrix: AlleleMatrix,
    haplotypes: List[Haplotype],
    breakpoints: List[PhaseBreakpoint],
    prephasing: AlleleMatrix,
    error_rate: float,
) -> List[List[List[float]]]:
    """aff[b][t][p]: log-affinity of thread t (in block b) to prephased
    haplotype p, from agreement counts over shared positions."""
    ploidy = len(haplotypes)
    happos_of = {pos: i for i, pos in enumerate(allele_matrix.getPositions())}
    block_starts = [bp.position for bp in breakpoints]
    assert block_starts == sorted(block_starts)
    num_blocks = len(block_starts) + 1

    shape = lambda: [[[0] * ploidy for _ in range(ploidy)] for _ in range(num_blocks)]
    overlap, errors = shape(), shape()

    prephasing_pos = prephasing.getPositions()
    phaseblock_starts = sorted({prephasing.getFirstPos(i) for i in range(len(prephasing))})
    phaseblock_starts.append(len(prephasing_pos))
    for phb, (start, end) in enumerate(zip(phaseblock_starts[:-1], phaseblock_starts[1:])):
        for i in range(start, end):
            hap_pos = happos_of.get(prephasing_pos[i])
            if hap_pos is None:
                continue
            block_id = bisect_right(block_starts, hap_pos)
            for t in range(ploidy):
                h_allele = haplotypes[t][hap_pos]
                if h_allele < 0:
                    continue
                for phase_id in range(phb * ploidy, (phb + 1) * ploidy):
                    p_allele = prephasing.getAllele(phase_id, i)
                    if p_allele < 0:
                        continue
                    overlap[block_id][t][phase_id % ploidy] += 1
                    errors[block_id][t][phase_id % ploidy] += h_allele != p_allele

    log_match, log_err = log(1 - error_rate), log(error_rate)
    return [
        [
            [
                log_match * (overlap[b][t][p] - errors[b][t][p]) + log_err * errors[b][t][p]
                for p in range(ploidy)
            ]
            for t in range(ploidy)
        ]
        for b in range(num_blocks)
    ]


# ---------------------------------------------------------------------------
# block assignment


def run_reordering(
    allele_matrix: AlleleMatrix,
    clustering: List[Cluster],
    threads: Threading,
    haplotypes: List[Haplotype],
    breakpoints: List[PhaseBreakpoint],
    prephasing: AlleleMatrix,
    error_rate=0.07,
):
    """Pick a permutation per block from read support (plus prephasing when
    available), apply it in place, and set breakpoint confidences."""
    lllh = compute_link_likelihoods(
        threads, haplotypes, breakpoints, clustering, allele_matrix, error_rate
    )
    aff = None
    if prephasing:
        aff = compute_phase_affiliation(
            allele_matrix, haplotypes, breakpoints, prephasing, error_rate
        )
    perms = get_optimal_assignments(breakpoints, lllh, len(haplotypes), aff)
    permute_blocks(threads, haplotypes, breakpoints, perms)
    compute_breakpoint_confidence(breakpoints, lllh, perms)


def _greedy_assignments(breakpoints, lllh, ploidy) -> List[List[int]]:
    """Without a prephasing: chain the locally best linkage permutation
    through the blocks."""
    assignments = [list(range(ploidy))]
    for b in range(len(breakpoints)):
        nxt = list(assignments[-1])
        best_perm = max(lllh[b], key=lllh[b].get)
        for left, right in zip(sorted(best_perm), best_perm):
            nxt[assignments[-1].index(left)] = right
        assignments.append(nxt)
    return assignments


def get_optimal_assignments(
    breakpoints: List[PhaseBreakpoint],
    lllh: List[Dict[ThreadPermutation, float]],
    ploidy: int,
    affiliations: List[List[List[float]]],
) -> List[ThreadPermutation]:
    """Permutation per block: greedy without a prephasing; with one, the
    exact optimum of linkage + affiliation scores (ILP when PuLP exists,
    otherwise an equivalent chain DP)."""
    if not breakpoints:
        return [list(range(ploidy))]
    if not affiliations:
        return _greedy_assignments(breakpoints, lllh, ploidy)

    try:
        from pulp import LpInteger, LpMaximize, LpProblem, LpVariable
    except ImportError:
        return _optimal_assignments_chain_dp(breakpoints, lllh, ploidy, affiliations)

    P = list(range(ploidy))
    B = list(range(len(breakpoints)))
    BE = list(range(len(breakpoints) + 1))
    model = LpProblem(f"PermuteBlocks_p{ploidy}_b{len(breakpoints)}", LpMaximize)

    # x[b][t][h] = 1 iff thread t sits on haplotype h in block b
    x = [[[LpVariable(f"x_{b}_{t}_{h}", 0, 1, LpInteger) for h in P] for t in P] for b in BE]
    # y[b][t1][t2] = 1 iff thread t1 links to thread t2 over breakpoint b
    y = [[[LpVariable(f"y_{b}_{t1}_{t2}", 0, 1, LpInteger) for t2 in P] for t1 in P] for b in B]
    # z[b][i] = 1 iff the i-th permutation is the linkage chosen at b
    z = [[LpVariable(f"z_{b}_{i}", 0, 1, LpInteger) for i in range(len(lllh[b]))] for b in B]

    aff_scores = []
    if affiliations is None:
        for t in P:
            model += x[0][t][t] == 1
    else:
        for b in BE:
            for t in P:
                for h in P:
                    aff_scores.append(x[b][t][h] * affiliations[b][h][t])

    # x[b] is a permutation matrix
    for b in BE:
        for j in P:
            model += sum(x[b][j][k] for k in P) == 1
            model += sum(x[b][k][j] for k in P) == 1

    # y consistency: only affected threads may relink; y follows x
    for b, bp in enumerate(breakpoints):
        affected = set(bp.haplotypes)
        for t1 in P:
            for t2 in P:
                if (t1 in affected) != (t2 in affected):
                    model += y[b][t1][t2] == 0
                elif t1 not in affected:
                    model += y[b][t1][t2] == (1 if t1 == t2 else 0)
                for h in P:
                    model += x[b][h][t1] + x[b + 1][h][t2] - 1 <= y[b][t1][t2]
            model += sum(y[b][t1][t2] for t2 in P) == 1
            model += sum(y[b][t2][t1] for t2 in P) == 1

    # z selects exactly one scored permutation per breakpoint
    z_weights = {}
    for b, bp in enumerate(breakpoints):
        left = bp.haplotypes
        assert left == sorted(left)
        for i, right in enumerate(lllh[b].keys()):
            z_weights[z[b][i]] = lllh[b][right]
            assert set(left) == set(right)
            model += z[b][i] >= sum(y[b][l][r] for l, r in zip(left, right)) - len(left) + 1
            for l, r in zip(left, right):
                model += z[b][i] <= y[b][l][r]
        model += sum(z[b]) == 1

    model += sum(var * weight for var, weight in z_weights.items()) + sum(aff_scores)
    model.solve(get_ilp_solver())

    assignments = [[0] * ploidy for _ in BE]
    for b in BE:
        for t in P:
            for h in P:
                if x[b][t][h].varValue > 0.999:
                    assignments[b][t] = h
                    break
            else:
                raise AssertionError("ILP returned a non-permutation x")
    return assignments


def _optimal_assignments_chain_dp(
    breakpoints: List[PhaseBreakpoint],
    lllh: List[Dict[ThreadPermutation, float]],
    ploidy: int,
    affiliations: List[List[List[float]]],
) -> List[ThreadPermutation]:
    """
    Exact maximizer of the same objective the reference encodes as an ILP
    (reorder.py get_optimal_assignments): per block b an assignment m_b
    (x[b][i][j] = 1 iff m_b[i] = j) contributing sum_i aff[b][m_b[i]][i],
    plus per breakpoint b the linkage likelihood lllh[b][perm] of the
    permutation of affected threads induced between m_b and m_{b+1}
    (t -> m_{b+1}[m_b^{-1}(t)]), with unaffected threads forced to link to
    themselves. The chain structure makes this a plain DP over blocks with
    ploidy! states.
    """
    states = [list(p) for p in it.permutations(range(ploidy))]
    neg_inf = -float("inf")

    def aff_score(b: int, m: List[int]) -> float:
        return sum(affiliations[b][m[i]][i] for i in range(ploidy))

    dp = [{tuple(m): aff_score(0, m) for m in states}]
    back: List[Dict[tuple, tuple]] = []
    for b, bp in enumerate(breakpoints):
        affected = bp.haplotypes
        affected_set = set(affected)
        cur: Dict[tuple, float] = {}
        choice: Dict[tuple, tuple] = {}
        for m2 in states:
            t2 = tuple(m2)
            base = aff_score(b + 1, m2)
            best = neg_inf
            best_prev = None
            for t1, prev_score in dp[b].items():
                if prev_score == neg_inf:
                    continue
                # induced linkage: thread m1[h] links to thread m2[h]
                valid = True
                link = {}
                for h in range(ploidy):
                    l, r = t1[h], m2[h]
                    if (l in affected_set) != (r in affected_set):
                        valid = False
                        break
                    if l not in affected_set and l != r:
                        valid = False
                        break
                    link[l] = r
                if not valid:
                    continue
                perm = tuple(link[l] for l in affected)
                score = prev_score + lllh[b].get(perm, neg_inf) + base
                if score > best:
                    best = score
                    best_prev = t1
            cur[t2] = best
            choice[t2] = best_prev
        dp.append(cur)
        back.append(choice)

    final = max(dp[-1], key=dp[-1].get)
    chain = [final]
    for b in range(len(breakpoints) - 1, -1, -1):
        chain.append(back[b][chain[-1]])
    chain.reverse()
    return [list(m) for m in chain]


def permute_blocks(
    threads: Threading,
    haplotypes: List[Haplotype],
    breakpoints: List[PhaseBreakpoint],
    perms: List[ThreadPermutation],
):
    ploidy = len(haplotypes)
    bounds = [0] + [bp.position for bp in breakpoints] + [len(threads)]
    for i, (start, end) in enumerate(zip(bounds[:-1], bounds[1:])):
        perm = perms[i]
        for p in range(start, end):
            threads[p] = [threads[p][perm[t]] for t in range(ploidy)]
            column = [haplotypes[t][p] for t in range(ploidy)]
            for t in range(ploidy):
                haplotypes[t][p] = column[perm[t]]


def compute_breakpoint_confidence(
    breakpoints: List[PhaseBreakpoint],
    lllh: List[Dict[ThreadPermutation, float]],
    perms: List[ThreadPermutation],
):
    """Softmax weight of the chosen linkage among all scored ones."""
    for i, bp in enumerate(breakpoints):
        affected = bp.haplotypes
        assert len(lllh[i].values()) >= 2
        best = max(lllh[i].values())
        reduced = [j for j in perms[i + 1] if j in affected]
        chosen = tuple(affected[reduced.index(j)] for j in perms[i] if j in affected)
        weights = sum(exp(v - best) for v in lllh[i].values())
        bp.confidence = exp(lllh[i][chosen] - best) / weights
