"""
Threading stage of the polyploid phaser (counterpart of
whatshap/polyphase/threading.py): pick the clusters relevant at each
position, thread ploidy-many paths through them with the HaploThreader DP,
read alleles off the per-cluster consensus rankings, and optionally force
the input genotypes back onto the result.
"""

import itertools
import logging
from collections import defaultdict
from functools import lru_cache
from math import ceil, log
from typing import Dict, List, Tuple

from scipy.stats import binom

from . import Allele, AlleleDepth, Cluster, ClusterId, Genotype, Haplotype, Threading
from .haplothreader import HaploThreader
from .solver import AlleleMatrix

logger = logging.getLogger(__name__)


@lru_cache(maxsize=65536)
def _binom_pmf(k, n, p):
    # scipy's pmf has heavy per-call overhead and the value set here is tiny
    return float(binom.pmf(k, n, p))


def run_threading(
    allele_matrix: AlleleMatrix,
    clustering: List[Cluster],
    ploidy: int,
    genotypes: List[Genotype],
    distrust_genotypes: bool = False,
    max_cluster_gap: int = 10,
    error_rate: float = 0.05,
) -> Tuple[Threading, List[Haplotype]]:
    """Thread ploidy paths through the clusters and derive alleles; unless
    genotypes are distrusted, minimally correct the haplotypes to match
    them."""
    num_vars = allele_matrix.getNumPositions()
    allele_depths, consensus = get_allele_depths(allele_matrix, clustering, ploidy)
    cov_map = select_clusters(allele_depths, ploidy, max_cluster_gap)

    affine_cost = ceil(compute_readlength_snp_distance_ratio(allele_matrix) / 1.0)
    paths = compute_threading_path(
        cov_map,
        allele_depths,
        ploidy,
        switch_cost=4 * affine_cost,
        affine_switch_cost=affine_cost,
        max_cluster_gap=max_cluster_gap,
    )
    assert len(paths) == num_vars

    haplotypes = compute_haplotypes(paths, consensus, ploidy)
    if not distrust_genotypes:
        haplotypes = force_genotypes(
            paths, haplotypes, genotypes, cov_map, allele_depths, error_rate
        )
    return paths, haplotypes


def compute_readlength_snp_distance_ratio(allele_matrix: AlleleMatrix) -> float:
    return sum(len(read) for read in allele_matrix) / len(allele_matrix)


def compute_threading_path(
    cov_map: List[List[ClusterId]],
    allele_depths: List[Dict[ClusterId, AlleleDepth]],
    ploidy: int,
    switch_cost: float = 32.0,
    affine_switch_cost: float = 8.0,
    max_cluster_gap: int = 10,
) -> Threading:
    """HaploThreader DP; the affine part prices a switch event once so
    simultaneous switches bundle onto one position."""
    logger.debug(f"Computing threading paths with switch cost {switch_cost} ..")
    row_limit = 16 * 2**ploidy if ploidy > 6 else 0
    threader = HaploThreader(ploidy, switch_cost, affine_switch_cost, max_cluster_gap, row_limit)
    return threader.computePathsBlockwise([0], cov_map, allele_depths)


def compute_haplotypes(
    path: Threading, consensus_lists: List[Dict[ClusterId, List[Allele]]], ploidy: int
) -> List[Haplotype]:
    """The k-th thread inside a cluster receives the cluster's k-th ranked
    consensus allele (-1 where the cluster has no data)."""
    haplotypes: List[Haplotype] = [[] for _ in range(ploidy)]
    for pos, row in enumerate(path):
        occupancy: Dict[ClusterId, int] = defaultdict(int)
        for i in range(ploidy):
            cid = row[i]
            ranking = consensus_lists[pos].get(cid)
            allele = ranking[occupancy[cid]] if ranking is not None else -1
            occupancy[cid] += 1
            haplotypes[i].append(allele)
    return haplotypes


def _config_log_likelihood(config, clusts, path_row, allele_depths_pos, alleles, error_rate):
    """How well a candidate per-thread allele configuration explains the
    observed per-cluster allele depths."""
    total = 0.0
    for clust in clusts:
        in_cluster = [slot for slot, cid in enumerate(path_row) if cid == clust]
        if not in_cluster:
            continue
        depths = allele_depths_pos[clust]
        total_depth = sum(depths.values())
        for a in alleles:
            share = sum(1 for slot in in_cluster if config[slot] == a) / len(in_cluster)
            expected = share * (1 - error_rate) + (1 - share) * error_rate
            prob = _binom_pmf(depths.get(a, 0), total_depth, expected)
            total += log(prob) if prob > 0 else -float("inf")
    return total


def force_genotypes(
    path: Threading,
    haplotypes: List[Haplotype],
    genotypes: List[Genotype],
    cov_map: List[List[ClusterId]],
    allele_depths: List[Dict[ClusterId, AlleleDepth]],
    error_rate: float,
) -> List[Haplotype]:
    """Where the threaded alleles disagree with the genotype, redistribute
    the allele multiset of the genotype over the conflicting threads,
    choosing the permutation most consistent with the read depths."""
    ploidy = len(haplotypes)
    for pos in range(len(path)):
        present: Dict[int, int] = defaultdict(int)
        alleles = set(genotypes[pos])
        for h in haplotypes:
            present[h[pos]] += 1
            alleles.add(h[pos])
        if -1 in present:
            continue

        surplus = {}
        to_insert: List[int] = []
        conflict_slots: List[int] = []
        for a in alleles:
            if a not in genotypes[pos]:
                genotypes[pos][a] = 0
            diff = present[a] - genotypes[pos][a]
            if diff > 0:
                surplus[a] = diff
                to_insert += [a] * genotypes[pos][a]
                conflict_slots += [
                    slot for slot in range(ploidy) if haplotypes[slot][pos] == a
                ]
            elif diff < 0:
                to_insert += [a] * (-diff)
        if not surplus:
            continue
        conflict_slots.sort()
        to_insert.sort()

        current = [haplotypes[h][pos] for h in range(ploidy)]
        best_config = current
        best_llh = -float("inf")
        for perm in set(itertools.permutations(to_insert)):
            candidate = current[:]
            for slot, allele in zip(conflict_slots, perm):
                candidate[slot] = allele
            llh = _config_log_likelihood(
                candidate, cov_map[pos], path[pos], allele_depths[pos], alleles, error_rate
            )
            if llh > best_llh:
                best_llh = llh
                best_config = candidate

        for h in range(ploidy):
            haplotypes[h][pos] = best_config[h]
    return haplotypes


def select_clusters(
    allele_depths: List[Dict[ClusterId, AlleleDepth]], ploidy: int, max_gap: int
) -> List[List[ClusterId]]:
    """Per position, the clusters worth threading through: the top covered
    ones (at most ploidy+2, each with >= 1/(8*ploidy) relative coverage),
    plus clusters from the previous position that reappear within max_gap
    positions (to bridge short gaps)."""
    cov_map: List[List[ClusterId]] = [[] for _ in allele_depths]
    for pos, depths in enumerate(allele_depths):
        ranked = sorted(
            ((cid, sum(d.values())) for cid, d in depths.items()),
            key=lambda t: t[1],
            reverse=True,
        )
        total = sum(cov for _, cov in ranked)
        keep = min(len(ranked), ploidy + 2)
        cov_map[pos].append(ranked[0][0])
        for cid, cov in ranked[1:keep]:
            if cov / total < 1.0 / (8.0 * ploidy) and cov_map[pos]:
                break
            cov_map[pos].append(cid)

    limit = ploidy + 2
    for pos in range(1, len(cov_map) - 1):
        lookahead = min(max_gap, len(cov_map) - pos - 1)
        for cid in cov_map[pos - 1]:
            if len(cov_map[pos]) >= limit:
                break
            if cid in cov_map[pos]:
                continue
            if any(cid in cov_map[pos + k + 1] for k in range(lookahead)):
                cov_map[pos].append(cid)
                allele_depths[pos][cid] = dict()

    for selection in cov_map:
        selection.sort()
    return cov_map


def _accumulate_depths_np(
    allele_matrix: AlleleMatrix,
    clustering: List[Cluster],
    depths: List[Dict[ClusterId, AlleleDepth]],
) -> bool:
    """Vectorized depth accumulation, equal to the scalar loop below
    including dict insertion order: per position the cluster ids appear in
    ascending order (the scalar loop's outer c_id loop), and per bucket the
    alleles appear in first-traversal-occurrence order (cluster-list order,
    then read order, then position order) — the downstream greedy consensus
    tie-breaks on that order."""
    import numpy as np

    n_clusters = len(clustering)
    n_alleles = allele_matrix.getMaxNumAllele()
    if n_clusters == 0 or n_alleles == 0:
        return True
    off, row_pos, row_allele = allele_matrix.flatRows()
    order = np.fromiter(
        (read for cluster in clustering for read in cluster),
        dtype=np.int64,
        count=sum(len(c) for c in clustering),
    )
    if order.size == 0:
        return True
    lens = off[order + 1] - off[order]
    total = int(lens.sum())
    if total == 0:
        return True
    # grouped-arange gather of every (pos, allele) in traversal order
    starts = off[order]
    csum = np.cumsum(lens)
    gather = np.arange(total, dtype=np.int64) - np.repeat(csum - lens, lens) + np.repeat(starts, lens)
    pos_t = row_pos[gather].astype(np.int64)
    allele_t = row_allele[gather].astype(np.int64)
    cid_per_read = np.repeat(
        np.arange(n_clusters, dtype=np.int64),
        np.fromiter((len(c) for c in clustering), np.int64, count=n_clusters),
    )
    cid_t = np.repeat(cid_per_read, lens)
    key = (pos_t * n_clusters + cid_t) * n_alleles + allele_t
    uniq, first_idx, counts = np.unique(key, return_index=True, return_counts=True)
    bucket_key = (uniq // n_alleles).tolist()
    allele_u = (uniq % n_alleles).tolist()
    first_idx = first_idx.tolist()
    counts = counts.tolist()
    prev_bk = -1
    bucket = None
    pending = []  # (first_idx, allele, count) of the current bucket
    for k in range(len(uniq) + 1):
        bk = bucket_key[k] if k < len(uniq) else -2
        if bk != prev_bk:
            if pending:
                pending.sort()  # first-occurrence order within the bucket
                bucket.update((a, c) for _, a, c in pending)
                pending = []
            if k < len(uniq):
                bucket = depths[bk // n_clusters].setdefault(bk % n_clusters, {})
                prev_bk = bk
        if k < len(uniq):
            pending.append((first_idx[k], allele_u[k], counts[k]))
    return True


def get_allele_depths(
    allele_matrix: AlleleMatrix, clustering: List[Cluster], ploidy: int
) -> Tuple[List[Dict[ClusterId, AlleleDepth]], List[Dict[ClusterId, List[Allele]]]]:
    """Per position and cluster: allele -> read count, plus a consensus
    ranking such that picking the first k entries yields the cluster's best
    k-allele multiset (greedy count/(1+uses) ranking)."""
    num_vars = allele_matrix.getNumPositions()
    depths: List[Dict[ClusterId, AlleleDepth]] = [{} for _ in range(num_vars)]
    depths_filled = _accumulate_depths_np(allele_matrix, clustering, depths)
    if not depths_filled:
        for c_id, cluster in enumerate(clustering):
            for read in cluster:
                for pos, allele in allele_matrix.getRead(read):
                    bucket = depths[pos].setdefault(c_id, {})
                    bucket[allele] = bucket.get(allele, 0) + 1

    rankings: List[Dict[ClusterId, List[Allele]]] = [{} for _ in range(num_vars)]
    buckets = [
        (pos, c_id, counts)
        for pos in range(num_vars)
        for c_id, counts in depths[pos].items()
    ]
    if buckets:
        # vectorized greedy consensus over all (position, cluster) buckets
        # at once: score = count / (1 + uses); ties go to the bucket's
        # FIRST dict entry with the max score (strict > in the scalar
        # loop), i.e. insertion order — so alleles are laid out in dict
        # order and argmax's first-max rule reproduces the tie-break
        import numpy as np

        n_b = len(buckets)
        width = max(len(c) for _, _, c in buckets)
        counts_m = np.zeros((n_b, width), dtype=np.float64)
        allele_m = np.zeros((n_b, width), dtype=np.int64)
        for b, (_pos, _cid, counts) in enumerate(buckets):
            for j, (allele, count) in enumerate(counts.items()):
                counts_m[b, j] = count
                allele_m[b, j] = allele
        uses = np.zeros((n_b, width), dtype=np.float64)
        picks = np.zeros((n_b, ploidy), dtype=np.int64)
        rows = np.arange(n_b)
        for step in range(ploidy):
            scores = counts_m / (1.0 + uses)
            # scalar rule: best starts at (score 0, allele 0) and only a
            # strictly greater score replaces it — an all-zero row picks
            # allele 0, which column 0 of a padded row reproduces only if
            # its allele is 0; real buckets always have a positive count
            win = np.argmax(scores, axis=1)
            picks[:, step] = allele_m[rows, win]
            uses[rows, win] += 1.0
        picks_l = picks.tolist()
        for b, (pos, c_id, _counts) in enumerate(buckets):
            rankings[pos][c_id] = picks_l[b]
    return depths, rankings
