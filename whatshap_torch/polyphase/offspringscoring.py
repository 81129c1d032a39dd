"""
Allele co-occurrence scores for genetic polyploid phasing (counterpart of
whatshap/polyphase/offspringscoring.py).

Progeny allele depths give per-progeny genotype likelihoods for each
phasable parent marker; log-likelihood-ratio scores over those quantify
whether two marker alleles travel on the same parental haplotype.
"""

import logging
from collections import defaultdict
from functools import lru_cache
from math import comb, isnan, log
from typing import Iterable, List, Tuple

from scipy.stats import binom

from .solver import ProgenyGenotypeLikelihoods, TriangleSparseMatrix
from .variantselection import VariantInfo

logger = logging.getLogger(__name__)


@lru_cache(maxsize=None)
def get_binom_pmf(n, k, g, ploidy, error_rate):
    """P(k alt reads out of n | genotype has g alt copies of ploidy)."""
    if not (isinstance(g, int) and 0 <= g <= ploidy):
        raise ValueError(f"Invalid genotype alt-count ({g}).")
    dosage = g / ploidy
    alt_fraction = (1 - dosage) * error_rate + dosage * (1 - error_rate)
    return binom.pmf(k, n, alt_fraction)


def hyp(k, N, M, n):
    """Hypergeometric pmf: draw n of N without replacement, k of the M
    marked ones."""
    if not (0 <= k <= M and 0 <= n - k <= N - M):
        return 0.0
    return comb(M, k) * comb(N - M, n - k) / comb(N, n)


def compute_gt_likelihood_priors(ploidy):
    """priors[i][j][m] = P(progeny inherits m alt copies | the parents
    carry i resp. j alt copies out of ploidy)."""
    gametes = ploidy // 2

    def inherit(m, i, j):
        # m alt copies split between a gamete from each parent
        return sum(
            hyp(l, ploidy, i, gametes) * hyp(m - l, ploidy, j, gametes)
            for l in range(m + 1)
        )

    priors = [[None] * (ploidy + 1) for _ in range(ploidy + 1)]
    for i in range(ploidy + 1):
        for j in range(i + 1):
            dist = [inherit(m, i, j) for m in range(ploidy + 1)]
            priors[i][j] = priors[j][i] = dist
    return priors


def compute_gt_likelihoods(
    progeny_table,
    offspring: str,
    position_pairs: Iterable[Tuple[int, int]],
    varinfo: VariantInfo,
    param,
    gt_priors=None,
):
    """Per (parent node, progeny row) pair: normalized genotype likelihood
    vector from the progeny's ref/alt depths, or None when the depth is too
    shallow.  Consecutive nodes of one variant share their vector."""
    results = []
    allele_depths = progeny_table.allele_depths_of(offspring)
    last_row = -1
    for parent_pos, progeny_row in position_pairs:
        if progeny_row == last_row:
            results.append(results[-1])
            continue
        last_row = progeny_row
        info = varinfo[parent_pos]
        depths = allele_depths[progeny_row]

        def depth_of(allele):
            return depths[allele] if allele < len(depths) else 0

        ref_dp, alt_dp = depth_of(info.ref), depth_of(info.alt)
        covered = ref_dp + alt_dp
        if covered < param.ploidy:
            results.append(None)
            continue
        gl = [
            get_binom_pmf(covered, alt_dp, g, param.ploidy, param.allele_error_rate)
            for g in range(param.ploidy + 1)
        ]
        if gt_priors:
            prior_row = gt_priors[info.alt_count][info.co_alt_count]
            gl = [p * q for p, q in zip(gl, prior_row)]
        total = sum(gl)
        results.append([p / total for p in gl])
    return results


def get_offspring_gl(
    variant_table,
    progeny_table,
    offspring: List[str],
    varinfo: VariantInfo,
    phasing_param,
):
    """Genotype likelihoods of every offspring at every node (phasable
    variants expanded by alt multiplicity); variants absent from the
    progeny table are dropped from the phasable set."""
    progeny_row_of = {}
    for i, variant in enumerate(progeny_table.variants):
        if variant.position:
            progeny_row_of[variant.position] = i

    for p in varinfo.get_phasable():
        if variant_table.variants[p].position not in progeny_row_of:
            varinfo.remove_phasable(p)

    progeny_positions = []
    simplex_nulliplex = 0
    for p in varinfo.get_phasable():
        info = varinfo[p]
        if info.alt_count == 1 and info.co_alt_count == 0:
            simplex_nulliplex += 1
        row = progeny_row_of[variant_table.variants[p].position]
        progeny_positions.extend([row] * info.alt_count)

    logger.info("   Number of nodes to cluster: %d", len(progeny_positions))
    logger.info("   Number of simplex-nulliplex variants: %d", simplex_nulliplex)

    priors = compute_gt_likelihood_priors(phasing_param.ploidy)
    off_gl = ProgenyGenotypeLikelihoods(
        phasing_param.ploidy, len(offspring), len(varinfo.get_node_positions())
    )
    for i, child in enumerate(offspring):
        gls = compute_gt_likelihoods(
            progeny_table,
            child,
            zip(varinfo.get_node_positions(), progeny_positions),
            varinfo,
            phasing_param,
            priors,
        )
        for pos, gl in enumerate(gls):
            if gl:
                off_gl.setGlv(pos, i, gl)
    return off_gl


def correct_variant_types(
    variant_table,
    progeny_table,
    offspring: List[str],
    varinfo: VariantInfo,
    phasing_param,
):
    """Re-estimate each variant's (alt, co_alt) classification from the
    progeny likelihoods; apply corrections afterwards (node ids shift as
    soon as varinfo changes)."""
    priors = compute_gt_likelihood_priors(phasing_param.ploidy)
    off_gl = get_offspring_gl(variant_table, progeny_table, offspring, varinfo, phasing_param)

    histogram = defaultdict(lambda: defaultdict(int))
    pending = []
    seen_var = -1
    for node_id in range(off_gl.getNumPositions()):
        var_id = varinfo.node_to_variant(node_id)
        if var_id == seen_var:
            continue
        seen_var = var_id
        genpos = variant_table.variants[var_id].position
        new_type = get_most_likely_variant_type(priors, genpos, off_gl, node_id)
        pending.append((var_id, new_type))
        old_type = (varinfo[var_id].alt_count, varinfo[var_id].co_alt_count)
        histogram[old_type][new_type] += 1

    for var_id, new_type in pending:
        varinfo.correct_type(var_id, new_type[0], new_type[1])

    logger.info("   Correcting variant type based on progenies:")
    for old_type, updates in histogram.items():
        total = sum(updates.values())
        if total == 0:
            continue
        logger.info(f"   {old_type[0]}/{old_type[1]} ({total})")
        for new_type, count in updates.items():
            logger.info(
                "%s", f"      -> {new_type[0]}/{new_type[1]}: {count} ({100 * count / total:2.1f}%)"
            )


def get_most_likely_variant_type(priors, genpos, off_gl, pos):
    """Maximum-likelihood (parent alt, co-parent alt) pair for one node,
    marginalizing the progeny genotype under the inheritance priors."""
    k = len(priors)
    # gl vectors of the progenies with usable depth at this node
    usable = [
        [off_gl.getGl(pos, i, g) for g in range(k)]
        for i in range(off_gl.getNumSamples())
        if off_gl.getGl(pos, i, 0) >= 0.0
    ]

    def loglik(pair):
        prior_row = priors[pair[0]][pair[1]]
        # the reference seeds this accumulator at 1.0, not 0.0; the offset
        # is constant across pairs so the argmax is unaffected
        llh = 1.0
        for gl in usable:
            marginal = sum(p * q for p, q in zip(prior_row, gl))
            llh = llh - float("inf") if marginal <= 0.0 else llh + log(marginal)
        return llh

    best = (0, 0)
    best_llh = -float("inf")
    for g0 in range(k):
        for g1 in range(g0 + 1):
            llh = loglik((g0, g1))
            if llh > best_llh:
                best, best_llh = (g0, g1), llh
    return best


def get_variant_scoring(varinfo, off_gl, phasing_param):
    """Sparse pairwise node scores.  Partners are sampled with growing
    strides (dense near, strides 3/7/13 further out) so the window spans
    far without quadratic cost."""
    num_nodes = len(varinfo.get_node_positions())
    scoring = TriangleSparseMatrix()

    w = phasing_param.scoring_window
    q1, q2, q3 = w // 4, w // 2, 3 * w // 4
    strides = list(range(1, q1 + 1))
    strides += [strides[-1] + 3 * i for i in range(1, q2 - q1 + 1)]
    strides += [strides[-1] + 7 * i for i in range(1, q3 - q2 + 1)]
    strides += [strides[-1] + 13 * i for i in range(1, w - q3 + 1)]

    scorer_of = {
        (1, 0): off_gl.getSimplexNulliplexScore,
        (2, 0): off_gl.getDuplexNulliplexScore,
        (1, 1): off_gl.getSimplexSimplexScore,
    }
    for i in range(num_nodes):
        ni = varinfo.node_to_variant(i)
        prev_variant, prev_score = -1, 0
        for j in (i + s for s in strides):
            if j >= num_nodes:
                break
            nj = varinfo.node_to_variant(j)
            if ni == nj:
                score = -float("inf")
            else:
                if (varinfo[ni].alt_count, varinfo[ni].co_alt_count) != (1, 0):
                    continue
                if nj == prev_variant:
                    # another node of the same multiplex variant: reuse
                    score = prev_score
                else:
                    scorer = scorer_of.get(
                        (varinfo[nj].alt_count, varinfo[nj].co_alt_count)
                    )
                    if scorer is not None:
                        score = scorer(i, j)
                    prev_score = score
                    prev_variant = nj
            assert score != float("inf")
            assert not isnan(score)
            scoring.set(i, j, score)
    return scoring
