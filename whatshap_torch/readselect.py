"""
Read selection (coverage downsampling): iterative greedy slices with a
priority queue under a max-coverage constraint, plus bridging reads that
connect phase-block components.

Behavior parity with whatshap/readselect.pyx, including its exact scoring
scheme (new - gaps, total - gaps, min quality), score-update rule, and
set/queue iteration patterns (these determine tie outcomes and hence the
exact selected read set).
"""

import logging
from collections import defaultdict

from .coverage import CovMonitor
from .graph import ComponentFinder
from .priorityqueue import PriorityQueue

logger = logging.getLogger(__name__)


class _CachedRead:
    """Lightweight per-read view (positions/qualities/source) so the hot
    selection loops avoid Read.__getitem__ object churn; selection logic
    and tie outcomes are unchanged.  score/begin/end are the constant
    per-read values the slice loop needs (each slice rebuilds its queue
    from these same initial scores, so one computation is exact)."""

    __slots__ = ("positions", "qualities", "source_id", "score", "begin", "end")

    def __init__(self, positions, qualities, source_id):
        self.positions = positions
        self.qualities = qualities
        self.source_id = source_id
        self.score = None
        self.begin = -1
        self.end = -1


def _construct_indexes(readset, preferred_source_ids=None):
    """Return (positions, vcf index map, variant->reads map, preferred
    reads, per-read cache)."""
    positions = readset.get_positions()
    vcf_indices = {position: index for index, position in enumerate(positions)}
    variant_to_reads_map = defaultdict(list)
    preferred_reads = set()
    reads = []
    for index, read in enumerate(readset):
        cached = _CachedRead(read._positions, read._qualities, read.source_id)
        reads.append(cached)
        if preferred_source_ids is not None:
            if read.source_id in preferred_source_ids:
                preferred_reads.add(index)
        for position in read._positions:
            variant_to_reads_map[vcf_indices[position]].append(index)
        if read._positions:
            cached.score = _compute_score_for_read(reads, index, vcf_indices)
            cached.begin = vcf_indices[read._positions[0]]
            cached.end = vcf_indices[read._positions[-1]] + 1
    return positions, vcf_indices, variant_to_reads_map, preferred_reads, reads


def _update_score_for_reads(former_score, reads, index, newly_covered_positions):
    """Score update after a read has been selected (readselect.pyx:37-53).

    NOTE: the reference decrements the first score component for every
    variant of the read that is NOT among the newly covered positions;
    replicated as-is since it shapes the selection outcome.
    """
    first_score, second_score, quality = former_score
    for pos in reads[index].positions:
        if pos not in newly_covered_positions:
            first_score -= 1
    return (first_score, second_score, quality)


def _compute_score_for_read(reads, index, vcf_indices):
    """Initial score (new - gaps, total - gaps, min quality)
    (readselect.pyx:55-91)."""
    read = reads[index]
    min_quality = -1
    good_score = 0
    covered_variants = []
    for i, pos in enumerate(read.positions):
        quality = read.qualities[i]
        if i == 0:
            min_quality = quality
        else:
            min_quality = min(min_quality, quality)
        variant_covered = vcf_indices.get(pos)
        if variant_covered is not None:
            covered_variants.append(variant_covered)
            good_score += 1
    bad_score = 0
    span = covered_variants[-1] - covered_variants[0] + 1
    if len(covered_variants) != span:
        bad_score = span - len(covered_variants)
    return (good_score - bad_score, good_score - bad_score, min_quality)


def _construct_priorityqueue(reads, read_indices, vcf_indices):
    # ascending read order: the heap layout among equal scores (and hence
    # tie pops) depends on push order, so it must be deterministic — and
    # identical to the native engine's fill order (readselectlib.cpp)
    pq = PriorityQueue()
    for index in sorted(read_indices):
        pq.c_push(reads[index].score, index)
    return pq


def _slice_read_selection(pq, coverages, max_cov, reads, vcf_indices, variant_to_reads_map):
    """Extract one slice: greedily pop reads, respecting the coverage cap
    (readselect.pyx:107-167)."""
    already_covered_variants = set()
    reads_in_slice = set()
    reads_violating_coverage = set()
    while not pq.c_is_empty():
        variants_covered_by_this_read = set()
        max_score, max_item = pq.c_pop()
        read = reads[max_item]
        covers_new_variant = False
        for pos in read.positions:
            if pos in already_covered_variants:
                continue
            covers_new_variant = True
            variants_covered_by_this_read.add(pos)
        begin = read.begin
        end = read.end
        if coverages.max_coverage_in_range(begin, end) >= max_cov:
            reads_violating_coverage.add(max_item)
        elif covers_new_variant:
            coverages.add_read(begin, end)
            reads_in_slice.add(max_item)
            reads_whose_score_has_to_be_updated = set()
            for pos in variants_covered_by_this_read:
                already_covered_variants.add(pos)
                reads_whose_score_has_to_be_updated.update(
                    variant_to_reads_map[vcf_indices.get(pos)]
                )
            selected_read_set = set(reads_in_slice)
            # ascending read order: a deterministic update sequence (heap
            # layout after equal-score updates depends on it); the native
            # engine (readselectlib.cpp) applies the same order
            d_set = sorted(reads_whose_score_has_to_be_updated.difference(selected_read_set))
            for element in d_set:
                oldscore = pq.c_get_score_by_item(element)
                if oldscore is not None:
                    newscore = _update_score_for_reads(
                        oldscore, reads, element, variants_covered_by_this_read
                    )
                    pq.c_change_score(element, newscore)
    return reads_in_slice, reads_violating_coverage


def _format_read_source_stats(reads, indices):
    if len(indices) == 0:
        return "n/a"
    source_id_counts = defaultdict(int)
    for i in indices:
        source_id_counts[reads[i].source_id] += 1
    return ", ".join(f"{sid}:{count}" for sid, count in source_id_counts.items())


def _readselection_helper(
    coverages,
    max_cov,
    reads,
    vcf_indices,
    variant_to_reads_map,
    selected_reads,
    undecided_reads,
    positions,
    bridging,
):
    loop = 0
    while len(undecided_reads) > 0:
        pq = _construct_priorityqueue(reads, undecided_reads, vcf_indices)
        reads_in_slice, reads_violating_coverage = _slice_read_selection(
            pq, coverages, max_cov, reads, vcf_indices, variant_to_reads_map
        )
        selected_reads.update(reads_in_slice)
        undecided_reads -= reads_in_slice
        undecided_reads -= reads_violating_coverage

        # Component finder over the reads just selected
        component_finder = ComponentFinder(positions)
        for read_index in reads_in_slice:
            rpos = reads[read_index].positions
            for i in range(1, len(rpos)):
                component_finder.merge(rpos[0], rpos[i])

        bridging_reads = set()
        if bridging:
            pq = _construct_priorityqueue(reads, undecided_reads, vcf_indices)
            while not pq.is_empty():
                score, read_index = pq.pop()
                rpos = reads[read_index].positions
                covered_blocks = set()
                for pos in rpos:
                    covered_blocks.add(component_finder.find(pos))

                begin = reads[read_index].begin
                end = reads[read_index].end
                if coverages.max_coverage_in_range(begin, end) >= max_cov:
                    undecided_reads.remove(read_index)
                    continue
                if len(covered_blocks) < 2:
                    continue
                bridging_reads.add(read_index)
                selected_reads.add(read_index)
                coverages.add_read(begin, end)
                undecided_reads.remove(read_index)
                for i in range(1, len(rpos)):
                    component_finder.merge(rpos[0], rpos[i])
        loop += 1
        logger.debug(
            "... iteration %d: selected %d reads (source: %s) to cover positions and "
            "%d reads (source: %s) for bridging; %d reads left undecided",
            loop,
            len(reads_in_slice),
            _format_read_source_stats(reads, reads_in_slice),
            len(bridging_reads),
            _format_read_source_stats(reads, bridging_reads),
            len(undecided_reads),
        )
    return selected_reads


def _readselection_native(readset, max_cov, bridging):
    """One-call native selection (csrc/host/readselectlib.cpp): identical
    slice/bridging semantics and heap tie behavior; returns the selected
    index set, or None where hostlib.readselectlib is None (the Python path)."""
    from .hostlib import readselectlib

    if readselectlib is None:
        return None
    import numpy as np

    n_reads = len(readset)
    lens = np.fromiter((len(r._positions) for r in readset), np.int64, n_reads)
    read_off = np.zeros(n_reads + 1, dtype=np.int32)
    np.cumsum(lens, out=read_off[1:])
    total = int(read_off[-1])
    all_pos = np.fromiter(
        (p for r in readset for p in r._positions), np.int64, total
    )
    quals = np.fromiter(
        (q for r in readset for q in r._qualities), np.int32, total
    )
    uniq = np.unique(all_pos)
    vidx = np.searchsorted(uniq, all_pos).astype(np.int32)
    mask = readselectlib.readselection(
        read_off, np.ascontiguousarray(vidx), np.ascontiguousarray(quals),
        len(uniq), max_cov, bridging,
    )
    return set(np.nonzero(mask)[0].tolist())


def readselection(readset, max_cov, preferred_source_ids=None, bridging=True):
    """Select read indices not violating the maximum coverage; preferred
    source ids (phased-VCF pseudo-reads) are selected first."""
    for r in readset:
        if not len(r) >= 2:
            raise ValueError("readselection expects reads that cover at least two variants")

    # Native one-call route for the common case (no preferred reads: the
    # preferred phase iterates a scattered CPython set whose order the
    # native heap fill cannot reproduce, so it stays here in Python).
    has_preferred = preferred_source_ids is not None and any(
        read.source_id in preferred_source_ids for read in readset
    )
    if not has_preferred:
        selected = _readselection_native(readset, max_cov, bridging)
        if selected is not None:
            return selected

    positions, vcf_indices, variant_to_reads_map, preferred_reads, reads = _construct_indexes(
        readset, preferred_source_ids
    )

    logger.debug(
        "Running read selection for %d reads covering %d variants (bridging %s)",
        len(readset),
        len(positions),
        "ON" if bridging else "OFF",
    )

    coverages = CovMonitor(len(positions))
    selected_reads = set()

    undecided_reads = set(range(len(readset)))

    if len(preferred_reads) > 0:
        selected_preferred_reads = _readselection_helper(
            coverages,
            max_cov,
            reads,
            vcf_indices,
            variant_to_reads_map,
            selected_reads,
            preferred_reads,
            positions,
            bridging,
        )
        selected_reads.update(selected_preferred_reads)
        undecided_reads -= preferred_reads

    selected_reads = _readselection_helper(
        coverages,
        max_cov,
        reads,
        vcf_indices,
        variant_to_reads_map,
        selected_reads,
        undecided_reads,
        positions,
        bridging,
    )
    return selected_reads
