"""
Read merging for ``phase --merge-reads``: cluster reads that look like they
come from the same haplotype and replace each cluster with one weighted
consensus superread.

Counterpart of the reference's whatshap/merge.py, with the same
probabilistic accept thresholds and the same output, but self-contained:
components are tracked with a union-find instead of networkx.

Replicated reference quirk (do NOT "fix"): the reference only considers a
"different-haplotype" (negative) edge for a read pair that was ALREADY
accepted as a "same-haplotype" (blue) edge — and the two acceptance
conditions (match - mismatch >= thr_diff >= 1 and mismatch - match >=
thr_neg_diff >= 1) are mutually exclusive, so its negative-evidence graph
is always empty and the component-breaking pass never runs.  We keep the
nested structure so behavior (and any future threshold change) matches.
"""

import logging
from math import log
from typing import Dict, List, Tuple

from .core import Read, ReadSet
from .graph import ComponentFinder

logger = logging.getLogger(__name__)


class ReadMergerBase:
    def merge(self, readset: ReadSet) -> ReadSet:
        raise NotImplementedError


class DoNothingReadMerger(ReadMergerBase):
    def merge(self, readset: ReadSet) -> ReadSet:
        return readset


def _overlap_counts(a_begin: int, a_alleles: List[int], b_begin: int, b_alleles: List[int]):
    """(matches, mismatches) over the index-aligned overlap of two reads,
    where read b starts (b_begin - a_begin) columns into read a."""
    skip = b_begin - a_begin
    match = mismatch = 0
    for x, y in zip(a_alleles[skip:], b_alleles):
        if x == y:
            match += 1
        else:
            mismatch += 1
    return match, mismatch


class ReadMerger(ReadMergerBase):
    def __init__(self, error_rate, max_error_rate, positive_threshold, negative_threshold):
        self._error_rate = error_rate
        self._max_error_rate = max_error_rate
        self._positive_threshold = positive_threshold
        self._negative_threshold = negative_threshold

    def merge(self, readset: ReadSet) -> ReadSet:
        logger.info(
            "Merging %d reads with error rate %.2f, maximum error rate %.2f, "
            "positive threshold %d and negative threshold %d ...",
            len(readset),
            self._error_rate,
            self._max_error_rate,
            self._positive_threshold,
            self._negative_threshold,
        )
        # Minimum allele-count margins implied by the likelihood-ratio
        # thresholds under the error model (same formula as the reference).
        base = (1 - self._error_rate) / (self._error_rate / 3)
        need_diff = 1 + int(log(self._positive_threshold, base))
        need_neg_diff = 1 + int(log(self._negative_threshold, base))

        n = len(readset)
        originals: List[List[Tuple[int, int, int]]] = []
        blue_edges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        negative_edges: List[Tuple[int, int]] = []

        # Sweep reads in start order, keeping a window of reads whose span
        # may still overlap the current one.
        window: Dict[int, Tuple[int, int, List[int]]] = {}  # id -> (begin, end, alleles)
        for i, read in enumerate(readset):
            vs = [(v.position, v.allele, v.quality) for v in read]
            originals.append(vs)
            alleles = [a for _, a, _ in vs]
            assert all(a in (0, 1) for a in alleles)
            begin = vs[0][0]
            end = begin + len(alleles)

            for dead in [j for j, (_, jend, _) in window.items() if jend <= begin]:
                del window[dead]
            for j, (jbegin, _, jalleles) in window.items():
                match, mismatch = _overlap_counts(jbegin, jalleles, begin, alleles)
                total = match + mismatch
                if (
                    total >= need_neg_diff
                    and min(match, mismatch) / total <= self._max_error_rate
                    and match - mismatch >= need_diff
                ):
                    blue_edges[(j, i)] = (match, mismatch)
                    if mismatch - match >= need_neg_diff:  # unreachable; see module docstring
                        negative_edges.append((j, i))
            window[i] = (begin, end, alleles)

        # Connected components of the same-haplotype graph.  The reference
        # would additionally cut blue paths between endpoints of a negative
        # edge, but its negative graph is provably empty (docstring); if a
        # negative edge ever appears, refuse to merge rather than silently
        # produce chimeric superreads.
        if negative_edges:
            raise AssertionError(
                "negative-evidence edges should be unreachable; thresholds changed?"
            )
        cf = ComponentFinder(range(n))
        for j, i in blue_edges:
            cf.merge(j, i)

        members: Dict[int, List[int]] = {}
        for i in range(n):
            members.setdefault(cf.find(i), []).append(i)

        merged = ReadSet()
        # Output names carry the ORIGINAL read index (the reference burns a
        # name per input read whether or not it emits one, so emitted names
        # are not consecutive).
        for i in range(n):
            rep = cf.find(i)
            group = members[rep]
            if len(group) == 1:
                # untouched read: copy through as-is
                copy = Read(f"read{i}")
                for pos, allele, quality in originals[i]:
                    copy.add_variant(pos, allele, quality)
                merged.add(copy)
            elif i == rep:
                # consensus superread: per position, weight-vote the allele
                votes: Dict[int, List[int]] = {}
                for member in group:
                    for pos, allele, quality in originals[member]:
                        votes.setdefault(pos, [0, 0])[allele] += quality
                consensus = Read(f"read{i}")
                for pos in sorted(votes):
                    w0, w1 = votes[pos]
                    consensus.add_variant(pos, 0 if w0 >= w1 else 1, abs(w1 - w0))
                merged.add(consensus)
            # non-representative members of a merged group emit nothing

        logger.info(
            "... after merging: merged %d reads into %d reads", len(readset), len(merged)
        )
        return merged
