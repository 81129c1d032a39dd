"""
Pure-Python CIGAR engines for allele detection (used by ``variants.py``).

Both entry points are built around one shared idea: the alignment's CIGAR is
first flattened into a **segment table** — a list of (kind, ref span, query
span) tuples with absolute coordinates — and variants are then resolved
against that table.  This replaces the reference's single interleaved
op-loop (whatshap/_variants.pyx) with two small passes: a *claim* pass that
assigns each variant to the segment that covers it, and a *replay* pass that
advances per-allele automata over the remaining segments.

Behavioral parity quirks with whatshap/_variants.pyx that we deliberately
keep:
  * during one match segment the query pointer used for base comparison is
    pinned at its value on segment entry (_variants.pyx:232-247);
  * insertion segments count a mismatching base as consumed before bailing;
  * insertion variants whose position falls inside a deletion segment are
    dropped entirely;
  * an insertion segment claims insertion variants within ``length`` bases
    of its anchor, but stops at the first non-insertion variant.
"""

import logging

logger = logging.getLogger(__name__)

# Segment kinds (subset of CIGAR ops that interact with variants).
_MATCH, _INS, _DEL, _SKIP = 0, 1, 2, 3

_KIND_OF_OP = {0: _MATCH, 7: _MATCH, 8: _MATCH, 1: _INS, 2: _DEL, 3: _SKIP}


def _segment_table(cigartuples, reference_start):
    """Flatten a CIGAR into segments with absolute coordinates.

    Returns a list of (kind, op_index, ref_start, ref_end, length,
    query_start).  Soft clips advance the query cursor, hard clips and pads
    are ignored; both produce no segment.  ``ref_end`` equals ``ref_start``
    for insertions (zero reference footprint).
    """
    table = []
    ref = reference_start
    query = 0
    for op_index, (op, length) in enumerate(cigartuples):
        kind = _KIND_OF_OP.get(op)
        if kind is None:
            if op == 4:  # soft clip
                query += length
                continue
            if op in (5, 6):  # hard clip / pad
                continue
            raise ValueError(f"Unsupported CIGAR operation: {op}")
        ref_span = length if kind in (_MATCH, _DEL, _SKIP) else 0
        table.append((kind, op_index, ref, ref + ref_span, length, query))
        ref += ref_span
        if kind in (_MATCH, _INS):
            query += length
    return table


# ---------------------------------------------------------------------------
# realignment mode: locate each variant's split point in the CIGAR


def _iterate_cigar(variants, j, bam_read, cigartuples):
    """Yield (variant index, CIGAR op index, offset within op, query pos)
    for every variant of ``variants[j:]`` covered by the alignment.

    Match and deletion segments cover their reference span; an insertion
    segment covers exactly its anchor position (and takes precedence over a
    following match at the same anchor).  Variants in skipped (N) regions or
    outside every segment produce nothing.
    """
    table = _segment_table(cigartuples, bam_read.reference_start)
    total = len(variants)
    cursor = 0
    limit = len(table)

    while j < total and cursor < limit:
        position = variants[j].position
        kind, op_index, ref_start, ref_end, _length, query_start = table[cursor]

        if kind == _INS:
            if position < ref_start:
                # left of the alignment (all in-alignment variants before
                # this anchor were consumed by the preceding segments)
                j += 1
                continue
            if position == ref_start:
                yield (j, op_index, 0, query_start)
                j += 1
            # a single insertion claims at most one variant
            cursor += 1
            continue

        if position >= ref_end:
            cursor += 1
            continue
        if position < ref_start:
            # variant lies left of the alignment (or in a gap) — unclaimable
            j += 1
            continue

        offset = position - ref_start
        if kind == _MATCH:
            yield (j, op_index, offset, query_start + offset)
        elif kind == _DEL:
            yield (j, op_index, offset, query_start)
        # _SKIP: covered but not observable — consume silently
        j += 1


# ---------------------------------------------------------------------------
# reference-free mode: per-allele progress automata


def _claim_variants(table, variants, trackers, first):
    """Assign each tracker to the segment that anchors its variant.

    Returns a list of (tracker, segment index, query start) in positional
    order.  Mirrors the reference's queueing rules: match/deletion segments
    claim variants inside their reference span; an insertion segment claims
    insertion variants within ``length`` bases of its anchor but stops at
    the first non-insertion variant; insertion variants inside a deletion
    span are dropped; variants behind the scan head are dropped.
    """
    claims = []
    j = first
    total = len(trackers)

    for seg_index, (kind, _op, ref_start, ref_end, length, query_start) in enumerate(table):
        while j < total:
            tracker = trackers[j]
            position = variants[tracker.variant_id].position
            if position < ref_start:
                j += 1  # left behind — never claimable any more
                continue
            if kind == _SKIP:
                if position >= ref_end:
                    break
                j += 1  # inside a skipped region — drop
                continue
            if kind == _INS:
                if position >= ref_start + length:
                    break
                if len(variants[tracker.variant_id].reference_allele) > 0:
                    break  # blocks this insertion segment entirely
                claims.append((tracker, seg_index, query_start + position - ref_start))
                j += 1
                continue
            if position >= ref_end:
                break
            if kind == _DEL:
                if len(variants[tracker.variant_id].reference_allele) == 0:
                    j += 1  # insertion variant swallowed by a deletion
                    continue
                claims.append((tracker, seg_index, query_start))
            else:  # _MATCH
                claims.append((tracker, seg_index, query_start + position - ref_start))
            j += 1
    return claims


def _advance_match(allele, sequence, read, query_base, qualities, budget):
    """Consume matching bases of a match segment; return ops consumed.

    ``query_base`` is pinned for the whole call (parity quirk)."""
    used = 0
    while allele.matched < allele.match_target and used < budget:
        if read[query_base] != sequence[allele.matched + allele.inserted]:
            break
        allele.quality += qualities[query_base] if qualities else 30
        allele.matched += 1
        allele.progress += 1
        used += 1
    return used


def _advance_insertion(allele, sequence, read, query_start, budget):
    """Consume inserted bases; a mismatching base still counts as consumed
    (parity quirk); return ops consumed."""
    used = 0
    while allele.inserted < allele.insert_target and used < budget:
        used += 1
        index = allele.matched + allele.inserted
        if read[query_start + index] != sequence[index]:
            break
        allele.inserted += 1
        allele.progress += 1
        allele.quality += 30
    return used


def _advance_deletion(allele, budget):
    """Consume deleted reference bases (no sequence check); return count."""
    used = min(allele.delete_target - allele.deleted, budget)
    allele.deleted += used
    allele.progress += used
    allele.quality += 30 * used
    return used


def _replay(tracker, variant, table, seg_index, bam_read):
    """Advance every candidate allele of one claimed variant over the
    segments from its claiming segment to the end of the alignment."""
    read = bam_read.query_sequence
    qualities = bam_read.query_qualities
    anchor = tracker.query_start

    for kind, _op, _ref_start, _ref_end, length, query_start in table[seg_index:]:
        if kind == _SKIP:
            continue
        pending = False
        for index, allele in enumerate(tracker.alleles):
            if allele.progress < 0 or allele.progress >= allele.length:
                continue
            sequence = variant.get_allele(index)
            if kind == _MATCH:
                head = max(0, anchor - query_start)
                used = head + _advance_match(
                    allele, sequence, read,
                    anchor + allele.matched + allele.inserted,
                    qualities, length - head,
                )
                if used < length and allele.progress < allele.length:
                    allele.progress = -1
                    continue
            elif kind == _INS:
                used = _advance_insertion(allele, sequence, read, anchor, length)
                if used < length and 0 < allele.progress < allele.length:
                    allele.progress = -1
                    continue
            else:  # _DEL
                used = _advance_deletion(allele, length)
                if used < length and allele.progress < allele.length:
                    allele.progress = -1
                    continue
            if 0 <= allele.progress < allele.length:
                pending = True
        if not pending:
            break


def _emit(tracker):
    """Pick the winning allele of a fully-resolved tracker, or None.

    A tracker emits only when at least one allele completed and none is
    still in flight; ties on completion go to the longest allele (lowest
    index among equals)."""
    best = None
    for index, allele in enumerate(tracker.alleles):
        if 0 <= allele.progress < allele.length:
            return None  # still pending — reference would not emit either
        if allele.progress == allele.length:
            if best is None or allele.length > tracker.alleles[best].length:
                best = index
    if best is None:
        return None
    chosen = tracker.alleles[best]
    quality = chosen.quality // chosen.length if chosen.length > 0 else 30
    return best, quality


def _detect_alleles(variants, var_progress, first, bam_read):
    """Reference-free allele detection.

    Yields (variant id, allele index, quality) for each variant of
    ``var_progress[first:]`` whose alleles could be fully resolved against
    the read.  Semantics match whatshap/_variants.pyx:84-297 (see module
    docstring for the shared quirks); the claim/replay structure is our own.
    """
    table = _segment_table(bam_read.cigartuples, bam_read.reference_start)
    for tracker, seg_index, query_start in _claim_variants(
        table, variants, var_progress, first
    ):
        tracker.reset(query_start)
        _replay(tracker, variants[tracker.variant_id], table, seg_index, bam_read)
        result = _emit(tracker)
        if result is not None:
            yield tracker.variant_id, result[0], result[1]
