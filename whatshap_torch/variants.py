"""
Re-discover VCF variants inside BAM/CRAM alignments and emit them as core
Read objects (the DP input).  Two detection modes:

- with a reference: realign the query segment around each variant against
  padded REF/ALT haplotypes and keep the closer one (edit distance, affine
  gaps, or kmer alignment);
- without a reference: walk the CIGAR and read the alleles off directly
  (``_variants`` module).

Functional counterpart of the reference's whatshap/variants.py
(ReadSetReader anatomy: whatshap/variants.py:124-848), reorganized around
a RealignmentConfig object instead of threading a dozen scalar knobs
through every call.
"""

import csv
import logging
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from ._variants import _detect_alleles, _iterate_cigar
from .align import edit_distance, edit_distance_affine_gap, enumerate_all_kmers, kmer_align
from .bam import AlignmentWithSourceID, BamReader, MultiBamReader, SampleBamReader
from .core import Genotype, NumericSampleIds, Read, ReadSet
from .io.sam import AlignedSegment
from .vcf import VcfVariant

logger = logging.getLogger(__name__)

# CIGAR operator codes
_M, _I, _D, _N, _S, _H = 0, 1, 2, 3, 4, 5
_EQ, _X = 7, 8


class ReadSetError(Exception):
    pass


# ---------------------------------------------------------------------------
# alignment identity helpers


def is_alignment_primary(alignment: AlignedSegment) -> bool:
    return not (
        alignment.is_supplementary or alignment.is_secondary or alignment.is_unmapped
    )


def is_alignmentwsid_primary(alignment: AlignmentWithSourceID) -> bool:
    return is_alignment_primary(alignment=alignment.bam_alignment)


# a suffix no genuine read id would end with; marks the primary alignment
PRIMARY_DEFAULT_SUB_ALIGNMENT_ID = "____1"


def get_sub_alignment_id(
    alignment: AlignedSegment,
    is_primary: bool,
    primary_default: Optional[str] = PRIMARY_DEFAULT_SUB_ALIGNMENT_ID,
) -> str:
    """Distinguish the alignment segments of one read: supplementary
    segments are keyed by (CIGAR, flags); the primary gets a fixed tag."""
    if is_primary and primary_default is not None:
        return primary_default
    return str(hash((alignment.cigarstring, alignment.flag)))


def get_sub_alignmentw_id_wsid(
    alignment: AlignmentWithSourceID,
    is_primary: bool,
    primary_default: Optional[str] = PRIMARY_DEFAULT_SUB_ALIGNMENT_ID,
) -> str:
    return get_sub_alignment_id(alignment.bam_alignment, is_primary, primary_default)


# ---------------------------------------------------------------------------
# progress trackers for reference-free CIGAR detection (consumed by
# the _variants module)


@dataclass
class AlleleProgress:
    progress: int = 0
    length: int = 0
    quality: int = 0
    matched: int = 0
    match_target: int = 0
    inserted: int = 0
    insert_target: int = 0
    deleted: int = 0
    delete_target: int = 0


class VariantProgress:
    """Per-variant tracker of how far each candidate allele has been
    confirmed while walking a CIGAR."""

    def __init__(self, variant_id: int):
        self.variant_id = variant_id
        self.query_start = 0
        self.alleles: List[AlleleProgress] = []

    def __iter__(self):
        return iter(self.alleles)

    def __len__(self):
        return len(self.alleles)

    def add_allele(self, matches: int, insertions: int, deletions: int) -> None:
        total = matches + insertions + deletions
        self.alleles.append(
            AlleleProgress(
                length=total,
                match_target=matches,
                insert_target=insertions,
                delete_target=deletions,
            )
        )

    def reset(self, query_start: int) -> None:
        self.query_start = query_start
        for a in self.alleles:
            a.progress = a.matched = a.inserted = a.deleted = a.quality = 0

    def get_resolved(self) -> List[int]:
        return [i for i, a in enumerate(self.alleles) if a.progress == a.length]

    def get_pending(self) -> List[int]:
        return [i for i, a in enumerate(self.alleles) if 0 <= a.progress < a.length]


# ---------------------------------------------------------------------------
# grouped alignments


@dataclass
class AlignedRead:
    read: Read
    is_supplementary: bool
    is_reverse: bool
    reference_start: int
    reference_end: int

    def distance(self, other: "AlignedRead") -> int:
        """Reference-coordinate gap between two alignment spans (0 when
        they touch or overlap)."""
        gap_left = other.reference_start - self.reference_end
        gap_right = self.reference_start - other.reference_end
        return max(0, gap_left, gap_right)


# ---------------------------------------------------------------------------
# realignment configuration


@dataclass
class RealignmentConfig:
    overhang: int = 10
    use_affine: bool = False
    gap_start: int = 10
    gap_extend: int = 7
    default_mismatch: int = 15


@dataclass
class KmeraldConfig:
    costs_path: Optional[str] = None
    kmer_size: int = 7
    gap_penalty: float = 40
    window: int = 25


class _KmeraldState:
    """Cost table plus per-run memo tables for the kmer aligner."""

    def __init__(self, config: KmeraldConfig):
        self.config = config
        self.costs: Dict[Tuple[int, int], str] = {}
        with open(config.costs_path) as handle:
            for row in csv.reader(handle, delimiter="\t"):
                self.costs[(int(row[0]), int(row[1]))] = row[2]
        self.distance_memo: Dict[Tuple[str, str], float] = {}
        self.kmerized: Dict[str, object] = {}

    def kmerize(self, text: str):
        cached = self.kmerized.get(text)
        if cached is None:
            cached = enumerate_all_kmers(str(text).encode("UTF-8"), int(self.config.kmer_size))
            self.kmerized[text] = cached
        return cached

    def distance(self, hap_text: str, query_text: str) -> float:
        key = (hap_text, query_text)
        if key not in self.distance_memo:
            self.distance_memo[key] = kmer_align(
                self.kmerize(hap_text),
                self.kmerize(query_text),
                self.costs,
                self.config.gap_penalty,
            )
        return self.distance_memo[key]


# ---------------------------------------------------------------------------
# CIGAR arithmetic


def _cigar_suffix_from(cigar, i: int, consumed: int):
    """CIGAR elements from split point (element i, consumed bases) to the
    end."""
    op, length = cigar[i]
    if consumed < length:
        yield op, length - consumed
    yield from cigar[i + 1 :]


def _cigar_prefix_to(cigar, i: int, consumed: int):
    """CIGAR elements from the split point back to the start (reversed)."""
    op, length = cigar[i]
    assert consumed <= length
    if consumed > 0:
        yield op, consumed
    for j in range(i - 1, -1, -1):
        yield cigar[j]


def _advance_along_cigar(cigar, reference_bases: int) -> Tuple[int, int]:
    """Walk CIGAR elements until ``reference_bases`` reference bases are
    consumed; return (reference bases actually consumed, query bases
    consumed).  Stops early at the CIGAR end or at an N (reference skip)."""
    ref = query = 0
    for op, length in cigar:
        if op in (_M, _EQ, _X):
            ref += length
            query += length
            if ref >= reference_bases:
                return reference_bases, query - (ref - reference_bases)
        elif op == _D:
            ref += length
            if ref >= reference_bases:
                return reference_bases, query
        elif op == _I:
            query += length
        elif op in (_S, _H):
            pass
        elif op == _N:
            return reference_bases, query
        else:
            raise AssertionError("unknown CIGAR operator")
    assert ref < reference_bases
    return ref, query


# ---------------------------------------------------------------------------
# the reader


class ReadSetReader:
    """Stream alignments for a sample, detect the allele each one carries
    at each covered variant, and group the per-alignment reads (read pairs,
    supplementary parts) into one Read per fragment."""

    def __init__(
        self,
        paths: List[str],
        reference: Optional[str],
        numeric_sample_ids: NumericSampleIds,
        *,
        mapq_threshold: int = 20,
        overhang: int = 10,
        affine: int = False,
        gap_start: int = 10,
        gap_extend: int = 7,
        default_mismatch: int = 15,
        duplicates: bool = False,
        use_kmerald: bool = False,
        kmeralign_costs_path: Optional[str] = None,
        kmer_size: int = 7,
        kmerald_gappenalty: float = 40,
        kmerald_window: int = 25,
        use_supplementary: bool = False,
        supplementary_distance_threshold: int = 100_000,
        allow_supplementary_only_read_groups: bool = False,
    ):
        self._paths = paths
        self._mapq_threshold = mapq_threshold
        self._numeric_sample_ids = numeric_sample_ids
        self._duplicates = duplicates
        self._realign_cfg = RealignmentConfig(
            overhang=overhang,
            use_affine=affine,
            gap_start=gap_start,
            gap_extend=gap_extend,
            default_mismatch=default_mismatch,
        )
        self._use_kmerald = use_kmerald
        self._kmerald_cfg = KmeraldConfig(
            costs_path=kmeralign_costs_path,
            kmer_size=kmer_size,
            gap_penalty=kmerald_gappenalty,
            window=kmerald_window,
        )
        self._use_supplementary = use_supplementary
        self._supplementary_distance_threshold = supplementary_distance_threshold
        self._allow_supplementary_only_read_groups = allow_supplementary_only_read_groups
        self._reader: BamReader
        if len(paths) == 1:
            self._reader = SampleBamReader(paths[0], reference=reference)
        else:
            self._reader = MultiBamReader(paths, reference=reference)

    @property
    def n_paths(self) -> int:
        return len(self._paths)

    def has_reference(self, chromosome) -> bool:
        return self._reader.has_reference(chromosome)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def close(self) -> None:
        self._reader.close()

    # -- top level

    def read(
        self,
        chromosome,
        variants,
        sample,
        reference,
        regions=None,
        restricted_genotypes: Optional[List[Genotype]] = None,
    ) -> ReadSet:
        """Detect alleles for all usable alignments of ``sample`` on
        ``chromosome`` and assemble the grouped ReadSet."""
        if __debug__ and variants:
            position, count = Counter(v.position for v in variants).most_common(1)[0]
            assert count == 1, f"Position {position} occurs more than once in variant list."
        assert restricted_genotypes is None or len(restricted_genotypes) == len(variants)

        alignments = self._usable_alignments(chromosome, sample, regions)
        aligned_reads = self._alignments_to_reads(
            alignments, variants, sample, reference, restricted_genotypes
        )
        readset = ReadSet()
        for group in self._group_reads(
            aligned_reads,
            self._supplementary_distance_threshold,
            allow_supplementary_only_groups=self._allow_supplementary_only_read_groups,
        ):
            readset.add(merge_reads(*group))
        return readset

    def _usable_alignments(self, chromosome, sample, regions=None):
        """Alignments passing the mapq/flag screens."""
        if regions is None:
            regions = [(0, None)]
        for start, end in regions:
            for alignment in self._reader.fetch(
                reference=chromosome, sample=sample, start=start, end=end
            ):
                seg = alignment.bam_alignment
                if seg.mapping_quality < self._mapq_threshold:
                    continue
                if seg.is_secondary or seg.is_unmapped:
                    continue
                if seg.is_supplementary and not self._use_supplementary:
                    continue
                if seg.is_duplicate and not self._duplicates:
                    continue
                yield alignment

    # -- alignment -> Read conversion

    def _alignments_to_reads(
        self,
        alignments,
        variants,
        sample,
        reference,
        restricted_genotypes: Optional[List[Genotype]],
    ) -> Iterator[AlignedRead]:
        """Yield one AlignedRead per alignment that covers >= 1 variant
        with a detectable allele."""
        numeric_sample_id = 0 if sample is None else self._numeric_sample_ids[sample]
        kmerald = _KmeraldState(self._kmerald_cfg) if self._use_kmerald else None

        if reference is not None:
            reference = reference[:]  # plain str for fast slicing
            scan_positions = [v.position for v in variants]
            cigar_walk_state = None
        else:
            normalized = [v.normalized() for v in variants]
            usable_ids = self.detect_non_overlapping_variants(normalized)
            scan_positions = [normalized[j].position for j in usable_ids]
            progress = sorted(
                (self.build_var_progress(normalized, j) for j in usable_ids),
                key=lambda p: p.variant_id,
            )
            cigar_walk_state = (normalized, progress)

        n_supplementary = 0
        cursor = 0  # first variant (by scan position) not left of the current alignment
        for alignment in alignments:
            seg = alignment.bam_alignment
            while cursor < len(scan_positions) and scan_positions[cursor] < seg.reference_start:
                cursor += 1

            read = self._empty_read_for(alignment, numeric_sample_id)
            if cigar_walk_state is not None:
                normalized, progress = cigar_walk_state
                detected = _detect_alleles(normalized, progress, cursor, seg)
            else:
                detected = self._detect_by_realignment(
                    variants, restricted_genotypes, cursor, seg, reference, kmerald
                )
            for j, allele, quality in detected:
                read.add_variant(variants[j].position, allele, quality)

            if read:  # covers at least one detected variant
                n_supplementary += seg.is_supplementary
                yield AlignedRead(
                    read,
                    seg.is_supplementary,
                    seg.is_reverse,
                    seg.reference_start,
                    seg.reference_end,
                )
        logger.info(f"Number of supplementary alignments: {n_supplementary}")

    def _empty_read_for(self, alignment: AlignmentWithSourceID, numeric_sample_id: int) -> Read:
        seg = alignment.bam_alignment
        barcode = seg.get_tag("BX") if seg.has_tag("BX") else ""
        hp = seg.get_tag("HP") if seg.has_tag("HP") else -1
        ps = seg.get_tag("PS") if seg.has_tag("PS") else -1
        try:
            ps = int(ps)
        except ValueError:
            raise ValueError(
                f"Invalid PS tag value ({ps}) in read {seg.query_name}. PS must be an integer."
            )
        primary = is_alignment_primary(seg)
        return Read(
            seg.query_name,
            seg.mapq,
            alignment.source_id,
            numeric_sample_id,
            seg.reference_start,
            barcode,
            hp,
            ps,
            chromosome=seg.reference_name,
            sub_alignment_id=get_sub_alignment_id(seg, is_primary=primary),
            is_supplementary=seg.is_supplementary,
            is_reverse=seg.is_reverse,
            reference_end=seg.reference_end,
        )

    # -- grouping

    @staticmethod
    def _group_reads(
        reads: Iterable[AlignedRead],
        distance_threshold: int,
        allow_supplementary_only_groups: bool = False,
    ) -> Iterator[List[Read]]:
        """Bucket AlignedReads by fragment identity and merge each bucket."""
        buckets: Dict[tuple, List[AlignedRead]] = defaultdict(list)
        for aligned in reads:
            r = aligned.read
            key = (
                r.source_id,
                r.name,
                r.sub_alignment_id if allow_supplementary_only_groups else None,
                r.sample_id,
            )
            buckets[key].append(aligned)

        n_skipped = n_multi = 0
        for group in buckets.values():
            if len(group) > 1:
                n_multi += 1
            merged = ReadSetReader.create_read_from_group(
                group,
                distance_threshold,
                allow_supplementary_only_groups=allow_supplementary_only_groups,
            )
            if merged is None:
                n_skipped += 1
            else:
                yield [merged]
        logger.info(f"Number of non-singleton groups: {n_multi}")
        logger.info(f"Skipped {n_skipped} groups")

    @staticmethod
    def create_read_from_group(
        group: List[AlignedRead],
        distance_threshold: int,
        allow_supplementary_only_groups: bool = False,
    ) -> Optional[Read]:
        """Union the variants of a fragment's alignments (primary +
        nearby same-strand supplementary parts) into one Read; positions
        with conflicting alleles are dropped."""
        if (
            len(group) == 1
            and not group[0].is_supplementary
            and not allow_supplementary_only_groups
            and group[0].read.is_sorted()
        ):
            # Singleton primary (the common case): one alignment cannot
            # conflict with itself and strictly-sorted positions imply no
            # duplicates, so the merge below would rebuild an identical Read.
            return group[0].read
        if len(group) > 1:
            logger.debug(f"Group of read {group[0].read.name!r} has {len(group)} items.")
        primaries = [g for g in group if not g.is_supplementary]
        if len(primaries) > 2:
            logger.warning(
                f"Read name {group[0].read.name!r} has more than two primary alignments."
            )
            return None
        if primaries:
            anchor = primaries[-1]
        elif allow_supplementary_only_groups:
            anchor = group[-1]
        else:
            return None

        chosen: Dict[int, object] = {}
        conflicted = set()
        reference_start = anchor.reference_start
        for aligned in group:
            if aligned.is_supplementary:
                if aligned.is_reverse != anchor.is_reverse:
                    continue
                if anchor.distance(aligned) > distance_threshold:
                    continue
            reference_start = min(reference_start, aligned.reference_start)
            for variant in aligned.read:
                prior = chosen.get(variant.position)
                if prior is None:
                    chosen[variant.position] = variant
                elif prior.allele != variant.allele:
                    conflicted.add(variant.position)

        name = anchor.read.name
        if allow_supplementary_only_groups:
            name += anchor.read.sub_alignment_id
        union = Read(
            name,
            anchor.read.mapqs[0],
            anchor.read.source_id,
            anchor.read.sample_id,
            reference_start,
            anchor.read.BX_tag,
            anchor.read.HP_tag,
            anchor.read.PS_tag,
            chromosome=anchor.read.chromosome,
            sub_alignment_id=anchor.read.sub_alignment_id,
            is_supplementary=anchor.read.is_supplementary,
            is_reverse=anchor.is_reverse,
            reference_end=anchor.reference_end,
        )
        for position, variant in chosen.items():
            if position not in conflicted:
                union.add_variant(variant.position, variant.allele, variant.quality)
        union.sort()
        if len(union) != len(anchor.read):
            logger.debug(
                f"Converted read {anchor.read.name} with {len(anchor.read)} variants"
                f" to read with {len(union)} variants."
            )
        return union

    # -- reference-free helpers

    def detect_non_overlapping_variants(self, variants: List[VcfVariant]) -> List[int]:
        """Indices of variants usable for CIGAR-walk detection: duplicates
        of a position and anything under a deletion span are excluded."""
        conflicting = set()
        seen_positions = set()
        j = 0
        while j < len(variants):
            v = variants[j]
            if v.position in seen_positions:
                conflicting.add(j)
                j += 1
                continue
            seen_positions.add(v.position)
            ref_len = len(v.reference_allele)
            longest_del = max(ref_len - len(alt) for alt in v.get_alt_allele_list())
            if longest_del > 0:
                deletion_end = v.position + ref_len
                if j + 1 < len(variants) and variants[j + 1].position < deletion_end:
                    conflicting.add(j)
                    while j + 1 < len(variants) and variants[j + 1].position < deletion_end:
                        j += 1
                        conflicting.add(j)
            j += 1
        return [j for j in range(len(variants)) if j not in conflicting]

    def build_var_progress(self, variants, j: int) -> VariantProgress:
        """Targets per allele: REF needs ref_len matches; each ALT needs
        min(ref, alt) matches plus the length surplus as insertions or
        deficit as deletions."""
        tracker = VariantProgress(j)
        ref_len = len(variants[j].reference_allele)
        tracker.add_allele(ref_len, 0, 0)
        for alt in variants[j].get_alt_allele_list():
            alt_len = len(alt)
            tracker.add_allele(
                min(ref_len, alt_len), max(0, alt_len - ref_len), max(0, ref_len - alt_len)
            )
        return tracker

    # -- realignment-based detection

    def _detect_by_realignment(
        self,
        variants: List[VcfVariant],
        restricted_genotypes: Optional[List[Genotype]],
        first_index: int,
        seg: AlignedSegment,
        reference: str,
        kmerald: Optional[_KmeraldState],
    ):
        """Yield (variant index, allele, quality) for each covered variant,
        scored by realignment."""
        cigartuples = seg.cigartuples
        if not cigartuples:
            return
        hits = _iterate_cigar(variants, first_index, seg, cigartuples)
        for index, i, consumed, query_pos in hits:
            restricted = restricted_genotypes[index] if restricted_genotypes else None
            allele, quality = self._realign_variant(
                variants[index], restricted, seg, cigartuples, i, consumed, query_pos,
                reference, kmerald,
            )
            if allele is not None and allele <= len(variants[index].get_alt_allele_list()):
                yield (index, allele, quality)

    def _realign_variant(
        self,
        variant: VcfVariant,
        restricted: Optional[Genotype],
        seg: AlignedSegment,
        cigartuples,
        i: int,
        consumed: int,
        query_pos: int,
        reference: str,
        kmerald: Optional[_KmeraldState],
    ):
        """Score the query window around one variant against each padded
        candidate haplotype; return (best allele, quality) or (None, None)
        on a tie."""
        # symbolic ALTs (<DEL>, <DUP>, ...) cannot be realigned
        if any(alt.startswith("<") for alt in variant.get_alt_allele_list()):
            return None, None

        window = kmerald.config.window if kmerald is not None else self._realign_cfg.overhang
        left_ref, left_query = _advance_along_cigar(
            _cigar_prefix_to(cigartuples, i, consumed), int(window)
        )
        right_ref, right_query = _advance_along_cigar(
            _cigar_suffix_from(cigartuples, i, consumed),
            len(variant.reference_allele) + int(window),
        )
        assert variant.position - left_ref >= 0
        assert variant.position + right_ref <= len(reference)

        query = seg.query_sequence[query_pos - left_query : query_pos + right_query]
        pos = variant.position
        left_pad = reference[pos - left_ref : pos]
        right_pad = reference[pos + len(variant.reference_allele) : pos + right_ref]
        ref_hap = reference[pos - left_ref : pos + right_ref]

        if kmerald is not None:
            # kmerald mode is biallelic: REF vs the first ALT
            alt_hap = left_pad + variant.alternative_allele + right_pad
            d_ref = kmerald.distance(ref_hap, query)
            d_alt = kmerald.distance(alt_hap, query)
            if d_ref == d_alt:
                return None, None
            return (0, 30) if d_ref < d_alt else (1, 30)

        haplotypes = [ref_hap] + [left_pad + alt + right_pad for alt in variant.get_alt_allele_list()]
        allowed = None if restricted is None else set(restricted.as_vector())
        cfg = self._realign_cfg
        if cfg.use_affine:
            quals = [cfg.default_mismatch] * len(query)
            scored = [
                (a, edit_distance_affine_gap(query, hap, quals, cfg.gap_start, cfg.gap_extend))
                for a, hap in enumerate(haplotypes)
                if allowed is None or a in allowed
            ]
            scored.sort(key=lambda t: t[1])
            quality = scored[0][1] - scored[1][1] if len(scored) > 1 else scored[0][1]
        else:
            scored = [
                (a, edit_distance(query, hap))
                for a, hap in enumerate(haplotypes)
                if allowed is None or a in allowed
            ]
            scored.sort(key=lambda t: t[1])
            quality = 30

        if len(scored) == 1 or scored[0][1] < scored[1][1]:
            return scored[0][0], quality
        return None, None


# ---------------------------------------------------------------------------
# read merging


def merge_two_reads(read1: Read, read2: Read) -> Read:
    """Interleave the variants of two same-haplotype reads (e.g. the two
    ends of a pair).  At shared positions, equal alleles add their
    qualities; conflicting alleles keep the higher-quality call (read1 on
    ties)."""
    assert read1.is_sorted()
    assert read2.is_sorted()
    if not read2:
        return read1

    merged = Read(
        read1.name,
        read1.mapqs[0],
        read1.source_id,
        read1.sample_id,
        read1.reference_start,
        read1.BX_tag,
        read1.HP_tag,
        read1.PS_tag,
    )
    merged.add_mapq(read2.mapqs[0])

    a, b = list(read1), list(read2)
    ia = ib = 0
    while ia < len(a) or ib < len(b):
        take_a = ib == len(b) or (ia < len(a) and a[ia].position <= b[ib].position)
        take_b = ia == len(a) or (ib < len(b) and b[ib].position <= a[ia].position)
        if take_a and take_b:
            va, vb = a[ia], b[ib]
            if va.allele == vb.allele:
                merged.add_variant(va.position, va.allele, va.quality + vb.quality)
            elif va.quality >= vb.quality:
                merged.add_variant(va.position, va.allele, va.quality)
            else:
                merged.add_variant(vb.position, vb.allele, vb.quality)
            ia += 1
            ib += 1
        elif take_a:
            merged.add_variant(a[ia].position, a[ia].allele, a[ia].quality)
            ia += 1
        else:
            merged.add_variant(b[ib].position, b[ib].allele, b[ib].quality)
            ib += 1
    return merged


def merge_reads(*reads: Read) -> Read:
    """Fold merge_two_reads over any number of reads."""
    if not reads:
        raise ValueError("no reads to merge")
    merged = reads[0]
    assert merged.is_sorted()
    for nxt in reads[1:]:
        merged = merge_two_reads(merged, nxt)
    return merged
