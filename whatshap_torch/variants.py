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
# native CIGAR engine glue


def _pack_detect_state(native_cigar, normalized, progress):
    """Flatten the reference-free detection metadata for the C++ engine
    (csrc/host/cigarlib.cpp): per usable variant its position/id/REF length,
    per allele the match/insert/delete targets and base string."""
    positions, variant_ids, ref_lens = [], [], []
    allele_off, match_t, insert_t, delete_t = [0], [], [], []
    seq_off, chunks = [0], []
    total = 0
    for tracker in progress:
        v = normalized[tracker.variant_id]
        positions.append(v.position)
        variant_ids.append(tracker.variant_id)
        ref_lens.append(len(v.reference_allele))
        for i, a in enumerate(tracker.alleles):
            match_t.append(a.match_target)
            insert_t.append(a.insert_target)
            delete_t.append(a.delete_target)
            seq = v.get_allele(i).encode()
            chunks.append(seq)
            total += len(seq)
            seq_off.append(total)
        allele_off.append(len(match_t))
    return dict(
        prog_positions=native_cigar._i64(positions),
        prog_variant_id=native_cigar._i32(variant_ids),
        prog_ref_len=native_cigar._i32(ref_lens),
        allele_off=native_cigar._i32(allele_off),
        match_t=native_cigar._i32(match_t),
        insert_t=native_cigar._i32(insert_t),
        delete_t=native_cigar._i32(delete_t),
        seq_off=native_cigar._i32(seq_off),
        allele_seq=b"".join(chunks),
    )


def _detect_alleles_native(native_cigar, state, first, seg):
    ops = native_cigar._i32([op for op, _ in seg.cigartuples])
    lens = native_cigar._i32([ln for _, ln in seg.cigartuples])
    result = native_cigar.detect_alleles(
        state["prog_positions"],
        state["prog_variant_id"],
        state["prog_ref_len"],
        state["allele_off"],
        state["match_t"],
        state["insert_t"],
        state["delete_t"],
        state["seq_off"],
        state["allele_seq"],
        first,
        seg.reference_start,
        ops,
        lens,
        seg.query_sequence,
        seg.query_qualities,
    )
    assert result is not None
    return result


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

        fast = self._read_pool_fast(
            chromosome, variants, sample, reference, regions, restricted_genotypes
        )
        if fast is not None:
            return fast

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

    def _read_pool_fast(
        self, chromosome, variants, sample, reference, regions, restricted_genotypes
    ) -> Optional[ReadSet]:
        """Whole-chromosome batched read path: filtering, CIGAR/sequence
        decode and realignment for EVERY record of the native BAM pool in
        one threaded C++ call (csrc/host/cigarlib.cpp wh_realign_pool), then
        bulk Read construction from the packed hit arrays.

        Covers the default realign mode on a single plain BAM; anything
        else (regions, kmerald, CIGAR-only detection, supplementary
        grouping, CRAM/SAM, multi-BAM) returns None and takes the
        per-alignment path.  Records the native pass cannot reproduce
        exactly (symbolic ALTs in range, odd tag types, missing sequence)
        come back with status -2 and are re-processed one by one through
        the identical Python fallback, preserving record order."""
        if (
            regions is not None
            or reference is None
            or self._use_kmerald
            or restricted_genotypes is not None
            or self._use_supplementary
            or self._allow_supplementary_only_read_groups
            or not variants
        ):
            return None
        from .hostlib import cigarlib as native_cigar

        if native_cigar is None:
            return None
        reader = self._reader
        if not isinstance(reader, SampleBamReader):
            return None
        samfile = reader._samfile
        if getattr(samfile, "_mode", None) != "bam":
            return None
        native = samfile._native_pool()
        if native is None:
            return None
        from .bam import ReferenceNotFoundError, SampleNotFoundError

        if not reader.has_reference(chromosome):
            raise ReferenceNotFoundError(chromosome)
        rg_ids = None
        if sample is not None:
            if not reader.has_sample(sample):
                raise SampleNotFoundError()
            rg_ids = sorted(reader._groups_of[sample])
        tid = samfile.header.get_reference_id(chromosome)
        if tid is None or tid < 0:
            raise ReferenceNotFoundError(chromosome)

        import numpy as np

        pool, offsets = native
        reference = reference[:]  # plain str
        self._native_cigar = native_cigar
        # per-(variant list, chromosome) table cache: a trio reads the same
        # chromosome three times (one call per sample) with one variant list
        vpos = np.asarray([v.position for v in variants], dtype=np.int64)
        cache_key = (id(variants), len(variants), int(vpos[0]), int(vpos[-1]))
        cached = getattr(self, "_pool_tables_cache", None)
        if cached is not None and cached[0] == cache_key:
            self._native_positions, tables = cached[1], cached[2]
            self._native_realign = tables
        else:
            import ctypes as _ct

            self._native_positions = (_ct.c_int64 * len(vpos)).from_buffer_copy(
                vpos.tobytes()
            )
            tables = self._native_realign = self._build_native_realign_tables(
                variants, reference, native_cigar
            )
            self._pool_tables_cache = (cache_key, self._native_positions, tables)
        res = native_cigar.realign_pool(
            pool, offsets, tid, self._mapq_threshold, self._duplicates,
            rg_ids, self._native_positions, len(variants),
            tables["ref_lens"], tables["alt_off"], tables["alt_seq_off"],
            tables["alt_seq"], tables["skip"], tables["reference"],
            int(self._realign_cfg.overhang),
            use_affine=self._realign_cfg.use_affine,
            default_mismatch=int(self._realign_cfg.default_mismatch),
            gap_start=int(self._realign_cfg.gap_start),
            gap_extend=int(self._realign_cfg.gap_extend),
        )
        if res is None:
            return None

        numeric_sample_id = 0 if sample is None else self._numeric_sample_ids[sample]
        status = res["status"]
        hit_off = res["hit_off"]
        hv, ha, hq = res["hit_var"], res["hit_allele"], res["hit_qual"]
        flags = res["flag"]
        mapqs = res["mapq"]
        hps = res["hp"]
        pss = res["ps"]
        starts = res["ref_start"]
        ends = res["ref_end"]
        name_off = res["name_off"]
        name_len = res["name_len"]
        bx_off = res["bx_off"]
        bx_len = res["bx_len"]

        def aligned_reads():
            # yields (AlignedRead, known_sorted): batch-constructed reads
            # have strictly ascending positions by construction (the CIGAR
            # walk emits each variant once, in order), so the singleton
            # grouping shortcut can skip the is_sorted() re-check
            from .io.sam import parse_bam_record

            for r in np.nonzero(status != -1)[0].tolist():
                st = int(status[r])
                if st == -2:
                    # exact Python fallback for this record (same screens,
                    # tag handling and per-variant detection as the
                    # per-alignment path)
                    seg = parse_bam_record(
                        pool[offsets[r] : offsets[r + 1]], samfile.header
                    )
                    if (
                        seg.mapping_quality < self._mapq_threshold
                        or seg.is_secondary
                        or seg.is_unmapped
                        or seg.is_supplementary
                        or (seg.is_duplicate and not self._duplicates)
                    ):
                        continue
                    if rg_ids is not None and not (
                        seg.has_tag("RG") and seg.get_tag("RG") in rg_ids
                    ):
                        continue
                    aln = AlignmentWithSourceID(reader.source_id, seg)
                    read = self._empty_read_for(aln, numeric_sample_id)
                    cursor = int(np.searchsorted(vpos, seg.reference_start))
                    for j, allele, quality in self._detect_by_realignment(
                        variants, None, cursor, seg, reference, None
                    ):
                        read.add_variant(variants[j].position, allele, quality)
                    if read:
                        yield AlignedRead(
                            read,
                            seg.is_supplementary,
                            seg.is_reverse,
                            seg.reference_start,
                            seg.reference_end,
                        ), False
                    continue
                if st == 0:
                    continue  # covers no detectable variant
                no = int(name_off[r])
                read = Read(
                    pool[no : no + int(name_len[r])].decode(),
                    int(mapqs[r]),
                    reader.source_id,
                    numeric_sample_id,
                    int(starts[r]),
                    pool[int(bx_off[r]) : int(bx_off[r]) + int(bx_len[r])].decode()
                    if bx_off[r] >= 0
                    else "",
                    int(hps[r]),
                    int(pss[r]),
                    chromosome=chromosome,
                    sub_alignment_id=PRIMARY_DEFAULT_SUB_ALIGNMENT_ID,
                    is_supplementary=False,
                    is_reverse=bool(flags[r] & 0x10),
                    reference_end=int(ends[r]),
                )
                a, b = int(hit_off[r]), int(hit_off[r + 1])
                read._positions = vpos[hv[a:b]].tolist()
                read._alleles = ha[a:b].tolist()
                read._qualities = hq[a:b].tolist()
                yield AlignedRead(
                    read, False, bool(flags[r] & 0x10), int(starts[r]), int(ends[r])
                ), True

        # inline fragment grouping, semantics of _group_reads +
        # merge_reads: singleton sorted primaries (the vast majority) go
        # straight into the set; only real multi-part fragments pay the
        # merge machinery
        buckets: Dict[tuple, List[tuple]] = {}
        readset = ReadSet()
        for aligned, known_sorted in aligned_reads():
            rd = aligned.read
            key = (rd.source_id, rd.name, None, rd.sample_id)
            if key in buckets:
                buckets[key].append((aligned, known_sorted))
            else:
                buckets[key] = [(aligned, known_sorted)]
                # optimistic placement: most fragments are singletons, so
                # reserve the slot now to keep record order; multi-part
                # groups resolve in a second pass below
                readset._add_owned(rd)

        n_multi = n_skipped = 0
        needs_fix = []
        for key, group in buckets.items():
            first_aligned, first_sorted = group[0]
            if len(group) == 1:
                if not first_aligned.is_supplementary and (
                    first_sorted or first_aligned.read.is_sorted()
                ):
                    continue  # already placed
                merged = ReadSetReader.create_read_from_group(
                    [first_aligned],
                    self._supplementary_distance_threshold,
                    allow_supplementary_only_groups=False,
                )
            else:
                n_multi += 1
                merged = ReadSetReader.create_read_from_group(
                    [a for a, _ in group],
                    self._supplementary_distance_threshold,
                    allow_supplementary_only_groups=False,
                )
            if merged is None:
                n_skipped += 1
            needs_fix.append((first_aligned.read, merged))
        if needs_fix:
            replacement = {id(rd): merged for rd, merged in needs_fix}
            readset_reads = [
                replacement.get(id(rd), rd) for rd in readset._reads
            ]
            readset = ReadSet()
            for rd in readset_reads:
                if rd is not None:
                    readset._add_owned(rd)
        logger.info("Number of supplementary alignments: 0")
        logger.info(f"Number of non-singleton groups: {n_multi}")
        logger.info(f"Skipped {n_skipped} groups")
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

    @staticmethod
    def _build_native_realign_tables(variants, reference: str, native_cigar):
        """Flattened per-variant tables consumed by the native realignment
        engines (wh_realign_read / wh_realign_pool): REF lengths, ALT
        sequences concatenated with offset vectors, and the symbolic-ALT
        skip mask that routes a variant to the Python path."""
        import ctypes as _ct

        import numpy as np

        def _i32_arr(xs):
            a = np.asarray(xs, dtype=np.int32)
            buf = a.tobytes()
            return (_ct.c_int32 * max(len(a), 1)).from_buffer_copy(
                buf if buf else b"\x00\x00\x00\x00"
            )

        alt_off = [0]
        alt_seqs: List[str] = []
        skip = bytearray()
        for v in variants:
            alts = v.get_alt_allele_list()
            symbolic = any(a.startswith("<") for a in alts)
            skip.append(1 if symbolic else 0)
            if symbolic:
                alt_off.append(alt_off[-1])
            else:
                alt_seqs.extend(alts)
                alt_off.append(alt_off[-1] + len(alts))
        alt_seq_off = np.zeros(len(alt_seqs) + 1, dtype=np.int32)
        np.cumsum(
            np.fromiter((len(a) for a in alt_seqs), np.int32, len(alt_seqs)),
            out=alt_seq_off[1:],
        )
        return dict(
            ref_lens=_i32_arr([len(v.reference_allele) for v in variants]),
            alt_off=_i32_arr(alt_off),
            alt_seq_off=_i32_arr(alt_seq_off),
            alt_seq="".join(alt_seqs).encode(),
            skip=(_ct.c_uint8 * max(len(skip), 1)).from_buffer_copy(
                bytes(skip) if skip else b"\x00"
            ),
            reference=reference.encode(),
        )

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

        from .hostlib import cigarlib as native_cigar

        if reference is not None:
            reference = reference[:]  # plain str for fast slicing
            scan_positions = [v.position for v in variants]
            cigar_walk_state = None
            self._native_positions = (
                native_cigar._i64([v.position for v in variants]) if native_cigar else None
            )
            self._native_cigar = native_cigar
            # Batched native realignment (one engine call per read) covers
            # the default mode exactly; affine/kmerald/restricted modes and
            # symbolic-ALT variants keep the per-variant Python path.
            self._native_realign = None
            if (
                native_cigar is not None
                and self._native_positions is not None
                and kmerald is None
                and restricted_genotypes is None
            ):
                self._native_realign = self._build_native_realign_tables(
                    variants, reference, native_cigar
                )
        else:
            self._native_realign = None
            normalized = [v.normalized() for v in variants]
            usable_ids = self.detect_non_overlapping_variants(normalized)
            scan_positions = [normalized[j].position for j in usable_ids]
            progress = sorted(
                (self.build_var_progress(normalized, j) for j in usable_ids),
                key=lambda p: p.variant_id,
            )
            cigar_walk_state = (normalized, progress)
            native_detect_state = (
                _pack_detect_state(native_cigar, normalized, progress) if native_cigar else None
            )

        n_supplementary = 0
        cursor = 0  # first variant (by scan position) not left of the current alignment
        for alignment in alignments:
            seg = alignment.bam_alignment
            while cursor < len(scan_positions) and scan_positions[cursor] < seg.reference_start:
                cursor += 1

            read = self._empty_read_for(alignment, numeric_sample_id)
            if cigar_walk_state is not None:
                normalized, progress = cigar_walk_state
                if native_detect_state is not None and seg.cigartuples:
                    detected = _detect_alleles_native(
                        native_cigar, native_detect_state, cursor, seg
                    )
                else:
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
        native_cigar = getattr(self, "_native_cigar", None)
        nr = getattr(self, "_native_realign", None)
        if (
            nr is not None
            and native_cigar is not None
            and seg.query_sequence is not None
        ):
            results = native_cigar.realign_read(
                self._native_positions,
                len(variants),
                first_index,
                nr["ref_lens"],
                nr["alt_off"],
                nr["alt_seq_off"],
                nr["alt_seq"],
                nr["skip"],
                nr["reference"],
                seg.reference_start,
                native_cigar._i32([op for op, _ in cigartuples]),
                native_cigar._i32([ln for _, ln in cigartuples]),
                seg.query_sequence,
                int(self._realign_cfg.overhang),
                use_affine=self._realign_cfg.use_affine,
                default_mismatch=int(self._realign_cfg.default_mismatch),
                gap_start=int(self._realign_cfg.gap_start),
                gap_extend=int(self._realign_cfg.gap_extend),
            )
            if all(allele != -2 for _, allele, _ in results):
                for index, allele, quality in results:
                    if allele < 0:  # tie: variant skipped
                        continue
                    if allele <= len(variants[index].get_alt_allele_list()):
                        yield (index, allele, quality)
                return
            # rare exact-fallback (symbolic ALT / reference-bound corner):
            # use the per-variant Python path for the whole read
        if native_cigar is not None and getattr(self, "_native_positions", None) is not None:
            hits = native_cigar.iterate_cigar(
                self._native_positions,
                first_index,
                seg.reference_start,
                native_cigar._i32([op for op, _ in cigartuples]),
                native_cigar._i32([ln for _, ln in cigartuples]),
            )
        else:
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
