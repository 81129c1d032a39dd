"""
Tag reads by haplotype

Sequencing reads are read from file ALIGNMENTS (in BAM or CRAM format) and tagged reads
are written to stdout.
"""

import hashlib
import logging
import sys
from collections import defaultdict
from contextlib import ExitStack
from dataclasses import dataclass
from enum import Enum
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, TextIO, Tuple, Union

from .. import __version__
from ..core import NumericSampleIds, Read
from ..io import sam as samlib
from ..timer import StageTimer
from ..utils import Region, xopen
from ..variants import (
    PRIMARY_DEFAULT_SUB_ALIGNMENT_ID,
    get_sub_alignment_id,
    is_alignment_primary,
)
from ..vcf import VariantCallPhase, VariantTable, VcfError, VcfInvalidChromosome, VcfReader
from . import CommandLineError, PhasedInputReader, populate_arg_parser

logger = logging.getLogger(__name__)


class SupplementaryHaplotaggingStrategy(Enum):
    SKIP = "skip"
    COPY_PRIMARY = "copy-primary"
    INDEPENDENT_OR_SKIP = "independent-or-skip"
    INDEPENDENT_OR_COPY_PRIMARY = "independent-or-copy-primary"

    def consider_supplementary(self) -> bool:
        return self is not SupplementaryHaplotaggingStrategy.SKIP

    def attempt_to_haplotag_each_supplementary(self) -> bool:
        return self in (
            SupplementaryHaplotaggingStrategy.INDEPENDENT_OR_SKIP,
            SupplementaryHaplotaggingStrategy.INDEPENDENT_OR_COPY_PRIMARY,
        )

    def attempt_to_copy_primary(self) -> bool:
        return self in (
            SupplementaryHaplotaggingStrategy.COPY_PRIMARY,
            SupplementaryHaplotaggingStrategy.INDEPENDENT_OR_COPY_PRIMARY,
        )

    def __str__(self):
        return self.value


HAPLOTAG_ARGUMENTS = [
    (None, [
        (("-o", "--output"), dict(default=sys.stdout,
            help="Output file. If omitted, use standard output.")),
        (("--reference", "-r"), dict(metavar="FASTA",
            help="Reference file. Must be accompanied by .fai index (create with samtools faidx)")),
        ("--no-reference", dict(action="store_true", default=False,
            help="Detect alleles without requiring a reference, at the expense of phasing quality (in particular for long reads)")),
        ("--regions", dict(dest="regions", metavar="REGION", default=None, action="append",
            help="Specify region(s) of interest to limit the tagging to reads/variants overlapping those regions. You can specify a space-separated list of regions in the form of chrom:start-end, chrom (consider entire chromosome), or chrom:start (consider region from this start to end of chromosome).")),
        ("--ignore-linked-read", dict(default=False, action="store_true",
            help="Ignore linkage information stored in BX tags of the reads.")),
        (("--linked-read-distance-cutoff", "-d"), dict(metavar="LINKEDREADDISTANCE", default=50000, type=int,
            help="Assume reads with identical BX tags belong to different read clouds if their distance is larger than LINKEDREADDISTANCE (default: %(default)s).")),
        ("--ignore-read-groups", dict(default=False, action="store_true",
            help="Ignore read groups in BAM/CRAM header and assume all reads come from the same sample.")),
        ("--sample", dict(dest="given_samples", metavar="SAMPLE", default=None, action="append",
            help="Name of a sample to phase. If not given, all samples in the input VCF are phased. Can be used multiple times.")),
        ("--output-haplotag-list", dict(dest="haplotag_list", metavar="HAPLOTAG_LIST", default=None,
            help="Write assignments of read names to haplotypes (tab separated) to given output file. If filename ends in .gz, then output is gzipped.")),
        ("--tag-supplementary", dict(nargs="?", type=SupplementaryHaplotaggingStrategy,
            choices=list(SupplementaryHaplotaggingStrategy),
            default=SupplementaryHaplotaggingStrategy.SKIP,
            const=SupplementaryHaplotaggingStrategy.COPY_PRIMARY,
            dest="supplementary_strategy",
            help="How to tag supplementary alignments. `skip`: do not tag; `copy-primary` or value omitted: tag same as primary; `independent-or-skip`: treat as independent alignment; `independent-or-copy-primary`: treat as independent alignment, but if fails, tag same as primary. \nDefault: skip")),
        ("--supplementary-distance", dict(dest="supplementary_distance_threshold", type=int, default=100_000,
            help="Maximum distance between supplementary alignment record and a primary one for the tag copying onto the supplementary to be attempted.\n(default: 100,000)")),
        ("--no-supplementary-strand-match", dict(action="store_false", dest="supplementary_strand_match", default=True,
            help="Allow for strands missmatch between supplementary and primary alignment records during the tag copying onto the supplementary.")),
        ("--ploidy", dict(metavar="PLOIDY", default=2, type=int, help="Ploidy (default: %(default)s).")),
        ("--skip-missing-contigs", dict(default=False, action="store_true",
            help="Skip reads that map to a contig that does not exist in the VCF")),
        (("--output-threads", "--out-threads"), dict(default=1, type=int,
            help="Number of threads to use for output file writing. For optimal performance, instead pipe output into 'samtools view' to compress.")),
        ("variant_file", dict(metavar="VCF",
            help="VCF file with phased variants (must be gzip-compressed and indexed)")),
        ("alignment_file", dict(metavar="ALIGNMENTS",
            help="BAM/CRAM file with alignments to be tagged by haplotype")),
    ]),
]


def add_arguments(parser):
    populate_arg_parser(parser, HAPLOTAG_ARGUMENTS)


def validate(args, parser):
    if args.reference is not None and args.no_reference:
        parser.error("Options --reference and --no-reference cannot be used together")


# ---------------------------------------------------------------------------
# alignment identity


@dataclass(frozen=True)
class ReadAlignmentRepresentation:
    read_name: str
    chromosome: str
    is_supplementary: bool
    sub_alignment_id: str


@dataclass(frozen=True)
class PrimaryInfo:
    reference_start: int
    reference_end: int
    is_reverse: bool


def read_representation(read: Read, as_primary: bool = False) -> ReadAlignmentRepresentation:
    sub_id = PRIMARY_DEFAULT_SUB_ALIGNMENT_ID if as_primary else read.sub_alignment_id
    name = read.name
    # undo the sub-alignment-id suffix appended during read-set construction
    if name.endswith(sub_id):
        name = name[: -len(read.sub_alignment_id)]
    return ReadAlignmentRepresentation(
        read_name=name,
        chromosome=read.chromosome,
        is_supplementary=False if as_primary else read.is_supplementary,
        sub_alignment_id=sub_id,
    )


def alignment_representation(alignment, as_primary: bool = False) -> ReadAlignmentRepresentation:
    primary = True if as_primary else is_alignment_primary(alignment=alignment)
    return ReadAlignmentRepresentation(
        read_name=alignment.query_name,
        chromosome=alignment.reference_name,
        is_supplementary=not primary,
        sub_alignment_id=get_sub_alignment_id(alignment, is_primary=(as_primary or primary)),
    )


def min_alignment_distance(first_start, first_end, second_start, second_end) -> int:
    a, b = sorted((first_start, first_end))
    c, d = sorted((second_start, second_end))
    # gap between the two intervals, zero when they overlap
    return max(0, a - d, c - b)


# ---------------------------------------------------------------------------
# variant/phase bookkeeping


def md5_of(filename):
    return hashlib.md5(Path(filename).read_bytes()).hexdigest()


def get_variant_information(variant_table: VariantTable, sample: str):
    """(position -> (block id, phase tuple), list of het phased variants)."""
    rows = zip(
        variant_table.variants,
        variant_table.genotypes_of(sample),
        variant_table.phases_of(sample),
    )
    phase_info_at = {}
    het_variants = []
    for variant, gt, phase in rows:
        if getattr(phase, "block_id", None) is None:
            continue
        phase_info_at[variant.position] = (int(phase.block_id), phase.phase)
        if not gt.is_homozygous():
            het_variants.append(variant)
    return phase_info_at, het_variants


def load_chromosome_variants(
    vcf_reader: VcfReader, chromosome: str, regions: Sequence[Tuple[int, Optional[int]]]
) -> VariantTable:
    logger.debug(f"Loading variants from {len(regions)} distinct region(s)")
    try:
        table = vcf_reader.fetch_regions(chromosome, regions)
    except OSError as err:
        logger.error(str(err))
        raise
    logger.debug(f"Loaded {len(table)} variants for chromosome {chromosome} in VCF")
    return table


# ---------------------------------------------------------------------------
# haplotype assignment per read


def prepare_haplotag_information(
    variant_table,
    shared_samples,
    phased_input_reader,
    regions,
    ignore_linked_read,
    linked_read_cutoff,
    ploidy,
    supplementary_strategy: SupplementaryHaplotaggingStrategy = (
        SupplementaryHaplotaggingStrategy.SKIP
    ),
):
    """Vote each read (and its linked-read cloud) onto a haplotype.  The
    vote of a read for haplotype h is the summed quality of its variants
    matching h's allele; the assignment quality is best minus second."""
    n_multiple_phase_sets = 0
    bx_to_haplotype = defaultdict(list)
    read_to_haplotype = {}
    primary_info = {}

    for sample in shared_samples:
        phase_info_at, het_variants = get_variant_information(variant_table, sample)
        read_set, _ = phased_input_reader.read(
            variant_table.chromosome, het_variants, sample, regions=regions
        )

        cloud_of_tag = defaultdict(list)
        if not ignore_linked_read:
            for read in read_set:
                if read.has_BX_tag():
                    cloud_of_tag[read.BX_tag].append(read)

        for read in read_set:
            if not read.is_supplementary:
                key = read_representation(read, as_primary=True)
                primary_info[key] = PrimaryInfo(
                    read.reference_start, read.reference_end, read.is_reverse
                )

        done = set()
        for read in read_set:
            me = read_representation(read, as_primary=False)
            if me in done:
                continue
            done.add(me)

            # pool nearby linked reads sharing this BX tag
            group = {read}
            if not ignore_linked_read and read.has_BX_tag():
                for partner in cloud_of_tag[read.BX_tag]:
                    if read_representation(partner, as_primary=False) in done:
                        continue
                    if abs(read.reference_start - partner.reference_start) <= linked_read_cutoff:
                        group.add(partner)

            # per phaseset: quality votes per haplotype
            votes: Dict[int, List[int]] = defaultdict(lambda: [0] * ploidy)
            for member in group:
                done.add(read_representation(member, as_primary=False))
                for v in member:
                    assert v.allele in (0, 1)
                    phaseset, phasing = phase_info_at[v.position]
                    tally = votes[phaseset]
                    for hap, hap_allele in enumerate(phasing):
                        tally[hap] += v.quality * (v.allele == hap_allele)

            if not votes:
                continue
            ranked = sorted(votes.items(), key=lambda t: max(t[1]), reverse=True)
            if len(ranked) > 1:
                n_multiple_phase_sets += 1
            phaseset, scores = ranked[0]
            by_score = sorted(enumerate(scores), key=lambda t: t[1], reverse=True)
            best_hap, best_score = by_score[0]
            quality = best_score - by_score[1][1]
            if quality == 0:
                continue

            if not ignore_linked_read and read.has_BX_tag():
                bx_to_haplotype[read.BX_tag].append((read.reference_start, best_hap, phaseset))
            for member in group:
                read_to_haplotype[read_representation(member, as_primary=False)] = (
                    best_hap,
                    quality,
                    phaseset,
                )
                logger.debug(
                    f"Assigned read {member.name} to haplotype {best_hap} with a "
                    f"quality of {quality} based on {len(member)} covered variants"
                )
    return bx_to_haplotype, read_to_haplotype, n_multiple_phase_sets, primary_info


def _candidate_representations(
    alignment,
    strategy: SupplementaryHaplotaggingStrategy,
    primary_info: Dict[ReadAlignmentRepresentation, PrimaryInfo],
    strand_match: bool,
    distance_threshold: int,
) -> List[ReadAlignmentRepresentation]:
    """Which haplotype-assignment keys may tag this alignment, in
    preference order: itself first, then its primary (depending on the
    supplementary strategy and distance/strand constraints)."""
    own = alignment_representation(alignment, as_primary=False)
    as_primary = alignment_representation(alignment, as_primary=True)
    if strategy == SupplementaryHaplotaggingStrategy.COPY_PRIMARY:
        candidates = [as_primary]
    elif strategy == SupplementaryHaplotaggingStrategy.INDEPENDENT_OR_SKIP:
        candidates = [own]
    else:
        candidates = [own, as_primary]

    if alignment.is_supplementary and strategy.attempt_to_copy_primary():
        info = primary_info.get(as_primary)
        if info is not None:
            too_far = distance_threshold < min_alignment_distance(
                info.reference_start,
                info.reference_end,
                alignment.reference_start,
                alignment.reference_end,
            )
            if strand_match:
                too_far |= info.is_reverse != alignment.is_reverse
            if too_far:
                candidates.pop()
    return candidates


def attempt_add_phase_information(
    alignment,
    read_to_haplotype,
    bxtag_to_haplotype,
    linked_read_cutoff,
    ignore_linked_read,
    supplementary_strategy: SupplementaryHaplotaggingStrategy = (
        SupplementaryHaplotaggingStrategy.COPY_PRIMARY
    ),
    primary_info_by_repr: Optional[Dict[ReadAlignmentRepresentation, PrimaryInfo]] = None,
    supplementary_strand_match: bool = True,
    supplementary_distance_threshold: int = 100_000,
):
    """Set HP/PC/PS on the alignment if an assignment (direct, via its
    primary, or via its linked-read cloud) exists; returns
    (tagged?, haplotype name, phaseset)."""
    if (
        alignment.is_supplementary
        and supplementary_strategy == SupplementaryHaplotaggingStrategy.SKIP
    ):
        return 0, "none", "none"

    candidates = _candidate_representations(
        alignment,
        supplementary_strategy,
        primary_info_by_repr or {},
        supplementary_strand_match,
        supplementary_distance_threshold,
    )
    def tag_with(haplotype, quality, phaseset):
        for name, value in (("HP", haplotype + 1), ("PC", quality), ("PS", phaseset)):
            alignment.set_tag(name, value)
        return 1, f"H{haplotype + 1}", phaseset

    for candidate in candidates:
        assignment = read_to_haplotype.get(candidate)
        if assignment is not None:
            return tag_with(*assignment)

    # fall back to the linked-read cloud of this BX tag
    if not ignore_linked_read:
        try:
            clouds = bxtag_to_haplotype[alignment.get_tag("BX")]
        except KeyError:
            clouds = []
        for reference_start, haplotype, phaseset in clouds:
            if abs(reference_start - alignment.reference_start) <= linked_read_cutoff:
                return tag_with(haplotype, None, phaseset)
    return 0, "none", "none"


# ---------------------------------------------------------------------------
# input/output setup


def normalize_user_regions(
    user_regions: Optional[Sequence[str]], bam_references: List[str]
) -> Dict[str, List[Tuple[int, Optional[int]]]]:
    """1-based closed user regions -> 0-based half-open, per chromosome;
    no regions means every reference contig in full."""
    regions: Dict[str, List[Tuple[int, Optional[int]]]] = defaultdict(list)
    if user_regions is None:
        for reference in bam_references:
            regions[reference].append((0, None))
        return regions
    known = set(bam_references)
    for spec in user_regions:
        region = Region.parse(spec)
        if region.chromosome not in known:
            raise ValueError(
                f"Requested reference '{region.chromosome}' not found in input BAM/CRAM"
            )
        regions[region.chromosome].append((region.start, region.end))
    return regions


def compute_variant_file_samples_to_use(vcf_samples, user_given_samples, ignore_read_groups):
    """The VCF samples to tag with, validating any user-given restriction."""
    in_vcf = set(vcf_samples)
    if not in_vcf:
        raise VcfError("No samples detected in VCF file; cannot perform haplotagging")
    logger.info(f"Found {len(in_vcf)} sample(s) in input VCF")

    if ignore_read_groups and user_given_samples is None and len(in_vcf) > 1:
        raise ValueError(
            'When setting "--ignore-read-groups" on '
            "a multi-sample VCF, samples to be used must "
            'be specified via the "--sample" parameter.'
        )
    if user_given_samples is None:
        return in_vcf
    unknown = set(user_given_samples) - in_vcf
    if unknown:
        raise VcfError(
            "The following samples were specified via the "
            '"--sample" parameter, but are not part of the '
            "input VCF: {}".format(sorted(unknown))
        )
    chosen = in_vcf & set(user_given_samples)
    logger.info(f"Keeping {len(chosen)} sample(s) for haplo-tagging")
    return chosen


def compute_shared_samples(bam_reader, ignore_read_groups, vcf_samples):
    """Samples present in both the BAM (via @RG SM) and the VCF."""
    read_groups = bam_reader.header.get("RG", [])
    bam_samples = {rg.get("SM", "") for rg in read_groups}
    logger.info(f"Found {len(bam_samples)} sample(s) in BAM file")
    if ignore_read_groups:
        return vcf_samples
    shared = bam_samples & vcf_samples
    if not shared:
        raise ValueError(
            "No common samples between VCF and BAM file detected. "
            'You may restart the analysis setting "--ignore-read-groups" '
            "(if appropriate) to avoid this error."
        )
    if len(shared) < len(bam_samples):
        skipped = " | ".join(sorted(bam_samples - shared))
        logger.warning(
            "Ignoring the following sample(s) for haplo-tagging "
            "because they are not part of the VCF or "
            'were not requested via "--sample": {}'.format(skipped)
        )
    return shared


def open_output_alignment_file(aln_output, reference, vcf_md5, bam_header, threads=1):
    """Open the output BAM with a fresh whatshap PG entry chained into the
    header."""
    entry = {
        "ID": "whatshap",
        "PN": "whatshap",
        "VN": __version__,
        "CL": " ".join(["whatshap"] + sys.argv[1:]),
        "m5": vcf_md5,
    }
    previous = bam_header.get("PG", [])
    taken = {pg["ID"] for pg in previous if pg["ID"].startswith("whatshap")}
    suffix = 1
    while entry["ID"] in taken:
        entry["ID"] = f"whatshap.{suffix}"
        suffix += 1
    bam_header["PG"] = previous + [entry]

    if aln_output is None or aln_output is sys.stdout:
        aln_output = sys.stdout.buffer
    try:
        return samlib.AlignmentFile(
            aln_output,
            mode="wb",
            header=samlib.AlignmentHeader.from_dict(bam_header),
            threads=threads,
        )
    except OSError as err:
        raise CommandLineError(
            f"Error while initializing alignment output file at path: {aln_output}\n{err}"
        )


def open_haplotag_writer(path: str) -> TextIO:
    try:
        writer = xopen(path, mode="wt")
    except OSError as err:
        raise CommandLineError(
            f"Error while initializing haplotag list output at path: {path}\n{err}"
        )
    logger.debug("Writing header line to haplotag list output file")
    print("#readname", "haplotype", "phaseset", "chromosome", sep="\t", file=writer)
    return writer


def ignore_read(alignment, include_supplementary: bool) -> bool:
    """Unmapped/secondary records are never tagged; supplementary only when
    requested."""
    if alignment.is_unmapped or alignment.is_secondary:
        return True
    if alignment.is_supplementary:
        return not include_supplementary
    return False


def contigs_with_alignments(af) -> FrozenSet[str]:
    found = set()
    for contig in af.references:
        if next(af.fetch(contig=contig), None) is not None:
            found.add(contig)
    return frozenset(found)


def _strip_phase_tags(alignment) -> None:
    alignment.set_tag("HP", value=None)
    alignment.set_tag("PC", value=None)
    alignment.set_tag("PS", value=None)


# ---------------------------------------------------------------------------
# entry point


def run_haplotag(
    variant_file, alignment_file, output=None,
    reference: Union[None, bool, str] = False, regions=None,
    ignore_linked_read=False, given_samples=None,
    linked_read_distance_cutoff=50000, ignore_read_groups: bool = False,
    haplotag_list: Optional[str] = None,
    supplementary_strategy=SupplementaryHaplotaggingStrategy.SKIP,
    supplementary_strand_match: bool = True,
    supplementary_distance_threshold: int = 100_000,
    skip_missing_contigs: bool = False, output_threads: int = 1, ploidy: int = 2,
):
    timers = StageTimer()
    timers.start("haplotag-run")

    if output in (None, sys.stdout) and sys.stdout.isatty():
        raise CommandLineError(
            "Refusing to write BAM to the terminal. Either use the '-o' option or redirect "
            "standard output with '>'."
        )
    with ExitStack() as stack:
        timers.start("haplotag-init")

        def managed(resource_factory, what, path):
            try:
                return stack.enter_context(resource_factory())
            except OSError as err:
                raise CommandLineError(f"Error while loading {what} file {path}: {err}")

        vcf = managed(
            lambda: VcfReader(variant_file, only_snvs=False, phases=True, ploidy=ploidy),
            "variant", variant_file,
        )
        use_vcf_samples = compute_variant_file_samples_to_use(
            vcf.samples, given_samples, ignore_read_groups
        )
        aln_reader = managed(
            lambda: samlib.AlignmentFile(
                alignment_file,
                reference_filename=reference if reference else None,
                require_index=True,
            ),
            "alignment", alignment_file,
        )
        shared_samples = compute_shared_samples(aln_reader, ignore_read_groups, use_vcf_samples)

        user_regions = normalize_user_regions(regions, aln_reader.references)
        include_unmapped = regions is None

        phased_input_reader = stack.enter_context(
            PhasedInputReader(
                [alignment_file],
                None if reference is False else reference,
                NumericSampleIds(),
                ignore_read_groups,
                only_snvs=False,
                duplicates=True,
                use_supplementary=supplementary_strategy.consider_supplementary(),
                allow_supplementary_only_read_groups=(
                    supplementary_strategy.attempt_to_haplotag_each_supplementary()
                ),
            )
        )
        if phased_input_reader.has_alignments and reference is None:
            raise CommandLineError(
                "A reference FASTA needs to be provided with -r/--reference; "
                "or use --no-reference at the expense of phasing quality."
            )

        aln_writer = stack.enter_context(
            open_output_alignment_file(
                output, reference, md5_of(variant_file),
                aln_reader.header.to_dict(), threads=output_threads,
            )
        )
        haplotag_writer = None
        if haplotag_list is not None:
            haplotag_writer = stack.enter_context(open_haplotag_writer(haplotag_list))

        timers.stop("haplotag-init")
        timers.start("haplotag-process")

        n_alignments = n_tagged = n_multiple_phase_sets = 0
        has_alignments = contigs_with_alignments(aln_reader)
        want_supplementary = supplementary_strategy.consider_supplementary()

        for chrom, chrom_regions in user_regions.items():
            logger.debug(f"Processing chromosome {chrom}")
            if chrom not in has_alignments:
                # BAM header may list contigs the VCF knows nothing about
                continue
            try:
                variant_table = load_chromosome_variants(vcf, chrom, chrom_regions)
            except VcfInvalidChromosome:
                if skip_missing_contigs:
                    logger.info(
                        f"Skipping reads on '{chrom}' because the contig does not exist in the VCF"
                    )
                    continue
                raise CommandLineError(
                    f"Input BAM/CRAM contains reads on contig '{chrom}', but that contig does "
                    "not exist in the VCF header. To bypass this check, use "
                    "--skip-missing-contigs"
                )
            except VcfError as e:
                raise CommandLineError(str(e))

            if variant_table is not None:
                logger.debug("Preparing haplotype information")
                prepared = prepare_haplotag_information(
                    variant_table, shared_samples, phased_input_reader, chrom_regions,
                    ignore_linked_read, linked_read_distance_cutoff, ploidy,
                    supplementary_strategy=supplementary_strategy,
                )
                bx_to_haplotype, read_to_haplotype, n_mult, primary_info = prepared
                n_multiple_phase_sets += n_mult
            else:
                bx_to_haplotype = read_to_haplotype = None
                primary_info = {}

            assert not include_unmapped or len(chrom_regions) == 1
            for start, end in chrom_regions:
                logger.debug("Working on %s:%s-%s", chrom, start, end)
                for alignment in aln_reader.fetch(contig=chrom, start=start, stop=end):
                    n_alignments += 1
                    haplotype_name = "none"
                    phaseset = "none"
                    skip = variant_table is None or ignore_read(
                        alignment, include_supplementary=want_supplementary
                    )
                    if skip:
                        _strip_phase_tags(alignment)
                    else:
                        is_tagged, haplotype_name, phaseset = attempt_add_phase_information(
                            alignment, read_to_haplotype, bx_to_haplotype,
                            linked_read_distance_cutoff, ignore_linked_read,
                            supplementary_strategy=supplementary_strategy,
                            primary_info_by_repr=primary_info,
                            supplementary_strand_match=supplementary_strand_match,
                            supplementary_distance_threshold=supplementary_distance_threshold,
                        )
                        n_tagged += is_tagged
                        if not is_tagged:
                            _strip_phase_tags(alignment)

                    aln_writer.write(alignment)
                    list_this = haplotag_writer is not None and not (
                        alignment.is_secondary
                        or (alignment.is_supplementary and not want_supplementary)
                    )
                    if list_this:
                        row = (alignment.query_name, haplotype_name, phaseset, chrom)
                        print(*row, sep="\t", file=haplotag_writer)
                    if n_alignments % 100_000 == 0:
                        logger.debug(f"Processed {n_alignments} alignment records.")

        if include_unmapped:
            logger.debug("Copying unmapped reads to output")
            for alignment in aln_reader.fetch(contig="*"):
                aln_writer.write(alignment)
        timers.stop("haplotag-process")

    timers.stop("haplotag-run")
    logger.info("\n== SUMMARY ==")
    for label, count in (
        ("Total alignments processed:", n_alignments),
        ("Alignments that could be tagged:", n_tagged),
        ("Alignments spanning multiple phase sets:", n_multiple_phase_sets),
    ):
        logger.info("%-40s %12d", label, count)
    logger.info("Finished in %.1f s", timers.elapsed("haplotag-run"))


def main(args):
    if args.no_reference:
        args.reference = False
    del args.no_reference
    run_haplotag(**vars(args))
