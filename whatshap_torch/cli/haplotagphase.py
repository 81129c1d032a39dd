"""
Phase variants in VCF based on information from haplotagged reads
"""

import itertools
import logging
import sys
from collections import defaultdict
from contextlib import ExitStack
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .. import __version__
from ..core import NumericSampleIds, Variant
from ..timer import StageTimer
from ..utils import ChromosomeFilter, IndexedFasta
from ..vcf import PhasedVcfWriter, VariantCallPhase, VcfError, VcfReader, VcfVariant
from . import (
    CommandLineError,
    PhasedInputReader,
    log_memory_usage,
    populate_arg_parser,
    raise_if_any_sample_not_in_vcf,
)

logger = logging.getLogger(__name__)


HAPLOTAGPHASE_ARGUMENTS = [
    (None, [
        (("-o", "--output"), dict(default=sys.stdout,
            help="Output file. If omitted, use standard output.")),
        (("--reference", "-r"), dict(metavar="FASTA",
            help="Reference file. Must be accompanied by .fai index (create with samtools faidx)")),
        (("--gap-threshold", "-g"), dict(metavar="PERCENT", default=70, type=int,
            help="Threshold percentage for qualities. If the percentage of votes for the variant is less than this value, the algorithm does not assign any information to the variant.")),
        (("--cut-poly", "-c"), dict(metavar="LENGTH", default=10, type=int,
            help="Ignore variants within homopolymers longer than the cut value.")),
        (("--only-indels", "-i"), dict(default=False, action="store_true",
            help="Add phasing information only to indels.")),
        ("--sample", dict(dest="samples", metavar="SAMPLE", default=[], action="append",
            help="Name of a sample to phase. If not given, all samples in the input VCF are phased. Can be used multiple times.")),
        ("--ignore-read-groups", dict(default=False, action="store_true",
            help="Ignore read groups in BAM/CRAM header and assume all reads come from the same sample.")),
        ("--chromosome", dict(dest="chromosomes", metavar="CHROMOSOME", default=[], action="append",
            help="Name of chromosome to phase. If not given, all chromosomes in the input VCF are phased. Can be used multiple times.")),
        ("--no-mav", dict(dest="mav", default=True, action="store_false",
            help="Ignore multiallelic variants.")),
        ("--exclude-chromosome", dict(dest="excluded_chromosomes", default=[], action="append",
            help="Name of chromosome not to phase.")),
        ("variant_file", dict(metavar="VCF",
            help="VCF file with variants to phase (must be gzip-compressed and indexed)")),
        ("alignment_file", dict(metavar="ALIGNMENTS",
            help="BAM/CRAM file with alignments tagged by haplotype and phase set")),
    ]),
]


def add_arguments(parser):
    populate_arg_parser(parser, HAPLOTAGPHASE_ARGUMENTS)


# ---------------------------------------------------------------------------
# vote accumulation


def compute_votes(
    is_homozygous: Dict[int, bool], reads, allele_to_id: Dict[int, Dict[int, int]]
) -> Dict[int, Dict[Tuple[int, int], int]]:
    """Per het position, per (phase set, haplotype-0 allele id): summed
    quality of read evidence.  A read tagged (PS, HP) voting allele a at a
    position contributes to (PS, HP xor allele-id(a))."""
    votes: Dict[int, Dict[Tuple[int, int], int]] = {}
    n_bad_hp = 0
    for read in reads:
        phase_set, haplotype = read.PS_tag - 1, read.HP_tag - 1
        if min(haplotype, phase_set) < 0:
            continue
        if haplotype > 1:
            n_bad_hp += 1
            continue
        for variant in read:
            pos = variant.position
            if is_homozygous[pos]:
                continue
            site = votes.setdefault(pos, {(phase_set, 0): 0, (phase_set, 1): 0})
            if (phase_set, 0) not in site:
                site.update({(phase_set, 0): 0, (phase_set, 1): 0})
            site[phase_set, haplotype ^ allele_to_id[pos][variant.allele]] += variant.quality
    if n_bad_hp > 0:
        logger.warning(
            f"{n_bad_hp} reads were skipped due incorrect HP. "
            "The haplotagphase command supports only a diploid input"
        )
    return votes


def best_candidate(var: Dict[Tuple[int, int], int]) -> Tuple[int, int, float, int]:
    """The top-voted (phase set, allele) with its vote share; insertion
    order breaks ties.

    Examples:
        >>> best_candidate({(1, 2): 50, (2, 3): 100, (3, 4): 75})
        (3, 2, 0.4444444444444444, 100)
        >>> best_candidate({(1, 1): 10, (2, 2): 20, (3, 3): 30, (4, 4): 40})
        (4, 4, 0.4, 40)
        >>> best_candidate({(0, 0): 2})
        (0, 0, 1.0, 2)
        >>> best_candidate({(1, 2): 100, (2, 2): 100, (3, 3): 100})
        (2, 1, 0.3333333333333333, 100)
        >>> best_candidate({(5, 5): 200, (6, 6): 300, (7, 7): 500})
        (7, 7, 0.5, 500)
    """
    (phase_set, allele), score = max(var.items(), key=lambda item: item[1])
    return allele, phase_set, score / sum(var.values()), score


def length_of_homopolymer(ref, start: int, step: int, threshold: int) -> int:
    """Homopolymer run length at `start` walking in direction `step`,
    capped at `threshold`.

    Examples:
        >>> length_of_homopolymer("AAABBBCCC", 0, 1, 10)
        3
        >>> length_of_homopolymer("AAABBBCCC", 2, -1, 10)
        3
        >>> length_of_homopolymer("AAABBBCCC", 3, 1, 2)
        2
        >>> length_of_homopolymer("A", 0, 1, 1)
        1
        >>> length_of_homopolymer("AABBBCCCC", 5, 1, 5)
        4
        >>> length_of_homopolymer("", 0, 1, 10)
        0
    """
    run = 0
    for i in itertools.count(start, step):
        if run >= threshold or not (0 <= i < len(ref)) or ref[i] != ref[start]:
            break
        run += 1
    return run


def consensus(
    only_indels: bool,
    gap_threshold: int,
    cut_homopolymers: int,
    refseq,
    variant_at: Dict[int, VcfVariant],
    phase_at: Dict[int, Optional[VariantCallPhase]],
    votes: Dict[int, Dict[Tuple[int, int], int]],
    id_to_allele: Dict[int, Dict[int, int]],
):
    """Turn per-position votes into the two superreads.  Variants that
    were not already phased must clear the vote-share threshold and the
    indel-only / homopolymer screens."""

    def in_long_homopolymer(pos: int) -> bool:
        if cut_homopolymers <= 0:
            return False
        longest = max(
            length_of_homopolymer(refseq, pos + 1, 1, cut_homopolymers),
            length_of_homopolymer(refseq, pos, -1, cut_homopolymers),
        )
        return longest > cut_homopolymers

    super_reads: List[List[Variant]] = [[], []]
    components = {}

    for pos, site_votes in votes.items():
        allele, phase_set, share, score = best_candidate(site_votes)
        components[pos] = phase_set
        if phase_at[pos] is None:
            screened_out = (
                100 * share < gap_threshold
                or (only_indels and variant_at[pos].is_snv())
                or in_long_homopolymer(pos)
            )
            if screened_out:
                continue
        alleles_at = id_to_allele[pos]
        for hap in (0, 1):
            super_reads[hap].append(
                Variant(pos, allele=alleles_at[allele ^ hap], quality=score)
            )

    for read in super_reads:
        read.sort(key=lambda v: v.position)
    return super_reads, components


# ---------------------------------------------------------------------------
# entry point


def run_haplotagphase(
    variant_file,
    alignment_file,
    output=None,
    samples: Optional[Sequence[str]] = None,
    reference: Union[None, bool, str] = False,
    ignore_read_groups: bool = False,
    only_indels: bool = False,
    chromosomes: Optional[List[str]] = None,
    excluded_chromosomes: Optional[List[str]] = None,
    gap_threshold: int = 70,
    cut_poly: int = 10,
    write_command_line_header: bool = True,
    mav: bool = True,
    tag: str = "PS",
):
    if samples is None:
        samples = []
    if reference is None:
        raise CommandLineError("Option --reference should be specified")
    timers = StageTimer()
    timers.start("haplotagphase-run")
    command_line = (
        "(whatshap {}) {}".format(__version__, " ".join(sys.argv[1:]))
        if write_command_line_header
        else None
    )
    with ExitStack() as stack:
        bam_reader = stack.enter_context(
            PhasedInputReader(
                [alignment_file],
                None if reference is False else reference,
                NumericSampleIds(),
                ignore_read_groups,
                only_snvs=False,
            )
        )
        try:
            writer = stack.enter_context(
                PhasedVcfWriter(
                    command_line=command_line,
                    in_path=variant_file,
                    out_file=output,
                    tag=tag,
                    mav=mav,
                )
            )
        except (OSError, VcfError) as e:
            raise CommandLineError(e)

        reader = stack.enter_context(VcfReader(variant_file, phases=True, mav=mav))
        if ignore_read_groups and not samples and len(reader.samples) > 1:
            raise CommandLineError(
                "When using --ignore-read-groups on a VCF with "
                "multiple samples, --sample must also be used."
            )
        if not samples:
            samples = reader.samples
        raise_if_any_sample_not_in_vcf(reader, samples)

        with timers("read-fasta"):
            fasta = stack.enter_context(IndexedFasta(reference))

        wanted = ChromosomeFilter(chromosomes, excluded_chromosomes)
        for variant_table in timers.iterate("parse-vcf", reader):
            chromosome = variant_table.chromosome
            refseq = fasta[chromosome]
            logger.info(f"Processing chromosome {chromosome}...")
            if chromosome not in wanted:
                logger.info(f"Leaving chromosome {chromosome} unchanged")
                with timers("write-vcf"):
                    writer.write_unchanged(chromosome)
                continue

            superreads_of, components_of = {}, {}
            for sample in reader.samples:
                logger.info(f"Processing sample {sample}")
                genotypes = variant_table.genotypes_of(sample)
                with timers("read-bam"):
                    reads, _ = bam_reader.read(
                        chromosome, variant_table.variants, sample, restricted_genotypes=genotypes
                    )
                phases = variant_table.phases_of(sample)
                if sample not in samples:
                    logger.info(f"Skipping sample {sample}")
                    continue

                # per-position lookups: genotype alleles <-> 0/1 ids,
                # homozygosity, existing phase, variant object
                allele_to_id: Dict[int, Dict[int, int]] = defaultdict(dict)
                id_to_allele: Dict[int, Dict[int, int]] = defaultdict(dict)
                homozygous: Dict[int, bool] = {}
                phased_at: Dict[int, Optional[VariantCallPhase]] = {}
                variant_at: Dict[int, VcfVariant] = {}
                n_hom = n_phased = 0
                for variant, phase, genotype in zip(variant_table.variants, phases, genotypes):
                    for i, a in enumerate(genotype.as_vector()):
                        allele_to_id[variant.position][a] = i
                        id_to_allele[variant.position][i] = a
                    homozygous[variant.position] = genotype.is_homozygous()
                    phased_at[variant.position] = phase
                    variant_at[variant.position] = variant
                    n_phased += phase is not None
                    n_hom += genotype.is_homozygous()
                logger.info(f"Number of homozygous variants is {n_hom}")
                logger.info(f"Number of already phased variants is {n_phased}")

                with timers("compute-votes"):
                    votes = compute_votes(homozygous, reads, allele_to_id)
                with timers("compute-consensus"):
                    superreads_of[sample], components_of[sample] = consensus(
                        only_indels,
                        gap_threshold,
                        cut_poly,
                        refseq,
                        variant_at,
                        phased_at,
                        votes,
                        id_to_allele,
                    )
            with timers("write-vcf"):
                writer.write(chromosome, superreads_of, components_of)
    timers.stop("haplotagphase-run")
    log_time_and_memory_usage(timers)


_SUMMARY_STAGES = [
    ("Finished in :", "haplotagphase-run"),
    ("Time spent reading reference:", "read-fasta"),
    ("Time spent reading VCF:", "parse-vcf"),
    ("Time spent writing VCF:", "write-vcf"),
    ("Time spent reading BAM:", "read-bam"),
    ("Time spent computing votes:", "compute-votes"),
    ("Time spent spent computing consensus:", "compute-consensus"),
]


def log_time_and_memory_usage(timers):
    logger.info("\n# Resource usage")
    log_memory_usage()
    for label, stage in _SUMMARY_STAGES:
        logger.info("%-42s %6.1f s", label, timers.elapsed(stage))


def main(args):
    run_haplotagphase(**vars(args))
