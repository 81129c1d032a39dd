"""
Genotype variants

Runs only the genotyping algorithm. Genotype Likelihoods are computed using the
forward backward algorithm.
"""

import logging
import platform
import sys
from argparse import SUPPRESS
from contextlib import ExitStack
from typing import Dict, Optional

from .. import __version__
from ..core import (
    Genotype,
    GenotypeDPTable,
    NumericSampleIds,
    Pedigree,
    PhredGenotypeLikelihoods,
    ReadSet,
    compute_genotypes,
)
from ..ops.wmec import resolve_device
from ..pedigree import (
    GeneticMapRecombinationCostComputer,
    PedReader,
    UniformRecombinationCostComputer,
)
from ..timer import StageTimer
from ..utils import ChromosomeFilter
from ..vcf import GenotypeVcfWriter, VcfReader
from . import CommandLineError, PhasedInputReader, log_memory_usage, populate_arg_parser
from .phase import refuse_families_past_envelope, select_reads, setup_families, vcf_samples

logger = logging.getLogger(__name__)

#: StageTimer of the most recent run_genotype call: a caller (chip_smoke.py)
#: reads it to print a per-stage wall-clock breakdown beside the end-to-end
#: number.
LAST_TIMERS = None

# the three biallelic diploid genotypes, by canonical index
_DIPLOID_GTS = (Genotype([0, 0]), Genotype([0, 1]), Genotype([1, 1]))


def int_to_diploid_biallelic_gt(numeric_repr) -> Genotype:
    """Genotype object for a canonical biallelic diploid index (0/1/2);
    anything else maps to the no-call genotype."""
    if 0 <= numeric_repr <= 2:
        return _DIPLOID_GTS[numeric_repr]
    return Genotype([])


def determine_genotype(likelihoods, threshold_prob: float) -> Genotype:
    """The likeliest of 0/0, 0/1, 1/1 — but only when it is a UNIQUE
    maximum above the threshold; otherwise the no-call genotype."""
    scored = sorted((likelihoods[gt], i) for i, gt in enumerate(_DIPLOID_GTS))
    best_prob, best_index = scored[2]
    runner_up_prob = scored[1][0]
    if best_prob > runner_up_prob and best_prob > threshold_prob:
        return _DIPLOID_GTS[best_index]
    return Genotype([])


def _regularized_priors(genotype_likelihoods, constant: float, gt_prob: float):
    """Normalize each prior GL triple with additive regularization and call
    the prior genotype from it."""
    genotypes = []
    regularized = []
    for gl in genotype_likelihoods:
        total = gl[0] + gl[1] + gl[2] + 3 * constant
        triple = PhredGenotypeLikelihoods(
            [(gl[0] + constant) / total, (gl[1] + constant) / total, (gl[2] + constant) / total]
        )
        genotypes.append(determine_genotype(triple, gt_prob))
        regularized.append(triple)
    return genotypes, regularized


def run_genotype(
    phase_input_files, variant_file, reference=None, output=sys.stdout,
    samples=None, chromosomes=None, excluded_chromosomes=None,
    ignore_read_groups=False, only_snvs=False, mapping_quality=20,
    max_coverage=15, nopriors=False, ped=None, recombrate=1.26, genmap=None,
    gt_qual_threshold=0, prioroutput=None, constant=0.0, overhang=10,
    affine_gap=False, gap_start=10, gap_extend=7, mismatch=15,
    write_command_line_header=True, use_ped_samples=False, use_kmerald=False,
    kmeralign_costs_path=False, kmer_size=7, kmerald_gappenalty=40,
    kmerald_window=25,
    device="cuda",
):
    """Re-genotype all variants with the forward-backward HMM (reference:
    whatshap/cli/genotype.py run_genotype).  The forward-backward runs on
    `device`: a CUDA device unless the caller passes "cpu" (see
    ops.wmec.resolve_device, which raises before any output is opened when
    no CUDA device is available; so does a PED family past the card's
    kernels, phase.refuse_families_past_envelope)."""
    device = resolve_device(device)
    if ped:
        # the samples as the run below takes them
        if use_ped_samples:
            family_samples = {
                member
                for trio in PedReader(ped)
                if trio.child and trio.mother and trio.father
                for member in (trio.mother, trio.father, trio.child)
            }
        else:
            family_samples = samples or vcf_samples(variant_file)
        refuse_families_past_envelope(family_samples, ped, device)

    global LAST_TIMERS
    timers = LAST_TIMERS = StageTimer()
    logger.info(
        "This is whatshap-torch (genotyping) %s running under Python %s",
        __version__,
        platform.python_version(),
    )
    command_line = (
        "(whatshap {}) {}".format(__version__, " ".join(sys.argv[1:]))
        if write_command_line_header
        else None
    )
    with ExitStack() as stack:
        numeric_sample_ids = NumericSampleIds()
        phased_input_reader = stack.enter_context(
            PhasedInputReader(
                phase_input_files, reference, numeric_sample_ids, ignore_read_groups,
                only_snvs=only_snvs, mapq_threshold=mapping_quality, overhang=overhang,
                affine=affine_gap, gap_start=gap_start, gap_extend=gap_extend,
                default_mismatch=mismatch, use_kmerald=use_kmerald,
                kmeralign_costs_path=kmeralign_costs_path, kmer_size=kmer_size,
                kmerald_gappenalty=kmerald_gappenalty, kmerald_window=kmerald_window,
            )
        )
        show_phase_vcfs = phased_input_reader.has_vcfs

        vcf_writer = stack.enter_context(
            GenotypeVcfWriter(command_line=command_line, in_path=variant_file, out_file=output)
        )
        prior_vcf_writer: Optional[GenotypeVcfWriter] = None
        if prioroutput is not None:
            prior_vcf_writer = stack.enter_context(
                GenotypeVcfWriter(
                    command_line=command_line,
                    in_path=variant_file,
                    out_file=stack.enter_context(open(prioroutput, "w")),
                )
            )

        vcf_reader = stack.enter_context(
            VcfReader(
                variant_file, only_snvs=only_snvs, genotype_likelihoods=False, ignore_genotypes=True
            )
        )

        if ignore_read_groups and not samples and len(vcf_reader.samples) > 1:
            raise CommandLineError(
                "When using --ignore-read-groups on a VCF with "
                "multiple samples, --sample must also be used."
            )
        if not samples:
            samples = vcf_reader.samples
        if ped and use_ped_samples:
            samples = {
                member
                for trio in PedReader(ped)
                if trio.child and trio.mother and trio.father
                for member in (trio.mother, trio.father, trio.child)
            }

        known_samples = set(vcf_reader.samples)
        for sample in samples:
            if sample not in known_samples:
                raise CommandLineError(
                    f"Sample {sample!r} requested on command-line not found in VCF"
                )

        if ped and genmap:
            logger.info("Using region-specific recombination rates from genetic map %s.", genmap)
            recomb_computer = GeneticMapRecombinationCostComputer(genmap)
        else:
            if ped:
                logger.info("Using uniform recombination rate of %g cM/Mb.", recombrate)
            recomb_computer = UniformRecombinationCostComputer(recombrate)

        samples = frozenset(samples)
        families, family_trios = setup_families(samples, ped, max_coverage)
        for trios in family_trios.values():
            for trio in trios:
                numeric_sample_ids[trio.child]

        with timers("parse_phasing_vcfs"):
            phased_input_reader.read_vcfs()

        # probability-space genotype quality threshold
        gt_prob = 1.0 - (10 ** (-gt_qual_threshold / 10.0))

        wanted = ChromosomeFilter(chromosomes, excluded_chromosomes)
        for variant_table in timers.iterate("parse_vcf", vcf_reader):
            chromosome = variant_table.chromosome
            row_of: Dict[int, int] = {
                v.position: i for i, v in enumerate(variant_table.variants)
            }
            if chromosome not in wanted:
                logger.info(
                    "Leaving chromosome %r unchanged (present in VCF but not requested by "
                    "option --chromosome)",
                    chromosome,
                )
                vcf_writer.write_unchanged(chromosome)
                if prior_vcf_writer is not None:
                    prior_vcf_writer.write_unchanged(chromosome)
                continue
            logger.info("======== Working on chromosome %r", chromosome)

            positions = [v.position for v in variant_table.variants]
            if nopriors:
                flat = PhredGenotypeLikelihoods([1 / 3, 1 / 3, 1 / 3])
                for sample in samples:
                    variant_table.set_genotype_likelihoods_of(sample, [flat] * len(positions))
            else:
                # per-column prior genotyping from the raw pileup
                for sample in samples:
                    logger.info("---- Initial genotyping of %s", sample)
                    with timers("read_bam"):
                        readset, _ = phased_input_reader.read(
                            chromosome, variant_table.variants, sample, read_vcf=False
                        )
                        readset.sort()
                        _, prior_gls = compute_genotypes(readset, positions)
                        genotypes, regularized = _regularized_priors(
                            prior_gls, constant, gt_prob
                        )
                        variant_table.set_genotype_likelihoods_of(
                            sample, [PhredGenotypeLikelihoods(list(gl)) for gl in regularized]
                        )
                        variant_table.set_genotypes_of(sample, genotypes)

            if prior_vcf_writer is not None:
                prior_vcf_writer.write_genotypes(chromosome, variant_table, only_snvs)

            # one forward-backward pass per family
            for representative, family in sorted(families.items()):
                if len(family) == 1:
                    logger.info("---- Processing individual %s", representative)
                else:
                    logger.info("---- Processing family with individuals: %s", ",".join(family))
                max_cov_per_sample = max(1, max_coverage // len(family))
                logger.info("Using maximum coverage per sample of %dX", max_cov_per_sample)
                trios = family_trios[representative]
                assert (len(family) == 1) or (len(trios) > 0)

                all_reads = ReadSet()
                for sample in family:
                    with timers("read_bam"):
                        readset, vcf_source_ids = phased_input_reader.read(
                            chromosome, variant_table.variants, sample
                        )
                    with timers("select"):
                        readset = readset.subset(
                            [i for i, read in enumerate(readset) if len(read) >= 2]
                        )
                        logger.info(
                            "Kept %d reads that cover at least two variants each", len(readset)
                        )
                        selection = select_reads(
                            readset, max_cov_per_sample, preferred_source_ids=vcf_source_ids
                        )
                    for read in selection:
                        assert read.is_sorted(), "Add a read.sort() here"
                        all_reads.add(read)
                all_reads.sort()

                accessible_positions = sorted(all_reads.get_positions())
                logger.info(
                    "Variants covered by at least one phase-informative "
                    "read in at least one individual after read selection: %d",
                    len(accessible_positions),
                )

                pedigree = Pedigree(numeric_sample_ids)
                for sample in family:
                    gls = variant_table.genotype_likelihoods_of(sample)
                    pedigree.add_individual(
                        sample,
                        [Genotype([]) for _ in accessible_positions],
                        [gls[row_of[p]] for p in accessible_positions],
                    )
                for trio in trios:
                    pedigree.add_relationship(
                        father_id=trio.father, mother_id=trio.mother, child_id=trio.child
                    )

                recombination_costs = recomb_computer.compute(accessible_positions)

                with timers("genotyping"):
                    logger.info(
                        "Genotype %d sample%s by solving the genotyping problem ...",
                        len(family),
                        "s" if len(family) > 1 else "",
                    )
                    fb_table = GenotypeDPTable(
                        numeric_sample_ids,
                        all_reads,
                        recombination_costs,
                        pedigree,
                        accessible_positions,
                        device=device,
                    )
                    for sample in family:
                        gl_column = variant_table.genotype_likelihoods_of(sample)
                        gt_column = variant_table.genotypes_of(sample)
                        for i, position in enumerate(accessible_positions):
                            likelihoods = fb_table.get_genotype_likelihoods(sample, i)
                            gt_column[row_of[position]] = determine_genotype(
                                likelihoods, gt_prob
                            )
                            gl_column[row_of[position]] = likelihoods
                        variant_table.set_genotypes_of(sample, gt_column)
                        variant_table.set_genotype_likelihoods_of(sample, gl_column)

            with timers("write_vcf"):
                logger.info("======== Writing VCF")
                vcf_writer.write_genotypes(chromosome, variant_table, only_snvs)
                logger.info("Done writing VCF")
            logger.debug("Chromosome %r finished", chromosome)

    logger.info("\n== SUMMARY ==")
    total_time = timers.total()
    log_memory_usage()
    logger.info("Time spent reading BAM:                      %6.1f s", timers.elapsed("read_bam"))
    logger.info("Time spent parsing VCF:                      %6.1f s", timers.elapsed("parse_vcf"))
    if show_phase_vcfs:
        logger.info(
            "Time spent parsing input phasings from VCFs: %6.1f s",
            timers.elapsed("parse_phasing_vcfs"),
        )
    logger.info("Time spent selecting reads:                  %6.1f s", timers.elapsed("select"))
    logger.info(
        "Time spent genotyping:                          %6.1f s", timers.elapsed("genotyping")
    )
    logger.info("Time spent writing VCF:                      %6.1f s", timers.elapsed("write_vcf"))
    logger.info("Time spent on rest:                          %6.1f s", total_time - timers.sum())
    logger.info("Total elapsed time:                          %6.1f s", total_time)


GENOTYPE_ARGUMENTS = [
    (None, [
        ("variant_file", dict(metavar="VCF",
            help="VCF file with variants to be genotyped (can be gzip-compressed)")),
        ("phase_input_files", dict(nargs="*", metavar="PHASEINPUT",
            help="BAM or VCF file(s) with phase information, either through sequencing reads (BAM) or through phased blocks (VCF)")),
        (("-o", "--output"), dict(default=sys.stdout,
            help="Output VCF file. Add .gz to the file name to get compressed output. If omitted, use standard output.")),
        (("--reference", "-r"), dict(metavar="FASTA",
            help="Reference file. Provide this to detect alleles through re-alignment. If no index (.fai) exists, it will be created")),
        (("--max-coverage", "-H"), dict(metavar="MAXCOV", default=15, type=int,
            help="Reduce coverage to at most MAXCOV (default: %(default)s).")),
        (("--mapping-quality", "--mapq"), dict(metavar="QUAL", default=20, type=int,
            help="Minimum mapping quality (default: %(default)s)")),
        ("--indels", dict(dest="indels_used", action="store_true", help=SUPPRESS)),
        ("--only-snvs", dict(default=False, action="store_true", help="Genotype only SNVs")),
        ("--ignore-read-groups", dict(default=False, action="store_true",
            help="Ignore read groups in BAM header and assume all reads come from the same sample.")),
        ("--sample", dict(dest="samples", metavar="SAMPLE", default=[], action="append",
            help="Name of a sample to genotype. If not given, all samples in the input VCF are genotyped. Can be used multiple times.")),
        ("--chromosome", dict(dest="chromosomes", metavar="CHROMOSOME", default=[], action="append",
            help="Name of chromosome to genotyped. If not given, all chromosomes in the input VCF are genotyped. Can be used multiple times.")),
        ("--exclude-chromosome", dict(dest="excluded_chromosomes", default=[], action="append",
            help="Name of chromosome not to genotype.")),
        ("--gt-qual-threshold", dict(metavar="GTQUALTHRESHOLD", type=float, default=0,
            help="Phred scaled error probability threshold used for genotyping (default: %(default)s). Must be at least 0. If error probability of genotype is higher, genotype ./. is output.")),
        ("--no-priors", dict(dest="nopriors", default=False, action="store_true",
            help="Skip initial prior genotyping and use uniform priors (default: %(default)s).")),
        ("--priors-out", dict(dest="prioroutput", default=None,
            help="output prior genotype likelihoods to the given file (in VCF format). If not given, the priors are not output.")),
        ("--overhang", dict(metavar="OVERHANG", default=10, type=int,
            help="When --reference is used, extend alignment by this many bases to left and right when realigning (default: %(default)s).")),
        ("--constant", dict(metavar="CONSTANT", default=0, type=float,
            help="This constant is used to regularize the priors (default: %(default)s).")),
        ("--affine-gap", dict(default=False, action="store_true",
            help="When detecting alleles through re-alignment, use affine gap costs (EXPERIMENTAL).")),
        ("--gap-start", dict(metavar="GAPSTART", default=10, type=float,
            help="gap starting penalty in case affine gap costs are used (default: %(default)s).")),
        ("--gap-extend", dict(metavar="GAPEXTEND", default=7, type=float,
            help="gap extend penalty in case affine gap costs are used (default: %(default)s).")),
        ("--mismatch", dict(metavar="MISMATCH", default=15, type=float,
            help="mismatch cost in case affine gap costs are used (default: %(default)s)")),
    ]),
    (("Pedigree genotyping", None), [
        ("--ped", dict(metavar="PED/FAM",
            help="Use pedigree information in PED file to improve genotyping (switches to PedMEC algorithm). Columns 2, 3, 4 must refer to child, father, and mother sample names as used in the VCF and BAM. Other columns are ignored (EXPERIMENTAL).")),
        ("--recombrate", dict(metavar="RECOMBRATE", type=float, default=1.26,
            help="Recombination rate in cM/Mb (used with --ped). If given, a constant recombination rate is assumed (default: %(default)gcM/Mb).")),
        ("--genmap", dict(metavar="FILE",
            help="File with genetic map (used with --ped) to be used instead of constant recombination rate, i.e. overrides option --recombrate.")),
        ("--use-ped-samples", dict(dest="use_ped_samples", action="store_true", default=False,
            help="Only work on samples mentioned in the provided PED file.")),
    ]),
]


def add_arguments(parser):
    populate_arg_parser(parser, GENOTYPE_ARGUMENTS)


def validate(args, parser):
    if args.ignore_read_groups and args.ped:
        parser.error("Option --ignore-read-groups cannot be used together with --ped")
    if args.genmap and not args.ped:
        parser.error("Option --genmap can only be used together with --ped")
    if args.genmap and (len(args.chromosomes) != 1):
        parser.error(
            "Option --genmap can only be used when working on exactly one "
            "chromosome (use --chromosome)"
        )
    if len(args.phase_input_files) == 0:
        parser.error("Not providing any PHASEINPUT files not allowed for genotyping.")
    if args.gt_qual_threshold < 0:
        parser.error("Genotype quality threshold (gt-qual-threshold) must be at least 0.")
    if args.prioroutput is not None and args.nopriors:
        parser.error("Genotype priors are only computed if --no-priors is NOT set.")


def main(args):
    del args.indels_used
    run_genotype(**vars(args))
