"""
Phase variants in a polyploid VCF using genetic information from progeny samples.

Reads parent and (optionally separate) progeny VCFs plus a pedigree file,
scores parental marker alleles by their co-segregation in the progenies,
clusters the markers and arranges the clusters onto haplotypes
(counterpart of whatshap/cli/polyphasegenetic.py).
"""

import argparse
import logging
import platform
import sys
from collections import defaultdict
from contextlib import ExitStack
from dataclasses import dataclass

from .. import __version__
from ..core import Read, ReadSet
from ..polyphase.clusterarrangement import arrange_clusters
from ..polyphase.offspringscoring import (
    correct_variant_types,
    get_offspring_gl,
    get_variant_scoring,
)
from ..polyphase.plots import create_genetic_plots
from ..polyphase.solver import ClusterEditingSolver
from ..polyphase.variantselection import compute_phasable_variants, filter_variants
from ..timer import StageTimer
from ..utils import ChromosomeFilter
from ..vcf import PhasedVcfWriter, PloidyError, VcfReader
from . import CommandLineError, log_memory_usage, populate_arg_parser

logger = logging.getLogger(__name__)


@dataclass
class PolyphaseGeneticParameter:
    ploidy: int
    scoring_window: int
    allele_error_rate: float
    complexity_support: int
    ratio_cutoff: float
    distrust_genotypes: bool
    allow_deletions: bool
    plot: bool
    output: str


POLYPHASEGENETIC_ARGUMENTS = [
    (None, [
        ("variant_file", dict(metavar="VCF",
            help="VCF file with variants to be phased (can be gzip-compressed)")),
        ("pedigree_file", dict(metavar="PEDIGREE", help="Pedigree file.")),
        (("-P", "--progeny_file"), dict(required=False,
            help="File with progeny genotypes. If not specified, information is taken from main input file.")),
        (("-o", "--output"), dict(default=sys.stdout,
            help="Output VCF file. Add .gz to the file name to get compressed output. If omitted, use standard output.")),
        ("--tag", dict(choices=("PS", "HP"), default="PS",
            help="Store phasing information with PS tag (standardized) or HP tag (used by GATK ReadBackedPhasing) (default: %(default)s)")),
    ]),
    (("Input pre-processing, selection, and filtering", None), [
        ("--only-snvs", dict(action="store_true", help="Phase only SNVs")),
        ("--sample", dict(dest="samples", metavar="SAMPLE", default=[], action="append",
            help="Name of a sample to phase. If not given, all samples in the input VCF are phased. Can be used multiple times.")),
        ("--chromosome", dict(dest="chromosomes", metavar="CHROMOSOME", default=[], action="append",
            help="Name of chromosome to phase. If not given, all chromosomes in the input VCF are phased. Can be used multiple times.")),
        ("--exclude-chromosome", dict(dest="excluded_chromosomes", default=[], action="append",
            help="Name of chromosome not to phase.")),
    ]),
    (("Parameters for phasing steps", None), [
        (("--ploidy", "-p"), dict(metavar="PLOIDY", type=int, required=True,
            help="The ploidy of the sample(s). Argument is required.")),
        ("--scoring-window", dict(metavar="SCORINGWINDOW", dest="scoring_window", type=int,
            default=250, required=False,
            help="Size of the window (in variants) for statistical progeny scoring.")),
        (("--complexity-support", "-C"), dict(dest="complexity_support", type=int, default=0,
            required=False,
            help="Indicates what level of genotype complexity is allowed for phased variants. 0 = simplex-nulliplex only, 1 = simplex-simplex on top, 2 = duplex-nulliplex on top. Default is 0.")),
        ("--distrust-genotypes", dict(dest="distrust_genotypes", default=False, action="store_true",
            help="Internally retypes the reported parent genotypes based on allele distribution in progeny samples.")),
        ("--ratio-cutoff", dict(metavar="RATIOCUTOFF", dest="ratio_cutoff", type=float,
            default=0.0, required=False, help=argparse.SUPPRESS)),
        ("--allele-error-rate", dict(metavar="ALLELEERRORRATE", dest="allele_error_rate",
            type=float, default=0.06, required=False, help=argparse.SUPPRESS)),
        ("--plot", dict(dest="plot", default=False, action="store_true", help=argparse.SUPPRESS)),
        (("--ground-truth-file", "-g"), dict(required=False, help=argparse.SUPPRESS)),
    ]),
]


def add_arguments(parser):
    populate_arg_parser(parser, POLYPHASEGENETIC_ARGUMENTS)


_ARG_CHECKS = [
    (lambda a: 0.01 <= a.allele_error_rate <= 0.5,
     "Allele error rate must be between 0.01 and 0.5."),
    (lambda a: a.scoring_window >= 1, "Scoring window must be a positive integer."),
    (lambda a: a.complexity_support in (0, 1, 2),
     "Complexity support level must be either 0, 1 or 2."),
    (lambda a: a.ploidy % 2 == 0, "Odd ploidies are not supported."),
    (lambda a: a.ploidy >= 2, "Ploidy must be at least 2."),
]


def validate(args, parser):
    for ok, message in _ARG_CHECKS:
        if not ok(args):
            parser.error(message)


# ---------------------------------------------------------------------------
# pedigree resolution


def _parse_trio_file(pedigree_file):
    """(parent -> co-parent, parent -> progeny list) from a 3-column
    space-separated trio file (father mother child)."""
    coparents = {}
    progenies = defaultdict(list)
    with open(pedigree_file) as ped:
        for lineno, raw in enumerate(ped):
            tokens = raw.rstrip("\n").split(" ")
            if len(tokens) != 3:
                logger.error(
                    f"Line {lineno} in pedfile contains {len(tokens)} values instead of 3."
                )
                raise CommandLineError(None)
            father, mother, progeny = tokens
            if progeny == father or progeny == mother:
                logger.warning(
                    f"Ignore: Sample {progeny} defined as its own parent in line {lineno}."
                )
                continue
            for parent, co_parent in ((father, mother), (mother, father)):
                known_partner = coparents.get(parent)
                if known_partner is not None and known_partner != co_parent:
                    msg = (
                        f"Pedfile assigns multiple partners ({co_parent}, {known_partner}) to "
                        f"{parent}. Currently only one partner per sample is supported."
                    )
                    logger.error(msg)
                    raise CommandLineError(msg)
                coparents[parent] = co_parent
                if progeny in progenies[parent]:
                    logger.warning(
                        f"Ignore: Duplicate trio ({parent}, {co_parent}, {progeny}) "
                        f"in pedfile line {lineno}"
                    )
                else:
                    progenies[parent].append(progeny)
    return coparents, progenies


def determine_pedigree(pedigree_file, samples, parent_samples, progeny_samples=None):
    """(samples to phase, sample -> co-parent, sample -> usable progeny
    list).  A progeny counts only when the pedigree defines its trio AND
    its genotypes are available (progeny VCF, else the primary VCF)."""
    coparents, progenies = _parse_trio_file(pedigree_file)

    def fail(msg):
        logger.error(msg)
        raise CommandLineError(msg)

    primary = set(parent_samples)
    if samples:
        for sample in samples:
            if sample not in coparents:
                fail(f"Requested parent sample {sample} does not occur as parent in pedfile.")
            if sample not in primary:
                fail(f"Requested parent sample {sample} is not present in primary VCF file.")
            if coparents[sample] not in primary:
                fail(
                    f"Partner {coparents[sample]} of requested parent sample {sample} "
                    "is not present in primary VCF file."
                )
    else:
        if not coparents:
            fail("Pedfile does not contain any trios.")
        samples = [s for s in coparents if s in primary]
        if not samples:
            fail("No prospect parent sample from the pedfile is present in primary VCF file")

    usable_progenies = {}
    chosen_coparents = {}
    for sample in samples:
        chosen_coparents[sample] = coparents[sample]
        kept = []
        for progeny in progenies[sample]:
            pool = progeny_samples if progeny_samples else primary
            if progeny in pool:
                kept.append(progeny)
            elif progeny_samples and progeny in primary:
                logger.warning(
                    f"Ignore: Progeny {progeny} present in primary VCF instead of progeny VCF."
                )
            else:
                where = "progeny VCF" if progeny_samples else "primary VCF"
                logger.warning(f"Ignore: Progeny {progeny} not present in {where}.")
        usable_progenies[sample] = kept
    return samples, chosen_coparents, usable_progenies


def get_parent_progeny_coverage(parent, co_parent, progeny_list, parent_table, progeny_table):
    """Per parent-table row: total read depth of parent, co-parent and the
    summed progenies (progeny rows are matched to parent rows by
    position)."""
    parent_depths = parent_table.allele_depths_of(parent)
    co_parent_depths = parent_table.allele_depths_of(co_parent)
    n = len(parent_table)
    parent_cov = [sum(parent_depths[pos]) for pos in range(n)]
    co_parent_cov = [sum(co_parent_depths[pos]) for pos in range(n)]
    progeny_cov = [0] * n
    for child in progeny_list:
        depths = progeny_table.allele_depths_of(child)
        assert len(depths) == len(progeny_table)
        progeny_pos = 0
        for parent_pos in range(n):
            if progeny_pos >= len(depths):
                break
            parent_gpos = parent_table.variants[parent_pos].position
            progeny_gpos = progeny_table.variants[progeny_pos].position
            if parent_gpos == progeny_gpos:
                progeny_cov[parent_pos] += sum(depths[progeny_pos])
                progeny_pos += 1
            else:
                assert parent_gpos < progeny_gpos
    return parent_cov, co_parent_cov, progeny_cov


# ---------------------------------------------------------------------------
# per-sample phasing


def phase_single_sample(
    chromosome,
    progeny_reader,
    ground_truth_reader,
    sample,
    coparent,
    progeny_list,
    variant_table,
    timers,
    param,
):
    varinfo = compute_phasable_variants(variant_table, sample, coparent, param)

    with timers("parse_vcf"):
        logger.info("Extracting progeny allele depths ...")
        if progeny_reader:
            positions = [variant_table.variants[i].position for i in varinfo.get_phasable()]
            progeny_table = progeny_reader.fetch_regions(
                chromosome, [(p, p + 1) for p in positions]
            )
        else:
            progeny_table = variant_table

    parent_cov, co_parent_cov, progeny_cov = get_parent_progeny_coverage(
        sample, coparent, progeny_list, variant_table, progeny_table
    )
    if param.ratio_cutoff > 1.0:
        logger.info("Filtering variant positions based on coverage ratios ...")
        before = len(varinfo.get_phasable())
        filter_variants(varinfo, parent_cov, co_parent_cov, progeny_cov, param.ratio_cutoff)
        logger.info("Kept %i out of %i variants.", len(varinfo.get_phasable()), before)

    with timers("scoring"):
        logger.info("Computing progeny genotype likelihoods ...")
        if param.distrust_genotypes:
            correct_variant_types(variant_table, progeny_table, progeny_list, varinfo, param)
        off_gl = get_offspring_gl(variant_table, progeny_table, progeny_list, varinfo, param)
        if progeny_reader:
            del progeny_table
        logger.info("Compute scores for markers ...")
        scoring = get_variant_scoring(varinfo, off_gl, param)
        del off_gl

    with timers("clustering"):
        logger.info("Clustering marker alleles ...")
        clustering = ClusterEditingSolver(scoring, False).run()
        assert clustering
        assert any(len(c) > 1 for c in clustering)

    timers.start("arrangement")
    logger.info("Arranging clusters ...")
    padding = int(param.scoring_window * 3.0 + 1)
    haplo_skeletons = arrange_clusters(clustering, padding, param.ploidy)

    accessible_positions = sorted(v.position for v in variant_table.variants)

    # markers_at: variant index -> haplotypes whose skeleton carries it
    markers_at = defaultdict(list)
    for hap_id, skeleton in enumerate(haplo_skeletons):
        for cluster_id in skeleton:
            for node in clustering[cluster_id]:
                markers_at[varinfo.node_to_variant(node)].append(hap_id)

    components = {}
    superreads = ReadSet()
    for i in range(param.ploidy):
        superreads.add(Read(f"superread {i + 1}", 0, 0))

    phased_positions = []
    haplotypes = [[] for _ in range(param.ploidy)]
    kept_parent_cov, kept_co_parent_cov, kept_progeny_cov = [], [], []
    for pos in range(len(variant_table)):
        if not markers_at[pos]:
            continue
        for i in range(param.ploidy):
            allele = varinfo[pos].alt if i in markers_at[pos] else varinfo[pos].ref
            superreads[i].add_variant(accessible_positions[pos], allele, 0)
            components[accessible_positions[pos]] = accessible_positions[0]
            haplotypes[i].append(allele)
        phased_positions.append(accessible_positions[pos])
        kept_parent_cov.append(parent_cov[pos])
        kept_co_parent_cov.append(co_parent_cov[pos])
        kept_progeny_cov.append(progeny_cov[pos])
    timers.stop("arrangement")

    if param.plot:
        with timers("plots"):
            create_genetic_plots(
                param.output,
                chromosome,
                sample,
                ground_truth_reader,
                varinfo,
                clustering,
                haplo_skeletons,
                haplotypes,
                phased_positions,
                kept_parent_cov,
                kept_co_parent_cov,
                kept_progeny_cov,
                param,
            )
    return superreads, components


# ---------------------------------------------------------------------------
# driver


def run_polyphasegenetic(
    variant_file,
    pedigree_file,
    ploidy,
    progeny_file=None,
    ground_truth_file=None,
    scoring_window=250,
    allele_error_rate=0.06,
    ratio_cutoff=0.0,
    complexity_support=0,
    distrust_genotypes=False,
    output=sys.stdout,
    samples=None,
    chromosomes=None,
    excluded_chromosomes=None,
    only_snvs=False,
    tag="PS",
    write_command_line_header=True,
    plot=False,
):
    """Genetic polyploid phasing pipeline."""
    timers = StageTimer()
    logger.info(
        "This is WhatsHap (polyploid-genetic) %s running under Python %s",
        __version__,
        platform.python_version(),
    )
    with ExitStack() as stack:
        command_line = (
            "(whatshap {}) {}".format(__version__, " ".join(sys.argv[1:]))
            if write_command_line_header
            else None
        )
        try:
            vcf_writer = stack.enter_context(
                PhasedVcfWriter(
                    command_line=command_line, in_path=variant_file, out_file=output,
                    tag=tag, ploidy=ploidy, mav=False,
                )
            )
        except OSError as e:
            raise CommandLineError(e)

        def open_depth_reader(path):
            return stack.enter_context(
                VcfReader(
                    path, only_snvs=only_snvs, phases=True, genotype_likelihoods=False,
                    ploidy=ploidy, mav=True, allele_depth=True,
                )
            )

        parent_reader = open_depth_reader(variant_file)
        progeny_reader = open_depth_reader(progeny_file) if progeny_file else None

        samples, sample_to_coparent, sample_to_progeny = determine_pedigree(
            pedigree_file,
            samples,
            parent_reader.samples,
            progeny_reader.samples if progeny_reader else None,
        )
        known = set(parent_reader.samples)
        for sample in samples:
            if sample not in known:
                raise CommandLineError(
                    "Sample {!r} requested on command-line not found in VCF".format(sample)
                )
        samples = frozenset(samples)

        param = PolyphaseGeneticParameter(
            ploidy=ploidy,
            scoring_window=scoring_window,
            allele_error_rate=allele_error_rate,
            complexity_support=complexity_support,
            ratio_cutoff=ratio_cutoff,
            distrust_genotypes=distrust_genotypes,
            allow_deletions=not only_snvs,
            plot=plot,
            output=output,
        )

        try:
            wanted = ChromosomeFilter(chromosomes, excluded_chromosomes)
            for variant_table in timers.iterate("parse_vcf", parent_reader):
                chromosome = variant_table.chromosome
                if chromosome not in wanted:
                    logger.info(
                        "Leaving chromosome %r unchanged (present in VCF but not "
                        "requested by option --chromosome)",
                        chromosome,
                    )
                    with timers("write_vcf"):
                        vcf_writer.write(chromosome, {}, {})
                    continue

                logger.info("======== Working on chromosome %r", chromosome)
                logger.info("Number of variants among all samples: %d", len(variant_table))

                superreads, components = {}, {}
                for sample in samples:
                    logger.info("---- Processing individual %s", sample)
                    coparent = sample_to_coparent[sample]
                    logger.info("Detected %s as co-parent for %s.", coparent, sample)
                    superreads[sample], components[sample] = phase_single_sample(
                        chromosome,
                        progeny_reader,
                        ground_truth_file,
                        sample,
                        coparent,
                        sample_to_progeny[sample],
                        variant_table,
                        timers,
                        param,
                    )

                with timers("write_vcf"):
                    logger.info("======== Writing VCF")
                    vcf_writer.write(chromosome, superreads, components)
                    logger.info("Done writing VCF")
                logger.debug("Chromosome %r finished", chromosome)
        except PloidyError as e:
            raise CommandLineError(e)

    logger.info("\n== SUMMARY ==")
    log_memory_usage()
    summary_rows = [
        ("Time spent parsing VCF:", timers.elapsed("parse_vcf")),
        ("Time spent for genetic scoring:", timers.elapsed("scoring")),
        ("Time spent for clustering:", timers.elapsed("clustering")),
        ("Time spent for cluster arrangement:", timers.elapsed("arrangement")),
        ("Time spent writing VCF:", timers.elapsed("write_vcf")),
    ]
    if plot:
        summary_rows.append(("Time spent creating plots:", timers.elapsed("plots")))
    summary_rows += [
        ("Time spent on rest:", timers.total() - timers.sum()),
        ("Total elapsed time:", timers.total()),
    ]
    for label, seconds in summary_rows:
        logger.info("%-41s %6.1f s", label, seconds)


def main(args):
    run_polyphasegenetic(**vars(args))
