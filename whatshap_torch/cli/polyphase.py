"""
Phase variants in a polyploid VCF using a clustering+threading algorithm.

Read a VCF and one or more files with phase information (BAM/CRAM or VCF phased
blocks) and phase the variants. The phased VCF is written to standard output.
Requires to specify a ploidy for the phasable input. Allows to specify a block
cut sensitivity to balance out length and accuracy of phased blocks.

Polyphase runs on the host alone, as in the reference: it does no device
work and needs no GPU. Read scoring, cluster editing and haplotype threading
run in C++ libraries built with g++ at first use.
"""

import argparse
import logging
import platform
import sys
from contextlib import ExitStack
from typing import Dict, FrozenSet, List, Optional, Sequence, TextIO, Tuple

from .. import __version__
from ..core import NumericSampleIds, Read, ReadSet
from ..polyphase import (
    PolyphaseParameter,
    Position,
    create_genotype_list,
    extract_partial_phasing,
)
from ..polyphase.algorithm import compute_cut_positions, solve_polyphase_instance
from ..polyphase.plots import draw_plots
from ..polyphase.solver import AlleleMatrix
from ..timer import StageTimer
from ..utils import ChromosomeFilter
from ..vcf import PhasedVcfWriter, PloidyError, VariantTable, VcfReader
from . import CommandLineError, PhasedInputReader, log_memory_usage, populate_arg_parser

logger = logging.getLogger(__name__)


POLYPHASE_ARGUMENTS = [
    (None, [
        ("variant_file", dict(metavar="VCF",
            help="VCF file with variants to be phased (can be gzip-compressed)")),
        ("phase_input_files", dict(nargs="*", metavar="PHASEINPUT",
            help="BAM or CRAM with sequencing reads.")),
        (("-o", "--output"), dict(default=sys.stdout,
            help="Output VCF file. Add .gz to the file name to get compressed output. If omitted, use standard output.")),
        (("--reference", "-r"), dict(metavar="FASTA",
            help="Reference file. Provide this to detect alleles through re-alignment. If no index (.fai) exists, it will be created")),
        ("--tag", dict(choices=("PS", "HP"), default="PS",
            help="Store phasing information with PS tag (standardized) or HP tag (used by GATK ReadBackedPhasing) (default: %(default)s)")),
    ]),
    (("Input pre-processing, selection, and filtering", None), [
        (("--mapping-quality", "--mapq"), dict(metavar="QUAL", default=20, type=int,
            help="Minimum mapping quality (default: %(default)s)")),
        ("--indels", dict(dest="indels_used", action="store_true", help=argparse.SUPPRESS)),
        ("--only-snvs", dict(action="store_true", help="Only phase SNVs")),
        ("--ignore-read-groups", dict(default=False, action="store_true",
            help="Ignore read groups in BAM/CRAM header and assume all reads come from the same sample.")),
        ("--include-haploid-sets", dict(default=False, action="store_true",
            help="Include the phase set information for every single haplotype in a custom VCF format field 'HS'.")),
        ("--sample", dict(dest="samples", metavar="SAMPLE", default=[], action="append",
            help="Name of a sample to phase. If not given, all samples in the input VCF are phased. Can be used multiple times.")),
        ("--chromosome", dict(dest="chromosomes", metavar="CHROMOSOME", default=[], action="append",
            help="Name of chromosome to phase. If not given, all chromosomes in the input VCF are phased. Can be used multiple times.")),
        ("--exclude-chromosome", dict(dest="excluded_chromosomes", default=[], action="append",
            help="Name of chromosome not to phase.")),
        ("--distrust-genotypes", dict(dest="distrust_genotypes", action="store_true", default=False,
            help="Allows the phaser to change genotypes if beneficial for the internal model.")),
    ]),
    (("Parameters for phasing steps", None), [
        (("--ploidy", "-p"), dict(metavar="PLOIDY", type=int, required=True,
            help="The ploidy of the sample(s). Argument is required.")),
        ("--use-prephasing", dict(dest="use_prephasing", action="store_true", default=False,
            help="Uses existing phase set blocks in the input to increase contiguity of phasing output.")),
        ("--min-overlap", dict(metavar="OVERLAP", type=int, default=2,
            help="Minimum required read overlap for internal read clustering stage (default: %(default)s).")),
        (("--block-cut-sensitivity", "-B"), dict(metavar="SENSITIVITY", type=int,
            dest="block_cut_sensitivity", default=4,
            help="Strategy to determine block borders. 0 yields the longest blocks with more switch errors, 5 has the shortest blocks with lowest switch error rate (default: %(default)s).")),
        (("--threads", "-t"), dict(metavar="THREADS", type=int, default=1,
            help="Maximum number of CPU threads used (default: %(default)s).")),
        ("--no-mav", dict(dest="mav", default=True, action="store_false",
            help="Disables phasing of multi-allelic variants.")),
        ("--use-supplementary", dict(dest="use_supplementary", action="store_true", default=False,
            help="Use also supplementary alignments (default: ignore supplementary_ alignments)")),
        ("--supplementary-distance", dict(metavar="DIST", type=int,
            dest="supplementary_distance_threshold", default=100_000,
            help="Skip supplementary alignments further than DIST bp away from the primary alignment (default: %(default)s)")),
        ("--ce-bundle-edges", dict(dest="ce_bundle_edges", default=False, action="store_true",
            help=argparse.SUPPRESS)),
        ("--plot-clusters", dict(dest="plot_clusters", default=False, action="store_true",
            help=argparse.SUPPRESS)),
        ("--plot-threading", dict(dest="plot_threading", default=False, action="store_true",
            help=argparse.SUPPRESS)),
        ("--verify-genotypes", dict(default=False, action="store_true", help=argparse.SUPPRESS)),
    ]),
]


def add_arguments(parser):
    populate_arg_parser(parser, POLYPHASE_ARGUMENTS)


def validate(args, parser):
    if args.block_cut_sensitivity > 5 or args.block_cut_sensitivity < 0:
        parser.error("Block cut sensitivity must be an integer value between 0 and 5.")
    if args.indels_used:
        logger.warning("Ignoring --indels as indel phasing is default in WhatsHap 2.0+")
    if args.verify_genotypes:
        logger.warning("Ignoring deprecated option --verify-genotypes.")


def run_polyphase(
    phase_input_files: Sequence[str], variant_file: str, ploidy: int,
    reference: Optional[str] = None, output: TextIO = sys.stdout,
    samples: Optional[Sequence[str]] = None,
    chromosomes: Optional[List[str]] = None,
    excluded_chromosomes: Optional[List[str]] = None,
    ignore_read_groups: bool = False, only_snvs: bool = False,
    mapping_quality: int = 20, distrust_genotypes: bool = False,
    tag: str = "PS", read_list_filename: Optional[str] = None,
    write_command_line_header: bool = True, include_haploid_sets: bool = False,
    block_cut_sensitivity=4, min_overlap: int = 2, mav: bool = True,
    threads: int = 1, use_supplementary: bool = False,
    supplementary_distance_threshold: int = 100_000,
    use_prephasing: bool = False, ce_bundle_edges: bool = False,
    plot_clusters: bool = False, plot_threading: bool = False,
):
    """Polyploid phasing pipeline (reference: whatshap/cli/polyphase.py
    run_polyphase)."""
    timers = StageTimer()
    logger.info(
        "This is WhatsHap (polyploid) %s running under Python %s",
        __version__,
        platform.python_version(),
    )
    numeric_sample_ids = NumericSampleIds()
    with ExitStack() as stack:
        assert phase_input_files
        phased_input_reader = stack.enter_context(
            PhasedInputReader(
                phase_input_files,
                reference,
                numeric_sample_ids,
                ignore_read_groups,
                only_snvs=only_snvs,
                mapq_threshold=mapping_quality,
                use_supplementary=use_supplementary,
                supplementary_distance_threshold=supplementary_distance_threshold,
            )
        )
        assert not phased_input_reader.has_vcfs

        command_line = (
            "(whatshap {}) {}".format(__version__, " ".join(sys.argv[1:]))
            if write_command_line_header
            else None
        )
        try:
            vcf_writer: PhasedVcfWriter = stack.enter_context(
                PhasedVcfWriter(
                    command_line=command_line, in_path=variant_file,
                    out_file=output, tag=tag, ploidy=ploidy, only_snvs=only_snvs,
                    include_haploid_sets=include_haploid_sets, mav=mav,
                )
            )
        except OSError as e:
            raise CommandLineError(e)

        vcf_reader = stack.enter_context(
            VcfReader(
                variant_file, only_snvs=only_snvs, phases=True,
                genotype_likelihoods=False, ploidy=ploidy, mav=mav,
            )
        )

        if ignore_read_groups and not samples and len(vcf_reader.samples) > 1:
            raise CommandLineError(
                "When using --ignore-read-groups on a VCF with "
                "multiple samples, --sample must also be used."
            )
        if not samples:
            samples = vcf_reader.samples
        known = set(vcf_reader.samples)
        for sample in samples:
            if sample not in known:
                raise CommandLineError(
                    f"Sample {sample!r} requested on command-line not found in VCF"
                )

        if use_prephasing and block_cut_sensitivity > 1:
            logger.info(
                "Consider using '-B 0' or '-B 1' when adding pre-phasings from another source."
            )
        samples = frozenset(samples)

        if read_list_filename:
            raise NotImplementedError("create_read_list_file not implemented")

        param = PolyphaseParameter(
            ploidy=ploidy, ce_bundle_edges=ce_bundle_edges,
            distrust_genotypes=distrust_genotypes, min_overlap=min_overlap,
            block_cut_sensitivity=block_cut_sensitivity,
            plot_clusters=plot_clusters, plot_threading=plot_threading,
            plot_path=output if type(output) is str else output.name,
            threads=threads, use_prephasing=use_prephasing,
        )

        try:
            wanted = ChromosomeFilter(chromosomes, excluded_chromosomes)
            for variant_table in timers.iterate("parse_vcf", vcf_reader):
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
                components, haploid_components, superreads = phase_single_chromosome(
                    variant_table, phased_input_reader, samples, timers, param
                )
                with timers("write_vcf"):
                    logger.info("======== Writing VCF")
                    vcf_writer.write(
                        chromosome,
                        superreads,
                        components,
                        haploid_components if include_haploid_sets else None,
                    )
                    logger.info("Done writing VCF")
                logger.debug("Chromosome %r finished", chromosome)
        except PloidyError as e:
            raise CommandLineError(e)

    logger.info("\n== SUMMARY ==")
    log_memory_usage(include_children=(threads > 1))
    # fmt: off
    logger.info("Time spent reading BAM/CRAM:         %6.1f s", timers.elapsed("read_bam"))
    logger.info("Time spent parsing VCF:              %6.1f s", timers.elapsed("parse_vcf"))
    logger.info("Time spent detecting blocks:         %6.1f s", timers.elapsed("detecting_blocks"))
    if threads == 1:
        logger.info("Time spent scoring reads:            %6.1f s", timers.elapsed("read_scoring"))
        logger.info("Time spent solving cluster editing:  %6.1f s", timers.elapsed("clustering"))
        logger.info("Time spent threading haplotypes:     %6.1f s", timers.elapsed("threading"))
        logger.info("Time spent reordering haplotypes:    %6.1f s", timers.elapsed("reordering"))
    else:
        logger.info("Time spent phasing blocks:           %6.1f s", timers.elapsed("phase_blocks"))
    if plot_clusters or plot_threading:
        logger.info("Time spent creating plots:           %6.1f s", timers.elapsed("create_plots"))
    logger.info("Time spent writing VCF:              %6.1f s", timers.elapsed("write_vcf"))
    logger.info("Time spent on rest:                  %6.1f s", timers.total() - timers.sum())
    logger.info("Total elapsed time:                  %6.1f s", timers.total())
    # fmt: on


def phase_single_chromosome(
    variant_table: VariantTable,
    phased_input_reader: PhasedInputReader,
    samples: FrozenSet[str],
    timers: StageTimer,
    param: PolyphaseParameter,
) -> Tuple[
    Dict[str, Dict[Position, int]], Dict[str, Dict[Position, List[int]]], Dict[str, ReadSet]
]:
    chromosome = variant_table.chromosome
    superreads: Dict[str, ReadSet] = {}
    components: Dict[str, Dict[Position, int]] = {}
    haploid_components: Dict[str, Dict[Position, List[int]]] = {}

    for sample in samples:
        logger.info("---- Processing individual %s", sample)

        genotypes = variant_table.genotypes_of(sample)
        missing = {i for i, gt in enumerate(genotypes) if gt.is_none()}
        heterozygous = {
            i for i, gt in enumerate(genotypes) if not gt.is_none() and not gt.is_homozygous()
        }
        phasable_table = variant_table.create_subtable([sample])
        phasable_table.remove_rows_by_index(set(range(len(variant_table))) - heterozygous)

        logger.info("Number of variants skipped due to missing genotypes: %d", len(missing))
        logger.info("Number of remaining heterozygous variants: %d", len(phasable_table))
        if len(phasable_table) < 2:
            logger.debug("Skipped phasing because there is only one variant")
            continue

        with timers("read_bam"):
            readset, _ = phased_input_reader.read(chromosome, phasable_table.variants, sample)
            readset.sort()

        min_len = max(2, param.min_overlap)
        readset = readset.subset([i for i, read in enumerate(readset) if len(read) >= min_len])
        if len(readset) == 0:
            logger.debug("Skipped phasing because no suitable reads remain")
            continue
        logger.info("Kept %d reads that cover at least two variants each", len(readset))
        phasable_table.subset_rows_by_position(readset.get_positions())

        components[sample], haploid_components[sample], superreads[sample] = (
            phase_single_individual(readset, phasable_table, sample, param, timers)
        )
        del phasable_table

    return components, haploid_components, superreads


def _spread_cut_blocks(cuts, accessible_pos, num_vars, assign):
    """Call assign(position, block_start_position) for every variant of
    every cut-delimited block (and for position+1, covering the VCF's
    1-based PS convention)."""
    bounds = cuts + [num_vars]
    for start, end in zip(bounds[:-1], bounds[1:]):
        anchor = accessible_pos[start]
        for pos in range(start, end):
            assign(accessible_pos[pos], anchor)
            assign(accessible_pos[pos] + 1, anchor)


def phase_single_individual(
    readset: ReadSet,
    phasable_variant_table: VariantTable,
    sample: str,
    param: PolyphaseParameter,
    timers: StageTimer,
) -> Tuple[Dict[Position, int], Dict[Position, List[int]], ReadSet]:
    genotype_list = create_genotype_list(phasable_variant_table, sample)

    prephasing = None
    if param.use_prephasing:
        prephasing = extract_partial_phasing(phasable_variant_table, sample, param.ploidy)
        if prephasing is None:
            logger.warning(
                f"Input VCF does not contain any phased blocks for {sample}. "
                "No pre-phasing will be used for this sample."
            )

    allele_matrix = AlleleMatrix(readset)
    result = solve_polyphase_instance(allele_matrix, genotype_list, param, timers, prephasing)
    cuts, hap_cuts = compute_cut_positions(
        result.breakpoints, param.ploidy, param.block_cut_sensitivity
    )

    accessible_pos = sorted(readset.get_positions())
    num_vars = len(accessible_pos)

    components: Dict[Position, int] = {}
    haploid_components: Dict[Position, List[int]] = {}

    def assign_component(position, anchor):
        components[position] = anchor
        haploid_components[position] = [0] * param.ploidy

    _spread_cut_blocks(cuts, accessible_pos, num_vars, assign_component)

    for j in range(param.ploidy):
        def assign_haploid(position, anchor, j=j):
            haploid_components[position][j] = anchor

        _spread_cut_blocks(hap_cuts[j], accessible_pos, num_vars, assign_haploid)

    superreads = ReadSet()
    fully_phased = [
        i for i in range(num_vars) if all(h[i] != -1 for h in result.haplotypes)
    ]
    for i in range(param.ploidy):
        read = Read(f"superread {i + 1}", 0, 0)
        for j in fully_phased:
            read.add_variant(accessible_pos[j], result.haplotypes[i][j], 0)
        superreads.add(read)

    if param.plot_clusters or param.plot_threading:
        with timers("create_plots"):
            draw_plots(
                readset,
                result,
                cuts,
                phasable_variant_table,
                param.plot_clusters,
                param.plot_threading,
                param.plot_path,
            )

    return components, haploid_components, superreads


def main(args):
    del args.indels_used
    del args.verify_genotypes
    run_polyphase(**vars(args))
