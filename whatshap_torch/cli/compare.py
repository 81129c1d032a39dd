"""
Compare two or more phased variant files
"""

import dataclasses
import logging
import math
from collections import defaultdict
from contextlib import ExitStack
from dataclasses import dataclass, field
from itertools import chain, permutations
from typing import DefaultDict, Dict, List, Optional, Set, Tuple

from ..core import Genotype
from ..polyphase.solver import SwitchFlipCalculator
from ..vcf import PloidyError, VariantTable, VcfReader, VcfVariant
from . import CommandLineError, populate_arg_parser

logger = logging.getLogger(__name__)

COUNT_WIDTH = 9


COMPARE_ARGUMENTS = [
    (None, [
        ("--sample", dict(metavar="SAMPLE", default=None,
            help="Name of the sample to process. If not given, use first sample found in VCF.")),
        ("--names", dict(metavar="NAMES", default=None,
            help="Comma-separated list of data set names to be used in the report (in same order as VCFs).")),
        ("--ignore-sample-name", dict(default=False, action="store_true",
            help="For single sample VCFs, ignore sample name and assume all samples are the same.")),
        ("--tsv-pairwise", dict(metavar="TSVPAIRWISE", default=None,
            help="Filename to write comparison results from pair-wise comparison to (tab-separated).")),
        ("--tsv-multiway", dict(metavar="TSVMULTIWAY", default=None,
            help="Filename to write comparison results from multiway comparison to (tab-separated). Only for diploid VCFs.")),
        ("--only-snvs", dict(default=False, action="store_true",
            help="Only process SNVs and ignore all other variants.")),
        ("--switch-error-bed", dict(default=None,
            help="Write BED file with switch error positions to given filename. Only for diploid VCFs.")),
        ("--plot-blocksizes", dict(default=None,
            help="Write PDF file with a block length histogram to given filename (requires matplotlib).")),
        ("--plot-sum-of-blocksizes", dict(default=None,
            help="Write PDF file with a block length histogram in which the height of each bar corresponds to the sum of lengths.")),
        ("--longest-block-tsv", dict(default=None,
            help="Write position-wise agreement of longest joint blocks in each chromosome to tab-separated file. Only for diploid VCFs.")),
        (("--ploidy", "-p"), dict(metavar="PLOIDY", type=int, default=2,
            help="The ploidy of the sample(s) (default: %(default)s).")),
        ("vcf", dict(nargs="+", metavar="VCF/BCF",
            help="At least two phased variant files (VCF or BCF) to be compared.")),
    ]),
]


def add_arguments(parser):
    populate_arg_parser(parser, COMPARE_ARGUMENTS)


def validate(args, parser):
    if len(args.vcf) < 2:
        parser.error("At least two VCFs need to be given.")
    if args.ploidy < 2:
        parser.error("Ploidy must be > 1.")
    if args.ploidy > 2 and args.tsv_multiway:
        parser.error("Option --tsv-multiway can only be used if ploidy=2.")
    if args.ploidy > 2 and args.switch_error_bed:
        parser.error("Option --switch-error-bed can only be used if ploidy=2.")
    if args.ploidy > 2 and args.longest_block_tsv:
        parser.error("Option --longest-block-tsv can only be used if ploidy=2.")


# ---------------------------------------------------------------------------
# error accounting


class SwitchFlips:
    # deliberately NOT a dataclass: PairwiseComparisonResults is flattened
    # with dataclasses.astuple, which must stringify this via __str__
    # ("s/f") instead of recursing into fields
    def __init__(self, switches: int = 0, flips: int = 0):
        self.switches = switches
        self.flips = flips

    def __iadd__(self, other):
        self.switches += other.switches
        self.flips += other.flips
        return self

    def __repr__(self):
        return f"SwitchFlips(switches={self.switches}, flips={self.flips})"

    def __str__(self):
        return f"{self.switches}/{self.flips}"


@dataclass
class PhasingErrors:
    switches: int = 0
    hamming: int = 0
    switch_flips: SwitchFlips = field(default_factory=SwitchFlips)
    diff_genotypes: int = 0

    def __iadd__(self, other):
        if not isinstance(other, PhasingErrors):
            raise TypeError("Can only add to PhasingErrors")
        self.switches += other.switches
        self.hamming += other.hamming
        self.switch_flips += other.switch_flips
        self.diff_genotypes += other.diff_genotypes
        return self


# ---------------------------------------------------------------------------
# bit-string primitives


_COMPLEMENT_TABLE = str.maketrans("01", "10")


def complement(s: str) -> str:
    """
    >>> complement('01100')
    '10011'
    """
    return s.translate(_COMPLEMENT_TABLE)


def hamming(s0, s1) -> int:
    """
    >>> hamming('ABCD', 'AXCY')
    2
    """
    assert len(s0) == len(s1)
    return sum(a != b for a, b in zip(s0, s1))


def switch_encoding(phasing: str) -> str:
    """
    >>> switch_encoding('0001011')
    '001110'
    """
    assert isinstance(phasing, str)
    return "".join("0" if a == b else "1" for a, b in zip(phasing, phasing[1:]))


def compute_switch_flips(phasing0, phasing1) -> SwitchFlips:
    """Decompose the disagreeing switch points greedily: every pair of
    adjacent disagreements is one flip, a leftover lone disagreement is one
    switch (reference: whatshap/cli/compare.py:137-160).

    >>> compute_switch_flips("00011", "00100")
    SwitchFlips(switches=1, flips=0)
    >>> compute_switch_flips("00011", "00111")
    SwitchFlips(switches=0, flips=1)
    >>> compute_switch_flips("000", "001")
    SwitchFlips(switches=1, flips=0)
    """
    assert len(phasing0) == len(phasing1)
    s0 = switch_encoding(phasing0)
    s1 = switch_encoding(phasing1)
    out = SwitchFlips()
    run = 0
    for i, (a, b) in enumerate(zip(s0, s1)):
        if a != b:
            run += 1
        if i + 1 == len(s0) or a == b:
            out.flips += run // 2
            out.switches += run % 2
            run = 0
    return out


# ---------------------------------------------------------------------------
# polyploid comparison


def _assert_rectangular(phasing0, phasing1):
    assert len(phasing0) == len(phasing1)
    assert len(phasing0) >= 2
    assert len(phasing0[0]) == len(phasing1[0])
    assert all(len(h) == len(phasing0[0]) for h in phasing0[1:])


def compute_matching_genotype_pos(phasing0, phasing1):
    """Column indices where both phasings imply the same genotype."""
    _assert_rectangular(phasing0, phasing1)
    n = len(phasing0[0])
    return [
        i
        for i in range(n)
        if Genotype([int(h[i]) for h in phasing0]) == Genotype([int(h[i]) for h in phasing1])
    ]


def compute_switch_errors_poly(phasing0, phasing1, matching_pos=None) -> int:
    """Minimum switches transforming phasing0 into phasing1 (polyploid);
    columns with disagreeing genotypes are dropped first."""
    _assert_rectangular(phasing0, phasing1)
    if matching_pos is None:
        matching_pos = compute_matching_genotype_pos(phasing0, phasing1)
    kept0 = ["".join(h[i] for i in matching_pos) for h in phasing0]
    kept1 = ["".join(h[i] for i in matching_pos) for h in phasing1]
    # flips priced out of reach -> pure switch count
    prohibitive = 2 * len(phasing0[0]) * len(phasing0) + 1
    errors = compute_switch_flips_poly(kept0, kept1, switch_cost=1, flip_cost=prohibitive)
    assert errors.flips == 0
    return errors.switches


def compute_switch_flips_poly(phasing0, phasing1, switch_cost=1, flip_cost=1) -> SwitchFlips:
    """Combined switch+flip distance between two polyploid phasings."""
    result, _, _, _ = compute_switch_flips_poly_bt(
        phasing0, phasing1, switch_cost=switch_cost, flip_cost=flip_cost
    )
    return result


def compute_switch_flips_poly_bt(
    phasing0, phasing1, report_error_positions=False, switch_cost=1, flip_cost=1
):
    if len(phasing0) != len(phasing1):
        logger.error(
            "Incompatible phasings. Number of haplotypes is not equal "
            f"({len(phasing0)} != {len(phasing1)})."
        )
    assert len(phasing0) == len(phasing1)
    ploidy = len(phasing0)
    if ploidy == 0 or len(phasing0[0]) == 0:
        return SwitchFlips(), None, None, None
    for h0, h1 in zip(phasing0, phasing1):
        assert len(h0) == len(phasing0[0])
        assert len(h1) == len(phasing0[0])
    if ploidy > 6:
        logger.warning(
            "Computing vector error with more than 6 haplotypes. This may take very long ..."
        )

    calculator = SwitchFlipCalculator(ploidy, switch_cost, flip_cost)
    switches, flips, per_col_switches, per_col_flips, positionwise_config = (
        calculator.compute_switch_flips_poly(phasing0, phasing1)
    )
    out = SwitchFlips(switches=switches / ploidy, flips=flips / ploidy)
    return out, per_col_switches, per_col_flips, positionwise_config


def compare_block(phasing0, phasing1) -> PhasingErrors:
    """All error measures between two blocks of haplotype strings."""
    assert len(phasing0) == len(phasing1)
    ploidy = len(phasing0)

    best_hamming = min(
        sum(hamming(h1, hp) for h1, hp in zip(phasing1, perm)) / float(ploidy)
        for perm in permutations(phasing0)
    )
    matching_pos = compute_matching_genotype_pos(phasing0, phasing1)

    if ploidy == 2:
        switches = int(hamming(switch_encoding(phasing0[0]), switch_encoding(phasing1[0])))
        switch_flips = compute_switch_flips(phasing0[0], phasing1[0])
        best_hamming = int(best_hamming)
    else:
        switches = compute_switch_errors_poly(phasing0, phasing1, matching_pos)
        switch_flips = compute_switch_flips_poly(phasing0, phasing1)

    return PhasingErrors(
        switches=switches,
        hamming=best_hamming,
        switch_flips=switch_flips,
        diff_genotypes=len(phasing0[0]) - len(matching_pos),
    )


# ---------------------------------------------------------------------------
# report formatting


def fraction2percentstr(nominator, denominator) -> str:
    return "--" if denominator == 0 else f"{nominator * 100.0 / denominator:.2f}%"


def safefraction(nominator, denominator) -> float:
    return float("nan") if denominator == 0 else nominator / denominator


def print_stat(text: str, value=None, value2=None, text_width=37):
    text = text.rjust(text_width)
    if value is None:
        assert value2 is None
        print(text)
        return
    value = "-" * COUNT_WIDTH if value == "-" else str(value).rjust(COUNT_WIDTH)
    if value2 is None:
        print(text + ":", value)
    else:
        print(text + ":", value, str(value2).rjust(COUNT_WIDTH))


def print_errors(errors, phased_pairs):
    print_stat("phased pairs of variants assessed", phased_pairs)
    print_stat("switch errors", errors.switches)
    print_stat("switch error rate", fraction2percentstr(errors.switches, phased_pairs))
    print_stat("switch/flip decomposition", errors.switch_flips)
    print_stat(
        "switch/flip rate",
        fraction2percentstr(errors.switch_flips.switches + errors.switch_flips.flips, phased_pairs),
    )


@dataclasses.dataclass
class PairwiseComparisonResults:
    intersection_blocks: int
    covered_variants: int
    all_assessed_pairs: int
    all_switches: int
    all_switch_rate: float
    all_switchflips: SwitchFlips
    all_switchflip_rate: float
    blockwise_hamming: int
    blockwise_hamming_rate: int
    blockwise_diff_genotypes: int
    blockwise_diff_genotypes_rate: int
    largestblock_assessed_pairs: int
    largestblock_switches: int
    largestblock_switch_rate: float
    largestblock_switchflips: SwitchFlips
    largestblock_switchflip_rate: float
    largestblock_hamming: int
    largestblock_hamming_rate: float
    largestblock_diff_genotypes: int
    largestblock_diff_genotypes_rate: float


@dataclasses.dataclass
class BlockStats:
    variant_count: int
    span: int


class BedCreator:
    def __init__(self, chromosome: str, dataset_names: List[str]):
        self._chromosome = chromosome
        self._annotation = "{}<-->{}".format(*dataset_names)

    def records(self, phasing0, phasing1, positions):
        """One BED tuple per disagreeing switch position."""
        assert len(phasing0) == len(phasing1) == len(positions)
        for i, (sw0, sw1) in enumerate(
            zip(switch_encoding(phasing0), switch_encoding(phasing1))
        ):
            if sw0 != sw1:
                yield (self._chromosome, positions[i] + 1, positions[i + 1] + 1, self._annotation)


# ---------------------------------------------------------------------------
# block collection


def collect_common_variants(
    variant_tables: List[VariantTable], sample_names: List[str]
) -> Set[VcfVariant]:
    common: Optional[Set[VcfVariant]] = None
    for table, sample in zip(variant_tables, sample_names):
        hets = {
            v
            for v, gt in zip(table.variants, table.genotypes_of(sample))
            if not gt.is_homozygous()
        }
        common = hets if common is None else (common & hets)
    assert common is not None
    return common


def compute_block_stats(blocks, sorted_variants: List[VcfVariant]):
    per_dataset = []
    for block_map in blocks:
        stats = []
        for indices in block_map.values():
            if len(indices) < 2:
                continue
            span = sorted_variants[indices[-1]].position - sorted_variants[indices[0]].position
            stats.append(BlockStats(len(indices), span))
        per_dataset.append(stats)
    return per_dataset


def compare(
    variant_tables: List[VariantTable],
    sample_names: List[str],
    dataset_names: List[str],
    ploidy: int,
):
    """Compare the phasings in the given tables (two -> pairwise report,
    more -> multiway)."""
    assert len(variant_tables) > 1

    common_variants = collect_common_variants(variant_tables, sample_names)
    print_stat("common heterozygous variants", len(common_variants))
    print_stat("(restricting to these below)")

    sorted_variants = sorted(common_variants, key=lambda v: v.position)
    phases = []
    for table, sample in zip(variant_tables, sample_names):
        selected = [
            phase
            for variant, phase in zip(table.variants, table.phases_of(sample))
            if variant in common_variants
        ]
        assert [v for v in table.variants if v in common_variants] == sorted_variants
        assert len(selected) == len(common_variants)
        phases.append(selected)

    # per dataset: block id -> indices into sorted_variants; plus the
    # intersection blocks (joint id across all datasets)
    blocks: List[DefaultDict[int, List[int]]] = [defaultdict(list) for _ in variant_tables]
    block_intersection = defaultdict(list)
    for i in range(len(common_variants)):
        complete = True
        for dataset, dataset_phases in enumerate(phases):
            phase = dataset_phases[i]
            if phase is None or any(allele is None for allele in phase.phase):
                complete = False
            else:
                blocks[dataset][phase.block_id].append(i)
        if complete:
            joint_id = tuple(dataset_phases[i].block_id for dataset_phases in phases)
            block_intersection[joint_id].append(i)

    block_stats = compute_block_stats(blocks, sorted_variants)

    for name, block_map in zip(dataset_names, blocks):
        nonsingleton = [b for b in block_map.values() if len(b) > 1]
        print_stat(f"non-singleton blocks in {name}", len(nonsingleton))
        print_stat("--> covered variants", sum(len(b) for b in nonsingleton))

    intersection_nonsingleton = [b for b in block_intersection.values() if len(b) > 1]
    intersection_block_count = len(intersection_nonsingleton)
    intersection_block_variants = sum(len(b) for b in intersection_nonsingleton)
    print_stat("non-singleton intersection blocks", intersection_block_count)
    print_stat("--> covered variants", intersection_block_variants)

    if len(variant_tables) == 2:
        bed_records, agreement, positions, pairwise = compare_pair(
            block_intersection,
            intersection_block_count,
            intersection_block_variants,
            phases,
            ploidy,
            sorted_variants,
            BedCreator(variant_tables[0].chromosome, dataset_names),
        )
        return pairwise, bed_records, block_stats, positions, agreement, None
    assert ploidy == 2
    multiway = compare_multiway(block_intersection, dataset_names, phases)
    return None, None, block_stats, None, None, multiway


def compare_pair(
    block_intersection,
    intersection_block_count,
    intersection_block_variants,
    phases,
    ploidy,
    sorted_variants,
    bed_creator: Optional[BedCreator],
):
    total = PhasingErrors()
    total_pairs = 0
    total_variants = 0
    bed_records = []
    longest = 0
    longest_errors = PhasingErrors()
    longest_positions: List[int] = []
    longest_agreement: List[int] = []

    for block in block_intersection.values():
        if len(block) < 2:
            continue
        phasing0 = ["".join(str(phases[0][i].phase[j]) for i in block) for j in range(ploidy)]
        phasing1 = ["".join(str(phases[1][i].phase[j]) for i in block) for j in range(ploidy)]
        positions = [sorted_variants[i].position for i in block]
        errors = compare_block(phasing0, phasing1)

        if ploidy == 2 and bed_creator is not None:
            bed_records.extend(bed_creator.records(phasing0[0], phasing1[0], positions))
        total += errors
        total_pairs += len(block) - 1
        total_variants += len(block)
        if len(block) > longest:
            longest = len(block)
            longest_errors = errors
            longest_positions = positions
            if ploidy == 2:
                direct = hamming(phasing0, phasing1)
                flipped = hamming(phasing0[0], complement(phasing1[0]))
                if direct < flipped:
                    longest_agreement = [
                        1 * (a == b) for a, b in zip(phasing0[0], phasing1[0])
                    ]
                else:
                    longest_agreement = [
                        1 * (a != b) for a, b in zip(phasing0[0], phasing1[0])
                    ]

    longest_pairs = max(longest - 1, 0)
    print_stat("ALL INTERSECTION BLOCKS", "-")
    print_errors(total, total_pairs)
    print_stat("Block-wise Hamming distance", total.hamming)
    print_stat(
        "Block-wise Hamming distance [%]", fraction2percentstr(total.hamming, total_variants)
    )
    print_stat("Different genotypes", total.diff_genotypes)
    print_stat(
        "Different genotypes [%]", fraction2percentstr(total.diff_genotypes, total_variants)
    )
    print_stat("LARGEST INTERSECTION BLOCK", "-")
    print_errors(longest_errors, longest_pairs)
    print_stat("Hamming distance", longest_errors.hamming)
    print_stat("Hamming distance [%]", fraction2percentstr(longest_errors.hamming, longest))
    print_stat("Different genotypes", longest_errors.diff_genotypes)
    print_stat(
        "Different genotypes [%]", fraction2percentstr(longest_errors.diff_genotypes, longest)
    )

    pairwise = PairwiseComparisonResults(
        intersection_blocks=intersection_block_count,
        covered_variants=intersection_block_variants,
        all_assessed_pairs=total_pairs,
        all_switches=total.switches,
        all_switch_rate=safefraction(total.switches, total_pairs),
        all_switchflips=total.switch_flips,
        all_switchflip_rate=safefraction(
            total.switch_flips.switches + total.switch_flips.flips, total_pairs
        ),
        blockwise_hamming=total.hamming,
        blockwise_hamming_rate=safefraction(total.hamming, total_variants),
        blockwise_diff_genotypes=total.diff_genotypes,
        blockwise_diff_genotypes_rate=safefraction(total.diff_genotypes, total_variants),
        largestblock_assessed_pairs=longest_pairs,
        largestblock_switches=longest_errors.switches,
        largestblock_switch_rate=safefraction(longest_errors.switches, longest_pairs),
        largestblock_switchflips=longest_errors.switch_flips,
        largestblock_switchflip_rate=safefraction(
            longest_errors.switch_flips.switches + longest_errors.switch_flips.flips,
            longest_pairs,
        ),
        largestblock_hamming=longest_errors.hamming,
        largestblock_hamming_rate=safefraction(longest_errors.hamming, longest),
        largestblock_diff_genotypes=longest_errors.diff_genotypes,
        largestblock_diff_genotypes_rate=safefraction(longest_errors.diff_genotypes, longest),
    )
    return bed_records, longest_agreement, longest_positions, pairwise


def compare_multiway(block_intersection, dataset_names, phases):
    histogram: Dict[str, int] = defaultdict(int)
    total_compared = 0
    for block in block_intersection.values():
        if len(block) < 2:
            continue
        total_compared += len(block) - 1
        encodings = [
            switch_encoding("".join(str(phases[j][i].phase[0]) for i in block))
            for j in range(len(phases))
        ]
        for i in range(len(block) - 1):
            pattern = "".join(e[i] for e in encodings)
            histogram[min(pattern, complement(pattern))] += 1

    print_stat("Compared pairs of variants", total_compared)
    results = {}
    for rank, pattern in enumerate(sorted(histogram)):
        count = histogram[pattern]
        if rank == 0:
            assert set(pattern) == {"0"}
            print("ALL AGREE")
        elif rank == 1:
            print("DISAGREEMENT")
        left = [n for n, c in zip(dataset_names, pattern) if c == "0"]
        right = [n for n, c in zip(dataset_names, pattern) if c != "0"]
        print_stat(
            "{{{}}} vs. {{{}}}".format(",".join(left), ",".join(right)),
            count,
            fraction2percentstr(count, total_compared),
        )
        results[(",".join(left), ",".join(right))] = count
    return results


# ---------------------------------------------------------------------------
# plots


def create_blocksize_histogram(filename, block_stats, names, use_weights=False):
    try:
        import matplotlib
        import numpy

        matplotlib.use("pdf")
        from matplotlib import pyplot
        from matplotlib.backends.backend_pdf import PdfPages
    except ImportError:
        raise CommandLineError(
            "To use option --plot-blocksizes, you need to have numpy and matplotlib installed."
        )

    assert len(block_stats) == len(names)
    palette = ["#ffa347", "#0064c8", "#b42222", "#22a5b4", "#b47c22", "#6db6ff"]
    if len(palette) < len(block_stats):
        palette = pyplot.cm.Set1([n / len(block_stats) for n in range(len(block_stats))])
    colors = palette[: len(block_stats)]

    with PdfPages(filename) as pdf:
        for measure, xlabel in [
            (lambda stats: stats.variant_count, "variant count"),
            (lambda stats: stats.span, "span [bp]"),
        ]:
            top = max(measure(stats) for stats in chain(*block_stats))

            pyplot.figure(figsize=(10, 8))
            bins = numpy.logspace(0, math.ceil(math.log10(top)), 50)
            for stats_list, name, color in zip(block_stats, names, colors):
                xs = [measure(stats) for stats in stats_list]
                pyplot.hist(
                    xs, bins=bins, alpha=0.6, color=color, label=name,
                    weights=xs if use_weights else None,
                )
            _finish_hist_page(pyplot, pdf, xlabel)

            pyplot.figure(figsize=(10, 8))
            bins = numpy.logspace(0, math.ceil(math.log10(top)), 25)
            xs = [[measure(stats) for stats in stats_list] for stats_list in block_stats]
            pyplot.hist(
                xs, bins=bins, alpha=0.6, color=colors, label=names,
                weights=xs if use_weights else None,
            )
            _finish_hist_page(pyplot, pdf, xlabel)


def _finish_hist_page(pyplot, pdf, xlabel):
    pyplot.xlabel(xlabel)
    pyplot.ylabel("Number of blocks")
    pyplot.gca().set_xscale("log")
    pyplot.gca().set_yscale("log")
    pyplot.grid(True)
    pyplot.legend()
    pdf.savefig()
    pyplot.close()


# ---------------------------------------------------------------------------
# input resolution


def get_common_chromosomes(vcfs: List[Dict[str, VariantTable]]) -> List[str]:
    common: Optional[Set[str]] = None
    for tables in vcfs:
        common = set(tables) if common is None else (common & set(tables))
    return sorted(common) if common else []


def get_variant_tables(
    vcf_readers: List[VcfReader], vcf_filenames: List[str]
) -> List[Dict[str, VariantTable]]:
    vcfs = []
    for reader, filename in zip(vcf_readers, vcf_filenames):
        logger.info("Reading phasing from %r", filename)
        try:
            vcfs.append({table.chromosome: table for table in reader})
        except PloidyError as e:
            raise CommandLineError(f"Provided ploidy is invalid: {e}. Aborting.")
    return vcfs


def get_sample_names(
    vcf_readers: List[VcfReader], requested_sample: Optional[str], ignore_name: bool = False
) -> List[str]:
    first_samples = []
    shared: Optional[Set[str]] = None
    for reader in vcf_readers:
        shared = set(reader.samples) if shared is None else (shared & set(reader.samples))
        if ignore_name and len(reader.samples) > 1:
            raise CommandLineError(
                "File '{file}' contains multiple samples, option --ignore-sample-name "
                "not available.".format(file=reader.path)
            )
        first_samples.append(reader.samples[0])
    assert shared is not None
    if requested_sample:
        if requested_sample not in shared:
            raise CommandLineError(
                "Sample {!r} requested on command-line not found in all VCFs".format(
                    requested_sample
                )
            )
        return [requested_sample] * len(vcf_readers)
    if ignore_name:
        return first_samples
    if len(shared) == 0:
        raise CommandLineError("None of the samples is present in all VCFs")
    if len(shared) > 1:
        raise CommandLineError(
            "More than one sample is present in all VCFs, please use"
            " --sample to specify which sample to work on."
        )
    return [next(iter(shared))] * len(vcf_readers)


# ---------------------------------------------------------------------------
# entry point


class _ReportFiles:
    """All optional TSV/BED outputs, opened once with their headers."""

    def __init__(self, stack, tsv_pairwise, tsv_multiway, longest_block_tsv, switch_error_bed):
        self.pairwise = self.multiway = self.longest_block = self.bed = None
        if tsv_pairwise:
            self.pairwise = stack.enter_context(open(tsv_pairwise, "w"))
            header = [
                "#sample", "chromosome", "dataset_name0", "dataset_name1",
                "file_name0", "file_name1",
            ]
            header += [f.name for f in dataclasses.fields(PairwiseComparisonResults)]
            header += ["het_variants0", "only_snvs"]
            print(*header, sep="\t", file=self.pairwise)
        if tsv_multiway:
            self.multiway = stack.enter_context(open(tsv_multiway, "w"))
            print(
                "#sample", "chromosome", "dataset_list0", "dataset_list1", "count",
                sep="\t", file=self.multiway,
            )
        if longest_block_tsv:
            self.longest_block = stack.enter_context(open(longest_block_tsv, "w"))
            print(
                "#dataset_name0", "dataset_name1", "#sample", "chromosome",
                "position", "phase_agreeing", sep="\t", file=self.longest_block,
            )
        if switch_error_bed:
            self.bed = stack.enter_context(open(switch_error_bed, "w"))


def _print_variant_counts(variant_tables, dataset_names, sample_names, width):
    """Per-dataset het/all counts plus union and intersection; returns the
    first dataset's het count (goes into the pairwise TSV)."""
    all_union: Set[VcfVariant] = set()
    all_isect: Optional[Set[VcfVariant]] = None
    het_union: Set[VcfVariant] = set()
    het_isect: Optional[Set[VcfVariant]] = None
    het_count0 = None
    print("VARIANT COUNTS (heterozygous / all): ")
    for table, name, sample in zip(variant_tables, dataset_names, sample_names):
        hets = [
            v
            for v, gt in zip(table.variants, table.genotypes_of(sample))
            if not gt.is_homozygous()
        ]
        if het_count0 is None:
            het_count0 = len(hets)
        all_union.update(table.variants)
        het_union.update(hets)
        if all_isect is None:
            all_isect, het_isect = set(table.variants), set(hets)
        else:
            all_isect &= set(table.variants)
            het_isect &= set(hets)
        print(
            f"{name}:".rjust(width),
            str(len(hets)).rjust(COUNT_WIDTH),
            "/",
            str(len(table.variants)).rjust(COUNT_WIDTH),
        )
    print(
        "UNION:".rjust(width),
        str(len(het_union)).rjust(COUNT_WIDTH),
        "/",
        str(len(all_union)).rjust(COUNT_WIDTH),
    )
    print(
        "INTERSECTION:".rjust(width),
        str(len(het_isect)).rjust(COUNT_WIDTH),
        "/",
        str(len(all_isect)).rjust(COUNT_WIDTH),
    )
    return het_count0


def run_compare(
    vcf,
    ploidy,
    names=None,
    sample=None,
    ignore_sample_name=False,
    tsv_pairwise=None,
    tsv_multiway=None,
    only_snvs=False,
    switch_error_bed=None,
    plot_blocksizes=None,
    plot_sum_of_blocksizes=None,
    longest_block_tsv=None,
):
    vcf_readers = [
        VcfReader(f, only_snvs=only_snvs, phases=True, ploidy=ploidy, mav=(ploidy > 2))
        for f in vcf
    ]
    if names:
        dataset_names = names.split(",")
        if len(dataset_names) != len(vcf):
            raise CommandLineError(
                "Number of names given with --names does not equal number of VCFs."
            )
    else:
        dataset_names = [f"file{i}" for i in range(len(vcf))]

    sample_names = get_sample_names(
        vcf_readers, requested_sample=sample, ignore_name=ignore_sample_name
    )

    with ExitStack() as stack:
        reports = _ReportFiles(
            stack, tsv_pairwise, tsv_multiway, longest_block_tsv, switch_error_bed
        )

        if len(set(sample_names)) > 1 and ignore_sample_name:
            print(
                "Comparing phasings for samples:",
                ", ".join(sample_names),
                " (--ignore-sample-names selected)",
            )
        else:
            print("Comparing phasings for sample", sample_names[0])

        vcfs = get_variant_tables(vcf_readers, vcf)
        chromosomes = get_common_chromosomes(vcfs)
        if len(chromosomes) == 0:
            raise CommandLineError("No chromosome is contained in all VCFs. Aborting.")
        logger.info("Chromosomes present in all VCFs: %s", ", ".join(chromosomes))

        print("FILENAMES")
        longest_name = max(len(n) for n in dataset_names)
        for name, filename in zip(dataset_names, vcf):
            print(name.rjust(longest_name + 2), "=", filename)
        width = max(longest_name, 15) + 5

        all_block_stats: List[List[BlockStats]] = [[] for _ in vcfs]

        def absorb_block_stats(block_stats):
            assert len(block_stats) == len(all_block_stats)
            for accumulated, fresh in zip(all_block_stats, block_stats):
                accumulated.extend(fresh)

        for chromosome in sorted(chromosomes):
            print(f"---------------- Chromosome {chromosome} ----------------")
            variant_tables = [tables[chromosome] for tables in vcfs]
            het_variants0 = _print_variant_counts(
                variant_tables, dataset_names, sample_names, width
            )
            chromosome_bed_records = []

            for i in range(len(vcfs)):
                for j in range(i + 1, len(vcfs)):
                    print(
                        "PAIRWISE COMPARISON: {} <--> {}:".format(
                            dataset_names[i], dataset_names[j]
                        )
                    )
                    (results, bed_records, block_stats, longest_positions,
                     longest_agreement, _) = compare(
                        [variant_tables[i], variant_tables[j]],
                        [sample_names[i], sample_names[j]],
                        [dataset_names[i], dataset_names[j]],
                        ploidy,
                    )
                    if len(vcfs) == 2:
                        absorb_block_stats(block_stats)
                    chromosome_bed_records.extend(bed_records)
                    sample_name = (
                        f"{sample_names[i]}_{sample_names[j]}"
                        if ignore_sample_name
                        else sample_names[i]
                    )
                    if reports.pairwise:
                        row = [
                            sample_name, chromosome,
                            dataset_names[i], dataset_names[j], vcf[i], vcf[j],
                        ]
                        row += list(dataclasses.astuple(results))
                        row += [het_variants0, int(only_snvs)]
                        print(*row, sep="\t", file=reports.pairwise)
                    if reports.longest_block:
                        assert ploidy == 2
                        assert len(longest_positions) == len(longest_agreement)
                        for position, agreeing in zip(longest_positions, longest_agreement):
                            print(
                                dataset_names[i], dataset_names[j], sample_name,
                                chromosome, position, agreeing,
                                sep="\t", file=reports.longest_block,
                            )

            if reports.bed:
                assert ploidy == 2
                for record in sorted(chromosome_bed_records):
                    print(*record, sep="\t", file=reports.bed)

            if len(vcfs) > 2:
                assert ploidy == 2
                print("MULTIWAY COMPARISON OF ALL PHASINGS:")
                *_, block_stats, _, _, multiway = compare(
                    variant_tables, sample_names, dataset_names, ploidy
                )
                absorb_block_stats(block_stats)
                if reports.multiway:
                    sample_name = (
                        "_".join(set(sample_names)) if ignore_sample_name else sample_names[0]
                    )
                    for (left, right), count in multiway.items():
                        print(
                            sample_name, chromosome, "{" + left + "}", "{" + right + "}",
                            count, sep="\t", file=reports.multiway,
                        )

        if plot_blocksizes:
            create_blocksize_histogram(plot_blocksizes, all_block_stats, dataset_names)
        if plot_sum_of_blocksizes:
            create_blocksize_histogram(
                plot_sum_of_blocksizes, all_block_stats, dataset_names, use_weights=True
            )


def main(args):
    run_compare(**vars(args))
