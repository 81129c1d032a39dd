"""
Print phasing statistics of a single VCF file
"""

import dataclasses
import logging
from collections import defaultdict
from contextlib import ExitStack
from math import isnan
from statistics import median
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..vcf import VariantTable, VcfReader, VcfVariant
from . import populate_arg_parser

logger = logging.getLogger(__name__)


STATS_ARGUMENTS = [
    (None, [
        ("--gtf", dict(metavar="FILE",
            help="Write phased blocks as GTF with each block represented as a 'gene'. If blocks are interleaved or nested, they are split into multiple 'exons'.")),
        ("--block-list", dict(metavar="FILE",
            help="Write list of all blocks to FILE (one block per line). Nested/interleaved blocks are not split.")),
        ("--sample", dict(metavar="SAMPLE",
            help="Name of the sample to process. If not given, use first sample found in VCF.")),
        ("--chr-lengths", dict(metavar="FILE",
            help="Override chromosome lengths in VCF with those from FILE (one line per chromosome, tab separated '<chr> <length>'). Lengths are used to compute NG50 values.")),
        ("--tsv", dict(metavar="FILE",
            help="Write statistics in tab-separated value format to FILE")),
        ("--only-snvs", dict(default=False, action="store_true",
            help="Only process SNVs and ignore all other variants.")),
        ("--chromosome", dict(dest="chromosomes", metavar="CHROMOSOME", default=[], action="append",
            help="Name of chromosome(s) to process. If not given, all chromosomes in the input VCF are considered. Can be used multiple times and accepts a comma-separated list. ")),
        ("vcf", dict(metavar="VCF", help="Phased VCF file")),
    ]),
]


def add_arguments(parser):
    populate_arg_parser(parser, STATS_ARGUMENTS)


def validate(args, parser):
    pass


# ---------------------------------------------------------------------------
# phase blocks


class PhasedBlock:
    def __init__(self, chromosome=None):
        self.phases: Dict[VcfVariant, object] = {}
        self.leftmost_variant: Optional[VcfVariant] = None
        self.rightmost_variant: Optional[VcfVariant] = None
        self.chromosome = chromosome

    def add(self, variant: VcfVariant, phase) -> None:
        if not self.phases:
            self.leftmost_variant = self.rightmost_variant = variant
        elif variant < self.leftmost_variant:
            self.leftmost_variant = variant
        elif self.rightmost_variant < variant:
            self.rightmost_variant = variant
        self.phases[variant] = phase

    def span(self) -> int:
        """Covered genomic region in bp."""
        return self.rightmost_variant.position - self.leftmost_variant.position

    def variants(self) -> List[VcfVariant]:
        return sorted(self.phases)

    def count_snvs(self) -> int:
        return sum(1 for variant in self.phases if variant.is_snv())

    def split(self, split_left: int, split_right: int) -> Tuple["PhasedBlock", "PhasedBlock"]:
        """Partition into (variants strictly left of split_left, variants
        strictly right of split_right); variants inside the window drop."""
        assert split_left <= split_right
        left = PhasedBlock(chromosome=self.chromosome)
        right = PhasedBlock(chromosome=self.chromosome)
        for variant, phase in self.phases.items():
            if variant.position < split_left:
                left.add(variant, phase)
            elif variant.position > split_right:
                right.add(variant, phase)
        return left, right

    def __repr__(self):
        return f"PhasedBlock({str(self.phases)})"

    def __len__(self):
        return len(self.phases)

    def __lt__(self, other):
        return (self.leftmost_variant, self.rightmost_variant) < (
            other.leftmost_variant,
            other.rightmost_variant,
        )


class GtfWriter:
    def __init__(self, file):
        self._file = file

    def write(self, chromosome, start, stop, name) -> None:
        """One GTF exon row; start is 0-based."""
        assert start < stop
        columns = (
            chromosome,
            "Phasing",
            "exon",
            start + 1,
            stop,
            ".",
            "+",
            ".",
            f'gene_id "{name}"; transcript_id "{name}.1";',
        )
        print(*columns, sep="\t", file=self._file)


@dataclasses.dataclass
class GtfBlock:
    start: Optional[int] = 0
    end: Optional[int] = 0
    id: Optional[int] = None

    def add(self, variant: VcfVariant):
        self.end = variant.position + 1


# ---------------------------------------------------------------------------
# statistics


@dataclasses.dataclass
class DetailedStats:
    variants: int = 0
    phased: int = 0
    unphased: int = 0
    singletons: int = 0
    blocks: int = 0
    variant_per_block_median: float = float("nan")
    variant_per_block_avg: float = float("nan")
    variant_per_block_min: int = 0
    variant_per_block_max: int = 0
    variant_per_block_sum: int = 0
    bp_per_block_median: float = float("nan")
    bp_per_block_avg: float = float("nan")
    bp_per_block_min: int = 0
    bp_per_block_max: int = 0
    bp_per_block_sum: int = 0
    heterozygous_variants: int = 0
    heterozygous_snvs: int = 0
    phased_snvs: int = 0
    phased_fraction: float = 0.0
    phased_snvs_fraction: float = 0.0
    block_n50: float = float("nan")

    # report layout: (label, kind, value attribute(s), trailing unit)
    # kind "int2"/"pct2" render a second parenthesized SNV value
    _LAYOUT = (
        ("Variants in VCF", "int", "variants", ""),
        ("Heterozygous", "int2", ("heterozygous_variants", "heterozygous_snvs"), "SNVs)"),
        ("Phased", "int2", ("phased", "phased_snvs"), "SNVs)"),
        ("Heterozygous phased", "pct2", ("phased_fraction", "phased_snvs_fraction"), "SNVs)"),
        ("Unphased", "int", "unphased", "(not considered below)"),
        ("Singletons", "int", "singletons", "(not considered below)"),
        ("Blocks", "int", "blocks", ""),
        (None, None, None, "Block sizes (no. of variants)"),
        ("Sum of sizes", "int", "variant_per_block_sum", "variants"),
        ("Median block size", "float", "variant_per_block_median", "variants"),
        ("Average block size", "float", "variant_per_block_avg", "variants"),
        ("Largest block", "int", "variant_per_block_max", "variants"),
        ("Smallest block", "int", "variant_per_block_min", "variants"),
        (None, None, None, "Block lengths (basepairs)"),
        ("Sum of lengths", "int", "bp_per_block_sum", "bp"),
        ("Median block length", "float", "bp_per_block_median", "bp"),
        ("Average block length", "float", "bp_per_block_avg", "bp"),
        ("Longest block", "int", "bp_per_block_max", "bp"),
        ("Shortest block", "int", "bp_per_block_min", "bp"),
        ("Block NG50", "int", "block_n50", "bp"),
    )

    def print(self):
        widest = max(len(str(int(v))) for v in vars(self).values() if not isnan(v))
        w = max(widest, 8)
        fmt = {"int": f"{w}.0f", "float": f"{w + 3}.2f", "pct": f"{w + 3}.1%"}

        lines = []
        for label, kind, attr, unit in self._LAYOUT:
            if label is None:
                lines.append("")
                lines.append(unit)
                continue
            head = f"{label:>21}: "
            if kind == "int":
                body = f"{getattr(self, attr):{fmt['int']}}"
                tail = f"    {unit}" if unit else ""
            elif kind == "float":
                body = f"{getattr(self, attr):{fmt['float']}}"
                tail = f" {unit}"
            elif kind == "int2":
                a, b = (getattr(self, x) for x in attr)
                body = f"{a:{fmt['int']}}    ({b:{fmt['int']}}    "
                tail = unit
            else:  # pct2
                a, b = (getattr(self, x) for x in attr)
                body = f"{a:{fmt['pct']}} ({b:{fmt['pct']}} "
                tail = unit
            lines.append(head + body + tail)
        print("\n".join(lines))
        assert self.phased + self.unphased + self.singletons == self.heterozygous_variants


def n50(lengths: List[int], target_length: Optional[int] = None) -> int:
    """Largest length such that pieces at least this long cover half the
    target."""
    if target_length is None:
        target_length = sum(lengths)
    running = 0
    for length in sorted(lengths, reverse=True):
        running += length
        if 2 * running >= target_length:
            return length
    return 0


def compute_ng50(blocks: List[PhasedBlock], chr_lengths: Dict[str, int]):
    target = 0
    for chromosome in sorted({b.chromosome for b in blocks}):
        if chromosome not in chr_lengths:
            logger.warning(
                "Not able to compute NG50 because length of contig '%s' not available", chromosome
            )
            return float("nan")
        target += chr_lengths[chromosome]
    return n50([b.span() for b in blocks], target_length=target)


class PhasingStats:
    def __init__(self):
        self.blocks: List[PhasedBlock] = []
        self.split_blocks: List[PhasedBlock] = []
        self.unphased = 0
        self.variants = 0
        self.heterozygous_variants = 0
        self.heterozygous_snvs = 0
        self.phased_snvs = 0

    def __iadd__(self, other):
        self.blocks.extend(other.blocks)
        self.split_blocks.extend(other.split_blocks)
        self.unphased += other.unphased
        self.variants += other.variants
        self.heterozygous_variants += other.heterozygous_variants
        self.heterozygous_snvs += other.heterozygous_snvs
        self.phased_snvs += other.phased_snvs
        return self

    def add_blocks(self, blocks: Sequence[PhasedBlock]) -> None:
        self.blocks.extend(blocks)
        self.split_blocks.extend(self.get_nonoverlapping_blocks())

    def add_unphased(self, unphased: int = 1) -> None:
        self.unphased += unphased

    def add_variants(self, variants: int) -> None:
        self.variants += variants

    def add_heterozygous_variants(self, variants: int) -> None:
        self.heterozygous_variants += variants

    def add_heterozygous_snvs(self, snvs: int) -> None:
        self.heterozygous_snvs += snvs

    def get_nonoverlapping_blocks(self) -> List[PhasedBlock]:
        """Resolve interleaved/nested blocks: whenever a block overlaps the
        next one (by start order), cut it around the next block's span and
        re-queue the right part."""

        def queue_order(block):
            return (block.chromosome, block.leftmost_variant.position)

        # stack with the leftmost block on top
        pending = sorted(
            (b for b in self.blocks if len(b) > 1), key=queue_order, reverse=True
        )
        resolved = []
        while pending:
            block = pending.pop()
            if pending:
                nxt = pending[-1]
                overlaps = (
                    block.rightmost_variant.position > nxt.leftmost_variant.position
                    and block.chromosome == nxt.chromosome
                )
                if overlaps:
                    block, tail = block.split(
                        nxt.leftmost_variant.position, nxt.rightmost_variant.position
                    )
                    if len(tail) > 1:
                        pending.append(tail)
                        pending.sort(key=queue_order, reverse=True)
                    if len(block) < 2:
                        continue
            resolved.append(block)
        return resolved

    def get_detailed_stats(self, chr_lengths: Optional[Dict[str, int]] = None) -> DetailedStats:
        sizes = sorted(len(b) for b in self.blocks if len(b) > 1)
        singletons = sum(1 for b in self.blocks if len(b) == 1)
        # split interleaved blocks first so bp spans are not double-counted
        lengths = sorted(b.span() for b in self.split_blocks if len(b) > 1)
        phased_snvs = sum(b.count_snvs() for b in self.blocks if len(b) > 1)
        if not sizes:
            return DetailedStats(
                variants=self.variants,
                unphased=self.unphased,
                singletons=singletons,
                heterozygous_variants=self.heterozygous_variants,
                heterozygous_snvs=self.heterozygous_snvs,
            )

        def mean(xs):
            return sum(xs) / len(xs) if xs else float("nan")

        def ratio(num, denom):
            return num / denom if denom else float("nan")

        return DetailedStats(
            variants=self.variants,
            phased=sum(sizes),
            unphased=self.unphased,
            singletons=singletons,
            blocks=len(sizes),
            variant_per_block_median=median(sizes),
            variant_per_block_avg=mean(sizes),
            variant_per_block_min=sizes[0],
            variant_per_block_max=sizes[-1],
            variant_per_block_sum=sum(sizes),
            bp_per_block_median=median(lengths),
            bp_per_block_avg=mean(lengths),
            bp_per_block_min=lengths[0],
            bp_per_block_max=lengths[-1],
            bp_per_block_sum=sum(lengths),
            heterozygous_variants=self.heterozygous_variants,
            heterozygous_snvs=self.heterozygous_snvs,
            phased_snvs=phased_snvs,
            phased_fraction=ratio(sum(sizes), self.heterozygous_variants),
            phased_snvs_fraction=ratio(phased_snvs, self.heterozygous_snvs),
            block_n50=(
                compute_ng50(self.split_blocks, chr_lengths)
                if chr_lengths is not None
                else float("nan")
            ),
        )


# ---------------------------------------------------------------------------
# input helpers


def unpack_chromosomes(chromosomes: List[str]) -> List[str]:
    """Expand comma-separated entries and drop empties."""
    return [c for entry in chromosomes for c in entry.split(",") if c]


def parse_chr_lengths(filename) -> Dict[str, int]:
    lengths = {}
    with open(filename) as handle:
        for line in handle:
            fields = line.split("\t")
            assert len(fields) == 2
            lengths[fields[0]] = int(fields[1])
    return lengths


def parse_variant_tables(
    vcf_reader: VcfReader, chromosomes: Optional[Sequence[str]] = None
) -> Iterator[VariantTable]:
    """Random-access requested chromosomes when an index exists; otherwise
    stream the whole file."""
    if chromosomes and vcf_reader.index_exists():
        for chromosome in chromosomes:
            yield vcf_reader.fetch(chromosome)
    else:
        yield from vcf_reader


def get_chr_lengths(vcf_reader: VcfReader, chr_lengths_file: Optional[str] = None):
    if chr_lengths_file:
        lengths = parse_chr_lengths(chr_lengths_file)
        logger.info("Read length of %d chromosomes from %s", len(lengths), chr_lengths_file)
        return lengths
    lengths = {
        contig.name: contig.length
        for contig in vcf_reader.contigs.values()
        if contig.length is not None
    }
    if not lengths:
        logger.warning(
            "VCF header does not contain contig lengths, cannot compute NG50. "
            "Consider using --chr-lengths"
        )
    return lengths


# ---------------------------------------------------------------------------
# per-chromosome collection


def get_phase_blocks(
    chromosome: str,
    gtfwriter,
    sample: str,
    stats: PhasingStats,
    variant_table: VariantTable,
) -> Dict[int, PhasedBlock]:
    """Bucket one sample's phased variants by block id, updating counters
    and streaming GTF exons at block changes."""
    genotypes = variant_table.genotypes_of(sample)
    phases = variant_table.phases_of(sample)
    assert len(genotypes) == len(phases) == len(variant_table.variants)

    blocks: Dict[int, PhasedBlock] = defaultdict(PhasedBlock)
    open_exon = GtfBlock()
    for variant, genotype, phase in zip(variant_table.variants, genotypes, phases):
        stats.add_variants(1)
        if genotype.is_homozygous():
            continue
        stats.add_heterozygous_variants(1)
        if variant.is_snv():
            stats.add_heterozygous_snvs(1)
        if phase is None:
            stats.add_unphased()
            continue

        blocks[phase.block_id].add(variant, phase)
        if gtfwriter:
            if open_exon.id is None:
                open_exon = GtfBlock(variant.position, variant.position + 1, phase.block_id)
            else:
                if open_exon.id != phase.block_id:
                    gtfwriter.write(chromosome, open_exon.start, open_exon.end, open_exon.id)
                    open_exon = GtfBlock(variant.position, variant.position + 1, phase.block_id)
                open_exon.add(variant)

    for block in blocks.values():
        block.chromosome = chromosome
    if gtfwriter and open_exon.id is not None:
        gtfwriter.write(chromosome, open_exon.start, open_exon.end, open_exon.id)
    return blocks


def write_to_block_list(
    block_list_file, blocks: Dict[int, PhasedBlock], chromosome: str, sample: str
):
    for block_id in sorted(blocks):
        block = blocks[block_id]
        row = (
            sample,
            chromosome,
            block_id,
            block.leftmost_variant.position + 1,
            block.rightmost_variant.position + 1,
            len(block),
        )
        print(*row, sep="\t", file=block_list_file)


# ---------------------------------------------------------------------------
# entry point


def run_stats(
    vcf,
    sample=None,
    gtf=None,
    tsv=None,
    block_list=None,
    only_snvs=False,
    chromosomes=None,
    chr_lengths=None,
):
    if chromosomes is not None:
        chromosomes = unpack_chromosomes(chromosomes)

    with ExitStack() as stack:
        gtfwriter = None
        if gtf:
            gtfwriter = GtfWriter(stack.enter_context(open(gtf, "wt")))

        vcf_reader = VcfReader(vcf, phases=True, only_snvs=only_snvs)
        if len(vcf_reader.samples) == 0:
            logger.error("Input VCF does not contain any sample")
            return 1
        logger.info(f"Found {len(vcf_reader.samples)} sample(s) in input VCF")
        if sample:
            if sample not in vcf_reader.samples:
                logger.error(f"Requested sample ({sample}) not found")
                return 1
        else:
            sample = vcf_reader.samples[0]
            logger.info(f"Reporting results for sample {sample}")

        chr_lengths = get_chr_lengths(vcf_reader, chr_lengths)

        tsv_file = None
        if tsv:
            tsv_file = stack.enter_context(open(tsv, "w"))
            field_names = [f.name for f in dataclasses.fields(DetailedStats)]
            print("#sample", "chromosome", "file_name", *field_names, sep="\t", file=tsv_file)

        block_list_file = None
        if block_list:
            block_list_file = stack.enter_context(open(block_list, "w"))
            print(
                "#sample", "chromosome", "phase_set", "from", "to", "variants",
                sep="\t", file=block_list_file,
            )

        def emit_tsv_row(chromosome_label, detailed):
            if tsv_file:
                print(sample, chromosome_label, vcf, sep="\t", end="\t", file=tsv_file)
                print(*dataclasses.astuple(detailed), sep="\t", file=tsv_file)

        print(f"Phasing statistics for sample {sample} from file {vcf}")
        total = PhasingStats()
        seen = set()
        for variant_table in parse_variant_tables(vcf_reader, chromosomes):
            chromosome = variant_table.chromosome
            seen.add(chromosome)
            if chromosomes and chromosome not in chromosomes:
                continue

            stats = PhasingStats()
            print(f"---------------- Chromosome {chromosome} ----------------")
            blocks = get_phase_blocks(chromosome, gtfwriter, sample, stats, variant_table)
            if block_list_file:
                write_to_block_list(block_list_file, blocks, chromosome, sample)
            stats.add_blocks(blocks.values())

            detailed = stats.get_detailed_stats(chr_lengths)
            detailed.print()
            emit_tsv_row(chromosome, detailed)
            total += stats

            if chromosomes and set(chromosomes) <= seen:
                break

        if len(seen) > 1:
            print("---------------- ALL chromosomes (aggregated) ----------------")
            detailed = total.get_detailed_stats(chr_lengths)
            detailed.print()
            emit_tsv_row("ALL", detailed)


def main(args):
    run_stats(**vars(args))
