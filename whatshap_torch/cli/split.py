"""
Split reads by haplotype

This subcommand reads either a FASTQ or a BAM file and a list of haplotype assignments
(such as generated by whatshap haplotag --output-haplotag-list); it then outputs one
FASTQ or BAM per haplotype.

1. BAM mode is intended for unmapped BAMs (such as provided by PacBio).
2. The output format is the same as the input format (FASTQ or BAM).
  (Reading BAM but writing FASTQ or vice versa is not possible.)

Examples:

    whatshap split --output-h1 h1.fastq.gz --output-h2 h2.fastq.gz reads.fastq.gz haplotypes.txt
    whatshap split --output-h1 h1.bam --output-h2 h2.bam reads.bam haplotypes.txt

Tetraploid:

    whatshap split -o h1.bam -o h2.bam -o h3.bam -o h4.bam reads.bam haplotypes.txt
"""

import itertools
import logging
import os
from collections import Counter, defaultdict
from contextlib import ExitStack

from ..io import sam as samlib
from ..timer import StageTimer
from ..utils import detect_file_format, xopen
from . import populate_arg_parser

logger = logging.getLogger(__name__)


SPLIT_ARGUMENTS = [
    (None, [
        ("--output-h1", dict(metavar="FILE",
            help="Output haplotype 1 reads to FILE (.gz supported)")),
        ("--output-h2", dict(metavar="FILE",
            help="Output haplotype 2 reads to FILE (.gz supported)")),
        (("--output", "-o"), dict(dest="outputs", metavar="FILE", action="append",
            help="Output haplotype reads to FILE. Use this option as many times as there are haplotypes in the input. The first -o is used for H1, second for H2 etc.")),
        ("--output-untagged", dict(
            help="Output file to write untagged reads to (.gz supported)")),
        ("--add-untagged", dict(default=False, action="store_true",
            help="Add reads without tag to all (H1, H2, ...) outputs.")),
        ("--only-largest-block", dict(default=False, action="store_true",
            help="Only consider reads to be tagged if they belong to the largest phased block (in terms of read count) on their respective chromosome")),
        ("--discard-unknown-reads", dict(default=False, action="store_true",
            help="Only check the haplotype of reads listed in the haplotag list file. Reads (read names) not contained in this file will be discarded.")),
        ("--read-lengths-histogram", dict(
            help="Output file to write read lengths histogram to in tab-separated format.")),
        ("reads_file", dict(metavar="READS",
            help="Input FASTQ/BAM file with reads (FASTQ can be gzipped)")),
        ("list_file", dict(metavar="LIST",
            help='Tab-separated list with (at least) two columns <readname> and <haplotype> (can be gzipped). Haplotypes are named H1, H2, ... (or none). The output of the "haplotag" command can be used (4 columns), required for --only-largest-block.')),
    ]),
]


def add_arguments(parser):
    populate_arg_parser(parser, SPLIT_ARGUMENTS)


def validate(args, parser):
    no_hap_outputs = args.output_h1 is None and args.output_h2 is None and not args.outputs
    if no_hap_outputs and args.output_untagged is not None:
        parser.error(
            "Nothing to be done since neither --output-h1/h2, --outputs/-o nor "
            "--output-untagged are given."
        )
    if (args.output_h1 is not None or args.output_h2 is not None) and args.outputs is not None:
        parser.error("--output-h1/-h2 cannot be used together with --outputs/-o")


# ---------------------------------------------------------------------------
# haplotag list parsing


def _two_column_parser(line):
    name, haplotype = line.strip().split("\t")[:2]
    return name, haplotype, None, None


def _four_column_parser(line):
    return line.strip().split("\t")[:4]


def check_haplotag_list_information(haplotag_list, exit_stack):
    """Sniff whether the list file carries phaseset/chromosome columns;
    return (handle, has chromosome info, row parser)."""
    handle = exit_stack.enter_context(xopen(haplotag_list, threads=0))
    first_line = handle.readline().strip()
    handle.seek(0)
    columns = first_line.split("\t")
    if len(columns) >= 4:
        return handle, True, _four_column_parser
    if len(columns) >= 2:
        return handle, False, _two_column_parser
    raise ValueError(
        "First line of haplotag list file does not have "
        "at least 2 columns, or it is not tab-separated: {}".format(first_line)
    )


def select_reads_in_largest_phased_blocks(block_sizes, block_to_readnames):
    chosen = set()
    logger.info("Determining largest blocks/phasesets per chromosome")
    for chromosome, counts in block_sizes.items():
        block_name, n_reads = counts.most_common(1)[0]
        logger.info(
            "Chromosome: %s - Phaseset: %s - Tagged reads: %s", chromosome, block_name, n_reads
        )
        chosen |= set(block_to_readnames[(chromosome, block_name)])
    return chosen


def process_haplotag_list_file(
    haplolist, line_parser, only_largest_blocks, discard_unknown_reads, ploidy: int
):
    """Build readname -> haplotype number (0 = untagged) from the list
    file, optionally restricted to each chromosome's biggest block."""
    if not haplolist.readline().startswith("#"):
        haplolist.seek(0)

    number_of = {f"H{i}": i for i in range(1, ploidy + 1)}
    number_of["none"] = 0

    block_sizes = defaultdict(Counter)
    block_members = defaultdict(set)
    known_reads = set()
    haplotype_of = defaultdict(int)

    total = 0
    for line in haplolist:
        readname, haplo_name, phaseset, chromosome = line_parser(line)
        total += 1
        if haplo_name not in number_of:
            logger.error(
                f"Haplotype name '{haplo_name}' in haplotype list file not recognized; "
                f"must be one of 'none', 'H1', ..., 'H{ploidy}'"
            )
            raise KeyError(haplo_name)
        haplo_num = number_of[haplo_name]
        if haplo_num == 0:
            # untagged; the defaultdict already answers 0 for these
            if discard_unknown_reads:
                known_reads.add(readname)
            continue
        haplotype_of[readname] = haplo_num
        if only_largest_blocks:
            block_sizes[chromosome][phaseset] += 1
            block_members[(chromosome, phaseset)].add(readname)

    tagged = len(haplotype_of)
    logger.info("Total number of reads in haplotag list: %d", total)
    logger.info("Total number of haplo-tagged reads: %d", tagged)
    logger.info("Total number of untagged reads: %d", total - tagged)

    if discard_unknown_reads:
        known_reads.update(haplotype_of)
        assert total == len(known_reads)

    if only_largest_blocks:
        keep = select_reads_in_largest_phased_blocks(block_sizes, block_members)
        haplotype_of = defaultdict(int, {name: haplotype_of[name] for name in keep})
        logger.info(
            "Number of reads removed / reads not overlapping largest phased blocks: %d",
            total - len(haplotype_of),
        )
    return haplotype_of, known_reads


# ---------------------------------------------------------------------------
# input/output plumbing


def _bam_iterator(bam_file):
    for record in bam_file:
        length = record.query_length
        if length <= 0:
            length = record.infer_query_length() or 0
        yield record.query_name, length, record


def _fastq_string_iterator(fastq_file):
    for record in fastq_file:
        yield record.name, len(record.sequence), str(record) + "\n"


_FASTQ_SUFFIXES = ("fastq", "fastq.gz", "fastq.gzip", "fq", "fq.gz", "fq.gzip")


def initialize_io_files(reads_file, outputs, exit_stack):
    kind = detect_file_format(reads_file)
    if kind is None:
        if not reads_file.endswith(_FASTQ_SUFFIXES):
            raise ValueError(
                "Undetected file format for input reads. "
                f"Expecting BAM or FASTQ (gzipped): {reads_file}"
            )
        kind = "FASTQ"
    elif kind in ("VCF", "CRAM"):
        raise ValueError(
            f"Input file format detected as: {kind}. "
            "Currently, only BAM and FASTQ is supported."
        )

    if kind == "BAM":
        reader = exit_stack.enter_context(
            samlib.AlignmentFile(reads_file, mode="rb", check_sq=False)
        )
        writers = [
            exit_stack.enter_context(
                samlib.AlignmentFile(
                    os.devnull if path is None else path, mode="wb", template=reader
                )
            )
            for path in outputs
        ]
        return reader, _bam_iterator, writers

    reader = exit_stack.enter_context(samlib.FastxFile(reads_file))
    writers = [
        exit_stack.enter_context(
            open(os.devnull, "w")
            if path is None
            else xopen(path, "w", compresslevel=1, threads=0)
        )
        for path in outputs
    ]
    return reader, _fastq_string_iterator, writers


def write_read_length_histogram(length_counts, path):
    # index 0 holds the untagged reads
    lengths = sorted(itertools.chain(*(counter.keys() for counter in length_counts)))
    with xopen(path, "w") as tsv_file:
        hap_columns = (f"count-h{i}" for i in range(1, len(length_counts)))
        print("#length", "count-untagged", *hap_columns, sep="\t", file=tsv_file)
        for length in lengths:
            print(length, *(c[length] for c in length_counts), sep="\t", file=tsv_file)


# ---------------------------------------------------------------------------
# entry point


def run_split(
    reads_file,
    list_file,
    output_h1=None,
    output_h2=None,
    outputs=None,
    output_untagged=None,
    add_untagged=False,
    only_largest_block=False,
    discard_unknown_reads=False,
    read_lengths_histogram=None,
):
    if output_h1 or output_h2:
        if outputs:
            raise ValueError("Cannot use output_h1/output_h2 and outputs at the same time")
        outputs = [output_untagged, output_h1, output_h2]
        ploidy = 2
    else:
        ploidy = len(outputs)
        outputs = [output_untagged] + outputs

    timers = StageTimer()
    timers.start("split-run")

    with ExitStack() as stack:
        haplo_list, has_chrom_info, line_parser = check_haplotag_list_information(
            list_file, stack
        )
        if only_largest_block and not has_chrom_info:
            raise ValueError(
                "The haplotag list file does not contain phaseset and chromosome "
                "information, which is required to select only reads from the "
                "largest phased block. Columns 3 and 4 are missing."
            )

        haplotype_of, known_reads = process_haplotag_list_file(
            haplo_list, line_parser, only_largest_block, discard_unknown_reads, ploidy
        )
        remaining = -1
        if discard_unknown_reads:
            assert (
                len(known_reads) > 0
            ), "No known reads in input set - would discard everything, this is probably wrong"
            remaining = len(known_reads)

        reader, record_iterator, writers = initialize_io_files(reads_file, outputs, stack)

        histograms = [Counter() for _ in outputs]
        tallies = Counter()
        wanted = [path is not None for path in outputs]
        wanted[0] = wanted[0] or add_untagged

        for read_name, read_length, record in record_iterator(reader):
            tallies["total_reads"] += 1
            if discard_unknown_reads and read_name not in known_reads:
                tallies["unknown_reads"] += 1
                continue
            haplotype = haplotype_of[read_name]
            if not wanted[haplotype]:
                tallies["skipped_reads"] += 1
                continue
            histograms[haplotype][read_length] += 1
            tallies[haplotype] += 1

            writers[haplotype].write(record)
            if haplotype == 0 and add_untagged:
                for writer in writers[1:]:
                    writer.write(record)

            if discard_unknown_reads:
                remaining -= 1
                if remaining == 0:
                    logger.info("All known reads processed - cancel processing...")
                    break

        if read_lengths_histogram is not None:
            write_read_length_histogram(histograms, read_lengths_histogram)

    timers.stop("split-run")

    logger.info("\n== SUMMARY ==")
    logger.info("Total reads processed: %d", tallies["total_reads"])
    logger.info('Number of output reads "untagged": %d', tallies[0])
    for h in range(1, ploidy + 1):
        logger.info("Number of output reads haplotype %d: %d", h, tallies[h])
    logger.info("Number of unknown (dropped) reads: %d", tallies["unknown_reads"])
    logger.info("Number of skipped reads (per user request): %d", tallies["skipped_reads"])
    logger.info("Total run time: %.3f sec", timers.elapsed("split-run"))


def main(args):
    run_split(**vars(args))
