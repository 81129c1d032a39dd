"""
Generate candidate SNP positions.
"""

import datetime
import logging
import sys
from collections import defaultdict

from ..io import sam as samlib
from ..utils import IndexedFasta

logger = logging.getLogger(__name__)


# fmt: off
def add_arguments(parser):
    add = parser.add_argument
    add('ref', metavar='REF', help='FASTA with reference genome')
    add('bam', metavar='BAM', help='BAM file')
    add('--minabs', metavar='MIN_ABS', default=3, type=int,
        help='Minimum absolute ALT depth to call a SNP (default: %(default)s).')
    add('--minrel', metavar='MIN_REL', default=0.25, type=float,
        help='Minimum relative ALT depth to call a SNP (default: %(default)s).')
    add('--multi-allelics', default=False, action='store_true',
        help='Also output multi-allelic sites, if not given only the best ALT allele is '
        'reported (if unique).')
    add('--sample', metavar='SAMPLE', default='sample',
        help='Put this sample column into VCF (default: output sites-only VCF).')
    add('--chromosome', dest='chromosome', metavar='CHROMOSOME', default=None,
        help='Name of chromosome to process. If not given, all chromosomes are processed.')
    add('-o', '--output', default=sys.stdout, help='Output VCF file.')
    group = parser.add_mutually_exclusive_group()
    group.add_argument(
        '--pacbio', dest='datatype', action='store_const', const='pacbio',
        help='Input is PacBio. Sets minrel=0.25 and minabs=3.')
    group.add_argument(
        '--nanopore', dest='datatype', action='store_const', const='nanopore',
        help='Input is Nanopore. Sets minrel=0.4 and minabs=3.')
    group.add_argument(
        '--illumina', dest='datatype', action='store_const', const='illumina',
        help='Input is Illumina. Sets minrel=0.25 and minabs=3.')
# fmt: on


def validate(args, parser):
    pass


def _pileup_base_counts(bamfile, chromosome, min_mapping_quality=20, min_base_quality=5):
    """Per-(chromosome, position) base counts over usable alignments.

    Equivalent to parsing samtools-style pileup strings (as the reference
    does via pysam.pileup, cli/find_snv_candidates.py:89-126): aligned query
    bases are counted (including mismatches and Ns), insertions and deleted
    positions are skipped, secondary/duplicate/qcfail reads and low-quality
    bases are excluded.
    """
    counts = defaultdict(lambda: defaultdict(int))  # (chrom, pos0) -> base -> count
    for aln in bamfile:
        if aln.is_unmapped or aln.is_secondary or aln.is_duplicate or aln.is_qcfail:
            continue
        if chromosome is not None and aln.reference_name != chromosome:
            continue
        if aln.mapping_quality < min_mapping_quality:
            continue
        if not aln.cigartuples or aln.query_sequence is None:
            continue
        chrom = aln.reference_name
        quals = aln.query_qualities
        ref_pos = aln.reference_start
        q_pos = 0
        for op, length in aln.cigartuples:
            if op in (0, 7, 8):  # M, =, X
                for i in range(length):
                    if quals is None or quals[q_pos + i] >= min_base_quality:
                        base = aln.query_sequence[q_pos + i].upper()
                        counts[(chrom, ref_pos + i)][base] += 1
                ref_pos += length
                q_pos += length
            elif op == 1 or op == 4:  # I, S
                q_pos += length
            elif op in (2, 3):  # D, N
                ref_pos += length
            # H, P consume nothing
    return counts


def run_find_snv_candidates(
    ref,
    bam,
    minabs=3,
    minrel=0.25,
    multi_allelics=False,
    datatype=None,
    sample="sample",
    chromosome=None,
    output=sys.stdout,
):
    outfile = output
    if output != sys.stdout:
        outfile = open(output, "w")
    if datatype == "pacbio":
        minabs = 3
        minrel = 0.25
    if datatype == "nanopore":
        minabs = 3
        minrel = 0.4
    if datatype == "illumina":
        minabs = 3
        minrel = 0.25
    print(minabs, minrel)
    fasta = IndexedFasta(ref)
    print("##fileformat=VCFv4.2", file=outfile)
    print("##fileDate={}".format(datetime.datetime.now().strftime("%Y%m%d")), file=outfile)
    print('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">', file=outfile)
    print('##FILTER=<ID=PASS,Description="All filters passed">', file=outfile)
    header_columns = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
    if sample is not None:
        header_columns += ["FORMAT", sample]
    print(*header_columns, sep="\t", file=outfile)

    bamfile = samlib.AlignmentFile(bam, "rb")
    counts = _pileup_base_counts(bamfile, chromosome)

    for (chrom, pos0) in sorted(counts.keys()):
        bases = counts[(chrom, pos0)]
        position = pos0 + 1
        ref_base = fasta[chrom][pos0].upper()
        if ref_base == "N":
            continue
        ref_count = bases[ref_base]
        alts = []
        for base, count in bases.items():
            if base == ref_base:
                continue
            if (count >= minabs) and (count / (count + ref_count) >= minrel):
                alts.append((count, base))
        alts.sort(reverse=True)
        if len(alts) > 0:
            columns = [chrom, position, ".", ref_base, ".", ".", "PASS", "."]
            if sample is not None:
                columns += ["GT", "."]
            if multi_allelics:
                columns[4] = ",".join(base for count, base in alts)
            else:
                # skip sites with two equally supported ALT alleles
                if len(alts) > 1 and (alts[0][0] == alts[1][0]):
                    columns[4] = "N"
                    continue
                else:
                    columns[4] = alts[0][1]
            print(*columns, sep="\t", file=outfile)
    if output != sys.stdout:
        outfile.close()


def main(args):
    run_find_snv_candidates(**vars(args))
