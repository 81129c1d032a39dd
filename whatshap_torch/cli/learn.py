"""
Generate sequencing technology specific error profiles
"""

import logging

from ..io import sam as samlib
from ..io.vcflib import VariantFile
from ..solver.caller import Caller
from ..utils import IndexedFasta

logger = logging.getLogger(__name__)


def add_arguments(parser):
    arg = parser.add_argument
    arg("bam", metavar="BAM", help="Read alignments")
    arg("vcf", metavar="VCF", help="List of variants")
    arg("--reference", "-r", metavar="FASTA", help="Reference genome", required=True)
    arg("-k", "--kmer", dest="k", metavar="K", help="k-mer size", type=int, default=7)
    arg(
        "--window",
        "-w",
        metavar="WINDOW",
        help="Ignore this many bases on the left and right of each variant position",
        type=int,
        default=25,
    )
    arg("--output", "-o", metavar="OUT", help="Output file with kmer-pair counts", required=True)


def run_learn(reference, bam, vcf, k: int, window: int, output):
    with VariantFile(vcf) as vcf_file:
        variants = [(variant.pos, len(variant.ref)) for variant in vcf_file]

    fasta = IndexedFasta(reference)
    with samlib.AlignmentFile(bam) as bamfile:
        call = 0
        encoded_references = {}
        chromosome = None
        caller = None
        open(output, "w").close()
        for alignment in bamfile:
            if alignment.is_unmapped or alignment.query_sequence is None:
                continue
            if alignment.reference_name != chromosome:
                chromosome = alignment.reference_name
                if chromosome not in encoded_references:
                    encoded_references[chromosome] = str(fasta[chromosome][:]).encode("UTF-8")
                caller = Caller(encoded_references[chromosome], k, window)
            if call == 0:
                caller.all_variants(variants)
                call = 1
            caller.add_read(
                alignment.pos,
                alignment.cigartuples,
                _query_alignment_sequence(alignment).encode("UTF-8"),
                str(output),
            )
        if caller is not None:
            caller.final_pop(str(output))


def _query_alignment_sequence(alignment) -> str:
    """Aligned portion of the read (soft clips removed), like pysam's
    query_alignment_sequence."""
    seq = alignment.query_sequence
    if not alignment.cigartuples:
        return seq
    start = 0
    end = len(seq)
    first_op, first_len = alignment.cigartuples[0]
    if first_op == 4:
        start = first_len
    last_op, last_len = alignment.cigartuples[-1]
    if last_op == 4:
        end -= last_len
    return seq[start:end]


def main(args):
    run_learn(**vars(args))
