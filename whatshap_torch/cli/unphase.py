"""
Strip phasing from a VCF

Writes a copy of the input VCF to standard output with every trace of
phasing removed: the HP/PS/PQ FORMAT fields disappear from the header and
from each call, and pipe-phased genotypes are rewritten as unphased
slash-separated genotypes with the alleles in ascending order (e.g. '1|0'
becomes '0/1').  Inputs without any phasing pass through unchanged.
"""

import logging
import sys

from ..io.vcflib import VariantFile

logger = logging.getLogger(__name__)

#: FORMAT fields that carry phasing and must not survive the copy.
PHASING_FIELDS = ("HP", "PQ", "PS")


def add_arguments(parser):
    parser.add_argument(
        "vcf", metavar="VCF", help='VCF file. Use "-" to read from standard input'
    )


def _strip_header(header) -> None:
    """Drop the ##phasing meta line and the phasing FORMAT declarations."""
    header.remove_meta_key("phasing")
    for field in PHASING_FIELDS:
        if field in header.formats:
            header.remove_format(field)


def _strip_record(record) -> None:
    """Remove phasing fields and pipe-phasing from one record in place."""
    record.format = [f for f in record.format if f not in PHASING_FIELDS]
    for call in record.samples.values():
        for field in PHASING_FIELDS:
            if field in call:
                del call[field]
        gt = call["GT"] if "GT" in call._values else None
        if gt is not None and len(gt) >= 2 and None not in gt:
            call["GT"] = tuple(sorted(gt))
        call.phased = False


def run_unphase(vcf_path, outfile):
    """Copy ``vcf_path`` to the file-like ``outfile`` without phasing.

    Reference behavior: whatshap/cli/unphase.py (header surgery + per-call
    GT normalization); re-implemented over this repo's own io/vcflib stack.
    """
    source = sys.stdin if vcf_path == "-" else vcf_path
    reader = VariantFile(source)
    _strip_header(reader.header)
    with VariantFile(outfile, mode="w", header=reader.header) as writer:
        for record in reader:
            _strip_record(record)
            writer.write(record)


def main(args):
    run_unphase(args.vcf, sys.stdout)
