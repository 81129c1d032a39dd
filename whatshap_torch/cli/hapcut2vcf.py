"""
Convert hapCUT output format to VCF

HapCUT’s output is combined with the original VCF and
then written as phased VCF to standard output.

HapCUT 1 and 2 are supported.

HapCUT’s output file format is explained at
<https://github.com/vibansal/hapcut#format-of-input-and-output-files>

HapCUT2’s output format is documented at
<https://github.com/pjedge/hapcut2#output-format>
"""

import itertools
import logging
import re
import sys
from contextlib import ExitStack
from dataclasses import dataclass

from .. import __version__
from ..core import Read
from ..vcf import PhasedVcfWriter
from . import CommandLineError

logger = logging.getLogger(__name__)


def add_arguments(parser):
    parser.add_argument(
        "-o",
        "--output",
        default=sys.stdout,
        help="Output VCF file. If omitted, use standard output.",
    )
    parser.add_argument("vcf", metavar="VCF", help="VCF file")
    parser.add_argument("hapcut", metavar="HAPCUT-RESULT", help="hapCUT result file")


class ParseError(Exception):
    pass


@dataclass
class HapCutVariant:
    chromosome: str
    position: int
    haplotype1: int
    haplotype2: int
    component_id: int


_BLOCK_HEADER = re.compile(
    r"BLOCK: "
    r"offset: (?P<offset>\d+) "
    r"len: (?P<len>\d+) "
    r"phased: (?P<phased>\d+) "
    r"SPAN: (?P<span>\d+) "
    r"(MECscore (?P<mecscore>\d+\.\d+) )?fragments (?P<fragments>\d+)"
)


def _parse_variant_line(line: str, block):
    """One hapCUT variant row (9 fields = hapCUT 1, 11 = hapCUT 2) ->
    HapCutVariant, or None for unphased ('-') rows."""
    fields = line.strip().split()
    if len(fields) not in (9, 11):
        raise ParseError(
            "Expected nine fields (for hapCUT 1) "
            "or eleven fields (for hapCUT 2) in variant line"
        )
    variant_id, hap1, hap2, chromosome, position = fields[:5]

    if len(fields) == 9:
        # hapCUT 1 ends in a colon-joined summary field; sanity-check it
        tail = fields[8].split(":")
        if len(tail) == 5:
            if tail[-1] != "FV":
                raise ParseError('Expected "FV" after last colon')
            tail = tail[:-1]
        if len(tail) != 4:
            raise ParseError("Too few elements in last (colon-separated) field")
    if hap1 == "-" or hap2 == "-":
        return None  # hapCUT 2 leaves some variants unphased
    int(variant_id)  # must be numeric
    position = int(position) - 1
    component_id = block[0].position if block else position
    return HapCutVariant(chromosome, position, int(hap1), int(hap2), component_id)


class HapCutParser:
    """Stream of BLOCK sections, each a header line, variant rows, and a
    '********' terminator."""

    def __init__(self, file):
        self._file = file

    def parse_blocks(self):
        """Yield each block as a list of HapCutVariant objects."""
        expecting_header = True
        block = []
        for line in self._file:
            if expecting_header:
                if not line.startswith("BLOCK:"):
                    raise ParseError('Expected a new block (line starting with "BLOCK:")')
                if not _BLOCK_HEADER.match(line):
                    raise ParseError("BLOCK line malformed")
                expecting_header = False
            elif line.startswith("********"):
                if block:
                    yield block
                block = []
                expecting_header = True
            else:
                variant = _parse_variant_line(line, block)
                if variant is not None:
                    block.append(variant)
        if block:
            yield block

    def __iter__(self):
        """Yield (chromosome, list of blocks) pairs."""
        grouped = itertools.groupby(self.parse_blocks(), lambda b: b[0].chromosome)
        for chromosome, blocks in grouped:
            yield chromosome, list(blocks)


def run_hapcut2vcf(hapcut, vcf, output=sys.stdout):
    command_line = "(whatshap {}) {}".format(__version__, " ".join(sys.argv[1:]))
    with ExitStack() as stack:
        if isinstance(output, str):
            output = stack.enter_context(open(output, "w"))

        writer = PhasedVcfWriter(vcf, command_line, out_file=output)
        if len(writer.samples) > 1:
            # hapCUT itself cannot process multi-sample VCFs
            raise CommandLineError("There is more than one sample in this VCF")
        sample = writer.samples[0]

        handle = stack.enter_context(open(hapcut))
        for chromosome, blocks in HapCutParser(handle):
            logger.info("Read %d phased blocks for chromosome %s", len(blocks), chromosome)
            haplotypes = [Read("1"), Read("2")]
            components = {}
            for block in blocks:
                for v in block:
                    haplotypes[0].add_variant(v.position, v.haplotype1, 0)
                    haplotypes[1].add_variant(v.position, v.haplotype2, 0)
                    components[v.position] = v.component_id
            writer.write(chromosome, {sample: haplotypes}, {sample: components})


def main(args):
    run_hapcut2vcf(**vars(args))
