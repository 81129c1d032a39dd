"""
Plumbing shared by all subcommands (counterpart of the reference's
whatshap/cli/__init__.py): CommandLineError, the PhasedInputReader that
multiplexes BAM/CRAM alignments and phased-VCF pseudo-reads into one
ReadSet, and small logging helpers.
"""

import logging
import resource
import sys
from typing import List, Optional, Sequence, Tuple

from ..bam import (
    AlignmentFileNotIndexedError,
    EmptyAlignmentFileError,
    ReferenceNotFoundError,
    SampleNotFoundError,
)
from ..core import Genotype, ReadSet
from ..utils import FastaNotIndexedError, IndexedFasta, detect_file_format
from ..variants import ReadSetError, ReadSetReader
from ..vcf import VcfReader

logger = logging.getLogger(__name__)


class CommandLineError(Exception):
    """An anticipated command-line error; shown as a user-visible message."""


def open_readset_reader(*args, **kwargs) -> ReadSetReader:
    """Construct a ReadSetReader, translating indexing/IO failures into
    user-facing CommandLineErrors."""
    try:
        return ReadSetReader(*args, **kwargs)
    except OSError as e:
        raise CommandLineError(e)
    except AlignmentFileNotIndexedError as e:
        msg = (
            f"The file '{e.args[0]}' is not indexed. Please create the appropriate"
            ' BAM/CRAM index with "samtools index"'
        )
        raise CommandLineError(msg)
    except EmptyAlignmentFileError as e:
        msg = (
            f"No reads could be retrieved from '{e.args[0]}'. If this is a CRAM file,"
            " possibly the reference could not be found. Try to use --reference=..."
            " or check your $REF_PATH/$REF_CACHE settings"
        )
        raise CommandLineError(msg)


def _classify_inputs(paths) -> Tuple[List[str], List[str]]:
    """Split a mixed input list into (alignment files, VCFs) by sniffing
    each file's format."""
    alignment_paths: List[str] = []
    vcf_paths: List[str] = []
    for path in paths:
        try:
            kind = detect_file_format(path)
        except OSError as e:
            raise CommandLineError(e)
        if kind in ("BAM", "CRAM"):
            alignment_paths.append(path)
        elif kind == "VCF":
            vcf_paths.append(path)
        else:
            raise CommandLineError(f"Unable to determine type of input file {path!r}")
    return alignment_paths, vcf_paths


def _open_fasta(path) -> IndexedFasta:
    try:
        return IndexedFasta(path)
    except OSError as e:
        raise CommandLineError(f"Error while opening FASTA reference file: {e}")
    except FastaNotIndexedError as e:
        msg = (
            f"An index file (.fai) for the reference FASTA '{e.args[0]}' could"
            " not be found. Please create one with 'samtools faidx'."
        )
        raise CommandLineError(msg)


class PhasedInputReader:
    """One front door for phasing input: alignments come from BAM/CRAM via
    ReadSetReader; previously-phased blocks in extra VCFs become
    pseudo-reads appended to the same ReadSet."""

    def __init__(
        self,
        bam_or_vcf_paths,
        reference,
        numeric_sample_ids,
        ignore_read_groups,
        only_snvs,
        **kwargs,  # forwarded to ReadSetReader
    ):
        self._bam_paths, self._vcf_paths = _classify_inputs(bam_or_vcf_paths)
        self._numeric_sample_ids = numeric_sample_ids
        self._ignore_read_groups = ignore_read_groups
        self._fasta = _open_fasta(reference) if reference else None
        self._vcf_readers = [
            VcfReader(path, only_snvs=only_snvs, phases=True) for path in self._vcf_paths
        ]
        self._readset_reader = open_readset_reader(
            self._bam_paths, reference, numeric_sample_ids, **kwargs
        )
        # chromosome->VariantTable per phased input VCF; None = not loaded yet
        self._vcfs: Optional[List[dict]] = [] if not self._vcf_readers else None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        if self._fasta is not None:
            self._fasta.close()

    @property
    def has_vcfs(self) -> bool:
        return bool(self._vcf_paths)

    @property
    def has_alignments(self) -> bool:
        return bool(self._bam_paths)

    def read_vcfs(self) -> None:
        """Load every phased input VCF fully (chromosome -> table)."""
        self._vcfs = []
        for reader in self._vcf_readers:
            logger.info("Reading phased blocks from %r", reader.path)
            self._vcfs.append({table.chromosome: table for table in reader})

    def _reference_sequence(self, chromosome):
        if self._fasta is None:
            return None
        try:
            return self._fasta[chromosome]
        except KeyError:
            raise CommandLineError(
                f"Chromosome {chromosome!r} present in VCF file,"
                " but not in the reference FASTA"
            )

    def _read_alignments(
        self, chromosome, variants, sample, regions, restricted_genotypes
    ) -> ReadSet:
        bam_sample = None if self._ignore_read_groups else sample
        try:
            return self._readset_reader.read(
                chromosome,
                variants,
                bam_sample,
                self._reference_sequence(chromosome),
                regions,
                restricted_genotypes,
            )
        except SampleNotFoundError:
            logger.warning("Sample %r not found in any BAM/CRAM file.", bam_sample)
            return ReadSet()
        except ReadSetError as e:
            raise CommandLineError(e)
        except ReferenceNotFoundError:
            message = f"The chromosome {chromosome!r} was not found in the BAM/CRAM file."
            renamed = chromosome[3:] if chromosome.startswith("chr") else "chr" + chromosome
            if self._readset_reader.has_reference(renamed):
                message += f" Found {renamed!r} instead"
            raise CommandLineError(message)

    def read(
        self,
        chromosome,
        variants,
        sample,
        *,
        read_vcf=True,
        regions=None,
        restricted_genotypes: Optional[List[Genotype]] = None,
    ):
        """Return (sorted ReadSet, set of pseudo-read source ids)."""
        logger.debug(
            "Reading alignments %son chromosome %s and detecting alleles ...",
            f"for sample {sample!r} " if not self._ignore_read_groups else "",
            chromosome,
        )
        readset = self._read_alignments(
            chromosome, variants, sample, regions, restricted_genotypes
        )

        vcf_source_ids = set()
        if read_vcf:
            if self._vcfs is None:
                raise ValueError("call PhasedInputReader.read_vcfs() first")
            numeric_id = self._numeric_sample_ids[sample]
            for offset, tables in enumerate(self._vcfs):
                table = tables.get(chromosome)
                if table is None:
                    continue
                source_id = self._readset_reader.n_paths + offset
                vcf_source_ids.add(source_id)
                for pseudo_read in table.phased_blocks_as_reads(
                    sample, variants, source_id, numeric_id
                ):
                    readset.add(pseudo_read)

        for read in readset:
            read.sort()
        readset.sort()
        logger.info(
            "Found %d reads covering %d variants", len(readset), len(readset.get_positions())
        )
        return readset, vcf_source_ids


def log_memory_usage(include_children=False) -> None:
    if sys.platform != "linux":
        return
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if include_children:
        kb += resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    logger.info("Maximum memory usage: %.3f GB", kb / 1e6)


def raise_if_any_sample_not_in_vcf(vcf_reader: VcfReader, samples: Sequence[str]) -> None:
    known = set(vcf_reader.samples)
    for sample in samples:
        if sample not in known:
            raise CommandLineError(f"Sample {sample!r} requested on command-line not found in VCF")


# ---------------------------------------------------------------------------
# declarative argparse specs

# Subcommand modules declare their options as a data table: a list of
# (group, entries) pairs, where group is None (top level) or a
# (title, description) tuple, and each entry is (flags, kwargs) for
# parser.add_argument.  One shared interpreter keeps the CLI surface in a
# scannable tabular form instead of hundreds of add_argument calls.


def populate_arg_parser(parser, spec) -> None:
    for group, entries in spec:
        if group is None:
            target = parser
        else:
            title, description = group
            target = parser.add_argument_group(title, description)
        for flags, kwargs in entries:
            if isinstance(flags, str):
                flags = (flags,)
            target.add_argument(*flags, **kwargs)
