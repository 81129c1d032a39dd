"""
Sample-filtered alignment input on top of this package's own BAM/CRAM stack
(``io.sam``), counterpart of the reference's whatshap/bam.py (which wraps
pysam).  Two readers share one interface:

- SampleBamReader: one indexed BAM/CRAM; yields only alignments whose RG
  tag maps to the requested sample.
- MultiBamReader: several coordinate-sorted files merged on the fly, each
  tagged with the ``source_id`` of its file.
"""

import heapq
import logging
import os
from typing import Iterable, Iterator, NamedTuple, Optional
from urllib.parse import urlparse

from .io.sam import AlignedSegment, AlignmentFile

logger = logging.getLogger(__name__)


class AlignmentFileNotIndexedError(Exception):
    pass


class SampleNotFoundError(Exception):
    pass


class ReferenceNotFoundError(Exception):
    pass


class EmptyAlignmentFileError(Exception):
    pass


class AlignmentWithSourceID(NamedTuple):
    source_id: int
    bam_alignment: AlignedSegment


def is_local(path: str) -> bool:
    return urlparse(path).scheme == ""


class BamReader:
    """Common interface marker for the two reader flavors."""


def _sample_to_read_groups(header_dict) -> dict:
    """Map sample name (SM) -> frozenset of read-group IDs from @RG lines."""
    by_sample: dict = {}
    for rg in header_dict.get("RG", []):
        sample = rg.get("SM")
        if sample is None:
            logger.warning(
                'Read group "%s" does not contain an SM field to assign it to a sample.'
                " Use --ignore-read-groups to use these alignments anyway.",
                rg["ID"],
            )
            continue
        by_sample.setdefault(sample, set()).add(rg["ID"])
    return {sample: frozenset(ids) for sample, ids in by_sample.items()}


class SampleBamReader(BamReader):
    """One indexed BAM/CRAM, filtered to a single sample's read groups."""

    def __init__(self, path: str, *, source_id: int = 0, reference: Optional[str] = None):
        self.source_id = source_id
        self._samfile = AlignmentFile(
            path, reference_filename=os.path.abspath(reference) if reference else None
        )
        # Probe the index immediately so a missing/empty file fails at
        # construction, not at first use deep inside the pipeline.
        try:
            probe = self._samfile.fetch()
        except ValueError:
            raise AlignmentFileNotIndexedError(path)
        if next(probe, None) is None:
            raise EmptyAlignmentFileError(path)
        self._references = frozenset(self._samfile.references)
        self._groups_of = _sample_to_read_groups(self._samfile.header.to_dict())

    def has_reference(self, name: str) -> bool:
        return name in self._references

    def has_sample(self, sample: str) -> bool:
        return sample in self._groups_of

    def fetch(
        self, reference: str, sample: Optional[str], start: int = 0, end: Optional[int] = None
    ) -> Iterator[AlignmentWithSourceID]:
        if reference not in self._references:
            raise ReferenceNotFoundError(reference)
        region = self._samfile.fetch(reference, start=start, stop=end)
        if sample is None:
            for aln in region:
                yield AlignmentWithSourceID(self.source_id, aln)
            return
        if sample not in self._groups_of:
            raise SampleNotFoundError()
        wanted = self._groups_of[sample]
        for aln in region:
            if aln.has_tag("RG") and aln.get_tag("RG") in wanted:
                yield AlignmentWithSourceID(self.source_id, aln)

    def close(self) -> None:
        self._samfile.close()


class MultiBamReader(BamReader):
    """Merge alignments from several sorted files, ordered by
    (reference_start, source_id)."""

    def __init__(self, paths: Iterable[str], *, reference: Optional[str] = None):
        self._readers = [
            SampleBamReader(p, source_id=i, reference=reference) for i, p in enumerate(paths)
        ]

    def has_reference(self, name: str) -> bool:
        return all(r.has_reference(name) for r in self._readers)

    def fetch(
        self,
        reference: Optional[str] = None,
        sample: Optional[str] = None,
        start: int = 0,
        end: Optional[int] = None,
    ) -> Iterator[AlignmentWithSourceID]:
        assert reference is not None
        streams = [
            r.fetch(reference, sample, start, end)
            for r in self._readers
            if sample is None or r.has_sample(sample)
        ]
        if not streams:
            raise SampleNotFoundError("Sample not found in any input CRAM/BAM file")
        merged = heapq.merge(
            *streams, key=lambda a: (a.bam_alignment.reference_start, a.source_id)
        )
        yield from merged

    def close(self) -> None:
        for r in self._readers:
            r.close()
