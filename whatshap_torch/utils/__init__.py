"""
Misc utilities: file-format sniffing, indexed FASTA access, region parsing,
one-shot warnings, chromosome filtering.

Behavior parity with whatshap/utils.py; IndexedFasta is our own .fai-based
reader (no pyfaidx).
"""

import gzip
import logging
import os
import stat
import sys
from collections import defaultdict
from dataclasses import dataclass
from typing import DefaultDict, Dict, List, Optional


class FastaNotIndexedError(Exception):
    pass


class InvalidRegion(Exception):
    pass


def detect_file_format(path):
    """Detect file format: 'BAM', 'CRAM', 'VCF' or None.

    'VCF' covers both uncompressed and compressed VCFs (.vcf / .vcf.gz / .bcf).
    """
    with open(path, "rb") as f:
        first_bytes = f.read(16)
        if first_bytes.startswith(b"CRAM"):
            return "CRAM"
        if first_bytes.startswith(b"##fileformat=VCF"):
            return "VCF"

    if first_bytes.startswith(b"\037\213"):
        with gzip.GzipFile(path, "rb") as f:
            first_bytes = f.read(16)
            if first_bytes.startswith(b"BAM\1"):
                return "BAM"
            elif first_bytes.startswith(b"##fileformat=VCF"):
                return "VCF"
            elif first_bytes.startswith(b"BCF"):
                return "VCF"

    return None


def xopen(path, mode: str = "rt", **kwargs):
    """Open a file, transparently handling .gz (stand-in for the xopen
    package used by the reference; extra keyword arguments like threads or
    compresslevel are accepted and ignored)."""
    if str(path).endswith(".gz"):
        if mode in ("r", "w", "a"):
            mode += "t"
        return gzip.open(path, mode)
    return open(path, mode)


def stdout_is_regular_file() -> bool:
    mode = os.fstat(sys.stdout.buffer.fileno()).st_mode
    return stat.S_ISREG(mode)


class _FastaSequence:
    """Lazy access to one reference sequence (upper-cased, raw strings)."""

    def __init__(self, fasta: "IndexedFastaFile", name: str):
        self._fasta = fasta
        self.name = name

    def __getitem__(self, key) -> str:
        if isinstance(key, slice):
            start = key.start if key.start is not None else 0
            stop = key.stop
            return self._fasta.fetch(self.name, start, stop)
        return self._fasta.fetch(self.name, key, key + 1)

    def __len__(self) -> int:
        return self._fasta.length(self.name)

    def __str__(self) -> str:
        return self._fasta.fetch(self.name, 0, None)


class IndexedFastaFile:
    """Random access to a FASTA file via its .fai index (like pyfaidx with
    as_raw=True, sequence_always_upper=True, build_index=False)."""

    def __init__(self, path):
        self._path = os.fspath(path)
        fai = self._path + ".fai"
        if not os.path.exists(fai):
            raise FastaNotIndexedError(path)
        # name -> (length, offset, linebases, linewidth)
        self._index: Dict[str, tuple] = {}
        self._order: List[str] = []
        with open(fai) as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 5:
                    continue
                name = fields[0]
                self._index[name] = (
                    int(fields[1]),
                    int(fields[2]),
                    int(fields[3]),
                    int(fields[4]),
                )
                self._order.append(name)
        self._handle = open(self._path, "rb")

    def close(self):
        self._handle.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def __contains__(self, name) -> bool:
        return name in self._index

    def __getitem__(self, name) -> _FastaSequence:
        if name not in self._index:
            raise KeyError(name)
        return _FastaSequence(self, name)

    def keys(self):
        return list(self._order)

    def length(self, name) -> int:
        return self._index[name][0]

    def fetch(self, name: str, start: int, stop: Optional[int]) -> str:
        length, offset, linebases, linewidth = self._index[name]
        if stop is None or stop > length:
            stop = length
        start = max(0, start)
        if start >= stop:
            return ""
        # file offset of 'start'
        first = offset + (start // linebases) * linewidth + (start % linebases)
        last = offset + ((stop - 1) // linebases) * linewidth + ((stop - 1) % linebases)
        self._handle.seek(first)
        raw = self._handle.read(last - first + 1)
        return raw.decode("ascii").replace("\n", "").replace("\r", "").upper()


def IndexedFasta(path) -> IndexedFastaFile:
    return IndexedFastaFile(path)


def plural_s(n: int) -> str:
    return "" if n == 1 else "s"


@dataclass
class Region:
    chromosome: str
    start: int
    end: Optional[int]

    def __repr__(self):
        return f'Region("{self.chromosome}", {self.start}, {self.end})'

    @staticmethod
    def parse(spec: str):
        """
        >>> Region.parse("chr1")
        Region("chr1", 0, None)
        >>> Region.parse("chr1:101-200")
        Region("chr1", 100, 200)
        """
        parts = spec.split(":", maxsplit=1)
        chromosome = parts[0]
        if len(parts) == 1 or not parts[1]:
            start, end = 0, None
        else:
            try:
                sep = ":" if ":" in parts[1] else "-"
                start_end = parts[1].split(sep, maxsplit=1)
                start = int(start_end[0]) - 1
                if len(start_end) == 1 or not start_end[1]:
                    end = None
                else:
                    end = int(start_end[1])
                    if end <= start:
                        raise InvalidRegion("end is before start in specified region")
            except ValueError:
                raise InvalidRegion("Region must be specified as chrom[:start[-end]])") from None
        return Region(chromosome, start, end)


_warning_count: DefaultDict[str, int] = defaultdict(int)


def warn_once(logger, msg: str, *args) -> None:
    if _warning_count[msg] == 0 and not logger.isEnabledFor(logging.DEBUG):
        logger.warning(msg + " Hiding further warnings of this type, use --debug to show", *args)
    else:
        logger.debug(msg, *args)
    _warning_count[msg] += 1


class ChromosomeFilter:
    """Inclusion/exclusion filter for chromosome names.

    >>> cs1 = ChromosomeFilter(['1', '2'], ['3'])
    >>> '4' in cs1
    False
    >>> '1' in cs1
    True
    >>> '3' in cs1
    False
    >>> cs2 = ChromosomeFilter([], ['3'])
    >>> '1' in cs2
    True
    """

    def __init__(
        self, included_chromosomes: Optional[List[str]], excluded_chromosomes: Optional[List[str]]
    ):
        self._included_chromosomes = [] if included_chromosomes is None else included_chromosomes
        self._excluded_chromosomes = [] if excluded_chromosomes is None else excluded_chromosomes

    def __contains__(self, chromosome):
        return (
            (not self._included_chromosomes) or (chromosome in self._included_chromosomes)
        ) and (chromosome not in self._excluded_chromosomes)
