"""
VCF domain layer: variant model, per-chromosome VariantTable, VcfReader,
and the two round-trip writers (PhasedVcfWriter, GenotypeVcfWriter).

Functional counterpart of the reference's whatshap/vcf.py (reference
anatomy: whatshap/vcf.py:288-492 VariantTable, :495-846 readers/writers),
but built on this package's own VCF engine (``whatshap_torch.io.vcflib``)
instead of pysam, with a different internal shape:

- variants are thin wrappers over an allele tuple (REF + ALTs) with the
  trim/normalize logic shared between the biallelic and multiallelic cases;
- VariantTable keeps one column struct per sample (keyed by name) rather
  than parallel outer lists indexed by sample id;
- the reader splits record-level screening from per-call field extraction.
"""

import itertools
import logging
import math
import os
import sys
from copy import deepcopy
from dataclasses import dataclass, field
from os import PathLike
from typing import (
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    TextIO,
    Tuple,
    Union,
)

from .core import (
    Genotype,
    PhredGenotypeLikelihoods,
    Read,
    ReadSet,
    binomial_coefficient,
    get_max_genotype_alleles,
    get_max_genotype_ploidy,
)
from .io.vcflib import (
    VariantFile,
    VariantHeader,
    VariantRecord,
    VariantRecordSample,
)
from .utils import warn_once

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# errors


class VcfError(Exception):
    pass


class VcfNotSortedError(VcfError):
    pass


class PloidyError(VcfError):
    pass


class VcfIndexMissing(VcfError):
    pass


class VcfInvalidChromosome(VcfError):
    pass


class VcfInvalidAllele(VcfError):
    pass


class MixedPhasingError(Exception):
    pass


# ---------------------------------------------------------------------------
# variant model


def _trim_common_affixes(position: int, alleles: Tuple[str, ...]):
    """Strip shared suffix then shared prefix from a (REF, ALT...) tuple,
    advancing the position per removed prefix base.  Stops as soon as any
    allele would become empty."""

    def all_end_equal(seq):
        tail = seq[0][-1]
        return all(a and a[-1] == tail for a in seq)

    def all_start_equal(seq):
        head = seq[0][0]
        return all(a and a[0] == head for a in seq)

    while alleles[0] and all_end_equal(alleles):
        alleles = tuple(a[:-1] for a in alleles)
    while alleles[0] and all_start_equal(alleles):
        alleles = tuple(a[1:] for a in alleles)
        position += 1
    return position, alleles


class VcfVariant:
    """One VCF site: a position plus REF and one or more ALT alleles.

    Base class carrying all shared behavior; the two concrete classes
    below only differ in their stored attribute layout (kept for API
    compatibility with the reference's model).
    """

    position: int
    reference_allele: str

    def get_ref_allele(self) -> str:
        return self.reference_allele

    def get_alt_allele_list(self) -> Sequence[str]:
        raise NotImplementedError

    def get_alt_allele(self) -> str:
        return self.get_alt_allele_list()[0]

    def get_allele(self, a: int) -> str:
        if a == 0:
            return self.reference_allele
        alts = self.get_alt_allele_list()
        if a - 1 >= len(alts):
            raise VcfInvalidAllele(f"Querying invalid allele {a} (highest id was {len(alts)}")
        return alts[a - 1]

    def is_snv(self) -> bool:
        alts = self.get_alt_allele_list()
        return (
            len(self.reference_allele) == 1
            and all(len(a) == 1 for a in alts)
            and any(a != self.reference_allele for a in alts)
        )

    def _key(self):
        raise NotImplementedError

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return self._key() == other._key()


class BiallelicVcfVariant(VcfVariant):
    __slots__ = ("position", "reference_allele", "alternative_allele")

    def __init__(self, position: int, reference_allele: str, alternative_allele: str):
        self.position = position
        self.reference_allele = reference_allele
        self.alternative_allele = alternative_allele

    def __repr__(self):
        return (
            f"BiallelicVcfVariant({self.position}, "
            f"{self.reference_allele!r}, {self.alternative_allele!r})"
        )

    def _key(self):
        return (self.position, self.reference_allele, self.alternative_allele)

    def __lt__(self, other):
        return self._key() < other._key()

    def get_alt_allele_list(self) -> Sequence[str]:
        return [self.alternative_allele]

    def get_allele(self, a: int) -> str:
        # keep the reference's exact error text for the biallelic case
        if a == 0:
            return self.reference_allele
        if a == 1:
            return self.alternative_allele
        raise VcfInvalidAllele(f"Querying invalid allele {a} (highest id was 1")

    def is_snv(self) -> bool:
        return self.reference_allele != self.alternative_allele and (
            len(self.reference_allele) == len(self.alternative_allele) == 1
        )

    def normalized(self) -> "BiallelicVcfVariant":
        """Trim shared prefix/suffix bases and shift the position.

        >>> BiallelicVcfVariant(100, 'GCTGTT', 'GCTAAATT').normalized()
        BiallelicVcfVariant(103, 'G', 'AAA')
        """
        pos, (ref, alt) = _trim_common_affixes(
            self.position, (self.reference_allele, self.alternative_allele)
        )
        return BiallelicVcfVariant(pos, ref, alt)


class MultiallelicVcfVariant(VcfVariant):
    __slots__ = ("position", "reference_allele", "alternative_alleles")

    def __init__(self, position: int, reference_allele: str, alternative_alleles: Sequence[str]):
        self.position = position
        self.reference_allele = reference_allele
        self.alternative_alleles = tuple(alternative_alleles)

    def __repr__(self):
        return (
            f"MultiallelicVcfVariant({self.position}, "
            f"{self.reference_allele!r}, {self.alternative_alleles!r})"
        )

    def _key(self):
        return (self.position, self.reference_allele, self.alternative_alleles)

    def __lt__(self, other):
        """Order by (position, ref), then by ALT count, then by the sorted
        ALT lists lexicographically."""
        a = (self.position, self.reference_allele, len(self.alternative_alleles))
        b = (other.position, other.reference_allele, len(other.alternative_alleles))
        if a != b:
            return a < b
        return sorted(self.alternative_alleles) < sorted(other.alternative_alleles)

    def get_alt_allele_list(self) -> Sequence[str]:
        return self.alternative_alleles

    def normalized(self) -> "MultiallelicVcfVariant":
        pos, alleles = _trim_common_affixes(
            self.position, (self.reference_allele,) + self.alternative_alleles
        )
        return MultiallelicVcfVariant(pos, alleles[0], alleles[1:])


@dataclass
class VariantCallPhase:
    block_id: int  # numeric id of the phased block
    phase: Tuple[Optional[int], ...]  # alleles in haplotype order; (1, 0) is 1|0
    quality: Optional[int]


class GenotypeLikelihoods:
    """Genotype likelihoods as log10 probabilities, one per genotype in
    canonical VCF order."""

    __slots__ = ("log_prob_genotypes",)

    def __init__(self, log_prob_genotypes: List[float]):
        self.log_prob_genotypes = log_prob_genotypes

    def __repr__(self):
        return f"GenotypeLikelihoods({self.log_prob_genotypes})"

    def __eq__(self, other):
        if other is None:
            return False
        if self.log_prob_genotypes is None and other.log_prob_genotypes is None:
            return True
        return self.log_prob_genotypes == other.log_prob_genotypes

    def log10_probs(self) -> List[float]:
        return self.log_prob_genotypes

    def log10_prob_of(self, genotype_index: int) -> float:
        return self.log_prob_genotypes[genotype_index]

    def as_phred(
        self, ploidy: int = 2, regularizer: Optional[float] = None
    ) -> PhredGenotypeLikelihoods:
        if regularizer is None:
            # shift so the best genotype sits at phred 0
            best = max(self.log_prob_genotypes)
            scaled = [round((lp - best) * -10) for lp in self.log_prob_genotypes]
        else:
            linear = [10**lp for lp in self.log_prob_genotypes]
            norm = sum(linear)
            regularized = [p / norm + regularizer for p in linear]
            best = max(regularized)
            scaled = [round(-10 * math.log10(p / best)) for p in regularized]
        return PhredGenotypeLikelihoods(scaled, ploidy=ploidy)


# ---------------------------------------------------------------------------
# VariantTable


@dataclass
class _SampleColumns:
    """All per-sample columns of a VariantTable, kept side by side."""

    genotypes: List[Genotype] = field(default_factory=list)
    phases: List[Optional[VariantCallPhase]] = field(default_factory=list)
    likelihoods: List[Optional[GenotypeLikelihoods]] = field(default_factory=list)
    depths: List[Optional[int]] = field(default_factory=list)


class VariantTable:
    """All variants of one chromosome with per-sample genotype, phase,
    likelihood and allele-depth columns.

    Attribute-compatibility note: ``genotypes``, ``phases``,
    ``genotype_likelihoods`` and ``allele_depths`` are exposed as lists
    indexed by sample id (like the reference); internally the columns are
    stored per sample name.
    """

    def __init__(self, chromosome: str, samples: List[str]):
        self.chromosome = chromosome
        self.samples = list(samples)
        self.variants: List[VcfVariant] = []
        self._columns: Dict[str, _SampleColumns] = {s: _SampleColumns() for s in samples}
        #: set by VcfReader(remember_records=True): the chromosome's parsed
        #: VariantRecords, reusable by the output writer (saves the writer's
        #: second parse of the input file)
        self.raw_records: Optional[List[VariantRecord]] = None

    # -- sample-id-indexed views (reference-compatible attribute access)

    @property
    def genotypes(self) -> List[List[Genotype]]:
        return [self._columns[s].genotypes for s in self.samples]

    @property
    def phases(self) -> List[List[Optional[VariantCallPhase]]]:
        return [self._columns[s].phases for s in self.samples]

    @property
    def genotype_likelihoods(self) -> List[List[Optional[GenotypeLikelihoods]]]:
        return [self._columns[s].likelihoods for s in self.samples]

    @property
    def allele_depths(self) -> List[List[Optional[int]]]:
        return [self._columns[s].depths for s in self.samples]

    def __len__(self) -> int:
        return len(self.variants)

    def id_of(self, sample: str) -> int:
        return self.samples.index(sample)

    def add_variant(
        self,
        variant: VcfVariant,
        genotypes: Sequence[Genotype],
        phases: Sequence[Optional[VariantCallPhase]],
        genotype_likelihoods: Sequence[Optional[GenotypeLikelihoods]],
        allele_depths: Sequence[Optional[int]],
    ) -> None:
        """Append one row across all columns."""
        n = len(self.samples)
        if len(genotypes) != n:
            raise ValueError("Expecting as many genotypes as there are samples")
        if len(phases) != n:
            raise ValueError("Expecting as many phases as there are samples")
        if len(allele_depths) != n:
            raise ValueError("Expecting as many allele_depths as there are samples")
        self.variants.append(variant)
        for i, sample in enumerate(self.samples):
            assert isinstance(genotypes[i], Genotype)
            col = self._columns[sample]
            col.genotypes.append(genotypes[i])
            col.phases.append(phases[i])
            col.likelihoods.append(genotype_likelihoods[i])
            col.depths.append(allele_depths[i])

    # -- per-sample accessors

    def genotypes_of(self, sample: str) -> List[Genotype]:
        return self._columns[sample].genotypes

    def set_genotypes_of(self, sample: str, genotypes: List[Genotype]) -> None:
        assert len(genotypes) == len(self.variants)
        self._columns[sample].genotypes = genotypes

    def genotype_likelihoods_of(self, sample: str) -> List[Optional[GenotypeLikelihoods]]:
        return self._columns[sample].likelihoods

    def set_genotype_likelihoods_of(
        self, sample: str, likelihoods: List[Optional[GenotypeLikelihoods]]
    ) -> None:
        assert len(likelihoods) == len(self.variants)
        self._columns[sample].likelihoods = likelihoods

    def phases_of(self, sample: str) -> List[Optional[VariantCallPhase]]:
        return self._columns[sample].phases

    def num_of_blocks_of(self, sample: str) -> int:
        return len({p.block_id for p in self._columns[sample].phases if p is not None})

    def allele_depths_of(self, sample: str) -> List[Tuple[int, ...]]:
        """Decode the 12-bit-packed per-allele depth codes (see
        VcfReader._extract_AD_depth) back into tuples."""
        out = []
        for code in self._columns[sample].depths:
            assert code is not None
            counts = []
            while code > 0:
                counts.append(code & 0xFFF)
                code >>= 12
            out.append(tuple(counts))
        return out

    # -- row filtering

    def remove_rows_by_index(self, indices: Iterable[int]) -> None:
        """Drop the given variant rows (by index) from every column."""
        drop = set(indices)
        keep = [i for i in range(len(self.variants)) if i not in drop]
        self.variants = [self.variants[i] for i in keep]
        for col in self._columns.values():
            col.genotypes = [col.genotypes[i] for i in keep]
            col.phases = [col.phases[i] for i in keep]
            col.likelihoods = [col.likelihoods[i] for i in keep]
            col.depths = [col.depths[i] for i in keep]

    def copy_with_rows(self, keep: Sequence[int]) -> "VariantTable":
        """A new table containing the given rows (in the given order).

        Row objects (variants, genotypes, phases, likelihoods) are shared
        with this table — they are treated as immutable throughout the
        pipeline (columns are only ever replaced wholesale) — so this is a
        cheap alternative to deepcopy + remove_rows_by_index."""
        sub = VariantTable(self.chromosome, self.samples)
        sub.variants = [self.variants[i] for i in keep]
        for s in self.samples:
            src, dst = self._columns[s], sub._columns[s]
            dst.genotypes = [src.genotypes[i] for i in keep]
            dst.phases = [src.phases[i] for i in keep]
            dst.likelihoods = [src.likelihoods[i] for i in keep]
            dst.depths = [src.depths[i] for i in keep]
        return sub

    def subset_rows_by_position(self, positions: Iterable[int]) -> None:
        """Keep only rows whose variant position is in ``positions``."""
        wanted = frozenset(positions)
        self.remove_rows_by_index(
            i for i, v in enumerate(self.variants) if v.position not in wanted
        )

    def create_subtable(self, samples: List[str]) -> "VariantTable":
        """A deep copy restricted to the given samples."""
        sub = VariantTable(self.chromosome, samples)
        sub.variants = deepcopy(self.variants)
        for sample in samples:
            sub._columns[sample] = deepcopy(self._columns[sample])
        return sub

    # -- phased-VCF input as pseudo-reads

    def phased_blocks_as_reads(
        self,
        sample: str,
        input_variants: Iterable[VcfVariant],
        source_id: int,
        numeric_sample_id: int,
        default_quality: int = 20,
        mapq: int = 100,
        target_ploidy: int = 2,
    ):
        """Turn each phased block of ``sample`` into ``target_ploidy``
        pseudo-reads (one per haplotype) carrying the block's phased
        alleles; blocks contribute only variants present in
        ``input_variants``, and only blocks with >= 2 usable variants are
        yielded."""
        if sample not in self._columns:
            return
        eligible = set(input_variants)
        col = self._columns[sample]
        assert len(self.variants) == len(col.genotypes) == len(col.phases)
        block_reads: Dict[int, List[Read]] = {}
        for variant, genotype, phase in zip(self.variants, col.genotypes, col.phases):
            if (
                len(genotype.as_vector()) != target_ploidy
                or variant not in eligible
                or genotype.is_homozygous()
                or phase is None
                or phase.phase[0] is None
            ):
                continue
            quality = default_quality if phase.quality is None else phase.quality
            reads = block_reads.get(phase.block_id)
            if reads is None:
                reads = block_reads[phase.block_id] = [
                    Read(
                        f"{sample}_phase_{i}_block_{phase.block_id}",
                        mapq,
                        source_id,
                        numeric_sample_id,
                    )
                    for i in range(len(phase.phase))
                ]
            for i, allele in enumerate(phase.phase):
                reads[i].add_variant(variant.position, allele, quality)
        for reads in block_reads.values():
            for read in reads:
                if len(read) > 1:
                    read.sort()
                    yield read


# ---------------------------------------------------------------------------
# reading


class VcfReader:
    """Parse a VCF/BCF into VariantTable objects, one per chromosome."""

    def __init__(
        self,
        path: Union[str, PathLike],
        only_snvs: bool = False,
        phases: bool = False,
        genotype_likelihoods: bool = False,
        ignore_genotypes: bool = False,
        ploidy: Optional[int] = None,
        mav: bool = False,
        allele_depth: bool = False,
        remember_records: bool = False,
    ):
        self._vcf = VariantFile(os.fspath(path))
        self._path = path
        self._remember_records = remember_records
        self._only_snvs = only_snvs
        self._want_phases = phases
        self._want_likelihoods = genotype_likelihoods
        self._ignore_genotypes = ignore_genotypes
        self.samples = list(self._vcf.header.samples)  # intentionally public
        self.contigs = self._vcf.header.contigs
        self.ploidy = ploidy
        self.mav = mav
        self.allele_depth = allele_depth
        # which phase representation (HP vs GT+PS) the file uses; mixing is
        # an error
        self._phase_style: Optional[str] = None
        logger.debug("Found %d sample(s) in the VCF file.", len(self.samples))

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def close(self):
        self._vcf.close()

    @property
    def path(self) -> str:
        return self._vcf.filename.decode()

    def index_exists(self) -> bool:
        return self._vcf.index is not None

    def _fetch(self, chromosome: str, start: int = 0, end: Optional[int] = None):
        try:
            return self._vcf.fetch(chromosome, start=start, stop=end)
        except ValueError as e:
            message = e.args[0]
            if "invalid contig" in message:
                raise VcfInvalidChromosome(message) from None
            if "fetch requires an index" in message:
                raise VcfIndexMissing(
                    f"{self._path} is missing an index (.tbi or .csi)"
                ) from None
            raise

    def fetch(self, chromosome: str, start: int = 0, end: Optional[int] = None) -> VariantTable:
        return self._build_table(chromosome, list(self._fetch(chromosome, start, end)))

    def fetch_regions(
        self, chromosome: str, regions: Iterable[Tuple[int, Optional[int]]]
    ) -> VariantTable:
        records: List[VariantRecord] = []
        for start, end in regions:
            records.extend(self._fetch(chromosome, start, end))
        return self._build_table(chromosome, records)

    def __iter__(self) -> Iterator[VariantTable]:
        for chromosome, records in itertools.groupby(self._vcf, lambda rec: rec.chrom):
            if self._remember_records:
                records = list(records)
                table = self._build_table(chromosome, records)
                table.raw_records = records
                yield table
            else:
                yield self._build_table(chromosome, records)

    # -- per-call field extraction

    @staticmethod
    def _extract_HP_phase(call: VariantRecordSample) -> Optional[VariantCallPhase]:
        """HP-style phase: entries like '1-2' = (block 1, haplotype 2)."""
        hp = call.get("HP")
        if hp is None or hp == (".",):
            return None
        if isinstance(hp, str):
            hp = (hp,)
        parsed = [tuple(int(x) for x in item.split("-")) for item in hp]
        block_id = parsed[0][0]
        assert all(block == block_id for block, _ in parsed)
        # invert: haplotype slot -> which GT entry sits there
        slot_of = [hap - 1 for _, hap in parsed]
        gt = call["GT"]
        phase = tuple(gt[slot_of.index(i)] for i in range(len(slot_of)))
        return VariantCallPhase(block_id=block_id, phase=phase, quality=call.get("PQ", None))

    @staticmethod
    def _extract_GT_PS_phase(call: VariantRecordSample) -> Optional[VariantCallPhase]:
        """Native VCF phase: phased GT with optional PS block id."""
        if not call.phased:
            return None
        gt = call["GT"]
        if all(allele == gt[0] for allele in gt):
            return None  # homozygous: no phase information
        return VariantCallPhase(
            block_id=call.get("PS", 0), phase=gt, quality=call.get("PQ", None)
        )

    @staticmethod
    def _extract_AD_depth(call: VariantRecordSample) -> int:
        """Pack per-allele depths into one int, 12 bits per allele
        (capped at 4095), first allele in the low bits."""
        depths = call.get("AD")
        if isinstance(depths, int):
            depths = (depths,)
        code = 0
        if depths and None not in depths:
            for depth in reversed(depths):
                if depth > 0xFFF:
                    warn_once(
                        logger,
                        "Allele depths of 4096 or higher detected. Cutting them off to 4095",
                    )
                code = (code << 12) | min(0xFFF, depth)
        return code

    def _check_ploidy(self, ploidy: int) -> None:
        if ploidy > get_max_genotype_ploidy():
            raise PloidyError(
                f"Ploidies higher than {get_max_genotype_ploidy()} are not supported."
            )
        if self.ploidy is None:
            self.ploidy = ploidy
        elif ploidy != self.ploidy:
            raise PloidyError(f"Inconsistent ploidy ({self.ploidy} and {ploidy})")

    def _phase_of_call(self, call: VariantRecordSample) -> Optional[VariantCallPhase]:
        """Try both phase representations; record which one the file uses
        and reject files mixing them."""
        phase = None
        for style, extractor in (
            ("HP", self._extract_HP_phase),
            ("GT_PS", self._extract_GT_PS_phase),
        ):
            extracted = extractor(call)
            if extracted is None:
                continue
            if self._phase_style is None:
                self._phase_style = style
            elif self._phase_style != style:
                raise MixedPhasingError(
                    "Mixed phasing information in input VCF (e.g. mixing PS and HP fields)"
                )
            phase = extracted
            phase_ploidy = len(extracted.phase)
            if phase_ploidy > get_max_genotype_ploidy():
                raise PloidyError(
                    f"Ploidies higher than {get_max_genotype_ploidy()} are not supported."
                )
            if self.ploidy is None:
                self.ploidy = phase_ploidy
            elif phase_ploidy != self.ploidy:
                raise PloidyError(
                    "Phasing information contains inconsistent ploidy "
                    f"({self.ploidy} and {phase_ploidy})"
                )
        return phase

    @staticmethod
    def _likelihoods_of_call(call: VariantRecordSample) -> Optional[GenotypeLikelihoods]:
        """GL (log10 floats) preferred over PL (phred ints)."""
        gl = call.get("GL", None)
        if gl is not None:
            if not isinstance(gl, tuple):
                gl = (gl,)
            return GenotypeLikelihoods(list(gl))
        pl = call.get("PL", None)
        if pl is not None:
            if not isinstance(pl, tuple):
                pl = (pl,)
            return GenotypeLikelihoods([(x / -10) if x is not None else None for x in pl])
        return None

    # -- table construction

    def _build_table(self, chromosome: str, records) -> VariantTable:
        table = VariantTable(chromosome, self.samples)
        counts = {"snv": 0, "other": 0, "multi": 0}
        last_pos = None
        for record in records:
            if not record.alts:
                continue
            alts = [str(a) for a in record.alts]
            if len(alts) > 1:
                counts["multi"] += 1
                if not self.mav or len(alts) >= get_max_genotype_alleles():
                    continue

            pos, ref = record.start, str(record.ref)
            if len(ref) == 1 and all(len(a) == 1 for a in alts):
                counts["snv"] += 1
            else:
                counts["other"] += 1
                if self._only_snvs:
                    continue

            if last_pos is not None and last_pos > pos:
                raise VcfNotSortedError(
                    f"VCF not ordered: {chromosome}:{last_pos + 1} appears before "
                    f"{chromosome}:{pos + 1}"
                )
            if last_pos == pos:
                warn_once(
                    logger, "Skipping duplicated position %s on chromosome %r", pos + 1, chromosome
                )
                continue
            last_pos = pos

            calls = list(record.samples.values())
            if self._want_phases:
                phases = [self._phase_of_call(c) for c in calls]
            else:
                phases = [None] * len(calls)

            if self._want_likelihoods:
                likelihoods = [self._likelihoods_of_call(c) for c in calls]
            else:
                likelihoods = [None] * len(calls)

            if self._ignore_genotypes:
                genotypes = [Genotype([]) for _ in self.samples]
                phases = [None] * len(self.samples)
            else:
                raw_gts = [c.get("GT", None) for c in calls]
                for gt in raw_gts:
                    if gt is not None and None not in gt:
                        self._check_ploidy(len(gt))
                genotypes = [genotype_code(gt) for gt in raw_gts]

            if self.allele_depth:
                depths: List[Optional[int]] = [self._extract_AD_depth(c) for c in calls]
            else:
                depths = [None] * len(calls)

            variant: VcfVariant
            if len(alts) == 1:
                variant = BiallelicVcfVariant(pos, ref, alts[0])
            else:
                variant = MultiallelicVcfVariant(pos, ref, alts)
            table.add_variant(variant, genotypes, phases, likelihoods, depths)

        logger.debug(
            "Parsed %s SNVs and %s non-SNVs. Also found %s multi-ALTs.",
            counts["snv"],
            counts["other"],
            counts["multi"],
        )
        return table


def genotype_code(gt: Optional[Tuple[Optional[int], ...]]) -> Genotype:
    """Core Genotype from a VCF GT tuple; missing or partial calls map to
    the empty genotype."""
    if gt is None or any(allele is None for allele in gt):
        return Genotype([])
    return Genotype(list(gt))


def remove_overlapping_calls(calls):
    """Filter out overlapping variants.  Deliberately a no-op, matching the
    reference (whatshap/vcf.py:806-821 returns its input unchanged)."""
    return calls


# ---------------------------------------------------------------------------
# header bookkeeping for the writers


def _meta_line(kind: str, id_: str, number, typ: str, description: str) -> str:
    return f'##{kind}=<ID={id_},Number={number},Type={typ},Description="{description}">'


@dataclass
class VcfHeader:
    """One FORMAT/INFO header definition (kept for API parity)."""

    format_or_info: str
    id: str
    number: Union[str, int]
    typ: str
    description: str

    def line(self) -> str:
        return _meta_line(self.format_or_info, self.id, self.number, self.typ, self.description)


def _fmt(id_, number, typ, description) -> VcfHeader:
    return VcfHeader("FORMAT", id_, number, typ, description)


PREDEFINED_FORMATS: Dict[str, VcfHeader] = {
    "GL": _fmt(
        "GL",
        "G",
        "Float",
        "Genotype Likelihood, log10-scaled likelihoods of the data given the"
        " called genotype for each possible genotype generated from the"
        " reference and alternate alleles given the sample ploidy",
    ),
    "GQ": _fmt("GQ", 1, "Integer", "Phred-scaled genotype quality"),
    "GT": _fmt("GT", 1, "String", "Genotype"),
    "HP": _fmt("HP", ".", "String", "Phasing haplotype identifier"),
    "PQ": _fmt("PQ", 1, "Float", "Phasing quality"),
    "PS": _fmt("PS", 1, "Integer", "Phase set identifier"),
    "HS": _fmt("HS", ".", "Integer", "Haploid phase set identifier"),
    "AD": _fmt("AD", ".", "Integer", "Observed allele depths"),
}

PREDEFINED_INFOS: Dict[str, VcfHeader] = {
    "AC": VcfHeader(
        "INFO",
        "AC",
        "A",
        "Integer",
        "Allele count in genotypes, for each ALT allele, in the same order as listed",
    ),
    "AN": VcfHeader(
        "INFO", "AN", "A", "Integer", "Total number of alleles in called genotypes"
    ),
    "END": VcfHeader("INFO", "END", 1, "Integer", "Stop position of the interval"),
    "SVLEN": VcfHeader(
        "INFO", "SVLEN", ".", "Integer", "Difference in length between REF and ALT alleles"
    ),
    "SVTYPE": VcfHeader("INFO", "SVTYPE", 1, "String", "Type of structural variant"),
}


def augment_header(
    header: VariantHeader, contigs: List[str], formats: List[str], infos: List[str]
) -> None:
    """Add missing contig/FORMAT/INFO definitions to a header in place;
    FORMATs already present are replaced by the predefined definition."""
    for contig in contigs:
        header.add_contig(contig)
    for fmt in formats:
        if fmt not in PREDEFINED_FORMATS:
            raise VcfError(f"FORMAT {fmt!r} not defined in VCF header")
        if fmt in header.formats:
            header.remove_format(fmt)
        header.add_line(PREDEFINED_FORMATS[fmt].line())
    for info in infos:
        if info not in PREDEFINED_INFOS:
            raise VcfError(f"INFO {info!r} not defined in VCF header")
        header.add_line(PREDEFINED_INFOS[info].line())


def missing_headers(path: str) -> Tuple[List[str], List[str], List[str]]:
    """Scan a VCF body for contigs/FORMATs/INFOs that its header does not
    declare (or declares with the wrong type/number).  Returns
    (missing contigs, wrong-or-missing formats, missing infos)."""
    with VariantFile(path) as vf:
        header = vf.header.copy()

        retype_formats = []
        for fmt, declared in vf.header.formats.items():
            expected = PREDEFINED_FORMATS.get(fmt)
            if expected is None:
                continue
            number_ok = str(declared.number) == str(expected.number)
            # an Integer field declared as Float is tolerated
            type_ok = declared.type == expected.typ or (
                declared.type == "Float" and expected.typ == "Integer"
            )
            if number_ok and type_ok:
                continue
            if fmt == "PS" and declared.type != expected.typ:
                raise VcfError(
                    "The input VCF/BCF contains phase set ('PS') tags that are of the"
                    " non-standard type '{}' instead of 'Integer'. WhatsHap cannot"
                    " overwrite these as it could produce inconsistent files."
                    " To proceed, you can use 'whatshap unphase' to remove phasing"
                    " information from the input file".format(declared.type)
                )
            retype_formats.append(fmt)

        seen_contigs: Dict[str, None] = {}
        seen_formats: Dict[str, None] = {}
        seen_infos: Dict[str, None] = {}
        try:
            if getattr(vf, "_is_bcf", True):
                for record in vf:
                    for info in record.info:
                        seen_infos[info] = None
                    if any(alt.startswith("<") for alt in record.alts or []):
                        seen_infos["END"] = None
                    seen_contigs[record.contig] = None
                    for fmt in record.format:
                        seen_formats[fmt] = None
            else:
                # text VCF: raw-column scan — only CHROM/ALT/INFO/FORMAT are
                # needed, so skip full record (and per-sample) parsing
                first = vf._first_body
                body = vf._lines_iter if vf._lines_iter is not None else iter(())
                if first is not None:
                    body = itertools.chain([first], body)
                for line in body:
                    fields = line.split("\t", 9)
                    if len(fields) < 8:
                        raise VcfError(
                            f"VCF record with fewer than 8 fields: {line!r}"
                        )
                    info_raw = fields[7]
                    if info_raw not in (".", ""):
                        for item in info_raw.split(";"):
                            if item:
                                seen_infos[item.split("=", 1)[0]] = None
                    alt = fields[4]
                    if alt not in (".", "") and any(
                        a.startswith("<") for a in alt.split(",")
                    ):
                        seen_infos["END"] = None
                    seen_contigs[fields[0]] = None
                    if len(fields) > 8:
                        fmt_col = fields[8].rstrip("\n")
                        if " " in fmt_col or not fmt_col:
                            raise VcfError(
                                f"Malformed FORMAT column: {fmt_col!r}"
                            )
                        if fmt_col != ".":
                            for fmt in fmt_col.split(":"):
                                seen_formats[fmt] = None
        except ValueError as e:
            raise VcfError(e)

    known_contigs = set(header.contigs)
    known_formats = set(header.formats)
    known_infos = set(header.infos)
    return (
        [c for c in seen_contigs if c not in known_contigs],
        retype_formats + [f for f in seen_formats if f not in known_formats],
        [i for i in seen_infos if i not in known_infos],
    )


@dataclass
class GenotypeChange:
    sample: str
    chromosome: str
    variant: VcfVariant
    old_gt: Genotype
    new_gt: Genotype


# ---------------------------------------------------------------------------
# writing


class VcfAugmenter:
    """Copy a VCF through while modifying records chromosome by
    chromosome.  Subclasses declare extra header lines via setup_header
    and drive _record_modifier per chromosome."""

    def __init__(
        self,
        in_path: str,
        command_line: Optional[str],
        out_file: TextIO = sys.stdout,
        include_haploid_phase_sets: bool = False,
    ):
        logger.debug("Reading the input VCF to find possibly missing headers")
        contigs, formats, infos = missing_headers(in_path)
        logger.debug("Missing contigs: %s", contigs)
        logger.debug("Missing formats: %s", formats)
        logger.debug("Missing infos: %s", infos)
        if include_haploid_phase_sets and "HS" not in formats:
            formats.append("HS")
        self._reader = VariantFile(in_path)
        augment_header(self._reader.header, contigs, formats, infos)
        if command_line is not None:
            self._reader.header.add_meta("commandline", '"' + command_line.replace('"', "") + '"')
        self.setup_header(self._reader.header)
        self._writer = VariantFile(out_file, mode="w", header=self._reader.header)
        self._records = iter(self._reader)
        # one-record lookahead buffer for chromosome hand-off
        self._buffered: Optional[VariantRecord] = None

    def setup_header(self, header) -> None:
        raise NotImplementedError

    def close(self) -> None:
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    @property
    def samples(self) -> List[str]:
        return list(self._reader.header.samples)

    def _iterrecords(
        self, chromosome: str, records: Optional[List[VariantRecord]] = None
    ) -> Iterator[VariantRecord]:
        """All input records of ``chromosome``; the first record of the
        following chromosome is buffered for the next call.  When
        ``records`` is given (the reader's already-parsed records of this
        chromosome, VcfReader(remember_records=True)), they are used
        directly and the writer's own input stream is not touched —
        callers must then inject records for EVERY chromosome."""
        if records is not None:
            yield from records
            return
        emitted = 0
        if self._buffered is not None:
            assert self._buffered.chrom == chromosome
            yield self._buffered
            self._buffered = None
            emitted += 1
        for record in self._records:
            if record.chrom != chromosome:
                self._buffered = record
                assert emitted > 0
                return
            emitted += 1
            yield record

    def _record_modifier(
        self, chromosome: str, records: Optional[List[VariantRecord]] = None
    ) -> Iterator[VariantRecord]:
        for record in self._iterrecords(chromosome, records):
            yield record  # caller mutates it here
            self._writer.write(record)

    def write_unchanged(
        self, chromosome: str, records: Optional[List[VariantRecord]] = None
    ) -> None:
        for record in self._iterrecords(chromosome, records):
            self._writer.write(record)


class PhasedVcfWriter(VcfAugmenter):
    """Copy a VCF through, adding phasing (PS or HP tags) from computed
    superreads."""

    def __init__(
        self,
        in_path: str,
        command_line: Optional[str],
        out_file: TextIO = sys.stdout,
        tag: str = "PS",
        ploidy: int = 2,
        include_haploid_sets: bool = False,
        only_snvs: bool = False,
        mav: bool = False,
    ):
        if tag not in ("HP", "PS"):
            raise ValueError('Tag must be either "HP" or "PS"')
        self.tag = tag
        self.ploidy = ploidy
        super().__init__(in_path, command_line, out_file, include_haploid_sets)
        self._warned_existing_tag = False
        self._only_snvs = only_snvs
        self._mav = mav

    def setup_header(self, header: VariantHeader) -> None:
        header.remove_meta_key("phasing")
        header.add_line(PREDEFINED_FORMATS[self.tag].line())

    # -- tag emission

    def _alleles_ok(self, phase: Tuple[int, ...]) -> bool:
        return all(allele in (0, 1) or self._mav for allele in phase)

    def _apply_phase(
        self,
        call: VariantRecordSample,
        block_id: int,
        phase: Tuple[int, ...],
        haploid_component: Optional[Iterable[int]],
    ) -> None:
        assert self._alleles_ok(phase)
        if self.tag == "HP":
            call["HP"] = ",".join(f"{block_id + 1}-{a + 1}" for a in phase)
        else:
            call["PS"] = block_id + 1
            call["GT"] = phase
            call.phased = True
        if haploid_component:
            call["HS"] = [c + 1 for c in haploid_component]

    #: raw-string GT normalization for the overwhelmingly common diploid
    #: biallelic values: unphase + ascending allele order in one lookup
    _GT_NORM = {
        "0/0": "0/0", "0/1": "0/1", "1/0": "0/1", "1/1": "1/1",
        "0|0": "0/0", "0|1": "0/1", "1|0": "0/1", "1|1": "1/1",
    }

    def _remove_existing_phasing(self, record: VariantRecord, samples: Iterable[str]) -> None:
        if self.tag != "PS":
            return
        norm = self._GT_NORM
        for sample in samples:
            call = record.samples[sample]
            raw = call._values.get("GT")
            if raw is None:
                continue
            fast = norm.get(raw)
            if fast is not None:
                call._values["GT"] = fast
                call.phased = False
                continue
            call.phased = False
            gt = call["GT"]
            if gt is not None and None not in gt:
                call["GT"] = tuple(sorted(gt))

    # -- main entry

    def write(
        self,
        chromosome: str,
        sample_superreads: Dict[str, ReadSet],
        sample_components: Dict,
        sample_haploid_components=None,
        records: Optional[List[VariantRecord]] = None,
    ) -> List[GenotypeChange]:
        """Phase one chromosome's records.  ``sample_components`` maps
        sample -> {position -> block id (leftmost variant position)}.
        ``records`` optionally supplies the chromosome's already-parsed
        input records (skips the writer's own re-parse of the input VCF).
        Returns the genotype corrections that were applied."""
        # per sample: position -> (phase tuple, implied genotype)
        phase_of: Dict[str, Dict[int, Tuple[Tuple[int, ...], Genotype]]] = {}
        for sample, superreads in sample_superreads.items():
            per_pos = phase_of[sample] = {}
            for haplotype_slices in zip(*superreads):
                phasing = tuple(v.allele for v in haplotype_slices)
                if self._alleles_ok(phasing):
                    per_pos[haplotype_slices[0].position] = (phasing, Genotype(list(phasing)))

        genotype_changes: List[GenotypeChange] = []
        target_samples = list(sample_superreads)
        # hoisted per-sample lookups for the any-sample-phased screen
        screen = [
            (sample_components.get(s, ()), phase_of.get(s, ()))
            for s in self.samples
            if s in sample_superreads
        ]
        prev_pos = None
        for record in self._record_modifier(chromosome, records):
            self._remove_existing_phasing(record, target_samples)
            if not record.alts:
                continue
            if len(record.alts) > 1 and not self._mav:
                continue
            pos = record.start
            if pos == prev_pos:
                continue
            if self._only_snvs and not (
                len(str(record.ref)) == 1 and len(str(record.alts[0])) == 1
            ):
                continue

            if not any(pos in comp and pos in ph for comp, ph in screen):
                continue  # this variant is phased in no sample

            for sample in target_samples:
                call = record.samples[sample]
                self._warn_about_existing_tag(call)
                genotype_changes.extend(
                    self._phase_one_call(record, chromosome, sample, call, pos, phase_of[sample],
                                         sample_components[sample], sample_haploid_components)
                )
            prev_pos = pos
        return genotype_changes

    def _warn_about_existing_tag(self, call: VariantRecordSample) -> None:
        if self._warned_existing_tag:
            return
        if self.tag in call and call[self.tag] is not None:
            logger.warning(
                "Ignoring existing phasing information "
                "found in input VCF ({} tag exists).".format(self.tag)
            )
            self._warned_existing_tag = True

    #: raw diploid biallelic GT -> canonical genotype index
    _GT_IDX = {"0/0": 0, "0/1": 1, "1/1": 2}

    def _phase_one_call(
        self,
        record: VariantRecord,
        chromosome: str,
        sample: str,
        call: VariantRecordSample,
        pos: int,
        phases: Dict[int, Tuple[Tuple[int, ...], Genotype]],
        components: Dict[int, int],
        sample_haploid_components,
    ) -> List[GenotypeChange]:
        # raw-string fast path for the common case: diploid biallelic call,
        # no genotype correction, PS tag, no haploid sets — equivalent to
        # the full path below, without Genotype object construction
        if self.tag == "PS" and sample_haploid_components is None:
            code = self._GT_IDX.get(call._values.get("GT", ""))
            if code is not None:
                entry = phases.get(pos)
                if entry is None:
                    call._values.pop("PS", None)
                    return []
                phasing = entry[0]
                if (
                    len(phasing) == 2
                    and 0 <= phasing[0] <= 1
                    and 0 <= phasing[1] <= 1
                    and phasing[0] + phasing[1] == code
                ):
                    if code == 1 and pos in components:
                        call._values["GT"] = f"{phasing[0]}|{phasing[1]}"
                        call._values["PS"] = str(components[pos] + 1)
                        call.phased = True
                        record._ensure_format("PS")
                    else:
                        call._values.pop("PS", None)
                    return []

        changes: List[GenotypeChange] = []
        current_gt = genotype_code(call["GT"])
        is_het = not current_gt.is_homozygous()

        entry = phases.get(pos)
        if entry is not None:
            phasing, implied_gt = entry
            if implied_gt != current_gt:
                # solver corrected the genotype (distrust-genotypes mode)
                call["GT"] = tuple(implied_gt.as_vector())
                alts = record.alts
                variant: VcfVariant
                if len(alts) > 1:
                    variant = MultiallelicVcfVariant(record.start, record.ref, alts)
                else:
                    variant = BiallelicVcfVariant(record.start, record.ref, alts[0])
                changes.append(
                    GenotypeChange(sample, chromosome, variant, current_gt, implied_gt)
                )
                is_het = not implied_gt.is_homozygous()

        if entry is not None and pos in components and is_het:
            haploid_component = None
            if sample_haploid_components:
                hc = sample_haploid_components[sample]
                if pos in hc and len(hc[pos]) == self.ploidy:
                    haploid_component = hc[pos]
            self._apply_phase(call, components[pos], entry[0], haploid_component)
        else:
            call[self.tag] = None
        return changes


class GenotypeVcfWriter(VcfAugmenter):
    """Copy a VCF through, replacing genotype calls (GT/GQ/GL) with the
    re-genotyping results."""

    def __init__(self, in_path: str, command_line: Optional[str], out_file: TextIO = sys.stdout):
        super().__init__(in_path, command_line, out_file)

    def setup_header(self, header: VariantHeader) -> None:
        header.add_line(
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="'
            'Genotype computed by WhatsHap genotyping algorithm">'
        )
        header.add_line(
            '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="'
            'Phred-scaled genotype quality computed by WhatsHap genotyping algorithm">'
        )
        header.add_line(
            '##FORMAT=<ID=GL,Number=G,Type=Float,Description="'
            'Log10-scaled likelihoods for genotypes: 0/0, 0/1, 1/1, '
            'computed by WhatsHap genotyping algorithm">'
        )

    def write_genotypes(
        self, chromosome: str, variant_table: VariantTable, only_snvs, ploidy: int = 2
    ) -> None:
        """Write re-genotyped records for one chromosome."""
        row_of = {v.position: i for i, v in enumerate(variant_table.variants)}

        KEEP_TAGS = frozenset(["GT", "GL", "GQ"])
        for record in self._record_modifier(chromosome):
            if not record.alts:
                continue
            pos = record.start
            n_alleles = 1 + len(record.alts)
            n_genotypes = int(binomial_coefficient(ploidy + n_alleles - 1, n_alleles - 1))

            for sample, call in record.samples.items():
                # defaults: no call, flat likelihood over all genotypes
                genotype = Genotype([])
                likelihoods: List[float] = [1 / n_genotypes] * n_genotypes

                row = row_of.get(pos)
                if row is not None:
                    gl = variant_table.genotype_likelihoods_of(sample)[row]
                    # gl is None when the position was inaccessible
                    if gl is not None:
                        likelihoods = list(gl)
                        genotype = variant_table.genotypes_of(sample)[row]

                call["GT"] = tuple(genotype.as_vector())
                call["GL"] = [
                    max(math.log10(p), -1000) if p > 0 else -1000 for p in likelihoods
                ]

                # GQ = phred probability that the call is wrong
                if genotype.is_none():
                    call["GQ"] = None
                else:
                    wrong = sum(
                        likelihoods[i] for i in range(n_genotypes) if i != genotype.get_index()
                    )
                    call["GQ"] = min(round(-10.0 * math.log10(wrong)), 10000) if wrong > 0 else 10000

                record.qual = None
                for tag in set(call.keys()) - KEEP_TAGS:
                    del call[tag]
