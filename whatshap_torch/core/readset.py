"""
Host-side read data model: Read (a sequence of allele observations at variant
positions), ReadSet (ordered container), IndexSet, NumericSampleIds.

Behavior parity with the reference's C++ data model wrapped in Cython
(src/read.{h,cpp}, src/readset.{h,cpp}, src/indexset.{h,cpp},
whatshap/core.pyx:24-361).  These objects live on the host; the solver packs
them into dense arrays (see whatshap_torch.ops.wmec) before dispatching the
column DP to the GPU.

Allele codes (src/entry.h:8): REF=0, ALT=1, BLANK=2 (read spans but does not
cover the site), EQUAL_SCORES=3 (ambiguous).
"""

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from ..utils.stdhash import name_and_source_id_hash
from .variant import Variant

REF_ALLELE = 0
ALT_ALLELE = 1
BLANK_ALLELE = 2
EQUAL_SCORES_ALLELE = 3


class NumericSampleIds:
    """Mapping of sample names (strings) to numeric ids (core.pyx:24-59)."""

    def __init__(self):
        self.mapping: Dict[str, int] = {}
        self.frozen = False

    def __getitem__(self, sample: str) -> int:
        if not self.frozen and sample not in self.mapping:
            self.mapping[sample] = len(self.mapping)
        return self.mapping[sample]

    def __len__(self) -> int:
        return len(self.mapping)

    def __str__(self) -> str:
        return str(self.mapping)

    def freeze(self) -> None:
        """No longer allow modifications"""
        self.frozen = True

    def inverse_mapping(self) -> Dict[int, str]:
        return {numeric_id: name for name, numeric_id in self.mapping.items()}

    def __getstate__(self):
        return (self.mapping, self.frozen)

    def __setstate__(self, state):
        mapping, frozen = state
        self.mapping = mapping
        self.frozen = frozen


class Read:
    """A read: name, mapq(s), ids, tags, and a list of variant observations.

    Parity with src/read.h:10-85 + core.pyx:62-245.
    """

    __slots__ = (
        "name",
        "_mapqs",
        "source_id",
        "sample_id",
        "id",
        "reference_start",
        "reference_end",
        "chromosome",
        "sub_alignment_id",
        "is_supplementary",
        "is_reverse",
        "BX_tag",
        "HP_tag",
        "PS_tag",
        "_positions",
        "_alleles",
        "_qualities",
    )

    def __init__(
        self,
        name: Optional[str] = None,
        mapq: int = 0,
        source_id: int = 0,
        sample_id: int = 0,
        reference_start: int = -1,
        BX_tag: Optional[str] = None,
        HP_tag: int = -1,
        PS_tag: int = -1,
        chromosome: Optional[str] = None,
        sub_alignment_id: Optional[str] = None,
        is_supplementary: bool = False,
        reference_end: int = -1,
        is_reverse: bool = False,
    ):
        self.name = name if name is not None else ""
        self._mapqs: List[int] = [mapq]
        self.source_id = source_id
        self.sample_id = sample_id
        self.id = -1
        self.reference_start = reference_start
        self.reference_end = reference_end
        self.chromosome = chromosome if chromosome is not None else ""
        self.sub_alignment_id = sub_alignment_id if sub_alignment_id is not None else ""
        self.is_supplementary = is_supplementary
        self.is_reverse = is_reverse
        self.BX_tag = BX_tag if BX_tag is not None else ""
        self.HP_tag = HP_tag
        self.PS_tag = PS_tag
        self._positions: List[int] = []
        self._alleles: List[int] = []
        self._qualities: List[int] = []

    # --- variant access -------------------------------------------------
    def add_variant(self, position: int, allele: int, quality: int) -> None:
        self._positions.append(position)
        self._alleles.append(allele)
        self._qualities.append(quality)

    def sort(self) -> None:
        """Sort variants by position; raise on duplicates (read.cpp:66-75)."""
        order = sorted(range(len(self._positions)), key=lambda i: self._positions[i])
        self._positions = [self._positions[i] for i in order]
        self._alleles = [self._alleles[i] for i in order]
        self._qualities = [self._qualities[i] for i in order]
        for i in range(1, len(self._positions)):
            if self._positions[i - 1] == self._positions[i]:
                raise RuntimeError(
                    f"Duplicate variant in read {self.name} at position {self._positions[i]}"
                )

    def is_sorted(self) -> bool:
        return all(
            self._positions[i - 1] < self._positions[i]
            for i in range(1, len(self._positions))
        )

    def first_position(self) -> int:
        if not self._positions:
            raise RuntimeError("No variants present")
        return self._positions[0]

    def last_position(self) -> int:
        if not self._positions:
            raise RuntimeError("No variants present")
        return self._positions[-1]

    @property
    def mapqs(self) -> Tuple[int, ...]:
        return tuple(self._mapqs)

    def add_mapq(self, mapq: int) -> None:
        self._mapqs.append(mapq)

    def has_BX_tag(self) -> bool:
        return self.BX_tag != ""

    # NOTE: the reference's Cython wrapper has a copy-paste quirk where
    # has_HP_tag()/has_PS_tag() also test the BX tag (core.pyx:252-258);
    # the C++ methods test the actual fields. We implement the C++ meaning.
    def has_HP_tag(self) -> bool:
        return self.HP_tag != -1

    def has_PS_tag(self) -> bool:
        return self.PS_tag != -1

    def __iter__(self) -> Iterator[Variant]:
        for i in range(len(self)):
            yield self[i]

    def __len__(self) -> int:
        return len(self._positions)

    def __getitem__(self, key: int) -> Variant:
        if isinstance(key, slice):
            raise NotImplementedError("Read does not support slices")
        n = len(self._positions)
        if not (-n <= key < n):
            raise IndexError(f"Index out of bounds: {key}")
        if key < 0:
            key += n
        return Variant(
            position=self._positions[key],
            allele=self._alleles[key],
            quality=self._qualities[key],
        )

    def __setitem__(self, index: int, variant: Variant) -> None:
        n = len(self._positions)
        if not (-n <= index < n):
            raise IndexError(f"Index out of bounds: {index}")
        if index < 0:
            index += n
        if not isinstance(variant, Variant):
            raise ValueError(f"Expected instance of Variant, but found {type(variant)}")
        self._positions[index] = variant.position
        self._alleles[index] = variant.allele
        self._qualities[index] = variant.quality

    def __contains__(self, position: int) -> bool:
        return position in self._positions

    def copy(self) -> "Read":
        r = Read(
            self.name,
            self._mapqs[0] if self._mapqs else 0,
            self.source_id,
            self.sample_id,
            self.reference_start,
            self.BX_tag,
            self.HP_tag,
            self.PS_tag,
            self.chromosome,
            self.sub_alignment_id,
            self.is_supplementary,
            self.reference_end,
            self.is_reverse,
        )
        r._mapqs = list(self._mapqs)
        r.id = self.id
        r._positions = list(self._positions)
        r._alleles = list(self._alleles)
        r._qualities = list(self._qualities)
        return r

    def __repr__(self) -> str:
        return (
            "Read(name={!r}, mapq={}, source_id={}, sample_id={}, reference_start={}, "
            "reference_end={}, chromosome={}, is_supplementary={}, is_reverse={},  "
            "BX_tag={}, HP_tag={}, PS_tag={}, variants={})".format(
                self.name,
                self.mapqs,
                self.source_id,
                self.sample_id,
                self.reference_start,
                self.reference_end,
                self.chromosome,
                self.is_supplementary,
                self.is_reverse,
                self.BX_tag,
                self.HP_tag,
                self.PS_tag,
                list(self),
            )
        )

    def __getstate__(self):
        variants = [(v.position, v.allele, v.quality) for v in self]
        return (
            list(self._mapqs),
            self.name,
            self.source_id,
            self.sample_id,
            self.reference_start,
            self.reference_end,
            self.BX_tag,
            self.HP_tag,
            self.PS_tag,
            self.chromosome,
            self.sub_alignment_id,
            self.is_supplementary,
            self.is_reverse,
            variants,
        )

    def __setstate__(self, state):
        (
            mapqs,
            name,
            source_id,
            sample_id,
            reference_start,
            reference_end,
            BX_tag,
            HP_tag,
            PS_tag,
            chromosome,
            sub_alignment_id,
            is_supplementary,
            is_reverse,
            variants,
        ) = state
        self.__init__(
            name,
            mapqs[0] if mapqs else 0,
            source_id,
            sample_id,
            reference_start,
            BX_tag,
            HP_tag,
            PS_tag,
            chromosome,
            sub_alignment_id,
            is_supplementary,
            reference_end,
            is_reverse,
        )
        for mapq in mapqs[1:]:
            self.add_mapq(mapq)
        for (pos, allele, quality) in variants:
            self.add_variant(pos, allele, quality)


class IndexSet:
    """Set of read indices (src/indexset.{h,cpp})."""

    def __init__(self):
        self._set = set()

    def contains(self, index: int) -> bool:
        return index in self._set

    def add(self, index: int) -> None:
        self._set.add(index)

    def __len__(self) -> int:
        return len(self._set)

    def __iter__(self):
        return iter(sorted(self._set))

    def __str__(self) -> str:
        return "IndexSet({})".format(", ".join(str(i) for i in sorted(self._set)))


def _readset_sort_key(read: Read):
    """Replicates read_comparator_t (src/readset.h:39-66).

    Reads with no variants come first; then sort by first variant position;
    ties broken by libstdc++ std::hash of (name, source_id), then by name,
    then source_id.
    """
    has_variants = len(read) > 0
    first_pos = read.first_position() if has_variants else -1
    h = name_and_source_id_hash(read.name, read.source_id)
    return (0 if not has_variants else 1, first_pos, h, read.name, read.source_id)


class ReadSet:
    """Ordered container of Reads (src/readset.{h,cpp}, core.pyx:275-361)."""

    def __init__(self):
        self._reads: List[Read] = []
        self._name_map: Dict[Tuple[str, int], int] = {}

    def add(self, read: Read) -> None:
        """Adds a COPY of the read to the set (matching the Cython wrapper)."""
        key = (read.name, read.source_id)
        self._name_map[key] = len(self._reads)
        self._reads.append(read.copy())

    def _add_owned(self, read: Read) -> None:
        """Adds the read itself, without the defensive copy.  Only for
        freshly constructed reads that no other container references
        (the batched read path builds thousands per chromosome)."""
        self._name_map[(read.name, read.source_id)] = len(self._reads)
        self._reads.append(read)

    def sort(self) -> None:
        self._reads.sort(key=_readset_sort_key)
        self._rebuild_name_map()

    def _rebuild_name_map(self) -> None:
        self._name_map = {
            (r.name, r.source_id): i for i, r in enumerate(self._reads)
        }

    def subset(self, reads_to_select: Iterable[int]) -> "ReadSet":
        selected = sorted(set(reads_to_select))
        result = ReadSet()
        for i in selected:
            result.add(self._reads[i])
        return result

    def get_positions(self) -> List[int]:
        positions = set()
        for read in self._reads:
            positions.update(read._positions)
        return sorted(positions)

    def reassign_read_ids(self) -> None:
        for i, read in enumerate(self._reads):
            read.id = i

    def __len__(self) -> int:
        return len(self._reads)

    def __iter__(self) -> Iterator[Read]:
        return iter(self._reads)

    def __getitem__(self, key):
        if isinstance(key, slice):
            raise NotImplementedError("ReadSet does not support slices")
        if isinstance(key, int):
            return self._reads[key]
        if (
            isinstance(key, tuple)
            and len(key) == 2
            and isinstance(key[0], int)
            and isinstance(key[1], str)
        ):
            source_id, name = key
            idx = self._name_map.get((name, source_id))
            if idx is None:
                raise KeyError(key)
            return self._reads[idx]
        raise AssertionError(f"Invalid key: {key}")

    def __str__(self) -> str:
        lines = []
        for read in self._reads:
            entries = ";".join(
                "[{},({},{},{})]".format(v.position, read.id, v.allele, v.quality)
                for v in read
            )
            lines.append(f"{read.name} mapq:{read.mapqs} ({entries})")
        return "ReadSet:\n" + "\n".join(lines)

    def __getstate__(self):
        return [read for read in self._reads]

    def __setstate__(self, state):
        self.__init__()
        for read in state:
            self.add(read)
