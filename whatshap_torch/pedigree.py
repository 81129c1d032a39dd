"""
Pedigree domain services: PED/FAM parsing, per-position recombination cost
computation (uniform rate or genetic map), Mendelian conflict detection and
recombination-event extraction from DP transmission vectors.

Counterpart of the reference's whatshap/pedigree.py — same cost formulas,
file formats and event semantics; the genetic-map lookup here is
bisect-based instead of the reference's two-cursor sweep.
"""

import logging
import math
from bisect import bisect_left
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import IO, Iterator, List, Mapping, Optional, Sequence, Union

from .core import Genotype

logger = logging.getLogger(__name__)

MINIMUM_GENETIC_DISTANCE: float = 1e-10  # cM


class ParseError(Exception):
    pass


@dataclass
class RecombinationMapEntry:
    position: int
    cum_distance: float


@dataclass(order=True)
class RecombinationEvent:
    position1: int
    position2: int
    transmitted_hap_father1: int
    transmitted_hap_father2: int
    transmitted_hap_mother1: int
    transmitted_hap_mother2: int
    recombination_cost: float


def centimorgen_to_phred(distance: float) -> float:
    """Phred-scale the recombination probability implied by a genetic
    distance in centimorgen (Haldane map function)."""
    assert distance >= 0
    if distance == 0:
        raise ValueError("Cannot convert genetic distance of zero to phred.")
    if distance < 1e-10:
        # For tiny distances p ~ distance/100; work in log space directly
        # to avoid underflow.
        return -10.0 * (math.log10(distance) - 2.0)
    p = (1.0 - math.exp(-(2.0 * distance) / 100.0)) / 2.0
    return -10.0 * math.log10(p)


def mendelian_conflict(gt_mother: Genotype, gt_father: Genotype, gt_child: Genotype) -> bool:
    """True iff no assignment of the child's two alleles to (mother, father)
    is consistent with the parental genotypes."""
    m = gt_mother.as_vector()
    f = gt_father.as_vector()
    c0, c1 = gt_child.as_vector()
    return not ((c0 in m and c1 in f) or (c1 in m and c0 in f))


class _GeneticMap:
    """Cumulative-cM lookup: piecewise-linear inside the map, linear from
    (0, 0) before it, and average-rate extrapolation past its end."""

    def __init__(self, entries: Sequence[RecombinationMapEntry]):
        assert entries
        self._pos = [e.position for e in entries]
        self._cum = [e.cum_distance for e in entries]

    def cum_distance_at(self, position: int) -> float:
        pos, cum = self._pos, self._cum
        if position <= pos[0]:
            # before (or at) the first map point: interpolate from origin
            return _lerp(position, 0, pos[0], 0.0, cum[0])
        if position >= pos[-1]:
            rate = cum[-1] / pos[-1]
            return cum[-1] + (position - pos[-1]) * rate
        hi = bisect_left(pos, position)  # pos[hi-1] < position <= pos[hi]
        if pos[hi] == position:
            return cum[hi]
        return _lerp(position, pos[hi - 1], pos[hi], cum[hi - 1], cum[hi])


def _lerp(x, x0, x1, y0, y1):
    assert x0 <= x <= x1
    if x0 == x1:
        assert y0 == y1
        return y0
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


def recombination_cost_map(
    genetic_map: Sequence[RecombinationMapEntry], positions: Sequence[int]
) -> List[int]:
    """Phred recombination cost between consecutive variant positions,
    derived from a genetic map (first position gets cost 0)."""
    gm = _GeneticMap(genetic_map)
    cum = [gm.cum_distance_at(p) for p in positions]
    costs = [0]
    for prev, cur in zip(cum, cum[1:]):
        step = max(cur - prev, MINIMUM_GENETIC_DISTANCE)
        costs.append(round(centimorgen_to_phred(step)))
    return costs


def find_recombination(
    transmission_vector: Sequence[int],
    components: Mapping[int, int],
    positions: Sequence[int],
    recombcost: Sequence[int],
) -> List[RecombinationEvent]:
    """Report positions where the transmission value changes within a phase
    block.  Transmission encodes (father_hap, mother_hap) as value%2 and
    value//2.  Reference quirk preserved: blocks of size <= 2 are skipped
    entirely and the first adjacent pair of larger blocks is never compared
    (the scan starts at the third position)."""
    assert len(transmission_vector) == len(positions) == len(recombcost)
    assert set(components.keys()).issubset(set(positions))
    index_of = {p: i for i, p in enumerate(positions)}

    by_block: dict = {}
    for position, block_id in components.items():
        by_block.setdefault(block_id, []).append(position)

    events = []
    accounted = 0
    for block_positions in by_block.values():
        block_positions.sort()
        if len(block_positions) <= 2:
            continue
        for a, b in zip(block_positions[1:], block_positions[2:]):
            ta = transmission_vector[index_of[a]]
            tb = transmission_vector[index_of[b]]
            if ta == tb:
                continue
            cost = recombcost[index_of[b]]
            events.append(
                RecombinationEvent(a, b, ta % 2, tb % 2, ta // 2, tb // 2, cost)
            )
            accounted += cost

    logger.info("Cost accounted for by recombination events: %d", accounted)
    events.sort()
    return events


class RecombinationCostComputer:
    def compute(self, positions: Sequence[int]) -> Sequence[int]:
        raise NotImplementedError


class GeneticMapRecombinationCostComputer(RecombinationCostComputer):
    def __init__(self, genetic_map_path):
        self._genetic_map = self.load_genetic_map(genetic_map_path)

    @staticmethod
    def load_genetic_map(filename: Union[str, Path]) -> List[RecombinationMapEntry]:
        """Parse a genetic-map file: one header line, then whitespace rows
        of (position, rate, cumulative-cM); only columns 1 and 3 are used."""
        entries: List[RecombinationMapEntry] = []
        warned_flat = False
        with open(filename) as handle:
            for lineno, raw in enumerate(handle, 1):
                if lineno == 1:
                    continue
                fields = raw.split()
                if not fields:
                    continue
                if len(fields) != 3:
                    raise ParseError(
                        f"Error at line {lineno} of genetic map file "
                        f"'{filename}': Found {len(fields)} fields instead of 3"
                    )
                try:
                    entry = RecombinationMapEntry(
                        position=int(fields[0]), cum_distance=float(fields[2])
                    )
                except ValueError as e:
                    raise ParseError(
                        f"Error at line {lineno} of genetic map file '{filename}': {e}"
                    )
                if (
                    not warned_flat
                    and entries
                    and entries[-1].cum_distance == entry.cum_distance
                ):
                    logger.warning("Zero genetic distances encountered in %s", filename)
                    warned_flat = True
                entries.append(entry)
        return entries

    def compute(self, positions: Sequence[int]) -> Sequence[int]:
        return recombination_cost_map(self._genetic_map, positions)


class UniformRecombinationCostComputer(RecombinationCostComputer):
    def __init__(self, recombination_rate: float):
        self._rate = recombination_rate

    @staticmethod
    def uniform_recombination_map(recombrate: float, positions) -> List[int]:
        """Constant cM/Mb rate: cost scales with the base-pair gap between
        consecutive positions."""
        return [0] + [
            round(centimorgen_to_phred((b - a) * 1e-6 * recombrate))
            for a, b in zip(positions, positions[1:])
        ]

    def compute(self, positions: Sequence[int]) -> Sequence[int]:
        return self.uniform_recombination_map(self._rate, positions)


@dataclass
class Trio:
    """One child with its (optional) father and mother."""

    child: str
    father: Optional[str]
    mother: Optional[str]


class PedReader:
    """PLINK PED/FAM parser.  Six whitespace-delimited columns per row
    (family, individual, father, mother, sex, phenotype); '0' parent ids
    mean unknown; comment lines start with '#'."""

    def __init__(self, file: Union[str, Path, IO]):
        if isinstance(file, (str, Path)):
            with open(file) as handle:
                self.trios = self._read(handle)
        else:
            self.trios = self._read(file)

    def _read(self, handle: IO) -> List[Trio]:
        trios = []
        for raw in handle:
            if raw.startswith("#") or not raw.strip():
                continue
            fields = raw.split()
            if len(fields) < 6:
                raise ParseError("Less than six fields found in PED/FAM file")
            child, father, mother = fields[1], fields[2], fields[3]
            trios.append(
                Trio(
                    child=child,
                    father=None if father == "0" else father,
                    mother=None if mother == "0" else mother,
                )
            )
        dupes = [name for name, k in Counter(t.child for t in trios).items() if k > 1]
        if dupes:
            raise ParseError(f"Individual {dupes[0]!r} occurs more than once in PED file")
        return trios

    def __iter__(self) -> Iterator[Trio]:
        return iter(self.trios)

    def samples(self) -> List[str]:
        """All individuals appearing in a complete trio (deterministic
        first-appearance order)."""
        seen: dict = {}
        for trio in self.trios:
            if trio.child is None or trio.father is None or trio.mother is None:
                continue
            for name in (trio.father, trio.mother, trio.child):
                seen[name] = True
        return list(seen)
