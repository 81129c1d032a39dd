"""
Polyploid phasing pipeline: shared types, block splitting by read
connectivity, coverage helpers and the ILP-solver gate used by the genetic
polyphase subcommand (counterpart of whatshap/polyphase/__init__.py).
"""

import logging
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

from ..core import ReadSet
from ..graph import ComponentFinder
from .solver import AlleleMatrix

logger = logging.getLogger(__name__)


# type aliases shared across the polyphase package
Position = Allele = ReadId = ClusterId = int
Genotype = AlleleDepth = Dict[int, int]
Haplotype = Cluster = List[int]
Clustering = List[Cluster]
Threading = List[List[ClusterId]]


class SolverError(Exception):
    pass


@dataclass
class Interval:
    start: Position
    end: Position
    length: int = field(init=False)

    def __post_init__(self):
        self.length = self.end - self.start


@dataclass
class PolyphaseParameter:
    ploidy: int
    ce_bundle_edges: bool
    distrust_genotypes: bool
    min_overlap: int
    block_cut_sensitivity: int
    plot_clusters: bool
    plot_threading: bool
    plot_path: str
    threads: int
    use_prephasing: bool


@dataclass
class BlockContext:
    block_id: int
    job_id: int
    total_blocks: int
    recursion_level: int


@dataclass
class PhaseBreakpoint:
    position: int
    haplotypes: List[int]
    confidence: float

    def __post_init__(self):
        self.haplotypes = sorted(self.haplotypes)


@dataclass
class PolyphaseBlockResult:
    block_id: int
    clustering: List[List[int]]
    threads: List[List[int]]
    haplotypes: List[List[int]]
    breakpoints: List[PhaseBreakpoint]


@dataclass
class PolyphaseResult:
    clustering: List[List[int]]
    threads: List[List[int]]
    haplotypes: List[int]
    breakpoints: List[PhaseBreakpoint]


def get_coverage(allele_matrix, clustering):
    """Per position: cluster id -> that cluster's share of the reads
    covering the position."""
    n_pos = allele_matrix.getNumPositions()
    tallies = [Counter() for _ in range(n_pos)]
    for c_id, members in enumerate(clustering):
        for read in members:
            for pos, _ in allele_matrix.getRead(read):
                tallies[pos][c_id] += 1
    shares = []
    for bucket in tallies:
        depth = sum(bucket.values())
        shares.append({c_id: n / depth for c_id, n in bucket.items()})
    return shares


def _cut_coverage_threshold(ploidy: int) -> int:
    """Smallest read count giving >= 98% chance of touching at least
    ploidy-1 haplotypes; replicates the reference's fallback of
    ploidy^2 - 1 when the loop never converges."""
    miss_rate = (ploidy - 2) / ploidy
    hi = ploidy * ploidy
    threshold = hi
    for count in range(ploidy - 1, hi):
        threshold = count
        if ploidy * miss_rate**count < 0.02:
            break
    return threshold


def compute_block_bounds(am, ploidy: int, single_linkage: bool = False) -> Iterator[Interval]:
    """Split the variant range into independently phasable intervals.

    Consecutive variants stay in one interval when enough reads link them
    (transitively, via merging of linked position runs).  A single linking
    read suffices for diploid input or with single_linkage; otherwise the
    coverage threshold from _cut_coverage_threshold applies.
    """
    n_pos = am.getNumPositions()
    if not n_pos:
        return

    link_min = (
        1 if ploidy == 2 or single_linkage else _cut_coverage_threshold(ploidy)
    )
    logger.debug(f"Cut position threshold: coverage >= {link_min}")

    # adjacency coverage between consecutive positions
    adjacent = [0] * n_pos
    for read in am:
        covered = [pos for (pos, _) in read]
        for a, b in zip(covered, covered[1:]):
            if b - a == 1:
                adjacent[a] += 1

    # runs of well-linked consecutive positions
    run_of = [0] * n_pos
    for pos in range(1, n_pos):
        run_of[pos] = run_of[pos - 1] + (adjacent[pos - 1] < link_min)
    n_runs = run_of[-1] + 1

    # reads spanning several runs link them; merge transitively when the
    # pairwise read count clears the threshold
    pair_support = defaultdict(int)
    for read in am:
        touched = {run_of[pos] for (pos, _) in read}
        for r1 in touched:
            for r2 in touched:
                if r1 < r2:
                    pair_support[r1, r2] += 1

    finder = ComponentFinder(range(n_runs))
    for (r1, r2), support in pair_support.items():
        if support >= link_min:
            finder.merge(r1, r2)

    cut_at = 0
    for pos in range(1, n_pos):
        if finder.find(run_of[pos]) != finder.find(run_of[pos - 1]):
            yield Interval(cut_at, pos)
            cut_at = pos
    yield Interval(cut_at, n_pos)


def create_genotype_list(variant_table, sample: str):
    """Per position: allele -> multiplicity in that position's genotype."""
    return [
        dict(Counter(gt.as_vector())) for gt in variant_table.genotypes_of(sample)
    ]


def extract_partial_phasing(variant_table, sample: str, ploidy: int):
    """Existing phased blocks of the input VCF as an AlleleMatrix of
    pseudo-reads (ploidy consecutive rows per block), or None."""
    pseudo = ReadSet()
    for read in variant_table.phased_blocks_as_reads(
        sample, variant_table.variants, 0, 0, target_ploidy=ploidy
    ):
        pseudo.add(read)
    if not len(pseudo):
        return None
    am = AlleleMatrix(pseudo)
    assert len(am) % ploidy == 0
    for row in range(0, len(am), ploidy):
        block_rows = range(row, row + ploidy)
        assert len({am.getFirstPos(r) for r in block_rows}) == 1
        assert len({am.getLastPos(r) for r in block_rows}) == 1
    return am


def get_ilp_solver():
    """A quiet PuLP solver, preferring Gurobi, then CBC; SolverError when
    PuLP or every backend is missing."""
    try:
        import pulp
    except ImportError:
        raise SolverError("PuLP is not installed; no ILP solver available.")
    usable = pulp.listSolvers(onlyAvailable=True)
    for wanted in ("GUROBI_CMD", "GUROBI", "COIN_CMD", "PULP_CBC_CMD"):
        if wanted in usable:
            return pulp.getSolver(wanted, msg=0)
    if usable:
        return pulp.getSolver(usable[0], msg=0)
    raise SolverError("No ILP solver is available for PuLP.")
