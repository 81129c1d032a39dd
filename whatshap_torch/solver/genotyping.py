"""
GenotypeDPTable (forward-backward genotyping) and the per-column prior
genotyper of the PyTorch port, with the reference API (whatshap/core.pyx:
581-618, backed by src/genotypedptable.cpp and src/genotyper.cpp).

Mirrors whatshap_tpu/solver/genotyping.py.  The one addition is `device`:
the forward-backward runs on a CUDA device unless the caller passes another
one (see whatshap_torch.ops.genotyping.run_genotyping).
"""

from typing import List, Optional, Sequence, Tuple

from ..core.genotype import Genotype
from ..core.pedigree_model import Pedigree
from ..core.phredgl import PhredGenotypeLikelihoods
from ..core.readset import ReadSet
from ..ops import genotyping as gt_ops
from ..ops import wmec


class GenotypeDPTable:
    def __init__(
        self,
        numeric_sample_ids,
        readset: ReadSet,
        recombcost: Sequence[int],
        pedigree: Pedigree,
        positions: Optional[Sequence[int]] = None,
        device=None,
    ):
        self.device = wmec.resolve_device(device)
        self._numeric_sample_ids = numeric_sample_ids
        self._pedigree = pedigree
        self._packed = wmec.pack_problem(
            readset, recombcost, pedigree, False, positions,
            check_conflicts=False,
            # the genotyping HMM builds its own probability-space emission
            # from allele/weight: the wMEC integer cost tables are unused
            emission_tables=False,
        )
        self._likelihoods = gt_ops.run_genotyping(self._packed, pedigree, self.device)

    def get_genotype_likelihoods(self, sample_id, pos: int) -> PhredGenotypeLikelihoods:
        numeric_id = self._numeric_sample_ids[sample_id]
        ind = self._pedigree.id_to_index(numeric_id)
        assert self._likelihoods is not None
        values = [float(v) for v in self._likelihoods[pos, ind]]
        return PhredGenotypeLikelihoods(values)


class GenotypeDistribution:
    """Per-column prior genotype distribution (src/genotypedistribution.cpp)."""

    def __init__(self, hom_ref_prob=1 / 3, het_prob=1 / 3, hom_alt_prob=1 / 3):
        self.distribution = [hom_ref_prob, het_prob, hom_alt_prob]

    def probability_of(self, genotype: int) -> float:
        return self.distribution[genotype]

    def __mul__(self, other: "GenotypeDistribution") -> "GenotypeDistribution":
        d = [a * b for a, b in zip(self.distribution, other.distribution)]
        s = sum(d)
        d = [x / s for x in d]
        return GenotypeDistribution(*d)

    def normalize(self) -> None:
        s = sum(self.distribution)
        if s <= 0.0:
            self.distribution = [1 / 3] * 3
        else:
            self.distribution = [x / s for x in self.distribution]

    def likeliest_genotype(self) -> int:
        best_index = 0
        best = 0.0
        for i, p in enumerate(self.distribution):
            if p > best:
                best = p
                best_index = i
        return best_index

    def error_probability(self) -> float:
        best_index = self.likeliest_genotype()
        return sum(p for i, p in enumerate(self.distribution) if i != best_index)


def compute_genotypes(
    readset: ReadSet, positions: Optional[Sequence[int]] = None
) -> Tuple[List[Genotype], List[Tuple[float, float, float]]]:
    """Per-column product-model prior genotyper
    (src/genotyper.cpp:13-55 via core.pyx:603-618)."""
    if positions is None:
        positions = readset.get_positions()
    # column walk identical to ColumnIterator: active reads between first
    # and last variant position, entries at the column position
    genotypes: List[Genotype] = []
    gls: List[Tuple[float, float, float]] = []

    # build per-position entries directly (order does not affect products)
    entries_by_pos = {p: [] for p in positions}
    pos_set = set(positions)
    for read in readset:
        for v in read:
            if v.position in pos_set:
                entries_by_pos[v.position].append((v.allele, v.quality))

    for p in positions:
        dist = GenotypeDistribution()
        for allele, quality in entries_by_pos[p]:
            p_wrong = max(0.05, 10.0 ** (-quality / 10.0))
            if allele == 0:
                dist = dist * GenotypeDistribution(
                    2.0 / 3.0 - 1.0 / 3.0 * p_wrong, 1.0 / 3.0, 1.0 / 3.0 * p_wrong
                )
            elif allele == 1:
                dist = dist * GenotypeDistribution(
                    1.0 / 3.0 * p_wrong, 1.0 / 3.0, 2.0 / 3.0 - 1.0 / 3.0 * p_wrong
                )
        dist.normalize()
        if dist.error_probability() < 0.1:
            genotype = Genotype.from_index(dist.likeliest_genotype(), 2)
        else:
            genotype = Genotype([])
        genotypes.append(genotype)
        gls.append(
            (dist.probability_of(0), dist.probability_of(1), dist.probability_of(2))
        )
    return genotypes, gls
