"""
Phred-scaled genotype likelihoods indexed by canonical genotype index.

Parity with src/phredgenotypelikelihoods.{h,cpp} and its Cython wrapper
(whatshap/core.pyx:469-504).
"""

from typing import List, Sequence

from .genotype import Genotype, binomial_coefficient


class PhredGenotypeLikelihoods:
    __slots__ = ("_gl", "_ploidy", "_nr_alleles")

    def __init__(self, gl: Sequence[float], ploidy: int = 2, nr_alleles: int = 2):
        expected_size = binomial_coefficient(ploidy + nr_alleles - 1, nr_alleles - 1)
        if expected_size != len(gl):
            raise RuntimeError("Error: wrong number of given genotype likelihoods given.")
        self._gl = [float(g) for g in gl]
        self._ploidy = ploidy
        self._nr_alleles = nr_alleles

    def get(self, genotype: Genotype) -> float:
        assert self._ploidy == genotype.get_ploidy()
        return self._gl[genotype.get_index()]

    def __getitem__(self, genotype: Genotype) -> float:
        return self.get(genotype)

    def __len__(self) -> int:
        return len(self._gl)

    def __iter__(self):
        for genotype in self.genotypes():
            yield self[genotype]

    def __eq__(self, other) -> bool:
        if not isinstance(other, PhredGenotypeLikelihoods):
            return NotImplemented
        return self.genotypes() == other.genotypes() and self._gl == other._gl

    def get_ploidy(self) -> int:
        return self._ploidy

    def get_nr_alleles(self) -> int:
        return self._nr_alleles

    def as_vector(self) -> List[float]:
        return list(self._gl)

    def genotypes(self) -> List[Genotype]:
        return [Genotype.from_index(i, self._ploidy) for i in range(len(self._gl))]

    def __str__(self) -> str:
        return "PhredGenotypeLikelihoods({})".format(",".join(str(g) for g in self._gl))
