"""
Core pedigree model consumed by the solvers.

Parity with src/pedigree.{h,cpp} (individuals with per-variant genotypes and
optional phred genotype likelihoods; mother/father/child triples) plus
src/pedigreepartitions.cpp (mapping of (individual, haplotype) to founder
haplotype partitions for a given transmission vector) and the Cython wrapper
whatshap/core.pyx:419-466.
"""

from typing import Dict, List, Optional, Sequence, Tuple

from .genotype import Genotype
from .phredgl import PhredGenotypeLikelihoods


class Pedigree:
    """Pedigree of individuals with genotypes and optional likelihoods.

    The Cython-level API takes a NumericSampleIds plus string sample names;
    individuals are stored in insertion order and identified by numeric id.
    """

    def __init__(self, numeric_sample_ids=None):
        self._numeric_sample_ids = numeric_sample_ids
        self._individual_ids: List[int] = []
        self._id_to_index: Dict[int, int] = {}
        self._genotypes: List[List[Genotype]] = []
        self._genotype_likelihoods: List[List[Optional[PhredGenotypeLikelihoods]]] = []
        self._triples: List[Tuple[int, int, int]] = []  # (father, mother, child) indices
        self._variant_count = -1

    # -- construction (core.pyx:424-448) ---------------------------------
    def _to_numeric_id(self, sample) -> int:
        # The Cython wrapper always maps through NumericSampleIds
        # (core.pyx:441-444), whatever the key type.
        if self._numeric_sample_ids is not None:
            return self._numeric_sample_ids[sample]
        return sample

    def add_individual(
        self,
        id,
        genotypes: Sequence[Genotype],
        genotype_likelihoods: Optional[Sequence[Optional[PhredGenotypeLikelihoods]]] = None,
    ) -> None:
        numeric_id = self._to_numeric_id(id)
        if self._variant_count == -1:
            self._variant_count = len(genotypes)
        elif self._variant_count != len(genotypes):
            raise RuntimeError("Pedigree: inconsistent numbers of genotypes")
        if genotype_likelihoods is None:
            gls: List[Optional[PhredGenotypeLikelihoods]] = [None] * len(genotypes)
        else:
            gls = list(genotype_likelihoods)
        if self._variant_count != len(gls):
            raise RuntimeError("Pedigree: inconsistent numbers of genotype likelihoods")
        self._id_to_index[numeric_id] = len(self._individual_ids)
        self._individual_ids.append(numeric_id)
        self._genotypes.append(list(genotypes))
        self._genotype_likelihoods.append(gls)

    def add_relationship(self, father_id, mother_id, child_id) -> None:
        self._triples.append(
            (
                self.id_to_index(self._to_numeric_id(father_id)),
                self.id_to_index(self._to_numeric_id(mother_id)),
                self.id_to_index(self._to_numeric_id(child_id)),
            )
        )

    # -- queries ----------------------------------------------------------
    def id_to_index(self, individual_id: int) -> int:
        return self._id_to_index[individual_id]

    def index_to_id(self, index: int) -> int:
        return self._individual_ids[index]

    def get_genotype(self, individual_index: int, variant_index: int) -> Genotype:
        return self._genotypes[individual_index][variant_index]

    def get_genotype_by_id(self, individual_id, variant_index: int) -> Genotype:
        return self.get_genotype(
            self.id_to_index(self._to_numeric_id(individual_id)), variant_index
        )

    def get_genotype_likelihoods(
        self, individual_index: int, variant_index: int
    ) -> Optional[PhredGenotypeLikelihoods]:
        return self._genotype_likelihoods[individual_index][variant_index]

    def get_genotype_likelihoods_by_id(
        self, individual_id, variant_index: int
    ) -> Optional[PhredGenotypeLikelihoods]:
        return self.get_genotype_likelihoods(
            self.id_to_index(self._to_numeric_id(individual_id)), variant_index
        )

    # Cython-wrapper method names (core.pyx:451-459)
    def genotype(self, sample_id, variant_index: int) -> Genotype:
        return self.get_genotype_by_id(sample_id, variant_index)

    def genotype_likelihoods(
        self, sample_id, variant_index: int
    ) -> Optional[PhredGenotypeLikelihoods]:
        return self.get_genotype_likelihoods_by_id(sample_id, variant_index)

    def __len__(self) -> int:
        return len(self._individual_ids)

    @property
    def size(self) -> int:
        return len(self._individual_ids)

    @property
    def variant_count(self) -> int:
        """Number of variants stored per individual (0 if no individuals)."""
        return self._variant_count if self._variant_count != -1 else 0

    @property
    def triple_count(self) -> int:
        return len(self._triples)

    @property
    def triples(self) -> List[Tuple[int, int, int]]:
        return list(self._triples)


class PedigreePartitions:
    """For one transmission vector, map each (individual, haplotype) to one of
    2*(#individuals - #trios) founder-haplotype partitions.

    Parity with src/pedigreepartitions.cpp:7-52.  Transmission vector has
    2 bits per trio: bit(2t) selects which parental haplotype of the father
    is transmitted, bit(2t+1) of the mother — with the reference's inverted
    bit convention (``!(bool)((tv >> (2*t)) & 1)``).
    """

    def __init__(self, pedigree: Pedigree, transmission_vector: int):
        self.pedigree = pedigree
        self.transmission_vector = transmission_vector
        n = len(pedigree)
        self.partition_count = 2 * (n - pedigree.triple_count)
        self._map: List[List[int]] = [[-1, -1] for _ in range(n)]

        triple_indices = [-1] * n
        for t, (_father, _mother, child) in enumerate(pedigree.triples):
            triple_indices[child] = t

        p = 0
        for i in range(n):
            if triple_indices[i] == -1:
                self._map[i] = [p, p + 1]
                p += 2
        for i in range(n):
            self._compute_rec(i, triple_indices)

    def _compute_rec(self, i: int, triple_indices: List[int]) -> None:
        if self._map[i][0] != -1:
            return
        t = triple_indices[i]
        assert t >= 0
        parent0, parent1, _child = self.pedigree.triples[t]
        self._compute_rec(parent0, triple_indices)
        self._compute_rec(parent1, triple_indices)
        tv = self.transmission_vector
        self._map[i] = [
            self._map[parent0][0 if ((tv >> (2 * t)) & 1) else 1],
            self._map[parent1][0 if ((tv >> (2 * t + 1)) & 1) else 1],
        ]

    def count(self) -> int:
        return self.partition_count

    def haplotype_to_partition(self, individual_index: int, haplotype: int) -> int:
        return self._map[individual_index][haplotype]
