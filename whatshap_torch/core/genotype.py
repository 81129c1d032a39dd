"""
Genotype representation: an unordered multiset of alleles with a canonical
VCF index.

Behavior parity with the reference C++ class (src/genotype.h:48-137,
src/genotype.cpp): alleles are stored sorted; the canonical index follows the
VCF specification ordering (for given ploidy, genotypes using only allele 0
come first, then those whose largest allele is 1, etc.).
"""

from functools import lru_cache
from typing import List, Sequence

MAX_ALLELES = 16
MAX_PLOIDY = 15
DIPLOID = 2


@lru_cache(maxsize=None)
def binomial_coefficient(n: int, k: int) -> int:
    # mirrors src/binomial.cpp
    if k < 0 or k > n:
        return 0
    if k == 0 or k == n:
        return 1
    k = min(k, n - k)
    c = 1
    for i in range(k):
        c = c * (n - i) // (i + 1)
    return c


def convert_index_to_alleles(index: int, ploidy: int) -> List[int]:
    """Sorted allele vector from canonical index and ploidy.

    Mirrors src/genotype.cpp convert_index_to_alleles (genotype.h:142).
    """
    # The canonical ordering enumerates genotypes grouped by their maximum
    # allele; within each group recursion applies on the remaining ploidy.
    alleles: List[int] = []
    p = ploidy
    while p > 0:
        # find largest allele a such that C(p + a - 1, p) <= index
        a = 0
        while binomial_coefficient(p + a, p) <= index:
            a += 1
        index -= binomial_coefficient(p + a - 1, p)
        alleles.append(a)
        p -= 1
    alleles.reverse()
    return alleles


def alleles_to_index(alleles: Sequence[int]) -> int:
    """Canonical index from a (multiset of) alleles."""
    s = sorted(alleles)
    index = 0
    for k, a in enumerate(s):
        # k alleles consumed so far (lowest ones); contribution of allele a
        # at position k (1-based count k+1)
        index += binomial_coefficient(k + a, k + 1)
    return index


_FROM_INDEX_CACHE: dict = {}


class Genotype:
    """Multiset of alleles (sorted); hashable and comparable.

    API parity with whatshap.core.Genotype (core.pyx:511-570).
    """

    __slots__ = ("_alleles",)

    def __init__(self, alleles: Sequence[int] = ()):
        if len(alleles) > MAX_PLOIDY:
            raise ValueError("exceeds maximum ploidy")
        if any(a < 0 or a >= MAX_ALLELES for a in alleles):
            raise ValueError("exceeds maximum number of alleles")
        self._alleles = tuple(sorted(alleles))

    @classmethod
    def from_index(cls, index: int, ploidy: int) -> "Genotype":
        # instances are immutable value objects, so common (index, ploidy)
        # pairs share one cached instance (hot in polyphase scoring)
        key = (index, ploidy)
        g = _FROM_INDEX_CACHE.get(key)
        if g is None:
            g = cls(convert_index_to_alleles(index, ploidy))
            if len(_FROM_INDEX_CACHE) < 65536:
                _FROM_INDEX_CACHE[key] = g
        return g

    def is_none(self) -> bool:
        return len(self._alleles) == 0

    def get_index(self) -> int:
        return alleles_to_index(self._alleles)

    def as_vector(self) -> List[int]:
        return list(self._alleles)

    def is_homozygous(self) -> bool:
        if self.is_none():
            return False
        return all(a == self._alleles[0] for a in self._alleles)

    def is_diploid_and_biallelic(self) -> bool:
        return len(self._alleles) == 2 and all(a in (0, 1) for a in self._alleles)

    def get_ploidy(self) -> int:
        return len(self._alleles)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Genotype):
            return NotImplemented
        return self._alleles == other._alleles

    def __ne__(self, other) -> bool:
        if not isinstance(other, Genotype):
            return NotImplemented
        return self._alleles != other._alleles

    def __lt__(self, other: "Genotype") -> bool:
        # reference compares the packed uint64 codes; for genotypes of equal
        # ploidy this is equivalent to comparing sorted allele tuples; across
        # ploidies the ploidy nibble dominates.
        return (len(self._alleles), self._alleles) < (
            len(other._alleles),
            other._alleles,
        )

    def __hash__(self) -> int:
        return hash(self._alleles)

    def __repr__(self) -> str:
        return f"Genotype({list(self._alleles)})"

    def __str__(self) -> str:
        if self.is_none():
            return "."
        return "/".join(str(a) for a in self._alleles)


def get_max_genotype_ploidy() -> int:
    return MAX_PLOIDY


def get_max_genotype_alleles() -> int:
    return MAX_ALLELES
