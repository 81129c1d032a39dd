"""
Phasable-variant bookkeeping for genetic polyploid phasing (counterpart of
whatshap/polyphase/variantselection.py).

Genetic phasing can only use variants whose (parent alt multiplicity,
co-parent alt multiplicity) pair is in an allowed set.  VariantInfo stores,
per variant, the parent's majority (ref) and minority (alt) allele and the
two multiplicities, tracks which variants are currently phasable, and
expands them into "nodes" (one node per alt copy) for the scoring graph.
"""

import logging
from dataclasses import dataclass
from typing import List, Optional

logger = logging.getLogger(__name__)


class VariantInfo:
    @dataclass
    class ParentVariant:
        ref: object
        alt: object
        alt_count: int
        co_alt_count: int

        __slots__ = ("ref", "alt", "alt_count", "co_alt_count")

    # allowed transitions when a (alt, co_alt) classification is corrected
    _COMPATIBLE = {
        (1, 0): {(1, 0), (1, 1), (2, 0)},
        (1, 1): {(1, 1)},
        (2, 0): {(1, 0), (1, 1), (2, 0)},
    }

    def __init__(self, allowed_types):
        self.allowed_types = allowed_types
        self.phasable = set()
        self.variants: List[VariantInfo.ParentVariant] = []
        self.node_positions: List[int] = []
        self.nodes_modified = True

    def __len__(self):
        return len(self.variants)

    def __getitem__(self, key):
        if isinstance(key, slice):
            raise NotImplementedError("VariantInfo does not support slices")
        assert isinstance(key, int)
        size = len(self.variants)
        if not (-size <= key < size):
            raise IndexError(f"Index out of bounds: {key}")
        return self.variants[key % size if key < 0 else key]

    def append(self, ref, alt, alt_count, co_alt_count, skip=False) -> None:
        self.variants.append(self.ParentVariant(ref, alt, alt_count, co_alt_count))
        phasable = (
            not skip and alt is not None and (alt_count, co_alt_count) in self.allowed_types
        )
        if phasable:
            self.phasable.add(len(self.variants) - 1)
            self.nodes_modified = True

    def correct_type(self, index, alt_count=None, co_alt_count=None) -> None:
        entry = self.variants[index]
        old = (entry.alt_count, entry.co_alt_count)
        changed = False
        if alt_count is not None and entry.alt_count != alt_count:
            if alt_count < 0:
                raise ValueError(f"Cannot set alt count of variant to {alt_count}")
            entry.alt_count = alt_count
            changed = True
        if co_alt_count is not None and entry.co_alt_count != co_alt_count:
            if co_alt_count < 0:
                raise ValueError(f"Cannot set alt count of variant to {co_alt_count}")
            entry.co_alt_count = co_alt_count
            changed = True
        if changed:
            if not self.check_variant_compatibility(old[0], old[1], alt_count, co_alt_count):
                self.remove_phasable(index)
            self.nodes_modified = True

    @staticmethod
    def check_variant_compatibility(old_alt, old_co_alt, new_alt, new_co_alt) -> bool:
        allowed = VariantInfo._COMPATIBLE.get((old_alt, old_co_alt))
        return allowed is not None and (new_alt, new_co_alt) in allowed

    def get_phasable(self) -> List[int]:
        return sorted(self.phasable)

    def remove_phasable(self, pos) -> None:
        if pos not in self.phasable:
            raise ValueError(f"Marked variant {pos} as unphasable, but it was already before")
        self.phasable.discard(pos)
        self.nodes_modified = True

    def _refresh_nodes(self) -> None:
        self.node_positions = [
            p for p in self.get_phasable() for _ in range(self.variants[p].alt_count)
        ]
        self.nodes_modified = False

    def update_node_positions(self) -> None:
        self._refresh_nodes()

    def node_to_variant(self, node_id) -> int:
        if self.nodes_modified:
            self._refresh_nodes()
        return self.node_positions[node_id]

    def get_node_positions(self) -> List[int]:
        if self.nodes_modified:
            self._refresh_nodes()
        return self.node_positions[:]


def _classify_parent_genotype(gt1v: List[int], gt2v: List[int]):
    """(ref, alt, parent alt count, co-parent alt count): ref is the
    parent's majority allele (lower-median on ties), alt its minority."""
    ordered = sorted(gt1v)
    ref = ordered[len(ordered) // 2 - 1]
    alt = ordered[0] if ordered[0] != ref else ordered[-1]
    return (
        ref,
        alt,
        sum(1 for a in ordered if a == alt),
        sum(1 for a in gt2v if a == alt),
    )


def compute_phasable_variants(variant_table, parent: str, co_parent: str, phasing_param):
    support = phasing_param.complexity_support
    if support == 0:
        allowed = [(1, 0)]
    elif support == 1:
        allowed = [(1, 0), (1, 1)]
    else:
        allowed = [(1, 0), (2, 0), (1, 1)]
    varinfo = VariantInfo(allowed)

    parent_gts = variant_table.genotypes_of(parent)
    co_parent_gts = variant_table.genotypes_of(co_parent)
    for variant, gt1, gt2 in zip(variant_table.variants, parent_gts, co_parent_gts):
        if gt1.is_none() or gt2.is_none():
            varinfo.append(None, None, 0, 0)
            continue
        gt1v = gt1.as_vector()
        if gt1.is_homozygous():
            varinfo.append(gt1v[0], None, 0, 0)
            continue
        gt2v = gt2.as_vector()
        if len(set(gt1v) | set(gt2v)) > 2:
            varinfo.append(None, None, 0, 0)
            continue
        ref, alt, alt_count, co_alt_count = _classify_parent_genotype(gt1v, gt2v)
        skip = not phasing_param.allow_deletions and "*" in variant.get_alt_allele_list()
        varinfo.append(ref, alt, alt_count, co_alt_count, skip)
    return varinfo


def diff_ratio(ratio):
    """Fold a ratio below 1 onto its reciprocal (deviation magnitude)."""
    if ratio and 0.0 < ratio < 1.0:
        return 1.0 / ratio
    return ratio


def filter_variants(
    varinfo: VariantInfo,
    parent_cov: List[int],
    co_parent_cov: List[int],
    progeny_cov: List[int],
    cutoff: float,
):
    """Drop phasable variants whose coverage ratios (co-parent x progeny
    relative to the parent) deviate from the median by more than cutoff."""
    phasable = varinfo.get_phasable()

    def ratio(num, denom):
        return num / denom if denom > 0 else 0

    products = [
        ratio(progeny_cov[i], parent_cov[i]) * ratio(co_parent_cov[i], parent_cov[i])
        for i in phasable
    ]
    median = sorted(products)[len(products) // 2]
    for index, product in zip(phasable, products):
        if diff_ratio(product / median) > cutoff:
            varinfo.remove_phasable(index)
