"""
Test-support helpers of the port: ASCII allele-matrix fixtures and a
brute-force MEC oracle, copied from whatshap_tpu/testhelpers.py so that the
port imports nothing of the reference.

The fixture *format* is a parity contract with the reference test suite
(whatshap/testhelpers.py defines it): each line of an ASCII block is one
read, each character column one variant at position (col+1)*10, spaces are
uncovered sites, and an optional parallel block gives per-site phred
weights.  Fixtures parse into a dense numpy allele/weight matrix first, and
the brute-force oracle scores every bipartition with one matrix product
instead of walking reads per partition per column.
"""

import math
import textwrap

import numpy as np

from .core import Genotype, PhredGenotypeLikelihoods, Read, ReadSet


def likelihoods_equal(a: PhredGenotypeLikelihoods, b: PhredGenotypeLikelihoods):
    return all(math.isclose(a[gt], b[gt], abs_tol=1e-9) for gt in a.genotypes())


def _parse_matrix(block):
    """ASCII block -> list of rows, each a list of (column, value) pairs."""
    rows = []
    for line in textwrap.dedent(block).strip().split("\n"):
        if line:
            rows.append([(col, int(ch)) for col, ch in enumerate(line) if ch != " "])
    return rows


def string_to_readset(s, w=None, sample_ids=None, source_id=0, scale_quality=None):
    """Build a ReadSet from an ASCII allele matrix (optionally with a
    parallel weight matrix `w`); variant positions are (column+1)*10."""
    alleles = _parse_matrix(s)
    weights = None if w is None else textwrap.dedent(w).strip().split("\n")
    rs = ReadSet()
    for i, row in enumerate(alleles):
        sid = 0 if sample_ids is None else sample_ids[i]
        read = Read(f"Read {i + 1}", 50, source_id, sid)
        for col, allele in row:
            q = 1 if weights is None else int(weights[i][col])
            if scale_quality is not None:
                q *= scale_quality
            read.add_variant(position=(col + 1) * 10, allele=allele, quality=q)
        assert len(read) > 1, "Reads covering less than two variants are not allowed"
        rs.add(read)
    print(rs)
    return rs


def string_to_readset_pedigree(s, w=None, scaling_quality=None):
    """Pedigree variant of the ASCII format: the first character of each
    line names the individual (A, B, C, ...)."""
    lines = [ln for ln in textwrap.dedent(s).strip().split("\n") if ln]
    sources = []
    for ln in lines:
        individual = ord(ln[0]) - ord("A")
        assert 0 <= individual < 26
        sources.append(individual)
    body = "\n".join(ln[1:] for ln in lines)
    rs = string_to_readset(
        s=body, w=w, sample_ids=sources, scale_quality=scaling_quality
    )
    print("read_sources:", sources)
    return rs


def matrix_to_readset(lines):
    """Build a ReadSet from the sparse `.matrix` fixture format: each line
    is `index (offset alleles)+` with 1-based contiguous indices."""
    rs = ReadSet()
    for expected_index, line in enumerate(lines, start=1):
        fields = line.split()
        assert len(fields) % 2 == 1, "Not in matrix format."
        assert int(fields[0]) == expected_index, "Not in matrix format."
        read = Read(f"Read {expected_index}", 50)
        for offset_str, run in zip(fields[1::2], fields[2::2]):
            offset = int(offset_str)
            for j, ch in enumerate(run):
                read.add_variant(position=(offset + j) * 10, allele=int(ch), quality=1)
        rs.add(read)
    print(rs)
    return rs


def _readset_to_arrays(read_set):
    """Dense (reads x positions) allele/weight matrices; allele -1 = blank."""
    positions = read_set.get_positions()
    col_of = {p: i for i, p in enumerate(positions)}
    R, P = len(read_set), len(positions)
    alleles = np.full((R, P), -1, dtype=np.int64)
    weights = np.zeros((R, P), dtype=np.int64)
    for r, read in enumerate(read_set):
        for v in read:
            c = col_of[v.position]
            alleles[r, c] = v.allele
            weights[r, c] = v.quality
    return alleles, weights


def _haplotype_with_ties(assign_costs, assignments):
    """Per column: minimum-cost assignment with EQUAL_SCORES (allele 3)
    marking any haplotype whose allele differs among the tied minima.
    assign_costs: (nA, P); assignments: (nA, 2)."""
    P = assign_costs.shape[1]
    mins = assign_costs.min(axis=0)
    hap = np.empty((P, 2), dtype=np.int64)
    for side in (0, 1):
        vals = assignments[:, side][:, None]  # (nA, 1)
        tied = assign_costs == mins[None, :]
        lo = np.where(tied, vals, np.iinfo(np.int64).max).min(axis=0)
        hi = np.where(tied, vals, np.iinfo(np.int64).min).max(axis=0)
        first = assignments[np.argmin(assign_costs, axis=0), side]
        hap[:, side] = np.where(lo != hi, 3, first)
    return mins, hap


def brute_force_phase(read_set, all_heterozygous):
    """Exact MEC by exhaustive bipartition enumeration, as a matrix product:
    cost[a0->side] = (partition indicator) @ (per-read flip cost), so all
    2^R partitions score in one shot.  Returns (cost, partition per read,
    #solutions//2, haplotype1, haplotype2) like the reference oracle."""
    R = len(read_set)
    assert R < 10, "Too many reads for brute force"
    alleles, weights = _readset_to_arrays(read_set)
    P = alleles.shape[1]
    if all_heterozygous:
        assignments = np.array([(0, 1), (1, 0)], dtype=np.int64)
    else:
        assignments = np.array([(0, 0), (0, 1), (1, 0), (1, 1)], dtype=np.int64)

    # flip[a, r, p]: cost of read r's observation at p under target allele
    # a — any covered allele differing from the target is charged (a
    # non-biallelic observation costs against both targets), blanks cost 0
    covered = alleles >= 0
    flip = np.stack(
        [
            np.where(covered & (alleles != 0), weights, 0),
            np.where(covered & (alleles != 1), weights, 0),
        ]
    )
    # side membership of every read under every partition mask
    masks = (np.arange(1 << R)[:, None] >> np.arange(R)[None, :]) & 1  # (2^R, R)
    side = np.stack([1 - masks, masks]).astype(np.int64)  # (2, 2^R, R)
    # cost_sa[side, allele, partition, position]
    cost_sa = np.einsum("smr,arp->samp", side, flip)
    # per-assignment cost: side 0 gets allele a0, side 1 gets a1
    assign_costs = (
        cost_sa[0, assignments[:, 0]] + cost_sa[1, assignments[:, 1]]
    )  # (nA, 2^R, P)
    totals = assign_costs.min(axis=0).sum(axis=1)  # (2^R,)

    best_cost = int(totals.min())
    best_partition = int(np.argmin(totals))
    solution_count = int((totals == best_cost).sum())
    # every partition pairs with its complement at the same cost
    assert solution_count % 2 == 0

    _, hap = _haplotype_with_ties(assign_costs[:, best_partition, :], assignments)
    return (
        best_cost,
        [(best_partition >> r) & 1 for r in range(R)],
        solution_count // 2,
        "".join(str(a) for a in hap[:, 0]),
        "".join(str(a) for a in hap[:, 1]),
    )


def canonic_index_to_biallelic_gt(num_alt, ploidy=2):
    """Numeric VCF genotype index + ploidy -> biallelic Genotype object."""
    if 0 <= num_alt <= ploidy:
        return Genotype([0] * (ploidy - num_alt) + [1] * num_alt)
    return Genotype([])


def canonic_index_list_to_biallelic_gt_list(list_int, ploidy=2):
    """List version of canonic_index_to_biallelic_gt."""
    return [canonic_index_to_biallelic_gt(i, ploidy) for i in list_int]
