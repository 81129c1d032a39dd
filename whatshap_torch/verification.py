"""
Self-check oracle for DP results: independently recompute the MEC score
implied by the solver's reported superreads/partitioning and require it to
equal the solver's reported optimum (counterpart of the reference's
whatshap/verification.py, used by tests and debugging sessions).
"""

EQUAL_SCORES = 3


def verify_mec_score_and_partitioning(dp_table, reads) -> None:
    """Recompute the MEC score from ``dp_table``'s own superreads and check
    it against ``get_optimal_cost()``; also check that every read with a
    cost preference sits on its cheaper haplotype (modulo one global
    haplotype swap, which the DP is free to choose)."""
    superread_sets, _ = dp_table.get_super_reads()
    assert len(superread_sets) == 1, "single-individual verification only"
    pair = superread_sets[0]
    assert len(pair) == 2
    assert len(pair[0]) == len(pair[1])

    # Haplotype alleles by position; EQUAL_SCORES (either allele ties)
    # resolves to haplotype h's default so the two haplotypes stay
    # complementary at tied sites.
    hap_allele = [{}, {}]
    for h in (0, 1):
        for v in pair[h]:
            hap_allele[h][v.position] = h if v.allele == EQUAL_SCORES else v.allele

    # Per-read disagreement cost against each haplotype.
    def read_costs(read):
        c0 = c1 = 0
        for v in read:
            if v.position not in hap_allele[0]:
                continue
            if hap_allele[0][v.position] != v.allele:
                c0 += v.quality
            if hap_allele[1][v.position] != v.allele:
                c1 += v.quality
        return c0, c1

    partitioning = dp_table.get_optimal_partitioning()
    total = 0
    # The DP may label haplotypes in either order; infer the orientation
    # from the first read that strictly prefers one side.
    orientation = None
    for idx, read in enumerate(reads):
        c0, c1 = read_costs(read)
        total += min(c0, c1)
        if c0 == c1:
            continue
        preferred = 0 if c0 < c1 else 1
        assigned = partitioning[idx]
        if orientation is None:
            orientation = preferred == assigned
        else:
            assert (preferred == assigned) == orientation, (
                f"read {idx} assigned to haplotype {assigned} but strictly "
                f"prefers {preferred} (costs {c0}/{c1})"
            )

    reported = dp_table.get_optimal_cost()
    print(f"Expected MEC score: {total}, obtained MEC score: {reported}")
    assert total == reported
