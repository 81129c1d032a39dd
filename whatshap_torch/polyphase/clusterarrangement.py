"""
Assign marker-allele clusters to haplotypes for genetic polyploid phasing
(behavior parity with whatshap/polyphase/clusterarrangement.py).

The problem is weighted interval scheduling on `ploidy` machines: each
non-singleton cluster spans an interval of variants (plus padding), at most
one cluster may occupy a haplotype at any position, and the total number of
covered variants is maximized. The reference solves an ILP via PuLP; when
PuLP is unavailable we solve the same optimum exactly with a min-cost flow
over the position chain (the LP relaxation of this interval model is
integral), then color the selected intervals onto haplotypes greedily.
"""

import logging

from . import get_ilp_solver

logger = logging.getLogger(__name__)


def arrange_clusters(clustering, padding, ploidy):
    # non-singleton clusters with their padded interval and worth
    filtered_to_real = [i for i, clust in enumerate(clustering) if len(clust) > 1]
    c_start, c_end, c_worth = [], [], []
    for i in filtered_to_real:
        members = clustering[i]
        c_worth.append(len(members))
        c_start.append(max(0, min(members) - padding))
        c_end.append(max(members) + padding)
    n = max(c_end)
    c = len(filtered_to_real)

    try:
        from pulp import LpInteger, LpMaximize, LpProblem, LpVariable, value
    except ImportError:
        return _arrange_clusters_flow(
            clustering, filtered_to_real, c_start, c_end, c_worth, n, c, ploidy
        )

    model = LpProblem(f"Cluster_Arrangement_c{c}_n{n}_p{ploidy}", LpMaximize)
    # x[i][j] = 1 iff cluster j is put on haplotype i
    x = [
        [LpVariable(f"x_{i}_{j}", 0, 1, LpInteger) for j in range(c)] for i in range(ploidy)
    ]
    # maximize covered variants
    model += sum(c_worth[j] * x[i][j] for j in range(c) for i in range(ploidy))
    # each cluster on at most one haplotype
    for j in range(c):
        model += sum(x[i][j] for i in range(ploidy)) <= 1
    # overlapping clusters may not share a haplotype (one constraint per
    # distinct overlap set)
    previous_overlap = []
    for pos in range(n):
        overlap = sorted(j for j in range(c) if c_start[j] <= pos <= c_end[j])
        if overlap != previous_overlap:
            for i in range(ploidy):
                model += sum(x[i][j] for j in overlap) <= 1
            previous_overlap = overlap

    model.solve(get_ilp_solver())

    logger.info(
        "Arranged %i variants out of a total of %i",
        int(value(model.objective)),
        sum(len(clust) for clust in clustering),
    )
    selected = []
    for i in range(ploidy):
        selected.append([filtered_to_real[j] for j in range(c) if x[i][j].varValue > 0.999])
        logger.info("   h%i: %s", i, selected[-1])
    return selected


def _arrange_clusters_flow(
    clustering, filtered_to_real, c_start, c_end, c_worth, n, c, ploidy
):
    """Exact replacement for the arrangement ILP: min-cost flow of `ploidy`
    units along the position chain, each cluster an arc of capacity 1 with
    profit c_worth; selected (non-overlapping per unit of flow) intervals
    are then greedily colored onto haplotypes."""
    import networkx as nx

    # compress positions to interval endpoints to keep the graph small
    points = sorted({0, n + 1} | set(c_start) | {e + 1 for e in c_end})

    G = nx.DiGraph()
    for a, b in zip(points[:-1], points[1:]):
        G.add_edge(("p", a), ("p", b), capacity=ploidy, weight=0)
    for j in range(c):
        # occupancy interval is [c_start, c_end] inclusive -> exits at end+1;
        # an intermediate node per cluster keeps parallel intervals distinct
        G.add_edge(("p", c_start[j]), ("c", j), capacity=1, weight=-c_worth[j])
        G.add_edge(("c", j), ("p", c_end[j] + 1), capacity=1, weight=0)

    flow = nx.max_flow_min_cost(G, ("p", points[0]), ("p", points[-1]))

    chosen = [j for j in range(c) if flow.get(("p", c_start[j]), {}).get(("c", j), 0) >= 1]

    # greedy interval coloring onto ploidy haplotypes
    selected = [[] for _ in range(ploidy)]
    hap_free_at = [0] * ploidy
    total_worth = 0
    for j in sorted(chosen, key=lambda j: c_start[j]):
        for i in range(ploidy):
            if hap_free_at[i] <= c_start[j]:
                selected[i].append(filtered_to_real[j])
                hap_free_at[i] = c_end[j] + 1
                total_worth += c_worth[j]
                break

    logger.info(
        "Arranged %i variants out of a total of %i",
        total_worth,
        sum([len(clust) for clust in clustering]),
    )
    for i in range(ploidy):
        logger.info("   h%i: %s", i, selected[i])
    return selected
