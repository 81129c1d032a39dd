"""
Debug/development visualizations for `polyphase` and `polyphasegenetic`
(functional counterpart of whatshap/polyphase/plots.py; matplotlib is
imported lazily inside the plotting functions so it never becomes a hard
dependency).

The plots are diagnostic aids, not data products: this module renders the
same information (read clustering as colored segments over variant space,
haplotype threading over cluster coverage) in a compact form.
"""

import logging
from collections import defaultdict
from copy import deepcopy
from itertools import combinations

from . import get_coverage
from .solver import AlleleMatrix

logger = logging.getLogger(__name__)

#: read-name suffix -> global haplotype id for the HGSVC trio convention
#: used by simulated readsets (reference: polyphase/plots.py parse_haplotype)
_TRIO_SAMPLE_BASE = {"HG00514": 0, "NA19240": 2, "HG00733": 4}


def parse_haplotype(name):
    """Haplotype id 0..5 encoded in a simulated read name of the form
    ``..._<SAMPLE>_HAP{1,2}``, or -1 when the name has no such suffix."""
    parts = name.split("_")
    if len(parts) < 2 or parts[-1] not in ("HAP1", "HAP2"):
        return -1
    base = _TRIO_SAMPLE_BASE.get(parts[-2])
    if base is None:
        return -1
    return base + (parts[-1] == "HAP2")


def get_phase(readset, var_table):
    """Phase vectors (one list of alleles per haplotype) of the first sample
    of ``var_table``, restricted to the readset's positions; None when the
    table carries no phasing."""
    table = deepcopy(var_table)
    table.subset_rows_by_position(readset.get_positions())
    try:
        rows = [variant.phase for variant in table.phases[0]]
    except AttributeError:
        return None
    if not rows:
        return None
    return [[row[h] for row in rows] for h in range(len(rows[0]))]


def relative_hamming_dist(seq1, seq2):
    """Fraction of mismatching entries; -1 on length mismatch."""
    if len(seq1) != len(seq2):
        return -1
    return sum(a != b for a, b in zip(seq1, seq2)) / len(seq1)


def haplodist(h1, h2, intervals):
    """Windowed relative Hamming distance between two phase vectors: entry i
    compares the slices covered by ``intervals[i] = (left, right)``."""
    if len(h1) != len(h2):
        return -1
    n = len(h1)
    return [
        relative_hamming_dist(h1[lo : min(n, hi + 1)], h2[lo : min(n, hi + 1)])
        for lo, hi in intervals
    ]


def diff_ratio(ratio):
    """Fold a ratio in (0, 1) onto its reciprocal so 'x-fold different'
    reads the same on both sides of 1."""
    if ratio and 0.0 < ratio < 1.0:
        return 1.0 / ratio
    return ratio


def create_histogram(path, same, diff, steps, dim, x_label, title, name1="same", name2="diff"):
    """Overlayed frequency histogram of two samples over ``steps`` equal bins
    spanning ``dim = (lo, hi)``."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    lo, hi = dim
    bins = [lo + i * (hi - lo) / steps for i in range(steps + 1)]
    fig = plt.figure()
    plt.hist(same, bins, alpha=0.5, label=name1)
    if len(diff) > 0:
        plt.hist(diff, bins, alpha=0.5, label=name2)
    plt.title(title)
    plt.xlabel(x_label)
    plt.ylabel("Frequency")
    plt.legend(loc="upper center")
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)


def plot_haplotype_dissimilarity(
    legend_handles, y_offset, y_margin, index, rev_index, readset, var_table, genome_space=False
):
    """Windowed dissimilarity curves between every pair of true haplotypes,
    drawn into the currently open matplotlib figure (companion of
    draw_clustering; reference: polyphase/plots.py plot_haplotype_dissimilarity).

    ``rev_index`` maps variant index -> genome position; each position's
    window spans all variants within +-(read length / 6) base pairs.
    """
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    phase_vectors = get_phase(readset, var_table)
    if not phase_vectors:
        return
    num_vars = len(readset.get_positions())
    x_min = min(readset.get_positions()) if genome_space else 0
    x_max = max(readset.get_positions()) if genome_space else num_vars
    padding = int(avg_readlength(readset) // 6)

    # per-position averaging window, in variant-index space
    intervals = []
    for i in range(num_vars):
        lo = hi = i
        pos = rev_index[i]
        while lo > 0 and rev_index[lo - 1] >= pos - padding:
            lo -= 1
        while hi + 1 < num_vars and rev_index[hi + 1] <= pos + padding:
            hi += 1
        intervals.append((lo, hi))

    chunk = 24  # alternate segment colors so individual windows stay visible
    for i, j in combinations(range(len(phase_vectors)), 2):
        y_offset -= 104 + y_margin
        pair_colors = [f"C{i}", f"C{j}"]
        for c, label in zip(pair_colors, (i, j)):
            if c not in legend_handles:
                legend_handles[c] = mpatches.Patch(color=c, label=label)
        dist = haplodist(phase_vectors[i], phase_vectors[j], intervals)
        ys = [y_offset + 2 + 100 * v for v in dist]
        plt.hlines(y=y_offset, xmin=x_min, xmax=x_max, color="black", lw=1)
        plt.hlines(y=y_offset + 104, xmin=x_min, xmax=x_max, color="black", lw=1)
        for k in range(0, num_vars, chunk):
            end = min(num_vars, k + chunk + 1)
            xs = rev_index[k:end] if genome_space else list(range(k, end))
            plt.plot(xs, ys[k:end], lw=1, color=pair_colors[(k // chunk) % 2])


def draw_plots(
    readset,
    result,
    cut_positions,
    phasable_variant_table,
    plot_clusters,
    plot_threading,
    output,
):
    logger.info("Generating plots ...")
    if plot_clusters:
        draw_clustering(
            readset,
            result.clustering,
            phasable_variant_table,
            output + ".clusters.pdf",
            genome_space=False,
        )
    if plot_threading:
        allele_matrix = AlleleMatrix(readset)
        coverage = get_coverage(allele_matrix, result.clustering)
        del allele_matrix
        draw_threading(
            readset,
            result.clustering,
            coverage,
            result.threads,
            cut_positions,
            result.haplotypes,
            phasable_variant_table,
            output + ".threading.pdf",
        )


def avg_readlength(readset):
    """Average read length in base pairs."""
    if len(readset) > 0:
        return sum(read[-1].position - read[0].position for read in readset) / len(readset)
    return 0


def draw_clustering(readset, clustering, var_table, path, genome_space=False):
    """One horizontal segment per read, colored by cluster, x = variant index
    (or genome position with genome_space)."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    pos_index = {pos: i for i, pos in enumerate(readset.get_positions())}
    num_reads = sum(len(c) for c in clustering)
    with PdfPages(path) as pdf:
        fig = plt.figure(figsize=(16, max(4, num_reads / 40)), dpi=100)
        y = 0
        cmap = plt.get_cmap("tab20")
        for cid, cluster in enumerate(clustering):
            color = cmap(cid % 20)
            for rid in sorted(cluster, key=lambda r: readset[r][0].position):
                read = readset[rid]
                if genome_space:
                    x0, x1 = read[0].position, read[-1].position
                else:
                    x0 = pos_index[read[0].position]
                    x1 = pos_index[read[-1].position]
                plt.hlines(y, x0, x1, colors=[color], linewidth=1)
                y += 1
        plt.xlabel("genome position" if genome_space else "variant index")
        plt.ylabel("reads (grouped by cluster)")
        plt.title("Read clustering")
        pdf.savefig(fig)
        plt.close(fig)
    logger.info(f"Wrote clustering plot to {path}")


def draw_threading(
    readset, clustering, coverage, paths, cut_positions, haplotypes, var_table, path
):
    """Cluster coverage as background band heights, threaded haplotype paths
    as lines through the clusters, cut positions as vertical markers."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    assert len(paths) > 0
    ploidy = len(paths[0])
    num_vars = len(paths)

    with PdfPages(path) as pdf:
        fig = plt.figure(figsize=(16, 8), dpi=100)
        cmap = plt.get_cmap("tab10")
        # background: relative coverage of each cluster per position
        present = sorted({cid for pos in range(num_vars) for cid in coverage[pos]})
        cluster_y = {cid: i for i, cid in enumerate(present)}
        for pos in range(num_vars):
            for cid, cov in coverage[pos].items():
                plt.vlines(
                    pos,
                    cluster_y[cid] - cov / 2,
                    cluster_y[cid] + cov / 2,
                    colors="lightgray",
                )
        # threads
        for h in range(ploidy):
            ys = [cluster_y.get(paths[pos][h], -1) + (h - ploidy / 2) * 0.08 for pos in range(num_vars)]
            plt.plot(range(num_vars), ys, color=cmap(h % 10), linewidth=1.2, label=f"hap {h}")
        for cut in cut_positions:
            plt.axvline(cut, color="red", linestyle="--", linewidth=0.8)
        plt.xlabel("variant index")
        plt.ylabel("cluster")
        plt.title("Haplotype threading")
        plt.legend(loc="upper right", fontsize="small")
        pdf.savefig(fig)
        plt.close(fig)
    logger.info(f"Wrote threading plot to {path}")


def draw_genetic_clustering(clustering, num_vars, path):
    """Variant-cluster membership matrix for the genetic polyphase."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    with PdfPages(path) as pdf:
        fig = plt.figure(figsize=(16, max(4, len(clustering) / 8)), dpi=100)
        for cid, cluster in enumerate(clustering):
            plt.scatter(list(cluster), [cid] * len(cluster), s=2)
        plt.xlabel("variant index")
        plt.ylabel("cluster id")
        plt.title("Genetic variant clustering")
        pdf.savefig(fig)
        plt.close(fig)


def draw_genetic_clustering_arrangement(clustering, arrangement, num_vars, path):
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    with PdfPages(path) as pdf:
        fig = plt.figure(figsize=(16, max(4, len(arrangement))), dpi=100)
        for hap, clusters in enumerate(arrangement):
            for cid in clusters:
                plt.scatter(list(clustering[cid]), [hap] * len(clustering[cid]), s=2)
        plt.xlabel("variant index")
        plt.ylabel("haplotype")
        plt.title("Cluster arrangement")
        pdf.savefig(fig)
        plt.close(fig)


def draw_phase_comparison(
    haplotypes,
    phased_positions,
    sample_cov,
    co_parent_cov,
    progeny_cov,
    ground_truth_table,
    path,
):
    """Phasing-vs-ground-truth diagnostic figure (reference:
    polyphase/plots.py draw_phase_comparison, rendered compactly):

    * top: progeny/sample and co-parent/sample coverage-ratio curves,
      clipped at 3x their median so spikes don't flatten the rest;
    * middle: the ground-truth alleles as a heat strip (one row per
      haplotype) with the computed haplotype-to-truth assignment drawn
      as colored lines through the rows;
    * bottom: per-position switch (blue, below axis) and flip (orange)
      error bars from the polyploid switch/flip DP.
    """
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    from ..cli.compare import compute_switch_flips_poly_bt

    ploidy = len(haplotypes)
    assert ploidy >= 2
    num_vars = len(haplotypes[0])

    # truth phase vectors, restricted to positions we actually phased
    truth_rows = []
    truth_positions = []
    for i, call in enumerate(ground_truth_table.phases[0]):
        if call is not None:
            truth_rows.append(call.phase)
            truth_positions.append(ground_truth_table.variants[i].position)
    if not truth_rows:
        logger.warning("Ground truth table contains no phased variants; skipping comparison plot")
        return
    truth_pos_set = set(truth_positions)
    compared_idx = [i for i in range(num_vars) if phased_positions[i] in truth_pos_set]
    if not compared_idx:
        logger.warning("No overlap between phased and truth positions; skipping comparison plot")
        return
    pos_to_truth = {p: r for p, r in zip(truth_positions, truth_rows)}
    truth_block = [
        [pos_to_truth[phased_positions[i]][h] for i in compared_idx] for h in range(ploidy)
    ]
    phase_block = [[haplotypes[h][i] for i in compared_idx] for h in range(ploidy)]

    _, switches_in_column, flips_in_column, poswise_config = compute_switch_flips_poly_bt(
        truth_block,
        phase_block,
        report_error_positions=True,
        switch_cost=1 + 1 / (num_vars * ploidy),
    )

    n = len(compared_idx)
    fig, (ax_cov, ax_hap, ax_err) = plt.subplots(
        3,
        1,
        sharex=True,
        figsize=(max(8, min(200, n * 0.4)), 2.5 + ploidy),
        dpi=100,
        gridspec_kw={"height_ratios": [1, ploidy, 1]},
    )

    # coverage ratios (vs the phased sample), clipped at 3x median
    for cov, color, label in (
        (progeny_cov, "tab:purple", "progeny/sample"),
        (co_parent_cov, "tab:cyan", "co-parent/sample"),
    ):
        ratio = [c / s if s > 0 else 0.0 for c, s in zip(cov, sample_cov)]
        kept = [ratio[i] for i in compared_idx]
        med = sorted(kept)[len(kept) // 2]
        cap = 3 * med if med > 0 else max(kept) or 1.0
        ax_cov.plot(range(n), [min(r, cap) for r in kept], color=color, lw=1, label=label)
        ax_cov.axhline(med, color=color, lw=0.5, ls="--")
    ax_cov.set_ylabel("cov ratio")
    ax_cov.legend(loc="upper right", fontsize="x-small")

    # truth alleles as background heat, assignment as lines
    ax_hap.imshow(
        truth_block,
        aspect="auto",
        interpolation="nearest",
        cmap="Greys",
        extent=(-0.5, n - 0.5, ploidy - 0.5, -0.5),
    )
    cmap = plt.get_cmap("tab10")
    for h in range(ploidy):
        ys = [poswise_config[i][h] + (h - ploidy / 2) * 0.06 for i in range(n)]
        ax_hap.plot(range(n), ys, color=cmap(h % 10), lw=1.4, label=f"hap {h}")
    ax_hap.set_ylabel("truth haplotype")
    ax_hap.legend(loc="upper right", fontsize="x-small")

    # switch/flip errors per compared position
    ax_err.bar(range(n), [-s for s in switches_in_column], color="tab:blue", label="switches")
    ax_err.bar(range(n), [-len(f) for f in flips_in_column], color="tab:orange",
               alpha=0.7, label="flips")
    ax_err.set_ylabel("errors")
    ax_err.set_xlabel("compared variant index")
    ax_err.legend(loc="lower right", fontsize="x-small")

    fig.suptitle("Phasing vs ground truth")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    logger.info(f"Wrote phase comparison plot to {path}")


def create_genetic_plots(
    output,
    chromosome,
    sample,
    ground_truth_file,
    varinfo,
    clustering,
    haplo_skeletons,
    haplotypes,
    phased_positions,
    parent_coverage,
    co_parent_coverage,
    progeny_coverage,
    param,
):
    """Diagnostics for `polyphasegenetic --plot`: coverage-distribution
    histogram, variant clustering, cluster arrangement, and (when a ground
    truth VCF is supplied) the phasing-comparison figure (signature matches
    the reference's cli/polyphasegenetic.py call site)."""
    base = output if isinstance(output, str) else getattr(output, "name", "polyphasegenetic")
    prefix = f"{base}.{chromosome}.{sample}"
    num_vars = len(varinfo)

    def _window_avg(values, pad, scale=1):
        return [
            scale
            * sum(values[max(0, i - pad) : i + pad + 1])
            / (min(i + pad + 1, len(values)) - max(0, i - pad))
            for i in range(len(values))
        ]

    if parent_coverage and progeny_coverage:
        logger.info("Plotting coverage distribution ...")
        # the parent is sequenced ~10x deeper per haplotype in the intended
        # protocol, hence the 10x scale on its curve
        create_histogram(
            prefix + ".coverage-dist.pdf",
            _window_avg(parent_coverage, 10, scale=10),
            _window_avg(progeny_coverage, 10),
            400,
            [0, max(10 * max(parent_coverage), max(progeny_coverage))],
            "Coverage",
            "Coverage distribution",
            name1=sample,
            name2="progeny",
        )

    logger.info("Plotting clustering ...")
    node_vars = [[varinfo.node_to_variant(n) for n in clust] for clust in clustering]
    draw_genetic_clustering(node_vars, num_vars, prefix + ".clusters.pdf")
    if haplo_skeletons:
        logger.info("Plotting cluster arrangements ...")
        draw_genetic_clustering_arrangement(
            node_vars, haplo_skeletons, num_vars, prefix + ".arrangement.pdf"
        )

    if ground_truth_file and haplotypes and phased_positions:
        logger.info("Plotting phasing comparison ...")
        from ..vcf import VcfReader

        reader = VcfReader(
            ground_truth_file,
            only_snvs=False,
            phases=True,
            genotype_likelihoods=False,
            ploidy=param.ploidy,
            mav=True,
            allele_depth=False,
        )
        regions = [(p, p + 1) for p in phased_positions]
        truth_table = reader.fetch_regions(chromosome, regions)
        draw_phase_comparison(
            haplotypes,
            phased_positions,
            parent_coverage,
            co_parent_coverage,
            progeny_coverage,
            truth_table,
            prefix + ".comparison.pdf",
        )
