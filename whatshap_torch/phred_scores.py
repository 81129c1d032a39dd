"""
Build a kmerald cost table from ``whatshap learn`` output.

``learn`` emits per-chromosome TSV files of (chrom, ref-kmer, read-kmer,
count) rows.  This script converts them into phred-scaled alignment costs
for the kmerald allele-detection mode: for every reference k-mer ``r`` the
probability of observing read k-mer ``q`` is

    P(q | r) = n(r, q) / D(r),
    D(r)     = N(r) + eps * (4^k - U(r)),

where ``n(r, q)`` is the summed pair count, ``N(r)`` the total count for
``r``, ``U(r)`` the number of distinct read k-mers seen with ``r`` and
``eps`` a pseudocount for the 4^k - U(r) unobserved pairings.  Costs are
``-10*log10(P)``.  Each reference k-mer additionally gets one sentinel row
(read-kmer column ``-5``) holding the unobserved-pair cost, which the
aligner uses as the default substitution cost.

Covers the role of the reference's ``whatshap/phred_scores.py`` (same
table semantics; grouped row layout and streaming aggregation are our own).
"""

import argparse
import math
from collections import defaultdict
from pathlib import Path

# Column indices of the `learn` TSV output: chrom, ref kmer, read kmer, count.
_REF_COL, _READ_COL, _COUNT_COL = 1, 2, 3

# Sentinel "read kmer" key marking the default (unobserved-pair) cost row.
UNSEEN_KEY = -5


def aggregate_pair_counts(count_dir):
    """Sum (ref-kmer -> read-kmer -> count) over every ``*.txt`` file in
    ``count_dir`` (one file per chromosome, as written by ``learn``)."""
    table = defaultdict(lambda: defaultdict(int))
    for part in sorted(Path(count_dir).glob("*.txt")):
        with open(part) as handle:
            for raw in handle:
                fields = raw.rstrip("\n").split("\t")
                if len(fields) <= _COUNT_COL:
                    continue
                table[fields[_REF_COL]][fields[_READ_COL]] += int(fields[_COUNT_COL])
    return table


def cost_rows(table, epsilon, kmer_size):
    """Yield (ref-kmer, read-kmer-or-sentinel, phred cost) rows.

    Rows are grouped per reference k-mer, sentinel first; within a group the
    observed read k-mers are emitted in sorted order.  (The table is loaded
    into a dict by the aligner, so row order is presentation only.)
    """
    space = 4.0 ** int(kmer_size)
    eps = float(epsilon)
    for ref in sorted(table):
        observed = table[ref]
        denominator = sum(observed.values()) + eps * (space - len(observed))
        yield ref, UNSEEN_KEY, -10.0 * math.log10(eps / denominator)
        for read in sorted(observed):
            yield ref, read, -10.0 * math.log10(observed[read] / denominator)


def phred(inputfile, outputfile, epsilon_value, kmer_size):
    """Aggregate counts under ``inputfile`` and write the cost table."""
    table = aggregate_pair_counts(inputfile)
    with open(outputfile, "w") as out:
        for ref, read, cost in cost_rows(table, epsilon_value, kmer_size):
            print(ref, read, cost, sep="\t", file=out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "-i", "--inputfile", required=True,
        help="Directory of per-chromosome kmer pair counts from `learn`",
    )
    parser.add_argument(
        "-o", "--outputfile", required=True,
        help="Output TSV of phred-scaled kmer substitution costs",
    )
    parser.add_argument(
        "-e", "--epsilon_value", required=True,
        help="Pseudocount assigned to unobserved kmer pairs",
    )
    parser.add_argument("-k", "--kmer_size", required=True, help="kmer length")
    args = parser.parse_args(argv)
    phred(args.inputfile, args.outputfile, args.epsilon_value, args.kmer_size)


if __name__ == "__main__":
    main()
