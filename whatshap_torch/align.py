"""
Alignment kernels for allele detection: banded unit-cost edit distance,
Gotoh affine-gap edit distance with per-position mismatch costs, k-mer
alignment with learned substitution costs.

Semantics parity with whatshap/align.pyx (and with whatshap_tpu.align, of
which this is a copy).  The edit distances run in C++ (csrc/host/alignlib.cpp,
hostlib.alignlib); the Python implementations are their plain versions.
"""

import collections
from typing import Dict, List, Sequence

INT_MAX = 2147483647

from . import hostlib


def _as_bytes(s) -> bytes:
    return s.encode() if isinstance(s, str) else s


def edit_distance(s, t, maxdiff: int = -1) -> int:
    """Edit distance between strings s and t (insertions + deletions +
    mismatches).  With maxdiff >= 0, performs banded alignment: the true
    distance is returned iff it is <= maxdiff; otherwise some value greater
    than maxdiff."""
    sv = _as_bytes(s)
    tv = _as_bytes(t)
    _native = hostlib.alignlib
    if _native is not None:
        return _native.edit_distance(sv, tv, maxdiff)
    return _edit_distance_py(sv, tv, maxdiff)


def _edit_distance_py(sv: bytes, tv: bytes, maxdiff: int = -1) -> int:
    m = len(sv)
    n = len(tv)
    e = maxdiff
    if e != -1 and abs(m - n) > e:
        return abs(m - n)

    # Skip identical prefixes
    start = 0
    while m > 0 and n > 0 and sv[start] == tv[start]:
        start += 1
        m -= 1
        n -= 1
    sv = sv[start:]
    tv = tv[start:]
    # Skip identical suffixes
    while m > 0 and n > 0 and sv[m - 1] == tv[n - 1]:
        m -= 1
        n -= 1

    costs = list(range(m + 1))
    if e == -1:
        for j in range(1, n + 1):
            prev = costs[0]
            costs[0] += 1
            tj = tv[j - 1]
            for i in range(1, m + 1):
                match = 1 if sv[i - 1] == tj else 0
                c = min(prev + 1 - match, costs[i] + 1, costs[i - 1] + 1)
                prev = costs[i]
                costs[i] = c
    else:
        smallest = 0
        for j in range(1, n + 1):
            stop = min(j + e + 1, m + 1)
            if j <= e:
                prev = costs[0]
                costs[0] += 1
                smallest = costs[0]
                start_i = 1
            else:
                start_i = j - e
                prev = costs[start_i - 1]
                smallest = maxdiff + 1
            tj = tv[j - 1]
            for i in range(start_i, stop):
                match = 1 if sv[i - 1] == tj else 0
                c = min(prev + 1 - match, costs[i] + 1, costs[i - 1] + 1)
                prev = costs[i]
                costs[i] = c
                smallest = min(smallest, c)
            if smallest > maxdiff:
                break
        if smallest > maxdiff:
            return smallest
    return costs[m]


def _gap_cost(length: int, gap_start: int, gap_ext: int) -> int:
    return gap_start + (length - 1) * gap_ext


def edit_distance_affine_gap(
    query, ref, mismatch_cost: Sequence[int], gap_start: int = 1, gap_extend: int = 1
) -> int:
    """Gotoh affine-gap edit distance; mismatch_cost gives per-query-position
    substitution costs (whatshap/align.pyx:114-196)."""
    assert len(query) == len(mismatch_cost)
    sv = _as_bytes(query)
    tv = _as_bytes(ref)
    _native = hostlib.alignlib
    if _native is not None:
        return _native.edit_distance_affine_gap(
            sv, tv, list(mismatch_cost), gap_start, gap_extend
        )
    return _edit_distance_affine_gap_py(sv, tv, mismatch_cost, gap_start, gap_extend)


def _edit_distance_affine_gap_py(sv, tv, mismatch_cost, gap_start, gap_extend):
    m = len(sv)
    n = len(tv)
    match_cost = 0
    len_p = 0
    # Skip identical prefixes
    while m > 0 and n > 0 and sv[len_p] == tv[len_p]:
        len_p += 1
        m -= 1
        n -= 1
    sv = sv[len_p:]
    tv = tv[len_p:]
    # Skip identical suffixes
    while m > 0 and n > 0 and sv[m - 1] == tv[n - 1]:
        m -= 1
        n -= 1

    a = [0.0] + [INT_MAX] * m
    b = [0.0] + [float(_gap_cost(i, gap_start, gap_extend)) for i in range(1, m + 1)]
    c = [0.0] + [INT_MAX] * m

    for j in range(1, n + 1):
        prev_a, prev_b, prev_c = a[0], b[0], c[0]
        a[0] = INT_MAX
        b[0] = INT_MAX
        c[0] = float(_gap_cost(j, gap_start, gap_extend))
        tj = tv[j - 1]
        for i in range(1, m + 1):
            m_c = mismatch_cost[i - 1 + len_p]
            if sv[i - 1] == tj:
                m_c = match_cost
            c_a = min(prev_a, prev_b, prev_c) + m_c
            c_b = min(a[i - 1] + gap_start, b[i - 1] + gap_extend, c[i - 1] + gap_start)
            c_c = min(a[i] + gap_start, b[i] + gap_start, c[i] + gap_extend)
            prev_a, prev_b, prev_c = a[i], b[i], c[i]
            a[i] = c_a
            b[i] = c_b
            c[i] = c_c
    return int(min(a[m], b[m], c[m]))


def kmer_align(seq1, seq2, costs: Dict, gap_penalty: float) -> float:
    """Needleman-Wunsch over k-mer sequences with a learned substitution cost
    table (whatshap/align.pyx:199-246)."""
    m = len(seq1)
    n = len(seq2)
    if list(seq1) == list(seq2):
        return 0

    seq1 = list(seq1)
    seq2 = list(seq2)
    x = 0
    while x < m and x < n and seq1[x] == seq2[x]:
        x += 1
    while m > x and n > x and seq1[m - 1] == seq2[n - 1]:
        m -= 1
        n -= 1
    m -= x
    n -= x

    score = [[0.0] * (n + 1) for _ in range(m + 1)]
    for i in range(m + 1):
        score[i][0] = gap_penalty * i
    for j in range(n + 1):
        score[0][j] = gap_penalty * j
    for i in range(1, m + 1):
        row = score[i]
        prev_row = score[i - 1]
        c1 = seq1[i - 1 + x]
        for j in range(1, n + 1):
            c2 = seq2[j - 1 + x]
            if c1 == c2:
                match = prev_row[j - 1]
            else:
                if (c1, c2) in costs:
                    mismatching = float(costs[(c1, c2)])
                elif (c1, -5) in costs:
                    mismatching = float(costs[(c1, -5)])
                else:
                    mismatching = float("inf")
                match = prev_row[j - 1] + mismatching
            delete = prev_row[j] + gap_penalty
            insert = row[j - 1] + gap_penalty
            row[j] = min(match, delete, insert)
    return score[m][n]


def enumerate_all_kmers(reference: bytes, k: int) -> collections.deque:
    """2-bit rolling hash enumeration of all k-mers
    (whatshap/align.pyx:249-271)."""
    A, C, G, T = ord("A"), ord("C"), ord("G"), ord("T")
    h = 0
    mask = (1 << (2 * k)) - 1
    kmer_list: collections.deque = collections.deque()
    for i, c in enumerate(reference):
        if c == A:
            h = ((h << 2) | 0) & mask
        elif c == C:
            h = ((h << 2) | 1) & mask
        elif c == G:
            h = ((h << 2) | 2) & mask
        elif c == T:
            h = ((h << 2) | 3) & mask
        if i >= k - 1 and h != 0:
            kmer_list.append(h)
    return kmer_list
