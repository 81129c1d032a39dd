"""
Read-pair similarity scoring for polyploid phasing.

Behavior parity with src/polyphase/readscoring.{h,cpp}: per-position
genotype likelihoods from allele depths, precomputed allele-pair likelihood
tables conditioned on genotype, and a log-likelihood-ratio score per
overlapping read pair (positive = likely same haplotype).
"""

import math
import struct
from typing import Dict, List, Sequence, Tuple

from ..core.genotype import Genotype
from .allelematrix import AlleleMatrix
from .mathutils import log_binom_pmf, log_multinom_pmf, binomial_coefficient
from .trianglesparse import TriangleSparseMatrix

_DBL_MAX = 1.7976931348623157e308
_U32_MASK = 0xFFFFFFFF

#: process-wide per-position LUT cache, keyed by
#: (allele-depth vector, ploidy, err, numAlleles) — see scoreReadset
_LUT_CACHE: Dict[Tuple, List[List[float]]] = {}


def _f32(v: float) -> float:
    return struct.unpack("f", struct.pack("f", v))[0]


def computeGenotypeLikelihoods(
    alleleDepth: Sequence[int], ploidy: int, err: float
) -> Dict[Genotype, float]:
    # readscoring.cpp:120-196
    gl: Dict[Genotype, float] = {}
    numAlleles = len(alleleDepth)
    numGenotypes = binomial_coefficient(ploidy + numAlleles - 1, numAlleles - 1)
    weight = 0.0
    lowest = 0.0
    alleles = [i for i in range(numAlleles) if alleleDepth[i] > 0]
    numExAlleles = len(alleles)

    for index in range(numGenotypes):
        g = Genotype.from_index(index, ploidy)
        gv = g.as_vector()
        if any(alleleDepth[a] == 0 for a in gv):
            continue
        if numExAlleles == 1:
            weight += 1
            gl[g] = 1
        elif numExAlleles == 2:
            fracAlt = float(index) / float(ploidy)
            l = log_binom_pmf(
                alleleDepth[alleles[0]] + alleleDepth[alleles[1]],
                alleleDepth[alleles[1]],
                (1 - fracAlt) * err + fracAlt * (1 - err),
            )
            lowest = min(lowest, l)
            gl[g] = l
        else:
            p = []
            n = []
            for a in range(numExAlleles):
                num = sum(1.0 for x in gv if x == alleles[a])
                freq = num / ploidy
                p.append(freq * (1 - err * (numExAlleles - 1)) + (1 - freq) * err)
                n.append(alleleDepth[alleles[a]])
            l = log_multinom_pmf(n, p)
            lowest = min(lowest, l)
            gl[g] = l

    # log-scaled values are exped after shifting by the lowest value
    underflow = False
    for g in list(gl):
        try:
            l = math.exp(gl[g] - lowest)
        except OverflowError:
            l = float("inf")
        gl[g] = l
        weight += l
        if not (l <= _DBL_MAX):
            underflow = True

    if underflow:
        return computeGenotypeLikelihoods([d // 2 for d in alleleDepth], ploidy, err)
    for g in list(gl):
        gl[g] = gl[g] / weight
    return gl


def _evaluate_genotype_likelihoods(gl: List[Dict[Genotype, float]]) -> float:
    # readscoring.cpp:107-118 (log of per-position max likelihood, summed)
    total = 0.0
    for column in gl:
        best = 0.0
        for v in column.values():
            if v > best:
                best = v
        total += math.log(best) if best > 0 else float("-inf")
    return total


def _estimate_allele_error_rate(am: AlleleMatrix, ploidy: int) -> float:
    # readscoring.cpp:85-105 (grid search over err in [0.01, 0.19]);
    # positions sharing an allele-depth vector share one GL computation per
    # grid point (pure function of the depths)
    depths_list = [tuple(am.getAlleleDepths(i)) for i in range(am.getNumPositions())]
    best_err = 0.0
    best_sum = float("-inf")
    err = 0.01
    while err < 0.2:
        cache: Dict[Tuple[int, ...], Dict[Genotype, float]] = {}
        gl = []
        for depths in depths_list:
            col = cache.get(depths)
            if col is None:
                col = computeGenotypeLikelihoods(list(depths), ploidy, err)
                cache[depths] = col
            gl.append(col)
        s = _evaluate_genotype_likelihoods(gl)
        if s > best_sum:
            best_sum = s
            best_err = err
        err += 0.01
    return best_err


def _compute_allele_pair_likelihoods(
    genos: List[Genotype], numAlleles: int, err: float
) -> Tuple[List[float], List[float]]:
    # readscoring.cpp:198-233: apls/apld[g][a1][a2] = P(a1,a2 | g, same/diff hap)
    numGenos = len(genos)
    apls = [0.0] * (numAlleles * numAlleles * numGenos)
    apld = [0.0] * (numAlleles * numAlleles * numGenos)
    gvs = [g.as_vector() for g in genos]
    for a1 in range(numAlleles):
        for a2 in range(a1, numAlleles):
            for gi in range(numGenos):
                i1 = numGenos * (numAlleles * a1 + a2) + gi
                i2 = numGenos * (numAlleles * a2 + a1) + gi
                lEqual = 0.0
                lDiff = 0.0
                gv = gvs[gi]
                for x1 in range(len(gv)):
                    l1 = (1 - err) if gv[x1] == a1 else err
                    for x2 in range(len(gv)):
                        l = l1 * ((1 - err) if gv[x2] == a2 else err)
                        if x1 == x2:
                            lEqual += l
                        else:
                            lDiff += l
                apls[i1] = apls[i2] = lEqual / len(gv)
                apld[i1] = apld[i2] = lDiff / (len(gv) * (len(gv) - 1))
    return apls, apld


def _compute_log_score_single_pos(
    allele1: int,
    allele2: int,
    numAlleles: int,
    gl_col: Dict[Genotype, float],
    gMap: Dict[Genotype, int],
    apls: List[float],
    apld: List[float],
) -> float:
    # readscoring.cpp:262-281
    same = 0.0
    diff = 0.0
    numGenos = len(gMap)
    base = numGenos * (allele1 * numAlleles + allele2)
    for g, p in gl_col.items():
        i = base + gMap[g]
        same += p * apls[i]
        diff += p * apld[i]
    if same * diff <= 0.0:
        return 0.0
    return _f32(math.log(same / diff))


def _single_pos_table(
    numAlleles: int,
    gl_col: Dict[Genotype, float],
    gMap: Dict[Genotype, int],
    apls: List[float],
    apld: List[float],
) -> List[List[float]]:
    """Per-position LUT of _compute_log_score_single_pos over all allele
    pairs — the value depends on the position only through gl_col, so
    computing it once per position (instead of once per read pair sharing
    it) preserves the exact float ops while removing the inner loop from
    the pair scoring."""
    return [
        [
            _compute_log_score_single_pos(a1, a2, numAlleles, gl_col, gMap, apls, apld)
            for a2 in range(numAlleles)
        ]
        for a1 in range(numAlleles)
    ]


def _compute_log_score_lut(
    read1, read2, luts, minOverlap: int
) -> float:
    # readscoring.cpp:235-260 (merge over sorted sparse rows), with the
    # per-position scores from the precomputed tables
    ov = 0
    logScore = 0.0
    k = 0
    l = 0
    n1 = len(read1)
    n2 = len(read2)
    while k < n1 and l < n2:
        p1 = read1[k][0]
        p2 = read2[l][0]
        if p1 == p2:
            logScore += luts[p1][read1[k][1]][read2[l][1]]
            ov += 1
            k += 1
            l += 1
        elif p1 < p2:
            k += 1
        else:
            l += 1
    if ov >= minOverlap:
        return _f32(logScore)
    return 0.0


class ReadScoring:
    def scoreReadset(
        self,
        result: TriangleSparseMatrix,
        am: AlleleMatrix,
        minOverlap: int,
        ploidy: int,
        err: float,
    ) -> None:
        # readscoring.cpp:17-83
        if ploidy < 2:
            print("Error: Ploidy < 2!")
            return

        if err == 0.0:
            err = _estimate_allele_error_rate(am, ploidy)

        # The per-position score LUT is a pure function of (allele-depth
        # vector, ploidy, err, numAlleles): the genotype likelihood column
        # is determined by the depths, and each apls/apld entry depends
        # only on its own genotype.  Depth vectors repeat heavily along a
        # chromosome AND across blocks, so the cache is process-wide.
        numAlleles = am.getMaxNumAllele()
        depths_list = [
            tuple(am.getAlleleDepths(i)) for i in range(am.getNumPositions())
        ]
        if len(_LUT_CACHE) > (1 << 16):
            _LUT_CACHE.clear()
        missing = []
        seen = set()
        for depths in depths_list:
            key = (depths, ploidy, err, numAlleles)
            if key not in _LUT_CACHE and key not in seen:
                seen.add(key)
                missing.append((key, depths))
        if missing:
            cols = [
                computeGenotypeLikelihoods(list(depths), ploidy, err)
                for _key, depths in missing
            ]
            occ = {}
            for col in cols:
                for g in col:
                    occ[g] = True
            occGenotypes = list(occ)
            gMap = {g: i for i, g in enumerate(occGenotypes)}
            apls, apld = _compute_allele_pair_likelihoods(occGenotypes, numAlleles, err)
            for (key, _depths), col in zip(missing, cols):
                _LUT_CACHE[key] = _single_pos_table(numAlleles, col, gMap, apls, apld)
        luts = [
            _LUT_CACHE[(depths, ploidy, err, numAlleles)] for depths in depths_list
        ]

        sortedReads = sorted(range(am.size()), key=am.getFirstPos)
        offset = _f32(-math.log(ploidy * (1.0 - 1.0 / ploidy)))
        reads_cache = [am.getRead(r) for r in range(am.size())]

        nans = self._score_pairs_native(
            result, am, sortedReads, reads_cache, luts, numAlleles, minOverlap, offset
        )
        if nans is None:
            nans = 0
            for i in range(am.size()):
                # uint32 arithmetic: lastPos - minOverlap + 1 may wrap
                terminal = (am.getLastPos(sortedReads[i]) - minOverlap + 1) & _U32_MASK
                read_i = reads_cache[sortedReads[i]]
                for j in range(i + 1, len(sortedReads)):
                    if am.getFirstPos(sortedReads[j]) > terminal:
                        break
                    score = _compute_log_score_lut(
                        read_i, reads_cache[sortedReads[j]], luts, minOverlap
                    )
                    if not math.isnan(score):
                        if score != 0.0:
                            result.set(sortedReads[i], sortedReads[j], score + offset)
                    else:
                        nans += 1
        if nans > 0:
            print(f"Warning: Found {nans} NaN scores during read scoring!")

    @staticmethod
    def _score_pairs_native(
        result, am, sortedReads, reads_cache, luts, numAlleles, minOverlap, offset
    ):
        """Pair loop in C++ (csrc/host/scorelib.cpp, built at first use):
        same merge, same f32 rounding points, same uint32 terminal wrap.
        Returns the NaN count, or None where hostlib.scorelib is None (the
        Python path)."""
        from ..hostlib import scorelib

        if scorelib is None:
            return None
        import numpy as np
        from itertools import chain

        n_reads = am.size()
        read_off = np.zeros(n_reads + 1, np.int32)
        read_off[1:] = np.cumsum([len(r) for r in reads_cache])
        flat = np.fromiter(
            chain.from_iterable(chain.from_iterable(reads_cache)),
            dtype=np.int32,
            count=int(read_off[-1]) * 2,
        ).reshape(-1, 2)
        read_pos = np.ascontiguousarray(flat[:, 0])
        read_allele = np.ascontiguousarray(flat[:, 1])
        # starts/ends mirror getFirstPos/getLastPos; uint32 cast == & mask
        first = np.asarray(am.starts, np.int64).astype(np.uint32)
        last = np.asarray(am.ends, np.int64).astype(np.uint32)
        # positions sharing a LUT (same gl dict) marshal one table
        lut_of_pos = np.empty(len(luts), np.int32)
        uniq_index: Dict[int, int] = {}
        uniq_tables: List = []
        for p, table in enumerate(luts):
            key = id(table)
            idx = uniq_index.get(key)
            if idx is None:
                idx = len(uniq_index)
                uniq_index[key] = idx
                uniq_tables.append(np.asarray(table, np.float32).ravel())
            lut_of_pos[p] = idx
        luts_flat = (
            np.concatenate(uniq_tables) if uniq_tables else np.zeros(1, np.float32)
        )
        cap = max(64 * n_reads, 1 << 16)
        while True:
            out = scorelib.score_pairs(
                n_reads, numAlleles, read_off, read_pos, read_allele,
                first, last, np.asarray(sortedReads, np.int32), lut_of_pos,
                luts_flat, minOverlap, offset, cap,
            )
            if out is None:
                return None
            if len(out) == 2 and isinstance(out[0], str) and out[0] == "retry":
                cap = int(out[1]) + 1
                continue
            break
        oi, oj, osc, nans = out
        if len(oi):
            hi = np.maximum(oi, oj).astype(np.int64)
            lo = np.minimum(oi, oj).astype(np.int64)
            keep = hi != lo  # entryToIndex(i, i) == 0: never stored
            index = hi * (hi - 1) // 2 + lo + 1
            result.m.update(
                zip(index[keep].tolist(), osc[keep].astype(np.float64).tolist())
            )
            result.maxDim = max(result.maxDim, int(hi.max()) + 1)
        return nans


def scoreReadset(am, minOverlap, ploidy, err=0.0) -> TriangleSparseMatrix:
    """solver.pyx:136-141 convenience wrapper."""
    sim = TriangleSparseMatrix()
    ReadScoring().scoreReadset(sim, am, minOverlap, ploidy, err)
    return sim
