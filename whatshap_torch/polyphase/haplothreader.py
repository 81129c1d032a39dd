"""
Haplotype threading DP over cluster tuples.

Behavior parity with src/polyphase/{haplothreader,tupleconverter}.{h,cpp}
and tuple.h: cluster tuples are packed 5 bits per haplotype into an int,
columns are sparse dicts keyed by tuple code, and the recursion minimizes
coverage cost (binomial log-pmf against expected cluster coverage) plus
permutation-minimal switch cost. Scores are float32 like the C++
(ThreadScore = float).
"""

import math
import struct
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from .mathutils import log_binom_pmf as _log_binom_pmf_uncached


@lru_cache(maxsize=65536)
def log_binom_pmf(n, k, p):
    # pure function; caching preserves exact float results while removing
    # the repeated O(k) coefficient loops from the coverage-cost inner loop
    return _log_binom_pmf_uncached(n, k, p)

BITS = 5
MASK = 31
MAX_PLOIDY = 64 // BITS
INVALID_TUPLE = (1 << 64) - 1
_U32 = 0xFFFFFFFF
INF = float("inf")


def _f32(v: float) -> float:
    return struct.unpack("f", struct.pack("f", v))[0]


def tuple_from_ids(ids: Sequence[int]) -> int:
    t = 0
    for i, c in enumerate(ids):
        t += c << (i * BITS)
    return t


def tuple_get(t: int, i: int) -> int:
    return (t >> (i * BITS)) & MASK


def tuple_fingerprint(t: int, ploidy: int) -> int:
    return tuple_from_ids(sorted(tuple_get(t, i) for i in range(ploidy)))


def tuple_as_vector(t: int, ploidy: int, globalIds: Sequence[int]) -> List[int]:
    out = []
    n = len(globalIds)
    for i in range(ploidy):
        c = tuple_get(t, i)
        if c >= n:
            return []
        out.append(globalIds[c])
    return out


class TupleConverter:
    """tupleconverter.cpp: maps local cluster ids between two adjacent
    positions via their global id lists."""

    def __init__(self, oldClusters: Sequence[int], newClusters: Sequence[int], ploidy: int):
        idMap = {g: c for c, g in enumerate(newClusters)}
        self.oldToNew = {
            c: idMap[g] for c, g in enumerate(oldClusters) if g in idMap
        }
        idMap = {g: c for c, g in enumerate(oldClusters)}
        self.newToOld = {
            c: idMap[g] for c, g in enumerate(newClusters) if g in idMap
        }
        self.ploidy = ploidy

    def convertNewToOld(self, newTuple: int) -> int:
        v = []
        for i in range(self.ploidy):
            c = tuple_get(newTuple, i)
            if c not in self.newToOld:
                return INVALID_TUPLE
            v.append(self.newToOld[c])
        return tuple_from_ids(v)

    def convertOldToNew(self, oldTuple: int) -> int:
        v = []
        for i in range(self.ploidy):
            c = tuple_get(oldTuple, i)
            if c not in self.oldToNew:
                return INVALID_TUPLE
            v.append(self.oldToNew[c])
        return tuple_from_ids(v)

    def permuteAgainstOld(self, newTuple: int, oldTuple: int) -> int:
        ploidy = self.ploidy
        v = [tuple_get(newTuple, i) for i in range(ploidy)]
        u = [0] * ploidy
        resOld = []
        for i in range(ploidy):
            c = tuple_get(oldTuple, i)
            if c in self.oldToNew:
                d = self.oldToNew[c]
                for j in range(ploidy):
                    if v[j] == d:
                        u[i] = d
                        v[j] = -1
                        d = -1
                        break
                if d >= 0:
                    resOld.append(i)
            else:
                resOld.append(i)
        resIdx = 0
        for i in range(ploidy):
            if v[i] >= 0:
                u[resOld[resIdx]] = v[i]
                resIdx += 1
        return tuple_from_ids(u)


class HaploThreader:
    def __init__(
        self,
        ploidy: int,
        switchCost: float,
        affineSwitchCost: float,
        maxClusterGap: int,
        rowLimit: int,
    ):
        self.ploidy = ploidy
        self.switchCost = switchCost
        self.affineSwitchCost = affineSwitchCost
        self.maxClusterGap = maxClusterGap
        self.rowLimit = rowLimit

    # --- public API (solver.pyx HaploThreader wrapper) ---

    def computePathsBlockwise(
        self,
        blockStarts: Sequence[int],
        covMap: Sequence[Sequence[int]],
        alleleDepths: Sequence[Dict[int, Dict[int, int]]],
    ) -> List[List[int]]:
        native = self._compute_native(blockStarts, covMap, alleleDepths)
        if native is not None:
            return native
        numVars = len(covMap)
        path: List[List[int]] = []
        for i, start in enumerate(blockStarts):
            end = numVars if i == len(blockStarts) - 1 else blockStarts[i + 1]
            if end > start:
                path.extend(self.computePaths(start, end, covMap, alleleDepths, numVars))
        return path

    def _compute_native(self, blockStarts, covMap, alleleDepths):
        """Dispatch to the C++ engine (csrc/host/threadlib.cpp, built at
        first use), an exact behavioral mirror of computePaths below —
        identical float32 score arithmetic and tie handling (differentially
        tested).  None where hostlib.threadlib is None or the instance is
        past the library's interface (ploidy or int32 bounds): the Python
        path then runs, as in the reference."""
        from ..hostlib import threadlib

        if threadlib is None or not (1 <= self.ploidy <= MAX_PLOIDY):
            return None
        num_vars = len(covMap)
        cov_offsets = [0]
        cov_ids: List[int] = []
        cov_totals: List[int] = []
        for pos in range(num_vars):
            for cid in covMap[pos]:
                cov_ids.append(cid)
                cov_totals.append(sum(alleleDepths[pos][cid].values()))
            cov_offsets.append(len(cov_ids))
        if cov_ids and (max(cov_ids) > 2**31 - 1 or max(cov_totals) > 2**31 - 1):
            return None  # int32 interface bounds
        return threadlib.thread_paths(
            num_vars,
            self.ploidy,
            float(self.switchCost),
            float(self.affineSwitchCost),
            self.maxClusterGap,
            self.rowLimit,
            list(blockStarts),
            cov_offsets,
            cov_ids,
            cov_totals,
        )

    def computePaths(
        self,
        start: int,
        end: int,
        covMap: Sequence[Sequence[int]],
        alleleDepths: Sequence[Dict[int, Dict[int, int]]],
        displayedEnd: int = 0,
    ) -> List[List[int]]:
        coverage, clusterCoverage = self._computeCoverage(alleleDepths, covMap)

        m: List[Dict[int, Tuple[float, int]]] = []  # tuple -> (score, pred)
        firstUnthreadedPosition = start
        sortedGlobalTuples: Dict[int, List[int]] = {}

        for pos in range(start, end):
            offset = 1 if pos > start else 0
            relevantTuples = self._computeRelevantTuples(clusterCoverage, pos)
            tc = TupleConverter(covMap[pos - offset], covMap[pos], self.ploidy)
            if not relevantTuples:
                print(f"No tuples for position {pos}. Aborting ...")
                break

            coverageCosts = []
            minCovCost = INF
            for t in relevantTuples:
                c = self._getCoverageCost(t, coverage[pos], clusterCoverage[pos])
                coverageCosts.append(c)
                if c < minCovCost:
                    minCovCost = c

            fpToTuple: Dict[int, int] = {}
            scoreSortedPreds: List[Tuple[int, Tuple[float, int]]] = []
            if pos > start:
                prev = m[pos - 1 - start]
                for pt, entry in prev.items():
                    fpToTuple[tuple_fingerprint(pt, self.ploidy)] = pt
                    scoreSortedPreds.append((pt, entry))
                scoreSortedPreds.sort(key=lambda a: a[1][0])

            column: Dict[int, Tuple[float, int]] = {}
            for tid, tuple_ in enumerate(relevantTuples):
                coverageCost = coverageCosts[tid]
                if coverageCost > 30 + minCovCost:
                    continue
                optPredScore = INF
                optPredTuple = INVALID_TUPLE
                tupleGlobal = sorted(tuple_as_vector(tuple_, self.ploidy, covMap[pos]))

                if fpToTuple:
                    # the reference fingerprints INVALID_TUPLE too (all-ones
                    # local ids); tuple_get masks make that work here as well
                    fp = tuple_fingerprint(tc.convertNewToOld(tuple_), self.ploidy)
                    if fp in fpToTuple:
                        optPredTuple = fpToTuple[fp]
                        if optPredTuple in m[pos - 1 - start]:
                            optPredScore = m[pos - 1 - start][optPredTuple][0]
                    for predTuple, predEntry in scoreSortedPreds:
                        if predEntry[0] + self.switchCost + self.affineSwitchCost >= optPredScore:
                            break
                        predTupleGlobal = sortedGlobalTuples.get(predTuple, [])
                        s = _f32(
                            predEntry[0]
                            + self._getSwitchCostAllPerms(predTupleGlobal, tupleGlobal)
                        )
                        if s < optPredScore:
                            optPredScore = s
                            optPredTuple = predTuple
                else:
                    optPredScore = 0.0
                    optPredTuple = tuple_

                bestPerm = tc.permuteAgainstOld(tuple_, optPredTuple)
                if optPredScore == INF or math.isnan(optPredScore):
                    print(
                        f"Invalid pred score of {optPredScore} for tuple at position {pos}"
                    )
                column[bestPerm] = (_f32(optPredScore + coverageCost), optPredTuple)
                firstUnthreadedPosition = pos + 1

            sortedGlobalTuples = {
                t: sorted(tuple_as_vector(t, self.ploidy, covMap[pos])) for t in column
            }

            if self.rowLimit > 0 and len(column) >= self.rowLimit:
                ranked = sorted(column.items(), key=lambda a: a[1][0])
                for t, _ in ranked[self.rowLimit :]:
                    del column[t]

            m.append(dict(column))

        # backtracking (haplothreader.cpp:208-252)
        path: List[List[int]] = []
        if not m:
            return path
        currentRow = INVALID_TUPLE
        minimum = INF
        for t, entry in m[firstUnthreadedPosition - 1 - start].items():
            if entry[0] < minimum:
                minimum = entry[0]
                currentRow = t
        if currentRow == INVALID_TUPLE:
            print(
                f"No minimum among {len(m[firstUnthreadedPosition - 1 - start])} entries "
                "in last threaded column!"
            )
        else:
            path.append(
                tuple_as_vector(currentRow, self.ploidy, covMap[firstUnthreadedPosition - 1])
            )
        for pos in range(firstUnthreadedPosition - 1, start, -1):
            currentRow = m[pos - start][currentRow][1]
            vec = tuple_as_vector(currentRow, self.ploidy, covMap[pos - 1])
            if not vec:
                print(f"Empty cluster tuple at position {pos - 1}")
                vec = [0] * self.ploidy
            path.append(vec)
        path.reverse()
        return path

    # --- internals ---

    def _getCoverageCost(
        self, tuple_: int, coverage: int, clusterCoverage: Sequence[int]
    ) -> float:
        llh = 0.0
        unthreadedReads = 0
        clustMult = [0] * len(clusterCoverage)
        for i in range(self.ploidy):
            clustMult[tuple_get(tuple_, i)] += 1
        for cid in range(len(clusterCoverage)):
            if clustMult[cid] == 0:
                unthreadedReads += clusterCoverage[cid]
            else:
                p = (0.975 * clustMult[cid]) / self.ploidy
                llh += log_binom_pmf(coverage, clusterCoverage[cid], p)
        llh += log_binom_pmf(coverage, unthreadedReads, 0.025)
        return _f32(-llh)

    def _getSwitchCostAllPerms(
        self, prevTuple: Sequence[int], curTuple: Sequence[int]
    ) -> float:
        pIdx = 0
        cIdx = 0
        switches = 0
        ploidy = self.ploidy
        while pIdx < ploidy and cIdx < ploidy:
            if prevTuple[pIdx] == curTuple[cIdx]:
                pIdx += 1
                cIdx += 1
            elif prevTuple[pIdx] < curTuple[cIdx]:
                switches += 1
                pIdx += 1
            else:
                cIdx += 1
        switches += ploidy - pIdx
        return _f32(self.switchCost * switches + self.affineSwitchCost * (switches > 0))

    def _computeRelevantTuples(
        self, clusterCoverage: Sequence[Sequence[int]], pos: int
    ) -> List[int]:
        # haplothreader.cpp:291-337: counter-style enumeration of all
        # cluster multisets (each multiset appears exactly once)
        maxElem = len(clusterCoverage[pos])
        ploidy = self.ploidy
        relevantTuples = []
        v = [0] * ploidy
        while v[ploidy - 1] < maxElem:
            relevantTuples.append(tuple_from_ids(v))
            v[0] += 1
            for i in range(1, ploidy):
                if v[i - 1] >= maxElem:
                    v[i] += 1
            for i in range(ploidy - 1, 0, -1):
                if v[i - 1] >= maxElem:
                    v[i - 1] = v[i]
        return relevantTuples

    def _computeCoverage(
        self,
        alleleDepths: Sequence[Dict[int, Dict[int, int]]],
        covMap: Sequence[Sequence[int]],
    ) -> Tuple[List[int], List[List[int]]]:
        numPos = len(alleleDepths)
        covGlobal: List[Dict[int, int]] = []
        for pos in range(numPos):
            d = {}
            for cid in covMap[pos]:
                d[cid] = sum(alleleDepths[pos][cid].values())
            covGlobal.append(d)
        coverage = [0] * numPos
        clusterCoverage: List[List[int]] = [[] for _ in range(numPos)]
        half = self.maxClusterGap // 2
        for pos in range(numPos):
            total = 0
            mx = min(numPos - 1, pos + (self.maxClusterGap + 1) // 2)
            mn = (pos - half) & _U32  # uint32 wrap like the reference
            if not (mn < mx):
                mn = 0
            for i, cid in enumerate(covMap[pos]):
                smoothedCov = 0
                numNonZero = 0
                for p in range(mn, mx + 1):
                    cov = covGlobal[p].get(cid, 0)
                    if cov > 0:
                        smoothedCov += cov
                        numNonZero += 1
                if numNonZero == 0:
                    numNonZero = 1
                clusterCoverage[pos].append(smoothedCov // numNonZero)
                total += clusterCoverage[pos][i]
            coverage[pos] = total
        return coverage, clusterCoverage
