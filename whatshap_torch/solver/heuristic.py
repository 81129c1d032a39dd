"""
PedMEC heuristic solver: row-limited column-wise search over read
bipartitions with allele-balance vectors, supporting pedigrees,
recombination and de-novo mutations.

Behavior parity with the reference's src/pedmecheuristic.{h,cpp} as wrapped
by whatshap/core.pyx PedMecHeuristic (core.pyx:674-742): instead of
enumerating all 2^coverage bipartitions like the exact PedigreeDPTable, it
keeps at most `row_limit` candidate solutions per column.  Each candidate
carries, per sample and partition, a windowed "balance" vector (signed
phred-weighted allele votes over the positions its active reads still
touch), so placing a new read into a partition scores immediately against
the target genotypes; trios add transmission vectors with recombination
costs and optional mutation penalties (0.75*(rc[p]+rc[p+1]) per event).
"""

import logging
from typing import Dict, List, Tuple

from ..core import Read, ReadSet

logger = logging.getLogger(__name__)

INF = float("inf")
MAX_ROW_LIMIT = 65535


class _Sol:
    """One candidate solution of the current column (PedSolution)."""

    __slots__ = ("bp", "bpNew", "trans", "score", "mutationScore", "btRow", "balances")

    def __init__(self, bp, trans, score, balances):
        self.bp: List[bool] = bp
        self.bpNew: List[bool] = []
        self.trans: int = trans
        self.score: float = score
        self.mutationScore: float = 0.0
        self.btRow: int = 0
        self.balances: List[List[float]] = balances

    def clone(self) -> "_Sol":
        s = _Sol(list(self.bp), self.trans, self.score, [list(b) for b in self.balances])
        s.bpNew = list(self.bpNew)
        s.mutationScore = self.mutationScore
        s.btRow = self.btRow
        return s

    def finalize(self) -> None:
        self.bp.extend(self.bpNew)


class PedMecHeuristic:
    def __init__(
        self,
        readset: ReadSet,
        recombcost,
        pedigree,
        row_limit: int = 256,
        distrust_genotypes: bool = False,
        positions=None,
        allow_mutations: bool = True,
        verbosity: int = 0,
    ):
        self.rs = readset
        self.pedigree = pedigree
        self.distrustGenotypes = distrust_genotypes
        self.rowLimit = min(row_limit, MAX_ROW_LIMIT)
        self.allowMutations = allow_mutations
        self.verbosity = verbosity
        self.solved = False
        self.tmBits = 2 * pedigree.triple_count

        # recombination / mutation cost tables (pedmecheuristic.cpp:33-41)
        n = len(recombcost)
        self.recombCost = [0.0] * n
        self.mutationCost = [INF] * n
        for i in range(1, n):
            self.recombCost[i] = float(recombcost[i])
            if allow_mutations:
                self.mutationCost[i - 1] = 0.75 * (float(recombcost[i - 1]) + float(recombcost[i]))
        if allow_mutations and n > 0:
            self.mutationCost[n - 1] = float(recombcost[n - 1]) * 1.5

        if positions is None:
            self.positions = sorted(readset.get_positions())
        else:
            self.positions = list(positions)
        self.posMap: Dict[int, int] = {p: i for i, p in enumerate(self.positions)}

        # sample set: read sample ids plus pedigree triple members
        # (the reference mixes ids and pedigree indices here; they coincide
        # for NumericSampleIds-generated inputs)
        sample_set = set()
        for i in range(len(readset)):
            sample_set.add(readset[i].sample_id)
        self.trios = [list(t) for t in pedigree.triples]
        for trio in self.trios:
            for s in trio:
                sample_set.add(s)
        self.globalSampleIds = sorted(sample_set)
        self.numSamples = len(self.globalSampleIds)
        self.sampleMap = {g: i for i, g in enumerate(self.globalSampleIds)}
        for trio in self.trios:
            for i in range(3):
                trio[i] = self.sampleMap[trio[i]]

        # per sample per position: genotype as alt-allele count (0/1/2)
        self.genotypes: List[List[int]] = []
        npos = len(self.positions)
        for s in range(self.numSamples):
            row = []
            for p in range(npos):
                a = pedigree.get_genotype(s, p).as_vector()
                row.append(a[0] + a[1])
            self.genotypes.append(row)

        # results
        self.optScore = 0.0
        self.optBipart: List[bool] = []
        self.optHaps: List[List[List[int]]] = []
        self.mutations: List[List[Tuple[int, int]]] = []
        self.optTrans: List[int] = []

    # --- public API (core.pyx PedMecHeuristic) ---

    def get_super_reads(self):
        self.solve()
        read_sets = []
        for sid in range(self.numSamples):
            read0 = Read("superread_0", -1, -1, self.globalSampleIds[sid])
            read1 = Read("superread_1", -1, -1, self.globalSampleIds[sid])
            for p, pos in enumerate(self.positions):
                read0.add_variant(pos, self.optHaps[sid][0][p], 30)
                read1.add_variant(pos, self.optHaps[sid][1][p], 30)
            phased = ReadSet()
            phased.add(read0)
            phased.add(read1)
            read_sets.append(phased)
        return read_sets, list(self.optTrans)

    def get_optimal_cost(self) -> float:
        self.solve()
        return self.optScore

    def get_optimal_partitioning(self):
        self.solve()
        # core.pyx:716-722 inverts the C++ bool
        return [0 if x else 1 for x in self.optBipart]

    def get_mutations(self):
        self.solve()
        return [list(m) for m in self.mutations]

    def get_mutation_cost(self):
        return list(self.mutationCost)

    # --- core (pedmecheuristic.cpp solve) ---

    def _solve_native(self) -> bool:
        """Dispatch to the C++ engine (csrc/host/heurlib.cpp), an
        operation-identical double-precision port of solve() below; False
        where hostlib.heurlib is None (the Python path)."""
        from ..hostlib import heurlib

        if heurlib is None:
            return False
        rs = self.rs
        m = len(rs)
        n = len(self.positions)
        posMap = self.posMap
        reads = [rs[i] for i in range(m)]
        read_first, read_last, read_sample = [], [], []
        var_off, var_pos, var_allele, var_qual = [0], [], [], []
        for r in reads:
            read_first.append(posMap.get(r[0].position, 0) if len(r) else 0)
            read_last.append(posMap.get(r[len(r) - 1].position, 0) if len(r) else 0)
            read_sample.append(self.sampleMap[r.sample_id])
            for v in r:
                var_pos.append(posMap.get(v.position, 0))
                var_allele.append(v.allele)
                var_qual.append(float(v.quality))
            var_off.append(len(var_pos))
        genotypes_flat = [g for row in self.genotypes for g in row]
        result = heurlib.solve(
            m, n, self.numSamples, self.trios, self.tmBits, self.rowLimit,
            self.distrustGenotypes, self.recombCost, self.mutationCost,
            genotypes_flat, read_sample, read_first, read_last,
            var_off, var_pos, var_allele, var_qual,
        )
        if result is None:
            return False
        self.optBipart, self.optTrans, self.optHaps, self.mutations = result
        # the reference never assigns optScore in solve(); see below
        self.optScore = 0
        self.solved = True
        return True

    def solve(self) -> None:
        if self.solved:
            return
        if self._solve_native():
            return
        rs = self.rs
        m = len(rs)
        n = len(self.positions)
        posMap = self.posMap

        reads = [rs[i] for i in range(m)]
        read_first = [posMap.get(r[0].position, 0) if len(r) else 0 for r in reads]
        read_last = [posMap.get(r[len(r) - 1].position, 0) if len(r) else 0 for r in reads]
        read_sample = [self.sampleMap[r.sample_id] for r in reads]

        # index of the first read starting at position >= p
        startIndex = [0]
        q = 0
        for p in range(n):
            while q < m and read_first[q] <= p:
                q += 1
            startIndex.append(q)

        # put the first read of a yet-unseen non-child sample into partition 0
        seen = [False] * self.numSamples
        for trio in self.trios:
            seen[trio[2]] = True

        lastCol: List[_Sol] = [
            _Sol([], 0, 0.0, [[0.0] for _ in range(self.numSamples * 2)])
        ]
        active: List[int] = []
        mBt: List[List[int]] = [[] for _ in range(n)]
        mBp: List[Tuple[int, List[bool]]] = []
        mTm: List[List[int]] = []

        right = 0
        for p in range(n):
            # reads still active in this column
            activeLast = list(active)
            kept = []
            active = []
            for i, r in enumerate(activeLast):
                if read_last[r] >= p:
                    active.append(r)
                    kept.append(i)

            # carry over bipartitions without the lost reads, dedup
            sols: List[_Sol] = []
            buckets: Dict[Tuple[int, Tuple[bool, ...]], List[int]] = {}
            for i, old in enumerate(lastCol):
                b = [old.bp[a] for a in kept]
                key = (old.trans, tuple(b))
                rows = buckets.get(key)
                if rows is not None:
                    self._update_solution(sols[rows[0]], old, i)
                else:
                    buckets[key] = [len(sols)]
                    fresh = _Sol(b, old.trans, INF, [[] for _ in range(self.numSamples * 2)])
                    self._update_solution(fresh, old, i)
                    sols.append(fresh)
            buckets.clear()

            # window end: furthest last position among current + new reads
            right = max(right, p)
            for r in range(startIndex[p], startIndex[p + 1]):
                right = max(right, read_last[r])
            width = right + 1 - p
            for sol in sols:
                for b in sol.balances:
                    if len(b) < width:
                        b.extend([0.0] * (width - len(b)))
                    else:
                        del b[width:]

            # summarize new reads; merge reads with identical allele support
            numNew = startIndex[p + 1] - startIndex[p]
            equalTo = [-1] * numNew
            balances: List[List[float]] = []
            sampleIds: List[int] = []
            for i in range(numNew):
                r = startIndex[p] + i
                active.append(r)
                b = [0.0] * width
                sampleIds.append(read_sample[r])
                for v in reads[r]:
                    o = posMap.get(v.position, 0) - p
                    a = v.allele
                    qv = float(v.quality)
                    b[o] += qv * a - qv * (1 - a)
                for j in range(i):
                    if equalTo[j] != -1 or sampleIds[j] != sampleIds[i]:
                        continue
                    equal = True
                    for k in range(width):
                        if balances[j][k] * b[k] < 0 or (balances[j][k] != 0.0) != (b[k] != 0.0):
                            equal = False
                            break
                    if equal:
                        equalTo[i] = j
                        for k in range(width):
                            balances[j][k] += b[k]
                        break
                balances.append(b)

            # two extensions per solution for every (non-duplicate) new read
            for i in range(numNew):
                balance = balances[i]
                sampleId = sampleIds[i]
                target = self.genotypes[sampleId][p : right + 1]

                solEnd = len(sols)
                for sol in range(solEnd):
                    if equalTo[i] >= 0:
                        sols[sol].bpNew.append(sols[sol].bpNew[equalTo[i]])
                        continue

                    # does this read even distinguish the partitions?
                    useful = False
                    if self.distrustGenotypes:
                        for j in range(len(balance)):
                            s0 = sols[sol].balances[sampleId * 2][j]
                            s1 = sols[sol].balances[sampleId * 2 + 1][j]
                            if (balance[j] != 0 and s0 * s1 < 0) or (
                                (balance[j] + s0) * s0 <= 0 and (balance[j] + s1) * s1 <= 0
                            ):
                                useful = True
                                break
                    else:
                        for j in range(len(balance)):
                            if self.genotypes[sampleId][p + j] == 1 and balance[j] != 0:
                                useful = True
                                break

                    sol1 = 0
                    if seen[sampleId]:
                        clone = sols[sol].clone()
                        sols.append(clone)
                        sol1 = len(sols) - 1
                        clone.score += self._add_balance(
                            clone.balances[2 * sampleId + 1],
                            clone.balances[2 * sampleId],
                            balance,
                            target,
                        )
                        clone.mutationScore = self._mutation_cost(
                            clone.balances, clone.trans, p, True, 5
                        )
                        clone.bpNew.append(True)
                    cur = sols[sol]
                    cur.score += self._add_balance(
                        cur.balances[2 * sampleId],
                        cur.balances[2 * sampleId + 1],
                        balance,
                        target,
                    )
                    cur.mutationScore = self._mutation_cost(cur.balances, cur.trans, p, True, 5)
                    cur.bpNew.append(False)

                    if sol1 and not useful:
                        if (
                            cur.score + cur.mutationScore
                            > sols[sol1].score + sols[sol1].mutationScore
                        ):
                            sols[sol] = sols[sol1]
                        sols.pop()
                seen[sampleId] = True

                if len(sols) > self.rowLimit:
                    self._filter_solutions(sols)

            # alternative transmissions where mutations could be avoided
            solEnd = len(sols)
            for i in range(solEnd):
                self._extend_solutions(sols, i, p)
            if len(sols) > self.rowLimit:
                self._filter_solutions(sols)

            # charge this column's phasing/mutation cost
            for sol in sols:
                firsts = [b[0] for b in sol.balances]
                sol.score += self._opt_phasing(firsts, sol.trans, p)[0]

            lastCol = []
            btVector: List[bool] = []
            tmVector: List[int] = []
            for sol in sols:
                sol.finalize()
                lastCol.append(sol)
                mBt[p].append(sol.btRow)
                btVector.extend(sol.bpNew)
                for j in range(self.tmBits):
                    tmVector.append((sol.trans >> j) & 1)
            mBp.append((startIndex[p + 1] - startIndex[p], btVector))
            mTm.append(tmVector)

        # pick the best final solution
        self.optTrans = [0] * n
        s = INF
        ri = 0
        for sol in range(len(lastCol)):
            if lastCol[sol].score < s:
                s = lastCol[sol].score
                ri = sol

        # backtracking
        self.optBipart = [False] * m
        for p in range(n - 1, -1, -1):
            offset = startIndex[p]
            newCount = mBp[p][0]
            current = mBp[p][1][newCount * ri : newCount * (ri + 1)]
            for i, bit in enumerate(current):
                self.optBipart[offset + i] = bit
            tm = mTm[p][self.tmBits * ri : self.tmBits * (ri + 1)]
            v = 0
            for t in range(self.tmBits - 1, -1, -1):
                v = (v << 1) + tm[t]
            self.optTrans[p] = v
            ri = mBt[p][ri]

        # allele votes per position given the final bipartition
        votes = [[0.0] * (2 * self.numSamples) for _ in range(n)]
        for rid in range(m):
            for v in reads[rid]:
                a = v.allele
                if a >= 0:
                    sid = read_sample[rid]
                    votes[posMap.get(v.position, 0)][2 * sid + self.optBipart[rid]] += (
                        2 * a - 1
                    ) * float(v.quality)

        # optimal phasing per position
        self.optHaps = [
            [[-1] * n for _ in range(2)] for _ in range(self.numSamples)
        ]
        self.mutations = [[] for _ in range(self.numSamples)]
        total = 0.0
        for p in range(n):
            s, phasing, mut = self._opt_phasing(votes[p], self.optTrans[p], p, want_phasing=True)
            total += s
            for sid in range(self.numSamples):
                self.optHaps[sid][0][p] = phasing[2 * sid]
                self.optHaps[sid][1][p] = phasing[2 * sid + 1]
                if mut[2 * sid]:
                    self.mutations[sid].append((0, p))
                if mut[2 * sid + 1]:
                    self.mutations[sid].append((1, p))
        # the reference never assigns optScore in solve(), so its
        # get_optimal_cost() always reports 0 (pedmecheuristic.cpp:28,89);
        # replicated here for parity
        self.optScore = 0
        self.solved = True

    # --- internals ---

    @staticmethod
    def _update_solution(newSol: _Sol, oldSol: _Sol, oldIdx: int) -> None:
        # pedmecheuristic.cpp updateSolution: keep the better score, shift
        # the balance windows by one position
        if newSol.score > oldSol.score:
            newSol.score = oldSol.score
            newSol.btRow = oldIdx
            newSol.balances = [b[1:] if b else [] for b in oldSol.balances]

    def _recombination_cost(self, t1: int, t2: int, p: int) -> float:
        return self.recombCost[p] * bin(t1 ^ t2).count("1")

    def _mutation_cost(
        self, balances: List[List[float]], t: int, p: int, allowFlips: bool, ahead: int
    ) -> float:
        cost = 0.0
        last = min(ahead, len(balances[0]) - 1)
        mc = self.mutationCost[p]
        for i in range(last + 1):
            for k, trio in enumerate(self.trios):
                m2c = (t >> (2 * k)) & 1
                f2c = (t >> (2 * k + 1)) & 1
                cm = balances[2 * trio[2]][i]
                cf = balances[2 * trio[2] + 1][i]
                mm = balances[2 * trio[0] + m2c][i]
                ff = balances[2 * trio[1] + f2c][i]
                if allowFlips:
                    if cm * mm < 0:
                        cost += min(mc, min(abs(cm), abs(mm)))
                    if cf * ff < 0:
                        cost += min(mc, min(abs(cf), abs(ff)))
                else:
                    if cm * mm < 0:
                        cost += mc
                    if cf * ff < 0:
                        cost += mc
        return cost

    def _opt_phasing(
        self, balances: List[float], t: int, p: int, want_phasing: bool = False
    ):
        """Best per-sample phasing (0|0, 0|1, 1|0, 1|1 encoded 0..3) for the
        given allele balances and transmission (getOptPhasing)."""
        ns = self.numSamples
        phaseCost = []
        for s in range(ns):
            a0 = balances[2 * s]
            a1 = balances[2 * s + 1]
            pc = [
                (a0 if a0 > 0 else 0.0) + (a1 if a1 > 0 else 0.0),
                (-a0 if a0 < 0 else 0.0) + (a1 if a1 > 0 else 0.0),
                (a0 if a0 > 0 else 0.0) + (-a1 if a1 < 0 else 0.0),
                (-a0 if a0 < 0 else 0.0) + (-a1 if a1 < 0 else 0.0),
            ]
            pc.append(max(pc))
            phaseCost.append(pc)

        phases: List[List[int]] = [[] for _ in range(ns)]
        if self.distrustGenotypes:
            mc = self.mutationCost[p]
            for s in range(ns):
                for i in range(4):
                    if phaseCost[s][i] < phaseCost[s][4] + 2 * mc:
                        phases[s].append(i)
        else:
            for s in range(ns):
                g = self.genotypes[s][p]
                if g == 0:
                    phases[s].append(0)
                elif g == 2:
                    phases[s].append(3)
                else:
                    phases[s].append(1)
                    phases[s].append(2)

        minCost = INF
        best_phasing = [0] * (2 * ns)
        best_mut = [False] * (2 * ns)
        mcost = self.mutationCost[p]
        v = [0] * ns
        while v[ns - 1] < len(phases[ns - 1]):
            cost = 0.0
            mut = [False] * (ns * 2)
            for k, trio in enumerate(self.trios):
                m2c = (t >> (2 * k)) & 1
                f2c = (t >> (2 * k + 1)) & 1
                pc_child = phases[trio[2]][v[trio[2]]]
                acm = pc_child & 1
                acf = (pc_child & 2) >> 1
                am = (phases[trio[0]][v[trio[0]]] & (1 + m2c)) >> m2c
                af = (phases[trio[1]][v[trio[1]]] & (1 + f2c)) >> f2c
                if am != acm:
                    cost += mcost
                    mut[2 * trio[2]] = True
                else:
                    mut[2 * trio[2]] = False
                if af != acf:
                    cost += mcost
                    mut[2 * trio[2] + 1] = True
                else:
                    mut[2 * trio[2] + 1] = False
            for s in range(ns):
                cost += phaseCost[s][phases[s][v[s]]]

            if cost < minCost:
                minCost = cost
                if want_phasing:
                    for s in range(ns):
                        best_phasing[2 * s] = phases[s][v[s]] & 1
                        best_phasing[2 * s + 1] = (phases[s][v[s]] & 2) >> 1
                    best_mut = list(mut)

            v[0] += 1
            for j in range(ns - 1):
                if v[j] >= len(phases[j]):
                    v[j] = 0
                    v[j + 1] += 1
        return minCost, best_phasing, best_mut

    def _add_balance(
        self,
        basis: List[float],
        coBasis: List[float],
        add: List[float],
        target: List[int],
    ) -> float:
        penalty = 0.0
        for i in range(len(add)):
            if self.distrustGenotypes:
                if basis[i] * add[i] < 0:
                    penalty += min(abs(basis[i]), abs(add[i]))
            elif target[i] == 1:
                if add[i] <= 0:
                    penalty += min(-add[i], max(basis[i] - coBasis[i], 0.0))
                else:
                    penalty += min(add[i], max(coBasis[i] - basis[i], 0.0))
            else:
                if add[i] * (target[i] - 1) < 0:
                    penalty += abs(add[i])
            basis[i] += add[i]
        return penalty

    def _extend_solutions(self, sols: List[_Sol], toExt: int, p: int) -> None:
        sols[toExt].mutationScore = self._mutation_cost(
            sols[toExt].balances, sols[toExt].trans, p, False, 0
        )
        if sols[toExt].mutationScore > 0:
            base = sols[toExt]
            for t in range(1 << self.tmBits):
                if t == base.trans:
                    continue
                rc = self._recombination_cost(base.trans, t, p)
                if rc >= base.mutationScore:
                    continue
                mutv = self._mutation_cost(base.balances, t, p, False, 0)
                if mutv + rc >= base.mutationScore:
                    continue
                alt = _Sol(
                    list(base.bp), t, base.score + rc, [list(b) for b in base.balances]
                )
                alt.bpNew = list(base.bpNew)
                alt.mutationScore = mutv
                alt.btRow = base.btRow
                sols.append(alt)

    def _filter_solutions(self, sols: List[_Sol]) -> None:
        scores = sorted(s.score + s.mutationScore for s in sols)
        tooHigh = scores[self.rowLimit] if len(scores) > self.rowLimit else INF
        kept = []
        for i, s in enumerate(sols):
            score = s.score + s.mutationScore
            if (score < tooHigh or score == scores[0]) and len(kept) < MAX_ROW_LIMIT:
                kept.append(i)
        for i, src in enumerate(kept):
            sols[i] = sols[src]
        del sols[len(kept):]
