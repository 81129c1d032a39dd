// PedMEC beam-search heuristic engine.
//
// C++ implementation of the row-limited column-wise bipartition search of
// whatshap_torch/solver/heuristic.py (semantics from the reference's
// src/pedmecheuristic.{h,cpp}); operation-for-operation identical in
// double precision so results are bit-equal to the Python engine, which in
// turn is fuzz-verified against the compiled reference oracle.
//
// Reads arrive pre-localized (variant positions as column indices, sample
// ids already mapped to dense indices); outputs are the final bipartition,
// per-column transmission values, per-sample haplotype alleles and the
// de-novo mutation events.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <utility>
#include <vector>

namespace {

constexpr double INF = std::numeric_limits<double>::infinity();
constexpr int MAX_ROW_LIMIT = 65535;

struct Sol {
    std::vector<uint8_t> bp;
    std::vector<uint8_t> bpNew;
    int trans = 0;
    double score = 0.0;
    double mutationScore = 0.0;
    int btRow = 0;
    std::vector<std::vector<double>> balances;
};

struct Engine {
    // inputs
    int m = 0, n = 0, numSamples = 0, tmBits = 0, rowLimit = 256;
    bool distrustGenotypes = false;
    std::vector<double> recombCost, mutationCost;
    std::vector<std::vector<int>> trios;              // k x 3 (dense ids)
    std::vector<std::vector<int>> genotypes;          // numSamples x n
    std::vector<int> readSample, readFirst, readLast; // per read
    std::vector<int> varOff;                          // m+1
    std::vector<int> varPos;                          // local column index
    std::vector<int> varAllele;
    std::vector<double> varQual;

    // outputs
    std::vector<uint8_t> optBipart;
    std::vector<int> optTrans;
    std::vector<std::vector<std::vector<int>>> optHaps; // sample x 2 x n
    std::vector<int> mutSample, mutHap, mutPos;

    double recombinationCost(int t1, int t2, int p) const {
        return recombCost[p] * __builtin_popcount((unsigned)(t1 ^ t2));
    }

    double mutationCostOf(const std::vector<std::vector<double>>& balances, int t, int p,
                          bool allowFlips, int ahead) const {
        double cost = 0.0;
        int last = std::min<int>(ahead, (int)balances[0].size() - 1);
        double mc = mutationCost[p];
        for (int i = 0; i <= last; ++i) {
            for (size_t k = 0; k < trios.size(); ++k) {
                int m2c = (t >> (2 * k)) & 1;
                int f2c = (t >> (2 * k + 1)) & 1;
                double cm = balances[2 * trios[k][2]][i];
                double cf = balances[2 * trios[k][2] + 1][i];
                double mm = balances[2 * trios[k][0] + m2c][i];
                double ff = balances[2 * trios[k][1] + f2c][i];
                if (allowFlips) {
                    if (cm * mm < 0) cost += std::min(mc, std::min(std::fabs(cm), std::fabs(mm)));
                    if (cf * ff < 0) cost += std::min(mc, std::min(std::fabs(cf), std::fabs(ff)));
                } else {
                    if (cm * mm < 0) cost += mc;
                    if (cf * ff < 0) cost += mc;
                }
            }
        }
        return cost;
    }

    // best per-sample phasing for the per-slot balances at column p
    double optPhasing(const std::vector<double>& balances, int t, int p, bool wantPhasing,
                      std::vector<int>* phasingOut, std::vector<uint8_t>* mutOut) const {
        int ns = numSamples;
        std::vector<std::vector<double>> phaseCost(ns);
        for (int s = 0; s < ns; ++s) {
            double a0 = balances[2 * s];
            double a1 = balances[2 * s + 1];
            std::vector<double> pc = {
                (a0 > 0 ? a0 : 0.0) + (a1 > 0 ? a1 : 0.0),
                (a0 < 0 ? -a0 : 0.0) + (a1 > 0 ? a1 : 0.0),
                (a0 > 0 ? a0 : 0.0) + (a1 < 0 ? -a1 : 0.0),
                (a0 < 0 ? -a0 : 0.0) + (a1 < 0 ? -a1 : 0.0),
            };
            double mx = pc[0];
            for (int i = 1; i < 4; ++i) mx = std::max(mx, pc[i]);
            pc.push_back(mx);
            phaseCost[s] = std::move(pc);
        }

        std::vector<std::vector<int>> phases(ns);
        if (distrustGenotypes) {
            double mc = mutationCost[p];
            for (int s = 0; s < ns; ++s)
                for (int i = 0; i < 4; ++i)
                    if (phaseCost[s][i] < phaseCost[s][4] + 2 * mc) phases[s].push_back(i);
        } else {
            for (int s = 0; s < ns; ++s) {
                int g = genotypes[s][p];
                if (g == 0) phases[s].push_back(0);
                else if (g == 2) phases[s].push_back(3);
                else { phases[s].push_back(1); phases[s].push_back(2); }
            }
        }

        double minCost = INF;
        std::vector<int> bestPhasing(2 * ns, 0);
        std::vector<uint8_t> bestMut(2 * ns, 0);
        double mcost = mutationCost[p];
        std::vector<int> v(ns, 0);
        std::vector<uint8_t> mut(2 * ns, 0);
        while (v[ns - 1] < (int)phases[ns - 1].size()) {
            double cost = 0.0;
            std::fill(mut.begin(), mut.end(), 0);
            for (size_t k = 0; k < trios.size(); ++k) {
                int m2c = (t >> (2 * k)) & 1;
                int f2c = (t >> (2 * k + 1)) & 1;
                int pcChild = phases[trios[k][2]][v[trios[k][2]]];
                int acm = pcChild & 1;
                int acf = (pcChild & 2) >> 1;
                int am = (phases[trios[k][0]][v[trios[k][0]]] & (1 + m2c)) >> m2c;
                int af = (phases[trios[k][1]][v[trios[k][1]]] & (1 + f2c)) >> f2c;
                if (am != acm) { cost += mcost; mut[2 * trios[k][2]] = 1; }
                else mut[2 * trios[k][2]] = 0;
                if (af != acf) { cost += mcost; mut[2 * trios[k][2] + 1] = 1; }
                else mut[2 * trios[k][2] + 1] = 0;
            }
            for (int s = 0; s < ns; ++s) cost += phaseCost[s][phases[s][v[s]]];

            if (cost < minCost) {
                minCost = cost;
                if (wantPhasing) {
                    for (int s = 0; s < ns; ++s) {
                        bestPhasing[2 * s] = phases[s][v[s]] & 1;
                        bestPhasing[2 * s + 1] = (phases[s][v[s]] & 2) >> 1;
                    }
                    bestMut = mut;
                }
            }
            v[0] += 1;
            for (int j = 0; j + 1 < ns; ++j) {
                if (v[j] >= (int)phases[j].size()) { v[j] = 0; v[j + 1] += 1; }
            }
        }
        if (wantPhasing) { *phasingOut = bestPhasing; *mutOut = bestMut; }
        return minCost;
    }

    double addBalance(std::vector<double>& basis, const std::vector<double>& coBasis,
                      const std::vector<double>& add, const int* target) const {
        double penalty = 0.0;
        for (size_t i = 0; i < add.size(); ++i) {
            if (distrustGenotypes) {
                if (basis[i] * add[i] < 0)
                    penalty += std::min(std::fabs(basis[i]), std::fabs(add[i]));
            } else if (target[i] == 1) {
                if (add[i] <= 0)
                    penalty += std::min(-add[i], std::max(basis[i] - coBasis[i], 0.0));
                else
                    penalty += std::min(add[i], std::max(coBasis[i] - basis[i], 0.0));
            } else {
                if (add[i] * (target[i] - 1) < 0) penalty += std::fabs(add[i]);
            }
            basis[i] += add[i];
        }
        return penalty;
    }

    static void updateSolution(Sol& newSol, const Sol& oldSol, int oldIdx) {
        if (newSol.score > oldSol.score) {
            newSol.score = oldSol.score;
            newSol.btRow = oldIdx;
            newSol.balances.clear();
            newSol.balances.reserve(oldSol.balances.size());
            for (const auto& b : oldSol.balances) {
                if (b.empty()) newSol.balances.emplace_back();
                else newSol.balances.emplace_back(b.begin() + 1, b.end());
            }
        }
    }

    void extendSolutions(std::vector<Sol>& sols, int toExt, int p) const {
        sols[toExt].mutationScore = mutationCostOf(sols[toExt].balances, sols[toExt].trans, p, false, 0);
        if (sols[toExt].mutationScore > 0) {
            for (int t = 0; t < (1 << tmBits); ++t) {
                const Sol& base = sols[toExt];
                if (t == base.trans) continue;
                double rc = recombinationCost(base.trans, t, p);
                if (rc >= base.mutationScore) continue;
                double mutv = mutationCostOf(base.balances, t, p, false, 0);
                if (mutv + rc >= base.mutationScore) continue;
                Sol alt;
                alt.bp = base.bp;
                alt.trans = t;
                alt.score = base.score + rc;
                alt.balances = base.balances;
                alt.bpNew = base.bpNew;
                alt.mutationScore = mutv;
                alt.btRow = base.btRow;
                sols.push_back(std::move(alt));
            }
        }
    }

    void filterSolutions(std::vector<Sol>& sols) const {
        std::vector<double> scores;
        scores.reserve(sols.size());
        for (const auto& s : sols) scores.push_back(s.score + s.mutationScore);
        std::vector<double> sorted = scores;
        std::sort(sorted.begin(), sorted.end());
        double tooHigh = (int)sorted.size() > rowLimit ? sorted[rowLimit] : INF;
        std::vector<int> kept;
        for (size_t i = 0; i < sols.size(); ++i) {
            double score = scores[i];
            if ((score < tooHigh || score == sorted[0]) && (int)kept.size() < MAX_ROW_LIMIT)
                kept.push_back((int)i);
        }
        for (size_t i = 0; i < kept.size(); ++i)
            if ((int)i != kept[i]) sols[i] = std::move(sols[kept[i]]);
        sols.resize(kept.size());
    }

    void solve() {
        // first read of each unseen non-child sample goes to partition 0
        std::vector<uint8_t> seen(numSamples, 0);
        for (const auto& trio : trios) seen[trio[2]] = 1;

        std::vector<int> startIndex;
        startIndex.push_back(0);
        {
            int q = 0;
            for (int p = 0; p < n; ++p) {
                while (q < m && readFirst[q] <= p) ++q;
                startIndex.push_back(q);
            }
        }

        std::vector<Sol> lastCol(1);
        lastCol[0].balances.assign(numSamples * 2, std::vector<double>(1, 0.0));
        std::vector<int> active;

        std::vector<std::vector<int>> mBt(n);
        std::vector<std::pair<int, std::vector<uint8_t>>> mBp;
        std::vector<std::vector<int>> mTm;

        int right = 0;
        for (int p = 0; p < n; ++p) {
            // retire reads that ended before this column
            std::vector<int> activeLast = active;
            std::vector<int> kept;
            active.clear();
            for (size_t i = 0; i < activeLast.size(); ++i) {
                if (readLast[activeLast[i]] >= p) {
                    active.push_back(activeLast[i]);
                    kept.push_back((int)i);
                }
            }

            // carry over bipartitions without the lost reads, dedup
            std::vector<Sol> sols;
            std::map<std::pair<int, std::vector<uint8_t>>, int> buckets;
            for (size_t i = 0; i < lastCol.size(); ++i) {
                std::vector<uint8_t> b;
                b.reserve(kept.size());
                for (int a : kept) b.push_back(lastCol[i].bp[a]);
                auto key = std::make_pair(lastCol[i].trans, b);
                auto it = buckets.find(key);
                if (it != buckets.end()) {
                    updateSolution(sols[it->second], lastCol[i], (int)i);
                } else {
                    buckets.emplace(std::move(key), (int)sols.size());
                    Sol fresh;
                    fresh.bp = std::move(b);
                    fresh.trans = lastCol[i].trans;
                    fresh.score = INF;
                    fresh.balances.assign(numSamples * 2, {});
                    updateSolution(fresh, lastCol[i], (int)i);
                    sols.push_back(std::move(fresh));
                }
            }

            // window end across current + newly starting reads
            right = std::max(right, p);
            for (int r = startIndex[p]; r < startIndex[p + 1]; ++r)
                right = std::max(right, readLast[r]);
            int width = right + 1 - p;
            for (auto& sol : sols)
                for (auto& b : sol.balances) b.resize(width, 0.0);

            // summarize new reads; merge reads with identical allele support
            int numNew = startIndex[p + 1] - startIndex[p];
            std::vector<int> equalTo(numNew, -1);
            std::vector<std::vector<double>> balances;
            std::vector<int> sampleIds;
            for (int i = 0; i < numNew; ++i) {
                int r = startIndex[p] + i;
                active.push_back(r);
                std::vector<double> b(width, 0.0);
                sampleIds.push_back(readSample[r]);
                for (int v = varOff[r]; v < varOff[r + 1]; ++v) {
                    int o = varPos[v] - p;
                    int a = varAllele[v];
                    double qv = varQual[v];
                    b[o] += qv * a - qv * (1 - a);
                }
                for (int j = 0; j < i; ++j) {
                    if (equalTo[j] != -1 || sampleIds[j] != sampleIds[i]) continue;
                    bool equal = true;
                    for (int k = 0; k < width; ++k) {
                        if (balances[j][k] * b[k] < 0 ||
                            (balances[j][k] != 0.0) != (b[k] != 0.0)) {
                            equal = false;
                            break;
                        }
                    }
                    if (equal) {
                        equalTo[i] = j;
                        for (int k = 0; k < width; ++k) balances[j][k] += b[k];
                        break;
                    }
                }
                balances.push_back(std::move(b));
            }

            // two extensions per solution for every (non-duplicate) new read
            for (int i = 0; i < numNew; ++i) {
                const std::vector<double>& balance = balances[i];
                int sampleId = sampleIds[i];
                const int* target = genotypes[sampleId].data() + p;

                int solEnd = (int)sols.size();
                for (int sol = 0; sol < solEnd; ++sol) {
                    if (equalTo[i] >= 0) {
                        sols[sol].bpNew.push_back(sols[sol].bpNew[equalTo[i]]);
                        continue;
                    }
                    bool useful = false;
                    if (distrustGenotypes) {
                        for (size_t j = 0; j < balance.size(); ++j) {
                            double s0 = sols[sol].balances[sampleId * 2][j];
                            double s1 = sols[sol].balances[sampleId * 2 + 1][j];
                            if ((balance[j] != 0 && s0 * s1 < 0) ||
                                ((balance[j] + s0) * s0 <= 0 && (balance[j] + s1) * s1 <= 0)) {
                                useful = true;
                                break;
                            }
                        }
                    } else {
                        for (size_t j = 0; j < balance.size(); ++j) {
                            if (genotypes[sampleId][p + j] == 1 && balance[j] != 0) {
                                useful = true;
                                break;
                            }
                        }
                    }

                    int sol1 = 0;
                    if (seen[sampleId]) {
                        Sol clone = sols[sol];
                        sols.push_back(std::move(clone));
                        sol1 = (int)sols.size() - 1;
                        Sol& cl = sols[sol1];
                        cl.score += addBalance(cl.balances[2 * sampleId + 1],
                                               cl.balances[2 * sampleId], balance, target);
                        cl.mutationScore = mutationCostOf(cl.balances, cl.trans, p, true, 5);
                        cl.bpNew.push_back(1);
                    }
                    Sol& cur = sols[sol];
                    cur.score += addBalance(cur.balances[2 * sampleId],
                                            cur.balances[2 * sampleId + 1], balance, target);
                    cur.mutationScore = mutationCostOf(cur.balances, cur.trans, p, true, 5);
                    cur.bpNew.push_back(0);

                    if (sol1 && !useful) {
                        if (cur.score + cur.mutationScore >
                            sols[sol1].score + sols[sol1].mutationScore)
                            sols[sol] = sols[sol1];
                        sols.pop_back();
                    }
                }
                seen[sampleId] = 1;

                if ((int)sols.size() > rowLimit) filterSolutions(sols);
            }

            // alternative transmissions where mutations could be avoided
            int solEnd = (int)sols.size();
            for (int i = 0; i < solEnd; ++i) extendSolutions(sols, i, p);
            if ((int)sols.size() > rowLimit) filterSolutions(sols);

            // charge this column's phasing/mutation cost
            for (auto& sol : sols) {
                std::vector<double> firsts(numSamples * 2);
                for (int j = 0; j < numSamples * 2; ++j) firsts[j] = sol.balances[j][0];
                sol.score += optPhasing(firsts, sol.trans, p, false, nullptr, nullptr);
            }

            lastCol.clear();
            std::vector<uint8_t> btVector;
            std::vector<int> tmVector;
            for (auto& sol : sols) {
                // finalize: append bpNew to bp
                sol.bp.insert(sol.bp.end(), sol.bpNew.begin(), sol.bpNew.end());
                mBt[p].push_back(sol.btRow);
                btVector.insert(btVector.end(), sol.bpNew.begin(), sol.bpNew.end());
                for (int j = 0; j < tmBits; ++j) tmVector.push_back((sol.trans >> j) & 1);
                sol.bpNew.clear();
                lastCol.push_back(std::move(sol));
            }
            mBp.emplace_back(numNew, std::move(btVector));
            mTm.push_back(std::move(tmVector));
        }

        // pick the best final solution
        optTrans.assign(n, 0);
        double s = INF;
        int ri = 0;
        for (size_t sol = 0; sol < lastCol.size(); ++sol) {
            if (lastCol[sol].score < s) {
                s = lastCol[sol].score;
                ri = (int)sol;
            }
        }

        // backtracking
        optBipart.assign(m, 0);
        for (int p = n - 1; p >= 0; --p) {
            int offset = startIndex[p];
            int newCount = mBp[p].first;
            for (int i = 0; i < newCount; ++i)
                optBipart[offset + i] = mBp[p].second[newCount * ri + i];
            int v = 0;
            for (int t = tmBits - 1; t >= 0; --t)
                v = (v << 1) + mTm[p][tmBits * ri + t];
            optTrans[p] = v;
            ri = mBt[p][ri];
        }

        // allele votes per position given the final bipartition
        std::vector<std::vector<double>> votes(n, std::vector<double>(2 * numSamples, 0.0));
        for (int rid = 0; rid < m; ++rid) {
            for (int v = varOff[rid]; v < varOff[rid + 1]; ++v) {
                int a = varAllele[v];
                if (a >= 0) {
                    int sid = readSample[rid];
                    votes[varPos[v]][2 * sid + optBipart[rid]] +=
                        (2 * a - 1) * varQual[v];
                }
            }
        }

        // optimal phasing per position
        optHaps.assign(numSamples,
                       std::vector<std::vector<int>>(2, std::vector<int>(n, -1)));
        for (int p = 0; p < n; ++p) {
            std::vector<int> phasing;
            std::vector<uint8_t> mut;
            optPhasing(votes[p], optTrans[p], p, true, &phasing, &mut);
            for (int sid = 0; sid < numSamples; ++sid) {
                optHaps[sid][0][p] = phasing[2 * sid];
                optHaps[sid][1][p] = phasing[2 * sid + 1];
                if (mut[2 * sid]) { mutSample.push_back(sid); mutHap.push_back(0); mutPos.push_back(p); }
                if (mut[2 * sid + 1]) { mutSample.push_back(sid); mutHap.push_back(1); mutPos.push_back(p); }
            }
        }
    }
};

}  // namespace

extern "C" {

// Returns number of mutation events (>= 0) or -1 on error.  Outputs:
//   out_bipart: m bytes; out_trans: n int32;
//   out_haps: numSamples*2*n int32 (sample-major, hap, column);
//   out_mut_*: capacity 2*n*numSamples each.
int32_t wh_pedmec_heuristic(
    int32_t m, int32_t n, int32_t num_samples, int32_t num_trios, int32_t tm_bits,
    int32_t row_limit, int32_t distrust,
    const double* recomb_cost, const double* mutation_cost,
    const int32_t* trios_flat, const int32_t* genotypes_flat,
    const int32_t* read_sample, const int32_t* read_first, const int32_t* read_last,
    const int32_t* var_off, const int32_t* var_pos, const int32_t* var_allele,
    const double* var_qual,
    uint8_t* out_bipart, int32_t* out_trans, int32_t* out_haps,
    int32_t* out_mut_sample, int32_t* out_mut_hap, int32_t* out_mut_pos) {
    if (n <= 0) return 0;
    Engine e;
    e.m = m; e.n = n; e.numSamples = num_samples; e.tmBits = tm_bits;
    e.rowLimit = std::min<int>(row_limit, MAX_ROW_LIMIT);
    e.distrustGenotypes = distrust != 0;
    e.recombCost.assign(recomb_cost, recomb_cost + n);
    e.mutationCost.assign(mutation_cost, mutation_cost + n);
    e.trios.resize(num_trios);
    for (int k = 0; k < num_trios; ++k)
        e.trios[k] = {trios_flat[3 * k], trios_flat[3 * k + 1], trios_flat[3 * k + 2]};
    e.genotypes.resize(num_samples);
    for (int s = 0; s < num_samples; ++s)
        e.genotypes[s].assign(genotypes_flat + s * n, genotypes_flat + (s + 1) * n);
    e.readSample.assign(read_sample, read_sample + m);
    e.readFirst.assign(read_first, read_first + m);
    e.readLast.assign(read_last, read_last + m);
    e.varOff.assign(var_off, var_off + m + 1);
    int nv = m > 0 ? var_off[m] : 0;
    e.varPos.assign(var_pos, var_pos + nv);
    e.varAllele.assign(var_allele, var_allele + nv);
    e.varQual.assign(var_qual, var_qual + nv);

    e.solve();

    for (int i = 0; i < m; ++i) out_bipart[i] = e.optBipart[i];
    for (int p = 0; p < n; ++p) out_trans[p] = e.optTrans[p];
    for (int s = 0; s < num_samples; ++s)
        for (int h = 0; h < 2; ++h)
            for (int p = 0; p < n; ++p)
                out_haps[(s * 2 + h) * n + p] = e.optHaps[s][h][p];
    int nm = (int)e.mutSample.size();
    for (int i = 0; i < nm; ++i) {
        out_mut_sample[i] = e.mutSample[i];
        out_mut_hap[i] = e.mutHap[i];
        out_mut_pos[i] = e.mutPos[i];
    }
    return nm;
}

}  // extern "C"
