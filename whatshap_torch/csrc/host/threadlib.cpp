// Native haplotype-threading DP (HaploThreader).
//
// Exact behavioral mirror of whatshap_torch/polyphase/haplothreader.py (which
// itself has behavior parity with the reference's
// src/polyphase/{haplothreader,tupleconverter}.{h,cpp}): cluster tuples are
// packed 5 bits per haplotype into a uint64, columns are insertion-ordered
// sparse maps keyed by tuple code, and the recursion minimizes coverage cost
// (binomial log-pmf against expected cluster coverage) plus
// permutation-minimal switch cost.  Scores are float (ThreadScore), with
// every intermediate computed in double and rounded exactly where the Python
// rounds through struct.pack("f") — the differential test asserts identical
// paths.
//
// Compile with -ffp-contract=off: FMA contraction would change the double
// arithmetic and break bit-parity with the Python implementation.

#include <cstdint>
#include <cstdio>
#include <cmath>
#include <cfloat>
#include <cstring>
#include <vector>
#include <algorithm>
#include <unordered_map>

namespace {

constexpr int BITS = 5;
constexpr uint64_t MASK = 31;
constexpr int MAX_PLOIDY = 12;  // 64 // 5
constexpr uint64_t INVALID_TUPLE = ~0ULL;

inline int tuple_get(uint64_t t, int i) { return (int)((t >> (i * BITS)) & MASK); }

inline uint64_t tuple_from_ids(const int* ids, int n) {
    uint64_t t = 0;
    for (int i = 0; i < n; i++) t += (uint64_t)ids[i] << (i * BITS);
    return t;
}

inline uint64_t tuple_fingerprint(uint64_t t, int ploidy) {
    int ids[MAX_PLOIDY];
    for (int i = 0; i < ploidy; i++) ids[i] = tuple_get(t, i);
    std::sort(ids, ids + ploidy);
    return tuple_from_ids(ids, ploidy);
}

// ---- binomial log-pmf (mathutils.py / src/binomial.cpp parity) ----

double binom_coeff_log(int n, int k) {
    if (k < 0 || n < 0 || n < k) return 0.0;
    double result = 0.0;
    if (k > n - k) k = n - k;
    double buffer = 1.0;
    for (int i = 0; i < k; i++) {
        double addition = (double)(n - i) / (double)(i + 1);
        if (buffer * addition > DBL_MAX) {
            result += std::log(buffer);
            buffer = addition;
        } else {
            buffer *= addition;
        }
    }
    return result + std::log(buffer);
}

double log_binom_pmf_raw(int n, int k, double p) {
    double logp = p > 0 ? std::log(p) : -INFINITY;
    double log1mp = (1 - p) > 0 ? std::log(1 - p) : -INFINITY;
    double val = binom_coeff_log(n, k);
    if (k != 0) val += (double)k * logp;
    if (n - k != 0) val += (double)(n - k) * log1mp;
    return val;
}

struct PmfKey {
    int n, k;
    uint64_t pbits;
    bool operator==(const PmfKey& o) const {
        return n == o.n && k == o.k && pbits == o.pbits;
    }
};
struct PmfHash {
    size_t operator()(const PmfKey& x) const {
        uint64_t h = (uint64_t)x.n * 0x9E3779B97F4A7C15ULL;
        h ^= (uint64_t)x.k + 0x9E3779B97F4A7C15ULL + (h << 6) + (h >> 2);
        h ^= x.pbits + 0x9E3779B97F4A7C15ULL + (h << 6) + (h >> 2);
        return (size_t)h;
    }
};

struct PmfCache {
    std::unordered_map<PmfKey, double, PmfHash> map;
    double get(int n, int k, double p) {
        uint64_t pb;
        std::memcpy(&pb, &p, 8);
        PmfKey key{n, k, pb};
        auto it = map.find(key);
        if (it != map.end()) return it->second;
        double v = log_binom_pmf_raw(n, k, p);
        map.emplace(key, v);
        return v;
    }
};

// ---- tuple converter (tupleconverter.cpp parity) ----

struct TupleConverter {
    int oldToNew[32], newToOld[32];
    int ploidy;

    TupleConverter(const int* oldC, int nOld, const int* newC, int nNew, int pl)
        : ploidy(pl) {
        for (int i = 0; i < 32; i++) oldToNew[i] = newToOld[i] = -1;
        // dict-comprehension semantics: last match wins
        for (int c = 0; c < nOld && c < 32; c++)
            for (int j = 0; j < nNew; j++)
                if (newC[j] == oldC[c]) oldToNew[c] = j;
        for (int c = 0; c < nNew && c < 32; c++)
            for (int j = 0; j < nOld; j++)
                if (oldC[j] == newC[c]) newToOld[c] = j;
    }

    uint64_t convertNewToOld(uint64_t newTuple) const {
        int v[MAX_PLOIDY];
        for (int i = 0; i < ploidy; i++) {
            int c = tuple_get(newTuple, i);
            if (newToOld[c] < 0) return INVALID_TUPLE;
            v[i] = newToOld[c];
        }
        return tuple_from_ids(v, ploidy);
    }

    uint64_t permuteAgainstOld(uint64_t newTuple, uint64_t oldTuple) const {
        int v[MAX_PLOIDY], u[MAX_PLOIDY], resOld[MAX_PLOIDY];
        int nRes = 0;
        for (int i = 0; i < ploidy; i++) {
            v[i] = tuple_get(newTuple, i);
            u[i] = 0;
        }
        for (int i = 0; i < ploidy; i++) {
            int c = tuple_get(oldTuple, i);
            if (oldToNew[c] >= 0) {
                int d = oldToNew[c];
                for (int j = 0; j < ploidy; j++) {
                    if (v[j] == d) {
                        u[i] = d;
                        v[j] = -1;
                        d = -1;
                        break;
                    }
                }
                if (d >= 0) resOld[nRes++] = i;
            } else {
                resOld[nRes++] = i;
            }
        }
        int resIdx = 0;
        for (int i = 0; i < ploidy; i++)
            if (v[i] >= 0) u[resOld[resIdx++]] = v[i];
        return tuple_from_ids(u, ploidy);
    }
};

// ---- insertion-ordered column (Python dict semantics) ----

struct Entry {
    uint64_t tuple;
    float score;
    uint64_t pred;
};

struct Column {
    std::vector<Entry> entries;               // insertion order
    std::unordered_map<uint64_t, int> index;  // tuple -> entries idx

    void set(uint64_t t, float score, uint64_t pred) {
        auto it = index.find(t);
        if (it != index.end()) {
            entries[it->second].score = score;
            entries[it->second].pred = pred;
        } else {
            index.emplace(t, (int)entries.size());
            entries.push_back({t, score, pred});
        }
    }
    const Entry* get(uint64_t t) const {
        auto it = index.find(t);
        return it == index.end() ? nullptr : &entries[it->second];
    }
};

struct Threader {
    int ploidy;
    double switchCost, affineSwitchCost;
    int maxClusterGap, rowLimit;
    int numVars;
    const int32_t* covOffsets;  // numVars + 1
    const int32_t* covIds;      // global cluster ids, flattened
    const int32_t* covTotals;   // per-(pos, local cluster) total depth
    PmfCache pmf;

    int covSize(int pos) const { return covOffsets[pos + 1] - covOffsets[pos]; }
    const int32_t* covAt(int pos) const { return covIds + covOffsets[pos]; }
    const int32_t* totAt(int pos) const { return covTotals + covOffsets[pos]; }

    int covLookup(int pos, int gid) const {
        // covGlobal[pos].get(gid, 0)
        int n = covSize(pos);
        const int32_t* ids = covAt(pos);
        for (int i = 0; i < n; i++)
            if (ids[i] == gid) return totAt(pos)[i];
        return 0;
    }

    // haplothreader.py _computeCoverage
    void computeCoverage(std::vector<int>& coverage,
                         std::vector<std::vector<int>>& clusterCoverage) {
        coverage.assign(numVars, 0);
        clusterCoverage.assign(numVars, {});
        int half = maxClusterGap / 2;
        for (int pos = 0; pos < numVars; pos++) {
            int total = 0;
            int mx = std::min(numVars - 1, pos + (maxClusterGap + 1) / 2);
            uint32_t mn = (uint32_t)(pos - half);
            if (!(mn < (uint32_t)mx)) mn = 0;
            int n = covSize(pos);
            clusterCoverage[pos].resize(n);
            for (int i = 0; i < n; i++) {
                int gid = covAt(pos)[i];
                int smoothed = 0, nonZero = 0;
                for (uint32_t p = mn; p <= (uint32_t)mx; p++) {
                    int cov = covLookup((int)p, gid);
                    if (cov > 0) {
                        smoothed += cov;
                        nonZero++;
                    }
                }
                if (nonZero == 0) nonZero = 1;
                clusterCoverage[pos][i] = smoothed / nonZero;
                total += clusterCoverage[pos][i];
            }
            coverage[pos] = total;
        }
    }

    // haplothreader.py _computeRelevantTuples (counter enumeration)
    void relevantTuples(int maxElem, std::vector<uint64_t>& out) {
        out.clear();
        int v[MAX_PLOIDY];
        std::memset(v, 0, sizeof(v));
        while (v[ploidy - 1] < maxElem) {
            out.push_back(tuple_from_ids(v, ploidy));
            v[0]++;
            for (int i = 1; i < ploidy; i++)
                if (v[i - 1] >= maxElem) v[i]++;
            for (int i = ploidy - 1; i > 0; i--)
                if (v[i - 1] >= maxElem) v[i - 1] = v[i];
        }
    }

    float coverageCost(uint64_t tup, int coverage, const std::vector<int>& clustCov) {
        double llh = 0.0;
        int unthreaded = 0;
        int mult[32];
        std::memset(mult, 0, sizeof(mult));
        for (int i = 0; i < ploidy; i++) mult[tuple_get(tup, i)]++;
        for (size_t cid = 0; cid < clustCov.size(); cid++) {
            if (mult[cid] == 0) {
                unthreaded += clustCov[cid];
            } else {
                double p = (0.975 * (double)mult[cid]) / (double)ploidy;
                llh += pmf.get(coverage, clustCov[cid], p);
            }
        }
        llh += pmf.get(coverage, unthreaded, 0.025);
        return (float)(-llh);
    }

    float switchCostAllPerms(const int* prevT, int nPrev, const int* curT, int nCur) const {
        int pIdx = 0, cIdx = 0, switches = 0;
        while (pIdx < ploidy && cIdx < ploidy) {
            if (pIdx >= nPrev || cIdx >= nCur) break;  // defensive; sizes == ploidy
            if (prevT[pIdx] == curT[cIdx]) {
                pIdx++;
                cIdx++;
            } else if (prevT[pIdx] < curT[cIdx]) {
                switches++;
                pIdx++;
            } else {
                cIdx++;
            }
        }
        switches += ploidy - pIdx;
        return (float)(switchCost * (double)switches +
                       affineSwitchCost * (double)(switches > 0 ? 1 : 0));
    }

    // sorted global-id vector of a tuple; false if any local id out of range
    bool tupleGlobalSorted(uint64_t t, int pos, int* out) const {
        int n = covSize(pos);
        const int32_t* ids = covAt(pos);
        for (int i = 0; i < ploidy; i++) {
            int c = tuple_get(t, i);
            if (c >= n) return false;
            out[i] = ids[c];
        }
        std::sort(out, out + ploidy);
        return true;
    }

    // returns number of positions threaded; writes global ids to outPath
    int computePaths(int start, int end, int32_t* outPath) {
        std::vector<int> coverage;
        std::vector<std::vector<int>> clusterCoverage;
        computeCoverage(coverage, clusterCoverage);

        std::vector<Column> m;
        int firstUnthreaded = start;
        std::unordered_map<uint64_t, std::vector<int>> sortedGlobalTuples;
        std::vector<uint64_t> tuples;

        for (int pos = start; pos < end; pos++) {
            int offset = pos > start ? 1 : 0;
            relevantTuples(covSize(pos), tuples);
            TupleConverter tc(covAt(pos - offset), covSize(pos - offset),
                              covAt(pos), covSize(pos), ploidy);
            if (tuples.empty()) {
                std::printf("No tuples for position %d. Aborting ...\n", pos);
                break;
            }

            std::vector<float> covCosts(tuples.size());
            float minCovCost = INFINITY;
            for (size_t i = 0; i < tuples.size(); i++) {
                covCosts[i] = coverageCost(tuples[i], coverage[pos], clusterCoverage[pos]);
                if (covCosts[i] < minCovCost) minCovCost = covCosts[i];
            }

            std::unordered_map<uint64_t, uint64_t> fpToTuple;
            std::vector<const Entry*> sortedPreds;
            if (pos > start) {
                const Column& prev = m.back();
                sortedPreds.reserve(prev.entries.size());
                for (const Entry& e : prev.entries) {
                    fpToTuple[tuple_fingerprint(e.tuple, ploidy)] = e.tuple;
                    sortedPreds.push_back(&e);
                }
                std::stable_sort(sortedPreds.begin(), sortedPreds.end(),
                                 [](const Entry* a, const Entry* b) {
                                     return a->score < b->score;
                                 });
            }

            Column column;
            int tupleGlobal[MAX_PLOIDY];
            for (size_t tid = 0; tid < tuples.size(); tid++) {
                uint64_t tuple_ = tuples[tid];
                float cc = covCosts[tid];
                if ((double)cc > 30.0 + (double)minCovCost) continue;
                double optPredScore = INFINITY;
                uint64_t optPredTuple = INVALID_TUPLE;
                tupleGlobalSorted(tuple_, pos, tupleGlobal);

                if (!fpToTuple.empty()) {
                    uint64_t fp = tuple_fingerprint(tc.convertNewToOld(tuple_), ploidy);
                    auto fit = fpToTuple.find(fp);
                    if (fit != fpToTuple.end()) {
                        optPredTuple = fit->second;
                        const Entry* pe = m.back().get(optPredTuple);
                        if (pe) optPredScore = (double)pe->score;
                    }
                    for (const Entry* pe : sortedPreds) {
                        if ((double)pe->score + switchCost + affineSwitchCost >= optPredScore)
                            break;
                        auto git = sortedGlobalTuples.find(pe->tuple);
                        const int* pg = nullptr;
                        int npg = 0;
                        if (git != sortedGlobalTuples.end()) {
                            pg = git->second.data();
                            npg = (int)git->second.size();
                        }
                        double s = (double)(float)((double)pe->score +
                                                   (double)switchCostAllPerms(
                                                       pg, npg, tupleGlobal, ploidy));
                        if (s < optPredScore) {
                            optPredScore = s;
                            optPredTuple = pe->tuple;
                        }
                    }
                } else {
                    optPredScore = 0.0;
                    optPredTuple = tuple_;
                }

                uint64_t bestPerm = tc.permuteAgainstOld(tuple_, optPredTuple);
                if (std::isinf(optPredScore) || std::isnan(optPredScore))
                    std::printf("Invalid pred score of %f for tuple at position %d\n",
                                optPredScore, pos);
                column.set(bestPerm, (float)(optPredScore + (double)cc), optPredTuple);
                firstUnthreaded = pos + 1;
            }

            sortedGlobalTuples.clear();
            for (const Entry& e : column.entries) {
                std::vector<int> g(ploidy);
                int n = covSize(pos);
                const int32_t* ids = covAt(pos);
                bool ok = true;
                for (int i = 0; i < ploidy; i++) {
                    int c = tuple_get(e.tuple, i);
                    if (c >= n) {
                        ok = false;
                        break;
                    }
                    g[i] = ids[c];
                }
                if (!ok) g.clear();
                std::sort(g.begin(), g.end());
                sortedGlobalTuples[e.tuple] = std::move(g);
            }

            if (rowLimit > 0 && (int)column.entries.size() >= rowLimit) {
                // stable rank by score, drop everything past rowLimit while
                // preserving the insertion order of the survivors
                std::vector<int> order(column.entries.size());
                for (size_t i = 0; i < order.size(); i++) order[i] = (int)i;
                std::stable_sort(order.begin(), order.end(),
                                 [&](int a, int b) {
                                     return column.entries[a].score <
                                            column.entries[b].score;
                                 });
                std::vector<char> keep(column.entries.size(), 0);
                for (int r = 0; r < rowLimit; r++) keep[order[r]] = 1;
                Column pruned;
                for (size_t i = 0; i < column.entries.size(); i++)
                    if (keep[i])
                        pruned.set(column.entries[i].tuple, column.entries[i].score,
                                   column.entries[i].pred);
                column = std::move(pruned);
            }

            m.push_back(std::move(column));
        }

        // backtracking
        if (m.empty()) return 0;
        uint64_t currentRow = INVALID_TUPLE;
        float minimum = INFINITY;
        const Column& last = m[firstUnthreaded - 1 - start];
        for (const Entry& e : last.entries) {
            if (e.score < minimum) {
                minimum = e.score;
                currentRow = e.tuple;
            }
        }
        int L = firstUnthreaded - start;
        if (currentRow == INVALID_TUPLE) {
            std::printf("No minimum among %d entries in last threaded column!\n",
                        (int)last.entries.size());
            return 0;
        }
        // write back to front
        int vec[MAX_PLOIDY];
        auto writeVec = new int32_t[(size_t)L * ploidy];
        {
            int p = firstUnthreaded - 1;
            bool ok = true;
            int n = covSize(p);
            const int32_t* ids = covAt(p);
            for (int i = 0; i < ploidy; i++) {
                int c = tuple_get(currentRow, i);
                if (c >= n) {
                    ok = false;
                    break;
                }
                vec[i] = ids[c];
            }
            if (!ok)
                for (int i = 0; i < ploidy; i++) vec[i] = 0;
            for (int i = 0; i < ploidy; i++)
                writeVec[(size_t)(L - 1) * ploidy + i] = vec[i];
        }
        for (int pos = firstUnthreaded - 1; pos > start; pos--) {
            const Entry* e = m[pos - start].get(currentRow);
            if (!e) {
                std::printf("Backtrack miss at position %d\n", pos);
                break;
            }
            currentRow = e->pred;
            int p = pos - 1;
            int n = covSize(p);
            const int32_t* ids = covAt(p);
            bool ok = true;
            for (int i = 0; i < ploidy; i++) {
                int c = tuple_get(currentRow, i);
                if (c >= n) {
                    ok = false;
                    break;
                }
                vec[i] = ids[c];
            }
            if (!ok) {
                std::printf("Empty cluster tuple at position %d\n", p);
                for (int i = 0; i < ploidy; i++) vec[i] = 0;
            }
            for (int i = 0; i < ploidy; i++)
                writeVec[(size_t)(p - start) * ploidy + i] = vec[i];
        }
        std::memcpy(outPath, writeVec, (size_t)L * ploidy * sizeof(int32_t));
        delete[] writeVec;
        return L;
    }
};

}  // namespace

extern "C" int32_t wh_thread_paths(
    int32_t numVars, int32_t ploidy, double switchCost, double affineSwitchCost,
    int32_t maxClusterGap, int32_t rowLimit,
    const int32_t* blockStarts, int32_t numBlocks,
    const int32_t* covOffsets, const int32_t* covIds, const int32_t* covTotals,
    int32_t* outPath) {
    if (ploidy < 1 || ploidy > MAX_PLOIDY) return -1;
    Threader th;
    th.ploidy = ploidy;
    th.switchCost = switchCost;
    th.affineSwitchCost = affineSwitchCost;
    th.maxClusterGap = maxClusterGap;
    th.rowLimit = rowLimit;
    th.numVars = numVars;
    th.covOffsets = covOffsets;
    th.covIds = covIds;
    th.covTotals = covTotals;

    int written = 0;
    for (int b = 0; b < numBlocks; b++) {
        int start = blockStarts[b];
        int end = b == numBlocks - 1 ? numVars : blockStarts[b + 1];
        if (end > start)
            written += th.computePaths(start, end, outPath + (size_t)written * ploidy);
    }
    return written;
}
