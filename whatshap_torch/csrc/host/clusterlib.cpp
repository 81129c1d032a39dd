// Native cluster-editing engine for the polyploid pipeline.
//
// This is a C++ translation of whatshap_torch/polyphase/clusterediting.py
// (which itself carries behavior parity with the reference heuristic,
// including its tie-breaking and float32 arithmetic).  The Python module
// remains the semantic source of truth and plain version; differential tests
// assert both produce identical clusterings.
//
// Entry point (ctypes): wh_cluster_run(n_nodes, n_edges, us, vs, ws,
// bundle_edges, out_nodes, out_offsets) -> n_clusters.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <set>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

const float FORBIDDEN = -std::numeric_limits<float>::infinity();
const float PERMANENT = std::numeric_limits<float>::infinity();

inline uint64_t ekey(int u, int v) {
    if (u > v) std::swap(u, v);
    return (uint64_t)u << 32 | (uint32_t)v;
}


// sorted flat small-set: iterates ascending exactly like std::set<int>,
// but inserts/lookups are binary searches over a contiguous vector (the
// per-clique forbidden sets are small, so this beats the tree by a large
// constant in setForbidden, the profile's hottest graph operation)
struct FlatSet {
    std::vector<int> v;
    bool count(int x) const {
        return std::binary_search(v.begin(), v.end(), x);
    }
    void insert(int x) {
        auto it = std::lower_bound(v.begin(), v.end(), x);
        if (it == v.end() || *it != x) v.insert(it, x);
    }
    void erase(int x) {
        auto it = std::lower_bound(v.begin(), v.end(), x);
        if (it != v.end() && *it == x) v.erase(it);
    }
    void clear() { v.clear(); }
    void merge_from(const FlatSet& other) {
        if (other.v.empty()) return;
        std::vector<int> out;
        out.reserve(v.size() + other.v.size());
        std::set_union(v.begin(), v.end(), other.v.begin(), other.v.end(),
                       std::back_inserter(out));
        v.swap(out);
    }
    std::vector<int>::const_iterator begin() const { return v.begin(); }
    std::vector<int>::const_iterator end() const { return v.end(); }
};

struct Graph {
    int n = 0;
    std::unordered_map<uint64_t, int> rank;  // (u,v) -> rank id (1-based; sparse fallback only)
    // the reference quirk in setPermanent's second loop probes an
    // edge-id->rank map with a RANK as the key; it is never mutated after
    // construction, so the probe collapses to a static per-rank boolean
    std::vector<char> rank_quirk_hit;
    std::vector<float> weight;               // rank -> weight; [0] = 0
    std::vector<std::pair<int, int>> edges;  // rank -> (u, v)
    std::vector<std::vector<int>> unpruned, nonzero, cliques;
    std::vector<int> cliqueOf;
    std::vector<FlatSet> forbidden;          // ordered for determinism

    // Dense (u, v) -> (rank, weight) matrix: the edge set is static after
    // construction, and findIndex dominates the triangle enumeration in
    // init() and every induced-cost update, so an O(1) array lookup beats
    // the hash map by a large constant.  Packing the weight next to the
    // rank makes the triple-update loops one cache access instead of two
    // (rankMat hit + random weight[] hit).  Falls back to the hash for
    // node counts whose n^2 matrix would be unreasonable.
    struct Cell {
        int r;
        float w;
    };
    std::vector<Cell> cellMat;
    bool dense = false;

    void buildIndex() {
        if ((long long)n * n > (64LL << 20)) return;  // > 512 MB: keep hash
        cellMat.assign((size_t)n * n, {0, 0.0f});
        for (size_t r = 1; r < edges.size(); ++r) {
            int u = edges[r].first, v = edges[r].second;
            Cell c{(int)r, weight[r]};
            cellMat[(size_t)u * n + v] = c;
            cellMat[(size_t)v * n + u] = c;
        }
        dense = true;
    }

    int findIndex(int u, int v) const {
        if (dense) return cellMat[(size_t)u * n + v].r;
        auto it = rank.find(ekey(u, v));
        return it == rank.end() ? 0 : it->second;
    }

    // (rank, weight) in one lookup; only valid on the dense path
    Cell cellAt(int u, int v) const { return cellMat[(size_t)u * n + v]; }

    // static adjacency (rank != 0 neighbors) in CSR form, built once: the
    // edge set never grows, so "does an edge exist between x and y" scans
    // can iterate deg(x) neighbors instead of probing every clique pair
    std::vector<int64_t> adjOff;
    std::vector<int> adjNb;

    void buildAdj() {
        adjOff.assign((size_t)n + 1, 0);
        for (size_t r = 1; r < edges.size(); ++r) {
            ++adjOff[(size_t)edges[r].first + 1];
            ++adjOff[(size_t)edges[r].second + 1];
        }
        for (int i = 0; i < n; ++i) adjOff[i + 1] += adjOff[i];
        adjNb.resize(adjOff[n]);
        std::vector<int64_t> cur(adjOff.begin(), adjOff.end() - 1);
        for (size_t r = 1; r < edges.size(); ++r) {
            adjNb[cur[edges[r].first]++] = edges[r].second;
            adjNb[cur[edges[r].second]++] = edges[r].first;
        }
    }

    void mirrorWeight(int u, int v, float w) {
        if (!dense) return;
        cellMat[(size_t)u * n + v].w = w;
        cellMat[(size_t)v * n + u].w = w;
    }

    static bool removeFromVector(std::vector<int>& vec, int v) {
        for (size_t i = 0; i < vec.size(); ++i)
            if (vec[i] == v) {
                vec[i] = vec.back();
                vec.pop_back();
                return true;
            }
        return false;
    }

    void refresh(int u, int v, float oldW, float newW) {
        bool oldPruned = oldW == FORBIDDEN || oldW == PERMANENT || oldW == 0.0f;
        bool newPruned = newW == FORBIDDEN || newW == PERMANENT || newW == 0.0f;
        if (oldPruned && !newPruned) {
            unpruned[u].push_back(v);
            unpruned[v].push_back(u);
        } else if (!oldPruned && newPruned) {
            removeFromVector(unpruned[u], v);
            removeFromVector(unpruned[v], u);
        }
        if (oldW == 0.0f && newW != 0.0f) {
            nonzero[u].push_back(v);
            nonzero[v].push_back(u);
        } else if (oldW != 0.0f && newW == 0.0f) {
            removeFromVector(nonzero[u], v);
            removeFromVector(nonzero[v], u);
        }
    }

    void setPermanent(int u, int v, int r) {
        int cu = cliqueOf[u], cv = cliqueOf[v];
        if (forbidden[cu].count(cv)) return;
        int merged, discarded;
        if (cliques[cu].size() < cliques[cv].size()) {
            merged = cv;
            discarded = cu;
        } else {
            merged = cu;
            discarded = cv;
        }
        if (merged != discarded) {
            auto& cd = cliques[discarded];
            for (int d : cd) cliqueOf[d] = merged;
            cliques[merged].insert(cliques[merged].end(), cd.begin(), cd.end());
            cd.clear();
            for (int f : forbidden[discarded]) {
                forbidden[f].insert(merged);
                forbidden[f].erase(discarded);
            }
            // both sides are sorted: one-pass union instead of per-element
            // binary-search inserts
            forbidden[merged].merge_from(forbidden[discarded]);
            forbidden[discarded].clear();
        }
        refresh(u, v, weight[r], PERMANENT);
        if (r > 0) {
            weight[r] = PERMANENT;
            mirrorWeight(edges[r].first, edges[r].second, PERMANENT);
        }
    }

    void setForbidden(int u, int v, int r) {
        int cu = cliqueOf[u], cv = cliqueOf[v];
        if (cu == cv) return;
        forbidden[cu].insert(cv);
        forbidden[cv].insert(cu);
        refresh(u, v, weight[r], FORBIDDEN);
        if (r > 0) {
            weight[r] = FORBIDDEN;
            mirrorWeight(edges[r].first, edges[r].second, FORBIDDEN);
        }
    }
};

struct Heap {
    Graph& g;
    long long unprocessed = 0;
    std::vector<std::pair<int, int>> edges;  // rank -> (u,v)
    std::vector<float> icf, icp;
    // Max-heaps packed as (score, edge) nodes: sift comparisons read the
    // node-local score copy instead of chasing icf[heap[x]] through two
    // random accesses (the sift is the hottest memory path of the whole
    // heuristic).  Every icf/icp mutation refreshes the owning node's copy
    // — including the bundle merge, which (matching the reference) adjusts
    // the score WITHOUT re-sifting — so comparison values are always the
    // fresh scores and the heap layout evolves exactly as with indirect
    // lookups.
    struct Node {
        float s;
        int e;
    };
    std::vector<Node> forb_heap, perm_heap;
    std::vector<int> edge2forb, edge2perm;
    std::vector<int> edgeToBundle;
    std::vector<std::vector<int>> edgeBundles;

    explicit Heap(Graph& graph) : g(graph) {
        size_t n = g.weight.size();
        edges.assign(n, {-1, -1});
        icf.assign(n, FORBIDDEN);
        icp.assign(n, FORBIDDEN);
        edge2forb.assign(n, 0);
        edge2perm.assign(n, 0);
        edgeToBundle.resize(n);
        edgeBundles.resize(n);
        for (size_t i = 0; i < n; ++i) {
            edgeToBundle[i] = (int)i;
            edgeBundles[i] = {(int)i};
        }
    }

    void init() {
        std::vector<std::vector<int>> higher(g.n);
        for (int u = 0; u < g.n; ++u) {
            for (int v : g.nonzero[u]) {
                if (v < u) continue;
                int rId = g.findIndex(u, v);
                edges[rId] = {u, v};
                icf[rId] = 0.0f;
                icp[rId] = 0.0f;
                float w = g.weight[rId];
                if (w == 0.0f || w == FORBIDDEN || w == PERMANENT) continue;
                ++unprocessed;
                higher[u].push_back(v);
                if (w >= 0)
                    icf[rId] += w;
                else
                    icp[rId] += -w;
            }
            std::sort(higher[u].begin(), higher[u].end());
        }
        // bitset mirror of `higher` for the triangle enumeration: the
        // common-neighbor set of an edge is a word-wise AND, and iterating
        // its set bits ascending visits exactly the same w's in exactly the
        // same order as the sorted-vector set_intersection did (so every
        // float accumulation below happens in the identical order)
        size_t words = ((size_t)g.n + 63) / 64;
        std::vector<uint64_t> bits((size_t)g.n * words, 0);
        for (int u = 0; u < g.n; ++u)
            for (int v : higher[u]) bits[(size_t)u * words + (size_t)v / 64] |= 1ull << (v % 64);
        std::vector<int> ws;  // intersection scratch, reused across edges
        for (int u = 0; u < g.n; ++u) {
            auto& hu = higher[u];
            const uint64_t* bu = &bits[(size_t)u * words];
            for (size_t i = 0; i < hu.size(); ++i) {
                int v = hu[i];
                int rUV = g.findIndex(u, v);
                float w_uv = g.weight[rUV];
                ws.clear();
                const uint64_t* bv = &bits[(size_t)v * words];
                // elements of hu past v intersected with higher[v]; bits
                // of bv are all > v, so masking bu from bit v+1 up suffices
                size_t w0 = (size_t)v / 64;
                uint64_t first_mask = ~0ull << (v % 64) << 1;  // bits > v
                for (size_t wi = w0; wi < words; ++wi) {
                    uint64_t m = bu[wi] & bv[wi];
                    if (wi == w0) m &= first_mask;
                    while (m) {
                        int b = __builtin_ctzll(m);
                        m &= m - 1;
                        ws.push_back((int)(wi * 64 + b));
                    }
                }
                for (int w : ws) {
                    int rUW, rVW;
                    float w_uw, w_vw;
                    if (g.dense) {
                        Graph::Cell cu = g.cellAt(u, w), cv = g.cellAt(v, w);
                        rUW = cu.r;
                        w_uw = cu.w;
                        rVW = cv.r;
                        w_vw = cv.w;
                    } else {
                        rUW = g.findIndex(u, w);
                        rVW = g.findIndex(v, w);
                        w_uw = g.weight[rUW];
                        w_vw = g.weight[rVW];
                    }
                    icf[rUV] += icf_triple(w_uw, w_vw);
                    icp[rUV] += icp_triple(w_uw, w_vw);
                    icf[rUW] += icf_triple(w_uv, w_vw);
                    icp[rUW] += icp_triple(w_uv, w_vw);
                    icf[rVW] += icf_triple(w_uv, w_uw);
                    icp[rVW] += icp_triple(w_uv, w_uw);
                }
            }
        }
        size_t n = icf.size();
        // descending-by-score with ties in ascending index == what a
        // stable_sort over `score[a] > score[b]` produces (Python's
        // sorted()); packing (inverted total-order float bits, index) into
        // one uint64 gives the identical permutation with a plain sort.
        // Scores here are never NaN and never -0.0 (they accumulate
        // non-negative terms from 0.0f, or are the -inf sentinel), so the
        // bit-level float order coincides with the arithmetic order.
        auto packDesc = [](float f, uint32_t idx) -> uint64_t {
            uint32_t b;
            std::memcpy(&b, &f, 4);
            uint32_t m = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
            return ((uint64_t)(~m) << 32) | idx;
        };
        std::vector<uint64_t> keys(n);
        for (size_t i = 0; i < n; ++i) keys[i] = packDesc(icf[i], (uint32_t)i);
        std::sort(keys.begin(), keys.end());
        forb_heap.resize(n);
        for (size_t i = 0; i < n; ++i) {
            int e = (int)(uint32_t)keys[i];
            forb_heap[i] = {icf[e], e};
            edge2forb[e] = (int)i;
        }
        for (size_t i = 0; i < n; ++i) keys[i] = packDesc(icp[i], (uint32_t)i);
        std::sort(keys.begin(), keys.end());
        perm_heap.resize(n);
        for (size_t i = 0; i < n; ++i) {
            int e = (int)(uint32_t)keys[i];
            perm_heap[i] = {icp[e], e};
            edge2perm[e] = (int)i;
        }
    }

    static inline float icf_triple(float uw, float vw) {
        if (uw > 0 && vw > 0) return std::min(uw, vw);
        return 0.0f;
    }
    static inline float icp_triple(float uw, float vw) {
        if (uw < 0 && vw > 0) return std::min(vw, -uw);
        if (uw > 0 && vw < 0) return std::min(-vw, uw);
        return 0.0f;
    }

    int maxIcfEdge() const {
        if (forb_heap.size() <= 1) return -1;
        int ei = forb_heap[0].e;
        if (icf[ei] < 0) return -1;
        return ei;
    }
    int maxIcpEdge() const {
        if (perm_heap.size() <= 1) return -1;
        int ei = perm_heap[0].e;
        if (icp[ei] < 0) return -1;
        return ei;
    }

    float getIcf(int rId) const { return icf[edgeToBundle[rId]]; }
    float getIcp(int rId) const { return icp[edgeToBundle[rId]]; }

    void increaseIcf(int rId, float w) {
        if (rId > 0 && icf[edgeToBundle[rId]] >= 0) {
            int eb = edgeToBundle[rId];
            icf[eb] = std::max(icf[eb] + w, 0.0f);
            update(forb_heap, eb, w, edge2forb, icf[eb]);
        }
    }
    void increaseIcp(int rId, float w) {
        if (rId > 0 && icp[edgeToBundle[rId]] >= 0) {
            int eb = edgeToBundle[rId];
            icp[eb] = std::max(icp[eb] + w, 0.0f);
            update(perm_heap, eb, w, edge2perm, icp[eb]);
        }
    }

    void mergeEdges(int r1, int r2) {
        if ((r1 & r2) == 0) return;  // reference quirk: bitwise AND
        int eb1 = edgeToBundle[r1], eb2 = edgeToBundle[r2];
        if (eb1 == eb2) return;
        int src, dst;
        if (edgeBundles[eb1].size() > edgeBundles[eb2].size()) {
            src = eb2;
            dst = eb1;
        } else {
            src = eb1;
            dst = eb2;
        }
        for (int d : edgeBundles[src]) {
            edgeBundles[dst].push_back(d);
            edgeToBundle[d] = dst;
        }
        edgeBundles[src].clear();
        if (icf[src] >= 0.0f) {
            icf[dst] += icf[src];
            forb_heap[edge2forb[dst]].s = icf[dst];  // refresh, no sift
        }
        if (icp[src] >= 0.0f) {
            icp[dst] += icp[src];
            perm_heap[edge2perm[dst]].s = icp[dst];
        }
        removeEdge(src);
    }

    void removeEdge(int rId) {
        if (rId == 0) return;
        if (icf[rId] != FORBIDDEN && icp[rId] != FORBIDDEN) {
            icf[rId] = FORBIDDEN;
            icp[rId] = FORBIDDEN;
            update(forb_heap, rId, FORBIDDEN, edge2forb, FORBIDDEN);
            update(perm_heap, rId, FORBIDDEN, edge2perm, FORBIDDEN);
            --unprocessed;
        }
    }

    void update(std::vector<Node>& heap, int e, float change, std::vector<int>& index,
                float newScore) {
        size_t pos = index[e];
        size_t n = heap.size();
        heap[pos].s = newScore;
        if (change > 0) {
            size_t parent = pos > 0 ? (pos - 1) / 2 : 0;
            while (pos > 0 && heap[parent].s < heap[pos].s) {
                std::swap(heap[pos], heap[parent]);
                index[heap[pos].e] = (int)pos;
                index[heap[parent].e] = (int)parent;
                pos = parent;
                parent = pos > 0 ? (pos - 1) / 2 : 0;
            }
        } else {
            for (;;) {
                size_t l = 2 * pos + 1 < n ? 2 * pos + 1 : pos;
                size_t r = 2 * pos + 2 < n ? 2 * pos + 2 : pos;
                size_t nxt = heap[r].s <= heap[l].s ? l : r;
                if (!(heap[pos].s < heap[nxt].s)) break;
                std::swap(heap[pos], heap[nxt]);
                index[heap[pos].e] = (int)pos;
                index[heap[nxt].e] = (int)nxt;
                pos = nxt;
            }
        }
    }
};

struct Solver {
    Graph g;
    Heap heap;
    bool bundleEdges;
    float totalCost = 0.0f;
    bool infeasible = false;
    std::vector<std::pair<int, int>> impl_scratch, implforb_scratch;
    std::vector<int> forb_scratch;
    // clique-membership stamps for the adjacency-driven implication scan
    std::vector<int> stamp_ver_, stamp_pos_;
    int ver_ = 0;
    std::vector<std::pair<int, int>> match_scratch;

    // All existing edges {x, y} with x in CU, y in CV, emitted in exactly
    // the order of the nested clique loops (x in CU order, y in CV order).
    // Small cross-products probe the dense cell matrix directly; large
    // ones (end-game cliques) switch to scanning each x's static adjacency
    // against CV membership stamps — sum(deg(x)) + |CV| work instead of
    // |CU| * |CV| probes.  Skips the (u, v) pair itself like the original.
    void collectImplications(const std::vector<int>& CU, const std::vector<int>& CV,
                             int u, int v, std::vector<std::pair<int, int>>& out) {
        size_t nested_cost = CU.size() * CV.size();
        size_t adj_cost = CV.size();
        for (int x : CU) adj_cost += (size_t)(g.adjOff[x + 1] - g.adjOff[x]);
        if (nested_cost <= adj_cost || g.adjOff.empty()) {
            for (int x : CU)
                for (int y : CV) {
                    if (x == y) continue;
                    if (g.findIndex(x, y) == 0 || (x == u && y == v)) continue;
                    out.push_back({std::min(x, y), std::max(x, y)});
                }
            return;
        }
        ++ver_;
        for (size_t j = 0; j < CV.size(); ++j) {
            stamp_ver_[CV[j]] = ver_;
            stamp_pos_[CV[j]] = (int)j;
        }
        for (int x : CU) {
            auto& matches = match_scratch;
            matches.clear();
            for (int64_t e = g.adjOff[x]; e < g.adjOff[x + 1]; ++e) {
                int y = g.adjNb[e];
                if (stamp_ver_[y] == ver_) matches.push_back({stamp_pos_[y], y});
            }
            std::sort(matches.begin(), matches.end());
            for (auto& m : matches) {
                int y = m.second;
                if (x == u && y == v) continue;
                out.push_back({std::min(x, y), std::max(x, y)});
            }
        }
    }

    Solver(Graph&& graph, bool bundle) : g(std::move(graph)), heap(g), bundleEdges(bundle) {
        stamp_ver_.assign(g.n, 0);
        stamp_pos_.assign(g.n, 0);
        if (g.adjOff.empty()) g.buildAdj();
        heap.init();
        if (!resolvePermanentForbidden()) infeasible = true;
    }

    bool resolvePermanentForbidden() {
        std::vector<char> processed(g.n, 0);
        std::vector<std::vector<int>> cliques;
        for (int u = 0; u < g.n; ++u) {
            if (processed[u]) continue;
            std::vector<int> clique;
            std::vector<int> q{u};
            processed[u] = 1;
            while (!q.empty()) {
                int cur = q.front();
                q.erase(q.begin());
                clique.push_back(cur);
                for (int v : g.cliques[g.cliqueOf[cur]])
                    if (!processed[v]) {
                        q.push_back(v);
                        processed[v] = 1;
                    }
            }
            cliques.push_back(clique);
            for (size_t i = 0; i < clique.size(); ++i)
                for (size_t j = i + 1; j < clique.size(); ++j) {
                    int r = g.findIndex(clique[i], clique[j]);
                    float w = g.weight[r];
                    if (w == FORBIDDEN) return false;
                    heap.removeEdge(r);
                    if (w < 0.0f) totalCost -= w;
                    if (w != PERMANENT && r != 0)
                        g.setPermanent(std::min(clique[i], clique[j]),
                                       std::max(clique[i], clique[j]), r);
                }
        }
        for (size_t k = 0; k < cliques.size(); ++k)
            for (size_t l = k + 1; l < cliques.size(); ++l) {
                bool found = false;
                for (int x : cliques[k]) {
                    if (found) break;
                    for (int y : cliques[l]) {
                        if (x == y) continue;
                        if (g.weight[g.findIndex(x, y)] == FORBIDDEN) {
                            found = true;
                            break;
                        }
                    }
                }
                if (found)
                    for (int x : cliques[k])
                        for (int y : cliques[l]) {
                            int r = g.findIndex(x, y);
                            heap.removeEdge(r);
                            float w = g.weight[r];
                            if (w > 0.0f) totalCost += w;
                            if (w != FORBIDDEN && r != 0)
                                g.setForbidden(std::min(x, y), std::max(x, y), r);
                        }
            }
        return true;
    }

    // The (other-pair, third-edge) induced-cost deltas; the third edge's
    // rank is looked up only when a delta is nonzero (both deltas vanish
    // for whole classes of weight-sign pairs — e.g. forbidding over a
    // negative-negative pair — and the rank lookup plus the two heap-guard
    // loads are the bulk of the per-triple cost).
    inline void updateTripleForbidden(float uv, int a, int b, float vw) {
        float icfC = 0.0f - Heap::icf_triple(uv, vw);
        float icpC = (vw > 0 ? vw : 0.0f) - Heap::icp_triple(uv, vw);
        if (icfC == 0 && icpC == 0) return;
        int r_uw = g.findIndex(a, b);
        if (icfC != 0) heap.increaseIcf(r_uw, icfC);
        if (icpC != 0) heap.increaseIcp(r_uw, icpC);
    }
    inline void updateTriplePermanent(float uv, int a, int b, float vw) {
        float icfC = (vw > 0 ? vw : 0.0f) - Heap::icf_triple(uv, vw);
        float icpC = (vw < 0 ? -vw : 0.0f) - Heap::icp_triple(uv, vw);
        if (icfC == 0 && icpC == 0) return;
        int r_uw = g.findIndex(a, b);
        if (icfC != 0) heap.increaseIcf(r_uw, icfC);
        if (icpC != 0) heap.increaseIcp(r_uw, icpC);
    }

    void setForbidden(int u, int v) {
        int rid = g.findIndex(u, v);
        float uv = g.weight[rid];
        // uv == FORBIDDEN makes every triple delta exactly zero (icf_triple
        // needs uv > 0; icp_triple saturates at vw), so the neighbor scans
        // are pure no-ops — skip them, keep the clique bookkeeping below.
        // Iterating unpruned[...] directly is safe: nothing below mutates
        // the graph until g.setForbidden after both loops (the heap updates
        // only touch icf/icp), so no snapshot copy is needed.
        if (uv != FORBIDDEN) {
            for (int w : g.unpruned[u]) {
                if (w == v) continue;
                if (g.dense) {
                    Graph::Cell c = g.cellAt(v, w);
                    if (c.r > 0) updateTripleForbidden(uv, u, w, c.w);
                } else {
                    int r = g.findIndex(v, w);
                    if (r > 0) updateTripleForbidden(uv, u, w, g.weight[r]);
                }
            }
            for (int w : g.unpruned[v]) {
                if (w == u) continue;
                if (g.dense) {
                    Graph::Cell c = g.cellAt(u, w);
                    if (c.r > 0) updateTripleForbidden(uv, v, w, c.w);
                } else {
                    int r = g.findIndex(u, w);
                    if (r > 0) updateTripleForbidden(uv, v, w, g.weight[r]);
                }
            }
        }
        if (uv > 0) totalCost += uv;
        if (rid > 0) g.setForbidden(u, v, rid);
    }

    void setPermanent(int u, int v) {
        int rid = g.findIndex(u, v);
        float uv = g.weight[rid];
        // uv == PERMANENT: every triple delta is exactly zero (both
        // *_triple saturate at the finite vw term) — skip the scans.
        // Direct iteration is safe for the same reason as in setForbidden.
        if (uv != PERMANENT) {
            for (int w : g.unpruned[u]) {
                if (w == v) continue;
                if (g.dense) {
                    Graph::Cell c = g.cellAt(v, w);
                    if (c.r > 0) updateTriplePermanent(uv, u, w, c.w);
                } else {
                    int r = g.findIndex(v, w);
                    if (r > 0) updateTriplePermanent(uv, u, w, g.weight[r]);
                }
            }
            for (int w : g.unpruned[v]) {
                if (w == u) continue;
                int r = g.dense ? g.cellAt(u, w).r : g.findIndex(u, w);
                // reference quirk: the second loop checks findIndex of the
                // RANK treated as an edge id
                if (r >= 0 && (size_t)r < g.rank_quirk_hit.size() && g.rank_quirk_hit[r])
                    updateTriplePermanent(uv, v, w, g.weight[r]);
            }
        }
        if (uv < 0) totalCost -= uv;
        if (rid > 0) g.setPermanent(u, v, rid);
    }

    void choosePermanentEdge(int u, int v) {
        std::vector<std::pair<int, int>>& implications = impl_scratch;
        implications.clear();
        collectImplications(g.cliques[g.cliqueOf[u]], g.cliques[g.cliqueOf[v]], u, v,
                            implications);
        std::vector<std::pair<int, int>>& implForb = implforb_scratch;
        implForb.clear();
        auto forbNbrs = [this](int node) -> const std::vector<int>& {
            forb_scratch.clear();
            for (int fc : g.forbidden[g.cliqueOf[node]])
                for (int fn : g.cliques[fc]) forb_scratch.push_back(fn);
            return forb_scratch;
        };
        for (int f : forbNbrs(u)) {
            if (g.forbidden[g.cliqueOf[v]].count(g.cliqueOf[f])) continue;
            for (int x : g.cliques[g.cliqueOf[v]]) {
                int a = std::min(f, x), b = std::max(f, x);
                if (g.findIndex(a, b) != 0 &&
                    !g.forbidden[g.cliqueOf[a]].count(g.cliqueOf[b]))
                    implForb.push_back({a, b});
            }
        }
        for (int f : forbNbrs(v)) {
            if (g.forbidden[g.cliqueOf[u]].count(g.cliqueOf[f])) continue;
            for (int x : g.cliques[g.cliqueOf[u]]) {
                int a = std::min(f, x), b = std::max(f, x);
                if (g.findIndex(a, b) != 0 &&
                    !g.forbidden[g.cliqueOf[a]].count(g.cliqueOf[b]))
                    implForb.push_back({a, b});
            }
        }
        setPermanent(u, v);
        heap.removeEdge(g.findIndex(u, v));
        for (auto& e : implications) {
            setPermanent(e.first, e.second);
            heap.removeEdge(g.findIndex(e.first, e.second));
        }
        for (auto& e : implForb) {
            setForbidden(e.first, e.second);
            heap.removeEdge(g.findIndex(e.first, e.second));
        }
        if (bundleEdges) {
            std::unordered_map<int, int> cliqueToRep;  // clique -> rank of representative
            std::vector<int> uClique = g.cliques[g.cliqueOf[u]];
            const auto& vc = g.cliques[g.cliqueOf[v]];
            uClique.insert(uClique.end(), vc.begin(), vc.end());
            std::unordered_set<int> uSet(uClique.begin(), uClique.end());
            for (int x : uClique) {
                std::vector<int> nb = g.unpruned[x];
                for (int xn : nb) {
                    if (uSet.count(xn)) continue;
                    int rex = g.findIndex(x, xn);
                    if (rex == 0) continue;
                    int cxn = g.cliqueOf[xn];
                    auto it = cliqueToRep.find(cxn);
                    if (it == cliqueToRep.end())
                        cliqueToRep[cxn] = rex;
                    else
                        heap.mergeEdges(rex, it->second);
                }
            }
        }
    }

    void chooseForbiddenEdge(int u, int v) {
        std::vector<std::pair<int, int>>& implications = impl_scratch;
        implications.clear();
        collectImplications(g.cliques[g.cliqueOf[u]], g.cliques[g.cliqueOf[v]], u, v,
                            implications);
        setForbidden(u, v);
        heap.removeEdge(g.findIndex(u, v));
        for (auto& e : implications) {
            setForbidden(e.first, e.second);
            heap.removeEdge(g.findIndex(e.first, e.second));
        }
    }

    std::vector<std::vector<int>> run() {
        std::vector<std::vector<int>> clusters;
        if (infeasible) return clusters;
        long long n_iter = (long long)g.weight.size();
        for (long long it = 0; it < n_iter; ++it) {
            int eIcf = heap.maxIcfEdge();
            int eIcp = heap.maxIcpEdge();
            if (eIcf < 0 || eIcp < 0) break;
            float mIcf = heap.getIcf(eIcf);
            float mIcp = heap.getIcp(eIcp);
            if (mIcf >= mIcp)
                choosePermanentEdge(heap.edges[eIcf].first, heap.edges[eIcf].second);
            else
                chooseForbiddenEdge(heap.edges[eIcp].first, heap.edges[eIcp].second);
        }
        std::vector<int> clusterOf(g.n, -1);
        for (int u = 0; u < g.n; ++u) {
            if (clusterOf[u] != -1) continue;
            int c = (int)clusters.size();
            clusterOf[u] = c;
            clusters.push_back({u});
            for (int v : g.cliques[g.cliqueOf[u]]) {
                if (u == v) continue;
                clusterOf[v] = c;
                clusters[c].push_back(v);
            }
        }
        for (auto& cl : clusters) std::sort(cl.begin(), cl.end());
        return clusters;
    }
};

thread_local std::vector<int> g_out_nodes;
thread_local std::vector<int64_t> g_out_offsets;

}  // namespace

extern "C" {

// returns number of clusters; results retrievable via wh_cluster_nodes/offsets
long long wh_cluster_run(int n_nodes, long long n_edges, const int* us, const int* vs,
                         const float* ws, int bundle_edges) {
    Graph g;
    g.n = n_nodes;
    g.weight.reserve((size_t)n_edges + 1);
    g.edges.reserve((size_t)n_edges + 1);
    g.weight.push_back(0.0f);
    g.edges.push_back({-1, -1});
    g.unpruned.resize(n_nodes);
    g.nonzero.resize(n_nodes);
    g.cliques.resize(n_nodes);
    g.cliqueOf.resize(n_nodes);
    g.forbidden.resize(n_nodes);
    for (int i = 0; i < n_nodes; ++i) {
        g.cliqueOf[i] = i;
        g.cliques[i] = {i};
    }
    // edges must arrive in ascending edge-id order (the caller sorts), like
    // the Python graph built from m.getIndices().  When the dense cell
    // matrix will serve every findIndex, the hash maps are never probed:
    // skip building them and derive the rank quirk table directly (its map
    // was only ever probed with a rank as the key, i.e. hit iff that rank
    // value equals some edge's triangular edge id).
    bool will_dense = (long long)n_nodes * n_nodes <= (64LL << 20);
    g.rank_quirk_hit.assign((size_t)n_edges + 1, 0);
    for (long long i = 0; i < n_edges; ++i) {
        int u = us[i], v = vs[i];
        if (u > v) std::swap(u, v);
        float w = ws[i];
        int r = (int)g.weight.size();
        int64_t eid = (int64_t)v * (v - 1) / 2 + u;
        if (!will_dense) {
            g.rank[ekey(u, v)] = r;
        }
        if (eid >= 1 && eid <= n_edges) g.rank_quirk_hit[(size_t)eid] = 1;
        g.weight.push_back(w);
        g.edges.push_back({u, v});
        if (w == FORBIDDEN)
            g.setForbidden(u, v, r);
        else if (w == PERMANENT)
            g.setPermanent(u, v, r);
        g.refresh(u, v, 0.0f, w);
    }
    g.buildIndex();
    Solver solver(std::move(g), bundle_edges != 0);
    auto clusters = solver.run();
    g_out_nodes.clear();
    g_out_offsets.clear();
    g_out_offsets.push_back(0);
    for (auto& c : clusters) {
        g_out_nodes.insert(g_out_nodes.end(), c.begin(), c.end());
        g_out_offsets.push_back((int64_t)g_out_nodes.size());
    }
    return (long long)clusters.size();
}

const int* wh_cluster_nodes() { return g_out_nodes.data(); }
const int64_t* wh_cluster_offsets() { return g_out_offsets.data(); }

}  // extern "C"
