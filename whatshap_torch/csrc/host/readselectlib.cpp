// Native read selection (coverage downsampling).
//
// Full C++ port of whatshap_torch/readselect.py (semantics from the
// reference's whatshap/readselect.pyx): iterative greedy slices from a
// binary max-heap with vector-valued priorities under a max-coverage
// constraint, plus bridging reads that connect phase-block components.
//
// Tie behavior is part of the output contract and is replicated exactly:
// the heap is operation-identical to pqext.cpp (same sift order),
// and the queue is filled in ascending read-index order — the iteration
// order CPython produces for the `undecided_reads` int set in the Python
// implementation (a set built from range(n) and only ever shrunk keeps
// slot == value, so iteration is ascending).  The preferred-reads phase
// (phased-VCF pseudo reads) iterates a scattered set whose CPython order
// is NOT ascending; callers keep that rare path in Python.

#include <algorithm>
#include <array>
#include <cstdint>
#include <vector>

namespace {

using Score = std::array<int64_t, 3>;

inline bool score_lower(const Score& a, const Score& b) {
    if (a[0] != b[0]) return a[0] < b[0];
    if (a[1] != b[1]) return a[1] < b[1];
    return a[2] < b[2];
}

// Binary max-heap, operation-identical to pqext.cpp / priorityqueue.py.
struct Heap {
    struct Entry {
        Score score;
        int32_t item;
    };
    std::vector<Entry> heap;
    std::vector<int32_t> pos;  // item -> heap index, -1 if absent

    explicit Heap(int32_t n_items) : pos(n_items, -1) {}

    void swap_at(int32_t i1, int32_t i2) {
        std::swap(pos[heap[i1].item], pos[heap[i2].item]);
        std::swap(heap[i1], heap[i2]);
    }
    bool lower(int32_t i1, int32_t i2) const {
        return score_lower(heap[i1].score, heap[i2].score);
    }
    void sift_up(int32_t index) {
        while (index > 0) {
            int32_t parent = (index - 1) / 2;
            if (lower(parent, index)) {
                swap_at(parent, index);
                index = parent;
            } else {
                break;
            }
        }
    }
    void sift_down(int32_t index) {
        const int32_t n = (int32_t)heap.size();
        for (;;) {
            int32_t l = 2 * index + 1, r = 2 * index + 2;
            if (r < n) {
                if (lower(l, r)) {
                    if (lower(index, r)) { swap_at(r, index); index = r; continue; }
                } else {
                    if (lower(index, l)) { swap_at(l, index); index = l; continue; }
                }
            } else if (l < n) {
                if (lower(index, l)) { swap_at(l, index); index = l; continue; }
            }
            break;
        }
    }
    void push(const Score& s, int32_t item) {
        int32_t newindex = (int32_t)heap.size();
        heap.push_back(Entry{s, item});
        pos[item] = newindex;
        sift_up(newindex);
    }
    Entry pop() {
        Entry first = heap[0];
        if (heap.size() == 1) {
            pos[first.item] = -1;
            heap.pop_back();
        } else {
            Entry last = heap.back();
            heap.pop_back();
            heap[0] = last;
            pos[last.item] = 0;
            pos[first.item] = -1;
            sift_down(0);
        }
        return first;
    }
    bool contains(int32_t item) const { return pos[item] >= 0; }
    void change_score(int32_t item, const Score& s) {
        int32_t position = pos[item];
        Score old = heap[position].score;
        heap[position].score = s;
        if (score_lower(old, s)) sift_up(position); else sift_down(position);
    }
    bool empty() const { return heap.empty(); }
};

// Union-find over position indices with min-index representative
// (graph.py ComponentFinder; indices are ascending in position, so the
// min-index root IS the min-position representative).
struct UnionFind {
    std::vector<int32_t> parent;
    explicit UnionFind(int32_t n) : parent(n) {
        for (int32_t i = 0; i < n; ++i) parent[i] = i;
    }
    int32_t find(int32_t x) {
        int32_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            int32_t nxt = parent[x];
            parent[x] = root;
            x = nxt;
        }
        return root;
    }
    void merge(int32_t a, int32_t b) {
        int32_t ra = find(a), rb = find(b);
        if (ra == rb) return;
        if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
    }
};

struct SelState {
    int32_t n_reads, n_positions, max_cov;
    const int32_t* read_off;
    const int32_t* vidx;   // ascending per read
    const int32_t* quals;
    std::vector<int32_t> coverage;
    std::vector<Score> score0;           // initial per-read scores
    std::vector<int32_t> begin, end;
    // CSR: position -> reads covering it (ascending read index)
    std::vector<int32_t> p2r_off, p2r;

    int32_t max_cov_in_range(int32_t b, int32_t e) const {
        int32_t m = 0;
        for (int32_t i = b; i < e; ++i) m = std::max(m, coverage[i]);
        return m;
    }
    void add_read_cov(int32_t b, int32_t e) {
        for (int32_t i = b; i < e; ++i) ++coverage[i];
    }
};

void slice_selection(SelState& st, Heap& pq, std::vector<uint8_t>& undecided,
                     std::vector<uint8_t>& selected,
                     std::vector<int32_t>& slice_members,
                     std::vector<uint8_t>& in_slice,
                     std::vector<uint8_t>& violating,
                     std::vector<uint8_t>& already_covered,
                     std::vector<int32_t>& newly, std::vector<uint8_t>& is_new,
                     std::vector<int32_t>& stamp, int32_t& stamp_val) {
    (void)undecided; (void)selected;
    std::vector<int32_t> to_update;
    while (!pq.empty()) {
        Heap::Entry top = pq.pop();
        const int32_t item = top.item;
        newly.clear();
        for (int32_t k = st.read_off[item]; k < st.read_off[item + 1]; ++k) {
            const int32_t p = st.vidx[k];
            if (!already_covered[p]) newly.push_back(p);
        }
        if (st.max_cov_in_range(st.begin[item], st.end[item]) >= st.max_cov) {
            violating[item] = 1;
        } else if (!newly.empty()) {
            st.add_read_cov(st.begin[item], st.end[item]);
            in_slice[item] = 1;
            slice_members.push_back(item);
            ++stamp_val;
            for (int32_t p : newly) {
                already_covered[p] = 1;
                is_new[p] = 1;
            }
            // collect the affected reads, then update in ascending read
            // order: the heap layout after equal-score updates depends on
            // the update sequence, and the Python implementation iterates
            // its candidate set in ascending order too
            to_update.clear();
            for (int32_t p : newly) {
                for (int32_t k = st.p2r_off[p]; k < st.p2r_off[p + 1]; ++k) {
                    const int32_t r = st.p2r[k];
                    if (in_slice[r] || stamp[r] == stamp_val) continue;
                    stamp[r] = stamp_val;
                    to_update.push_back(r);
                }
            }
            std::sort(to_update.begin(), to_update.end());
            for (int32_t r : to_update) {
                if (!pq.contains(r)) continue;
                // decrement the first component by the count of the
                // read's variants NOT newly covered by this pop
                int32_t not_new = 0;
                for (int32_t kk = st.read_off[r]; kk < st.read_off[r + 1]; ++kk)
                    if (!is_new[st.vidx[kk]]) ++not_new;
                Score s = pq.heap[pq.pos[r]].score;
                s[0] -= not_new;
                pq.change_score(r, s);
            }
            for (int32_t p : newly) is_new[p] = 0;
        }
    }
}

}  // namespace

extern "C" int32_t wh_readselection(
    int32_t n_reads, int32_t n_positions,
    const int32_t* read_off,  // n_reads + 1
    const int32_t* vidx,      // position indices, ascending per read
    const int32_t* quals,
    int32_t max_cov, int32_t bridging,
    uint8_t* out_selected /* n_reads */) {
    SelState st;
    st.n_reads = n_reads;
    st.n_positions = n_positions;
    st.max_cov = max_cov;
    st.read_off = read_off;
    st.vidx = vidx;
    st.quals = quals;
    st.coverage.assign(n_positions, 0);

    st.score0.resize(n_reads);
    st.begin.assign(n_reads, -1);
    st.end.assign(n_reads, -1);
    std::vector<int32_t> counts(n_positions + 1, 0);
    for (int32_t r = 0; r < n_reads; ++r) {
        const int32_t a = read_off[r], b = read_off[r + 1];
        int64_t min_q = -1;
        for (int32_t k = a; k < b; ++k) {
            if (k == a) min_q = quals[k];
            else min_q = std::min<int64_t>(min_q, quals[k]);
            ++counts[vidx[k] + 1];
        }
        const int64_t good = b - a;
        const int64_t span = (b > a) ? (int64_t)vidx[b - 1] - vidx[a] + 1 : 0;
        const int64_t bad = (good != span) ? span - good : 0;
        st.score0[r] = Score{good - bad, good - bad, min_q};
        if (b > a) {
            st.begin[r] = vidx[a];
            st.end[r] = vidx[b - 1] + 1;
        }
    }
    st.p2r_off.assign(n_positions + 1, 0);
    for (int32_t p = 0; p < n_positions; ++p)
        st.p2r_off[p + 1] = st.p2r_off[p] + counts[p + 1];
    st.p2r.resize(st.p2r_off[n_positions]);
    std::vector<int32_t> cursor(st.p2r_off.begin(), st.p2r_off.end() - 1);
    for (int32_t r = 0; r < n_reads; ++r)
        for (int32_t k = read_off[r]; k < read_off[r + 1]; ++k)
            st.p2r[cursor[st.vidx[k]]++] = r;

    std::vector<uint8_t> selected(n_reads, 0), undecided(n_reads, 1);
    std::vector<uint8_t> in_slice(n_reads), violating(n_reads);
    std::vector<uint8_t> already_covered(n_positions), is_new(n_positions, 0);
    std::vector<int32_t> slice_members, newly, stamp(n_reads, 0);
    int32_t stamp_val = 0;
    int64_t n_undecided = n_reads;

    while (n_undecided > 0) {
        Heap pq(n_reads);
        for (int32_t r = 0; r < n_reads; ++r)
            if (undecided[r]) pq.push(st.score0[r], r);
        std::fill(in_slice.begin(), in_slice.end(), 0);
        std::fill(violating.begin(), violating.end(), 0);
        std::fill(already_covered.begin(), already_covered.end(), 0);
        slice_members.clear();
        slice_selection(st, pq, undecided, selected, slice_members, in_slice,
                        violating, already_covered, newly, is_new, stamp,
                        stamp_val);
        for (int32_t r : slice_members) selected[r] = 1;
        for (int32_t r = 0; r < n_reads; ++r) {
            if (undecided[r] && (in_slice[r] || violating[r])) {
                undecided[r] = 0;
                --n_undecided;
            }
        }

        UnionFind cf(n_positions);
        for (int32_t r : slice_members) {
            const int32_t a = read_off[r], b = read_off[r + 1];
            for (int32_t k = a + 1; k < b; ++k) cf.merge(st.vidx[a], st.vidx[k]);
        }

        if (bridging) {
            Heap bq(n_reads);
            for (int32_t r = 0; r < n_reads; ++r)
                if (undecided[r]) bq.push(st.score0[r], r);
            while (!bq.empty()) {
                Heap::Entry top = bq.pop();
                const int32_t item = top.item;
                const int32_t a = read_off[item], b = read_off[item + 1];
                // count distinct covered blocks
                int32_t first_block = b > a ? cf.find(st.vidx[a]) : -1;
                bool multi = false;
                for (int32_t k = a + 1; k < b && !multi; ++k)
                    multi = cf.find(st.vidx[k]) != first_block;
                if (st.max_cov_in_range(st.begin[item], st.end[item]) >= st.max_cov) {
                    undecided[item] = 0;
                    --n_undecided;
                    continue;
                }
                if (!multi) continue;
                selected[item] = 1;
                st.add_read_cov(st.begin[item], st.end[item]);
                undecided[item] = 0;
                --n_undecided;
                for (int32_t k = a + 1; k < b; ++k) cf.merge(st.vidx[a], st.vidx[k]);
            }
        }
    }

    int32_t n_sel = 0;
    for (int32_t r = 0; r < n_reads; ++r) {
        out_selected[r] = selected[r];
        n_sel += selected[r];
    }
    return n_sel;
}
