// HapCHAT adaptive-k MEC solver engine.
//
// C++ implementation of the column DP in whatshap_torch/solver/hapchat.py
// (semantics from the reference's src/hapchat/ sources as wrapped by
// core.pyx HapChatCore), operation-identical in double precision: the same
// popcount-major/Gosper enumeration order, the same strict-improvement
// updates and INC-K growth, so the haplotypes and cost are bit-equal to
// the Python engine (which is fuzz-verified against the compiled
// reference oracle).
//
// Inputs arrive block-localized: reads of the first interval-overlap block
// in ReadSet order, variant positions as local column indices.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

constexpr int MAX_COVERAGE = 64;
constexpr double INF = std::numeric_limits<double>::infinity();

struct Tables {
    // binomials up to MAX_COVERAGE (uint64: C(64,32) fits)
    uint64_t binom[MAX_COVERAGE + 1][MAX_COVERAGE + 1] = {};
    std::vector<int> ks;

    Tables() {
        for (int i = 0; i <= MAX_COVERAGE; ++i)
            for (int j = 0; j <= i; ++j)
                binom[i][j] = (i == 0 || j == 0 || j == i)
                                  ? 1
                                  : binom[i - 1][j - 1] + binom[i - 1][j];
        // adaptive k per coverage (alpha=0.01, err=0.05), as in computeK
        ks.assign(MAX_COVERAGE + 1, 0);
        const double alpha = 0.01, err = 0.05;
        for (int i = 1; i <= MAX_COVERAGE; ++i) {
            int k = 0;
            double cumulative = std::pow(1.0 - err, i);
            while (!(1.0 - cumulative <= alpha) && k < i) {
                ++k;
                cumulative += (double)binom[i][k] * std::pow(err, k) *
                              std::pow(1.0 - err, i - k);
            }
            ks[i] = k;
        }
    }

    uint64_t B(int n, int k) const {
        if (k < 0 || n < 0 || n < k) return 0;
        return binom[n][k];
    }
} const TABLES;

// colex rank of a subset among subsets of its size
uint64_t colex_index(uint64_t mask) {
    int k = 0;
    int c_k = 0;
    uint64_t result = 0;
    while (mask) {
        int ffs = __builtin_ctzll(mask) + 1;
        c_k += ffs;
        k += 1;
        result += TABLES.B(c_k - 1, k);
        mask >>= ffs;
    }
    return result;
}

// rank among all subsets of size <= popcount
uint64_t cumulative_index(uint64_t mask, int n_elements) {
    int k = __builtin_popcountll(mask);
    uint64_t result = colex_index(mask);
    for (int i = 0; i < k; ++i) result += TABLES.B(n_elements, i);
    return result;
}

struct Column {
    std::vector<int> rids;
    uint64_t alleles = 0;   // bit i set iff entry i is ALT (gaps count as REF)
    uint64_t gap_mask = 0;
    std::vector<int> weights;
    int cov = 0;
    int num_gaps = 0;
};

struct Backtrack {
    uint64_t prev_index = 0;
    bool haplotypes = false;
    bool new_block = false;
};

}  // namespace

extern "C" {

// Solve one block.  Reads are sorted (ReadSet order); per read:
// var_off ranges into var_pos (local column index) / var_allele /
// var_qual.  Outputs: hap1/hap2 as 0/1 bytes per column, *out_cost.
// Returns 0 on success, -1 when coverage exceeds MAX_COVERAGE.
int32_t wh_hapchat_solve(
    int32_t n_reads, int32_t n_cols,
    const int32_t* var_off, const int32_t* var_pos, const int32_t* var_allele,
    const int32_t* var_qual,
    uint8_t* out_hap1, uint8_t* out_hap2, double* out_cost) {
    // ---- materialize columns (ColumnIterator semantics) ----
    std::vector<int> first(n_reads), last(n_reads);
    for (int r = 0; r < n_reads; ++r) {
        first[r] = var_pos[var_off[r]];
        last[r] = var_pos[var_off[r + 1] - 1];
    }
    std::vector<Column> columns(n_cols);
    {
        std::vector<int> active;
        int next_read = 0;
        // per read: map local position -> (allele, quality)
        for (int pos = 0; pos < n_cols; ++pos) {
            std::vector<int> still;
            for (int r : active)
                if (last[r] >= pos) still.push_back(r);
            active = std::move(still);
            while (next_read < n_reads && first[next_read] <= pos) {
                if (last[next_read] >= pos) active.push_back(next_read);
                ++next_read;
            }
            Column& col = columns[pos];
            for (int r : active) {
                int idx = col.cov;
                if (idx >= MAX_COVERAGE) return -1;
                col.rids.push_back(r);
                // find this read's entry at pos (reads are short: scan)
                int found = -1;
                for (int v = var_off[r]; v < var_off[r + 1]; ++v)
                    if (var_pos[v] == pos) { found = v; break; }
                if (found < 0) {
                    col.gap_mask |= 1ull << idx;
                    col.num_gaps += 1;
                    col.weights.push_back(0);
                } else {
                    if (var_allele[found] == 1) col.alleles |= 1ull << idx;
                    col.weights.push_back(var_qual[found]);
                }
                col.cov += 1;
            }
        }
    }

    // ---- the DP ----
    std::vector<int> k_j(n_cols);
    for (int c = 0; c < n_cols; ++c)
        k_j[c] = TABLES.ks[std::min(columns[c].cov - columns[c].num_gaps, MAX_COVERAGE)];

    double OPT_prev = 0.0;
    std::unordered_map<uint64_t, double> prev_proj;
    std::vector<std::unordered_map<uint64_t, Backtrack>> bt(n_cols + 1);
    std::vector<uint64_t> best1_index(n_cols + 1, 0);
    std::vector<uint8_t> best2_h(n_cols + 1, 0), best2_nb(n_cols + 1, 0);

    int j = 0;
    while (j < n_cols) {
        const Column& col = columns[j];
        const Column empty;
        const Column& prev_col = j > 0 ? columns[j - 1] : empty;

        // shared-read index lists with the previous / next column
        std::vector<int> forw, back;
        {
            int a = 0, b = 0;
            while (a < prev_col.cov && b < col.cov) {
                if (prev_col.rids[a] == col.rids[b]) {
                    forw.push_back(a);
                    back.push_back(b);
                    ++a; ++b;
                } else if (prev_col.rids[a] < col.rids[b]) ++a;
                else ++b;
            }
        }
        bool has_prev = !forw.empty();
        std::vector<int> back_n;
        bool has_next = false;
        if (j + 1 < n_cols) {
            const Column& next_col = columns[j + 1];
            int a = 0, b = 0;
            while (a < next_col.cov && b < col.cov) {
                if (next_col.rids[a] == col.rids[b]) {
                    back_n.push_back(b);
                    ++a; ++b;
                } else if (next_col.rids[a] < col.rids[b]) ++a;
                else ++b;
            }
            has_next = !back_n.empty();
        }

        uint64_t diff_bits = 0;
        for (size_t a = 0; a < forw.size(); ++a) {
            if (((prev_col.alleles >> forw[a]) & 1) != ((col.alleles >> back[a]) & 1))
                diff_bits |= 1ull << a;
        }

        bool solution_existence = false;
        double current_best = INF;
        double OPT_cur = INF;
        std::unordered_map<uint64_t, double> next_proj;
        int step = j + 1;
        int active_qj = (int)forw.size();
        uint64_t full = active_qj >= 64 ? ~0ull : ((1ull << active_qj) - 1);

        // enumerate masks: popcount-major, ascending within each popcount
        auto consider = [&](uint64_t mask) {
            double weight_mask = 0.0;
            for (uint64_t mm = mask; mm;) {
                uint64_t low = mm & (~mm + 1);
                weight_mask += col.weights[__builtin_ctzll(low)];
                mm ^= low;
            }

            double current_cost = INF;
            uint64_t temp_index = 0;
            bool temp_haplotypes = false;
            bool temp_new_block = false;

            if (has_prev) {
                uint64_t mask_bits = 0;
                for (size_t a = 0; a < back.size(); ++a)
                    mask_bits |= ((mask >> back[a]) & 1) << a;
                uint64_t mask_qj = diff_bits ^ mask_bits;
                int corrected = __builtin_popcountll(mask_qj);

                if (corrected <= k_j[j - 1]) {
                    uint64_t index = cumulative_index(mask_qj, active_qj);
                    auto it = prev_proj.find(index);
                    double temp = (it != prev_proj.end() ? it->second : INF) + weight_mask;
                    if (temp < current_cost) {
                        current_cost = temp;
                        solution_existence = true;
                        temp_index = index;
                        temp_haplotypes = bt[step - 1][index].haplotypes;
                        temp_new_block = false;
                    }
                }
                if ((active_qj - corrected) <= k_j[j - 1]) {
                    uint64_t index = cumulative_index(mask_qj ^ full, active_qj);
                    auto it = prev_proj.find(index);
                    double temp = (it != prev_proj.end() ? it->second : INF) + weight_mask;
                    if (temp < current_cost) {
                        current_cost = temp;
                        solution_existence = true;
                        temp_index = index;
                        temp_haplotypes = !bt[step - 1][index].haplotypes;
                        temp_new_block = false;
                    }
                }
            } else {
                double temp = OPT_prev + weight_mask;
                if (temp < current_cost) {
                    current_cost = temp;
                    solution_existence = true;
                    temp_index = 0;
                    temp_haplotypes = false;
                    temp_new_block = true;
                }
            }

            if (has_next && current_cost < INF) {
                uint64_t cut_mask = 0;
                for (size_t a = 0; a < back_n.size(); ++a)
                    cut_mask |= ((mask >> back_n[a]) & 1) << a;
                uint64_t index = cumulative_index(cut_mask, (int)back_n.size());
                auto it = next_proj.find(index);
                if (it == next_proj.end() || current_cost < it->second) {
                    next_proj[index] = current_cost;
                    bt[step][index] = {temp_index, temp_haplotypes, temp_new_block};
                }
            }

            if (current_cost < current_best) {
                current_best = current_cost;
                best1_index[step] = temp_index;
                best2_h[step] = temp_haplotypes;
                best2_nb[step] = temp_new_block;
            }
            if (current_cost < OPT_cur) OPT_cur = current_cost;
        };

        consider(0);
        int max_k = std::min(k_j[j], col.cov);
        for (int t = 1; t <= max_k; ++t) {
            uint64_t mask = (1ull << t) - 1;
            uint64_t top = col.cov >= 64 ? 0 : (1ull << col.cov);
            while (col.cov >= 64 ? mask >= (1ull << t) - 1 : mask < top) {
                consider(mask);
                // Gosper's hack
                uint64_t c = mask & (~mask + 1);
                uint64_t r = mask + c;
                uint64_t nxt = (((r ^ mask) >> 2) / c) | r;
                if (nxt <= mask) break;  // wrapped (only possible at cov 64)
                mask = nxt;
                if (col.cov < 64 && mask >= top) break;
            }
        }

        if (solution_existence) {
            OPT_prev = OPT_cur;
            prev_proj = std::move(next_proj);
            j += 1;
        } else {
            // INC-K: grow k for this column and re-run it
            int old_k = k_j[j];
            double k_inc = old_k;
            if (k_inc <= 0) k_inc = 1;
            else k_inc = k_inc + std::log2(k_inc) + 1;
            k_j[j] = (int)std::floor(k_inc);
            if (k_j[j] <= old_k) k_j[j] = old_k + 1;
        }
    }

    // ---- backtracking ----
    std::vector<uint8_t> hap1(n_cols, 0), hap2(n_cols, 0);
    int col = n_cols;
    while (col > 0) {
        uint64_t back_index = best1_index[col];
        bool b_h = best2_h[col];
        bool b_nb = best2_nb[col];
        bool flag = col > 0;
        while (flag) {
            if (b_h) { hap1[col - 1] = 0; hap2[col - 1] = 1; }
            else { hap1[col - 1] = 1; hap2[col - 1] = 0; }
            col -= 1;
            if (b_nb || col == 0) flag = false;
            else {
                const Backtrack& b = bt[col][back_index];
                b_h = b.haplotypes;
                b_nb = b.new_block;
                back_index = b.prev_index;
            }
        }
    }

    for (int c = 0; c < n_cols; ++c) {
        out_hap1[c] = hap1[c];
        out_hap2[c] = hap2[c];
    }
    *out_cost = OPT_prev;
    return 0;
}

}  // extern "C"
