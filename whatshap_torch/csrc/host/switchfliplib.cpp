// Polyploid switch/flip-distance engine.
//
// C++ implementation of whatshap_torch/polyphase/switchflip.py (semantics
// from src/polyphase/switchflipcalculator.cpp): DP over haplotype
// permutations per column with switch-cost transitions, flip-cost
// emissions and the reference's non-profitability pruning.  Iteration
// order (permutations in itertools order, survivors keeping insertion
// order) is preserved so tie-breaking matches the Python engine exactly.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

const double INF = std::numeric_limits<double>::infinity();

void build_perms(int k, std::vector<std::vector<int>>& out) {
    std::vector<int> base(k);
    for (int i = 0; i < k; ++i) base[i] = i;
    out.clear();
    do {
        out.push_back(base);
    } while (std::next_permutation(base.begin(), base.end()));
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 when the DP dead-ends (Python returns inf).
// fl_haps must have capacity num_vars*ploidy; perm_col num_vars*ploidy.
int32_t wh_switchflip(
    int32_t ploidy, double switch_cost, double flip_cost, int32_t num_vars,
    const int32_t* phase0, const int32_t* phase1,
    double* out_switches, double* out_flips,
    int32_t* sw_col, int32_t* fl_off, int32_t* fl_haps, int32_t* perm_col) {
    std::vector<std::vector<int>> perms;
    build_perms(ploidy, perms);
    const int NP = (int)perms.size();

    auto num_flips = [&](const std::vector<int>& perm, const int32_t* p0,
                         const int32_t* p1) {
        int n = 0;
        for (int i = 0; i < ploidy; ++i)
            if (p0[perm[i]] != p1[i]) ++n;
        return n;
    };
    auto num_switches = [&](const std::vector<int>& a, const std::vector<int>& b) {
        int n = 0;
        for (int i = 0; i < ploidy; ++i)
            if (a[i] != b[i]) ++n;
        return n;
    };

    // per column: for each perm (by index) score/pred/alive; iteration in
    // perms order restricted to alive mirrors the Python dict order
    struct Cell {
        double score = INF;
        int pred = -1;       // perm index in the previous column, -1 = None
        bool alive = false;
    };
    std::vector<std::vector<Cell>> m(num_vars, std::vector<Cell>(NP));

    for (int p = 0; p < NP; ++p) {
        m[0][p] = {flip_cost * num_flips(perms[p], phase0, phase1), -1, true};
    }

    for (int pos = 1; pos < num_vars; ++pos) {
        const auto& prev = m[pos - 1];
        auto& column = m[pos];
        double minimum_in_column = INF;
        for (int rp = 0; rp < NP; ++rp) {
            double minimum = INF;
            int minimum_pred = -1;
            for (int pp = 0; pp < NP; ++pp) {
                if (!prev[pp].alive) continue;
                double s = prev[pp].score +
                           switch_cost * num_switches(perms[rp], perms[pp]);
                if (s < minimum) {
                    minimum = s;
                    minimum_pred = pp;
                }
            }
            double emission =
                flip_cost * num_flips(perms[rp], phase0 + (size_t)pos * ploidy,
                                      phase1 + (size_t)pos * ploidy);
            if (minimum_pred >= 0)
                column[rp] = {minimum + emission, minimum_pred, true};
            else
                column[rp] = {emission, -1, true};
            if (column[rp].score < minimum_in_column)
                minimum_in_column = column[rp].score;
        }

        // non-profitability pruning (switchflipcalculator.cpp:93-119)
        std::vector<int> profitable, open_tuples;
        for (int p = 0; p < NP; ++p) {
            if (column[p].score <= minimum_in_column) profitable.push_back(p);
            else open_tuples.push_back(p);
        }
        for (int t : open_tuples) {
            bool is_profitable = true;
            for (int p : profitable) {
                if (column[t].score >=
                    column[p].score + switch_cost * num_switches(perms[t], perms[p])) {
                    is_profitable = false;
                    break;
                }
            }
            if (is_profitable) {
                if ((int)profitable.size() < ploidy) profitable.push_back(t);
            } else {
                column[t].alive = false;
            }
        }
    }

    // backtracking
    double flips = 0.0, switches = 0.0;
    int current = -1;
    double minimum = INF;
    for (int p = 0; p < NP; ++p) {
        if (m[num_vars - 1][p].alive && m[num_vars - 1][p].score < minimum) {
            minimum = m[num_vars - 1][p].score;
            current = p;
        }
    }
    if (current < 0) return 1;

    // fill per-column outputs back-to-front, reverse at the end
    std::vector<int> perm_rev;        // perm indices, last column first
    std::vector<int> sw_rev;
    std::vector<std::vector<int>> fl_rev;

    {
        int pos = num_vars - 1;
        perm_rev.push_back(current);
        int pred = m[pos][current].pred;
        int local_switches =
            pred >= 0 ? num_switches(perms[current], perms[pred]) : 0;
        std::vector<int> fl;
        for (int i = 0; i < ploidy; ++i)
            if (phase0[(size_t)pos * ploidy + perms[current][i]] !=
                phase1[(size_t)pos * ploidy + i])
                fl.push_back(i);
        fl_rev.push_back(fl);
        sw_rev.push_back(local_switches);
        flips += (double)fl.size();
        switches += local_switches;
    }
    for (int pos = num_vars - 2; pos >= 0; --pos) {
        current = m[pos + 1][current].pred;
        if (current < 0) return 1;
        perm_rev.push_back(current);
        int pred = m[pos][current].pred;
        int local_switches =
            (pos == 0 || pred < 0) ? 0 : num_switches(perms[current], perms[pred]);
        std::vector<int> fl;
        for (int i = 0; i < ploidy; ++i)
            if (phase0[(size_t)pos * ploidy + perms[current][i]] !=
                phase1[(size_t)pos * ploidy + i])
                fl.push_back(i);
        fl_rev.push_back(fl);
        sw_rev.push_back(local_switches);
        flips += (double)fl.size();
        switches += local_switches;
    }

    *out_switches = switches;
    *out_flips = flips;
    int off = 0;
    for (int pos = 0; pos < num_vars; ++pos) {
        int src = num_vars - 1 - pos;  // reverse
        sw_col[pos] = sw_rev[src];
        for (int i = 0; i < ploidy; ++i)
            perm_col[(size_t)pos * ploidy + i] = perms[perm_rev[src]][i];
        fl_off[pos] = off;
        for (int h : fl_rev[src]) fl_haps[off++] = h;
    }
    fl_off[num_vars] = off;
    return 0;
}

}  // extern "C"
