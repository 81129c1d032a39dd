// Native alignment kernels for whatshap_torch's host-side allele detection.
// Same semantics as the Python paths in whatshap_torch/align.py (and the
// reference's whatshap/align.pyx): banded unit-cost edit distance and Gotoh
// affine-gap alignment with per-position mismatch costs.
//
// Built as a plain shared library; accessed via ctypes (no pybind11).
#include <algorithm>
#include <climits>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

int wh_edit_distance(const char* s, int m, const char* t, int n, int maxdiff) {
    int e = maxdiff;
    if (e != -1 && std::abs(m - n) > e) {
        return std::abs(m - n);
    }
    // skip identical prefixes
    while (m > 0 && n > 0 && s[0] == t[0]) {
        ++s;
        ++t;
        --m;
        --n;
    }
    // skip identical suffixes
    while (m > 0 && n > 0 && s[m - 1] == t[n - 1]) {
        --m;
        --n;
    }
    std::vector<int> costs(m + 1);
    for (int i = 0; i <= m; ++i) costs[i] = i;
    if (e == -1) {
        for (int j = 1; j <= n; ++j) {
            int prev = costs[0];
            costs[0] += 1;
            const char tj = t[j - 1];
            for (int i = 1; i <= m; ++i) {
                const int match = (s[i - 1] == tj) ? 1 : 0;
                const int c = std::min(prev + 1 - match,
                                       std::min(costs[i] + 1, costs[i - 1] + 1));
                prev = costs[i];
                costs[i] = c;
            }
        }
    } else {
        int smallest = 0;
        for (int j = 1; j <= n; ++j) {
            const int stop = std::min(j + e + 1, m + 1);
            int start, prev;
            if (j <= e) {
                prev = costs[0];
                costs[0] += 1;
                smallest = costs[0];
                start = 1;
            } else {
                start = j - e;
                prev = costs[start - 1];
                smallest = maxdiff + 1;
            }
            const char tj = t[j - 1];
            for (int i = start; i < stop; ++i) {
                const int match = (s[i - 1] == tj) ? 1 : 0;
                const int c = std::min(prev + 1 - match,
                                       std::min(costs[i] + 1, costs[i - 1] + 1));
                prev = costs[i];
                costs[i] = c;
                smallest = std::min(smallest, c);
            }
            if (smallest > maxdiff) break;
        }
        if (smallest > maxdiff) return smallest;
    }
    return costs[m];
}

int wh_edit_distance_affine_gap(const char* sv, int m, const char* tv, int n,
                                const int* mismatch_cost, int gap_start,
                                int gap_extend) {
    int len_p = 0;
    while (m > 0 && n > 0 && sv[0] == tv[0]) {
        ++sv;
        ++tv;
        --m;
        --n;
        ++len_p;
    }
    while (m > 0 && n > 0 && sv[m - 1] == tv[n - 1]) {
        --m;
        --n;
    }
    // float tables, matching the reference numerics exactly
    std::vector<float> a(m + 1), b(m + 1), c(m + 1);
    a[0] = 0.0f;
    b[0] = 0.0f;
    c[0] = 0.0f;
    for (int i = 1; i <= m; ++i) {
        a[i] = (float)INT_MAX;
        b[i] = (float)(gap_start + (i - 1) * gap_extend);
        c[i] = (float)INT_MAX;
    }
    for (int j = 1; j <= n; ++j) {
        float prev_a = a[0], prev_b = b[0], prev_c = c[0];
        a[0] = (float)INT_MAX;
        b[0] = (float)INT_MAX;
        c[0] = (float)(gap_start + (j - 1) * gap_extend);
        const char tj = tv[j - 1];
        for (int i = 1; i <= m; ++i) {
            float m_c = (float)mismatch_cost[i - 1 + len_p];
            if (sv[i - 1] == tj) m_c = 0.0f;
            const float c_a = std::min(prev_a, std::min(prev_b, prev_c)) + m_c;
            const float c_b =
                std::min(a[i - 1] + gap_start,
                         std::min(b[i - 1] + gap_extend, c[i - 1] + gap_start));
            const float c_c = std::min(
                a[i] + gap_start, std::min(b[i] + gap_start, c[i] + gap_extend));
            prev_a = a[i];
            prev_b = b[i];
            prev_c = c[i];
            a[i] = c_a;
            b[i] = c_b;
            c[i] = c_c;
        }
    }
    return (int)std::min(a[m], std::min(b[m], c[m]));
}

}  // extern "C"
