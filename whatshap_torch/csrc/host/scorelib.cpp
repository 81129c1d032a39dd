// Read-pair scoring engine for the polyploid pipeline.
//
// C++ implementation of the pair loop of
// whatshap_torch/polyphase/readscoring.py (_compute_log_score_lut +
// scoreReadset; semantics from src/polyphase/readscoring.cpp:17-83,
// 235-260): per overlapping read pair, merge the sorted sparse rows and
// sum the per-position log-score LUT entries, with the reference's
// float32 rounding points and the uint32 terminal-position wrap quirk.
//
// The genotype-likelihood and LUT computation stays in Python (it is
// O(positions), not O(pairs)).

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Returns the number of emitted (i, j, score) triples (capped at cap),
// and writes the NaN count to *out_nans.
int64_t wh_score_pairs(
    int32_t n_reads, int32_t num_alleles,
    const int32_t* read_off,        // n_reads+1
    const int32_t* read_pos,        // flattened local positions
    const int32_t* read_allele,     // flattened alleles
    const uint32_t* first_pos,      // per read
    const uint32_t* last_pos,       // per read
    const int32_t* sorted_reads,    // n_reads, by first position
    const int32_t* lut_of_pos,      // n_pos: position -> unique LUT index
    const float* luts,              // n_unique * A * A, float32 entries
    int32_t min_overlap, float offset,
    int32_t* out_i, int32_t* out_j, float* out_score,
    int64_t cap, int64_t* out_nans) {
    int64_t count = 0;
    int64_t nans = 0;
    const int A = num_alleles;

    for (int32_t i = 0; i < n_reads; ++i) {
        int ri = sorted_reads[i];
        // uint32 arithmetic: lastPos - minOverlap + 1 may wrap (reference
        // quirk, readscoring.cpp terminal position)
        uint32_t terminal = last_pos[ri] - (uint32_t)min_overlap + 1u;
        const int32_t* pi = read_pos + read_off[ri];
        const int32_t* ai = read_allele + read_off[ri];
        int ni = read_off[ri + 1] - read_off[ri];
        for (int32_t j = i + 1; j < n_reads; ++j) {
            int rj = sorted_reads[j];
            if (first_pos[rj] > terminal) break;
            const int32_t* pj = read_pos + read_off[rj];
            const int32_t* aj = read_allele + read_off[rj];
            int nj = read_off[rj + 1] - read_off[rj];

            int ov = 0;
            double log_score = 0.0;  // Python accumulates in double
            int k = 0, l = 0;
            while (k < ni && l < nj) {
                int32_t p1 = pi[k], p2 = pj[l];
                if (p1 == p2) {
                    log_score += luts[((size_t)lut_of_pos[p1] * A + ai[k]) * A + aj[l]];
                    ++ov;
                    ++k;
                    ++l;
                } else if (p1 < p2) ++k;
                else ++l;
            }
            float score = ov >= min_overlap ? (float)log_score : 0.0f;
            if (std::isnan(score)) {
                ++nans;
                continue;
            }
            if (score != 0.0f) {
                // stored value: float32(score + offset), as
                // TriangleSparseMatrix.set does
                float stored = (float)((double)score + (double)offset);
                if (count < cap) {
                    out_i[count] = ri;
                    out_j[count] = rj;
                    out_score[count] = stored;
                }
                ++count;
            }
        }
    }
    *out_nans = nans;
    return count;
}

}  // extern "C"
