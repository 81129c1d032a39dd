// CIGAR allele-detection engine.
//
// C++ implementation of whatshap_torch/_variants.py (semantics from the
// reference's compiled whatshap/_variants.pyx): the realignment-mode
// lockstep walk over CIGAR x variants (wh_iterate_cigar) and the
// reference-free allele detector (wh_detect_alleles).  Both are
// operation-identical to the Python module, which stays as the
// verification fallback.

#include <algorithm>
#include <cstdint>
#include <deque>
#include <vector>

namespace {

struct AlleleProgress {
    int progress = 0;
    int length = 0;
    int quality = 0;
    int matched = 0;
    int match_target = 0;
    int inserted = 0;
    int insert_target = 0;
    int deleted = 0;
    int delete_target = 0;
};

struct VariantState {
    int variant_id = 0;   // global index into the variants array
    int query_start = 0;
    std::vector<AlleleProgress> alleles;
};

}  // namespace

extern "C" {

// Realignment-mode walk: for each variant covered by the alignment, emit
// (variant index, cigar element index, ops consumed within it, query pos).
// Returns the number of hits (capped at `cap`).
int32_t wh_iterate_cigar(
    const int64_t* var_positions, int32_t n_variants, int32_t j,
    int64_t ref_start,
    const int32_t* cigar_ops, const int32_t* cigar_lens, int32_t n_cigar,
    int32_t* out_index, int32_t* out_elem, int32_t* out_consumed,
    int32_t* out_qpos, int32_t cap) {
    int64_t ref_pos = ref_start;
    int64_t query_pos = 0;
    int32_t count = 0;

    while (j < n_variants && var_positions[j] < ref_pos) ++j;

    auto emit = [&](int32_t idx, int32_t elem, int64_t consumed, int64_t qpos) {
        if (count < cap) {
            out_index[count] = idx;
            out_elem[count] = elem;
            out_consumed[count] = (int32_t)consumed;
            out_qpos[count] = (int32_t)qpos;
        }
        ++count;
    };

    for (int32_t i = 0; i < n_cigar; ++i) {
        int op = cigar_ops[i];
        int64_t length = cigar_lens[i];
        if (op == 0 || op == 7 || op == 8) {  // M, =, X
            while (j < n_variants && var_positions[j] < ref_pos + length) {
                int64_t vp = var_positions[j];
                emit(j, i, vp - ref_pos, query_pos + vp - ref_pos);
                ++j;
            }
            query_pos += length;
            ref_pos += length;
        } else if (op == 1) {  // I
            if (j < n_variants && var_positions[j] == ref_pos) {
                emit(j, i, 0, query_pos);
                ++j;
            }
            query_pos += length;
        } else if (op == 2) {  // D
            while (j < n_variants && var_positions[j] < ref_pos + length) {
                emit(j, i, var_positions[j] - ref_pos, query_pos);
                ++j;
            }
            ref_pos += length;
        } else if (op == 3) {  // N
            while (j < n_variants && var_positions[j] < ref_pos + length) ++j;
            ref_pos += length;
        } else if (op == 4) {  // S
            query_pos += length;
        } else if (op == 5 || op == 6) {  // H, P
        } else {
            return -1;
        }
    }
    return count;
}

// Reference-free allele detection.  Variant metadata arrives flattened:
//   prog_positions[k]: genomic position of the k-th usable variant
//   prog_variant_id[k]: its index in the full variants list
//   prog_ref_len[k]: length of its REF allele
//   allele_off[k] .. allele_off[k+1]: its allele range in the target arrays
//   match_t/insert_t/delete_t[a]: per-allele targets
//   seq_off[a] .. seq_off[a+1]: the allele's base string in allele_seq
// The query is the read's sequence (quals optional; <0 entries mean "use
// 30").  Emits (variant id, allele, quality) triples; returns their count.
int32_t wh_detect_alleles(
    const int64_t* prog_positions, const int32_t* prog_variant_id,
    const int32_t* prog_ref_len, int32_t n_prog,
    const int32_t* allele_off,
    const int32_t* match_t, const int32_t* insert_t, const int32_t* delete_t,
    const int32_t* seq_off, const char* allele_seq,
    int32_t first, int64_t ref_start,
    const int32_t* cigar_ops, const int32_t* cigar_lens, int32_t n_cigar,
    const char* query_seq, int32_t query_len,
    const int8_t* query_quals, int32_t has_quals,
    int32_t* out_variant, int32_t* out_allele, int32_t* out_quality,
    int32_t cap) {
    (void)query_len;
    int64_t ref_pos = ref_start;
    int64_t query_pos = 0;
    int32_t j = first;
    int32_t count = 0;

    std::deque<VariantState> vqueue;

    auto flush_entry = [&](VariantState& st) -> int {
        // -1: still pending, 0: discarded, 1: emitted
        int num_pending = 0;
        std::vector<int> resolved;
        for (size_t i = 0; i < st.alleles.size(); ++i) {
            const AlleleProgress& a = st.alleles[i];
            if (a.progress == a.length) resolved.push_back((int)i);
            if (a.progress >= 0 && a.progress < a.length) ++num_pending;
        }
        if (!resolved.empty() && num_pending == 0) {
            int best = resolved[0];
            for (int r : resolved)
                if (st.alleles[r].length > st.alleles[best].length) best = r;
            const AlleleProgress& a = st.alleles[best];
            int q = a.length > 0 ? a.quality / a.length : 30;
            if (count < cap) {
                out_variant[count] = st.variant_id;
                out_allele[count] = best;
                out_quality[count] = q;
            }
            ++count;
            return 1;
        }
        if (num_pending > 0) return -1;
        return 0;
    };

    while (j < n_prog && prog_positions[j] < ref_pos) ++j;

    for (int32_t ci = 0; ci < n_cigar; ++ci) {
        int op = cigar_ops[ci];
        int64_t length = cigar_lens[ci];

        while (j < n_prog && prog_positions[j] < ref_pos) ++j;

        if (op == 3) { ref_pos += length; continue; }
        if (op == 4) { query_pos += length; continue; }
        if (op == 5 || op == 6) continue;

        // queue the variants starting inside this op's reference span
        int64_t ref_end_span = ref_pos + length;
        while (j < n_prog) {
            int64_t vp = prog_positions[j];
            if (vp >= ref_end_span) break;
            int ref_len = prog_ref_len[j];
            if (op == 1 && ref_len > 0) break;         // insertion op, non-ins variant
            if (op == 2 && ref_len == 0) { ++j; continue; }  // deletion op, ins variant
            int64_t qstart = (op != 2) ? query_pos + vp - ref_pos : query_pos;
            VariantState st;
            st.variant_id = prog_variant_id[j];
            st.query_start = (int32_t)qstart;
            int a0 = allele_off[j], a1 = allele_off[j + 1];
            st.alleles.resize(a1 - a0);
            for (int a = a0; a < a1; ++a) {
                AlleleProgress& ap = st.alleles[a - a0];
                ap.match_target = match_t[a];
                ap.insert_target = insert_t[a];
                ap.delete_target = delete_t[a];
                ap.length = ap.match_target + ap.insert_target + ap.delete_target;
            }
            vqueue.push_back(std::move(st));
            ++j;
        }

        // --- progress handlers ---
        int64_t ref_end = ref_pos;
        int64_t query_end = query_pos;
        int kind;  // 0 = match, 1 = insertion, 2 = deletion
        if (op == 0 || op == 7 || op == 8) { kind = 0; ref_end += length; query_end += length; }
        else if (op == 1) { kind = 1; query_end += length; }
        else if (op == 2) { kind = 2; ref_end += length; }
        else return -1;

        for (VariantState& st : vqueue) {
            // prog_variant_id is sorted ascending: binary-search the row
            int lo = 0, hi = n_prog - 1, row = -1;
            while (lo <= hi) {
                int mid = (lo + hi) / 2;
                if (prog_variant_id[mid] == st.variant_id) { row = mid; break; }
                if (prog_variant_id[mid] < st.variant_id) lo = mid + 1; else hi = mid - 1;
            }
            if (row < 0) continue;
            int a0 = allele_off[row];
            for (size_t i = 0; i < st.alleles.size(); ++i) {
                AlleleProgress& a = st.alleles[i];
                if (a.progress < 0) continue;
                const char* aseq = allele_seq + seq_off[a0 + (int)i];
                if (kind == 0) {
                    int op_start = std::max<int64_t>(0, st.query_start - query_pos);
                    int ops_consumed = op_start;
                    int64_t qp = st.query_start + a.matched + a.inserted;
                    while (a.matched < a.match_target && ops_consumed < length) {
                        char qbase = query_seq[qp];
                        char vbase = aseq[a.matched + a.inserted];
                        if (qbase == vbase) {
                            ++ops_consumed;
                            a.quality += has_quals ? query_quals[qp] : 30;
                            ++a.matched;
                            ++a.progress;
                        } else break;
                    }
                    if (ops_consumed < length && a.progress < a.length) a.progress = -1;
                } else if (kind == 1) {
                    int ops_consumed = 0;
                    while (a.inserted < a.insert_target && ops_consumed < length) {
                        ++ops_consumed;
                        char qbase = query_seq[st.query_start + a.matched + a.inserted];
                        char vbase = aseq[a.matched + a.inserted];
                        if (qbase == vbase) {
                            ++a.inserted;
                            ++a.progress;
                            a.quality += 30;
                        } else break;
                    }
                    if (ops_consumed < length && 0 < a.progress && a.progress < a.length)
                        a.progress = -1;
                } else {
                    int ops_consumed = 0;
                    while (a.deleted < a.delete_target && ops_consumed < length) {
                        ++ops_consumed;
                        ++a.deleted;
                        ++a.progress;
                        a.quality += 30;
                    }
                    if (ops_consumed < length && a.progress < a.length) a.progress = -1;
                }
            }
        }
        ref_pos = ref_end;
        query_pos = query_end;

        // emit resolved variants from the left; stop at the first pending
        while (!vqueue.empty()) {
            VariantState st = std::move(vqueue.front());
            vqueue.pop_front();
            int r = flush_entry(st);
            if (r == -1) {
                vqueue.push_front(std::move(st));
                break;
            }
        }
    }

    for (VariantState& st : vqueue) flush_entry(st);
    return count;
}

}  // extern "C"
// ---------------------------------------------------------------------------
// Batched realignment scoring: one call per read instead of one Python ->
// ctypes round trip per (read, variant).  Covers the default realign mode
// (unit-cost edit distance, no affine gaps, no kmerald, no genotype
// restriction); hits it cannot handle exactly (symbolic ALTs, reference
// bound violations) are emitted with allele == -2 so the Python
// _realign_variant path handles them identically.
//
// Semantics mirror whatshap_torch/variants.py _realign_variant +
// _advance_along_cigar (including the N-skip quirk that claims the full
// target) and align.py edit_distance (same DP as alignlib.cpp).

namespace {

int edit_distance_affine(const char* sv, int m, const char* tv, int n,
                         int mismatch_cost, int gap_start, int gap_extend) {
    // identical to wh_edit_distance_affine_gap (alignlib.cpp) with a
    // constant per-position mismatch cost (the realign path passes
    // [default_mismatch] * len(query))
    while (m > 0 && n > 0 && sv[0] == tv[0]) { ++sv; ++tv; --m; --n; }
    while (m > 0 && n > 0 && sv[m - 1] == tv[n - 1]) { --m; --n; }
    std::vector<float> a(m + 1), b(m + 1), c(m + 1);
    a[0] = 0.0f;
    b[0] = 0.0f;
    c[0] = 0.0f;
    for (int i = 1; i <= m; ++i) {
        a[i] = (float)INT32_MAX;
        b[i] = (float)(gap_start + (i - 1) * gap_extend);
        c[i] = (float)INT32_MAX;
    }
    for (int j = 1; j <= n; ++j) {
        float prev_a = a[0], prev_b = b[0], prev_c = c[0];
        a[0] = (float)INT32_MAX;
        b[0] = (float)INT32_MAX;
        c[0] = (float)(gap_start + (j - 1) * gap_extend);
        const char tj = tv[j - 1];
        for (int i = 1; i <= m; ++i) {
            float m_c = (float)mismatch_cost;
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

int edit_distance_unit(const char* s, int m, const char* t, int n) {
    // identical to wh_edit_distance (alignlib.cpp) with maxdiff=-1
    while (m > 0 && n > 0 && s[0] == t[0]) { ++s; ++t; --m; --n; }
    while (m > 0 && n > 0 && s[m - 1] == t[n - 1]) { --m; --n; }
    std::vector<int> costs(m + 1);
    for (int i = 0; i <= m; ++i) costs[i] = i;
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
    return costs[m];
}

// _advance_along_cigar over an element sequence; returns false on an
// unknown op (Python raises AssertionError -> fallback)
bool advance_cigar(const std::vector<std::pair<int, long>>& seq, long target,
                   long* ref_out, long* q_out) {
    long ref = 0, query = 0;
    for (const auto& e : seq) {
        int op = e.first;
        long length = e.second;
        if (op == 0 || op == 7 || op == 8) {  // M, =, X
            ref += length;
            query += length;
            if (ref >= target) { *ref_out = target; *q_out = query - (ref - target); return true; }
        } else if (op == 2) {  // D
            ref += length;
            if (ref >= target) { *ref_out = target; *q_out = query; return true; }
        } else if (op == 1) {  // I
            query += length;
        } else if (op == 4 || op == 5) {  // S, H
        } else if (op == 3) {  // N quirk: claim the full target
            *ref_out = target; *q_out = query; return true;
        } else {
            return false;
        }
    }
    *ref_out = ref;
    *q_out = query;
    return true;
}

}  // namespace

extern "C" int32_t wh_realign_read(
    const int64_t* var_positions, int32_t n_vars, int32_t j0,
    const int32_t* ref_lens,
    const int32_t* alt_off,      // n_vars+1: per-variant alt range
    const int32_t* alt_seq_off,  // n_alts+1: per-alt offset into alt_seq
    const char* alt_seq,
    const uint8_t* skip,         // per variant: needs the Python path
    const char* reference, int64_t ref_total_len,
    int64_t ref_start,
    const int32_t* cigar_ops, const int32_t* cigar_lens, int32_t n_cigar,
    const char* query, int32_t query_len,
    int32_t overhang,
    int32_t use_affine, int32_t default_mismatch, int32_t gap_start,
    int32_t gap_extend,
    int32_t* out_index, int32_t* out_allele, int32_t* out_quality, int32_t cap) {
    (void)query_len;
    std::vector<int32_t> hi(cap), he(cap), hc(cap), hq(cap);
    int32_t n_hits = wh_iterate_cigar(
        var_positions, n_vars, j0, ref_start, cigar_ops, cigar_lens, n_cigar,
        hi.data(), he.data(), hc.data(), hq.data(), cap);
    int32_t count = 0;
    std::vector<std::pair<int, long>> seq;
    std::vector<char> hap;
    for (int32_t h = 0; h < n_hits && count < cap; ++h) {
        int idx = hi[h], i = he[h], consumed = hc[h];
        long qpos = hq[h];
        int32_t allele = -2;  // Python fallback by default
        int32_t quality = 0;
        if (!skip[idx]) {
            int64_t pos = var_positions[idx];
            long reflen = ref_lens[idx];
            // left: prefix reversed from the split point
            seq.clear();
            if (consumed > 0) seq.emplace_back(cigar_ops[i], (long)consumed);
            for (int j = i - 1; j >= 0; --j)
                seq.emplace_back(cigar_ops[j], (long)cigar_lens[j]);
            long left_ref, left_query;
            bool ok = advance_cigar(seq, overhang, &left_ref, &left_query);
            // right: suffix from the split point
            seq.clear();
            if (consumed < cigar_lens[i])
                seq.emplace_back(cigar_ops[i], (long)(cigar_lens[i] - consumed));
            for (int j = i + 1; j < n_cigar; ++j)
                seq.emplace_back(cigar_ops[j], (long)cigar_lens[j]);
            long right_ref, right_query;
            ok = ok && advance_cigar(seq, reflen + overhang, &right_ref, &right_query);
            if (ok && pos - left_ref >= 0 && pos + right_ref <= ref_total_len) {
                const char* q = query + (qpos - left_query);
                int qlen = (int)(left_query + right_query);
                const char* left_pad = reference + (pos - left_ref);
                long right_pad_len = right_ref - reflen;
                if (right_pad_len < 0) right_pad_len = 0;
                const char* right_pad = reference + (pos + reflen);
                // allele 0: the reference haplotype window
                auto score = [&](const char* hp, int hlen) {
                    if (use_affine)
                        return edit_distance_affine(q, qlen, hp, hlen,
                                                    default_mismatch, gap_start,
                                                    gap_extend);
                    return edit_distance_unit(q, qlen, hp, hlen);
                };
                int best_a = 0;
                int best_d = score(left_pad, (int)(left_ref + right_ref));
                int second_d = INT32_MAX;
                for (int32_t a = alt_off[idx]; a < alt_off[idx + 1]; ++a) {
                    hap.clear();
                    hap.insert(hap.end(), left_pad, left_pad + left_ref);
                    hap.insert(hap.end(), alt_seq + alt_seq_off[a],
                               alt_seq + alt_seq_off[a + 1]);
                    hap.insert(hap.end(), right_pad, right_pad + right_pad_len);
                    int d = score(hap.data(), (int)hap.size());
                    if (d < best_d) {
                        second_d = best_d;
                        best_d = d;
                        best_a = (int)(a - alt_off[idx]) + 1;
                    } else if (d < second_d) {
                        second_d = d;
                    }
                }
                if (second_d == best_d) {
                    allele = -1;  // tie -> variant skipped (Python returns None)
                } else {
                    allele = best_a;
                    // affine mode reports scored[0] - scored[1] (best minus
                    // second best -- NEGATIVE, a reference quirk replicated
                    // by the Python path); unit mode a constant 30
                    quality = use_affine
                                  ? (second_d == INT32_MAX ? best_d
                                                           : best_d - second_d)
                                  : 30;
                }
            }
        }
        out_index[count] = idx;
        out_allele[count] = allele;
        out_quality[count] = quality;
        ++count;
    }
    return count;
}

// ---------------------------------------------------------------------------
// Pool-batched realignment: one call for EVERY record of a chromosome,
// straight off the raw BAM record pool produced by bamlib.cpp.
// Replaces, for the default phase/genotype read path, the per-record
// Python chain parse_bam_record -> _usable_alignments ->
// _detect_by_realignment (whatshap_torch/variants.py) with a single native
// pass: header-field filtering (tid, flags, mapq), read-group sample
// filtering, CIGAR + 4-bit sequence decode, and the same realignment
// scoring as wh_realign_read, parallelized over records with std::thread.
//
// Records the fast pass cannot reproduce exactly (symbolic ALTs in range,
// missing sequence, odd tag types) get status -2 and are re-processed by
// the Python fallback path, one by one, with identical semantics.

#include <cstring>
#include <thread>

namespace {

constexpr char kSeqNT16[] = "=ACMGRSVTWYHKDBN";

constexpr int32_t kStatusFiltered = -1;
constexpr int32_t kStatusFallback = -2;

struct RecMeta {
    int32_t status = kStatusFiltered;  // >=0: kept, #hits after tie-drop
    int32_t flag = 0;
    int32_t mapq = 0;
    int64_t ref_start = -1;
    int64_t ref_end = -1;
    int32_t hp = -1;
    int64_t ps = -1;
    int64_t name_off = 0;
    int32_t name_len = 0;
    int64_t bx_off = -1;
    int32_t bx_len = 0;
};

struct RealignPoolResult {
    std::vector<RecMeta> meta;
    std::vector<int64_t> hit_off;  // n_rec + 1
    std::vector<int32_t> hit_var, hit_allele, hit_qual;
};

struct TagScan {
    int64_t rg_off = -1;
    int32_t rg_len = 0;
    int64_t bx_off = -1;
    int32_t bx_len = 0;
    int64_t hp = -1;
    int64_t ps = -1;
    bool bad = false;  // tag block truncated or HP/PS of a non-int type
};

// Scan one record's aux block.  `base` is the pool origin (offsets into it
// are returned so Python can slice string values without another parse).
void scan_tags(const uint8_t* base, int64_t off, int64_t end, TagScan* out) {
    int64_t p = off;
    while (p + 3 <= end) {
        const char t0 = (char)base[p], t1 = (char)base[p + 1];
        const char typ = (char)base[p + 2];
        int64_t val = p + 3;
        int64_t vlen = 0;
        int64_t ival = 0;
        bool is_int = false;
        switch (typ) {
            case 'A': vlen = 1; break;
            case 'c': if (val >= end) { out->bad = true; return; }
                ival = (int8_t)base[val]; is_int = true; vlen = 1; break;
            case 'C': if (val >= end) { out->bad = true; return; }
                ival = base[val]; is_int = true; vlen = 1; break;
            case 's': { if (val + 2 > end) { out->bad = true; return; }
                int16_t v; std::memcpy(&v, base + val, 2);
                ival = v; is_int = true; vlen = 2; break; }
            case 'S': { if (val + 2 > end) { out->bad = true; return; }
                uint16_t v; std::memcpy(&v, base + val, 2);
                ival = v; is_int = true; vlen = 2; break; }
            case 'i': { if (val + 4 > end) { out->bad = true; return; }
                int32_t v; std::memcpy(&v, base + val, 4);
                ival = v; is_int = true; vlen = 4; break; }
            case 'I': { if (val + 4 > end) { out->bad = true; return; }
                uint32_t v; std::memcpy(&v, base + val, 4);
                ival = (int64_t)v; is_int = true; vlen = 4; break; }
            case 'f': vlen = 4; break;
            case 'Z': case 'H': {
                int64_t q = val;
                while (q < end && base[q]) ++q;
                if (q >= end) { out->bad = true; return; }  // missing NUL
                vlen = q - val + 1;
                break;
            }
            case 'B': {
                if (val + 5 > end) { out->bad = true; return; }
                const char sub = (char)base[val];
                uint32_t n; std::memcpy(&n, base + val + 1, 4);
                int64_t esz = (sub == 'c' || sub == 'C') ? 1
                            : (sub == 's' || sub == 'S') ? 2 : 4;
                vlen = 5 + (int64_t)n * esz;
                break;
            }
            default: out->bad = true; return;
        }
        if (val + vlen > end) { out->bad = true; return; }
        if (t0 == 'R' && t1 == 'G') {
            if (typ == 'Z') { out->rg_off = val; out->rg_len = (int32_t)(vlen - 1); }
        } else if (t0 == 'B' && t1 == 'X') {
            if (typ == 'Z') { out->bx_off = val; out->bx_len = (int32_t)(vlen - 1); }
            else { out->bad = true; return; }
        } else if (t0 == 'H' && t1 == 'P') {
            if (is_int) out->hp = ival;
            else { out->bad = true; return; }
        } else if (t0 == 'P' && t1 == 'S') {
            if (is_int) out->ps = ival;
            else { out->bad = true; return; }
        }
        p = val + vlen;
    }
    if (p != end) out->bad = true;
}

}  // namespace

extern "C" void* wh_realign_pool(
    const uint8_t* pool, const uint64_t* rec_off, int64_t n_rec,
    int32_t target_tid, int32_t mapq_threshold, int32_t keep_duplicates,
    // allowed read-group ids, concatenated (sample filter); n_rg == 0
    // means "no RG filtering" (ignore-read-groups mode)
    const char* rg_concat, const int32_t* rg_off, int32_t n_rg,
    // shared variant tables, identical to wh_realign_read
    const int64_t* var_positions, int32_t n_vars,
    const int32_t* ref_lens, const int32_t* alt_off, const int32_t* alt_seq_off,
    const char* alt_seq, const uint8_t* skip,
    const char* reference, int64_t ref_total_len,
    int32_t overhang, int32_t use_affine, int32_t default_mismatch,
    int32_t gap_start, int32_t gap_extend, int32_t n_threads) {
    auto* res = new RealignPoolResult();
    res->meta.assign(n_rec, RecMeta());
    res->hit_off.assign(n_rec + 1, 0);

    if (n_threads < 1) n_threads = 1;
    int hw = (int)std::thread::hardware_concurrency();
    if (hw > 0 && n_threads > hw) n_threads = hw;
    if (n_threads > n_rec) n_threads = (int32_t)(n_rec > 0 ? n_rec : 1);

    struct ThreadOut {
        std::vector<int32_t> var, allele, qual;
    };
    std::vector<ThreadOut> touts(n_threads);

    auto work = [&](int ti, int64_t lo, int64_t hi, ThreadOut* tout) {
        (void)ti;
        std::vector<int32_t> ops, lens;
        std::vector<char> seq;
        std::vector<int32_t> hidx, hallele, hqual;
        for (int64_t r = lo; r < hi; ++r) {
            RecMeta& m = res->meta[r];
            const int64_t o = (int64_t)rec_off[r];
            const int64_t oe = (int64_t)rec_off[r + 1];
            if (oe - o < 32) { m.status = kStatusFallback; continue; }
            int32_t ref_id, pos, l_seq, next_ref, next_pos, tlen;
            std::memcpy(&ref_id, pool + o, 4);
            std::memcpy(&pos, pool + o + 4, 4);
            const uint8_t l_read_name = pool[o + 8];
            const uint8_t mapq = pool[o + 9];
            uint16_t n_cigar, flag;
            std::memcpy(&n_cigar, pool + o + 12, 2);
            std::memcpy(&flag, pool + o + 14, 2);
            std::memcpy(&l_seq, pool + o + 16, 4);
            std::memcpy(&next_ref, pool + o + 20, 4);
            std::memcpy(&next_pos, pool + o + 24, 4);
            std::memcpy(&tlen, pool + o + 28, 4);
            if (ref_id != target_tid) continue;               // other contig
            if (flag & 0x4) continue;                         // unmapped
            if (flag & 0x100) continue;                       // secondary
            if (flag & 0x800) continue;                       // supplementary
            if ((flag & 0x400) && !keep_duplicates) continue; // duplicate
            if ((int32_t)mapq < mapq_threshold) continue;     // mapq screen

            const int64_t name_off = o + 32;
            const int64_t cig_off = name_off + l_read_name;
            const int64_t seq_off = cig_off + 4LL * n_cigar;
            const int64_t nseq_bytes = ((int64_t)l_seq + 1) / 2;
            const int64_t qual_off = seq_off + nseq_bytes;
            const int64_t tag_off = qual_off + l_seq;
            if (tag_off > oe) { m.status = kStatusFallback; continue; }

            TagScan tags;
            scan_tags(pool, tag_off, oe, &tags);
            if (n_rg > 0) {
                // sample filter: RG tag must exist and match an allowed id
                if (tags.rg_off < 0) continue;
                bool match = false;
                for (int32_t g = 0; g < n_rg && !match; ++g) {
                    const int32_t glen = rg_off[g + 1] - rg_off[g];
                    match = glen == tags.rg_len &&
                            std::memcmp(rg_concat + rg_off[g],
                                        pool + tags.rg_off, glen) == 0;
                }
                if (!match) continue;
            }
            // past every screen: this record WOULD reach _empty_read_for,
            // whose PS validation can raise -- odd tags go to Python
            if (tags.bad) { m.status = kStatusFallback; continue; }
            if (n_cigar == 0 || l_seq == 0) { m.status = kStatusFallback; continue; }

            m.flag = flag;
            m.mapq = mapq;
            m.ref_start = pos;
            m.hp = (int32_t)tags.hp;
            m.ps = tags.ps;
            m.name_off = name_off;
            m.name_len = l_read_name > 0 ? l_read_name - 1 : 0;
            m.bx_off = tags.bx_off;
            m.bx_len = tags.bx_len;

            ops.resize(n_cigar);
            lens.resize(n_cigar);
            int64_t ref_end = pos;
            for (int32_t ci = 0; ci < n_cigar; ++ci) {
                uint32_t c;
                std::memcpy(&c, pool + cig_off + 4LL * ci, 4);
                const int op = (int)(c & 0xF);
                const int32_t ln = (int32_t)(c >> 4);
                ops[ci] = op;
                lens[ci] = ln;
                if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                    ref_end += ln;
            }
            m.ref_end = ref_end;

            seq.resize(l_seq);
            for (int32_t b = 0; b < l_seq; ++b) {
                const uint8_t byte = pool[seq_off + (b >> 1)];
                seq[b] = kSeqNT16[(b & 1) ? (byte & 0xF) : (byte >> 4)];
            }

            // cursor + hit capacity from the variant span
            const int64_t* vlo =
                std::lower_bound(var_positions, var_positions + n_vars, (int64_t)pos);
            const int64_t* vhi = std::lower_bound(
                var_positions + (vlo - var_positions), var_positions + n_vars,
                ref_end + 1);
            const int32_t j0 = (int32_t)(vlo - var_positions);
            const int32_t cap = (int32_t)(vhi - vlo) + 1;
            hidx.resize(cap);
            hallele.resize(cap);
            hqual.resize(cap);
            const int32_t n = wh_realign_read(
                var_positions, n_vars, j0, ref_lens, alt_off, alt_seq_off,
                alt_seq, skip, reference, ref_total_len, pos,
                ops.data(), lens.data(), n_cigar, seq.data(), l_seq, overhang,
                use_affine, default_mismatch, gap_start, gap_extend,
                hidx.data(), hallele.data(), hqual.data(), cap);
            bool fallback = n < 0 || n > cap;
            int32_t kept = 0;
            for (int32_t h = 0; h < n && !fallback; ++h) {
                if (hallele[h] == -2) fallback = true;  // Python path needed
            }
            if (fallback) { m.status = kStatusFallback; continue; }
            for (int32_t h = 0; h < n; ++h) {
                if (hallele[h] < 0) continue;  // tie: variant skipped
                const int32_t n_alts = alt_off[hidx[h] + 1] - alt_off[hidx[h]];
                if (hallele[h] > n_alts) continue;
                tout->var.push_back(hidx[h]);
                tout->allele.push_back(hallele[h]);
                tout->qual.push_back(hqual[h]);
                ++kept;
            }
            m.status = kept;
        }
    };

    if (n_threads <= 1 || n_rec == 0) {
        work(0, 0, n_rec, &touts[0]);
    } else {
        std::vector<std::thread> threads;
        const int64_t chunk = (n_rec + n_threads - 1) / n_threads;
        for (int ti = 0; ti < n_threads; ++ti) {
            const int64_t lo = ti * chunk;
            const int64_t hi = std::min<int64_t>(lo + chunk, n_rec);
            if (lo >= hi) break;
            threads.emplace_back(work, ti, lo, hi, &touts[ti]);
        }
        for (auto& t : threads) t.join();
    }

    int64_t total = 0;
    for (int64_t r = 0; r < n_rec; ++r) {
        res->hit_off[r] = total;
        if (res->meta[r].status > 0) total += res->meta[r].status;
    }
    res->hit_off[n_rec] = total;
    res->hit_var.reserve(total);
    res->hit_allele.reserve(total);
    res->hit_qual.reserve(total);
    for (auto& t : touts) {  // threads own contiguous record ranges in order
        res->hit_var.insert(res->hit_var.end(), t.var.begin(), t.var.end());
        res->hit_allele.insert(res->hit_allele.end(), t.allele.begin(), t.allele.end());
        res->hit_qual.insert(res->hit_qual.end(), t.qual.begin(), t.qual.end());
    }
    return res;
}

extern "C" int64_t wh_realign_pool_n_hits(void* h) {
    return ((RealignPoolResult*)h)->hit_off.back();
}

extern "C" void wh_realign_pool_fetch(
    void* h, int32_t* status, int32_t* flag, int32_t* mapq,
    int64_t* ref_start, int64_t* ref_end, int32_t* hp, int64_t* ps,
    int64_t* name_off, int32_t* name_len, int64_t* bx_off, int32_t* bx_len,
    int64_t* hit_off, int32_t* hit_var, int32_t* hit_allele,
    int32_t* hit_qual) {
    auto* res = (RealignPoolResult*)h;
    const int64_t n_rec = (int64_t)res->meta.size();
    for (int64_t r = 0; r < n_rec; ++r) {
        const RecMeta& m = res->meta[r];
        status[r] = m.status;
        flag[r] = m.flag;
        mapq[r] = m.mapq;
        ref_start[r] = m.ref_start;
        ref_end[r] = m.ref_end;
        hp[r] = m.hp;
        ps[r] = m.ps;
        name_off[r] = m.name_off;
        name_len[r] = m.name_len;
        bx_off[r] = m.bx_off;
        bx_len[r] = m.bx_len;
        hit_off[r] = res->hit_off[r];
    }
    hit_off[n_rec] = res->hit_off[n_rec];
    std::memcpy(hit_var, res->hit_var.data(), res->hit_var.size() * 4);
    std::memcpy(hit_allele, res->hit_allele.data(), res->hit_allele.size() * 4);
    std::memcpy(hit_qual, res->hit_qual.data(), res->hit_qual.size() * 4);
}

extern "C" void wh_realign_pool_free(void* h) {
    delete (RealignPoolResult*)h;
}
