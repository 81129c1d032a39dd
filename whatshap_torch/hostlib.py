"""
The host helpers, loaded with ctypes: the C++ sources in csrc/host/, built
with g++ at first use by ops/_build.build_host into build/whatshap_torch/.

    alignlib       banded and affine-gap edit distance (align.py)
    bamlib         whole-file BAM decode into one record pool (io/sam.py)
    cigarlib       the CIGAR walk, reference-free allele detection and the
                   threaded realignment pool (variants.py)
    readselectlib  read selection in one call (readselect.py)
    pqext          the selection heap, a CPython extension (priorityqueue.py)
    hapchatlib     the HapCHAT column DP of phase --algorithm hapchat
                   (solver/hapchat.py)
    heurlib        the PedMEC beam search of phase --algorithm heuristic
                   (solver/heuristic.py)
    switchfliplib  the switch/flip distance of compare
                   (polyphase/switchflip.py)
    clusterlib     polyphase's cluster editing (polyphase/clusterediting.py)
    threadlib      polyphase's haplotype threading DP
                   (polyphase/haplothreader.py)
    scorelib       polyphase's read-pair scoring (polyphase/readscoring.py)

Each is an attribute of this module, built and loaded the first time it is
read (nothing is built at import); a build or load that fails raises
RuntimeError with the compiler's output.  The modules above take their
Python paths only where an attribute is None, which tests and chip_smoke.py
set to hold the helpers against those paths.
"""

import ctypes
import importlib.machinery
import importlib.util
import threading

from .ops import _build

__all__ = [
    "alignlib", "bamlib", "cigarlib", "readselectlib", "pqext",
    "hapchatlib", "heurlib", "switchfliplib",
    "clusterlib", "threadlib", "scorelib",
]

_LOCK = threading.Lock()


class _AlignLib:
    def __init__(self, cdll):
        self._lib = cdll
        self._lib.wh_edit_distance.restype = ctypes.c_int
        self._lib.wh_edit_distance.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
        ]
        self._lib.wh_edit_distance_affine_gap.restype = ctypes.c_int
        self._lib.wh_edit_distance_affine_gap.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_int,
        ]

    def edit_distance(self, s: bytes, t: bytes, maxdiff: int = -1) -> int:
        return self._lib.wh_edit_distance(s, len(s), t, len(t), maxdiff)

    def edit_distance_affine_gap(self, q, r, mismatch_cost, gap_start, gap_extend):
        arr = (ctypes.c_int * len(mismatch_cost))(*mismatch_cost)
        return self._lib.wh_edit_distance_affine_gap(
            q, len(q), r, len(r), arr, gap_start, gap_extend
        )


class _BamLib:
    def __init__(self, cdll):
        c = self._lib = cdll
        c.wh_bam_load.restype = ctypes.c_void_p
        c.wh_bam_load.argtypes = [ctypes.c_char_p]
        c.wh_bam_n_records.restype = ctypes.c_uint64
        c.wh_bam_n_records.argtypes = [ctypes.c_void_p]
        c.wh_bam_pool.restype = ctypes.POINTER(ctypes.c_uint8)
        c.wh_bam_pool.argtypes = [ctypes.c_void_p]
        c.wh_bam_pool_size.restype = ctypes.c_uint64
        c.wh_bam_pool_size.argtypes = [ctypes.c_void_p]
        c.wh_bam_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
        c.wh_bam_offsets.argtypes = [ctypes.c_void_p]
        c.wh_bam_fixed.restype = ctypes.POINTER(ctypes.c_int32)
        c.wh_bam_fixed.argtypes = [ctypes.c_void_p]
        c.wh_bam_header_text.restype = ctypes.c_char_p
        c.wh_bam_header_text.argtypes = [ctypes.c_void_p]
        c.wh_bam_n_refs.restype = ctypes.c_int
        c.wh_bam_n_refs.argtypes = [ctypes.c_void_p]
        c.wh_bam_ref_name.restype = ctypes.c_char_p
        c.wh_bam_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        c.wh_bam_ref_len.restype = ctypes.c_int
        c.wh_bam_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        c.wh_bam_free.restype = None
        c.wh_bam_free.argtypes = [ctypes.c_void_p]


class _CigarLib:
    def __init__(self, cdll):
        c = self._lib = cdll
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        c.wh_iterate_cigar.restype = ctypes.c_int32
        c.wh_iterate_cigar.argtypes = [
            i64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            i32p, i32p, ctypes.c_int32,
            i32p, i32p, i32p, i32p, ctypes.c_int32,
        ]
        c.wh_detect_alleles.restype = ctypes.c_int32
        c.wh_detect_alleles.argtypes = [
            i64p, i32p, i32p, ctypes.c_int32,
            i32p, i32p, i32p, i32p, i32p, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_int64,
            i32p, i32p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
            i32p, i32p, i32p, ctypes.c_int32,
        ]
        c.wh_realign_read.restype = ctypes.c_int32
        c.wh_realign_read.argtypes = [
            i64p, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            i32p, i32p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, ctypes.c_int32,
        ]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        c.wh_realign_pool.restype = ctypes.c_void_p
        c.wh_realign_pool.argtypes = [
            ctypes.c_char_p, u64p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, i32p, ctypes.c_int32,
            i64p, ctypes.c_int32,
            i32p, i32p, i32p, ctypes.c_char_p, u8p,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        c.wh_realign_pool_n_hits.restype = ctypes.c_int64
        c.wh_realign_pool_n_hits.argtypes = [ctypes.c_void_p]
        c.wh_realign_pool_fetch.restype = None
        c.wh_realign_pool_fetch.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, i64p, i64p, i32p, i64p,
            i64p, i32p, i64p, i32p, i64p, i32p, i32p, i32p,
        ]
        c.wh_realign_pool_free.restype = None
        c.wh_realign_pool_free.argtypes = [ctypes.c_void_p]

    def realign_pool(
        self, pool, rec_offsets, target_tid, mapq_threshold, keep_duplicates,
        rg_ids, var_positions, n_vars, ref_lens, alt_off, alt_seq_off,
        alt_seq, skip, reference, overhang, use_affine=False,
        default_mismatch=15, gap_start=10, gap_extend=7, n_threads=4,
    ):
        """Batched realignment over a whole BAM record pool (one contig).

        Returns a dict of numpy arrays: per-record `status` (>=0 kept with
        that many hits, -1 filtered, -2 needs the per-record Python path),
        header fields, tag values, and the packed (variant, allele, quality)
        hit arrays with per-record `hit_off` boundaries.  `rg_ids` is an
        iterable of allowed read-group id strings, or None to skip sample
        filtering.  The result does not depend on `n_threads`.
        """
        import numpy as np

        n_rec = len(rec_offsets) - 1
        rec_off = np.ascontiguousarray(rec_offsets, dtype=np.uint64)
        if rg_ids is None:
            rg_concat, rg_off_arr, n_rg = b"", self._i32([0]), 0
        else:
            ids = [s.encode() for s in rg_ids]
            offs = [0]
            for s in ids:
                offs.append(offs[-1] + len(s))
            rg_concat = b"".join(ids)
            rg_off_arr = self._i32(offs)
            n_rg = len(ids)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        h = self._lib.wh_realign_pool(
            pool, rec_off.ctypes.data_as(u64p), n_rec,
            target_tid, mapq_threshold, int(keep_duplicates),
            rg_concat, rg_off_arr, n_rg,
            var_positions, n_vars, ref_lens, alt_off, alt_seq_off,
            alt_seq, skip, reference, len(reference),
            overhang, int(use_affine), default_mismatch, gap_start,
            gap_extend, n_threads,
        )
        if not h:
            return None
        try:
            n_hits = self._lib.wh_realign_pool_n_hits(h)
            out = {
                "status": np.empty(n_rec, np.int32),
                "flag": np.empty(n_rec, np.int32),
                "mapq": np.empty(n_rec, np.int32),
                "ref_start": np.empty(n_rec, np.int64),
                "ref_end": np.empty(n_rec, np.int64),
                "hp": np.empty(n_rec, np.int32),
                "ps": np.empty(n_rec, np.int64),
                "name_off": np.empty(n_rec, np.int64),
                "name_len": np.empty(n_rec, np.int32),
                "bx_off": np.empty(n_rec, np.int64),
                "bx_len": np.empty(n_rec, np.int32),
                "hit_off": np.empty(n_rec + 1, np.int64),
                "hit_var": np.empty(max(n_hits, 1), np.int32),
                "hit_allele": np.empty(max(n_hits, 1), np.int32),
                "hit_qual": np.empty(max(n_hits, 1), np.int32),
            }
            i32p = ctypes.POINTER(ctypes.c_int32)

            def p32(name):
                return out[name].ctypes.data_as(i32p)

            def p64(name):
                return out[name].ctypes.data_as(i64p)

            self._lib.wh_realign_pool_fetch(
                h, p32("status"), p32("flag"), p32("mapq"),
                p64("ref_start"), p64("ref_end"), p32("hp"), p64("ps"),
                p64("name_off"), p32("name_len"), p64("bx_off"), p32("bx_len"),
                p64("hit_off"), p32("hit_var"), p32("hit_allele"),
                p32("hit_qual"),
            )
        finally:
            self._lib.wh_realign_pool_free(h)
        return out

    @staticmethod
    def _i32(xs):
        return (ctypes.c_int32 * max(len(xs), 1))(*xs)

    @staticmethod
    def _i64(xs):
        return (ctypes.c_int64 * max(len(xs), 1))(*xs)

    def iterate_cigar(self, var_positions, j, ref_start, cigar_ops, cigar_lens):
        cap = len(var_positions) - j if len(var_positions) > j else 0
        cap = max(cap, 1)
        oi = (ctypes.c_int32 * cap)()
        oe = (ctypes.c_int32 * cap)()
        oc = (ctypes.c_int32 * cap)()
        oq = (ctypes.c_int32 * cap)()
        n = self._lib.wh_iterate_cigar(
            var_positions, len(var_positions), j, ref_start,
            cigar_ops, cigar_lens, len(cigar_ops), oi, oe, oc, oq, cap,
        )
        if n < 0:
            return None
        return [(oi[k], oe[k], oc[k], oq[k]) for k in range(n)]

    def detect_alleles(
        self, prog_positions, prog_variant_id, prog_ref_len, allele_off,
        match_t, insert_t, delete_t, seq_off, allele_seq,
        first, ref_start, cigar_ops, cigar_lens, query_seq, query_quals,
    ):
        n_prog = len(prog_positions)
        cap = max(n_prog, 1)
        ov = (ctypes.c_int32 * cap)()
        oa = (ctypes.c_int32 * cap)()
        oq = (ctypes.c_int32 * cap)()
        if query_quals is not None:
            quals = (ctypes.c_int8 * max(len(query_quals), 1))(*query_quals)
            has_quals = 1
        else:
            quals = (ctypes.c_int8 * 1)()
            has_quals = 0
        n = self._lib.wh_detect_alleles(
            prog_positions, prog_variant_id, prog_ref_len, n_prog,
            allele_off, match_t, insert_t, delete_t, seq_off, allele_seq,
            first, ref_start, cigar_ops, cigar_lens, len(cigar_ops),
            query_seq.encode() if isinstance(query_seq, str) else query_seq,
            len(query_seq), quals, has_quals, ov, oa, oq, cap,
        )
        if n < 0:
            return None
        return [(ov[k], oa[k], oq[k]) for k in range(n)]

    def realign_read(
        self, var_positions, n_vars, j0, ref_lens, alt_off, alt_seq_off,
        alt_seq, skip, reference, ref_start, cigar_ops, cigar_lens,
        query_seq, overhang, use_affine=False, default_mismatch=15,
        gap_start=10, gap_extend=7,
    ):
        cap = max(n_vars - j0, 1)
        oi = (ctypes.c_int32 * cap)()
        oa = (ctypes.c_int32 * cap)()
        oq = (ctypes.c_int32 * cap)()
        n = self._lib.wh_realign_read(
            var_positions, n_vars, j0, ref_lens, alt_off, alt_seq_off,
            alt_seq, skip, reference, len(reference), ref_start,
            cigar_ops, cigar_lens, len(cigar_ops),
            query_seq.encode() if isinstance(query_seq, str) else query_seq,
            len(query_seq), overhang,
            int(use_affine), default_mismatch, gap_start, gap_extend,
            oi, oa, oq, cap,
        )
        return [(oi[k], oa[k], oq[k]) for k in range(n)]


class _ReadSelectLib:
    def __init__(self, cdll):
        c = self._lib = cdll
        i32p = ctypes.POINTER(ctypes.c_int32)
        c.wh_readselection.restype = ctypes.c_int32
        c.wh_readselection.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]

    def readselection(self, read_off, vidx, quals, n_positions, max_cov, bridging):
        """Run the full slice/bridging selection; returns the selected-read
        boolean mask as a numpy array.  Inputs are int32 numpy arrays:
        CSR offsets per read into the (position index, quality) columns."""
        import numpy as np

        n_reads = len(read_off) - 1
        out = np.zeros(max(n_reads, 1), dtype=np.uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._lib.wh_readselection(
            n_reads, n_positions,
            read_off.ctypes.data_as(i32p),
            vidx.ctypes.data_as(i32p),
            quals.ctypes.data_as(i32p),
            max_cov, int(bridging),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out[:n_reads]


class _HeurLib:
    def __init__(self, cdll):
        c = self._lib = cdll
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        c.wh_pedmec_heuristic.restype = ctypes.c_int32
        c.wh_pedmec_heuristic.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            f64p, f64p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, f64p,
            ctypes.POINTER(ctypes.c_uint8), i32p, i32p, i32p, i32p, i32p,
        ]

    def solve(
        self, m, n, num_samples, trios, tm_bits, row_limit, distrust,
        recomb_cost, mutation_cost, genotypes_flat,
        read_sample, read_first, read_last, var_off, var_pos, var_allele, var_qual,
    ):
        """Returns (bipart list, trans list, haps[sample][hap][col],
        mutations[sample] list of (hap, col))."""
        def i32(xs):
            return (ctypes.c_int32 * max(len(xs), 1))(*xs)

        def f64(xs):
            return (ctypes.c_double * max(len(xs), 1))(*xs)

        out_bipart = (ctypes.c_uint8 * max(m, 1))()
        out_trans = (ctypes.c_int32 * max(n, 1))()
        out_haps = (ctypes.c_int32 * max(num_samples * 2 * n, 1))()
        cap = max(2 * n * num_samples, 1)
        out_ms = (ctypes.c_int32 * cap)()
        out_mh = (ctypes.c_int32 * cap)()
        out_mp = (ctypes.c_int32 * cap)()
        trios_flat = [x for t in trios for x in t]
        nm = self._lib.wh_pedmec_heuristic(
            m, n, num_samples, len(trios), tm_bits, row_limit, int(distrust),
            f64(recomb_cost), f64(mutation_cost), i32(trios_flat), i32(genotypes_flat),
            i32(read_sample), i32(read_first), i32(read_last),
            i32(var_off), i32(var_pos), i32(var_allele), f64(var_qual),
            out_bipart, out_trans, out_haps, out_ms, out_mh, out_mp,
        )
        if nm < 0:
            return None
        bipart = [bool(out_bipart[i]) for i in range(m)]
        trans = [int(out_trans[p]) for p in range(n)]
        haps = [
            [[int(out_haps[(s * 2 + h) * n + p]) for p in range(n)] for h in range(2)]
            for s in range(num_samples)
        ]
        mutations = [[] for _ in range(num_samples)]
        for i in range(nm):
            mutations[out_ms[i]].append((int(out_mh[i]), int(out_mp[i])))
        return bipart, trans, haps, mutations


class _HapchatLib:
    def __init__(self, cdll):
        c = self._lib = cdll
        i32p = ctypes.POINTER(ctypes.c_int32)
        c.wh_hapchat_solve.restype = ctypes.c_int32
        c.wh_hapchat_solve.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, i32p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double),
        ]

    def solve(self, n_reads, n_cols, var_off, var_pos, var_allele, var_qual):
        """Returns (hap1 list, hap2 list, optimal cost) or None."""
        def i32(xs):
            return (ctypes.c_int32 * max(len(xs), 1))(*xs)

        h1 = (ctypes.c_uint8 * max(n_cols, 1))()
        h2 = (ctypes.c_uint8 * max(n_cols, 1))()
        cost = ctypes.c_double()
        rc = self._lib.wh_hapchat_solve(
            n_reads, n_cols, i32(var_off), i32(var_pos), i32(var_allele),
            i32(var_qual), h1, h2, ctypes.byref(cost),
        )
        if rc != 0:
            return None
        return (
            [bool(h1[c]) for c in range(n_cols)],
            [bool(h2[c]) for c in range(n_cols)],
            cost.value,
        )


class _SwitchFlipLib:
    def __init__(self, cdll):
        c = self._lib = cdll
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        c.wh_switchflip.restype = ctypes.c_int32
        c.wh_switchflip.argtypes = [
            ctypes.c_int32, ctypes.c_double, ctypes.c_double, ctypes.c_int32,
            i32p, i32p, f64p, f64p, i32p, i32p, i32p, i32p,
        ]

    def compute(self, ploidy, switch_cost, flip_cost, num_vars, phase0_flat, phase1_flat):
        """Returns (switches, flips, sw_col, fl_col, perm_col) or None for
        a DP dead-end (caller returns inf)."""
        def i32(xs):
            return (ctypes.c_int32 * max(len(xs), 1))(*xs)

        sw = ctypes.c_double()
        fl = ctypes.c_double()
        sw_col = (ctypes.c_int32 * max(num_vars, 1))()
        fl_off = (ctypes.c_int32 * (num_vars + 1))()
        fl_haps = (ctypes.c_int32 * max(num_vars * ploidy, 1))()
        perm_col = (ctypes.c_int32 * max(num_vars * ploidy, 1))()
        rc = self._lib.wh_switchflip(
            ploidy, switch_cost, flip_cost, num_vars,
            i32(phase0_flat), i32(phase1_flat),
            ctypes.byref(sw), ctypes.byref(fl), sw_col, fl_off, fl_haps, perm_col,
        )
        if rc != 0:
            return None
        switches_in_column = [int(sw_col[i]) for i in range(num_vars)]
        flips_in_column = [
            [int(fl_haps[k]) for k in range(fl_off[i], fl_off[i + 1])]
            for i in range(num_vars)
        ]
        perm_in_column = [
            [int(perm_col[i * ploidy + j]) for j in range(ploidy)] for i in range(num_vars)
        ]
        return sw.value, fl.value, switches_in_column, flips_in_column, perm_in_column


class _ClusterLib:
    def __init__(self, cdll):
        c = self._lib = cdll
        c.wh_cluster_run.restype = ctypes.c_longlong
        c.wh_cluster_run.argtypes = [
            ctypes.c_int,
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        c.wh_cluster_nodes.restype = ctypes.POINTER(ctypes.c_int)
        c.wh_cluster_nodes.argtypes = []
        c.wh_cluster_offsets.restype = ctypes.POINTER(ctypes.c_int64)
        c.wh_cluster_offsets.argtypes = []

    def run(self, n_nodes, us, vs, ws, bundle_edges):
        import numpy as np

        n = len(us)
        ua = np.ascontiguousarray(us, dtype=np.int32)
        va = np.ascontiguousarray(vs, dtype=np.int32)
        wa = np.ascontiguousarray(ws, dtype=np.float32)
        k = self._lib.wh_cluster_run(
            n_nodes,
            n,
            ua.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            va.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            wa.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(bundle_edges),
        )
        nodes_p = self._lib.wh_cluster_nodes()
        offs_p = self._lib.wh_cluster_offsets()
        if k <= 0:
            return []
        offs = np.ctypeslib.as_array(offs_p, shape=(k + 1,))
        nodes = np.ctypeslib.as_array(nodes_p, shape=(int(offs[k]),)).tolist()
        return [nodes[offs[i] : offs[i + 1]] for i in range(k)]


class _ThreadLib:
    def __init__(self, cdll):
        c = self._lib = cdll
        c.wh_thread_paths.restype = ctypes.c_int32
        c.wh_thread_paths.argtypes = [
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]

    def thread_paths(
        self,
        num_vars,
        ploidy,
        switch_cost,
        affine_switch_cost,
        max_cluster_gap,
        row_limit,
        block_starts,
        cov_offsets,
        cov_ids,
        cov_totals,
    ):
        import numpy as np

        p32 = ctypes.POINTER(ctypes.c_int32)

        def _arr(seq):
            a = np.ascontiguousarray(
                seq if isinstance(seq, np.ndarray) else np.fromiter(seq, np.int32, count=len(seq)),
                dtype=np.int32,
            )
            if a.size == 0:
                a = np.zeros(1, np.int32)
            return a

        bs, co, ci, ct = _arr(block_starts), _arr(cov_offsets), _arr(cov_ids), _arr(cov_totals)
        out = np.empty(num_vars * ploidy, np.int32)
        n = self._lib.wh_thread_paths(
            num_vars,
            ploidy,
            switch_cost,
            affine_switch_cost,
            max_cluster_gap,
            row_limit,
            bs.ctypes.data_as(p32),
            len(block_starts),
            co.ctypes.data_as(p32),
            ci.ctypes.data_as(p32),
            ct.ctypes.data_as(p32),
            out.ctypes.data_as(p32),
        )
        if n < 0:
            return None
        return out[: n * ploidy].reshape(n, ploidy).tolist()


class _ScoreLib:
    def __init__(self, cdll):
        c = self._lib = cdll
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        c.wh_score_pairs.restype = ctypes.c_int64
        c.wh_score_pairs.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, u32p, u32p, i32p, i32p, f32p,
            ctypes.c_int32, ctypes.c_float,
            i32p, i32p, f32p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]

    def score_pairs(
        self, n_reads, num_alleles, read_off, read_pos, read_allele,
        first_pos, last_pos, sorted_reads, lut_of_pos, luts_flat,
        min_overlap, offset, cap,
    ):
        """Returns (i_array, j_array, score_array, nan_count) or None.

        Inputs may be numpy arrays (zero-copy pointer pass) or plain
        sequences; outputs are numpy views trimmed to the pair count."""
        import numpy as np

        def as_np(xs, dt):
            a = np.ascontiguousarray(xs, dtype=dt)
            return a if a.size else np.zeros(1, dt)

        ro = as_np(read_off, np.int32)
        rp = as_np(read_pos, np.int32)
        ra = as_np(read_allele, np.int32)
        fp = as_np(first_pos, np.uint32)
        lp = as_np(last_pos, np.uint32)
        sr = as_np(sorted_reads, np.int32)
        lop = as_np(lut_of_pos, np.int32)
        lf = as_np(luts_flat, np.float32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        oi = np.empty(max(cap, 1), np.int32)
        oj = np.empty(max(cap, 1), np.int32)
        osc = np.empty(max(cap, 1), np.float32)
        nans = ctypes.c_int64()
        n = self._lib.wh_score_pairs(
            n_reads, num_alleles,
            ro.ctypes.data_as(i32p), rp.ctypes.data_as(i32p),
            ra.ctypes.data_as(i32p), fp.ctypes.data_as(u32p),
            lp.ctypes.data_as(u32p), sr.ctypes.data_as(i32p),
            lop.ctypes.data_as(i32p), lf.ctypes.data_as(f32p),
            min_overlap, offset,
            oi.ctypes.data_as(i32p), oj.ctypes.data_as(i32p),
            osc.ctypes.data_as(f32p), cap, ctypes.byref(nans),
        )
        if n < 0:
            return None
        if n > cap:
            return ("retry", n)
        return oi[:n], oj[:n], osc[:n], nans.value


def _load_extension(path):
    loader = importlib.machinery.ExtensionFileLoader("_pqext", str(path))
    module = importlib.util.module_from_spec(importlib.util.spec_from_loader("_pqext", loader))
    loader.exec_module(module)
    return module


_WRAPPERS = {
    "alignlib": _AlignLib,
    "bamlib": _BamLib,
    "cigarlib": _CigarLib,
    "readselectlib": _ReadSelectLib,
    "hapchatlib": _HapchatLib,
    "heurlib": _HeurLib,
    "switchfliplib": _SwitchFlipLib,
    "clusterlib": _ClusterLib,
    "threadlib": _ThreadLib,
    "scorelib": _ScoreLib,
}


def load(name: str):
    """The helper `name` of __all__, built first if needed (one g++ run)."""
    path = _build.host_library_path(name)
    if not path.exists():
        _build.build_host([name])
    try:
        if name == "pqext":
            return _load_extension(path)
        return _WRAPPERS[name](ctypes.CDLL(str(path)))
    except (OSError, ImportError, AttributeError) as e:
        raise RuntimeError(f"cannot load the host helper {name} from {path}: {e}") from e


def __getattr__(name: str):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    with _LOCK:
        if name not in globals():
            globals()[name] = load(name)
    return globals()[name]
