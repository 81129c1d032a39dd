"""
The host helpers of the read path, loaded with ctypes: the C++ sources in
csrc/host/, built with g++ at first use by ops/_build.build_host into
build/whatshap_torch/.

    alignlib       banded and affine-gap edit distance (align.py)
    bamlib         whole-file BAM decode into one record pool (io/sam.py)
    cigarlib       the CIGAR walk, reference-free allele detection and the
                   threaded realignment pool (variants.py)
    readselectlib  read selection in one call (readselect.py)
    pqext          the selection heap, a CPython extension (priorityqueue.py)

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

__all__ = ["alignlib", "bamlib", "cigarlib", "readselectlib", "pqext"]

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
