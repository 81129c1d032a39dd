"""
Streaming k-mer pileup engine for `whatshap learn` (parity with
src/caller.{h,cpp}): enumerates reference k-mers and per-read k-mers along
the CIGAR, maintains pileup columns in deques, and appends
(position, ref-kmer, read-kmer, count) rows for positions outside variant
windows.
"""

from collections import deque
from typing import Deque, Dict, List, Tuple

_BASE_CODE = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3}

# sentinel standing for the C++ none_dict ({-1: -1})
_NONE_DICT = None


def enumerate_reference_kmers(reference: bytes, k: int) -> List[Tuple[int, int]]:
    """(kmer_hash, end_position) for every position in the reference
    (2-bit rolling hash; non-ACGT characters leave the hash unchanged)."""
    h = 0
    mask = (1 << (2 * k)) - 1
    out = []
    for i, c in enumerate(reference):
        code = _BASE_CODE.get(c)
        if code is not None:
            h = ((h << 2) | code) & mask
        if i >= k - 1:
            out.append((h, i + 1))
    return out


def enumerate_kmers(
    pos: int, query: bytes, k: int, cigartuples: List[Tuple[int, int]]
) -> List[Tuple[int, int]]:
    """(kmer_hash, aligned_end_position) for all k-mers of the read,
    walking the CIGAR (caller.cpp enumerate_kmers)."""
    h = 0
    mask = (1 << (2 * k)) - 1
    cigar_index = 0
    cigar_op, cigar_length = cigartuples[cigar_index]
    i = 0
    consecutive = 0
    out = []
    n = len(query)
    while i < n:
        # process cigar entries that don't consume a read character
        while True:
            if cigar_op in (2, 3):  # D, N
                pos += cigar_length
            elif cigar_op == 4:  # S
                consecutive = 0
            elif cigar_length == 0 or cigar_op == 5:  # exhausted or H
                pass
            else:
                break
            cigar_index += 1
            if cigar_index >= len(cigartuples):
                return out
            cigar_op, cigar_length = cigartuples[cigar_index]
        if i >= n:
            break
        code = _BASE_CODE.get(query[i])
        if code is not None:
            h = ((h << 2) | code) & mask
        consecutive += 1
        if consecutive >= k:
            out.append((h, pos + 1))
        # consume one read character
        assert cigar_length > 0
        if cigar_op in (0, 7, 8):  # M, =, X
            cigar_length -= 1
            pos += 1
        elif cigar_op == 1:  # I
            cigar_length -= 1
        else:
            raise AssertionError(f"unexpected cigar op {cigar_op}")
        i += 1
    return out


class Caller:
    def __init__(self, reference: bytes, k: int, window: int):
        if isinstance(reference, str):
            reference = reference.encode()
        self.k = k
        self.window = window
        self._refk = enumerate_reference_kmers(reference, k)
        self._ri = 0  # index into self._refk (the C++ iterator i1)
        kmer, pos = self._refk[self._ri]
        if self._ri < len(self._refk):
            self._ri += 1
        self.pileup_columns: Deque[Dict[int, int]] = deque([{}])
        self.ref_kmers: Deque[int] = deque([kmer])
        self.ref_pos = pos

        self.kmer_generators: Deque[List[Tuple[int, int]]] = deque()
        self.kmer_generators_finished: Deque[bool] = deque()
        self.iterators: Deque[int] = deque()  # per-generator index
        self.current_kmers: Deque[Tuple[int, int]] = deque()
        self.variantslist: Deque[Tuple[int, int]] = deque()

    def all_variants(self, variant_list) -> None:
        self.variantslist = deque(variant_list)

    def _next_ref_kmer(self) -> Tuple[int, int]:
        if self._ri < len(self._refk):
            kmer, pos = self._refk[self._ri]
            self._ri += 1
        else:
            kmer, pos = self._refk[-1]
        return kmer, pos

    def _get_column(self, pos: int) -> Tuple[int, int]:
        index = pos - self.ref_pos
        if index >= 0:
            while len(self.pileup_columns) <= index:
                kmer, _pos = self._next_ref_kmer()
                self.ref_kmers.append(kmer)
                self.pileup_columns.append({})
            return self.ref_kmers[index], index
        else:
            kmer, _pos = self._next_ref_kmer()
            self.ref_kmers.append(kmer)
            self.pileup_columns.append({})
            return kmer, -1

    def add_read(self, bam_alignment_pos, cigartuples, query, outfile) -> None:
        if isinstance(query, str):
            query = query.encode()
        cig = [tuple(ct) for ct in cigartuples]
        kmers = enumerate_kmers(bam_alignment_pos, query, self.k, cig)
        if not kmers:
            return
        self.kmer_generators.append(kmers)
        self.kmer_generators_finished.append(False)
        self.iterators.append(0)
        kmer, pos = kmers[0]
        self.current_kmers.append((kmer, pos))
        if self.iterators[-1] != len(kmers) - 1:
            self.iterators[-1] += 1
        ref_kmer, index = self._get_column(pos)
        if index >= 0:
            col = self.pileup_columns[index]
            col[kmer] = col.get(kmer, 0) + 1
        target_pos = bam_alignment_pos + self.k - 1
        self.process_complete_columns(target_pos, outfile)

    def final_pop(self, outfile) -> None:
        final_ref_pos = self._refk[-1][1]
        self.process_complete_columns(final_ref_pos, outfile)

    def _advance_to(self, target_pos: int) -> None:
        for i in range(len(self.kmer_generators)):
            gen = self.kmer_generators[i]
            kmer, pos = self.current_kmers[i]
            finished = False
            while pos <= target_pos:
                if self.iterators[i] != len(gen):
                    kmer, pos = gen[self.iterators[i]]
                    ref_kmer, index = self._get_column(pos)
                    if index >= 0:
                        col = self.pileup_columns[index]
                        col[kmer] = col.get(kmer, 0) + 1
                    self.iterators[i] += 1
                else:
                    finished = True
                    break
            if finished:
                self.kmer_generators_finished[i] = True
            else:
                self.current_kmers[i] = (kmer, pos)
        while self.kmer_generators and self.kmer_generators_finished[0]:
            self.current_kmers.popleft()
            self.kmer_generators.popleft()
            self.iterators.popleft()
            self.kmer_generators_finished.popleft()

    def _pop_column(self, writer) -> None:
        if len(self.pileup_columns) > 0:
            result_ref_pos = self.ref_pos
            result_ref_kmer = self.ref_kmers.popleft()
            result_pileup = self.pileup_columns.popleft()
        else:
            kmer, pos = self._next_ref_kmer()
            assert pos == self.ref_pos
            result_ref_pos = self.ref_pos
            result_ref_kmer = kmer
            result_pileup = _NONE_DICT
        self.ref_pos += 1

        if not self.variantslist:
            in_window = False
            pop_variant = False
        else:
            variantposition, var_len_field = self.variantslist[0]
            var_length = var_len_field - 1
            varstart = variantposition - self.window
            varend = variantposition + var_length + self.window + self.k - 1
            in_window = varstart <= result_ref_pos <= varend
            pop_variant = False
            if not in_window and len(self.variantslist) >= 2:
                next_variantposition, next_len_field = self.variantslist[1]
                next_var_length = next_len_field - 1
                if (
                    result_ref_pos >= next_variantposition - self.window
                    and result_ref_pos <= next_variantposition + next_var_length + self.window
                ):
                    pop_variant = True
        if in_window:
            return
        if pop_variant:
            self.variantslist.popleft()
            return
        if result_pileup is not _NONE_DICT and result_pileup:
            for result_kmer, result_count in result_pileup.items():
                print(
                    result_ref_pos,
                    result_ref_kmer,
                    result_kmer,
                    result_count,
                    sep="\t",
                    file=writer,
                )

    def process_complete_columns(self, target_pos: int, outfile) -> None:
        """Pop all columns that cannot receive more reads."""
        self._advance_to(target_pos)
        with open(outfile, "a") as writer:
            while self.ref_pos <= target_pos:
                self._pop_column(writer)

    def finish(self) -> None:
        pass
