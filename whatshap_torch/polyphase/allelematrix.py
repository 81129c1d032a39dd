"""
Column-compressed allele matrix for the polyploid pipeline.

Behavior parity with the reference's src/polyphase/allelematrix.{h,cpp} and
the Cython surface in whatshap/polyphase/solver.pyx (class AlleleMatrix):
per-read sparse rows over *local* position indices, a sorted global-position
map, per-position allele depth counts, and interval / sub-matrix extraction.
"""

from typing import Dict, List, Optional, Sequence, Tuple

# starts[] sentinel used by the reference for empty reads (Position is
# uint32_t there, and it assigns -1)
_U32_MAX = 0xFFFFFFFF


class AlleleMatrix:
    """Immutable allele matrix (src/polyphase/allelematrix.cpp)."""

    def __init__(self, rs=None):
        if rs is None:
            # bare instance (filled by _init_from_lists / __setstate__)
            self._init_from_lists([], [], [])
            return
        # --- from ReadSet (allelematrix.cpp:55-91) ---
        positions = sorted(rs.get_positions())
        self.genPos: List[int] = positions
        self.posIdx: Dict[int, int] = {p: i for i, p in enumerate(positions)}
        n = len(rs)
        self.m: List[Dict[int, int]] = [dict() for _ in range(n)]
        self.starts: List[int] = [0] * n
        self.ends: List[int] = [0] * n
        self.globalReadIds: List[int] = list(range(n))
        self.depths: List[List[int]] = [[] for _ in positions]
        self.maxAllele = 0
        for i in range(n):
            read = rs[i]
            self.starts[i] = self.posIdx[read[0].position]
            self.ends[i] = self.posIdx[read[len(read) - 1].position]
            row = self.m[i]
            for variant in read:
                a = variant.allele
                p = self.posIdx[variant.position]
                row[p] = a
                if a >= self.maxAllele:
                    self.maxAllele = a + 1
                    for d in self.depths:
                        d.extend([0] * (self.maxAllele - len(d)))
                self.depths[p][a] += 1

    def _init_from_lists(
        self,
        read_list: Sequence[Dict[int, int]],
        pos_list: Sequence[int],
        id_list: Sequence[int],
    ) -> None:
        # allelematrix.cpp:10-53 (readList/posList/idList constructor); read
        # rows are keyed by LOCAL position index here.
        self._rowCache = None
        self._flatRows = None
        self.genPos = sorted(pos_list)
        self.posIdx = {p: i for i, p in enumerate(self.genPos)}
        n = len(read_list)
        self.m = [dict() for _ in range(n)]
        self.starts = [0] * n
        self.ends = [0] * n
        self.globalReadIds = list(id_list)
        self.depths = [[] for _ in self.genPos]
        self.maxAllele = 0
        for i, row_in in enumerate(read_list):
            row = self.m[i]
            for p, a in row_in.items():
                row[p] = a
                if a >= self.maxAllele:
                    self.maxAllele = a + 1
                    for d in self.depths:
                        d.extend([0] * (self.maxAllele - len(d)))
                # the C++ indexes depths[p] unchecked (UB when a row key is
                # outside the position list); extend defensively instead
                while p >= len(self.depths):
                    self.depths.append([0] * self.maxAllele)
                self.depths[p][a] += 1
            if row:
                keys = sorted(row)
                self.starts[i] = keys[0]
                self.ends[i] = keys[-1]
            else:
                self.starts[i] = _U32_MAX
                self.ends[i] = 0

    @classmethod
    def _from_lists(cls, read_list, pos_list, id_list) -> "AlleleMatrix":
        am = cls.__new__(cls)
        am._init_from_lists(read_list, pos_list, id_list)
        return am

    @classmethod
    def _from_flat(cls, new_off, pos_k, all_k, pos_list, id_list) -> "AlleleMatrix":
        """Array-native constructor: rows as CSR (new_off int64, pos_k/all_k
        int32, per-row ascending positions keyed like _init_from_lists'
        read_list rows).  Produces the identical field state — including
        depth-table shape and dict insertion order — without per-entry
        Python loops."""
        import numpy as np

        am = cls.__new__(cls)
        am._rowCache = None
        am.genPos = sorted(pos_list)
        am.posIdx = {p: i for i, p in enumerate(am.genPos)}
        n = len(new_off) - 1
        am.globalReadIds = list(id_list)
        pos_l = pos_k.tolist()
        all_l = all_k.tolist()
        off_l = new_off.tolist()
        am.m = [
            dict(zip(pos_l[off_l[i] : off_l[i + 1]], all_l[off_l[i] : off_l[i + 1]]))
            for i in range(n)
        ]
        starts = np.full(n, _U32_MAX, dtype=np.int64)
        ends = np.zeros(n, dtype=np.int64)
        lens = new_off[1:] - new_off[:-1]
        nz = lens > 0
        if pos_k.size:
            starts[nz] = pos_k[new_off[:-1][nz]]
            ends[nz] = pos_k[new_off[1:][nz] - 1]
        am.starts = starts.tolist()
        am.ends = ends.tolist()
        if pos_k.size:
            am.maxAllele = int(all_k.max()) + 1
            n_depth = max(len(am.genPos), int(pos_k.max()) + 1)
            counts = np.bincount(
                pos_k.astype(np.int64) * am.maxAllele + all_k,
                minlength=n_depth * am.maxAllele,
            ).reshape(n_depth, am.maxAllele)
            am.depths = counts.tolist()
        else:
            am.maxAllele = 0
            am.depths = [[] for _ in am.genPos]
        am._flatRows = (
            np.ascontiguousarray(new_off, dtype=np.int64),
            np.ascontiguousarray(pos_k, dtype=np.int32),
            np.ascontiguousarray(all_k, dtype=np.int32),
        )
        return am

    # --- accessors (solver.pyx AlleleMatrix wrapper) ---

    def size(self) -> int:
        return len(self.m)

    def __len__(self) -> int:
        return len(self.m)

    def getNumPositions(self) -> int:
        return len(self.genPos)

    def getPositions(self) -> List[int]:
        return list(self.genPos)

    def getMaxNumAllele(self) -> int:
        return self.maxAllele

    def getAllele(self, readId: int, position: int) -> int:
        return self.m[readId].get(position, -1)

    def getAlleleGlobal(self, readId: int, genPosition: int) -> int:
        idx = self.posIdx.get(genPosition)
        if idx is None:
            return -1
        return self.getAllele(readId, idx)

    def getRead(self, readId: int) -> List[Tuple[int, int]]:
        # the matrix is immutable after construction; cache the sorted rows
        # (callers iterate but never mutate the returned list)
        cache = getattr(self, "_rowCache", None)
        if cache is None:
            cache = self._rowCache = {}
        row = cache.get(readId)
        if row is None:
            flat = getattr(self, "_flatRows", None)
            if flat is not None:
                # rows in the flat store are already position-sorted
                off, pos, allele = flat
                lo, hi = int(off[readId]), int(off[readId + 1])
                row = list(zip(pos[lo:hi].tolist(), allele[lo:hi].tolist()))
            else:
                row = sorted(self.m[readId].items())
            cache[readId] = row
        return row

    def flatRows(self):
        """(offsets[n+1] int64, positions int32, alleles int32) of the
        sorted rows concatenated in read order; cached (matrix immutable)."""
        import numpy as np
        from itertools import chain

        cached = getattr(self, "_flatRows", None)
        if cached is not None:
            return cached
        n = len(self.m)
        off = np.zeros(n + 1, np.int64)
        off[1:] = np.cumsum([len(r) for r in self.m])
        flat = np.fromiter(
            chain.from_iterable(
                chain.from_iterable(self.getRead(i) for i in range(n))
            ),
            dtype=np.int32,
            count=int(off[-1]) * 2,
        ).reshape(-1, 2)
        self._flatRows = (
            off,
            np.ascontiguousarray(flat[:, 0]),
            np.ascontiguousarray(flat[:, 1]),
        )
        return self._flatRows

    def getFirstPos(self, readId: int) -> int:
        return self.starts[readId]

    def getLastPos(self, readId: int) -> int:
        return self.ends[readId]

    def getGlobalId(self, readId: int) -> int:
        return self.globalReadIds[readId]

    def globalToLocal(self, genPosition: int) -> int:
        idx = self.posIdx.get(genPosition)
        return _U32_MAX if idx is None else idx

    def localToGlobal(self, position: int) -> int:
        return self.genPos[position]

    def getAlleleDepths(self, position: int) -> List[int]:
        return list(self.depths[position])

    # --- extraction (allelematrix.cpp:153-216) ---

    def extractInterval(self, start: int, end: int, removeEmpty: bool = True) -> "AlleleMatrix":
        import numpy as np

        off, row_pos, row_allele = self.flatRows()
        n = len(self.m)
        starts = np.fromiter(self.starts, dtype=np.int64, count=n)
        ends = np.fromiter(self.ends, dtype=np.int64, count=n)
        if removeEmpty:
            keep = np.nonzero((starts < end) & (ends >= start))[0]
        else:
            keep = np.arange(n, dtype=np.int64)
        lens = off[keep + 1] - off[keep]
        total = int(lens.sum())
        if total:
            # grouped arange: every entry of every kept row, in row order
            csum = np.cumsum(lens)
            gather = (
                np.arange(total, dtype=np.int64)
                - np.repeat(csum - lens, lens)
                + np.repeat(off[keep], lens)
            )
            pos_t = row_pos[gather].astype(np.int64)
            in_range = (pos_t >= start) & (pos_t < end)
            rid_t = np.repeat(np.arange(len(keep), dtype=np.int64), lens)
            pos_sel = pos_t[in_range]
            pos_k = (pos_sel - start).astype(np.int32)
            all_k = row_allele[gather][in_range]
            new_lens = np.bincount(rid_t[in_range], minlength=len(keep))
            genPosArr = np.fromiter(self.genPos, dtype=np.int64, count=len(self.genPos))
            posList = genPosArr[np.unique(pos_sel)].tolist()
        else:
            pos_k = np.empty(0, np.int32)
            all_k = np.empty(0, np.int32)
            new_lens = np.zeros(len(keep), np.int64)
            posList = []
        new_off = np.zeros(len(keep) + 1, np.int64)
        np.cumsum(new_lens, out=new_off[1:])
        idList = [self.globalReadIds[i] for i in keep.tolist()]
        return AlleleMatrix._from_flat(new_off, pos_k, all_k, posList, idList)

    def extractSubMatrix(
        self,
        positions: Sequence[int],
        readIds: Sequence[int],
        removeEmpty: bool = True,
    ) -> "AlleleMatrix":
        newReads: List[Dict[int, int]] = []
        posList: List[int] = []
        idList: List[int] = []
        projPos: Dict[int, int] = {}
        num_positions = self.getNumPositions()
        # the reference loop STOPS at the first out-of-range position
        for i, p in enumerate(positions):
            if p >= num_positions:
                break
            projPos[p] = i
            posList.append(self.localToGlobal(p))
        start = _U32_MAX
        end = 0
        if len(positions) > 0:
            start = min(positions)
            end = max(positions)
        for i in readIds:
            if i >= self.size():
                continue
            if removeEmpty and (self.starts[i] >= end or self.ends[i] < start):
                continue
            newRead = {}
            for p, a in self.m[i].items():
                if p in projPos:
                    newRead[projPos[p]] = a
            if removeEmpty and not newRead:
                continue
            idList.append(self.globalReadIds[i])
            newReads.append(newRead)
        posList.sort()
        return AlleleMatrix._from_lists(newReads, posList, idList)

    # --- iteration / pickling (solver.pyx:84-100) ---

    def __iter__(self):
        for i in range(self.size()):
            yield self.getRead(i)

    def __getstate__(self):
        read_list = [{pos: allele for pos, allele in read} for read in self]
        pos_list = self.getPositions()
        id_list = [self.getGlobalId(i) for i in range(len(self))]
        return read_list, pos_list, id_list

    def __setstate__(self, state):
        read_list, pos_list, id_list = state
        self._init_from_lists(read_list, pos_list, id_list)
