"""
PedigreeDPTable: exact wMEC solver with the reference API, on PyTorch.

API parity with whatshap.core.PedigreeDPTable (core.pyx:364-416, backed by
src/pedigreedptable.cpp) and with whatshap_tpu.solver.dptable: construct from
(ReadSet, recombcost, Pedigree, distrust_genotypes, positions); query
get_super_reads(), get_optimal_cost(), get_optimal_partitioning().  The one
addition is `device`: the column DP runs on a CUDA device unless the caller
passes another one (see whatshap_torch.ops.wmec.run_dp).
"""

from typing import List, Optional, Sequence, Tuple

from ..core.pedigree_model import Pedigree
from ..core.readset import Read, ReadSet
from ..ops import wmec


class PedigreeDPTable:
    def __init__(
        self,
        readset: ReadSet,
        recombcost: Sequence[int],
        pedigree: Pedigree,
        distrust_genotypes: bool = False,
        positions: Optional[Sequence[int]] = None,
        device=None,
    ):
        self.device = wmec.resolve_device(device)
        self._readset = readset
        self._pedigree = pedigree
        self._packed = wmec.pack_problem(
            readset, recombcost, pedigree, distrust_genotypes, positions
        )
        self._result = wmec.run_dp(self._packed, self.device)

    def get_optimal_cost(self) -> int:
        if self._result is None:
            return 0
        return self._result.optimal_cost

    def get_optimal_partitioning(self) -> List[bool]:
        return wmec.extract_partitioning(self._packed, self._result)

    def get_super_reads(self) -> Tuple[List[ReadSet], List[int]]:
        """Per individual, a ReadSet with the two haplotype superreads; plus
        the transmission vector.

        Mirrors PedigreeDPTable::get_super_reads
        (pedigreedptable.cpp:344-388) and its Cython wrapper
        (core.pyx:397-414).
        """
        n_ind = len(self._pedigree)
        superreads = [
            (
                Read(f"superread_0_{i}", -1, -1, self._pedigree.index_to_id(i)),
                Read(f"superread_1_{i}", -1, -1, self._pedigree.index_to_id(i)),
            )
            for i in range(n_ind)
        ]
        transmission_vector: List[int] = []

        if self._result is not None:
            allele0, allele1, quality = wmec.extract_alleles(
                self._packed, self._result, self._pedigree
            )
            # bulk column assignment (same content as per-variant
            # add_variant calls; the arrays are fresh per superread)
            positions = self._packed.positions.tolist()
            for i in range(n_ind):
                quals = quality[:, i].tolist()
                r0, r1 = superreads[i]
                r0._positions = list(positions)
                r0._alleles = allele0[:, i].tolist()
                r0._qualities = quals
                r1._positions = list(positions)
                r1._alleles = allele1[:, i].tolist()
                r1._qualities = list(quals)
            transmission_vector = self._result.trans_path[
                : self._packed.n_cols
            ].tolist()

        output: List[ReadSet] = []
        for i in range(n_ind):
            rs = ReadSet()
            rs._add_owned(superreads[i][0])
            rs._add_owned(superreads[i][1])
            output.append(rs)
        return output, transmission_vector
