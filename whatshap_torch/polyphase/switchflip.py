"""
Polyploid switch/flip-distance DP between two phasings, with per-column
backtracking of the best haplotype permutation.

Semantics parity with src/polyphase/switchflipcalculator.cpp (the state space
is the set of haplotype permutations per position; transitions cost
switchCost per changed permutation entry, emissions cost flipCost per
mismatching allele under the permutation; non-profitable states are pruned
per column).
"""

from itertools import permutations as iter_permutations
from math import inf
from typing import List, Tuple


class SwitchFlipCalculator:
    def __init__(self, ploidy: int, switch_cost: float = 1, flip_cost: float = 1):
        self.ploidy = ploidy
        self.switch_cost = switch_cost
        self.flip_cost = flip_cost

    # -- helpers ----------------------------------------------------------
    def _num_flips(self, perm, phase0, phase1) -> int:
        return sum(1 for i in range(self.ploidy) if phase0[perm[i]] != phase1[i])

    def _flipped_haps(self, perm, phase0, phase1) -> List[int]:
        return [i for i in range(self.ploidy) if phase0[perm[i]] != phase1[i]]

    @staticmethod
    def _num_switches(p1, p2) -> int:
        return sum(1 for a, b in zip(p1, p2) if a != b)

    def compute_switch_flips_poly(self, phasing0, phasing1):
        """Haplotype-wise string phasings -> (switches, flips,
        switches_in_column, flips_in_column, perm_in_column)."""
        assert len(phasing0) == len(phasing1) == self.ploidy
        assert self.ploidy >= 2
        assert len(phasing0[0]) > 0

        num_vars = len(phasing0[0])
        input0 = [[int(phasing0[k][i]) for k in range(self.ploidy)] for i in range(num_vars)]
        input1 = [[int(phasing1[k][i]) for k in range(self.ploidy)] for i in range(num_vars)]

        native = self._compare_native(input0, input1)
        if native is not None:
            return native
        switches, flips, sw_col, fl_col, perm_col = self._compare(input0, input1)
        return switches, flips, sw_col, fl_col, perm_col

    def _compare_native(self, input0, input1):
        """Dispatch to the C++ engine (csrc/host/switchfliplib.cpp), an
        iteration-order-identical port of _compare below; None where
        hostlib.switchfliplib is None (the Python path)."""
        from ..hostlib import switchfliplib

        if switchfliplib is None:
            return None
        num_vars = len(input0)
        flat0 = [a for row in input0 for a in row]
        flat1 = [a for row in input1 for a in row]
        result = switchfliplib.compute(
            self.ploidy, float(self.switch_cost), float(self.flip_cost),
            num_vars, flat0, flat1,
        )
        if result is None:
            return inf, inf, [], [], []
        return result

    def _compare(self, phasing0, phasing1) -> Tuple[float, float, list, list, list]:
        perms = [tuple(p) for p in iter_permutations(range(self.ploidy))]
        num_vars = len(phasing0)

        # first column: emission only
        m = []
        column = {}
        for p in perms:
            column[p] = (self.flip_cost * self._num_flips(p, phasing0[0], phasing1[0]), None)
        m.append(dict(column))

        for pos in range(1, num_vars):
            prev = m[pos - 1]
            column = {}
            minimum_in_column = inf
            for row_perm in perms:
                minimum = inf
                minimum_pred = None
                for pred_perm, (pred_score, _) in prev.items():
                    s = pred_score + self.switch_cost * self._num_switches(row_perm, pred_perm)
                    if s < minimum:
                        minimum = s
                        minimum_pred = pred_perm
                emission = self.flip_cost * self._num_flips(row_perm, phasing0[pos], phasing1[pos])
                if minimum_pred is not None:
                    column[row_perm] = (minimum + emission, minimum_pred)
                else:
                    column[row_perm] = (emission, None)
                minimum_in_column = min(minimum_in_column, column[row_perm][0])

            # prune non-profitable entries (switchflipcalculator.cpp:93-119)
            profitable = [t for t in perms if column[t][0] <= minimum_in_column]
            open_tuples = [t for t in perms if column[t][0] > minimum_in_column]
            for t in open_tuples:
                is_profitable = True
                for p in profitable:
                    if column[t][0] >= column[p][0] + self.switch_cost * self._num_switches(t, p):
                        is_profitable = False
                        break
                if is_profitable:
                    if len(profitable) < self.ploidy:
                        profitable.append(t)
                else:
                    del column[t]

            m.append(dict(column))

        # backtracking
        flips = 0.0
        switches = 0.0
        current_row = None
        minimum = inf
        for perm, (score, _) in m[num_vars - 1].items():
            if score < minimum:
                minimum = score
                current_row = perm
        if current_row is None:
            return inf, inf, [], [], []

        perm_in_column = [list(current_row)]
        switches_in_column = []
        flips_in_column = []
        pred = m[num_vars - 1][current_row][1]
        local_switches = self._num_switches(current_row, pred) if pred is not None else 0
        flips_in_column.append(self._flipped_haps(current_row, phasing0[-1], phasing1[-1]))
        switches_in_column.append(local_switches)
        flips += self._num_flips(current_row, phasing0[-1], phasing1[-1])
        switches += local_switches

        for pos in range(num_vars - 2, -1, -1):
            current_row = m[pos + 1][current_row][1]
            if current_row is None:
                return inf, inf, [], [], []
            perm_in_column.append(list(current_row))
            pred = m[pos][current_row][1]
            local_switches = 0 if pos == 0 or pred is None else self._num_switches(current_row, pred)
            flips_in_column.append(self._flipped_haps(current_row, phasing0[pos], phasing1[pos]))
            switches_in_column.append(local_switches)
            flips += self._num_flips(current_row, phasing0[pos], phasing1[pos])
            switches += local_switches

        perm_in_column.reverse()
        flips_in_column.reverse()
        switches_in_column.reverse()
        return switches, flips, switches_in_column, flips_in_column, perm_in_column
