"""
Genotype likelihood store for progeny samples (genetic polyploid phasing).

Behavior parity with src/polyphase/progenygenotypelikelihoods.{h,cpp}:
flat float32 storage indexed by (position, sample, genotype), plus
log-likelihood-difference scores for the three supported variant types
(simplex-nulliplex, simplex-simplex, duplex-nulliplex).
"""

import math
import struct
from typing import List

import numpy as np


def _f32(v: float) -> float:
    return struct.unpack("f", struct.pack("f", v))[0]


def _d(a: float, b: float) -> float:
    # IEEE division (inf/nan instead of exceptions), like C++ doubles
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(a) / np.float64(b))


class ProgenyGenotypeLikelihoods:
    def __init__(self, ploidy: int, numSamples: int, numPositions: int):
        self.ploidy = ploidy
        self.numSamples = numSamples
        self.numPositions = numPositions
        self.gl: List[float] = []
        self.setNumPositions(numPositions)

        # six (signal count other variant, signal count SN variant) cases
        self.genotypePairs = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]
        k = float(ploidy)

        # simplex-nulliplex vs simplex-nulliplex
        self.likelihoodSameSN = [0.5, 0.0, 0.0, 0.5, 0.0, 0.0]
        self.likelihoodDiffSN = [
            _d(k / 2 - 1, 2 * (k - 1)),
            _d(k, 4 * (k - 1)),
            _d(k, 4 * (k - 1)),
            _d(k / 2 - 1, 2 * (k - 1)),
            0.0,
            0.0,
        ]

        # simplex-simplex vs simplex-nulliplex
        sSN, dSN = self.likelihoodSameSN, self.likelihoodDiffSN
        self.likelihoodSameS2 = [
            sSN[0] / 2.0,
            sSN[1] / 2.0,
            (sSN[2] + sSN[0]) / 2.0,
            (sSN[3] + sSN[1]) / 2.0,
            (sSN[4] + sSN[2]) / 2.0,
            (sSN[5] + sSN[3]) / 2.0,
        ]
        self.likelihoodDiffS2 = [
            dSN[0] / 2.0,
            dSN[1] / 2.0,
            (dSN[2] + dSN[0]) / 2.0,
            (dSN[3] + dSN[1]) / 2.0,
            (dSN[4] + dSN[2]) / 2.0,
            (dSN[5] + dSN[3]) / 2.0,
        ]

        # duplex-nulliplex vs simplex-nulliplex; NOTE the reference's operator
        # precedence in the last four Diff entries is kept verbatim
        # (progenygenotypelikelihoods.cpp:60-73): a/b*(c) groups as (a/b)*c.
        self.likelihoodSameDN = [
            _d(k / 2 - 1, 2 * (k - 1)),
            0.0,
            _d(k, 4 * (k - 1)),
            _d(k, 4 * (k - 1)),
            0.0,
            _d(k / 2 - 1, 2 * (k - 1)),
        ]
        self.likelihoodDiffDN = [
            _d((k / 2 - 2) * (k / 2 - 1), 2 * (k - 1) * (k - 2)),
            _d((k / 2) * (k / 2 - 1), 2 * (k - 1) * (k - 2)),
            _d((k / 2) * (k / 2 - 1), (k - 1)) * (k - 2),
            _d((k / 2) * (k / 2 - 1), (k - 1)) * (k - 2),
            _d((k / 2) * (k / 2 - 1), 2 * (k - 1) * (k - 2)),
            _d((k / 2 - 2) * (k / 2 - 1), 2 * (k - 1) * (k - 2)),
        ]

    def _getIndex(self, pos: int, sampleId: int, genotype: int) -> int:
        return pos * self.numSamples * (self.ploidy + 1) + sampleId * (self.ploidy + 1) + genotype

    def setNumPositions(self, pos: int) -> None:
        # resizes storage only; numPositions member intentionally not updated
        # (matches the reference, progenygenotypelikelihoods.cpp:115-117)
        new_size = self._getIndex(pos + 1, 0, 0)
        if new_size > len(self.gl):
            self.gl.extend([-1.0] * (new_size - len(self.gl)))
        else:
            del self.gl[new_size:]

    def getGl(self, pos: int, sampleId: int, genotype: int) -> float:
        if pos >= self.numPositions:
            return 0.0
        return self.gl[self._getIndex(pos, sampleId, genotype)]

    def getGlv(self, pos: int, sampleId: int) -> List[float]:
        if pos >= self.numPositions:
            return [0.0] * (self.ploidy + 1)
        index = self._getIndex(pos, sampleId, 0)
        return self.gl[index : index + self.ploidy + 1]

    def getPloidy(self) -> int:
        return self.ploidy

    def getNumSamples(self) -> int:
        return self.numSamples

    def getNumPositions(self) -> int:
        return self.numPositions

    def setGl(self, pos: int, sampleId: int, genotype: int, l: float) -> None:
        if pos >= self.numPositions:
            self.setNumPositions(pos)
        self.gl[self._getIndex(pos, sampleId, genotype)] = _f32(l)

    def setGlv(self, pos: int, sampleId: int, l: List[float]) -> None:
        if pos >= self.numPositions:
            self.setNumPositions(pos)
        start = self._getIndex(pos, sampleId, 0)
        for i in range(self.ploidy + 1):
            self.gl[start + i] = _f32(l[i])

    def getSimplexNulliplexScore(self, pos1: int, pos2: int) -> float:
        return self._log_likelihood_difference(
            pos1, pos2, self.likelihoodSameSN, self.likelihoodDiffSN, 4
        )

    def getSimplexSimplexScore(self, pos1: int, pos2: int) -> float:
        return self._log_likelihood_difference(
            pos1, pos2, self.likelihoodSameS2, self.likelihoodDiffS2, 6
        )

    def getDuplexNulliplexScore(self, pos1: int, pos2: int) -> float:
        return self._log_likelihood_difference(
            pos1, pos2, self.likelihoodSameDN, self.likelihoodDiffDN, 6
        )

    def _log_likelihood_difference(
        self,
        pos1: int,
        pos2: int,
        likelihoodSame: List[float],
        likelihoodDiff: List[float],
        numCases: int,
    ) -> float:
        # progenygenotypelikelihoods.cpp:140-158
        result = math.log(1.0 / (self.ploidy - 1))
        for i in range(self.numSamples):
            if self.getGl(pos1, i, 0) < 0.0 or self.getGl(pos2, i, 0) < 0.0:
                continue
            cooccur = 0.0
            disjoint = 0.0
            for j in range(numCases):
                g1, g2 = self.genotypePairs[j]
                gl = self.getGl(pos1, i, g1) * self.getGl(pos2, i, g2)
                cooccur += gl * likelihoodSame[j]
                disjoint += gl * likelihoodDiff[j]
            if cooccur * disjoint > 0:
                result += math.log(cooccur / disjoint)
        return result
