"""
Sparse upper-triangle matrix keyed by unordered read pairs.

Behavior parity with src/polyphase/trianglesparsematrix.{h,cpp}: the pair
(i, j), i > j maps to index i*(i-1)/2 + j + 1 (0 is the reserved diagonal
index, which is never stored), values are float32, and getEntries() decodes
indices back to pairs.
"""

import math
import struct
from typing import Dict, List, Tuple


def _f32(v: float) -> float:
    return struct.unpack("f", struct.pack("f", v))[0]


class TriangleSparseMatrix:
    def __init__(self):
        self.m: Dict[int, float] = {}
        self.maxDim = 0

    @staticmethod
    def entryToIndex(i: int, j: int) -> int:
        if i < j:
            i, j = j, i
        if i > j:
            return i * (i - 1) // 2 + j + 1
        return 0

    def size(self) -> int:
        return len(self.m)

    def __len__(self) -> int:
        return len(self.m)

    def getMaxDim(self) -> int:
        return self.maxDim

    def get(self, i: int, j: int) -> float:
        return self.m.get(self.entryToIndex(i, j), 0.0)

    def set(self, i: int, j: int, v: float) -> None:
        index = self.entryToIndex(i, j)
        if index != 0:
            self.m[index] = _f32(v)
            self.maxDim = max(self.maxDim, i + 1, j + 1)

    # DoubleInt variants store two uint16 values packed into the same slot
    # (trianglesparsematrix.h union MatrixItem)
    def getDoubleInt(self, i: int, j: int) -> Tuple[int, int]:
        index = self.entryToIndex(i, j)
        if index in self.m:
            u = struct.unpack("I", struct.pack("f", self.m[index]))[0]
            return (u // 65536, u % 65536)
        return (0, 0)

    def setDoubleInt(self, i: int, j: int, u1: int, u2: int) -> None:
        index = self.entryToIndex(i, j)
        if index != 0:
            packed = ((u1 & 0xFFFF) << 16) + (u2 & 0xFFFF)
            self.m[index] = struct.unpack("f", struct.pack("I", packed))[0]
            self.maxDim = max(self.maxDim, i + 1, j + 1)

    def getIndices(self) -> List[int]:
        return sorted(k - 1 for k in self.m)

    def getEntries(self) -> List[Tuple[int, int]]:
        pairs = []
        for index in self.m:
            u = math.ceil(math.sqrt(2 * index + 0.25) - 0.5)
            v = (index - 1) - u * (u - 1) // 2
            pairs.append((int(u), int(v)))
        return pairs

    def __iter__(self):
        return iter(self.getEntries())
