"""
Polyphase solver components (import-path parity with
whatshap.polyphase.solver, which wraps the reference's C++).
"""

from .allelematrix import AlleleMatrix
from .clusterediting import (
    ClusterEditingSolution,
    ClusterEditingSolver,
    EdgeHeap,
    InducedCostHeuristic,
    StaticSparseGraph,
)
from .progenygl import ProgenyGenotypeLikelihoods
from .readscoring import ReadScoring, scoreReadset
from .switchflip import SwitchFlipCalculator
from .trianglesparse import TriangleSparseMatrix
from .haplothreader import HaploThreader

__all__ = [
    "AlleleMatrix",
    "ClusterEditingSolution",
    "ClusterEditingSolver",
    "EdgeHeap",
    "InducedCostHeuristic",
    "StaticSparseGraph",
    "ProgenyGenotypeLikelihoods",
    "ReadScoring",
    "scoreReadset",
    "SwitchFlipCalculator",
    "TriangleSparseMatrix",
    "HaploThreader",
]
