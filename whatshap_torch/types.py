"""Common interface of the diploid phasing solvers
(parity with whatshap/types.py)."""

from abc import ABC, abstractmethod
from typing import List, Optional, Tuple

from .core import ReadSet


class PhasingAlgorithm(ABC):
    @abstractmethod
    def get_super_reads(self) -> Tuple[List[ReadSet], Optional[List[int]]]:
        ...

    @abstractmethod
    def get_optimal_cost(self) -> int:
        ...

    @abstractmethod
    def get_optimal_partitioning(self) -> List[int]:
        ...
