"""
Public core API of the PyTorch port, mirroring whatshap_tpu.core for what
this package has so far: the read data model, the pedigree model and the
exact wMEC solver.
"""

from .genotype import Genotype
from .readset import NumericSampleIds, Read, ReadSet
from .pedigree_model import Pedigree

# The solver lives in whatshap_torch.solver but is re-exported here for
# parity with `from whatshap.core import PedigreeDPTable`.
from ..solver.dptable import PedigreeDPTable  # noqa: E402

__all__ = [
    "Genotype",
    "NumericSampleIds",
    "Read",
    "ReadSet",
    "Pedigree",
    "PedigreeDPTable",
]
