"""
Public core API of the PyTorch port, mirroring whatshap_tpu.core for what
this package has so far: the read data model, the pedigree model, the exact
wMEC solver and the forward-backward genotyper.
"""

from .genotype import Genotype
from .readset import NumericSampleIds, Read, ReadSet
from .pedigree_model import Pedigree
from .phredgl import PhredGenotypeLikelihoods

# The solver lives in whatshap_torch.solver but is re-exported here for
# parity with `from whatshap.core import PedigreeDPTable`.
from ..solver.dptable import PedigreeDPTable  # noqa: E402
from ..solver.genotyping import (  # noqa: E402
    GenotypeDPTable,
    GenotypeDistribution,
    compute_genotypes,
)

__all__ = [
    "Genotype",
    "NumericSampleIds",
    "Read",
    "ReadSet",
    "Pedigree",
    "PedigreeDPTable",
    "PhredGenotypeLikelihoods",
    "GenotypeDPTable",
    "GenotypeDistribution",
    "compute_genotypes",
]
