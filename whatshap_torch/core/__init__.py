"""
Public core API of the PyTorch port, mirroring whatshap_tpu.core for what
this package has so far: the read data model, the pedigree model, the exact
wMEC solver and the forward-backward genotyper (the host-only solvers,
HapChatCore, Caller and PedMecHeuristic, are not ported yet).
"""

from .genotype import (
    Genotype,
    binomial_coefficient,
    convert_index_to_alleles,
    get_max_genotype_alleles,
    get_max_genotype_ploidy,
)
from .phredgl import PhredGenotypeLikelihoods
from .readset import (
    ALT_ALLELE,
    BLANK_ALLELE,
    EQUAL_SCORES_ALLELE,
    REF_ALLELE,
    IndexSet,
    NumericSampleIds,
    Read,
    ReadSet,
)
from .pedigree_model import Pedigree, PedigreePartitions
from .variant import Variant

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
    "binomial_coefficient",
    "convert_index_to_alleles",
    "get_max_genotype_alleles",
    "get_max_genotype_ploidy",
    "PhredGenotypeLikelihoods",
    "REF_ALLELE",
    "ALT_ALLELE",
    "BLANK_ALLELE",
    "EQUAL_SCORES_ALLELE",
    "IndexSet",
    "NumericSampleIds",
    "Read",
    "ReadSet",
    "Pedigree",
    "PedigreePartitions",
    "Variant",
    "PedigreeDPTable",
    "GenotypeDPTable",
    "GenotypeDistribution",
    "compute_genotypes",
]
