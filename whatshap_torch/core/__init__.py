"""
Public core API of the PyTorch port, mirroring whatshap_tpu.core: the read
data model, the pedigree model, the exact wMEC solver, the forward-backward
genotyper and the host-only solvers HapChatCore, PedMecHeuristic and Caller
(the k-mer pileup engine of `learn`): the reference's whole surface.
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

# The solvers live in whatshap_torch.solver but are re-exported here for
# parity with `from whatshap.core import PedigreeDPTable`.
from ..solver.dptable import PedigreeDPTable  # noqa: E402
from ..solver.hapchat import HapChatCore  # noqa: E402
from ..solver.caller import Caller  # noqa: E402
from ..solver.heuristic import PedMecHeuristic  # noqa: E402
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
    "HapChatCore",
    "Caller",
    "PedMecHeuristic",
    "GenotypeDPTable",
    "GenotypeDistribution",
    "compute_genotypes",
]
