"""
Test-support helpers of the port: the part of whatshap_tpu/testhelpers.py
that the synthetic batch builders (parallel/workloads.py) use.
"""

from .core import Genotype


def canonic_index_to_biallelic_gt(num_alt, ploidy=2):
    """Numeric VCF genotype index + ploidy -> biallelic Genotype object."""
    if 0 <= num_alt <= ploidy:
        return Genotype([0] * (ploidy - num_alt) + [1] * num_alt)
    return Genotype([])
