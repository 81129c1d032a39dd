"""
Import-path parity with whatshap/variant.py: the Variant dataclass lives in
whatshap_torch.core.variant; re-exported here under the reference's module
path.
"""

from .core.variant import Variant

__all__ = ["Variant"]
