"""
Polyphase solver components (import-path parity with
whatshap.polyphase.solver, which wraps the reference's C++).  So far only
SwitchFlipCalculator, which compare imports from this path.
"""

from .switchflip import SwitchFlipCalculator

__all__ = ["SwitchFlipCalculator"]
