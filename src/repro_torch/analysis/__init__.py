"""Static verification of graphs, plans, and packs.

The diagnostic *types* live in ``repro_torch.core.diagnostics`` (a leaf
every layer can raise through); this package holds the checkers that
emit them and the ``python -m repro_torch.analysis`` lint CLI.
"""
from ..core.diagnostics import (CODES, KNOWN_BACKENDS, Diagnostic,
                                UnsupportedGroupError, VerificationError,
                                diag, raise_if_errors)
from .checks import (verify_graph, verify_pack, verify_plan,
                     verify_plan_quick, verify_plan_structural)

__all__ = [
    "CODES", "KNOWN_BACKENDS", "Diagnostic", "UnsupportedGroupError",
    "VerificationError", "diag", "raise_if_errors",
    "verify_graph", "verify_pack", "verify_plan", "verify_plan_quick",
    "verify_plan_structural",
]
