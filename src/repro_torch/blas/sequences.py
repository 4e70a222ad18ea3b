"""The paper's 11 BLAS sequences — re-export of ``programs.BLAS``."""
from __future__ import annotations

# importing the registry submodule initializes the programs package,
# which registers the BLAS group
from repro_torch.programs.registry import BLAS as REGISTRY
from repro_torch.programs.registry import Program as Sequence
from repro_torch.programs.registry import make_inputs

__all__ = ["REGISTRY", "Sequence", "make_inputs"]
