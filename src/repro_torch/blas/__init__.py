"""repro_torch.blas — fusible BLAS elementary-function library + the
paper's 11 evaluation sequences."""
from . import elementary_lib
from .sequences import REGISTRY, Sequence, make_inputs

__all__ = ["REGISTRY", "Sequence", "elementary_lib", "make_inputs"]
