"""repro_torch.blas — fusible BLAS elementary-function library + the
paper's 11 evaluation sequences and synthetic chains."""
from . import elementary_lib
from .sequences import REGISTRY, Sequence, make_inputs, make_synthetic_chain

__all__ = ["REGISTRY", "Sequence", "elementary_lib", "make_inputs",
           "make_synthetic_chain"]
