"""repro_torch.programs — the program registry: the paper's 11 BLAS
sequences (``BLAS``), also visible in ``REGISTRY``."""
from .registry import BLAS, REGISTRY, Program, Sequence, make_inputs, register
from . import blas as _blas_programs    # noqa: F401  (registers BLAS)

__all__ = ["BLAS", "REGISTRY", "Program", "Sequence", "make_inputs",
           "register"]
