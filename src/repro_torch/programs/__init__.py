"""repro_torch.programs — the program registry: the paper's 11 BLAS
sequences (``BLAS``) and the LM decode-step workloads (``MODELS``), all
visible in ``REGISTRY``."""
from .registry import (BLAS, MODELS, REGISTRY, Program, Sequence,
                       make_inputs, register)
from . import blas as _blas_programs    # noqa: F401  (registers BLAS)
from . import models as _model_programs  # noqa: F401  (registers MODELS)

__all__ = ["BLAS", "MODELS", "REGISTRY", "Program", "Sequence",
           "make_inputs", "register"]
