"""repro_torch.configs — one module per architecture: the reference's
``repro.configs``, pure Python, kept as the port's own copy (the port
imports nothing of the reference package)."""
from .base import (ARCHS, SHAPES, SUBQUADRATIC, ModelConfig, ShapeConfig,
                   get_config, smoke_config, supported_cells)

__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC", "ModelConfig", "ShapeConfig",
           "get_config", "smoke_config", "supported_cells"]
