"""repro_torch.optim — AdamW (K6 a leaf, int8 moments) and AdamW through
the fusion compiler."""
from .adamw import (QBLOCK, AdamWHyper, apply_adamw, dequantize,
                    init_opt_state, quantize, schedule)
from .fused import fused_adamw_update, make_fused_adamw

__all__ = ["QBLOCK", "AdamWHyper", "apply_adamw", "dequantize",
           "fused_adamw_update", "init_opt_state", "make_fused_adamw",
           "quantize", "schedule"]
