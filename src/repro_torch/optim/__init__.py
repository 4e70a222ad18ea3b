"""repro_torch.optim — AdamW through the fusion compiler."""
from .fused import fused_adamw_update, make_fused_adamw

__all__ = ["fused_adamw_update", "make_fused_adamw"]
