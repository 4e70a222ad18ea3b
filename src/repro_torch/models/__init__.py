"""repro_torch.models — the dense decoder of the reference's model zoo
(``repro.models``), on the port's kernels: K4 for every RMSNorm and K5
for decode attention on the card."""
from .forward import (cast_params, decode_step, forward_lm, prefill,
                      zero_cache)
from .model import LM, init_params, model_shapes

__all__ = ["LM", "cast_params", "decode_step", "forward_lm", "init_params",
           "model_shapes", "prefill", "zero_cache"]
