"""repro_torch.models — every family of the reference's model zoo
(``repro.models``: dense, vlm, MoE with MLA, the SSD state-space model,
the attention-SSD hybrid and Whisper's encoder-decoder), on the port's
kernels: K4 for every RMSNorm and K5 for GQA decode attention on the
card."""
from .forward import (cache_shapes, cast_params, decode_step, forward_lm,
                      lm_loss, prefill, zero_cache)
from .model import LM, init_params, model_shapes

__all__ = ["LM", "cache_shapes", "cast_params", "decode_step", "forward_lm",
           "init_params", "lm_loss", "model_shapes", "prefill", "zero_cache"]
