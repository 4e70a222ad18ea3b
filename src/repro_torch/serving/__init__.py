"""repro_torch.serving — the batched serving engine over the fusion
compiler: shape buckets, reduction-safe padding or per-lane masking,
batched K1 launches, packed multi-sequence dispatches, one CUDA graph
per dispatch."""
from .engine import (Request, RequestResult, ServingEngine, bucket_of,
                     input_pad_values, pad_to_shape)

__all__ = ["Request", "RequestResult", "ServingEngine", "bucket_of",
           "input_pad_values", "pad_to_shape"]
