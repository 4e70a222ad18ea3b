"""repro_torch.serving — the batched serving engine over the fusion
compiler: shape buckets, reduction-safe padding or per-lane masking,
batched K1 launches, packed multi-sequence dispatches, one CUDA graph
per dispatch; and its replica-sharded variant over a mesh."""
from .engine import (Request, RequestResult, ServingEngine,
                     ShardedServingEngine, bucket_of, input_pad_values,
                     pad_to_shape, replica_fill)

__all__ = ["Request", "RequestResult", "ServingEngine",
           "ShardedServingEngine", "bucket_of", "input_pad_values",
           "pad_to_shape", "replica_fill"]
