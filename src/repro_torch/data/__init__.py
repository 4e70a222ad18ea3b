"""repro_torch.data — deterministic synthetic pipeline."""
from .pipeline import DataConfig, SyntheticLM, make_batch_fn, shard_batch

__all__ = ["DataConfig", "SyntheticLM", "make_batch_fn", "shard_batch"]
