"""repro_torch.dist — the distributed layer, its replica side: the mesh
helpers and ``shard_program``, which spreads a batched program's request
batch over the ``data`` axis of a mesh (``sharding``).  The FSDP and
tensor-parallel builders and the expert-parallel MoE come with the
port's SPMD slice (ROADMAP.md)."""
from . import sharding

__all__ = ["sharding"]
