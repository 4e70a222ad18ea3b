"""repro_torch.dist — the distributed layer: the reference's pspec
builders and the replica side of the serving engine (``sharding``), the
runtime of sharded training over ``torch.distributed`` (``spmd``: where
each rank's pieces lie, the process-group view of a mesh, ``run_ranks``)
and the expert-parallel MoE (``moe_ep``)."""
from . import moe_ep, sharding, spmd

__all__ = ["moe_ep", "sharding", "spmd"]
