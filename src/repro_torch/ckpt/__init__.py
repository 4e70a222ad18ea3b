"""repro_torch.ckpt — fault tolerance (checkpointing comes with the next
slice of the port: ``ROADMAP.md``)."""
from .fault_tolerance import (Heartbeat, PreemptionGuard, StepWatchdog,
                              StragglerReport, plan_remesh)

__all__ = ["Heartbeat", "PreemptionGuard", "StepWatchdog", "StragglerReport",
           "plan_remesh"]
