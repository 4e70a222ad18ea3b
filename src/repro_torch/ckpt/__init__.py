"""repro_torch.ckpt — checkpointing with exact resume and fault
tolerance."""
from .checkpoint import AsyncCheckpointer, latest_step, restore, save
from .fault_tolerance import (Heartbeat, PreemptionGuard, StepWatchdog,
                              StragglerReport, plan_remesh)

__all__ = ["AsyncCheckpointer", "Heartbeat", "PreemptionGuard",
           "StepWatchdog", "StragglerReport", "latest_step", "plan_remesh",
           "restore", "save"]
