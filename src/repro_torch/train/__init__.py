"""Durability substrate of the port: the fault-injection seam and backoff
policies (:mod:`.fault`) and atomic, CRC-checked checkpoints
(:mod:`.checkpoint`).  The reference's training loop and optimizer are not
part of the port."""
from .checkpoint import (
    AsyncCheckpointer,
    CheckpointCorruption,
    gc_tmp_dirs,
    latest_step,
    restore_checkpoint,
    restore_latest_valid,
    save_checkpoint,
    valid_steps,
    verify_checkpoint,
)
from .fault import (
    BackoffPolicy,
    ElasticPlan,
    StragglerPolicy,
    fault_point,
    recompute_plan,
    set_fault_hook,
)

__all__ = [
    "AsyncCheckpointer", "CheckpointCorruption", "gc_tmp_dirs",
    "latest_step", "restore_checkpoint", "restore_latest_valid",
    "save_checkpoint", "valid_steps", "verify_checkpoint",
    "BackoffPolicy", "ElasticPlan", "StragglerPolicy", "fault_point",
    "recompute_plan", "set_fault_hook",
]
