"""Training of the port: AdamW (:mod:`.optimizer`), the train state and the
microbatched train step (:mod:`.train_state`, :mod:`.loop`), the
fault-injection seam and backoff policies (:mod:`.fault`) and atomic,
CRC-checked checkpoints (:mod:`.checkpoint`)."""
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
from .loop import make_train_step
from .optimizer import AdamWState, adamw_init, adamw_update
from .train_state import TrainState
from .fault import (
    BackoffPolicy,
    ElasticPlan,
    StragglerPolicy,
    fault_point,
    recompute_plan,
    set_fault_hook,
)

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "TrainState",
    "make_train_step",
    "AsyncCheckpointer", "CheckpointCorruption", "gc_tmp_dirs",
    "latest_step", "restore_checkpoint", "restore_latest_valid",
    "save_checkpoint", "valid_steps", "verify_checkpoint",
    "BackoffPolicy", "ElasticPlan", "StragglerPolicy", "fault_point",
    "recompute_plan", "set_fault_hook",
]
