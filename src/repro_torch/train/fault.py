"""Failure / straggler / elasticity policies, and the fault-injection seam.

The port's copy of ``repro.train.fault`` (host-only, no device work): the
control-plane half of fault tolerance.  The data-plane half (atomic,
CRC-checked, async checkpoints) lives in :mod:`repro_torch.train.checkpoint`,
and the serving stack's write-ahead log in :mod:`repro_torch.streams.wal`.

Policies
--------
- Restart-from-checkpoint: any hard failure restarts the job from the
  newest valid checkpoint.
- Elastic resize: when the data-parallel degree changes between restarts,
  the batch schedule is re-planned (:func:`recompute_plan`) so the global
  batch stays fixed.
- Straggler mitigation: sGrapp's adaptive windows balance work by
  themselves (equal-unique-timestamp windows -> equal expected work); the
  training side gets timeout and skip knobs as a policy object.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "ElasticPlan",
    "recompute_plan",
    "StragglerPolicy",
    "BackoffPolicy",
    "fault_point",
    "set_fault_hook",
]


# -- deterministic fault-injection seam --------------------------------------
#
# ``fault_point(name)`` marks a crash/fault site on a production code path
# (checkpoint rename, WAL sync, engine apply, ...).  By default it is a
# no-op; the serving fault harness (:mod:`repro_torch.streams.faults`) installs a
# hook that counts traversals and fires planned faults (SIGKILL, raised
# OSError, ...).  The hook lives *here* — the lowest layer that needs a
# seam — so ``train.checkpoint`` can mark its sites without importing the
# streams package.

_FAULT_HOOK = None


def set_fault_hook(hook) -> None:
    """Install (or with ``None`` remove) the process-global fault hook.
    Called by :func:`repro_torch.streams.faults.install_plan`."""
    global _FAULT_HOOK
    _FAULT_HOOK = hook


def fault_point(name: str) -> None:
    """Traverse a named injection point.  No-op unless a plan is installed;
    an installed hook may raise or kill the process here, by design."""
    if _FAULT_HOOK is not None:
        _FAULT_HOOK(name)


@dataclass(frozen=True)
class BackoffPolicy:
    """Deterministic bounded exponential backoff (no jitter — the fault
    harness replays schedules, so delays must be reproducible).

    ``delay(k)`` is the sleep before retry ``k`` (0-based):
    ``min(max_s, initial_s * factor**k)``.
    """

    initial_s: float = 0.05
    max_s: float = 5.0
    factor: float = 2.0

    def __post_init__(self):
        if not (self.initial_s > 0.0):
            raise ValueError("initial_s must be positive")
        if not (self.max_s >= self.initial_s):
            raise ValueError("max_s must be >= initial_s")
        if not (self.factor >= 1.0):
            raise ValueError("factor must be >= 1")

    def delay(self, attempt: int) -> float:
        if attempt < 0:
            raise ValueError("attempt must be >= 0")
        return min(self.max_s, self.initial_s * self.factor ** attempt)


@dataclass(frozen=True)
class ElasticPlan:
    global_batch: int
    n_data_shards: int
    microbatch_size: int
    n_microbatches: int

    @property
    def per_shard_batch(self) -> int:
        return self.global_batch // self.n_data_shards


def recompute_plan(global_batch: int, n_data_shards: int,
                   max_per_device_batch: int) -> ElasticPlan:
    """Re-plan microbatching after an elastic resize.

    Keeps the *global* batch (and therefore the optimization trajectory)
    fixed while the number of data shards changes; raises if the global
    batch cannot be evenly re-tiled (the launcher then pads or rejects).
    """
    if global_batch % n_data_shards:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n_data_shards} shards")
    per_shard = global_batch // n_data_shards
    micro = min(per_shard, max_per_device_batch)
    while per_shard % micro:
        micro -= 1
    return ElasticPlan(global_batch, n_data_shards, micro, per_shard // micro)


@dataclass(frozen=True)
class StragglerPolicy:
    """Knobs the launcher maps onto runtime flags / collective configs."""
    collective_timeout_s: float = 300.0   # abort-and-restart past this
    checkpoint_every_steps: int = 100
    checkpoint_every_windows: int = 50    # streaming jobs: window-granular
    spare_capacity_frac: float = 0.05     # hot spares per pod for fast swap
    skip_slow_replica_after_s: float = 60.0
