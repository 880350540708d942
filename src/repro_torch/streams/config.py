"""One validated config object for the streaming engine: ``EngineConfig``.

The port's copy of ``repro.streams.config.EngineConfig``: the same knobs,
validation, defaults and JSON form, so a checkpoint's embedded config reads
the same in both packages.  Besides the reference's ``devices`` / ``mesh``
(window sharding) the port takes ``device`` (default ``cuda``; with
``devices`` / ``mesh`` the mesh's first device); all three are deployment
properties and never serialized, so a checkpoint of a sharded engine
restores into an unsharded one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from dataclasses import dataclass

import numpy as np

__all__ = ["EngineConfig", "ServingConfig", "DUP_POLICIES",
           "resolve_engine_config", "resolve_sync_dispatch",
           "SYNC_DISPATCH_ENV"]

# escape hatch forcing the engine's blocking flush path (submit + reap in
# one call) without touching code: SGRAPP_SYNC_DISPATCH=1
SYNC_DISPATCH_ENV = "SGRAPP_SYNC_DISPATCH"

# duplicate-edge policies: "distinct" is the paper's keep-first semantics;
# "multiset" counts butterflies multiplicity-weighted
DUP_POLICIES = ("distinct", "multiset")

# knobs that are part of the stream's semantics or identity and therefore
# serialize into checkpoints (the reference's list, in its order)
_PORTABLE_FIELDS = (
    "tier", "tol", "step", "flush_every", "drop_partial", "align",
    "dup_policy", "on_missing_delete", "seed", "capacity", "gamma",
    "memory_budget", "target_mape",
)


@dataclass(frozen=True)
class EngineConfig:
    """Frozen, validated knob set for the streaming engine.

    Parameters
    ----------
    tier : counting tier the engine builds its executor with (``numpy |
        dense | tiled | pallas | sparse | auto | sampled``).
    tol, step : Algorithm 5 error band and alpha adaptation step.
    flush_every : closed windows to accumulate before one bucketed count.
    drop_partial : whether ``finalize()`` drops a trailing unfilled window.
    align : edge-lane alignment of packed flush batches.
    dup_policy : ``"distinct"`` (keep-first dedupe) or ``"multiset"``
        (multiplicity-weighted counts; not with the ``sampled`` tier).
    on_missing_delete : ``"raise"`` or ``"ignore"`` for deletes of absent
        edges.
    seed, capacity, gamma, memory_budget, target_mape : the sampled tier's
        knobs, validated and carried so checkpoints round-trip.
    sync_dispatch : force the blocking flush path instead of the
        overlapped one (also ``SGRAPP_SYNC_DISPATCH=1``); both are
        bit-identical.  Deployment-only, never serialized.
    warmup : ``(cap_e, cap_i, cap_j)`` rungs to run once at engine
        construction.  Deployment-only, never serialized.
    device : where the engine counts and estimates; default ``cuda``.
        Deployment-only, never serialized.
    devices, mesh : shard each flush's window axis (``WindowExecutor``'s
        knobs; not with a shared ``executor=``).  Deployment-only, never
        serialized.
    """

    tier: str = "dense"
    tol: float = 0.05
    step: float = 0.005
    flush_every: int = 32
    drop_partial: bool = True
    align: int = 64
    dup_policy: str = "distinct"
    on_missing_delete: str = "raise"
    seed: int = 0
    capacity: int = 8192
    gamma: float = 0.7
    memory_budget: int | None = None
    target_mape: float | None = None
    sync_dispatch: bool = False
    warmup: tuple = ()
    device: object = None
    devices: object = None
    mesh: object = None

    def __post_init__(self):
        from ..core.executor import TIERS
        from ..core.fleet import check_sampling_knobs

        def pin(name, value):
            object.__setattr__(self, name, value)

        if self.tier not in TIERS:
            raise ValueError(
                f"tier must be one of {TIERS}, got {self.tier!r}")
        pin("tol", float(self.tol))
        pin("step", float(self.step))
        if int(self.flush_every) < 1:
            raise ValueError("flush_every must be >= 1")
        pin("flush_every", int(self.flush_every))
        pin("drop_partial", bool(self.drop_partial))
        if int(self.align) < 1:
            raise ValueError("align must be >= 1")
        pin("align", int(self.align))
        if self.dup_policy not in DUP_POLICIES:
            raise ValueError(
                f"dup_policy must be one of {DUP_POLICIES}, got "
                f"{self.dup_policy!r}")
        if self.on_missing_delete not in ("raise", "ignore"):
            raise ValueError(
                "on_missing_delete must be 'raise' or 'ignore', got "
                f"{self.on_missing_delete!r}")
        check_sampling_knobs(self.capacity, self.gamma, self.seed)
        pin("capacity", int(self.capacity))
        pin("gamma", float(self.gamma))
        pin("seed", int(self.seed))
        if self.memory_budget is not None:
            if (isinstance(self.memory_budget, bool)
                    or not isinstance(self.memory_budget, (int, np.integer))
                    or int(self.memory_budget) <= 0):
                raise ValueError(
                    f"memory_budget must be a positive int or None, "
                    f"got {self.memory_budget!r}")
            pin("memory_budget", int(self.memory_budget))
        if self.target_mape is not None:
            if not (float(self.target_mape) > 0.0):
                raise ValueError(
                    f"target_mape must be positive or None, "
                    f"got {self.target_mape!r}")
            pin("target_mape", float(self.target_mape))
        pin("sync_dispatch", bool(self.sync_dispatch))
        rungs = []
        for rung in tuple(self.warmup):
            rung = tuple(int(x) for x in rung)
            if len(rung) != 3 or any(x < 1 for x in rung):
                raise ValueError(
                    "warmup rungs must be (cap_e, cap_i, cap_j) triples of "
                    f"positive ints, got {rung!r}")
            rungs.append(rung)
        pin("warmup", tuple(rungs))
        if self.dup_policy == "multiset" and self.tier == "sampled":
            raise NotImplementedError(
                "sampled tier does not support dup_policy='multiset': the "
                "subsample-and-scale identity assumes distinct edges; use "
                "an exact tier for multiset streams")

    # -- executor construction ----------------------------------------------

    def make_executor(self, executor=None):
        """Build the engine's :class:`WindowExecutor`, or validate and pass
        through a prebuilt one.  ``snap=0``: engine flushes see the stream
        piecewise, so buckets run at ladder rungs."""
        from ..core.executor import WindowExecutor

        if executor is not None:
            if self.devices is not None or self.mesh is not None:
                raise ValueError(
                    "devices=/mesh= conflict with executor=; configure the "
                    "executor's sharding at construction instead")
            if self.device is not None:
                raise ValueError(
                    "device= conflicts with executor=; the executor already "
                    "owns its device")
            if self.dup_policy == "multiset" and executor.tier == "sampled":
                raise NotImplementedError(
                    "sampled tier does not support dup_policy='multiset': "
                    "the subsample-and-scale identity assumes distinct "
                    "edges; use an exact tier for multiset streams")
            return executor
        return WindowExecutor(
            self.tier, align=self.align, snap=0,
            capacity=self.capacity, gamma=self.gamma, seed=self.seed,
            memory_budget=self.memory_budget, target_mape=self.target_mape,
            device=self.device, devices=self.devices, mesh=self.mesh)

    # -- serialization -------------------------------------------------------

    def to_json(self) -> str:
        """Portable JSON form (deterministic key order), identical to the
        reference's for the same knobs.  ``device`` / ``devices`` / ``mesh``
        are deployment-only and never serialized."""
        return json.dumps(
            {f: getattr(self, f) for f in _PORTABLE_FIELDS}, sort_keys=True)

    @classmethod
    def from_json(cls, payload: str, *, device=None) -> "EngineConfig":
        """Inverse of :meth:`to_json`, with the deployment ``device`` given
        separately.  Strict: an unknown field raises."""
        obj = json.loads(payload)
        if not isinstance(obj, dict):
            raise ValueError(f"EngineConfig JSON must be an object, "
                             f"got {type(obj).__name__}")
        unknown = sorted(set(obj) - set(_PORTABLE_FIELDS))
        if unknown:
            raise ValueError(
                f"EngineConfig JSON has unknown fields {unknown}")
        return cls(**obj, device=device)

    def replace(self, **changes) -> "EngineConfig":
        """A copy with ``changes`` applied (re-validated)."""
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ServingConfig:
    """Durability and supervision knobs of the serving front end
    (:class:`repro_torch.streams.server.StreamServer`), the reference's.
    Separate from :class:`EngineConfig`: they govern the server process
    (WAL, watchdog restarts, checkpoint retry), not the stream's
    semantics, so they never serialize into engine checkpoints and may
    differ across restarts of the same stream.

    Parameters
    ----------
    wal : write every admitted push to the per-tenant WAL before acking
        (needs the server's ``checkpoint_dir``); ``False`` leaves
        checkpoint-only durability.
    wal_segment_bytes : WAL segment rotation size.
    wal_fsync : fsync the WAL once per coalesce cycle (group commit);
        ``False`` survives a process crash (SIGKILL) but not power loss.
    restart_backoff : supervisor backoff for crashed internal loops
        (coalescer, checkpoint loop); restarts are unbounded, the delay is
        bounded by ``restart_backoff.max_s``.
    checkpoint_retry : backoff between retries of a failed periodic
        checkpoint (e.g. disk full).
    degraded_checkpoint_age_factor : report degraded health when the last
        successful checkpoint is older than ``factor *
        checkpoint_every_s``.
    drain_timeout_s : ``stop()`` waits this long for the coalescer to
        drain before resolving queued pushes with ``draining``.
    """

    wal: bool = True
    wal_segment_bytes: int = 4 << 20
    wal_fsync: bool = True
    restart_backoff: object = None
    checkpoint_retry: object = None
    degraded_checkpoint_age_factor: float = 3.0
    drain_timeout_s: float = 10.0

    def __post_init__(self):
        from ..train.fault import BackoffPolicy

        def pin(name, value):
            object.__setattr__(self, name, value)

        pin("wal", bool(self.wal))
        if int(self.wal_segment_bytes) < 1:
            raise ValueError("wal_segment_bytes must be >= 1")
        pin("wal_segment_bytes", int(self.wal_segment_bytes))
        pin("wal_fsync", bool(self.wal_fsync))
        if self.restart_backoff is None:
            pin("restart_backoff", BackoffPolicy(initial_s=0.05, max_s=5.0))
        elif not isinstance(self.restart_backoff, BackoffPolicy):
            raise TypeError("restart_backoff must be a BackoffPolicy")
        if self.checkpoint_retry is None:
            pin("checkpoint_retry", BackoffPolicy(initial_s=0.5, max_s=30.0))
        elif not isinstance(self.checkpoint_retry, BackoffPolicy):
            raise TypeError("checkpoint_retry must be a BackoffPolicy")
        if not (float(self.degraded_checkpoint_age_factor) > 0.0):
            raise ValueError("degraded_checkpoint_age_factor must be > 0")
        pin("degraded_checkpoint_age_factor",
            float(self.degraded_checkpoint_age_factor))
        if not (float(self.drain_timeout_s) > 0.0):
            raise ValueError("drain_timeout_s must be > 0")
        pin("drain_timeout_s", float(self.drain_timeout_s))

    def replace(self, **changes) -> "ServingConfig":
        return dataclasses.replace(self, **changes)


# sentinel distinguishing "caller never passed this legacy kwarg" from any
# real value (None is a real value for device)
_UNSET = object()


def resolve_engine_config(config, legacy: dict) -> EngineConfig:
    """Resolve ``config=`` vs per-knob keyword arguments into one validated
    :class:`EngineConfig`, as the reference does: ``config=`` alone wins;
    knobs alone build a config (with a ``DeprecationWarning``); both raise
    ``ValueError``; neither gives the defaults."""
    passed = {k: v for k, v in legacy.items() if v is not _UNSET}
    if config is not None:
        if not isinstance(config, EngineConfig):
            raise TypeError(
                f"config must be an EngineConfig, got "
                f"{type(config).__name__}")
        if passed:
            raise ValueError(
                f"config= conflicts with legacy engine kwargs "
                f"{sorted(passed)}; set them on the EngineConfig instead")
        return config
    if passed:
        warnings.warn(
            "passing engine knobs as keyword arguments is deprecated; "
            "build an EngineConfig and pass config= "
            f"(got legacy kwargs {sorted(passed)})",
            DeprecationWarning, stacklevel=3)
        return EngineConfig(**passed)
    return EngineConfig()


def resolve_sync_dispatch(config: EngineConfig) -> bool:
    """Whether an engine built from ``config`` uses the blocking flush path:
    the ``sync_dispatch`` field OR'd with ``SGRAPP_SYNC_DISPATCH=1``
    (resolved once, at engine construction)."""
    return bool(config.sync_dispatch) or (
        os.environ.get(SYNC_DISPATCH_ENV, "") == "1")
