"""Sampling-knob validation (the port's copy of
``repro.core.fleet.check_sampling_knobs``).

The FLEET baselines, the reservoir and the executor's ``sampled`` tier are
not ported yet (ROADMAP Queue 1 item 7); the executor and the engine config
still validate the sampling knobs they carry, with the reference's rules and
messages.
"""
from __future__ import annotations

import numpy as np

__all__ = ["check_sampling_knobs"]


def check_sampling_knobs(capacity, gamma, seed) -> None:
    """Reject bad sampling knobs loudly *before any state exists or
    mutates*.  ``capacity`` must be a positive int (bools are ints in
    Python — rejected), ``gamma`` must lie strictly inside (0, 1), and
    ``seed`` must be an int (a float seed would silently truncate)."""
    if isinstance(capacity, bool) or not isinstance(
            capacity, (int, np.integer)):
        raise ValueError(f"capacity must be an int, got {capacity!r}")
    if int(capacity) <= 0:
        raise ValueError(f"capacity must be positive, got {int(capacity)}")
    if not (0.0 < float(gamma) < 1.0):
        raise ValueError(
            f"gamma must lie strictly in (0, 1), got {float(gamma)}")
    if isinstance(seed, bool) or not isinstance(seed, (int, np.integer)):
        raise ValueError(f"seed must be an int, got {seed!r}")
