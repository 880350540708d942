"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "canonical_device", "same_device", "on_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises instead of running on the CPU when no card is present
    and the caller did not ask for ``device="cpu"`` explicitly.

    ``meta`` is admitted only where the caller names it: a placeholder
    device (shapes and dtypes, no memory, no work), the port's counterpart
    of XLA's placeholder host devices, on which the dry-run traces a step
    (``launch.dryrun``).  It is never a default and never stands in for a
    missing card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be a CUDA or CPU device (or meta, "
                         f"named explicitly), got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain torch path on the CPU")
    return dev


def canonical_device(device) -> torch.device:
    """:func:`resolve_device` with the card's index made explicit (``cuda``
    names the current card), so that two names of one device compare
    equal.  A CUDA index past the cards present raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(f"{dev} is not one of the "
                         f"{torch.cuda.device_count()} CUDA devices present")
    return torch.device("cuda", index)


def same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` is the current
    card).  Devices of different types differ without a card being
    asked for."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    return a.type != "cuda" or canonical_device(a) == canonical_device(b)


def on_device(device: torch.device):
    """The context that makes ``device`` current, so that its current
    stream takes the kernels queued inside; nothing for the CPU or
    ``meta``."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
