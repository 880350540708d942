"""What the port's sharded code and kernels tell an observer of a step.

The port runs a mesh in one process, so the positions of a mesh may share
a device (``[cuda:0] * 8``, ``["meta"] * 256``) and a device cannot say
whose work it is doing.  The sharded code says it instead: it enters
:func:`at_position` for the work of one position (``core.distributed``'s
scatter per block, ``distributed.collectives``' pair partials and sums),
reports each move between positions with :func:`note_move` and each
kernel whose work a dispatch cannot see (K1 on ``meta``) with
:func:`note_kernel`.  Without an observer (``observing``) the notes go
nowhere; a position is a flat index into ``Mesh.devices``.
"""
from __future__ import annotations

import contextlib
import contextvars

__all__ = ["at_position", "current_position", "note_kernel", "note_move",
           "observing"]

_POSITION: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "mesh_position", default=None)
_observers: list = []


@contextlib.contextmanager
def at_position(position: int):
    """The work inside is mesh position ``position``'s."""
    token = _POSITION.set(int(position))
    try:
        yield
    finally:
        _POSITION.reset(token)


def current_position() -> int | None:
    """The position whose work runs now, or None outside any."""
    return _POSITION.get()


@contextlib.contextmanager
def observing(observer):
    """Send every note made inside to ``observer`` (an object with
    ``move(kind, src, dst, nbytes)`` and ``kernel(name, flops, nbytes)``)."""
    _observers.append(observer)
    try:
        yield observer
    finally:
        _observers.remove(observer)


def note_move(kind: str, src: int, dst: int, nbytes: int) -> None:
    """``nbytes`` went from position ``src`` to ``dst`` in a collective of
    ``kind`` (XLA's names: ``collective-permute``, ``all-to-all``,
    ``all-reduce``, ``all-gather``)."""
    for o in _observers:
        o.move(kind, int(src), int(dst), int(nbytes))


def note_kernel(name: str, flops: float, nbytes: int) -> None:
    """Kernel ``name`` did ``flops`` operations over ``nbytes`` of operands
    and results at the current position."""
    for o in _observers:
        o.kernel(name, float(flops), int(nbytes))
