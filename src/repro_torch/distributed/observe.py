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

A backward runs outside every ``at_position`` (autograd's engine calls
the nodes), so while an observer watches a differentiable run,
:func:`at_position` also tags each autograd node made inside with its
position (:func:`tag_node`): the node's backward then runs at the
position whose forward made it, and an observer sees each backward op,
and each tensor it makes, where it belongs.  A move between positions
tags its node with both ends (``distributed.sharding.send``): its
backward runs at the receiving position and hands its gradient on at the
sending one.  :func:`note_stage` marks the boundaries of a step's stages
(the train step's microbatches, a layer of the LMs' trunk) for an observer
that keeps them, and :func:`note_repeat` asks it to count the work since
the last mark again, as if it ran more times (the layers a trace skips).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["at_position", "current_position", "note_kernel", "note_move",
           "note_repeat", "note_stage", "observing", "tag_node"]

_POSITION: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "mesh_position", default=None)
_TAGGING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "mesh_tagging", default=False)
_RESTORING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "mesh_restoring", default=False)
_observers: list = []
# the key of a node's metadata that holds its position
_KEY = "mesh_position"


@functools.lru_cache(maxsize=None)
def _setter(position: int):
    """A hook that makes ``position`` current (and changes no gradient); the
    first of a backward also has the position that was current before it
    made current again when the backward ends.  One per position, shared
    by its nodes."""
    def hook(*_) -> None:
        if not _RESTORING.get():
            _RESTORING.set(True)
            before = _POSITION.get()

            def restore() -> None:
                _POSITION.set(before)
                _RESTORING.set(False)
            torch.autograd.Variable._execution_engine.queue_callback(restore)
        _POSITION.set(position)
    return hook


def tag_node(node, position: int, after: int | None = None) -> None:
    """Run autograd node ``node``'s backward at ``position``, and what
    follows it (the sums of its gradients into the nodes before it) at
    ``after`` (default ``position``); nodes before it made by no tagged op
    get ``position`` too.  A node tagged once keeps its tag; leaves'
    accumulators are not tagged."""
    stack = [(node, int(position), int(position if after is None
                                           else after))]
    while stack:
        node, pre, post = stack.pop()
        if node is None or hasattr(node, "variable"):
            continue
        meta = node.metadata
        if _KEY in meta:
            continue
        meta[_KEY] = pre
        node.register_prehook(_setter(pre))
        node.register_hook(_setter(post))
        stack.extend((nxt, post, post) for nxt, _ in node.next_functions)


class _Tagger(TorchFunctionMode):
    """Tags the autograd nodes of every op's outputs with the current
    position (:func:`tag_node`)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        p = _POSITION.get()
        if p is not None:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.grad_fn is not None:
                    tag_node(t.grad_fn, p)
        return out


@contextlib.contextmanager
def at_position(position: int):
    """The work inside is mesh position ``position``'s.  While an observer
    watches and gradients are on, the autograd nodes made inside are
    tagged with the position (see the module docstring)."""
    token = _POSITION.set(int(position))
    tag = bool(_observers) and torch.is_grad_enabled() and not _TAGGING.get()
    try:
        if tag:
            flag = _TAGGING.set(True)
            try:
                with _Tagger():
                    yield
            finally:
                _TAGGING.reset(flag)
        else:
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
    ``all-reduce``, ``all-gather``, ``reduce-scatter``)."""
    for o in _observers:
        o.move(kind, int(src), int(dst), int(nbytes))


def note_stage(name: str) -> None:
    """A step's stage ``name`` begins (an observer with a ``stage(name)``
    method keeps the mark)."""
    for o in _observers:
        mark = getattr(o, "stage", None)
        if mark is not None:
            mark(name)


def note_repeat(since: str, times: int) -> None:
    """The work done since the mark of stage ``since`` runs ``times`` more
    times in a row from here, untraced (an observer with a
    ``repeat(since, times)`` method counts it)."""
    for o in _observers:
        again = getattr(o, "repeat", None)
        if again is not None:
            again(since, int(times))


def note_kernel(name: str, flops: float, nbytes: int) -> None:
    """Kernel ``name`` did ``flops`` operations over ``nbytes`` of operands
    and results at the current position."""
    for o in _observers:
        o.kernel(name, float(flops), int(nbytes))
