"""Train-step factory with gradient-accumulation microbatching (the port of
``repro.train.loop``).

``make_train_step(loss_fn, n_microbatches)`` returns ``step(state, batch)
-> (state, metrics)``.  The global batch is split into ``[n_micro, micro,
...]`` and the microbatches run one after another; their gradients
accumulate in float32.  The step updates the parameters and the moments in
place, which stands for the reference's donation of the state.

On a mesh (the state's parameters a tree of ``ShardedTensor`` leaves, as
the registry's ``in_shardings`` and ``restore_checkpoint(...,
shardings=)`` lay them out) the step is the one GSPMD makes of the
reference's: microbatch ``i`` is rows ``[i * mb, (i + 1) * mb)`` of the
global batch, laid out over the data axes by ``loss_fn`` (a batch of
``ShardedTensor`` leaves is re-split to it, each row from a position that
holds it; one microbatch is the batch as it lies, which ``loss_fn`` lays
out as its cell's specs say: the GNNs' over ``"flat"``); each position's
shards take the gradient (``loss_fn`` returns
one scalar, the mesh's loss), accumulated in float32 per shard; the
gradient of a block that several positions hold (a dim replicated over an
axis) is the float32 sum of their partial gradients, an all-reduce over
them; and AdamW runs on each position's shards
(``optimizer.adamw_update_mesh``).  The step reports its stages to an
observer (``observe.note_stage``: ``"microbatches"``, ``"optimizer"``), and
under :func:`traced_microbatches` runs only the first microbatches, so
that the dry-run can trace one and scale it.  Under :func:`traced_layers`
a loss that runs a stack of identical layers (the LMs' trunk over a mesh,
``models.transformer.sharded_train``) runs only the first of them and
has the observer count one of those as all the rest
(:func:`scaled_layers`).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

import torch

from .checkpoint import tree_flatten, tree_map, tree_unflatten
from .optimizer import adamw_update, adamw_update_mesh, param_leaves
from .train_state import TrainState

__all__ = ["make_train_step", "scaled_layers", "traced_layers",
           "traced_microbatches"]

_TRACED: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "traced_microbatches", default=None)
_LAYERS: contextvars.ContextVar[tuple | None] = contextvars.ContextVar(
    "traced_layers", default=None)


@contextlib.contextmanager
def traced_microbatches(k: int):
    """Inside, a step over a mesh runs only its first ``k`` microbatches
    (its loss and gradients then lack the rest: a dry-run's trace, whose
    costs the caller scales by the stage marks)."""
    token = _TRACED.set(int(k))
    try:
        yield
    finally:
        _TRACED.reset(token)


@contextlib.contextmanager
def traced_layers(k: int | None):
    """Inside, a loss over a mesh whose trunk has more than ``k`` identical
    layers runs only its first ``k`` and has the observer count one of
    them as the rest (a dry-run's trace; its values lack those layers);
    ``k=None`` runs them all.  Yields a dict that such a loss fills
    (:func:`scaled_layers`): empty where no loss scaled its layers."""
    info: dict = {}
    token = _LAYERS.set(None if k is None else (int(k), info))
    try:
        yield info
    finally:
        _LAYERS.reset(token)


def scaled_layers(n_layers: int) -> int | None:
    """How many of a trunk's ``n_layers`` layers to run under
    :func:`traced_layers` (None: all of them, as outside it), noting the
    answer in the dict it yielded."""
    got = _LAYERS.get()
    if got is None or n_layers <= got[0]:
        return None
    k, info = got
    info.update(n_layers=n_layers, traced=k)
    return k


def _value_and_grad(loss_fn: Callable, params, batch, leaves: dict
                    ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves.values(), grads)]


def _on_mesh(params) -> bool:
    from ..distributed.sharding import ShardedTensor

    leaves, _ = tree_flatten(params)
    return bool(leaves) and isinstance(leaves[0], ShardedTensor)


def _rows(x, lo: int, hi: int, shard):
    """Rows ``[lo, hi)`` of a batch leaf: a view of a whole tensor, or of a
    ``ShardedTensor`` split over its rows the rows re-split over the data
    axes (``("batch", None, ...)``), each position's taken from itself, a
    position on its device, or the lowest that holds them (an
    all-to-all)."""
    from ..distributed.observe import at_position
    from ..distributed.sharding import ShardedTensor, send

    if not isinstance(x, ShardedTensor):
        return x[lo:hi]
    mesh = x.sharding.mesh
    devs = mesh.devices.ravel()
    shape = (hi - lo, *x.shape[1:])
    have = [x.sharding.shard_slices(q, x.shape) for q in range(mesh.size)]
    if any(h[d] != slice(0, x.shape[d]) for h in have
           for d in range(1, len(shape))):
        raise ValueError("a batch leaf split past its rows")
    target = shard.named("batch", *(None,) * (len(shape) - 1)).fitted(shape)
    out = []
    for p in range(mesh.size):
        want = target.shard_slices(p, shape)[0]
        r, stop, parts = lo + want.start, lo + want.stop, []
        with at_position(p):
            while r < stop:
                held = [q for q in range(mesh.size)
                        if have[q][0].start <= r < have[q][0].stop]
                q = p if p in held else next(
                    (h for h in held if devs[h] == devs[p]), held[0])
                end = min(stop, have[q][0].stop)
                start = have[q][0].start
                parts.append(send(x.shards[q][r - start:end - start], q, p,
                                  "all-to-all", devs[p]))
                r = end
            out.append(torch.cat(parts) if len(parts) > 1 else parts[0]
                       if parts else x.shards[p][:0])
    return ShardedTensor(target, shape, tuple(out))


def _reduce_replicas(st, grads: list) -> list:
    """``grads[p]`` (position ``p``'s gradient of its shard of ``st``) with
    each block that several positions hold summed over them in float32 at
    the first, in position order, and the sum placed back on each (an
    all-reduce)."""
    from ..device import on_device
    from ..distributed.observe import at_position
    from ..distributed.sharding import send

    devs = st.sharding.mesh.devices.ravel()
    out = list(grads)
    for group in st.holders():
        if len(group) == 1:
            continue
        home = group[0]
        with on_device(devs[home]), at_position(home):
            total = grads[home].float()
            for q in group[1:]:
                total = total + send(grads[q], q, home, "all-reduce",
                                     devs[home]).float()
        for q in group:
            with at_position(q):
                out[q] = send(total, home, q, "all-reduce", devs[q])
    return out


def _mesh_step(loss_fn: Callable, state: TrainState, batch, nm: int,
               **adamw) -> tuple[TrainState, dict]:
    """The step over a mesh (see the module docstring)."""
    from ..device import on_device
    from ..distributed.observe import at_position, note_stage
    from ..distributed.sharding import ShardedTensor, Sharder

    leaves, treedef = tree_flatten(state.params)
    mesh = leaves[0].sharding.mesh
    shard = Sharder.for_mesh(mesh)
    devs = mesh.devices.ravel()
    takes = [[s.detach().requires_grad_() for s in st.shards]
             for st in leaves]
    params = tree_unflatten(treedef, [
        ShardedTensor(st.sharding, st.shape, tuple(t))
        for st, t in zip(leaves, takes)])
    flat = [t for ts in takes for t in ts]
    b_all = tree_flatten(batch)[0][0].shape[0]
    mb = b_all // nm
    runs = nm if _TRACED.get() is None else min(nm, _TRACED.get())
    acc = None
    if nm > 1:
        acc = []
        for st in leaves:
            row = []
            for p, s in enumerate(st.shards):
                with on_device(devs[p]), at_position(p):
                    row.append(torch.zeros(s.shape, dtype=torch.float32,
                                           device=s.device))
            acc.append(row)
    with at_position(0):
        loss = torch.zeros((), dtype=torch.float32, device=devs[0])
    note_stage("microbatches")
    for i in range(runs):
        # one microbatch is the batch as it lies: the loss lays it out
        micro = batch if nm == 1 else tree_map(
            lambda x: _rows(x, i * mb, (i + 1) * mb, shard), batch)
        value = loss_fn(params, micro)
        got = torch.autograd.grad(value, flat, allow_unused=True)
        got = [torch.zeros_like(t) if g is None else g
               for t, g in zip(flat, got)]
        del micro
        grads = [got[j * mesh.size:(j + 1) * mesh.size]
                 for j in range(len(leaves))]
        del got
        if acc is not None:
            for row, gs in zip(acc, grads):
                for p, (a, g) in enumerate(zip(row, gs)):
                    with on_device(devs[p]), at_position(p):
                        a.add_(g.float())
            del grads
        with at_position(0):
            loss = loss + value.detach().float().to(devs[0])
    note_stage("optimizer")
    if acc is not None:
        for row in acc:
            for p, a in enumerate(row):
                with on_device(devs[p]), at_position(p):
                    a.div_(nm)
        grads = acc
    grads = [_reduce_replicas(st, gs) for st, gs in zip(leaves, grads)]
    with at_position(0):
        loss = loss / nm
    params, opt, gnorm = adamw_update_mesh(grads, state.opt, state.params,
                                           **adamw)
    metrics = {"loss": loss, "grad_norm": gnorm, "step": opt.step.shards[0]
               if isinstance(opt.step, ShardedTensor) else opt.step}
    return TrainState(params, opt, state.rng), metrics


def make_train_step(
    loss_fn: Callable,            # loss_fn(params, microbatch) -> scalar
    *,
    n_microbatches: int = 1,
    lr: float = 3e-4,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
):
    def split_batch(batch):
        def rs(x):
            mb = x.shape[0] // n_microbatches
            return x.reshape(n_microbatches, mb, *x.shape[1:])
        return tree_map(rs, batch)

    def step(state: TrainState, batch):
        params = state.params
        if _on_mesh(params):
            return _mesh_step(loss_fn, state, batch, n_microbatches, lr=lr,
                              weight_decay=weight_decay, clip_norm=clip_norm)
        leaves = param_leaves(params)
        for p in leaves.values():
            p.requires_grad_(True)
        if n_microbatches == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch, leaves)
        else:
            micro = split_batch(batch)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves.values()]
            loss = None
            for i in range(n_microbatches):
                mb = tree_map(lambda x: x[i], micro)
                l, g = _value_and_grad(loss_fn, params, mb, leaves)
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                del g
                loss = l.float() if loss is None else loss + l
            for acc in grads:
                acc.div_(n_microbatches)
            loss = loss / n_microbatches
        params, opt, gnorm = adamw_update(
            dict(zip(leaves, grads)), state.opt, params, lr=lr,
            weight_decay=weight_decay, clip_norm=clip_norm)
        metrics = {"loss": loss.float(), "grad_norm": gnorm, "step": opt.step}
        return TrainState(params, opt, state.rng), metrics

    step.n_microbatches = n_microbatches
    return step
