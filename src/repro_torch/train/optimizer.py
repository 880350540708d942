"""AdamW with global-norm clipping (the port of ``repro.train.optimizer``,
by hand: ``torch.optim`` rounds differently).

The optimizer state mirrors the parameters leaf by leaf: the float32 first
and second moments, keyed by each leaf's name (:func:`param_leaves`).  The
update runs leaf by leaf, in place under ``torch.no_grad()``, so a model
of billions of parameters holds no second copy of its parameters or
moments, only one leaf's float32 temporaries at a time.

On a mesh (:func:`adamw_update_mesh`) the parameters and both moments are
trees of ``ShardedTensor`` leaves of one layout (ZeRO-3 where the specs
split a leaf over the data axes): each position runs :func:`adamw_leaf` on
its shards, the global norm counts each distinct block once, and shards
that share storage (replicas on one device) are updated once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

__all__ = ["AdamWState", "adamw_init", "adamw_leaf", "adamw_update",
           "adamw_update_mesh", "bias_corrections", "clip_scale",
           "global_norm", "leaves_as_tree", "param_leaves"]


class AdamWState(NamedTuple):
    step: torch.Tensor          # [] int32
    m: dict                     # leaf name -> float32 tensor
    v: dict


def param_leaves(params) -> dict[str, torch.Tensor]:
    """The leaves of ``params`` by name: a module's ``named_parameters()``,
    or a tree of dicts and lists of tensors in ``jax.tree``'s leaf order
    (dict keys sorted, lists in order), with its keys and list indices
    joined by ``.`` (``w_self.0``, ``proc.edge_mlp.w.1``)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, x) -> None:
        if isinstance(x, dict):
            for k in sorted(x):
                walk(f"{prefix}{k}.", x[k])
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = x
    walk("", params)
    return out


def leaves_as_tree(named: dict, like):
    """The inverse of :func:`param_leaves` on a tree: the values of
    ``named`` (keyed by leaf name) placed in the structure of ``like``."""
    def build(prefix: str, x):
        if isinstance(x, dict):
            return {k: build(f"{prefix}{k}.", v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)([build(f"{prefix}{i}.", v) for i, v in enumerate(x)])
        return named[prefix[:-1]]
    return build("", like)


def adamw_init(params) -> AdamWState:
    """Zero float32 moments for every leaf, on the leaf's device, and step
    0 (int32)."""
    leaves = param_leaves(params)
    dev = next(iter(leaves.values())).device if leaves else None

    def zeros() -> dict:
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in leaves.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros())


def global_norm(grads: dict) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(g**2))`` in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


@torch.no_grad()
def adamw_update(
    grads: dict,
    state: AdamWState,
    params,
    *,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> tuple[object, AdamWState, torch.Tensor]:
    """One AdamW step on ``params`` in place: gradients (``grads``, by leaf
    name) scaled by ``min(1, clip_norm / max(|g|, 1e-9))``, the moments
    ``m = b1 m + (1 - b1) g`` and ``v = b2 v + (1 - b2) g g`` in float32,
    bias correction ``1 - b**t`` in float32, ``delta = mhat / (sqrt(vhat)
    + eps) + weight_decay * p`` and ``p = p - lr * delta`` rounded to the
    leaf's dtype.  Returns ``(params, state, grad_norm)``; ``params`` and
    the state's moments are the objects given, updated."""
    leaves = param_leaves(params)
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, clip_norm)
    step = state.step + 1
    bc = bias_corrections(step, b1, b2)
    for name, p in leaves.items():
        adamw_leaf(p, state.m[name], state.v[name], grads[name], scale, *bc,
                   lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return params, AdamWState(step, state.m, state.v), gnorm


def clip_scale(gnorm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """``min(1, clip_norm / max(gnorm, 1e-9))``."""
    return torch.clamp(clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)


def bias_corrections(step: torch.Tensor, b1: float, b2: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(1 - b1**t, 1 - b2**t)`` in float32 at ``step``'s device."""
    t = step.float()
    return (1.0 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t,
            1.0 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t)


@torch.no_grad()
def adamw_leaf(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               grad: torch.Tensor, scale, bc1, bc2, *, lr: float, b1: float,
               b2: float, eps: float, weight_decay: float) -> None:
    """One leaf's AdamW step in place (:func:`adamw_update`'s arithmetic):
    ``p``, its float32 moments ``m`` and ``v``, its gradient, the clip
    scale and the bias corrections."""
    g = grad.float() * scale
    m.mul_(b1).add_(g * (1 - b1))
    g2 = g * (1 - b2)
    v.mul_(b2).add_(g2.mul_(g))
    del g, g2
    den = (v / bc2).sqrt_().add_(eps)
    delta = torch.div(m / bc1, den)
    del den
    pf = p.float()
    delta.add_(pf * weight_decay)
    p.copy_(pf.sub_(delta.mul_(lr)))


def _alias(t: torch.Tensor) -> tuple:
    """What identifies ``t``'s elements: its storage and its view of it."""
    return (t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape),
            t.stride())


@torch.no_grad()
def adamw_update_mesh(
    grads: list,
    state: AdamWState,
    params,
    *,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> tuple[object, AdamWState, torch.Tensor]:
    """:func:`adamw_update` over a mesh.  ``params``, ``state.m`` and
    ``state.v`` are trees of one structure and layout whose leaves are
    ``ShardedTensor`` (``jax.tree``'s leaf order, :func:`~.checkpoint.
    tree_flatten`); ``grads[j][p]`` is leaf ``j``'s whole gradient at
    position ``p`` (replicas of a block equal).  The global norm sums each
    distinct block's squares once, at its first holder, and adds the
    positions' sums (an all-reduce over the mesh); then every position
    runs :func:`adamw_leaf` on its shards with its copy of the norm and of
    ``state.step`` (a ``ShardedTensor`` of scalars, or one tensor), where
    shards that share storage with ones already updated are skipped.
    Returns ``(params, state, grad_norm)``: the parameters and moments are
    the objects given, updated in place; the step a ``ShardedTensor`` of
    the positions' new steps (a tensor where it was one); the norm the
    mesh's first position's."""
    from ..device import on_device
    from ..distributed.collectives import psum
    from ..distributed.observe import at_position
    from ..distributed.sharding import ShardedTensor
    from .checkpoint import tree_flatten

    leaves, _ = tree_flatten(params)
    m_leaves, _ = tree_flatten(state.m)
    v_leaves, _ = tree_flatten(state.v)
    if not len(leaves) == len(m_leaves) == len(v_leaves) == len(grads):
        raise ValueError("params, moments and gradients differ in leaves")
    mesh = leaves[0].sharding.mesh
    devs = mesh.devices.ravel()
    squares: list = [None] * mesh.size
    for st, g in zip(leaves, grads):
        for group in st.holders():
            p = group[0]
            with on_device(devs[p]), at_position(p):
                part = torch.sum(torch.square(g[p].float()))
                squares[p] = part if squares[p] is None else squares[p] + part
    for p in range(mesh.size):
        if squares[p] is None:
            with on_device(devs[p]), at_position(p):
                squares[p] = torch.zeros((), dtype=torch.float32,
                                         device=devs[p])
    total = psum(squares, mesh, mesh.axis_names)
    sharded_step = isinstance(state.step, ShardedTensor)
    steps, norms, seen = [], [], set()
    for p in range(mesh.size):
        with on_device(devs[p]), at_position(p):
            gnorm = torch.sqrt(total[p])
            scale = clip_scale(gnorm, clip_norm)
            step = (state.step.shards[p] if sharded_step else state.step) + 1
            bc = bias_corrections(step, b1, b2)
            for st, mt, vt, g in zip(leaves, m_leaves, v_leaves, grads):
                trio = (st.shards[p], mt.shards[p], vt.shards[p])
                keys = [_alias(t) for t in trio]
                done = [k in seen for k in keys]
                if all(done):
                    continue
                if any(done):
                    raise ValueError("a shard shares storage with another "
                                     "position's and its moments do not (or "
                                     "the other way round)")
                seen.update(keys)
                adamw_leaf(*trio, g[p], scale, *bc, lr=lr, b1=b1, b2=b2,
                           eps=eps, weight_decay=weight_decay)
        steps.append(step)
        norms.append(gnorm)
    step = ShardedTensor(state.step.sharding, (), tuple(steps)) \
        if sharded_step else steps[0]
    return params, AdamWState(step, state.m, state.v), norms[0]
