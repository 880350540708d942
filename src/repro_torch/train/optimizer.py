"""AdamW with global-norm clipping (the port of ``repro.train.optimizer``,
by hand: ``torch.optim`` rounds differently).

The optimizer state mirrors the parameters leaf by leaf: the float32 first
and second moments, keyed by each leaf's name (:func:`param_leaves`).  The
update runs leaf by leaf, in place under ``torch.no_grad()``, so a model
of billions of parameters holds no second copy of its parameters or
moments, only one leaf's float32 temporaries at a time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "leaves_as_tree", "param_leaves"]


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
    scale = torch.clamp(clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t
    for name, p in leaves.items():
        m, v = state.m[name], state.v[name]
        g = grads[name].float() * scale
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
    return params, AdamWState(step, state.m, state.v), gnorm
