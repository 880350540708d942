"""Train-step factory with gradient-accumulation microbatching (the port of
``repro.train.loop``).

``make_train_step(loss_fn, n_microbatches)`` returns ``step(state, batch)
-> (state, metrics)``.  The global batch is split into ``[n_micro, micro,
...]`` and the microbatches run one after another; their gradients
accumulate in float32.  The step updates the parameters and the moments in
place, which stands for the reference's donation of the state.
"""
from __future__ import annotations

from typing import Callable

import torch

from .optimizer import adamw_update, param_leaves
from .train_state import TrainState

__all__ = ["make_train_step"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _value_and_grad(loss_fn: Callable, params, batch, leaves: dict
                    ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves.values(), grads)]


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
        return _tree_map(rs, batch)

    def step(state: TrainState, batch):
        params = state.params
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
                mb = _tree_map(lambda x: x[i], micro)
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

    return step
