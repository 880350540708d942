"""Shared model-building blocks: the generator splitter, the dense
initializer, norms, MLPs and losses (the port of ``repro.models.common``),
in the reference's float32 arithmetic; and what the GNN and recsys models
share beyond it: the device their parameters are drawn on (``meta`` for
shapes alone), stacking per-layer trees on ``[L]``, and carrying the
reference's parameter trees across."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..arrays import tensor_from_numpy, tensor_to_numpy
from ..device import resolve_device
from ..train.checkpoint import tree_flatten, tree_map, tree_unflatten

__all__ = ["Split", "dense_init", "rms_norm", "layer_norm", "mlp_init",
           "mlp_apply", "cross_entropy", "token_nll", "bce_terms",
           "bce_with_logits", "param_device", "seeded_split", "stack_layers",
           "layer_slices", "params_from_reference", "params_to_reference"]


class Split:
    """Deterministic generator splitter over an explicit
    :class:`torch.Generator`: ``Split(gen)()`` yields a fresh generator on
    ``gen``'s device, seeded from ``gen``'s stream, so each draw is
    independent of how many numbers the others take."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def __call__(self) -> torch.Generator:
        seed = int(torch.randint(0, 2**62, (1,), generator=self.gen,
                                 device=self.gen.device))
        return torch.Generator(device=self.gen.device).manual_seed(seed)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: float | None = None,
               dtype: torch.dtype = torch.float32,
               device: torch.device | None = None) -> torch.Tensor:
    """``[d_in, d_out]`` standard normals times ``scale`` (default
    ``1/sqrt(d_in)``), drawn in float32 on ``device`` (default ``gen``'s)
    and cast to ``dtype``."""
    s = scale if scale is not None else 1.0 / d_in ** 0.5
    w = torch.randn((d_in, d_out), generator=gen,
                    device=gen.device if device is None else device)
    return (w * s).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm over the last axis in float32; output in ``x.dtype``."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Layer norm over the last axis in float32 (biased variance);
    output in ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def mlp_init(gen: torch.Generator, dims: list[int], *,
             dtype: torch.dtype = torch.float32,
             device: torch.device | None = None) -> dict:
    """``{"w": [dense_init(d_in, d_out)], "b": [zeros(d_out)]}`` for each
    consecutive pair of ``dims``, on ``device`` (default ``gen``'s)."""
    ks = Split(gen)
    dev = gen.device if device is None else device
    return {
        "w": [dense_init(ks(), a, b, dtype=dtype, device=dev)
              for a, b in zip(dims[:-1], dims[1:])],
        "b": [torch.zeros((b,), dtype=dtype, device=dev) for b in dims[1:]],
    }


def mlp_apply(p: dict, x: torch.Tensor, *, act=F.silu,
              final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` per layer, ``act`` between layers (and after the last
    with ``final_act``)."""
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    return x


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-level cross entropy in float32: logits ``[..., V]``, integer
    labels ``[...]``; the mean over tokens, or with ``mask`` the
    mask-weighted sum over ``max(sum(mask), 1)``."""
    nll = token_nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's negative log-likelihood in float32: ``logsumexp`` of
    its logits less its label's logit."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    return lse - torch.gather(lg, -1, labels.long()[..., None])[..., 0]


def bce_terms(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on logits in float32, elementwise, in the
    stable form ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    lg = logits.float()
    t = targets.float()
    return (torch.clamp_min(lg, 0) - lg * t
            + torch.log1p(torch.exp(-torch.abs(lg))))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """The mean of :func:`bce_terms`."""
    return torch.mean(bce_terms(logits, targets))


# -- the GNN and recsys models' parameter trees --------------------------------

def param_device(device) -> torch.device:
    """The device an ``init_*`` draws its parameters on:
    ``resolve_device(device)`` (the card by default), or ``meta``, which
    allocates nothing and gives the trees' shapes and dtypes alone."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def seeded_split(seed: int, device: torch.device) -> Split:
    """A :class:`Split` over a generator seeded with ``seed`` on ``device``
    (on the CPU for ``meta``, whose draws take no numbers)."""
    gen_dev = torch.device("cpu") if device.type == "meta" else device
    return Split(torch.Generator(device=gen_dev).manual_seed(seed))


def stack_layers(layers: list):
    """Per-layer trees of one structure -> one tree whose leaves are the
    layers' leaves stacked on a leading ``[L]`` axis (the reference's
    ``jax.tree.map(lambda *xs: jnp.stack(xs), *layers)``)."""
    flat = [tree_flatten(t) for t in layers]
    treedef = flat[0][1]
    return tree_unflatten(treedef, [torch.stack(xs) for xs in
                                    zip(*(leaves for leaves, _ in flat))])


def layer_slices(tree) -> list:
    """The inverse of :func:`stack_layers`: one tree per index of the
    leaves' leading ``[L]`` axis, each leaf a view (gradients reach the
    stacked leaves)."""
    leaves, treedef = tree_flatten(tree)
    return [tree_unflatten(treedef, [x[i] for x in leaves])
            for i in range(leaves[0].shape[0])]


def params_from_reference(tree, device=None):
    """The reference's parameter tree (dicts and lists of numpy arrays,
    layer leaves stacked on ``[L]``) as the same tree of tensors on
    ``device`` (default the card): how the GNN and recsys models take the
    reference's weights."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(np.asarray(a), dev), tree)


def params_to_reference(tree):
    """The inverse of :func:`params_from_reference`: a tree of tensors as
    the same tree of host numpy arrays (:func:`tensor_to_numpy`)."""
    return tree_map(tensor_to_numpy, tree)
