"""Carry the reference's parameter pytree across into the port and back.

Leaves cross as host numpy arrays, bf16 as the ``V2`` array of its bits
(:mod:`repro_torch.arrays`)."""
from __future__ import annotations

import numpy as np
import torch

from ...arrays import tensor_from_numpy, tensor_to_numpy
from ...device import resolve_device
from .config import LMConfig
from .model import TransformerLM, layer_keys
from .moe import MOE_KEYS

__all__ = ["named_to_reference", "params_from_reference",
           "params_to_reference", "reference_to_named"]


def params_from_reference(tree: dict, cfg: LMConfig, device=None) -> TransformerLM:
    """The reference's ``init_lm_params`` pytree -- ``embed``, ``head``,
    ``ln_f`` and ``layers`` with each leaf stacked on a leading ``[L]`` axis
    (an MoE layer's ``moe`` subtree likewise), as numpy arrays -- as a
    :class:`TransformerLM` on ``device``."""
    dev = resolve_device(device)

    def layer(tree: dict, i: int) -> dict:
        return {name: layer(leaf, i) if isinstance(leaf, dict)
                else tensor_from_numpy(np.asarray(leaf)[i], dev)
                for name, leaf in tree.items()}

    layers = tree["layers"]
    per_layer = [layer({name: layers[name] for name in layer_keys(cfg)}, i)
                 for i in range(cfg.n_layers)]
    return TransformerLM(cfg, tensor_from_numpy(tree["embed"], dev),
                         tensor_from_numpy(tree["head"], dev),
                         tensor_from_numpy(tree["ln_f"], dev), per_layer)


def named_to_reference(named: dict, cfg: LMConfig) -> dict:
    """Tensors keyed as a :class:`TransformerLM`'s ``named_parameters()``
    (``embed``, ``head``, ``ln_f``, ``layers.<i>.<name>``,
    ``layers.<i>.moe.<name>``) -> the reference's tree of numpy leaves
    (:func:`tensor_to_numpy`), each layer leaf stacked on ``[L]``."""
    def stack(suffix: str) -> np.ndarray:
        return tensor_to_numpy(torch.stack(
            [named[f"layers.{i}.{suffix}"] for i in range(cfg.n_layers)]))

    layers = {}
    for name in layer_keys(cfg):
        if name == "moe":
            layers["moe"] = {k: stack(f"moe.{k}") for k in MOE_KEYS}
        else:
            layers[name] = stack(name)
    return {"embed": tensor_to_numpy(named["embed"]),
            "head": tensor_to_numpy(named["head"]),
            "ln_f": tensor_to_numpy(named["ln_f"]), "layers": layers}


def reference_to_named(tree: dict, cfg: LMConfig, device=None) -> dict:
    """The inverse of :func:`named_to_reference`: the reference's tree
    (numpy leaves or tensors, layers stacked on ``[L]``) -> tensors on
    ``device`` keyed as ``named_parameters()``."""
    dev = resolve_device(device)

    def put(a) -> torch.Tensor:
        return a.to(dev) if isinstance(a, torch.Tensor) else tensor_from_numpy(a, dev)

    out = {name: put(tree[name]) for name in ("embed", "head", "ln_f")}
    for name in layer_keys(cfg):
        sub = {f"moe.{k}": tree["layers"]["moe"][k] for k in MOE_KEYS} \
            if name == "moe" else {name: tree["layers"][name]}
        for key, leaf in sub.items():
            t = put(leaf)
            for i in range(cfg.n_layers):
                out[f"layers.{i}.{key}"] = t[i]
    return out


def params_to_reference(params: TransformerLM) -> dict:
    """The inverse of :func:`params_from_reference`: ``params`` as the
    reference's tree of numpy leaves (:func:`tensor_to_numpy`), each layer
    leaf stacked on a leading ``[L]`` axis (an MoE layer's ``moe`` subtree
    likewise)."""
    return named_to_reference(dict(params.named_parameters()), params.cfg)
