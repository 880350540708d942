"""Carry the reference's parameter pytree across into the port."""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from .config import LMConfig
from .model import TransformerLM, layer_keys

__all__ = ["params_from_reference", "tensor_from_numpy"]


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``.  A bfloat16 array (``ml_dtypes.bfloat16``, what
    ``np.asarray`` gives for a JAX bf16 array) is refused by
    ``torch.from_numpy``, so its bits travel as uint16."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


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
