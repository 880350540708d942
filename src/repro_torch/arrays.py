"""Tensors to and from host numpy arrays, bfloat16 included.

numpy has no bfloat16: a bf16 tensor leaves as a 2-byte ``V2`` array of its
bits (:func:`tensor_to_numpy`), the dtype that ``np.load`` gives for the
bf16 leaves the reference's checkpoints store, and comes back from one
(:func:`tensor_from_numpy`); ``.view(ml_dtypes.bfloat16)`` reads it as
numbers where ``ml_dtypes`` is installed."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BF16_BITS", "tensor_from_numpy", "tensor_to_numpy"]

BF16_BITS = np.dtype("V2")


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``.  A bfloat16 array (``ml_dtypes.bfloat16``, what
    ``np.asarray`` gives for a JAX bf16 array) and a ``V2`` array of bf16
    bits are refused by ``torch.from_numpy``, so their bits travel as
    uint16."""
    a = np.asarray(a)
    a = np.ascontiguousarray(a).reshape(a.shape)   # keeps a 0-d array 0-d
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BITS:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 as a ``V2`` array of its
    bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()
