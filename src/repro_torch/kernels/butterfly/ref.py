"""Plain torch oracle for one biadjacency's butterfly count.

B = sum_{u<v} C(W_uv, 2),  W = A @ A.T  over the i-side of the biadjacency.
K1 computes the same quantity without materializing W.
"""
from __future__ import annotations

import torch

__all__ = ["butterfly_count_ref"]


def butterfly_count_ref(adj: torch.Tensor) -> torch.Tensor:
    """adj: [n_i, n_j] 0/1 (any float/int dtype).  Returns scalar float32."""
    a = adj.to(torch.float32)
    w = a @ a.T
    pairs = w * (w - 1.0) * 0.5
    total = pairs.sum() - torch.diagonal(pairs).sum()
    return (total * 0.5).to(torch.float32)
