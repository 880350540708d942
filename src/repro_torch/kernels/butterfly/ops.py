"""Wrappers around K1 that the executor's ``pallas`` tier calls.

``butterfly_count_pallas_windows`` keeps the reference's name, so the tier
maps one to one: a ``[B, n_i, n_j]`` stack of same-capacity biadjacencies
(one chunk of an executor bucket) is counted with a single launch of K1.
The wrapper orients every window so the smaller side is the Gram side,
clamps the tile to the matrix and sums each window's partials.
"""
from __future__ import annotations

import torch

from ...core.butterfly import build_biadjacency
from .butterfly_kernel import butterfly_pairs_windows_kernel_call

__all__ = ["butterfly_count_pallas_windows", "clamp_block_i", "oriented",
           "oriented_biadjacency"]


def clamp_block_i(block_i: int, n: int) -> int:
    """The tile edge K1 runs at for an ``n``-row Gram side: ``block_i``
    clamped toward ``n`` rounded up to 8, as the reference clamps."""
    return min(block_i, max(8, -(-n // 8) * 8))


def oriented(adjs: torch.Tensor) -> torch.Tensor:
    """The stack K1 reads: ``adjs`` as contiguous float32 with the smaller
    side (the Gram side) as rows.  Every window of a bucket shares its
    capacity, so the transpose decision the per-window reference makes
    applies stack-wide; a transposed stack is copied."""
    a = adjs.transpose(1, 2) if adjs.shape[1] > adjs.shape[2] else adjs
    return a.to(torch.float32).contiguous()


def oriented_biadjacency(edge_i: torch.Tensor, edge_j: torch.Tensor,
                         valid: torch.Tensor, n_i: int,
                         n_j: int) -> torch.Tensor:
    """Lanes ``[c, cap_e]`` -> the stack :func:`oriented` would make of
    their ``[c, n_i, n_j]`` biadjacencies, built oriented by the scatter
    itself: a strided transpose copy of a large stack costs a sizeable
    share of K1's own time."""
    if n_i > n_j:
        return build_biadjacency(edge_j, edge_i, valid, n_j, n_i)
    return build_biadjacency(edge_i, edge_j, valid, n_i, n_j)


def butterfly_count_pallas_windows(adjs: torch.Tensor, *,
                                   block_i: int = 256) -> torch.Tensor:
    """Count a ``[B, n_i, n_j]`` stack of 0/1 biadjacencies -> ``[B]``
    float32 counts with ONE launch of K1 on the :func:`oriented` stack, at
    the tile clamped to its Gram side.  Any dtype is cast to float32 (as the
    reference kernel casts).  No padding: K1 masks the ragged edge.
    """
    a = oriented(adjs)
    partials = butterfly_pairs_windows_kernel_call(
        a, block_i=clamp_block_i(block_i, a.shape[1]))
    return partials.sum(dim=1)
