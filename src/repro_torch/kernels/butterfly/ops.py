"""Wrappers around K1, K2 and K3 that the executor's ``pallas`` tier and
the single-matrix entries call.

``butterfly_count_pallas_windows`` and its multiset twin keep the
reference's names, so the tier maps one to one: a ``[B, n_i, n_j]`` stack
of same-capacity biadjacencies (one chunk of an executor bucket) is counted
with a single launch of K1 (K2 for net multiplicities).  The wrappers orient
every window so the smaller side is the Gram side, clamp the tile to the
matrix and reduce each window's partials with :func:`window_sums`.  The
pallas tier's multiset path hands K2 its lanes' uint8 limb planes
(:func:`butterfly_count_pallas_windows_multiset_lanes`), built by the
scatter, not a float32 stack.
``butterfly_count_pallas`` and ``butterfly_count_tiles`` count one matrix
through K3.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.butterfly import build_biadjacency, build_biadjacency_limbs
from ...device import resolve_device
from .butterfly_kernel import (
    butterfly_pairs_kernel_call,
    butterfly_pairs_windows_kernel_call,
    butterfly_pairs_windows_kernel_multiset_call,
    butterfly_pairs_windows_multiset_limbs_call,
    check_no_wrap,
    stack_limbs,
)

__all__ = ["butterfly_count_pallas", "butterfly_count_pallas_batched",
           "butterfly_count_pallas_windows",
           "butterfly_count_pallas_windows_multiset",
           "butterfly_count_pallas_windows_multiset_lanes",
           "butterfly_count_pallas_windows_multiset_limbs",
           "butterfly_count_tiles", "clamp_block_i", "oriented",
           "oriented_biadjacency", "oriented_biadjacency_limbs",
           "window_sums"]


def clamp_block_i(block_i: int, n: int) -> int:
    """The tile edge the kernels run at for an ``n``-row Gram side:
    ``block_i`` clamped toward ``n`` rounded up to 8, as the reference
    clamps."""
    return min(block_i, max(8, -(-n // 8) * 8))


def oriented(adjs: torch.Tensor) -> torch.Tensor:
    """The stack the kernels read: ``adjs`` (``[B, n_i, n_j]``, or one
    ``[n_i, n_j]`` matrix) as a contiguous stack with the smaller side (the
    Gram side) as rows, in uint8 if it is uint8 (K1's 0/1 stacks) and in
    float32 otherwise.  Every window of a bucket shares its capacity, so
    the transpose decision the per-window reference makes applies
    stack-wide; a transposed stack is copied."""
    a = adjs.transpose(-2, -1) if adjs.shape[-2] > adjs.shape[-1] else adjs
    dtype = torch.uint8 if a.dtype == torch.uint8 else torch.float32
    return a.to(dtype).contiguous()


def oriented_biadjacency(edge_i: torch.Tensor, edge_j: torch.Tensor,
                         valid: torch.Tensor, n_i: int,
                         n_j: int) -> torch.Tensor:
    """Lanes ``[c, cap_e]`` -> the uint8 stack :func:`oriented` would make
    of their ``[c, n_i, n_j]`` biadjacencies, built oriented by the scatter
    itself: a strided transpose copy of a large stack costs a sizeable
    share of K1's own time.  uint8 is what K1 reads; with the executor's
    capacities (multiples of ``snap`` or of 64) its rows are a multiple of
    16 bytes, so K1 reads it through TMA as it lies."""
    if n_i > n_j:
        return build_biadjacency(edge_j, edge_i, valid, n_j, n_i,
                                 dtype=torch.uint8)
    return build_biadjacency(edge_i, edge_j, valid, n_i, n_j,
                             dtype=torch.uint8)


def oriented_biadjacency_limbs(edge_i: torch.Tensor, edge_j: torch.Tensor,
                               mult: torch.Tensor, valid: torch.Tensor,
                               n_i: int, n_j: int, lw: int, ls: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multiset twin of :func:`oriented_biadjacency`: the uint8 limb planes
    ``[c, lw + ls, n_g, k]`` of the lanes' net multiplicities that K2
    reads, and their block masks, oriented by the scatter
    (``core.butterfly.build_biadjacency_limbs``; the multiset identity is
    symmetric in the sides)."""
    if n_i > n_j:
        return build_biadjacency_limbs(edge_j, edge_i, mult, valid, n_j, n_i,
                                       lw, ls)
    return build_biadjacency_limbs(edge_i, edge_j, mult, valid, n_i, n_j,
                                   lw, ls)


def window_sums(partials: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` float32 partials -> ``[B]`` float32 window counts: the
    float32 rounding of each row's exact sum.

    A window's count must not depend on how many windows share its launch
    (streaming at any micro-batch equals replay bit for bit), but the order
    of a float32 reduction over a ``[B, T]`` tensor depends on ``B`` on
    the card.  The partials are float32 multiples of 0.5 (``w^2 - s`` and
    ``w(w-1)`` are integers in any rounding), so their float64 sum is exact
    in any order while it stays below 2**51 in magnitude; rounding it once
    gives the same bits for every ``B``, on the card and on the CPU."""
    return partials.to(torch.float64).sum(dim=-1).to(torch.float32)


def butterfly_count_pallas_windows(adjs: torch.Tensor, *,
                                   block_i: int = 256) -> torch.Tensor:
    """Count a ``[B, n_i, n_j]`` stack of 0/1 biadjacencies -> ``[B]``
    float32 counts with ONE launch of K1 on the :func:`oriented` stack, at
    the tile clamped to its Gram side.  A uint8 stack stays uint8; any other
    dtype is cast to float32 (as the reference kernel casts), which K1
    reads through one uint8 copy.  No padding to the tile: K1 masks the
    ragged edge.  A ``meta`` stack (the dry-run's) gives ``[B]`` float32 on
    ``meta``, with nothing launched or allocated.
    """
    a = oriented(adjs)
    partials = butterfly_pairs_windows_kernel_call(
        a, block_i=clamp_block_i(block_i, a.shape[1]))
    return window_sums(partials)


def butterfly_count_pallas_windows_multiset(adjs: torch.Tensor, *,
                                            block_i: int = 256
                                            ) -> torch.Tensor:
    """Multiset twin of :func:`butterfly_count_pallas_windows`: a
    ``[B, n_i, n_j]`` stack of weighted biadjacencies (entries = net edge
    multiplicities, non-negative integers) -> ``[B]`` float32 counts with
    ONE launch of K2 on the stack's limb split (any dtype is cast to
    float32 first)."""
    a = oriented(adjs).to(torch.float32)
    partials = butterfly_pairs_windows_kernel_multiset_call(
        a, block_i=clamp_block_i(block_i, a.shape[1]))
    return window_sums(partials)


def butterfly_count_pallas_windows_multiset_limbs(planes: torch.Tensor,
                                                  masks: torch.Tensor, *,
                                                  lw: int,
                                                  block_i: int = 256
                                                  ) -> torch.Tensor:
    """``[B, lw + ls, n_g, k]`` oriented limb planes and their block masks
    -> ``[B]`` float32 counts with ONE launch of K2, at the tile clamped to
    the Gram side."""
    partials = butterfly_pairs_windows_multiset_limbs_call(
        planes, masks, lw=lw, block_i=clamp_block_i(block_i, planes.shape[2]))
    return window_sums(partials)


def butterfly_count_pallas_windows_multiset_lanes(
        edge_i: torch.Tensor, edge_j: torch.Tensor, mult: torch.Tensor,
        valid: torch.Tensor, n_i: int, n_j: int, *, max_mult: int,
        max_vertex_sq: int, block_i: int = 256) -> torch.Tensor:
    """The pallas tier's multiset count: lanes ``[c, cap_e]`` of distinct
    (edge, multiplicity) pairs per window -> ``[c]`` float32 counts.
    ``max_mult`` (the largest multiplicity) and ``max_vertex_sq`` (the
    largest sum of squared multiplicities at one vertex) are the caller's
    bounds, known on the host, so nothing here waits for the device:
    ``max_vertex_sq`` is held to :func:`check_no_wrap`, ``max_mult`` sizes
    the limb planes, and the scatter marks which 64-row blocks of each
    plane hold a nonzero byte, so K2 runs only the limb products each tile
    needs."""
    check_no_wrap(max_vertex_sq)
    lw, ls = stack_limbs(max_mult)
    planes, masks = oriented_biadjacency_limbs(edge_i, edge_j, mult, valid,
                                               n_i, n_j, lw, ls)
    return butterfly_count_pallas_windows_multiset_limbs(
        planes, masks, lw=lw, block_i=block_i)


def butterfly_count_pallas_batched(adjs: torch.Tensor, *,
                                   block_i: int = 256) -> torch.Tensor:
    """The reference's historical stacked entry: an alias of
    :func:`butterfly_count_pallas_windows`."""
    return butterfly_count_pallas_windows(adjs, block_i=block_i)


def butterfly_count_pallas(adj: torch.Tensor, *,
                           block_i: int = 256) -> torch.Tensor:
    """Butterfly count of one dense 0/1 biadjacency ``[n_i, n_j]`` -> a
    0-d float32 tensor, through K3 (K1's kernel at ``B = 1``) at the tile
    clamped to the oriented matrix."""
    a = oriented(adj)
    partials = butterfly_pairs_kernel_call(
        a, block_i=clamp_block_i(block_i, a.shape[0]))
    return window_sums(partials)


def butterfly_count_tiles(adj, *, block_i: int = 256, device=None) -> float:
    """Host entry: K3's partials at the unclamped ``block_i``, reduced in
    float64 on the host (each partial is exact below 2**24; the float64 sum
    adds no error).  ``adj`` is a tensor, counted on its own device, or an
    array, counted on ``device`` (``cuda`` unless the caller names
    another)."""
    if not isinstance(adj, torch.Tensor):
        adj = torch.as_tensor(np.asarray(adj), device=resolve_device(device))
    partials = butterfly_pairs_kernel_call(oriented(adj), block_i=block_i)
    return float(partials.cpu().to(torch.float64).sum())
