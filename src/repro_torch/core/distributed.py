"""Distributed exact butterfly counting: the Gram-sharded ring counter.

The port of ``repro.core.distributed``.  A window's biadjacency rows
(i-vertices) are split into row-blocks over a mesh axis ("model"); each
device builds only its own block and the blocks circulate through the ring
of :func:`repro_torch.distributed.collectives.ring_pair_count`, so every
``(u, v)`` block pair is counted exactly once and no device holds the whole
Gram.  :func:`make_distributed_window_counter` adds the window axis: the
windows split over "data" (over ("pod", "data") on a multi-pod mesh), each
window's Gram over "model".  It covers
windows whose Gram is too large for one device.

The block-pair product is a full-float32 ``torch.matmul``
(:func:`repro_torch.core.butterfly.full_fp32_matmul`), as the reference
computes it outside any kernel; counts are exact while each device's
partial sums stay below 2**24.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import on_device
from ..distributed.collectives import ring_pair_count
from ..distributed.observe import at_position, note_move
from ..launch.mesh import Mesh
from .butterfly import build_biadjacency, full_fp32_matmul

__all__ = ["distributed_count_dense", "make_distributed_window_counter"]


def _pair_partial(mine: torch.Tensor, theirs: torch.Tensor, my_idx: int,
                  their_idx: int, symmetric: bool,
                  block_rows: int) -> torch.Tensor:
    """Butterfly partial of row-blocks ``mine`` (block ``my_idx``) and
    ``theirs`` (block ``their_idx``), ``[..., rows, n_j]`` each -> ``[...]``
    float32: ``sum C(w, 2)`` over the kept entries of ``w = mine
    theirs^T``.

    Full ring (``symmetric=False``): keep global row < global column, so
    each unordered pair, visited twice, counts once.  Half ring
    (``symmetric=True``): each block pair is visited once, so a cross pair
    keeps every entry and the diagonal block its strict upper triangle."""
    with full_fp32_matmul():
        w = torch.matmul(mine.to(torch.float32),
                         theirs.to(torch.float32).transpose(-2, -1))
    pairs = w * (w - 1.0) * 0.5
    if symmetric and my_idx != their_idx:
        return pairs.sum(dim=(-2, -1))
    dev = mine.device
    rows = my_idx * block_rows + torch.arange(mine.shape[-2], device=dev)
    cols = their_idx * block_rows + torch.arange(theirs.shape[-2], device=dev)
    keep = rows[:, None] < cols[None, :]
    return torch.where(keep, pairs, torch.zeros((), device=dev)).sum(
        dim=(-2, -1))


def distributed_count_dense(adj: torch.Tensor, mesh: Mesh,
                            axis: str = "model", *, half_ring: bool = True,
                            wire_dtype: torch.dtype | None = torch.int8
                            ) -> torch.Tensor:
    """Exact butterfly count of one dense biadjacency ``[n_i, n_j]``, its
    rows split over ``axis`` (``n_i`` must divide by the axis size; pad
    upstream).  Returns a 0-d float32 tensor on the first device of the
    axis.  ``half_ring`` and the int8 wire are the reference's
    optimizations; ``half_ring=False, wire_dtype=None`` is the
    paper-faithful schedule."""
    devs = mesh.axis_devices(axis)
    n_i = adj.shape[0]
    if n_i % len(devs):
        raise ValueError(f"n_i={n_i} not divisible by {axis} size "
                         f"{len(devs)}")
    block_rows = n_i // len(devs)
    blocks = [blk.to(d) for blk, d in zip(adj.split(block_rows), devs)]
    return ring_pair_count(
        blocks, devs, functools.partial(_pair_partial, block_rows=block_rows),
        half_ring=half_ring, wire_dtype=wire_dtype,
        positions=mesh.axis_positions(axis))


def make_distributed_window_counter(n_i: int, n_j: int, mesh: Mesh, *,
                                    window_axis: str | tuple = "data",
                                    gram_axis: str = "model",
                                    half_ring: bool = True,
                                    wire_dtype: torch.dtype | None = torch.int8):
    """Per-window exact counts with the windows split over ``window_axis``
    and each window's Gram over ``gram_axis``.

    ``window_axis`` is one axis name or a tuple of them (``("pod",
    "data")`` on a multi-pod mesh): the windows split over the product of
    those axes, the first axis major, the order in which the reference's
    ``shard_map`` splits them over ``P(window_axis)``
    (``Mesh.shard_devices``).  The returned function takes ``(edge_i,
    edge_j, valid)`` ``[n_windows, capacity]`` lanes (numpy or tensors;
    ``n_windows`` must divide by the window axes' size) and returns
    ``[n_windows]`` float32 counts on the mesh's first device.  Each
    position scatters only its own row-block of each window
    (``build_biadjacency`` on the lanes shifted to the block's first row),
    inside ``observe.at_position``; each window's count is then gathered
    to the first position (reported as an ``all-gather`` from any other).  Every row of
    the window axes queues all its windows before anything is read back,
    so distinct cards work concurrently."""
    window_axes = (window_axis,) if isinstance(window_axis, str) \
        else tuple(window_axis)
    row_sizes = tuple(mesh.shape[a] for a in window_axes)
    n_rows = math.prod(row_sizes)
    n_dev = mesh.shape[gram_axis]
    block_rows = -(-n_i // n_dev)
    pair = functools.partial(_pair_partial, block_rows=block_rows)
    home = mesh.devices.flat[0]

    def count(edge_i, edge_j, valid) -> torch.Tensor:
        lanes = [torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x for x in (edge_i, edge_j, valid)]
        n_win = lanes[0].shape[0]
        if n_win % n_rows:
            raise ValueError(f"{n_win} windows not divisible by "
                             f"{window_axis} size {n_rows}")
        per = n_win // n_rows
        out = []
        for d in range(n_rows):
            at = dict(zip(window_axes, np.unravel_index(d, row_sizes)))
            devs = mesh.axis_devices(gram_axis, **at)
            pos = mesh.axis_positions(gram_axis, **at)
            held = [tuple(x[d * per:(d + 1) * per].to(dev) for x in lanes)
                    for dev in devs]
            for w in range(per):
                blocks = []
                for m, (dev, (ei, ej, v)) in enumerate(zip(devs, held)):
                    # rows of other blocks fall outside [0, block_rows): the
                    # scatter drops them
                    with on_device(dev), at_position(pos[m]):
                        blocks.append(build_biadjacency(
                            ei[w].long() - m * block_rows, ej[w], v[w],
                            block_rows, n_j))
                total = ring_pair_count(blocks, devs, pair,
                                        half_ring=half_ring,
                                        wire_dtype=wire_dtype, positions=pos)
                if pos[0]:
                    note_move("all-gather", pos[0], 0, total.nbytes)
                out.append(total.to(home))
        if not out:
            return torch.zeros(0, dtype=torch.float32, device=home)
        return torch.stack(out)

    return count
