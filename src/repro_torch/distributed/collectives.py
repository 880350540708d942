"""The blocked-Gram ring of the distributed butterfly counter.

The port's counterpart of ``repro.distributed.collectives.ring_pair_count``.
The reference runs it inside ``shard_map``: every device holds one row-block
of a biadjacency, the blocks circulate by ``collective_permute`` and a
``psum`` adds the devices' partials.  The port runs the same schedule in one
process over a list of devices: each step moves every block to the next
device (``.to(device, non_blocking=True)``; a no-op where the next device is
the same one) and queues each device's partial on that device, so distinct
cards work concurrently; the final sum on the first device stands for the
``psum``.  The reference's gradient compression (``compress_grads``,
``decompress_grads``, ``psum_mean_compressed``) belongs to training, which
the port does not have yet.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

from ..device import on_device

__all__ = ["ring_pair_count"]


def ring_pair_count(blocks: Sequence[torch.Tensor],
                    devices: Sequence[torch.device], pair_fn: Callable,
                    *, half_ring: bool = False,
                    wire_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Blocked-Gram ring over ``devices``: ``blocks[k]`` is device k's
    row-block (on ``devices[k]``).  At step ``s`` device ``me`` holds the
    block of ``their = (me - s) % n`` and adds ``pair_fn(mine, theirs, me,
    their, symmetric)``; the devices' totals are summed on ``devices[0]``
    in device order.

    ``half_ring=True`` visits each unordered block pair once: ``n // 2 +
    1`` steps, and at even ``n`` the antipodal pair (step ``n / 2``) is
    counted only by its lower index.  ``wire_dtype`` (int8 for 0/1 blocks)
    is the dtype the blocks travel in; each partial is computed in the
    block's own dtype."""
    n = len(blocks)
    if n == 0 or len(devices) != n:
        raise ValueError(f"{n} blocks need as many devices, got "
                         f"{len(devices)}")
    steps = n // 2 + 1 if half_ring else n
    wire = [b if wire_dtype is None else b.to(wire_dtype) for b in blocks]
    totals: list[torch.Tensor | None] = [None] * n
    for s in range(steps):
        if s:
            # the collective permute: device i receives device i - 1's block
            wire = [wire[(i - 1) % n].to(devices[i], non_blocking=True)
                    for i in range(n)]
        for me in range(n):
            their = (me - s) % n
            if half_ring and not (s < (n + 1) // 2 or me < their):
                continue
            with on_device(devices[me]):
                part = pair_fn(blocks[me], wire[me].to(blocks[me].dtype), me,
                               their, half_ring)
                totals[me] = part if totals[me] is None else totals[me] + part
    home = devices[0]
    total = totals[0]
    for t in totals[1:]:
        total = total + t.to(home)
    return total
