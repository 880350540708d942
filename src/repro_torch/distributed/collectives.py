"""Collectives of the port over a list of devices in one process.

``ring_pair_count`` is the blocked-Gram ring of the distributed butterfly
counter (``repro.distributed.collectives.ring_pair_count``).  The
reference runs it inside ``shard_map``: every device holds one row-block
of a biadjacency, the blocks circulate by ``collective_permute`` and a
``psum`` adds the devices' partials.  The port runs the same schedule in one
process over a list of devices: each step moves every block to the next
device (``.to(device, non_blocking=True)``; a no-op where the next device is
the same one) and queues each device's partial on that device, so distinct
cards work concurrently; the final sum on the first device stands for the
``psum``.  :func:`all_to_all` is ``lax.all_to_all`` (``split_axis=0``,
``concat_axis=0``) over such a list, the halo exchange's collective.  The
reference's gradient compression (``compress_grads``,
``decompress_grads``, ``psum_mean_compressed``) is not ported yet (ROADMAP
Queue 1 item 3).
"""
from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

from ..device import on_device

__all__ = ["all_to_all", "ring_pair_count"]


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


def all_to_all(sends: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """``sends[o]`` ``[n, ...]`` lies on ``devices[o]``; device ``d``
    receives ``sends[o][d]`` from each ``o``, moved with
    ``.to(devices[d])`` (a no-op where both are one device), stacked in
    device order: ``[n, ...]`` on ``devices[d]``.  Autograd flows through
    the moves."""
    n = len(sends)
    if len(devices) != n or any(s.shape[0] != n for s in sends):
        raise ValueError(f"{n} sends of leading dim {[s.shape[0] for s in sends]} "
                         f"over {len(devices)} devices")
    return [torch.stack([sends[o][d].to(devices[d], non_blocking=True)
                         for o in range(n)]) for d in range(n)]
