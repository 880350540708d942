"""Halo-exchange message passing (the port of ``repro.graphs.halo``).

The gather-based GNN moves every node's features to wherever an edge needs
them.  In a partitioned layout each device owns a node block, and only
*boundary* features cross between devices, through one all-to-all a
layer:

  send   = x_local[halo_send_idx]          # [n_dev, H, F]   local gather
  recv   = all_to_all(send)                # [n_dev, H, F]   what peers sent me
  ext_x  = concat([x_local, recv.flat])    # [N_loc + n_dev*H, F]
  msgs   = ext_x[edge_src_ext]             # local gather
  agg    = segment_sum(msgs, edge_dst_loc) # local scatter

The reference runs this per device inside ``shard_map``; the port runs it
in one process over the devices of a :class:`~repro_torch.launch.mesh.Mesh`
(``distributed.collectives.all_to_all``), so :func:`halo_exchange` takes
every device's local block at once.  ``build_partitioned_batch`` is the
host-side reference partitioner (range partition), a numpy copy of the
reference's: the same layout, slot for slot.
"""
from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch

from ..distributed.collectives import all_to_all

__all__ = ["PartitionedGraph", "build_partitioned_batch", "halo_exchange"]


@dataclass
class PartitionedGraph:
    """Per-device stacked partitioned layout ([n_dev, ...] arrays)."""
    x: np.ndarray              # [n_dev, n_loc, F]
    halo_send_idx: np.ndarray  # [n_dev, n_dev, H] sender-local indices
    edge_src_ext: np.ndarray   # [n_dev, e_loc]    into [n_loc + n_dev*H]
    edge_dst_loc: np.ndarray   # [n_dev, e_loc]
    edge_mask: np.ndarray      # [n_dev, e_loc]
    labels: np.ndarray         # [n_dev, n_loc]
    label_mask: np.ndarray     # [n_dev, n_loc]
    n_loc: int
    halo: int                  # H

    def device_batch(self):
        """Layout consumed by sage_loss_halo: x flat [N, F]; per-device
        tables keep their stacked leading dim (sharded over the mesh)."""
        return {
            "x": self.x.reshape(-1, self.x.shape[-1]),
            "halo_send_idx": self.halo_send_idx,
            "edge_src_ext": self.edge_src_ext, "edge_dst_loc": self.edge_dst_loc,
            "edge_mask": self.edge_mask, "labels_2d": self.labels,
            "label_mask_2d": self.label_mask,
        }


def build_partitioned_batch(
    src: np.ndarray, dst: np.ndarray, x: np.ndarray,
    labels: np.ndarray, n_dev: int, *, halo: int | None = None,
    edge_cap: int | None = None,
) -> PartitionedGraph:
    """Host-side reference partitioner: range partition + halo construction.

    Edges land on their dst's device.  Remote sources enter the receiver's
    extended index space at  n_loc + owner*H + slot.  Overflowing halo slots
    (or edge slots) are dropped with mask=False — the budget is explicit,
    like every other capacity in this framework.
    """
    n = x.shape[0]
    n_loc = -(-n // n_dev)
    owner = np.minimum(src // n_loc, n_dev - 1), np.minimum(dst // n_loc, n_dev - 1)
    src_own, dst_own = owner
    if halo is None:
        halo = max(16, n_loc // 2 // n_dev)
    if edge_cap is None:
        edge_cap = -(-len(src) // n_dev) * 2

    x_p = np.zeros((n_dev, n_loc, x.shape[1]), x.dtype)
    lab_p = np.zeros((n_dev, n_loc), labels.dtype)
    lmask = np.zeros((n_dev, n_loc), np.float32)
    for d in range(n_dev):
        lo, hi = d * n_loc, min((d + 1) * n_loc, n)
        x_p[d, : hi - lo] = x[lo:hi]
        lab_p[d, : hi - lo] = labels[lo:hi]
        lmask[d, : hi - lo] = 1.0

    # halo slot assignment: (sender o -> receiver d) unique sources
    send_idx = np.zeros((n_dev, n_dev, halo), np.int64)
    slot_of: dict[tuple[int, int, int], int] = {}
    fill = np.zeros((n_dev, n_dev), np.int64)
    es = [[] for _ in range(n_dev)]
    ed = [[] for _ in range(n_dev)]
    for s, t, so, to in zip(src, dst, src_own, dst_own):
        d = int(to)
        dst_l = int(t - d * n_loc)
        if so == to:
            src_ext = int(s - d * n_loc)
        else:
            o = int(so)
            key = (o, d, int(s))
            if key not in slot_of:
                if fill[o, d] >= halo:
                    continue  # halo budget exhausted -> edge dropped (masked)
                slot_of[key] = int(fill[o, d])
                send_idx[o, d, fill[o, d]] = s - o * n_loc
                fill[o, d] += 1
            src_ext = n_loc + o * halo + slot_of[key]
        es[d].append(src_ext)
        ed[d].append(dst_l)

    e_src = np.zeros((n_dev, edge_cap), np.int64)
    e_dst = np.zeros((n_dev, edge_cap), np.int64)
    e_mask = np.zeros((n_dev, edge_cap), bool)
    for d in range(n_dev):
        m = min(len(es[d]), edge_cap)
        e_src[d, :m] = es[d][:m]
        e_dst[d, :m] = ed[d][:m]
        e_mask[d, :m] = True

    return PartitionedGraph(x_p, send_idx, e_src, e_dst, e_mask, lab_p, lmask,
                            n_loc, halo)


def halo_exchange(x_locals: Sequence[torch.Tensor],
                  halo_send_idx: Sequence[torch.Tensor],
                  devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """Exchange halo rows between the devices' node blocks: ``x_locals[d]``
    ``[n_loc, F]`` and ``halo_send_idx[d]`` ``[n_dev, H]`` lie on
    ``devices[d]``.  Returns each device's extended feature array
    ``[n_loc + n_dev*H, F]``: its own rows, then the ``H`` rows each device
    ``o`` sent it, in device order."""
    sends = [x[idx.long()] for x, idx in zip(x_locals, halo_send_idx)]
    recv = all_to_all(sends, devices)
    return [torch.cat([x, r.reshape(-1, x.shape[-1])], dim=0)
            for x, r in zip(x_locals, recv)]
