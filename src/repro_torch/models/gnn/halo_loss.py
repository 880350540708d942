"""What the halo-exchange losses share (``sage_loss_halo``,
``eqv2_loss_halo``): placing each device's shard of a partitioned batch and
the replicated parameters, and the cross entropy summed over the devices."""
from __future__ import annotations

import torch

from ...train.checkpoint import tree_map

__all__ = ["halo_ce_loss", "shard_inputs"]

# the per-device tables of a partitioned batch: [n_dev, ...], one row each
_STACKED = ("halo_send_idx", "edge_src_ext", "edge_dst_loc", "edge_mask",
            "wigner", "labels_2d", "label_mask_2d")


def shard_inputs(params, batch, mesh, axes) -> tuple[list, list[dict], list]:
    """``(devices, shards, params)``: the devices along ``axes``
    (``Mesh.shard_devices``), each device's shard of ``batch`` on it (x's
    ``n_loc`` rows and its row of every stacked table) and the parameters
    on it (replicated; ``.to`` keeps the autograd graph to the leaves)."""
    devs = mesh.shard_devices(axes)
    n_dev = len(devs)
    x = batch["x"]
    if x.shape[0] % n_dev or batch["halo_send_idx"].shape[:2] != (n_dev, n_dev):
        raise ValueError(f"a batch of {x.shape[0]} rows and halo tables "
                         f"{tuple(batch['halo_send_idx'].shape)} is not "
                         f"partitioned over {n_dev} devices")
    n_loc = x.shape[0] // n_dev
    shards = []
    for d, dev in enumerate(devs):
        s = {k: batch[k][d].to(dev) for k in _STACKED if k in batch}
        s["x"] = x[d * n_loc:(d + 1) * n_loc].to(dev)
        shards.append(s)
    return devs, shards, [tree_map(lambda t, dev=dev: t.to(dev), params)
                          for dev in devs]


def halo_ce_loss(logits: list, shards: list[dict], devs: list) -> torch.Tensor:
    """The label-masked cross entropy over every device's nodes: each
    device's float32 numerator and mask sum, added on the first device in
    device order (the reference's ``psum``), then ``num / max(den, 1)``."""
    num = den = None
    for lg, s in zip(logits, shards):
        lg = lg.float()
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, s["labels_2d"].long()[:, None])[:, 0]
        lmask = s["label_mask_2d"].float()
        n_d = ((lse - gold) * lmask).sum().to(devs[0])
        d_d = lmask.sum().to(devs[0])
        num = n_d if num is None else num + n_d
        den = d_d if den is None else den + d_d
    return num / torch.clamp_min(den, 1.0)
