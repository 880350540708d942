"""GraphCast-style encode-process-decode mesh GNN (Lam et al. 2022; the port
of ``repro.models.gnn.graphcast``).

An encoder MLP -> ``n_layers`` message-passing processor layers (edge MLP +
node MLP with sum aggregation, residual) -> decoder MLP, over one
homogeneous node set (the reference's grid == mesh collapse).  The
reference scans a checkpointed layer over the stacked ``proc`` leaves; the
port loops over ``L``, slicing each stacked leaf, with
``torch.utils.checkpoint`` per layer.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from ...distributed.sharding import Sharder
from ...graphs.segment import segment_sum
from ..common import (
    layer_slices,
    mlp_apply,
    mlp_init,
    param_device,
    seeded_split,
    stack_layers,
)

__all__ = ["GraphCastConfig", "init_graphcast", "graphcast_forward",
           "graphcast_loss"]


@dataclass(frozen=True)
class GraphCastConfig:
    name: str
    n_layers: int = 16
    d_hidden: int = 512
    d_in: int = 227          # n_vars
    d_out: int = 227
    d_edge_in: int = 4       # displacement features
    mesh_refinement: int = 6
    aggregator: str = "sum"
    dtype: str = "float32"


def init_graphcast(cfg: GraphCastConfig, *, seed: int = 0, device=None) -> dict:
    """The reference's tree (``enc_node``, ``enc_edge``, ``proc`` with each
    leaf stacked on ``[L]``, ``dec``) with its distributions, from a torch
    generator seeded with ``seed`` on ``device`` (``meta``: shapes
    alone)."""
    dev = param_device(device)
    ks = seeded_split(seed, dev)
    d = cfg.d_hidden
    layers = [{"edge_mlp": mlp_init(ks(), [3 * d, d, d], device=dev),
               "node_mlp": mlp_init(ks(), [2 * d, d, d], device=dev)}
              for _ in range(cfg.n_layers)]
    return {
        "enc_node": mlp_init(ks(), [cfg.d_in, d, d], device=dev),
        "enc_edge": mlp_init(ks(), [cfg.d_edge_in, d, d], device=dev),
        "proc": stack_layers(layers),
        "dec": mlp_init(ks(), [d, d, cfg.d_out], device=dev),
    }


def graphcast_forward(params, batch, cfg: GraphCastConfig,
                      shard: Sharder | None = None):
    shard = shard or Sharder(None)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    mask = batch.get("edge_mask")
    n = batch["x"].shape[0]
    h = mlp_apply(params["enc_node"], batch["x"])
    e = mlp_apply(params["enc_edge"], batch["edge_feat"])

    def layer(h, e, lp):
        h = shard.act(h, "flat", None)
        e = shard.act(e, "flat", None)
        msg_in = torch.cat([e, h[src], h[dst]], dim=-1)
        e_new = e + mlp_apply(lp["edge_mlp"], msg_in)
        agg = segment_sum(e_new, dst, n, mask)
        h_new = h + mlp_apply(lp["node_mlp"], torch.cat([h, agg], dim=-1))
        return h_new, e_new

    for lp in layer_slices(params["proc"]):
        h, e = checkpoint(layer, h, e, lp, use_reentrant=False)
    return mlp_apply(params["dec"], h)


def graphcast_loss(params, batch, cfg: GraphCastConfig,
                   shard: Sharder | None = None):
    pred = graphcast_forward(params, batch, cfg, shard)
    err = (pred - batch["target"]).float() ** 2
    if "label_mask" in batch:
        m = batch["label_mask"][:, None].float()
        return (err * m).sum() / torch.clamp_min(m.sum() * err.shape[-1], 1.0)
    return err.mean()
