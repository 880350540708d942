"""GraphCast-style encode-process-decode mesh GNN (Lam et al. 2022; the port
of ``repro.models.gnn.graphcast``).

An encoder MLP -> ``n_layers`` message-passing processor layers (edge MLP +
node MLP with sum aggregation, residual) -> decoder MLP, over one
homogeneous node set (the reference's grid == mesh collapse).  The
reference scans a checkpointed layer over the stacked ``proc`` leaves; the
port loops over ``L``, slicing each stacked leaf, with
``torch.utils.checkpoint`` per layer, on one device or over a mesh in the
reference's flat-sharded layout (``sharded``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...distributed.sharding import Sharder
from ..common import (
    mlp_apply,
    mlp_init,
    param_device,
    seeded_split,
    stack_layers,
)
from .sharded import graph_ops

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


def _graphcast(g, params, batch, cfg: GraphCastConfig, n: int):
    """The nodes' predictions on graph ops ``g`` (``sharded.Whole`` or
    ``sharded.OnMesh``)."""
    src = g.map(lambda t: t.long(), batch["edge_src"])
    dst = g.map(lambda t: t.long(), batch["edge_dst"])
    mask = batch.get("edge_mask")
    h = g.map(lambda x, p: mlp_apply(p["enc_node"], x), batch["x"], params)
    e = g.map(lambda x, p: mlp_apply(p["enc_edge"], x), batch["edge_feat"],
              params)

    def layer(h, e, lp):
        hs, hd = g.gather(h, src, dst)
        e_new = g.map(lambda e, hs, hd, lp: e + mlp_apply(
            lp["edge_mlp"], torch.cat([e, hs, hd], dim=-1)), e, hs, hd, lp)
        agg = g.segment_sum(e_new, dst, n, mask)
        h_new = g.map(lambda h, a, lp: h + mlp_apply(
            lp["node_mlp"], torch.cat([h, a], dim=-1)), h, agg, lp)
        return h_new, e_new

    for lp in g.layers(params, "proc"):
        h, e = g.checkpoint(layer, h, e, lp)
    return g.map(lambda h, p: mlp_apply(p["dec"], h), h, params)


def graphcast_forward(params, batch, cfg: GraphCastConfig,
                      shard: Sharder | None = None):
    """The nodes' predictions; on a mesh a ``ShardedTensor`` in the nodes'
    ``"flat"`` blocks (``sharded``)."""
    g, p, b = graph_ops(shard, params, batch)
    return g.result(_graphcast(g, p, b, cfg, batch["x"].shape[0]))


def graphcast_loss(params, batch, cfg: GraphCastConfig,
                   shard: Sharder | None = None):
    """The (label-masked) mean squared error in float32; on a mesh each
    position's terms are added at its first position (``sharded``)."""
    g, p, b = graph_ops(shard, params, batch)
    pred = _graphcast(g, p, b, cfg, batch["x"].shape[0])
    return g.mse(pred, b["target"], b.get("label_mask"))
