"""GraphSAGE (Hamilton et al. 2017) — mean aggregator, edge-list form (the
port of ``repro.models.gnn.graphsage``).

Message passing is gather -> segment_mean -> linear, over full graphs and
sampler-produced padded subgraphs; :func:`sage_loss_halo` is the
partitioned layout whose features cross devices only through the halo
all-to-all (``graphs/halo.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...distributed.sharding import Sharder
from ...graphs.segment import segment_mean
from ..common import (
    cross_entropy,
    dense_init,
    param_device,
    seeded_split,
)
from .halo_loss import halo_ce_loss, shard_inputs

__all__ = ["SAGEConfig", "init_sage", "sage_forward", "sage_loss",
           "sage_loss_halo"]


@dataclass(frozen=True)
class SAGEConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_classes: int = 41
    aggregator: str = "mean"
    dtype: str = "float32"


def init_sage(cfg: SAGEConfig, *, seed: int = 0, device=None) -> dict:
    """The reference's tree (``w_self``, ``w_nbr``, ``b`` lists over the
    layers, ``w_out``) with its distributions, drawn from a torch generator
    seeded with ``seed`` on ``device`` (the card by default; ``meta`` for
    shapes alone), so the numbers differ from the reference's threefry
    draws."""
    dev = param_device(device)
    ks = seeded_split(seed, dev)
    dims = [cfg.d_in] + [cfg.d_hidden] * cfg.n_layers
    pairs = list(zip(dims[:-1], dims[1:]))
    return {
        "w_self": [dense_init(ks(), a, b, device=dev) for a, b in pairs],
        "w_nbr": [dense_init(ks(), a, b, device=dev) for a, b in pairs],
        "b": [torch.zeros((b,), device=dev) for b in dims[1:]],
        "w_out": dense_init(ks(), cfg.d_hidden, cfg.n_classes, device=dev),
    }


def _readout(x: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                            1e-6)
    return x @ w_out


def sage_forward(params, batch, cfg: SAGEConfig, shard: Sharder | None = None):
    shard = shard or Sharder(None)
    x = batch["x"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"]
    mask = batch.get("edge_mask")
    n = x.shape[0]
    for ws, wn, b in zip(params["w_self"], params["w_nbr"], params["b"]):
        x = shard.act(x, "flat", None)
        # project-then-gather: mean_nbr(x) @ Wn == mean_nbr(x @ Wn), so the
        # gather moves d_hidden-wide rows instead of d_in-wide ones
        xn = x @ wn
        agg = segment_mean(xn[src], dst, n, mask)
        x = F.relu(x @ ws + agg + b)
    return _readout(x, params["w_out"])


def sage_loss(params, batch, cfg: SAGEConfig, shard: Sharder | None = None):
    logits = sage_forward(params, batch, cfg, shard)
    return cross_entropy(logits, batch["labels"], mask=batch.get("label_mask"))


def sage_loss_halo(params, batch, cfg: SAGEConfig, mesh, axes: tuple):
    """Partitioned-layout GraphSAGE: features cross devices only through the
    per-layer halo all-to-all, never a gather of the whole graph.

    ``batch`` uses the ``PartitionedGraph.device_batch()`` layout: x [N, F]
    (``n_loc`` rows per device), halo_send_idx [n_dev, n_dev, H],
    edge_src_ext/edge_dst_loc/edge_mask [n_dev, e_loc], labels_2d /
    label_mask_2d [n_dev, n_loc].  The reference's ``shard_map`` over
    ``axes`` is a loop over the mesh's devices along ``axes`` (one may
    repeat), and its ``psum`` the sum on the first device in device
    order."""
    from ...graphs.halo import halo_exchange

    devs, local, p = shard_inputs(params, batch, mesh, axes)
    n_loc = local[0]["x"].shape[0]
    xs = [s["x"] for s in local]
    for i in range(len(params["w_self"])):
        xn = [x @ pd["w_nbr"][i] for x, pd in zip(xs, p)]   # project-then-exchange
        ext = halo_exchange(xn, [s["halo_send_idx"] for s in local], devs)
        xs = [F.relu(x @ pd["w_self"][i]
                     + segment_mean(e[s["edge_src_ext"].long()], s["edge_dst_loc"],
                                    n_loc, s["edge_mask"])
                     + pd["b"][i])
              for x, e, s, pd in zip(xs, ext, local, p)]
    logits = [_readout(x, pd["w_out"]) for x, pd in zip(xs, p)]
    return halo_ce_loss(logits, local, devs)
