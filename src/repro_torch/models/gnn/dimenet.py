"""DimeNet (Klicpera et al. 2020): directional message passing with radial
Bessel and spherical basis over edge-pair (triplet) gathers (the port of
``repro.models.gnn.dimenet``).

Messages live on directed edges; each interaction block gathers, for every
triplet (k->j, j->i), the incoming message m_kj, modulates it by the
spherical basis of the angle (k, j, i) through the bilinear layer, and
scatter-sums back onto m_ji.  Triplet indices are precomputed on the host
(:func:`build_triplets`, or its vectorised twin
:func:`build_triplets_vectorised`, equal element for element).  The
reference scans a checkpointed block over the stacked ``blocks``; the port
loops over them with ``torch.utils.checkpoint`` per block.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ...distributed.sharding import Sharder
from ...graphs.segment import segment_sum
from ..common import (
    dense_init,
    layer_slices,
    mlp_apply,
    mlp_init,
    param_device,
    seeded_split,
    stack_layers,
)

__all__ = ["DimeNetConfig", "init_dimenet", "dimenet_forward", "dimenet_loss",
           "build_triplets", "build_triplets_vectorised", "TRIPLET_CHUNK"]

# the edges ji whose candidate triplets build_triplets_vectorised forms at once
TRIPLET_CHUNK = 1 << 20


@dataclass(frozen=True)
class DimeNetConfig:
    name: str
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    d_out: int = 1           # per-graph energy
    dtype: str = "float32"


def _pad_triplets(t_in, t_out, max_triplets: int):
    pad = max_triplets - len(t_in)
    mask = np.r_[np.ones(len(t_in), bool), np.zeros(pad, bool)]
    t_in = np.r_[np.asarray(t_in, np.int64), np.zeros(pad, np.int64)]
    t_out = np.r_[np.asarray(t_out, np.int64), np.zeros(pad, np.int64)]
    return t_in, t_out, mask


def build_triplets(src: np.ndarray, dst: np.ndarray, max_triplets: int):
    """Host-side triplet enumeration: pairs (edge kj, edge ji) with dst(kj) ==
    src(ji) and k != i.  Truncated/padded to ``max_triplets``."""
    n_e = len(src)
    by_dst: dict[int, list[int]] = {}
    for e in range(n_e):
        by_dst.setdefault(int(dst[e]), []).append(e)
    t_in, t_out = [], []
    for e_ji in range(n_e):
        j = int(src[e_ji])
        for e_kj in by_dst.get(j, ()):
            if int(src[e_kj]) == int(dst[e_ji]):
                continue  # k == i back-tracking excluded
            t_in.append(e_kj)
            t_out.append(e_ji)
            if len(t_in) >= max_triplets:
                break
        if len(t_in) >= max_triplets:
            break
    return _pad_triplets(t_in, t_out, max_triplets)


def build_triplets_vectorised(src: np.ndarray, dst: np.ndarray,
                              max_triplets: int):
    """:func:`build_triplets` in numpy, equal element for element and in
    order: for each edge ji in edge order, the edges kj into ``src(ji)`` in
    edge order (a stable sort by ``dst``), less ``k == i``; edges are taken
    :data:`TRIPLET_CHUNK` at a time until ``max_triplets`` are found."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    n_e = len(src)
    n_v = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    order = np.argsort(dst, kind="stable")
    count = np.bincount(dst, minlength=n_v)
    start = np.zeros(n_v + 1, np.int64)
    np.cumsum(count, out=start[1:])
    t_in, t_out, found = [], [], 0
    for lo in range(0, n_e, TRIPLET_CHUNK):
        e_ji = np.arange(lo, min(lo + TRIPLET_CHUNK, n_e))
        k = count[src[e_ji]]
        ji = np.repeat(e_ji, k)
        first = np.repeat(np.cumsum(k) - k, k)
        kj = order[np.repeat(start[src[e_ji]], k) + np.arange(len(ji)) - first]
        keep = src[kj] != dst[ji]
        ji, kj = ji[keep], kj[keep]
        take = min(len(ji), max_triplets - found)
        t_in.append(kj[:take])
        t_out.append(ji[:take])
        found += take
        if found >= max_triplets:
            break
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64)  # noqa: E731
    return _pad_triplets(cat(t_in), cat(t_out), max_triplets)


def _bessel_rbf(d, n_radial: int, cutoff: float):
    """Radial Bessel basis sin(n pi d / c) / d."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    dd = torch.clamp_min(d[..., None], 1e-6)
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * dd / cutoff) / dd


def _angular_sbf(angle, d, n_spherical: int, n_radial: int, cutoff: float):
    """Simplified spherical basis: cos(l * angle) x radial Bessel (the
    reference's structure-faithful stand-in)."""
    l = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)  # noqa: E741
    ang = torch.cos(angle[..., None] * (l + 1.0))             # [T, L]
    rad = _bessel_rbf(d, n_radial, cutoff)                    # [T, R]
    return (ang[..., :, None] * rad[..., None, :]).reshape(*angle.shape, -1)


def init_dimenet(cfg: DimeNetConfig, *, seed: int = 0, device=None) -> dict:
    """The reference's tree (``embed_edge``, ``embed_node``, ``blocks``
    with each leaf stacked on ``[L]``, ``out``) with its distributions,
    from a torch generator seeded with ``seed`` on ``device`` (``meta``:
    shapes alone)."""
    dev = param_device(device)
    ks = seeded_split(seed, dev)
    d, nb = cfg.d_hidden, cfg.n_bilinear
    n_sbf = cfg.n_spherical * cfg.n_radial
    blocks = []
    for _ in range(cfg.n_blocks):
        blocks.append({
            "w_sbf": dense_init(ks(), n_sbf, nb, device=dev),
            "w_bilinear": torch.randn((nb, d, d), generator=ks(), device=dev) / d,
            "edge_mlp": mlp_init(ks(), [d, d, d], device=dev),
            "w_rbf": dense_init(ks(), cfg.n_radial, d, device=dev),
            "out_mlp": mlp_init(ks(), [d, d, d], device=dev),
        })
    return {
        "embed_edge": mlp_init(ks(), [2 * d + cfg.n_radial, d, d], device=dev),
        "embed_node": dense_init(ks(), 1, d, device=dev),  # atom type scalar stub
        "blocks": stack_layers(blocks),
        "out": mlp_init(ks(), [d, d, cfg.d_out], device=dev),
    }


def _bilinear(a, m_in, w):
    """``einsum("tb,td,bdf->tf", a, m_in, w)`` as one GEMM on the [T, nb*d]
    outer product of ``a`` and ``m_in``."""
    nb, d, f = w.shape
    outer = (a[:, :, None] * m_in[:, None, :]).reshape(-1, nb * d)
    return outer @ w.reshape(nb * d, f)


def dimenet_forward(params, batch, cfg: DimeNetConfig,
                    shard: Sharder | None = None):
    """batch: pos [N,3], z [N,1], edge_src/dst [E], t_in/t_out [T] triplet
    edge indices, masks, graph_id [N] for batched molecules."""
    shard = shard or Sharder(None)
    pos = batch["pos"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch.get("edge_mask")
    tmask = batch.get("triplet_mask")
    t_in, t_out = batch["t_in"].long(), batch["t_out"].long()
    n = pos.shape[0]
    n_e = src.shape[0]

    vec = pos[dst] - pos[src]                                # [E, 3]
    dist = torch.linalg.vector_norm(vec, dim=-1)
    rbf = _bessel_rbf(dist, cfg.n_radial, cfg.cutoff)        # [E, R]

    h = batch["z"].float() @ params["embed_node"]
    m = mlp_apply(params["embed_edge"],
                  torch.cat([h[src], h[dst], rbf], dim=-1))  # [E, d]

    # triplet angles: between edge (k->j) = t_in and (j->i) = t_out
    v1 = -vec[t_in]
    v2 = vec[t_out]
    cosang = torch.sum(v1 * v2, -1) / torch.clamp_min(
        torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1),
        1e-6)
    angle = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
    sbf = _angular_sbf(angle, dist[t_in], cfg.n_spherical, cfg.n_radial,
                       cfg.cutoff)

    node_acc = torch.zeros((n, cfg.d_hidden), dtype=torch.float32,
                           device=pos.device)

    def block(m, node_acc, bp):
        m = shard.act(m, "flat", None)
        # directional message: bilinear(sbf, m_kj) scattered onto ji
        a = sbf @ bp["w_sbf"]                                # [T, nbil]
        msg = _bilinear(a, m[t_in], bp["w_bilinear"])
        if tmask is not None:
            msg = torch.where(tmask[:, None], msg, 0.0)
        inter = segment_sum(msg, t_out, n_e)
        m_new = m + mlp_apply(bp["edge_mlp"], m * (rbf @ bp["w_rbf"]) + inter)
        # per-block output: edge -> node
        contrib = segment_sum(mlp_apply(bp["out_mlp"], m_new), dst, n, emask)
        return m_new, node_acc + contrib

    for bp in layer_slices(params["blocks"]):
        m, node_acc = checkpoint(block, m, node_acc, bp, use_reentrant=False)
    per_node = mlp_apply(params["out"], node_acc)            # [N, d_out]
    if "graph_id" in batch:
        n_graphs = batch["target"].shape[0]
        return segment_sum(per_node, batch["graph_id"], n_graphs,
                           batch.get("node_mask"))
    return per_node


def dimenet_loss(params, batch, cfg: DimeNetConfig, shard: Sharder | None = None):
    pred = dimenet_forward(params, batch, cfg, shard)
    return torch.mean((pred - batch["target"]).float() ** 2)
