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
loops over them with ``torch.utils.checkpoint`` per block, on one device or
over a mesh in the reference's flat-sharded layout (``sharded``; the
per-graph readout all-reduced).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ...distributed.sharding import Sharder
from ..common import (
    dense_init,
    mlp_apply,
    mlp_init,
    param_device,
    seeded_split,
    stack_layers,
)
from .sharded import graph_ops

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


def _angle_basis(v1, v2, d_in, cfg: DimeNetConfig):
    """The spherical basis of each triplet's angle between edges (k->j)
    (``-v1``) and (j->i) (``v2``), with the first's length ``d_in``."""
    cosang = torch.sum(v1 * v2, -1) / torch.clamp_min(
        torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1),
        1e-6)
    angle = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
    return _angular_sbf(angle, d_in, cfg.n_spherical, cfg.n_radial,
                        cfg.cutoff)


def _dimenet(g, params, batch, cfg: DimeNetConfig, n: int, n_e: int):
    """Each node's (or graph's) prediction on graph ops ``g``
    (``sharded.Whole`` or ``sharded.OnMesh``)."""
    long = lambda t: t.long()  # noqa: E731
    src, dst = g.map(long, batch["edge_src"]), g.map(long, batch["edge_dst"])
    t_in, t_out = g.map(long, batch["t_in"]), g.map(long, batch["t_out"])
    emask, tmask = batch.get("edge_mask"), batch.get("triplet_mask")

    p_dst, p_src = g.gather(batch["pos"], dst, src)
    vec = g.map(torch.sub, p_dst, p_src)                     # [E, 3]
    dist = g.map(lambda v: torch.linalg.vector_norm(v, dim=-1), vec)
    rbf = g.map(lambda d: _bessel_rbf(d, cfg.n_radial, cfg.cutoff), dist)

    h = g.map(lambda z, p: z.float() @ p["embed_node"], batch["z"], params)
    h_src, h_dst = g.gather(h, src, dst)
    m = g.map(lambda a, b, r, p: mlp_apply(p["embed_edge"],
                                           torch.cat([a, b, r], dim=-1)),
              h_src, h_dst, rbf, params)                     # [E, d]

    # triplet angles: between edge (k->j) = t_in and (j->i) = t_out
    v_in, v_out = g.gather(vec, t_in, t_out)
    sbf = g.map(lambda a, b, d: _angle_basis(-a, b, d, cfg), v_in, v_out,
                g.gather(dist, t_in))

    node_acc = g.map(lambda pos: torch.zeros(
        (pos.shape[0], cfg.d_hidden), dtype=torch.float32, device=pos.device),
        batch["pos"])

    def triplet_msg(s, mi, tm, bp):
        # directional message: bilinear(sbf, m_kj)
        msg = _bilinear(s @ bp["w_sbf"], mi, bp["w_bilinear"])
        return msg if tm is None else torch.where(tm[:, None], msg, 0.0)

    def block(m, node_acc, bp):
        msg = g.map(triplet_msg, sbf, g.gather(m, t_in), tmask, bp)
        inter = g.segment_sum(msg, t_out, n_e)               # onto ji
        m_new = g.map(lambda m, r, i, bp: m + mlp_apply(
            bp["edge_mlp"], m * (r @ bp["w_rbf"]) + i), m, rbf, inter, bp)
        # per-block output: edge -> node
        out = g.map(lambda mn, bp: mlp_apply(bp["out_mlp"], mn), m_new, bp)
        contrib = g.segment_sum(out, dst, n, emask)
        return m_new, g.map(torch.add, node_acc, contrib)

    for bp in g.layers(params, "blocks"):
        m, node_acc = g.checkpoint(block, m, node_acc, bp)
    per_node = g.map(lambda a, p: mlp_apply(p["out"], a), node_acc, params)
    if "graph_id" in batch:
        n_graphs = batch["target"][0].shape[0] if g.mesh is not None \
            else batch["target"].shape[0]
        return g.segment_sum(per_node, batch["graph_id"], n_graphs,
                             batch.get("node_mask"), to="all")
    return per_node


def _laid_out(shard, params, batch):
    """:func:`sharded.graph_ops` with a per-graph target whole at every
    position (the reference's ``(None, None)``)."""
    return graph_ops(shard, params, batch,
                     replicated=("target",) if "graph_id" in batch else ())


def dimenet_forward(params, batch, cfg: DimeNetConfig,
                    shard: Sharder | None = None):
    """batch: pos [N,3], z [N,1], edge_src/dst [E], t_in/t_out [T] triplet
    edge indices, masks, graph_id [N] for batched molecules.  On a mesh a
    ``ShardedTensor``: the nodes' predictions in their ``"flat"`` blocks,
    or the graphs' whole at every position (``sharded``)."""
    g, p, b = _laid_out(shard, params, batch)
    out = _dimenet(g, p, b, cfg, batch["pos"].shape[0],
                   batch["edge_src"].shape[0])
    return g.result(out, replicated="graph_id" in batch)


def dimenet_loss(params, batch, cfg: DimeNetConfig, shard: Sharder | None = None):
    """The mean squared error in float32; on a mesh each position's terms
    (its block of the graphs where the prediction is per graph) are added
    at its first position (``sharded``)."""
    g, p, b = _laid_out(shard, params, batch)
    pred = _dimenet(g, p, b, cfg, batch["pos"].shape[0],
                    batch["edge_src"].shape[0])
    target = b["target"]
    if "graph_id" in batch:
        pred, target = g.block(pred), g.block(target)
    return g.mse(pred, target)
