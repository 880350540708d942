"""EquiformerV2-style equivariant graph attention via eSCN convolutions
(Liao et al. 2023, arXiv:2306.12059; the port of
``repro.models.gnn.equiformer_v2``).

Node features are spherical-harmonic coefficient stacks x [N, (L+1)^2, C].
Per edge, the source features are rotated into the edge-aligned frame
(Wigner-D matrices, inputs precomputed on the host), where the SO(3)
tensor-product convolution reduces to an SO(2) convolution coupling only
m <= m_max, with per-|m| channel mixing shared across l (the reference's
documented simplification).  Attention weights come from the invariant
(l=0) channel through an MLP and a segment softmax; messages rotate back
and scatter-sum onto their destinations.

The forward runs on one device or over a mesh in the reference's
flat-sharded layout (``sharded``).  Both dtypes of the reference are
ported: ``bfloat16`` keeps the coefficient stacks in bf16 and computes
each contraction the reference computes with
``preferred_element_type=float32`` as a float32 einsum on widened
operands.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ...distributed.sharding import Sharder
from ...graphs.segment import segment_softmax, segment_sum
from ..common import (
    dense_init,
    layer_slices,
    mlp_apply,
    mlp_init,
    param_device,
    seeded_split,
    stack_layers,
)
from .halo_loss import halo_ce_loss, shard_inputs
from .sharded import graph_ops

__all__ = ["EqV2Config", "init_eqv2", "eqv2_forward", "eqv2_loss",
           "eqv2_loss_halo", "m_order_masks"]


@dataclass(frozen=True)
class EqV2Config:
    name: str
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_in: int = 100
    d_out: int = 1
    dtype: str = "float32"

    @property
    def n_coeff(self) -> int:
        return (self.l_max + 1) ** 2


def m_order_masks(l_max: int, m_max: int) -> np.ndarray:
    """|m| per coefficient index (l^2 + l + m layout), clipped mask m<=m_max."""
    ms = np.zeros((l_max + 1) ** 2, dtype=np.int64)
    for l in range(l_max + 1):  # noqa: E741
        for m in range(-l, l + 1):
            ms[l * l + l + m] = abs(m)
    return ms


def init_eqv2(cfg: EqV2Config, *, seed: int = 0, device=None) -> dict:
    """The reference's tree (``embed``, ``layers`` with each leaf stacked on
    ``[L]``, ``out``) with its distributions, from a torch generator seeded
    with ``seed`` on ``device`` (``meta``: shapes alone)."""
    dev = param_device(device)
    ks = seeded_split(seed, dev)
    c = cfg.d_hidden
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            # SO(2) channel mixing per |m| (m_max+1 weight sets)
            "w_so2": torch.randn((cfg.m_max + 1, c, c), generator=ks(),
                                 device=dev) / c ** 0.5,
            "w_so2_im": torch.randn((cfg.m_max + 1, c, c), generator=ks(),
                                    device=dev) / c ** 0.5,
            "attn_mlp": mlp_init(ks(), [2 * c, c, cfg.n_heads], device=dev),
            "node_mlp": mlp_init(ks(), [c, 2 * c, c], device=dev),
            "ln_scale": torch.ones((c,), device=dev),
        })
    return {
        "embed": dense_init(ks(), cfg.d_in, c, device=dev),
        "layers": stack_layers(layers),
        "out": mlp_init(ks(), [c, c, cfg.d_out], device=dev),
    }


class _SO2Index:
    """The coefficient bookkeeping of the SO(2) restriction, on a device:
    ``|m|`` clipped to ``m_max`` per coefficient (which weight set mixes
    it), whether ``|m| <= m_max`` (``keep``), the sign of ``m`` and the
    index of each coefficient's ``(l, -m)`` partner."""

    def __init__(self, cfg: EqV2Config, device):
        m_of = m_order_masks(cfg.l_max, cfg.m_max)
        l_of = np.asarray([l for l in range(cfg.l_max + 1)  # noqa: E741
                           for _ in range(2 * l + 1)])
        m_signed = np.arange(cfg.n_coeff) - (l_of * l_of + l_of)
        as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.w_idx = as_t(np.clip(m_of, 0, cfg.m_max))
        self.keep = as_t(m_of <= cfg.m_max)[None, :, None]
        self.sign = as_t(np.sign(m_signed).astype(np.float32))[None, :, None]
        self.partner = as_t(l_of * l_of + l_of - m_signed)

    def conv(self, xe: torch.Tensor, lp: dict) -> torch.Tensor:
        """The SO(2) convolution of edge-frame stacks ``xe`` [E, nc, C]:
        ``(l, m)`` mixed with ``(l, -m)`` by the per-|m| weights, zero past
        ``m_max``; float32 out."""
        w_re = lp["w_so2"][self.w_idx].to(xe.dtype).float()
        w_im = lp["w_so2_im"][self.w_idx].to(xe.dtype).float()
        y_re = torch.einsum("epc,pcd->epd", xe.float(), w_re)
        y_im = torch.einsum("epc,pcd->epd", xe[:, self.partner, :].float(), w_im)
        return torch.where(self.keep, y_re + self.sign * y_im, 0.0)


def _norm_and_mlp(x: torch.Tensor, lp: dict) -> torch.Tensor:
    """The equivariant norm over the coefficients, then the invariant MLP
    added to the l=0 channel."""
    norm = torch.sqrt(torch.sum(x.float() ** 2, dim=1, keepdim=True) + 1e-6)
    x = (x.float() / norm * lp["ln_scale"][None, None, :]).to(x.dtype)
    add = mlp_apply(lp["node_mlp"], x[:, 0, :].float()).to(x.dtype)
    return torch.cat([x[:, :1, :] + add[:, None, :], x[:, 1:, :]], dim=1)


def _lift(xin: torch.Tensor, embed: torch.Tensor, nc: int, dt) -> torch.Tensor:
    """Invariant inputs lifted into the l=0 channel of zero stacks."""
    x0 = torch.tanh(xin.float() @ embed).to(dt)
    rest = torch.zeros((x0.shape[0], nc - 1, x0.shape[1]), dtype=dt,
                       device=x0.device)
    return torch.cat([x0[:, None, :], rest], dim=1)


def _eqv2(g, params, batch, cfg: EqV2Config, n: int):
    """The nodes' invariant readout on graph ops ``g`` (``sharded.Whole``
    or ``sharded.OnMesh``)."""
    src = g.map(lambda t: t.long(), batch["edge_src"])
    dst = g.map(lambda t: t.long(), batch["edge_dst"])
    emask = batch.get("edge_mask")
    nc, c = cfg.n_coeff, cfg.d_hidden
    so2 = g.map(lambda t: _SO2Index(cfg, t.device), src)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    wig = g.map(lambda w: w.to(dt), batch["wigner"])
    x = g.map(lambda xin, p: _lift(xin, p["embed"], nc, dt), batch["x"],
              params)

    def edge(xs, xd, wig, lp, so2):
        # -- rotate into edge frames (float32 accumulation)
        xe = torch.einsum("epq,eqc->epc", wig.float(), xs.float()).to(dt)
        # -- SO(2) conv: couple (l, m) with (l, -m), per-|m| channel mixing
        ye = so2.conv(xe, lp).to(dt)
        # -- invariant attention logits over incoming edges
        inv = torch.cat([xs[:, 0, :], xd[:, 0, :]], dim=-1)
        return ye, mlp_apply(lp["attn_mlp"], inv.float())           # [E, H]

    def message(ye, alpha, wig, mask):
        alpha = alpha.mean(-1, keepdim=True)[:, None, :]             # [E,1,1]
        # -- rotate back
        msg = (torch.einsum("eqp,epc->eqc", wig, ye) * alpha.to(dt)).to(dt)
        if mask is not None:
            msg = torch.where(mask[:, None, None], msg,
                              torch.zeros((), dtype=dt, device=msg.device))
        return msg.reshape(msg.shape[0], -1)

    def layer(x, lp):
        xs, xd = g.gather(x, src, dst)
        ye, logits = g.map(edge, xs, xd, wig, lp, so2)
        alpha = g.segment_softmax(logits, dst, n, emask)             # [E, H]
        # -- scatter
        agg = g.segment_sum(g.map(message, ye, alpha, wig, emask), dst, n)
        return g.map(lambda x, a, lp: _norm_and_mlp(
            x + a.reshape(a.shape[0], nc, c), lp), x, agg, lp)

    for lp in g.layers(params, "layers"):
        x = g.checkpoint(layer, x, lp)
    return g.map(lambda x, p: mlp_apply(p["out"], x[:, 0, :].float()), x,
                 params)                                     # invariant readout


def eqv2_forward(params, batch, cfg: EqV2Config, shard: Sharder | None = None):
    """batch: x [N, d_in] invariant inputs, edge_src/dst [E], wigner
    [E, n_coeff, n_coeff] edge-frame rotations, masks.  On a mesh a
    ``ShardedTensor`` in the nodes' ``"flat"`` blocks (``sharded``)."""
    g, p, b = graph_ops(shard, params, batch)
    return g.result(_eqv2(g, p, b, cfg, batch["x"].shape[0]))


def eqv2_loss(params, batch, cfg: EqV2Config, shard: Sharder | None = None):
    """The label-masked cross entropy where the batch has labels, else the
    mean squared error to its target; on a mesh each position's terms are
    added at its first position (``sharded``)."""
    g, p, b = graph_ops(shard, params, batch)
    pred = _eqv2(g, p, b, cfg, batch["x"].shape[0])
    if "labels" in batch:
        return g.cross_entropy(pred, b["labels"], b.get("label_mask"))
    return g.mse(pred, b["target"])


def eqv2_loss_halo(params, batch, cfg: EqV2Config, mesh, axes: tuple):
    """Partitioned-layout EquiformerV2 (float32, as the reference's).

    batch: x [N, d_in] (``n_loc`` rows per device); halo_send_idx
    [n_dev, n_dev, H]; edge_src_ext/edge_dst_loc/edge_mask [n_dev, e_loc];
    wigner [n_dev, e_loc, nc, nc]; labels_2d/label_mask_2d [n_dev, n_loc].
    The reference's ``shard_map`` is a loop over the mesh's devices along
    ``axes`` and its ``psum`` the sum on the first device in device order
    (``sage_loss_halo``); each layer is checkpointed over all devices at
    once, as the exchange joins them."""
    from ...graphs.halo import halo_exchange

    devs, local, p = shard_inputs(params, batch, mesh, axes)
    nc, c = cfg.n_coeff, cfg.d_hidden
    n_loc = local[0]["x"].shape[0]
    so2 = [_SO2Index(cfg, dev) for dev in devs]
    xs = [_lift(s["x"], pd["embed"], nc, torch.float32)
          for s, pd in zip(local, p)]

    def layer(lps, *xs):
        ext = halo_exchange([x.reshape(n_loc, nc * c) for x in xs],
                            [s["halo_send_idx"] for s in local], devs)
        out = []
        for x, e, s, lp, ix in zip(xs, ext, local, lps, so2):
            e_src, e_dst = s["edge_src_ext"].long(), s["edge_dst_loc"].long()
            xsrc = e[e_src].reshape(-1, nc, c)           # boundary-aware gather
            xe = torch.einsum("epq,eqc->epc", s["wigner"], xsrc)
            ye = ix.conv(xe, lp)
            inv = torch.cat([xsrc[:, 0, :], x[e_dst][:, 0, :]], dim=-1)
            alpha = segment_softmax(mlp_apply(lp["attn_mlp"], inv), e_dst,
                                    n_loc, s["edge_mask"])
            alpha = alpha.mean(-1, keepdim=True)[:, None, :]
            msg = torch.einsum("eqp,epc->eqc", s["wigner"], ye) * alpha
            msg = torch.where(s["edge_mask"][:, None, None], msg, 0.0)
            agg = segment_sum(msg.reshape(msg.shape[0], -1), e_dst,
                              n_loc).reshape(n_loc, nc, c)
            out.append(_norm_and_mlp(x + agg, lp))
        return tuple(out)

    per_dev = [layer_slices(pd["layers"]) for pd in p]
    for i in range(len(per_dev[0])):
        xs = checkpoint(layer, [lps[i] for lps in per_dev], *xs,
                        use_reentrant=False)
    logits = [mlp_apply(pd["out"], x[:, 0, :]).float() for x, pd in zip(xs, p)]
    return halo_ce_loss(logits, local, devs)
