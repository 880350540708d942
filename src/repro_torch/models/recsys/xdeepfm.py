"""xDeepFM (Lian et al. 2018): CIN + deep MLP + linear over field embeddings
(the port of ``repro.models.recsys.xdeepfm``).

The Compressed Interaction Network computes, per layer,
    X^k[b, h, d] = sum_{i, j} W^k[h, i, j] * X^{k-1}[b, i, d] * X^0[b, j, d]
— an outer product over fields compressed by a 1x1 conv.  The reference's
``einsum("bid,bjd,hij->bhd")`` forms the outer product ``[B, H_prev, m,
D]`` in float32 (20.4 GB for a 65,536-row batch at the full config), so
:func:`_cin` contracts it in slabs of batch rows, each slab's outer
product within ``CIN_SLAB_BYTES``, with ``torch.utils.checkpoint`` per
slab when gradients are needed.  Each row's output depends only on that
row, so the slabs compute the same function.

The forward's math is written once (:func:`_logits`), against the ops of
one device or of a mesh (:mod:`.sharded`): with a ``Sharder`` on a mesh
the forward, the loss and the candidate scores run in the reference's
layout, the tables row-split over "model" and the rows over "batch".
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...distributed.sharding import Sharder
from ..common import (
    dense_init,
    mlp_apply,
    mlp_init,
    param_device,
    seeded_split,
)
from .embedding import fused_field_lookup
from .sharded import mesh_ops

__all__ = ["XDeepFMConfig", "init_xdeepfm", "xdeepfm_forward", "xdeepfm_loss",
           "xdeepfm_param_specs", "xdeepfm_score_candidates", "CIN_SLAB_BYTES"]

# the float32 outer product one slab of the CIN may hold at once
CIN_SLAB_BYTES = 1 << 30


@dataclass(frozen=True)
class XDeepFMConfig:
    name: str
    n_sparse: int = 39
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp_dims: tuple = (400, 400)
    n_dense: int = 0
    vocab_per_field: int = 1_000_000   # Criteo-scale default
    dtype: str = "float32"

    @property
    def total_vocab(self) -> int:
        return self.n_sparse * self.vocab_per_field


def init_xdeepfm(cfg: XDeepFMConfig, *, seed: int = 0, device=None) -> dict:
    """The reference's tree (``table``, ``linear``, ``cin_w`` list,
    ``cin_out``, ``mlp``, ``bias``) with its distributions, from a torch
    generator seeded with ``seed`` on ``device`` (``meta``: shapes
    alone)."""
    dev = param_device(device)
    ks = seeded_split(seed, dev)
    m, d = cfg.n_sparse, cfg.embed_dim
    cin_w = []
    h_prev = m
    for h in cfg.cin_layers:
        cin_w.append(torch.randn((h, h_prev, m), generator=ks(), device=dev)
                     / (h_prev * m) ** 0.5)
        h_prev = h
    return {
        "table": torch.randn((cfg.total_vocab, d), generator=ks(), device=dev) * 0.01,
        "linear": torch.randn((cfg.total_vocab, 1), generator=ks(), device=dev) * 0.01,
        "cin_w": cin_w,
        "cin_out": dense_init(ks(), sum(cfg.cin_layers), 1, device=dev),
        "mlp": mlp_init(ks(), [m * d, *cfg.mlp_dims, 1], device=dev),
        "bias": torch.zeros((1,), device=dev),
    }


def xdeepfm_param_specs(cfg: XDeepFMConfig) -> dict:
    """Embedding tables row-sharded over 'model'; dense nets replicated."""
    return {
        "table": ("model", None),
        "linear": ("model", None),
        "cin_w": [(None, None, None) for _ in cfg.cin_layers],
        "cin_out": (None, None),
        "mlp": {"w": [(None, None)] * (len(cfg.mlp_dims) + 1),
                "b": [(None,)] * (len(cfg.mlp_dims) + 1)},
        "bias": (None,),
    }


def _field_offsets(cfg: XDeepFMConfig, device) -> torch.Tensor:
    return torch.arange(cfg.n_sparse, dtype=torch.int64,
                        device=device) * cfg.vocab_per_field


def _cin_rows(x0: torch.Tensor, *cin_w: torch.Tensor) -> torch.Tensor:
    """The CIN on a slab of rows: x0 [b, m, D] -> [b, sum(H_k)].  Each
    layer's outer product is formed as [b*D, H_prev*m] and contracted with
    its weights as one GEMM; the stacks are kept as [b, D, H].  The widths
    are spelled out, so that a slab of 0 rows (a mesh's empty block) gives
    [0, sum(H_k)]."""
    b, m, d = x0.shape
    x0t = x0.transpose(1, 2)                 # [b, D, m]
    xs = []
    xk = x0t
    for w in cin_w:
        h, h_prev = w.shape[0], w.shape[1]
        # z[b,h,d] = sum_{i,j} w[h,i,j] x_k[b,i,d] x_0[b,j,d]
        outer = (xk[..., :, None] * x0t[..., None, :]).reshape(b * d, h_prev * m)
        xk = F.relu(outer @ w.reshape(h, h_prev * m).T).reshape(b, d, h)
        xs.append(xk.sum(dim=1))             # sum pooling over D
    return torch.cat(xs, dim=-1)


def _cin(params, x0, cfg: XDeepFMConfig):
    """x0 [B, m, D] -> concat of per-layer sum-pooled features [B, sum(H_k)],
    in slabs of rows whose outer product fits :data:`CIN_SLAB_BYTES`.  The
    reference constrains each layer's stack to the batch axis; here every
    row's stack lies where its row does (on a mesh, at its group's
    positions), so there is nothing to constrain."""
    b, m, d = x0.shape
    h_max = max([m, *cfg.cin_layers[:-1]])
    per_row = h_max * m * d * x0.element_size()
    rows = max(1, CIN_SLAB_BYTES // per_row)
    ws = params["cin_w"]
    if rows >= b:
        return _cin_rows(x0, *ws)
    grad = torch.is_grad_enabled() and (x0.requires_grad
                                        or any(w.requires_grad for w in ws))
    parts = [checkpoint(_cin_rows, x0[s:s + rows], *ws, use_reentrant=False)
             if grad else _cin_rows(x0[s:s + rows], *ws)
             for s in range(0, b, rows)]
    return torch.cat(parts)


def _head(p: dict, emb: torch.Tensor, lin: torch.Tensor,
          cfg: XDeepFMConfig) -> torch.Tensor:
    """The logits [b] of rows whose lookups are ``emb`` [b, m, D] and
    ``lin`` [b, m, 1], from the dense nets of the tree ``p``."""
    b, m, d = emb.shape
    cin_logit = (_cin(p, emb, cfg) @ p["cin_out"])[:, 0]
    mlp_logit = mlp_apply(p["mlp"], emb.reshape(b, m * d))[:, 0]
    return lin[..., 0].sum(-1) + cin_logit + mlp_logit + p["bias"][0]


def _logits(ops, params, ids, cfg: XDeepFMConfig):
    """The forward's math, once: ``ids`` [B, n_sparse] -> logits [B], over
    ``ops`` (:mod:`.sharded`: ``Whole`` on one device, ``OnMesh`` with one
    value per position)."""
    offs = ops.map(lambda i: _field_offsets(cfg, i.device), ids)
    emb = fused_field_lookup(ops.map(lambda p: p["table"], params), offs,
                             ids, ops.shard)                     # [B, m, D]
    lin = fused_field_lookup(ops.map(lambda p: p["linear"], params), offs,
                             ids, ops.shard)                     # [B, m, 1]
    return ops.map(lambda p, e, x: _head(p, e, x, cfg), params, emb, lin)


def xdeepfm_forward(params, batch, cfg: XDeepFMConfig,
                    shard: Sharder | None = None):
    """batch: ids [B, n_sparse] int32 (per-field categorical).  -> logits [B];
    over a mesh a ``ShardedTensor`` over "batch"."""
    ops = mesh_ops(shard)
    params = ops.params(params, xdeepfm_param_specs(cfg))
    return ops.result(_logits(ops, params, ops.rows(batch["ids"]), cfg))


def xdeepfm_loss(params, batch, cfg: XDeepFMConfig, shard: Sharder | None = None):
    """The mean BCE of the logits against ``batch["clicks"]``; over a mesh a
    scalar at its first position."""
    ops = mesh_ops(shard)
    params = ops.params(params, xdeepfm_param_specs(cfg))
    logits = _logits(ops, params, ops.rows(batch["ids"]), cfg)
    return ops.bce(logits, ops.rows(batch["clicks"]))


def xdeepfm_score_candidates(params, batch, cfg: XDeepFMConfig,
                             shard: Sharder | None = None,
                             *, chunk: int = 65_536):
    """retrieval_cand: one user (shared fields) against n_candidates items.

    batch: user_ids [n_user_fields], cand_ids [n_cand, n_item_fields].
    Broadcast-joins the user fields onto every candidate row and scores in
    slabs of ``chunk`` rows, as the reference's ``lax.map`` does (its last
    slab is padded with id 0 and the padding's scores dropped; each row's
    score depends only on that row, so the port scores the last slab
    short).  -> scores [n_cand]; over a mesh a ``ShardedTensor`` over
    "batch", each data group scoring its block (:mod:`.sharded`).
    """
    ops = mesh_ops(shard)
    params = ops.params(params, xdeepfm_param_specs(cfg))
    cand = ops.rows(batch["cand_ids"])
    user = ops.rows(batch["user_ids"], split=False)
    n_cand = batch["cand_ids"].shape[0]
    c = min(chunk, n_cand)
    out = []
    for s in range(-(-n_cand // c)):
        ids = ops.map(lambda u, x: torch.cat(
            [u[None, :].expand(x.shape[0], -1), x], dim=1),
            user, ops.slab(cand, s, c))
        out.append(_logits(ops, params, ids, cfg))
    return ops.result(ops.map(lambda *xs: torch.cat(xs), *out))
