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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...distributed.sharding import Sharder
from ..common import (
    bce_with_logits,
    dense_init,
    mlp_apply,
    mlp_init,
    param_device,
    seeded_split,
)
from .embedding import fused_field_lookup

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
    its weights as one GEMM; the stacks are kept as [b, D, H]."""
    b, m, d = x0.shape
    x0t = x0.transpose(1, 2)                 # [b, D, m]
    xs = []
    xk = x0t
    for w in cin_w:
        # z[b,h,d] = sum_{i,j} w[h,i,j] x_k[b,i,d] x_0[b,j,d]
        outer = (xk[..., :, None] * x0t[..., None, :]).reshape(b * d, -1)
        xk = F.relu(outer @ w.reshape(w.shape[0], -1).T).reshape(b, d, -1)
        xs.append(xk.sum(dim=1))             # sum pooling over D
    return torch.cat(xs, dim=-1)


def _cin(params, x0, cfg: XDeepFMConfig, shard: Sharder):
    """x0 [B, m, D] -> concat of per-layer sum-pooled features [B, sum(H_k)],
    in slabs of rows whose outer product fits :data:`CIN_SLAB_BYTES`.  The reference constrains each layer's stack
    to the batch axis; the port constrains the input once (a no-op without
    a mesh)."""
    x0 = shard.act(x0, "batch", None, None)
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


def xdeepfm_forward(params, batch, cfg: XDeepFMConfig,
                    shard: Sharder | None = None):
    """batch: ids [B, n_sparse] int32 (per-field categorical).  -> logits [B]."""
    shard = shard or Sharder(None)
    ids = batch["ids"]
    b = ids.shape[0]
    offs = _field_offsets(cfg, ids.device)
    emb = fused_field_lookup(params["table"], offs, ids)       # [B, m, D]
    emb = shard.act(emb, "batch", None, None)
    lin = fused_field_lookup(params["linear"], offs, ids)[..., 0].sum(-1)  # [B]
    cin_feat = _cin(params, emb, cfg, shard)                   # [B, sum(H)]
    cin_logit = (cin_feat @ params["cin_out"])[:, 0]
    mlp_logit = mlp_apply(params["mlp"], emb.reshape(b, -1))[:, 0]
    return lin + cin_logit + mlp_logit + params["bias"][0]


def xdeepfm_loss(params, batch, cfg: XDeepFMConfig, shard: Sharder | None = None):
    logits = xdeepfm_forward(params, batch, cfg, shard)
    return bce_with_logits(logits, batch["clicks"])


def xdeepfm_score_candidates(params, batch, cfg: XDeepFMConfig,
                             shard: Sharder | None = None,
                             *, chunk: int = 65_536):
    """retrieval_cand: one user (shared fields) against n_candidates items.

    batch: user_ids [n_user_fields], cand_ids [n_cand, n_item_fields].
    Broadcast-joins the user fields onto every candidate row and scores in
    slabs of ``chunk`` rows, as the reference's ``lax.map`` does (its last
    slab is padded with id 0 and the padding's scores dropped; each row's
    score depends only on that row, so the port scores the last slab
    short).  -> scores [n_cand].
    """
    shard = shard or Sharder(None)
    cand = batch["cand_ids"]
    user = batch["user_ids"]
    n_cand = cand.shape[0]
    c = min(chunk, n_cand)
    out = []
    for s in range(0, n_cand, c):
        slab = cand[s:s + c]
        ids = torch.cat([user[None, :].expand(slab.shape[0], -1), slab], dim=1)
        ids = shard.act(ids, "batch", None)
        out.append(xdeepfm_forward(params, {"ids": ids}, cfg, shard))
    return torch.cat(out)
