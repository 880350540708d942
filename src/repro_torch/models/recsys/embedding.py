"""EmbeddingBag and the fused per-field lookup (the port of
``repro.models.recsys.embedding``).

``embedding_bag`` follows the torch ``nn.EmbeddingBag`` contract — ragged
bags of indices reduced per bag — built as the reference builds it: a row
gather and a segment reduction by bag id, with the reference's padding
(``total_len``) and weights.  ``fused_field_lookup`` is the recsys fast
path: one fused table for all categorical fields.
"""
from __future__ import annotations

import torch

__all__ = ["embedding_bag", "fused_field_lookup"]


def embedding_bag(
    table: torch.Tensor,          # [vocab, dim]
    indices: torch.Tensor,        # [total_indices]  flat bag contents
    offsets: torch.Tensor,        # [n_bags]         start of each bag
    *,
    mode: str = "sum",
    per_sample_weights: torch.Tensor | None = None,
    total_len: int | None = None,
) -> torch.Tensor:
    """Bag-reduce rows of ``table``: out[b] = reduce(table[indices[bag b]]).

    ``offsets`` follows the torch convention (monotone starts, last bag runs
    to the end).  ``indices`` may be padded; pass ``total_len`` as the true
    length when padded (padding lanes are dropped).  An empty bag gives 0 in
    every mode.
    """
    if mode not in ("sum", "mean", "max"):
        raise ValueError(f"unknown mode {mode!r}")
    n_bags = offsets.shape[0]
    n_idx = indices.shape[0]
    pos = torch.arange(n_idx, device=indices.device)
    # bag id per index = # offsets <= pos  - 1  (searchsorted on sorted offsets)
    bag = torch.searchsorted(offsets.to(pos.dtype).contiguous(), pos,
                             right=True) - 1
    valid = pos < (total_len if total_len is not None else n_idx)
    rows = table[torch.where(valid, indices.long(), 0)]
    if per_sample_weights is not None:
        rows = rows * per_sample_weights[:, None]
    rows = torch.where(valid[:, None], rows, 0.0)
    tgt = torch.where(valid, bag, n_bags)
    summed = rows.new_zeros((n_bags + 1, rows.shape[1])).index_add(
        0, tgt, rows)[:n_bags]
    if mode == "sum":
        return summed
    if mode == "mean":
        cnt = rows.new_zeros(n_bags + 1).index_add(
            0, tgt, valid.to(rows.dtype))[:n_bags]
        return summed / torch.clamp_min(cnt, 1.0)[:, None]
    rows_m = torch.where(valid[:, None], rows, torch.finfo(rows.dtype).min)
    out = torch.full((n_bags + 1, rows.shape[1]), float("-inf"),
                     dtype=rows.dtype, device=rows.device)
    out = out.scatter_reduce(0, tgt[:, None].expand_as(rows_m), rows_m, "amax",
                             include_self=True)[:n_bags]
    return torch.where(torch.isfinite(out), out, 0.0)


def fused_field_lookup(
    table: torch.Tensor,          # [sum_vocab, dim]
    field_offsets: torch.Tensor,  # [n_fields]        start row of each field
    ids: torch.Tensor,            # [batch, n_fields] per-field categorical id
) -> torch.Tensor:
    """Single-hot per-field lookup into one fused table -> [B, n_fields, dim]."""
    rows = ids.long() + field_offsets[None, :]
    return table[rows]
