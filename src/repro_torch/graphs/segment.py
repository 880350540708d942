"""Message-passing primitives on edge lists via segment reductions (the
port of ``repro.graphs.segment``).

Message passing is gather -> transform -> segment-reduce over an edge
index, as in the reference.  Sums are ``index_add``, maxima
``scatter_reduce("amax")`` from ``-inf`` (or the integer minimum), so an
empty segment gives what ``jax.ops.segment_max`` gives before the
reference maps it to 0.  On the card both sum with atomics, in an order
that changes from run to run, so a result there is held within an rtol,
not bit for bit.  Padding is routed to an extra segment ``num_segments``
that is sliced off, as the reference's ``_masked_targets`` does.  Segment
ids must lie in ``[0, num_segments)`` (XLA drops ids outside; torch
raises).
"""
from __future__ import annotations

import torch

__all__ = [
    "segment_sum", "segment_mean", "segment_max", "segment_softmax",
    "gather_scatter", "degrees",
]


def _masked_targets(dst: torch.Tensor, mask: torch.Tensor | None,
                    num_segments: int) -> torch.Tensor:
    dst = dst.long()
    if mask is None:
        return dst
    return torch.where(mask, dst, num_segments)  # padding routed out of range


def _segment_sum(data: torch.Tensor, tgt: torch.Tensor, n: int) -> torch.Tensor:
    out = data.new_zeros((n, *data.shape[1:]))
    return out.index_add(0, tgt, data)


def _segment_amax(data: torch.Tensor, tgt: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment maximum, ``-inf`` (the integer minimum) where a segment is
    empty: ``jax.ops.segment_max``."""
    lo = float("-inf") if data.is_floating_point() else torch.iinfo(data.dtype).min
    out = torch.full((n, *data.shape[1:]), lo, dtype=data.dtype,
                     device=data.device)
    idx = tgt.view(-1, *([1] * (data.ndim - 1))).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=True)


def segment_sum(data, dst, num_segments: int, mask=None):
    """Scatter-add ``data`` rows into ``num_segments`` buckets by ``dst``."""
    tgt = _masked_targets(dst, mask, num_segments)
    n = num_segments + (1 if mask is not None else 0)
    return _segment_sum(data, tgt, n)[:num_segments]


def segment_mean(data, dst, num_segments: int, mask=None):
    s = segment_sum(data, dst, num_segments, mask)
    ones = torch.ones(data.shape[:1], dtype=data.dtype, device=data.device)
    cnt = segment_sum(ones, dst, num_segments, mask)
    return s / torch.clamp_min(cnt, 1.0)[(...,) + (None,) * (data.ndim - 1)]


def segment_max(data, dst, num_segments: int, mask=None):
    """Per-segment maximum; 0 for an empty segment (and, as the reference,
    for a non-finite float maximum or an integer one at the dtype's
    minimum)."""
    tgt = _masked_targets(dst, mask, num_segments)
    n = num_segments + (1 if mask is not None else 0)
    out = _segment_amax(data, tgt, n)[:num_segments]
    if data.is_floating_point():
        keep = torch.isfinite(out)
    else:
        keep = out > torch.iinfo(data.dtype).min
    return torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def segment_softmax(logits, dst, num_segments: int, mask=None):
    """Edge softmax: normalize edge logits over incoming edges per dst node.

    ``logits`` may be [E] or [E, H] (multi-head); ``mask`` is [E].  The
    per-segment maximum only shifts each segment's logits, which leaves the
    softmax and its gradient unchanged, so it is taken without a gradient.
    """
    tgt = _masked_targets(dst, mask, num_segments)
    n = num_segments + (1 if mask is not None else 0)
    mx = _segment_amax(logits.detach(), tgt, n)
    mx = torch.where(torch.isneginf(mx), torch.zeros((), dtype=mx.dtype,
                                                     device=mx.device), mx)
    z = torch.exp(logits - mx[tgt])
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (z.ndim - mask.ndim))
        z = torch.where(m, z, torch.zeros((), dtype=z.dtype, device=z.device))
    denom = _segment_sum(z, tgt, n)
    return z / torch.clamp_min(denom[tgt], 1e-9)


def gather_scatter(node_feats, src, dst, num_nodes: int, *, msg_fn=None,
                   mask=None, reduce: str = "sum"):
    """The canonical GNN primitive: gather src features, transform, scatter to dst."""
    msgs = node_feats[src.long()]
    if msg_fn is not None:
        msgs = msg_fn(msgs)
    red = {"sum": segment_sum, "mean": segment_mean, "max": segment_max}[reduce]
    return red(msgs, dst, num_nodes, mask)


def degrees(dst, num_nodes: int, mask=None, dtype=torch.float32):
    ones = torch.ones(dst.shape, dtype=dtype, device=dst.device)
    return segment_sum(ones, dst, num_nodes, mask)
