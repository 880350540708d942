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

Over a mesh (:func:`segment_sum_mesh`, :func:`segment_mean_mesh`,
:func:`segment_softmax_mesh`) the edges are split in blocks over mesh
positions, one list entry per position: each position computes the
reduction over its own edges, a partial over every segment, with the
functions above, and the partials are brought together as GSPMD brings
them together: a sum reduce-scattered to the segments' blocks (or, with
``to="all"``, all-reduced), a mean's sum and count both so, a softmax's
maximum by ``pmax`` and its denominator by ``psum``.  The float32
partials are added at the group's first position in position order
(``distributed.collectives``).
"""
from __future__ import annotations

import torch

__all__ = [
    "segment_sum", "segment_mean", "segment_max", "segment_softmax",
    "gather_scatter", "degrees", "segment_sum_mesh", "segment_mean_mesh",
    "segment_softmax_mesh",
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
    z = _softmax_numerator(logits, _finite_max(
        _segment_amax(logits.detach(), tgt, n)), tgt, mask)
    return _softmax_ratio(z, _segment_sum(z, tgt, n), tgt)


def _finite_max(mx: torch.Tensor) -> torch.Tensor:
    """A segment maximum with empty segments' ``-inf`` as 0."""
    return torch.where(torch.isneginf(mx), torch.zeros((), dtype=mx.dtype,
                                                       device=mx.device), mx)


def _softmax_numerator(logits, mx, tgt, mask) -> torch.Tensor:
    """``exp(logits - mx[tgt])``, zero at masked edges."""
    z = torch.exp(logits - mx[tgt])
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (z.ndim - mask.ndim))
        z = torch.where(m, z, torch.zeros((), dtype=z.dtype, device=z.device))
    return z


def _softmax_ratio(z, denom, tgt) -> torch.Tensor:
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


# -- over a mesh --------------------------------------------------------------

def segment_sum_mesh(data: list, dst: list, num_segments: int, mesh, axes,
                     mask: list | None = None, *, to: str = "blocks") -> list:
    """:func:`segment_sum` over ``mesh``: ``data[p]``, ``dst[p]`` (and
    ``mask[p]``) are position ``p``'s edges, on its device; ``axes`` the
    mesh axes the edges split over.  Each position's partial over every
    segment is summed over ``axes`` in position order: reduce-scattered
    (``to="blocks"``, position ``p`` getting its block of
    ``shard_bounds(num_segments, k)``) or all-reduced (``to="all"``, the
    whole sum at every position)."""
    from ..distributed.collectives import each_position, psum, reduce_scatter

    if to not in ("blocks", "all"):
        raise ValueError(f"to must be 'blocks' or 'all', got {to!r}")
    masks = [None] * mesh.size if mask is None else mask
    parts = each_position(
        mesh, lambda x, d, m: segment_sum(x, d, num_segments, m), data, dst,
        masks)
    if to == "all":
        return psum(parts, mesh, axes)
    return reduce_scatter(parts, mesh, axes, 0)


def segment_mean_mesh(data: list, dst: list, num_segments: int, mesh, axes,
                      mask: list | None = None) -> list:
    """:func:`segment_mean` over ``mesh``: the sum and the count each
    reduce-scattered to the segments' blocks (:func:`segment_sum_mesh`),
    then divided at each position."""
    from ..distributed.collectives import each_position

    s = segment_sum_mesh(data, dst, num_segments, mesh, axes, mask)
    ones = each_position(mesh, lambda x: torch.ones(
        x.shape[:1], dtype=x.dtype, device=x.device), data)
    cnt = segment_sum_mesh(ones, dst, num_segments, mesh, axes, mask)
    lift = (...,) + (None,) * (data[0].ndim - 1)
    return each_position(mesh, lambda a, c: a / torch.clamp_min(c, 1.0)[lift],
                         s, cnt)


def segment_softmax_mesh(logits: list, dst: list, num_segments: int, mesh,
                         axes, mask: list | None = None) -> list:
    """:func:`segment_softmax` over ``mesh``, each position's edges
    normalised over every position's edges into their segment: the
    partial maxima (padding's segment included) all-reduced by ``pmax``,
    each position's numerators, their partial sums all-reduced by
    ``psum``, and each position's ratios.  Returns each position's
    ``[E_p, ...]`` weights."""
    from ..distributed.collectives import each_position as each, pmax, psum

    n = num_segments + (1 if mask is not None else 0)
    masks = [None] * mesh.size if mask is None else mask
    tgt = each(mesh, lambda d, m: _masked_targets(d, m, num_segments), dst,
               masks)
    mx = pmax(each(mesh, lambda lg, t: _segment_amax(lg.detach(), t, n),
                   logits, tgt), mesh, axes)
    z = each(mesh, lambda lg, m, t, mk: _softmax_numerator(
        lg, _finite_max(m), t, mk), logits, mx, tgt, masks)
    denom = psum(each(mesh, lambda x, t: _segment_sum(x, t, n), z, tgt),
                 mesh, axes)
    return each(mesh, _softmax_ratio, z, denom, tgt)
