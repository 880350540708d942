"""Exact butterfly counting for bipartite window snapshots (the port's copy).

A butterfly is a (2,2)-biclique: vertices {i1, i2} x {j1, j2} with all four
edges present.  With ``A`` the |V_i| x |V_j| 0/1 biadjacency and
``W = A A^T`` the wedge-multiplicity matrix,

    B(G) = sum_{u<v in V_i} C(W_uv, 2).

Two tiers live here, held against ``repro.core.butterfly``:

1. :func:`count_butterflies_np` -- the numpy wedge-hash oracle, int64,
   always exact (a copy of the reference's host code, with its id-range
   guard and pair emission).
2. :func:`count_butterflies_dense` / :func:`count_butterflies_from_edges`
   -- the Gram formulation in torch: a scatter into a dense biadjacency and
   one batched ``torch.matmul``.  It accumulates in float32 like the
   reference with x64 off, so counts are exact while every partial sum stays
   below 2**24.

The hand-written kernel tier (``repro_torch.kernels.butterfly``) computes
the same Gram triangle without materializing ``W``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "count_butterflies_np",
    "build_biadjacency",
    "count_butterflies_dense",
    "count_butterflies_from_edges",
]


# ---------------------------------------------------------------------------
# numpy oracle tier (host, always exact, independent algorithm)
# ---------------------------------------------------------------------------

_MAX_ID = np.int64(1) << 32  # ids pack two-per-int64 key: each must fit 32 bits


def _check_id_range_np(e: np.ndarray) -> None:
    """Host paths pack (a, b) id pairs into one int64 sort key (``a << 32 |
    b``).  The key is injective for ids in ``[0, 2**32)`` (numpy's int64
    shift wraps deterministically, mapping a/b onto disjoint halves of the
    64-bit pattern), but an id >= 2**32 wraps onto another id's key and a
    negative id smears its sign bits over the other half — either silently
    *collides* distinct pairs and corrupts counts.  Fail loudly instead."""
    if e.size and (int(e.min()) < 0 or int(e.max()) >= _MAX_ID):
        raise ValueError(
            "vertex ids must be in [0, 2**32): got range "
            f"[{int(e.min())}, {int(e.max())}] — ids outside it silently "
            "collide in the packed int64 wedge/edge keys; relabel to a "
            "compact id space first (e.g. np.unique(..., "
            "return_inverse=True))")


def _dedupe_edges_np(edges: np.ndarray) -> np.ndarray:
    """Drop duplicate (i, j) pairs, preserving nothing about order."""
    if edges.size == 0:
        return edges.reshape(0, 2).astype(np.int64)
    e = np.asarray(edges, dtype=np.int64)
    _check_id_range_np(e)
    key = e[:, 0] << 32 | e[:, 1]
    _, idx = np.unique(key, return_index=True)
    return e[np.sort(idx)]


def _group_pairs_np(starts: np.ndarray, counts: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """All within-group index pairs (p, t) with p < t, fully vectorized.

    ``starts``/``counts`` describe contiguous groups of a sorted array; every
    element pairs with each *earlier* element of its group (rank r emits r
    pairs), so a group of size c emits C(c, 2) pairs total.  This replaces
    the per-hub ``np.triu_indices`` Python loop — the pair-emission cost is
    one ``repeat`` + arithmetic over the output size.
    """
    m = int(counts.sum())
    start_pos = np.repeat(starts, counts)                    # group start per row
    r = np.arange(m, dtype=np.int64) - start_pos             # rank within group
    total = int(r.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    t = np.repeat(np.arange(m, dtype=np.int64), r)           # later element
    off = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(r) - r, r)
    p = start_pos[t] + off                                   # earlier element
    return p, t


def count_butterflies_np(edges: np.ndarray) -> int:
    """Exact butterfly count via wedge aggregation (sort-based, int64).

    ``edges`` is an (m, 2) int array of (i, j) endpoints.  Duplicate edges are
    ignored, mirroring the paper's duplicate-insertion semantics.  Algorithm:
    every j-vertex of degree d contributes C(d, 2) wedges (i1, i2); butterflies
    are pairs of wedges with identical endpoints:  B = sum_p C(mult_p, 2).
    This is the same arithmetic as Alg. 1 but organised for vectorised numpy —
    wedge emission is one vectorized ``repeat`` (:func:`_group_pairs_np`),
    never a Python loop over hubs.  Ids must lie in ``[0, 2**32)`` (raises
    otherwise: larger ids would collide in the packed int64 wedge keys).
    """
    e = _dedupe_edges_np(np.asarray(edges))
    if e.shape[0] < 4:
        return 0
    # Group i-neighbors by j: sort by j then i.
    order = np.lexsort((e[:, 0], e[:, 1]))
    i_sorted = e[order, 0]
    j_sorted = e[order, 1]
    _, starts = np.unique(j_sorted, return_index=True)
    counts = np.diff(np.append(starts, j_sorted.shape[0]))
    # Wedge endpoints for each j-group: all pairs within the group.  In-group
    # i is sorted ascending and deduped, so i_sorted[p] < i_sorted[t].
    p, t = _group_pairs_np(starts, counts)
    if p.size == 0:
        return 0
    keys = i_sorted[p] << 32 | i_sorted[t]
    _, mult = np.unique(keys, return_counts=True)
    mult = mult.astype(np.int64)
    return int((mult * (mult - 1) // 2).sum())


# ---------------------------------------------------------------------------
# torch dense tier
# ---------------------------------------------------------------------------

def build_biadjacency(
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    valid: torch.Tensor,
    n_i: int,
    n_j: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Scatter padded edge lists into dense 0/1 biadjacencies.

    ``edge_i`` / ``edge_j`` / ``valid`` are ``[cap_e]`` (one window) or
    ``[B, cap_e]`` (a stack); the result is ``[n_i, n_j]`` or
    ``[B, n_i, n_j]``, contiguous.  Duplicate edges collapse (every write
    stores 1), reproducing the paper's duplicate-ignoring semantics.
    Invalid (padding) lanes and ids outside ``[0, n_i) x [0, n_j)`` are
    routed to one sacrificial slot past the end of the buffer, which is
    sliced off: the reference's ``mode="drop"`` scatter, without the
    out-of-range index a torch scatter would reject (and a CUDA device
    assert that would kill the context).  No host synchronization.
    """
    single = edge_i.dim() == 1
    ei = edge_i.reshape(-1, edge_i.shape[-1]).long()
    ej = edge_j.reshape(-1, edge_j.shape[-1]).long()
    ok = valid.reshape(-1, valid.shape[-1]).bool()
    ok = ok & (ei >= 0) & (ei < n_i) & (ej >= 0) & (ej < n_j)
    n_win = ei.shape[0]
    plane = n_i * n_j
    base = torch.arange(n_win, device=ei.device).unsqueeze(1) * plane
    flat = torch.where(ok, base + ei * n_j + ej, n_win * plane)
    buf = torch.zeros(n_win * plane + 1, dtype=dtype, device=ei.device)
    buf[flat.reshape(-1)] = 1
    adj = buf[:-1].view(n_win, n_i, n_j)
    return adj[0] if single else adj


def count_butterflies_dense(adj: torch.Tensor) -> torch.Tensor:
    """B = sum_{u<v} C((A A^T)_uv, 2) on dense biadjacencies ``[..., n_i,
    n_j]`` -> ``[...]`` float32.

    The Gram side is whichever side is smaller (the paper iterates the
    lower-degree side; with the Gram trick that is a transpose decision).
    The matmul runs in full float32: TF32 is switched off around it and the
    caller's setting restored after.  0/1 operands are exact in TF32 too,
    but the reference states float32 arithmetic, so the port runs the same.
    """
    a = adj.to(torch.float32)
    if a.shape[-2] > a.shape[-1]:
        a = a.transpose(-2, -1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        w = torch.matmul(a, a.transpose(-2, -1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    pairs = w * (w - 1.0) * 0.5
    off = pairs.sum(dim=(-2, -1)) - torch.diagonal(
        pairs, dim1=-2, dim2=-1).sum(dim=-1)
    return off * 0.5


def count_butterflies_from_edges(
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    valid: torch.Tensor,
    n_i: int,
    n_j: int,
) -> torch.Tensor:
    """Count butterflies directly from padded edge lists (one window
    ``[cap_e]`` -> scalar, or a stack ``[B, cap_e]`` -> ``[B]``)."""
    adj = build_biadjacency(edge_i, edge_j, valid, n_i, n_j)
    return count_butterflies_dense(adj)
