"""Exact butterfly counting for bipartite window snapshots (the port's copy).

A butterfly is a (2,2)-biclique: vertices {i1, i2} x {j1, j2} with all four
edges present.  With ``A`` the |V_i| x |V_j| 0/1 biadjacency and
``W = A A^T`` the wedge-multiplicity matrix,

    B(G) = sum_{u<v in V_i} C(W_uv, 2).

The tiers here are held against ``repro.core.butterfly``:

1. :func:`count_butterflies_np` -- the numpy wedge-hash oracle, int64,
   always exact (a copy of the reference's host code, with its id-range
   guard and pair emission); :func:`count_butterflies_multiset_np` is its
   multiplicity-weighted twin.
2. :func:`count_butterflies_dense` / :func:`count_butterflies_from_edges`
   -- the Gram formulation in torch: a scatter into a dense biadjacency and
   one batched ``torch.matmul``.  It accumulates in float32 like the
   reference with x64 off, so counts are exact while every partial sum stays
   below 2**24.
3. :func:`count_butterflies_tiled` -- the same Gram in row-block pairs (a
   Python loop of batched matmuls where the reference scans), so only one
   ``tile x tile`` block of ``W`` exists at a time.
4. :func:`count_butterflies_sparse` -- wedge sort and rank aggregation over
   the padded edge lists, batched over windows; O(cap_e + wedge_cap)
   memory per window and no biadjacency.

**Multiset counting.**  The ``*_multiset`` twins count
multiplicity-weighted butterflies: an edge of multiplicity ``m`` behaves
like ``m`` parallel copies.  With ``W = A A^T`` and ``S = (A∘A)(A∘A)^T``
over the weighted biadjacency ``A[u, j] = mult(u, j)``,

    B_multi = sum_{u<v} (W_uv^2 - S_uv) / 2,

which is ``sum C(W, 2)`` when every multiplicity is 1.  In float32 the
``W^2 - S`` difference cancels: once ``W^2`` or ``S`` passes 2**24 the
count carries the rounding of both terms, as the reference's does.

Every device tier takes a single window (``[cap_e]`` lanes or one
``[n_i, n_j]`` matrix) or a stack of them (a leading window axis) and
returns a scalar or one count per window.  The hand-written kernel tier
(``repro_torch.kernels.butterfly``) computes the Gram triangles without
materializing ``W``.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "count_butterflies_np",
    "count_butterflies_multiset_np",
    "butterfly_delta_np",
    "window_wedge_counts_np",
    "build_biadjacency",
    "build_biadjacency_multiset",
    "build_biadjacency_limbs",
    "limb_block_masks",
    "MASK_ROWS",
    "n_limbs",
    "split_limbs",
    "join_limbs",
    "count_butterflies_dense",
    "count_butterflies_dense_multiset",
    "count_butterflies_from_edges",
    "count_butterflies_from_edges_multiset",
    "count_butterflies_sampled_from_edges",
    "snapshot_count",
    "Snapshot",
    "enumerate_butterflies_np",
    "butterfly_support_np",
    "count_caterpillars_np",
    "butterfly_support_dense",
    "full_fp32_matmul",
    "count_butterflies_tiled",
    "count_butterflies_tiled_multiset",
    "count_butterflies_sparse",
    "count_butterflies_sparse_multiset",
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


def count_butterflies_multiset_np(edges: np.ndarray,
                                  mult: np.ndarray) -> int:
    """Multiplicity-weighted butterfly count, numpy oracle (int64 exact).

    ``edges`` is an (m, 2) int array of *unique* (i, j) pairs and ``mult``
    their positive multiplicities (duplicate rows are aggregated by summing
    their multiplicities, so pre-resolution edge lists are also accepted).
    A wedge (i1, i2) through hub j weighs ``mult(i1, j) * mult(i2, j)``;
    butterflies on a wedge endpoint pair are all unordered hub pairs, so

        B = sum_pairs (S^2 - S2) / 2,   S = sum_j w_j,  S2 = sum_j w_j^2

    which reduces to ``sum C(mult, 2)`` of :func:`count_butterflies_np`
    when every multiplicity is 1.  Ids must lie in ``[0, 2**32)``.
    """
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    m = np.asarray(mult, dtype=np.int64).reshape(-1)
    if e.shape[0] != m.shape[0]:
        raise ValueError(
            f"edges/mult length mismatch: {e.shape[0]} != {m.shape[0]}")
    if m.size and int(m.min()) < 1:
        raise ValueError("multiplicities must be >= 1")
    if e.shape[0] == 0:
        return 0
    _check_id_range_np(e)
    # aggregate duplicate (i, j) rows (net multiplicity per unique edge)
    key = e[:, 0] << 32 | e[:, 1]
    uk, inv = np.unique(key, return_inverse=True)
    um = np.zeros(uk.shape[0], dtype=np.int64)
    np.add.at(um, inv, m)
    if uk.shape[0] < 4:
        return 0
    ei = uk >> 32
    ej = uk & np.int64(0xFFFFFFFF)
    # group i-neighbors by j (sorted by (j, i)); emit weighted wedges
    order = np.lexsort((ei, ej))
    i_sorted, j_sorted, m_sorted = ei[order], ej[order], um[order]
    _, starts = np.unique(j_sorted, return_index=True)
    counts = np.diff(np.append(starts, j_sorted.shape[0]))
    p, t = _group_pairs_np(starts, counts)
    if p.size == 0:
        return 0
    w = m_sorted[p] * m_sorted[t]
    keys = i_sorted[p] << 32 | i_sorted[t]
    _, winv = np.unique(keys, return_inverse=True)
    s1 = np.zeros(int(winv.max()) + 1, dtype=np.int64)
    s2 = np.zeros_like(s1)
    np.add.at(s1, winv, w)
    np.add.at(s2, winv, w * w)
    return int(((s1 * s1 - s2) // 2).sum())


def butterfly_delta_np(edges: np.ndarray, deleted: np.ndarray) -> int:
    """Butterflies destroyed by deleting ``deleted`` edges from the distinct
    graph ``edges`` (the decremental half of Abacus's insert/delete
    symmetry).  Deletions process sequentially; each deleted edge (u, x)
    destroys exactly the butterflies containing it in the *current* graph:

        sum over v in N(x), v != u  of  (|N(u) ∩ N(v)| - 1)

    Returns ``B(edges) - B(edges \\ deleted)`` as an exact int.  Each
    deleted edge must be present and not already deleted; raises
    ``ValueError`` otherwise.
    """
    e = _dedupe_edges_np(np.asarray(edges))
    d = np.asarray(deleted, dtype=np.int64).reshape(-1, 2)
    adj_i: dict[int, set[int]] = {}
    adj_j: dict[int, set[int]] = {}
    for u, x in e:
        adj_i.setdefault(int(u), set()).add(int(x))
        adj_j.setdefault(int(x), set()).add(int(u))
    total = 0
    for u, x in d:
        u, x = int(u), int(x)
        if x not in adj_i.get(u, ()):  # never inserted or already deleted
            raise ValueError(
                f"cannot delete absent edge ({u}, {x}); deletions must name "
                "a present edge")
        nu = adj_i[u]
        for v in adj_j[x]:
            if v != u:
                total += len(nu & adj_i[v]) - 1
        nu.remove(x)
        adj_j[x].remove(u)
    return total


def window_wedge_counts_np(edge_i: np.ndarray, edge_j: np.ndarray,
                           valid: np.ndarray) -> np.ndarray:
    """Deduped wedge count per window, host-side: ``sum_j C(d_j, 2)`` over
    each window's valid lanes -- what the sparse tier needs a static
    capacity for, and the sparse term of the ``auto`` router's cost model.
    ``edge_i``/``edge_j``/``valid`` are the padded ``[n_windows, capacity]``
    window lanes (compact non-negative ids)."""
    ei = np.asarray(edge_i, dtype=np.int64)
    ej = np.asarray(edge_j, dtype=np.int64)
    v = np.asarray(valid, dtype=bool)
    out = np.zeros(ei.shape[0], dtype=np.int64)
    if ei.size == 0:
        return out
    span = max(int(ej.max()), 0) + 1
    for k in range(ei.shape[0]):
        i, j = ei[k][v[k]], ej[k][v[k]]
        if i.size < 2:
            continue
        keys = np.unique(i * span + j)          # dedupe (i, j) pairs
        d = np.bincount(keys % span)
        out[k] = int((d * (d - 1) // 2).sum())
    return out


def enumerate_butterflies_np(edges: np.ndarray) -> np.ndarray:
    """Enumerate distinct butterflies as (i1, i2, j1, j2) rows (i1<i2, j1<j2).

    Used by the SS3 analysis (hub membership, inter-arrival).  Only meant
    for small snapshots (the paper itself caps at 5000 sgrs).
    """
    e = _dedupe_edges_np(np.asarray(edges))
    if e.shape[0] < 4:
        return np.zeros((0, 4), dtype=np.int64)
    order = np.lexsort((e[:, 0], e[:, 1]))
    i_sorted, j_sorted = e[order, 0], e[order, 1]
    _, starts = np.unique(j_sorted, return_index=True)
    counts = np.diff(np.append(starts, j_sorted.shape[0]))
    # wedges (i1 < i2, hub j)
    p, t = _group_pairs_np(starts, counts)
    if p.size == 0:
        return np.zeros((0, 4), dtype=np.int64)
    w1, w2, wj = i_sorted[p], i_sorted[t], j_sorted[t]
    # butterflies: pairs of wedges sharing (i1, i2); sorting by (key, j)
    # keeps each key group's hubs ascending, so j1 < j2
    key = w1 << 32 | w2
    order2 = np.lexsort((wj, key))
    key_s, wj_s = key[order2], wj[order2]
    w1_s, w2_s = w1[order2], w2[order2]
    _, kstarts = np.unique(key_s, return_index=True)
    kcounts = np.diff(np.append(kstarts, key_s.shape[0]))
    p2, t2 = _group_pairs_np(kstarts, kcounts)
    if p2.size == 0:
        return np.zeros((0, 4), dtype=np.int64)
    return np.stack([w1_s[t2], w2_s[t2], wj_s[p2], wj_s[t2]], axis=1)


def butterfly_support_np(edges: np.ndarray, n_i: int,
                         n_j: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex butterfly support (Algorithm 2 semantics), int64 numpy
    oracle: how many butterflies each i- and j-vertex belongs to."""
    quads = enumerate_butterflies_np(edges)
    sup_i = np.zeros(n_i, dtype=np.int64)
    sup_j = np.zeros(n_j, dtype=np.int64)
    if quads.shape[0]:
        np.add.at(sup_i, quads[:, 0], 1)
        np.add.at(sup_i, quads[:, 1], 1)
        np.add.at(sup_j, quads[:, 2], 1)
        np.add.at(sup_j, quads[:, 3], 1)
    return sup_i, sup_j


def count_caterpillars_np(edges: np.ndarray) -> int:
    """Three-paths (caterpillars): sum over distinct edges of (deg_i - 1)
    (deg_j - 1), for the bipartite clustering coefficient 4B /
    caterpillars (SS1)."""
    e = _dedupe_edges_np(np.asarray(edges))
    if e.shape[0] == 0:
        return 0
    di = np.bincount(e[:, 0])
    dj = np.bincount(e[:, 1])
    return int(((di[e[:, 0]] - 1) * (dj[e[:, 1]] - 1)).sum())


# ---------------------------------------------------------------------------
# torch dense and tiled tiers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def full_fp32_matmul():
    """Run CUDA float32 matmuls in full float32: TF32 is cleared for the
    block and the caller's setting restored after.  The reference states
    float32 arithmetic; TF32 would round multiplicities past 2**11."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _flat_slots(edge_i, edge_j, valid, n_i: int, n_j: int):
    """Lanes ``[cap_e]`` or ``[B, cap_e]`` -> ``(flat, ok, n_win, single)``:
    each lane's slot in a flat ``[B * n_i * n_j + 1]`` buffer.  Invalid
    (padding) lanes and ids outside ``[0, n_i) x [0, n_j)`` go to the one
    sacrificial slot past the end, which the caller slices off: the
    reference's ``mode="drop"`` scatter, without the out-of-range index a
    torch scatter would reject (and a CUDA device assert that would kill
    the context).  No host synchronization."""
    single = edge_i.dim() == 1
    ei = edge_i.reshape(-1, edge_i.shape[-1]).long()
    ej = edge_j.reshape(-1, edge_j.shape[-1]).long()
    ok = valid.reshape(-1, valid.shape[-1]).bool()
    ok = ok & (ei >= 0) & (ei < n_i) & (ej >= 0) & (ej < n_j)
    n_win = ei.shape[0]
    plane = n_i * n_j
    base = torch.arange(n_win, device=ei.device).unsqueeze(1) * plane
    flat = torch.where(ok, base + ei * n_j + ej, n_win * plane)
    return flat, ok, n_win, single


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
    Invalid lanes are dropped through the sacrificial slot of
    :func:`_flat_slots`.
    """
    flat, _, n_win, single = _flat_slots(edge_i, edge_j, valid, n_i, n_j)
    buf = torch.zeros(n_win * n_i * n_j + 1, dtype=dtype, device=flat.device)
    buf[flat.reshape(-1)] = 1
    adj = buf[:-1].view(n_win, n_i, n_j)
    return adj[0] if single else adj


def build_biadjacency_multiset(
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    mult: torch.Tensor,
    valid: torch.Tensor,
    n_i: int,
    n_j: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Scatter padded (edge, multiplicity) lanes into *weighted*
    biadjacencies ``A[u, j] = mult(u, j)`` (``[n_i, n_j]`` or
    ``[B, n_i, n_j]``).

    Edges are expected unique per window (the engine resolves duplicates to
    net multiplicities at window close); a repeated (i, j) lane adds, which
    keeps the sum-of-multiplicities semantics either way.  The add is
    float32 on integer weights below 2**24, so it is exact in any order
    (CUDA's atomics included).  Invalid lanes go to the sacrificial slot.
    """
    flat, ok, n_win, single = _flat_slots(edge_i, edge_j, valid, n_i, n_j)
    w = torch.where(ok, mult.reshape(ok.shape).to(dtype),
                    torch.zeros((), dtype=dtype, device=flat.device))
    buf = torch.zeros(n_win * n_i * n_j + 1, dtype=dtype, device=flat.device)
    buf.index_add_(0, flat.reshape(-1), w.reshape(-1))
    adj = buf[:-1].view(n_win, n_i, n_j)
    return adj[0] if single else adj


def n_limbs(max_value: int) -> int:
    """How many uint8 limbs (base-256 digits) hold every non-negative
    integer up to ``max_value``: ``ceil(bits(max_value) / 8)``, 0 for 0."""
    return -(-int(max_value).bit_length() // 8)


def _limbs(m: torch.Tensor, lw: int, ls: int):
    """``(plane, limb)`` for the limbs of the int64 multiplicities ``m``:
    planes ``0 .. lw - 1`` hold the base-256 digits of ``m``, planes
    ``lw .. lw + ls - 1`` those of ``m * m``; each limb is int64 in
    ``[0, 256)``."""
    x = m * m
    for p in range(lw):
        yield p, (m >> (8 * p)) & 255
    for p in range(ls):
        yield lw + p, (x >> (8 * p)) & 255


def _row_bytes(n_j: int) -> int:
    """Row length of a limb plane: ``n_j`` rounded up to 16 bytes, the row
    stride TMA takes (the executor's capacities already are)."""
    return -(-n_j // 16) * 16


# rows per block of the limb masks: K2's TMA box height
# (kBoxRows in kernels/butterfly/csrc/butterfly_windows_multiset_wgmma.cu)
MASK_ROWS = 64


def build_biadjacency_limbs(
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    mult: torch.Tensor,
    valid: torch.Tensor,
    n_i: int,
    n_j: int,
    lw: int,
    ls: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter padded (edge, multiplicity) lanes straight into the uint8
    limb planes of the weighted biadjacency and their block masks.

    Planes: ``[B, lw + ls, n_i, k]`` (``[lw + ls, n_i, k]`` for one window),
    ``k = n_j`` rounded up to 16, zero past ``n_j``.  Plane ``p < lw`` is
    digit ``p`` (base 256) of ``A[u, j] = mult(u, j)``, plane ``lw + p``
    digit ``p`` of ``A[u, j]^2``, so ``A = sum_p 256^p a_p`` exactly while
    every multiplicity is below ``256^lw`` and its square below ``256^ls``
    (:func:`n_limbs`).  Masks: ``[B, ceil(n_i / 64)]`` int32 (``[...]`` for
    one window), bit ``P`` set where plane ``P`` holds a nonzero byte in
    those 64 rows, as :func:`limb_block_masks` computes from the planes.

    The lanes of a window must name distinct edges, as the engine resolves
    them (net multiplicities at window close): each lane stores its limbs,
    so a repeated lane is not added as :func:`build_biadjacency_multiset`
    adds it.  Invalid lanes and ids out of range are dropped, as there.
    """
    single = edge_i.dim() == 1
    _, ok, n_win, _ = _flat_slots(edge_i, edge_j, valid, n_i, n_j)
    ei = edge_i.reshape(ok.shape).long()
    ej = edge_j.reshape(ok.shape).long()
    m = torch.where(ok, mult.reshape(ok.shape).long(),
                    torch.zeros((), dtype=torch.long, device=ok.device))
    k = _row_bytes(n_j)
    plane = n_i * k
    n_planes = lw + ls
    size = n_win * n_planes * plane
    win = torch.arange(n_win, device=ok.device).unsqueeze(1)
    slot = torch.where(ok, win * (n_planes * plane) + ei * k + ej, size)
    buf = torch.zeros(size + 1, dtype=torch.uint8, device=ok.device)
    n_blocks = -(-n_i // MASK_ROWS)
    flags_size = n_win * n_blocks * n_planes
    block = (win * n_blocks + ei // MASK_ROWS) * n_planes
    flags = torch.zeros(flags_size + 1, dtype=torch.int32, device=ok.device)
    for p, limb in _limbs(m, lw, ls):
        buf[torch.where(ok, slot + p * plane, size).reshape(-1)] = (
            limb.reshape(-1).to(torch.uint8))
        flags[torch.where(ok & (limb != 0), block + p, flags_size)] = 1
    planes = buf[:-1].view(n_win, n_planes, n_i, k)
    masks = _pack_bits(flags[:-1].view(n_win, n_blocks, n_planes))
    return (planes[0], masks[0]) if single else (planes, masks)


def _pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """``[..., P]`` 0/1 -> ``[...]`` int32 with bit ``p`` = ``flags[..., p]``."""
    bits = torch.arange(flags.shape[-1], device=flags.device, dtype=torch.int32)
    return (flags.to(torch.int32) << bits).sum(dim=-1).to(torch.int32)


def limb_block_masks(planes: torch.Tensor) -> torch.Tensor:
    """``[B, P, n, k]`` limb planes -> ``[B, ceil(n / 64)]`` int32 masks:
    bit ``p`` set where plane ``p`` holds a nonzero byte in those 64
    rows."""
    b, n_planes, n, _ = planes.shape
    n_blocks = -(-n // MASK_ROWS)
    nz = torch.zeros((b, n_planes, n_blocks * MASK_ROWS), dtype=torch.int32,
                     device=planes.device)
    nz[..., :n] = planes.ne(0).any(dim=-1) if planes.shape[-1] else 0
    flags = nz.view(b, n_planes, n_blocks, MASK_ROWS).amax(dim=-1)
    return _pack_bits(flags.transpose(1, 2))


def split_limbs(adjs: torch.Tensor, lw: int, ls: int) -> torch.Tensor:
    """A ``[B, n, n_k]`` stack of non-negative integer multiplicities (any
    dtype that holds them exactly) -> its ``[B, lw + ls, n, k]`` uint8 limb
    planes, laid out as :func:`build_biadjacency_limbs` lays them out."""
    b, n, n_k = adjs.shape
    m = adjs.to(torch.int64)
    out = torch.zeros((b, lw + ls, n, _row_bytes(n_k)), dtype=torch.uint8,
                      device=adjs.device)
    for p, limb in _limbs(m, lw, ls):
        out[:, p, :, :n_k] = limb
    return out


def join_limbs(planes: torch.Tensor, lw: int) -> torch.Tensor:
    """``[B, lw + ls, n, k]`` limb planes -> the ``[B, n, k]`` int64
    multiplicities they hold (planes ``0 .. lw - 1``)."""
    m = torch.zeros(planes.shape[:1] + planes.shape[2:], dtype=torch.int64,
                    device=planes.device)
    for p in range(lw):
        m += planes[:, p].to(torch.int64) << (8 * p)
    return m


def _gram_side(adj: torch.Tensor) -> torch.Tensor:
    """``adj`` as float32 with the smaller side as rows (the Gram side; the
    paper iterates the lower-degree side, with the Gram trick that is a
    transpose decision).  Both identities are symmetric in the sides."""
    a = adj.to(torch.float32)
    return a.transpose(-2, -1) if a.shape[-2] > a.shape[-1] else a


def _off_diagonal_half(pairs: torch.Tensor) -> torch.Tensor:
    """``sum_{u<v} pairs_uv`` of a symmetric ``[..., n, n]`` matrix, as the
    reference takes it: the whole sum less the diagonal, halved."""
    off = pairs.sum(dim=(-2, -1)) - torch.diagonal(
        pairs, dim1=-2, dim2=-1).sum(dim=-1)
    return off * 0.5


def _pairs_multiset(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Per wedge-endpoint pair: unordered hub pairs weighted by
    multiplicity, ``(W^2 - S) / 2`` (``C(W, 2)`` when every multiplicity
    is 1, since then ``S == W``)."""
    return (w * w - s) * 0.5


def count_butterflies_dense(adj: torch.Tensor) -> torch.Tensor:
    """B = sum_{u<v} C((A A^T)_uv, 2) on dense biadjacencies ``[..., n_i,
    n_j]`` -> ``[...]`` float32, the Gram in full float32
    (:func:`full_fp32_matmul`).  0/1 operands are exact in TF32 too, but
    the reference states float32 arithmetic, so the port runs the same."""
    a = _gram_side(adj)
    with full_fp32_matmul():
        w = torch.matmul(a, a.transpose(-2, -1))
    return _off_diagonal_half(w * (w - 1.0) * 0.5)


def count_butterflies_dense_multiset(adj: torch.Tensor) -> torch.Tensor:
    """Multiplicity-weighted count on weighted biadjacencies ``[..., n_i,
    n_j]`` -> ``[...]`` float32: ``sum_{u<v} (W_uv^2 - S_uv) / 2`` with
    ``W = A A^T`` and ``S = (A∘A)(A∘A)^T``, both Grams in full float32."""
    a = _gram_side(adj)
    a2 = a * a
    with full_fp32_matmul():
        w = torch.matmul(a, a.transpose(-2, -1))
        s = torch.matmul(a2, a2.transpose(-2, -1))
    return _off_diagonal_half(_pairs_multiset(w, s))


def butterfly_support_dense(adj: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vertex butterfly support (Algorithm 2) from both Grams, float32
    on ``adj``'s device: ``support_i[u] = sum_{v != u} C(W_uv, 2)`` with
    ``W = A A^T`` and ``support_j[x] = sum_{y != x} C(W'_xy, 2)`` with
    ``W' = A^T A``.  Exact while the sums stay below 2**24."""
    a = adj.to(torch.float32)

    def side(m):
        with full_fp32_matmul():
            w = torch.matmul(m, m.transpose(-2, -1))
        pairs = w * (w - 1.0) * 0.5
        return pairs.sum(dim=-1) - torch.diagonal(pairs, dim1=-2, dim2=-1)

    return side(a), side(a.transpose(-2, -1))


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


def count_butterflies_from_edges_multiset(
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    mult: torch.Tensor,
    valid: torch.Tensor,
    n_i: int,
    n_j: int,
) -> torch.Tensor:
    """Multiset count directly from padded (edge, multiplicity) lanes."""
    adj = build_biadjacency_multiset(edge_i, edge_j, mult, valid, n_i, n_j)
    return count_butterflies_dense_multiset(adj)


def count_butterflies_sampled_from_edges(
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    valid: torch.Tensor,
    uid_hi,
    uid_lo,
    n_i: int,
    n_j: int,
    *,
    capacity: int,
    gamma: float,
    seed: int,
) -> torch.Tensor:
    """FLEET subsample-and-scale count of padded windows (one ``[cap_e]``
    window with scalar uid halves, or ``[B, cap_e]`` with ``[B]`` halves):
    keep each valid edge with the gamma-ladder probability p that leaves at
    most ``capacity`` edges, count the survivors exactly with the dense
    counter and scale by ``p**-4`` in float32 (``p = 0`` gives 0).  A
    window that statically fits the reservoir (``cap_e <= capacity``) is
    counted by the dense counter directly, bit-identical to the ``dense``
    tier, with no threefry work.  ``uid_hi`` / ``uid_lo`` are the uint32
    halves of each window's sampling uid (``fleet.sample_keep_mask``)."""
    if edge_i.shape[-1] <= capacity:
        return count_butterflies_from_edges(edge_i, edge_j, valid, n_i, n_j)
    from .fleet import sample_keep_mask

    keep, p = sample_keep_mask(edge_i, edge_j, valid, uid_hi, uid_lo,
                               capacity=capacity, gamma=gamma, seed=seed)
    count = count_butterflies_from_edges(edge_i, edge_j, keep, n_i, n_j)
    inv = torch.where(p > 0, 1.0 / p, torch.zeros_like(p)).to(count.dtype)
    # inv**4 as XLA's integer power computes it: (inv * inv) squared
    sq = inv * inv
    return count * (sq * sq)


def snapshot_count(edge_i: torch.Tensor, edge_j: torch.Tensor,
                   valid: torch.Tensor, *, n_i: int, n_j: int) -> torch.Tensor:
    """Butterflies of one graph snapshot given as padded edge lanes (the
    serving monitor's call): :func:`count_butterflies_from_edges`."""
    return count_butterflies_from_edges(edge_i, edge_j, valid, n_i, n_j)


class Snapshot(NamedTuple):
    """A padded, compactly relabelled window snapshot on a device.

    edge_i / edge_j : int ``[capacity]`` compact per-window vertex ids
    valid           : bool ``[capacity]``
    n_i / n_j       : ints, the compact id-space sizes (padded)
    """

    edge_i: torch.Tensor
    edge_j: torch.Tensor
    valid: torch.Tensor
    n_i: int
    n_j: int

    def count(self) -> torch.Tensor:
        return count_butterflies_from_edges(self.edge_i, self.edge_j,
                                            self.valid, self.n_i, self.n_j)


def _tiled(adj: torch.Tensor, tile: int, multiset: bool) -> torch.Tensor:
    """Shared body of the tiled tiers: the Gram side split into row blocks
    of ``tile`` and a loop over block pairs ``u <= v`` (the reference scans
    all pairs, but a ``u > v`` pair lies wholly under the diagonal and adds
    exactly 0).  Each pair's ``[..., tile, tile]`` Gram block is reduced
    with the global ``row < col`` mask and added to a float32 total in
    (u, v) order, as the reference's scan carry adds."""
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    a = _gram_side(adj)
    a2 = a * a if multiset else None
    n = a.shape[-2]
    rows = torch.arange(n, device=a.device)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    total = torch.zeros(a.shape[:-2], dtype=torch.float32, device=a.device)
    with full_fp32_matmul():
        for u0 in range(0, n, tile):
            bu = a[..., u0:u0 + tile, :]
            iu = rows[u0:u0 + tile]
            for v0 in range(u0, n, tile):
                bv = a[..., v0:v0 + tile, :]
                w = torch.matmul(bu, bv.transpose(-2, -1))
                if multiset:
                    s = torch.matmul(a2[..., u0:u0 + tile, :],
                                     a2[..., v0:v0 + tile, :].transpose(-2, -1))
                    pairs = _pairs_multiset(w, s)
                else:
                    pairs = w * (w - 1.0) * 0.5
                keep = iu[:, None] < rows[v0:v0 + tile][None, :]
                total = total + torch.where(keep, pairs, zero).sum(
                    dim=(-2, -1))
    return total


def count_butterflies_tiled(adj: torch.Tensor,
                            tile: int = 512) -> torch.Tensor:
    """Tiled Gram counting on ``[..., n_i, n_j]`` -> ``[...]`` float32:
    only one ``tile x tile`` block of ``W`` per window exists at a time,
    O(tile * n_j + tile^2) memory per window instead of O(n_i^2)."""
    return _tiled(adj, tile, multiset=False)


def count_butterflies_tiled_multiset(adj: torch.Tensor,
                                     tile: int = 512) -> torch.Tensor:
    """Tiled twin of :func:`count_butterflies_dense_multiset`: the same
    block-pair loop as :func:`count_butterflies_tiled`, with the weighted
    Gram ``W`` and its square-weighted twin ``S`` per block pair and the
    ``(W^2 - S)/2`` epilogue."""
    return _tiled(adj, tile, multiset=True)


# ---------------------------------------------------------------------------
# sparse tier (wedge sort + rank aggregation; never builds the biadjacency)
# ---------------------------------------------------------------------------

def _check_sparse_keys(n_i: int, n_j: int, wedge_cap: int) -> None:
    if wedge_cap < 1:
        raise ValueError("wedge_cap must be >= 1")
    # the reference packs both sort phases' id pairs into ONE int32 key; the
    # port sorts int64 keys but refuses the same id spaces, so the two
    # packages route and fail alike
    if (n_i + 2) * (n_j + 2) >= 2**31 or (n_i + 2) * (n_i + 2) >= 2**31:
        raise ValueError(
            "sparse tier requires (n_i + 2) * (max(n_i, n_j) + 2) < 2**31 "
            "to pack sort keys into int32; use the dense/tiled tiers for "
            "id spaces this large")


def _lanes2d(*lanes: torch.Tensor):
    """Lift ``[cap_e]`` lanes to ``[1, cap_e]``; returns (lanes, single)."""
    single = lanes[0].dim() == 1
    return [x.reshape(-1, x.shape[-1]) for x in lanes], single


def _group_ranks(jj: torch.Tensor, live: torch.Tensor, pos: torch.Tensor):
    """In-group rank ``r`` of each sorted lane (distance to its j-group's
    first position, by a cummax of group-start markers; dead lanes rank 0,
    they owe no wedges), the group start of each lane, and the inclusive
    cumsum of ``r`` (the wedge-slot boundaries)."""
    first = pos == 0
    is_start = first | (jj != torch.roll(jj, 1, dims=-1))
    start = torch.cummax(torch.where(is_start, pos, -1), dim=-1).values
    r = torch.where(live, pos - start, 0)
    return r, start, torch.cumsum(r, dim=-1)


def _wedge_slots(r, start, cum_r, wedge_cap: int):
    """Scatter the wedge slots ``[0, wedge_cap)`` of every window to their
    ``(earlier, later)`` edge pair: slot ``w`` belongs to the sorted lane
    ``t`` whose rank cumsum first passes ``w`` (``searchsorted``, right
    side), and pairs it with the earlier group member ``p``.  Returns
    ``(p, t, alive)``, ``p`` and ``t`` clamped into the lanes."""
    cap_e = r.shape[-1]
    w = torch.arange(wedge_cap, device=r.device).expand(
        r.shape[0], wedge_cap).contiguous()
    t = torch.searchsorted(cum_r, w, right=True).clamp(0, cap_e - 1)
    p = (torch.gather(start, 1, t)
         + (w - (torch.gather(cum_r, 1, t) - torch.gather(r, 1, t))))
    alive = w < cum_r[:, -1:]
    return p.clamp(0, cap_e - 1), t, alive


def _run_heads(wkey: torch.Tensor, wpos: torch.Tensor) -> torch.Tensor:
    return (wpos == 0) | (wkey != torch.roll(wkey, 1, dims=-1))


def count_butterflies_sparse(
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    valid: torch.Tensor,
    n_i: int,
    n_j: int,
    wedge_cap: int,
) -> torch.Tensor:
    """Butterfly count from padded edge lists by wedge aggregation, the
    reference's schedule batched over a leading window axis (``[cap_e]``
    -> scalar, ``[B, cap_e]`` -> ``[B]`` float32):

    1. sort edges by ``(j, i)`` (invalid lanes carry sentinel ids ``(n_j,
       n_i)`` so they group last) and invalidate exact duplicates;
    2. a second sort compacts the surviving edges into contiguous
       j-groups;
    3. every edge of in-group rank ``r`` owes ``r`` wedges, one per earlier
       group member (:func:`_wedge_slots`); in-group ``i`` is ascending
       and deduped, so the wedge endpoints satisfy ``i1 < i2``;
    4. sort wedges by ``(i1, i2)`` and sum every live wedge's rank within
       its run of equal keys: a run of multiplicity ``m`` adds
       ``0 + 1 + ... + (m-1) = C(m, 2)``.

    ``wedge_cap`` must bound each window's wedge count (the executor counts
    it on the host per bucket, :func:`window_wedge_counts_np`).
    """
    _check_sparse_keys(n_i, n_j, wedge_cap)
    (ei, ej, v), single = _lanes2d(edge_i, edge_j, valid)
    cap_e = ei.shape[-1]
    dev = ei.device
    pos = torch.arange(cap_e, device=dev)
    v = v.bool()
    ii = torch.where(v, ei.long(), n_i)
    jj = torch.where(v, ej.long(), n_j)
    span_i = n_i + 2
    ekey = torch.sort(jj * span_i + ii, dim=-1).values
    dup = (pos != 0) & (ekey == torch.roll(ekey, 1, dims=-1))
    sent = n_j * span_i                        # every live key sorts below
    ekey = torch.sort(torch.where(dup, sent + ii, ekey), dim=-1).values
    jj = ekey // span_i
    ii = ekey - jj * span_i
    r, start, cum_r = _group_ranks(jj, jj < n_j, pos)
    p, t, alive = _wedge_slots(r, start, cum_r, wedge_cap)
    i1 = torch.where(alive, torch.gather(ii, 1, p), n_i)
    i2 = torch.where(alive, torch.gather(ii, 1, t), n_i)
    wkey = torch.sort(i1 * span_i + i2, dim=-1).values  # dead wedges last
    wpos = torch.arange(wedge_cap, device=dev)
    wstart = torch.cummax(torch.where(_run_heads(wkey, wpos), wpos, -1),
                          dim=-1).values
    wrank = torch.where(wkey < n_i * span_i, wpos - wstart, 0)
    out = wrank.to(torch.float32).sum(dim=-1)
    return out[0] if single else out


def count_butterflies_sparse_multiset(
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    mult: torch.Tensor,
    valid: torch.Tensor,
    n_i: int,
    n_j: int,
    wedge_cap: int,
) -> torch.Tensor:
    """Multiset twin of :func:`count_butterflies_sparse` over lanes of
    *unique* (i, j) pairs with multiplicities (no dedupe sort): each wedge
    weighs ``mult(i1, j) * mult(i2, j)`` and each run of equal wedge keys
    adds ``(S^2 - S2) / 2``, ``S`` and ``S2`` its weight and squared-weight
    sums, taken at run tails from float32 cumsums less their run bases
    (the exclusive cumsums at run heads, carried forward by a cummax: both
    cumsums are non-decreasing since weights are >= 0)."""
    _check_sparse_keys(n_i, n_j, wedge_cap)
    (ei, ej, mm, v), single = _lanes2d(edge_i, edge_j, mult, valid)
    cap_e = ei.shape[-1]
    dev = ei.device
    pos = torch.arange(cap_e, device=dev)
    v = v.bool()
    ii = torch.where(v, ei.long(), n_i)
    jj = torch.where(v, ej.long(), n_j)
    mm = torch.where(v, mm.long(), 0)
    span_i = n_i + 2
    # sort by packed (j, i) with the multiplicity lane as payload
    ekey, order = torch.sort(jj * span_i + ii, dim=-1, stable=True)
    mm = torch.gather(mm, 1, order)
    jj = ekey // span_i
    ii = ekey - jj * span_i
    r, start, cum_r = _group_ranks(jj, jj < n_j, pos)
    p, t, alive = _wedge_slots(r, start, cum_r, wedge_cap)
    i1 = torch.where(alive, torch.gather(ii, 1, p), n_i)
    i2 = torch.where(alive, torch.gather(ii, 1, t), n_i)
    macc = mm.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ww = torch.where(alive, torch.gather(macc, 1, p) * torch.gather(macc, 1, t),
                     zero)
    # dead wedges share the sentinel key and weigh 0: their run adds 0
    wkey, order = torch.sort(i1 * span_i + i2, dim=-1, stable=True)
    ww = torch.gather(ww, 1, order)
    wpos = torch.arange(wedge_cap, device=dev)
    head = _run_heads(wkey, wpos)
    ww2 = ww * ww
    c1 = torch.cumsum(ww, dim=-1)
    c2 = torch.cumsum(ww2, dim=-1)
    neg = torch.full((), -1.0, dtype=torch.float32, device=dev)
    base1 = torch.cummax(torch.where(head, c1 - ww, neg), dim=-1).values
    base2 = torch.cummax(torch.where(head, c2 - ww2, neg), dim=-1).values
    tail = torch.roll(head, -1, dims=-1) | (wpos == wedge_cap - 1)
    s1 = c1 - base1
    s2 = c2 - base2
    out = torch.where(tail, (s1 * s1 - s2) * 0.5, zero).sum(dim=-1)
    return out[0] if single else out
