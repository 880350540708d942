"""Adaptive time-based tumbling windows (paper SS4.1, Algorithm 3).

A window closes after ``nt_w`` *unique timestamps* have been observed — not a
fixed time span and not a fixed sgr count.  The adaptivity (a data-dependent
boundary decision) lives on the host: the windowizer turns a time-ordered
sgr sequence into padded numpy window tensors (:class:`WindowBatch`) that
the executor stages onto the device bucket by bucket.  This module is the
port's own copy of ``repro.core.windows``: the two packages pack the same
stream into equal lanes, so one batch feeds both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["window_ids", "window_bounds", "WindowBatch", "pack_windows",
           "windowize", "adaptive_window_stream"]


def window_ids(tau: np.ndarray, nt_w: int) -> np.ndarray:
    """Window index per sgr for adaptive tumbling windows.

    ``tau`` must be non-decreasing (stream order).  The k-th window contains
    the sgrs whose timestamp falls in the k-th block of ``nt_w`` unique
    timestamps — exactly Algorithm 3's close condition.
    """
    tau = np.asarray(tau)
    if tau.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    if not np.isfinite(tau).all():
        # NaN compares False to everything, so it would slip past the order
        # check below AND count as a fresh unique timestamp per record
        raise ValueError("timestamps must be finite")
    if np.any(np.diff(tau) < 0):
        raise ValueError("timestamps must be non-decreasing (stream order)")
    if nt_w <= 0:
        raise ValueError("nt_w must be positive")
    is_new = np.r_[True, tau[1:] != tau[:-1]]
    uniq_rank = np.cumsum(is_new) - 1  # 0-based unique-timestamp rank
    return uniq_rank // nt_w


def window_bounds(tau: np.ndarray, nt_w: int, *, drop_partial: bool = True) -> np.ndarray:
    """(start, end) sgr index ranges per window; optionally drop the trailing
    partial window (one that never saw its nt_w-th unique timestamp close)."""
    wid = window_ids(tau, nt_w)
    if wid.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.int64)
    n_win = int(wid[-1]) + 1
    starts = np.searchsorted(wid, np.arange(n_win), side="left")
    ends = np.searchsorted(wid, np.arange(n_win), side="right")
    bounds = np.stack([starts, ends], axis=1)
    if drop_partial:
        tau = np.asarray(tau)
        n_uniq_last = np.unique(tau[starts[-1] : ends[-1]]).shape[0]
        if n_uniq_last < nt_w:
            bounds = bounds[:-1]
    return bounds


@dataclass
class WindowBatch:
    """Padded device-ready window tensors.

    edge_i / edge_j : int32 [n_windows, capacity]  compact per-window ids
    valid           : bool  [n_windows, capacity]
    n_edges         : int64 [n_windows]            deduped in-window edge count
    n_sgrs          : int64 [n_windows]            raw sgr count (incl. dups)
    cum_sgrs        : int64 [n_windows]            |E_k| = sgrs in [W_0^b, W_k^e)
    n_i / n_j       : int                          compact id-space capacity
    window_end_tau  : float64 [n_windows]          W_k^e (last tau in window)
    n_i_per_window / n_j_per_window : int64 [n_windows]
    stream_ids      : int32 [n_windows] | None     provenance lane: which
        tenant stream each window belongs to (multi-stream co-batching;
        ``None`` for single-stream batches).  Bookkeeping only — bucketing
        and counting ignore it, which is exactly what lets windows from
        different streams share a compiled bucket.
    edge_mult       : int32 [n_windows, capacity] | None   per-edge net
        multiplicity lane (``multiset`` duplicate policy).  ``None`` for
        distinct-mode batches — counting treats a missing lane as all-ones.
        Padding slots are zero (masked out by ``valid`` anyway).
    sample_uid      : int64 [n_windows] | None     per-window sampling uid
        for the ``sampled`` executor tier: the 64-bit value folded into the
        threefry key so each window (of each stream) draws its own coin
        stream.  The streaming engines stamp ``(res_seed << 32) +
        cum_sgrs``; ``None`` makes the executor derive the equivalent from
        ``stream_ids``/``cum_sgrs`` (seed-0 semantics).  Exact tiers never
        read it.
    """

    edge_i: np.ndarray
    edge_j: np.ndarray
    valid: np.ndarray
    n_edges: np.ndarray
    n_sgrs: np.ndarray
    cum_sgrs: np.ndarray
    n_i: int
    n_j: int
    window_end_tau: np.ndarray
    n_i_per_window: np.ndarray
    n_j_per_window: np.ndarray
    stream_ids: np.ndarray | None = None
    edge_mult: np.ndarray | None = None
    sample_uid: np.ndarray | None = None

    @property
    def n_windows(self) -> int:
        return self.edge_i.shape[0]

    @property
    def capacity(self) -> int:
        return self.edge_i.shape[1]

    def take(self, indices, capacity: int | None = None) -> "WindowBatch":
        """Sub-batch of the given window indices, optionally sliced to a
        smaller edge capacity (must cover every selected window's edges).
        The executor uses this to carve same-capacity buckets out of a batch
        without copying the global-capacity tensors onto the device.
        """
        idx = np.asarray(indices, dtype=np.int64)
        cap = self.capacity if capacity is None else capacity
        if cap < 0:
            raise ValueError(f"capacity must be non-negative, got {cap}")
        if cap > self.capacity:
            raise ValueError(
                f"capacity {cap} > batch capacity {self.capacity}")
        # the coverage check also applies to the empty selection (where the
        # required capacity is trivially 0, so any non-negative cap passes)
        need = int(self.n_edges[idx].max()) if idx.size else 0
        if need > cap:
            raise ValueError(
                f"capacity {cap} < max selected in-window edges {need}")
        return WindowBatch(
            edge_i=self.edge_i[idx, :cap],
            edge_j=self.edge_j[idx, :cap],
            valid=self.valid[idx, :cap],
            n_edges=self.n_edges[idx],
            n_sgrs=self.n_sgrs[idx],
            cum_sgrs=self.cum_sgrs[idx],
            n_i=self.n_i,
            n_j=self.n_j,
            window_end_tau=self.window_end_tau[idx],
            n_i_per_window=self.n_i_per_window[idx],
            n_j_per_window=self.n_j_per_window[idx],
            stream_ids=(None if self.stream_ids is None
                        else self.stream_ids[idx]),
            edge_mult=(None if self.edge_mult is None
                       else self.edge_mult[idx, :cap]),
            sample_uid=(None if self.sample_uid is None
                        else self.sample_uid[idx]),
        )


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_windows(
    per_window_edges: list[np.ndarray],
    *,
    n_sgrs: np.ndarray,
    cum_sgrs: np.ndarray,
    window_end_tau: np.ndarray,
    capacity: int | None = None,
    align: int = 128,
    dedupe: bool = True,
    stream_ids: np.ndarray | None = None,
    per_window_mult: list[np.ndarray] | None = None,
    sample_uid: np.ndarray | None = None,
) -> WindowBatch:
    """Pack per-window raw edge lists into padded device-ready tensors.

    Each entry of ``per_window_edges`` is an ``[m, 2]`` int64 array of (i, j)
    sgrs in arrival order.  Per window: dedupe (i, j) pairs keeping first
    arrival (paper semantics), relabel vertices to a compact per-window id
    space (tumbling windows renew the graph, Alg. 4 line 19, so ids never
    leak across windows), pad to a common capacity aligned to ``align``
    lanes.  Shared by the batch :func:`windowize` path and the online
    :class:`repro_torch.streams.engine.StreamingSGrapp` flush path — both pack
    through here, so a window's device-side representation is identical no
    matter which ingestion mode produced it.

    ``stream_ids`` (optional, int32 ``[n_windows]``) tags each window with
    its tenant stream — the provenance lane the multi-stream engine uses to
    scatter co-batched counts back to the right tenant.  Packing, bucketing
    and counting never read it.

    ``per_window_mult`` (optional, one int array per window, aligned with
    ``per_window_edges``) carries per-edge net multiplicities for the
    ``multiset`` duplicate policy; it is packed into ``WindowBatch.edge_mult``
    (int32, zero-padded).  The lane is *ignored* under ``dedupe=True`` —
    distinct-mode packing collapses duplicates keep-first, so a multiplicity
    lane would be meaningless there (``edge_mult`` stays ``None``).

    ``sample_uid`` (optional, int64 ``[n_windows]``) stamps each window's
    64-bit sampling uid for the ``sampled`` executor tier (see
    :class:`WindowBatch`).  Like ``stream_ids`` it is pure bookkeeping to
    the packer.
    """
    n_win = len(per_window_edges)
    n_sgrs = np.asarray(n_sgrs, dtype=np.int64)
    cum_sgrs = np.asarray(cum_sgrs, dtype=np.int64)
    window_end_tau = np.asarray(window_end_tau, dtype=np.float64)
    if stream_ids is not None:
        stream_ids = np.asarray(stream_ids, dtype=np.int32)
        if stream_ids.shape != (n_win,):
            raise ValueError(
                f"stream_ids must be [n_windows]={n_win}, "
                f"got shape {stream_ids.shape}")
    if sample_uid is not None:
        sample_uid = np.asarray(sample_uid, dtype=np.int64)
        if sample_uid.shape != (n_win,):
            raise ValueError(
                f"sample_uid must be [n_windows]={n_win}, "
                f"got shape {sample_uid.shape}")
    want_mult = per_window_mult is not None and not dedupe
    if per_window_mult is not None and len(per_window_mult) != n_win:
        raise ValueError(
            f"per_window_mult must have one entry per window ({n_win}), "
            f"got {len(per_window_mult)}")
    if n_win == 0:
        z2 = np.zeros((0, 0), dtype=np.int32)
        z1 = np.zeros(0, dtype=np.int64)
        return WindowBatch(z2, z2, z2.astype(bool), z1, z1, z1, 0, 0,
                           np.zeros(0, dtype=np.float64), z1, z1,
                           stream_ids=stream_ids,
                           edge_mult=z2 if want_mult else None,
                           sample_uid=sample_uid)

    from .butterfly import _check_id_range_np, _dedupe_edges_np

    per_edges: list[np.ndarray] = []
    per_mult: list[np.ndarray] = []
    for k, ew in enumerate(per_window_edges):
        ew = np.asarray(ew, dtype=np.int64).reshape(-1, 2)
        # loud id-range guard regardless of dedupe: raw ids >= 2**32 (or
        # negative) would silently collide in packed int64 keys downstream
        # (host oracle, sparse tier) and corrupt counts
        _check_id_range_np(ew)
        if dedupe:
            # same keep-first-arrival packed-key dedupe as the host oracle
            ew = _dedupe_edges_np(ew)
        elif want_mult:
            mw = np.asarray(per_window_mult[k], dtype=np.int64).reshape(-1)
            if mw.shape[0] != ew.shape[0]:
                raise ValueError(
                    f"per_window_mult[{k}] length {mw.shape[0]} != "
                    f"{ew.shape[0]} edges")
            per_mult.append(mw)
        per_edges.append(ew)

    n_edges = np.array([e.shape[0] for e in per_edges], dtype=np.int64)
    cap = capacity if capacity is not None else _round_up(max(1, int(n_edges.max())), align)
    if int(n_edges.max()) > cap:
        raise ValueError(
            f"window capacity {cap} < max in-window edges {int(n_edges.max())}"
        )

    out_i = np.zeros((n_win, cap), dtype=np.int32)
    out_j = np.zeros((n_win, cap), dtype=np.int32)
    valid = np.zeros((n_win, cap), dtype=bool)
    out_m = np.zeros((n_win, cap), dtype=np.int32) if want_mult else None
    ni_w = np.zeros(n_win, dtype=np.int64)
    nj_w = np.zeros(n_win, dtype=np.int64)
    for k, ew in enumerate(per_edges):
        ui, inv_i = np.unique(ew[:, 0], return_inverse=True)
        uj, inv_j = np.unique(ew[:, 1], return_inverse=True)
        m = ew.shape[0]
        out_i[k, :m] = inv_i
        out_j[k, :m] = inv_j
        valid[k, :m] = True
        if out_m is not None:
            out_m[k, :m] = per_mult[k]
        ni_w[k], nj_w[k] = ui.shape[0], uj.shape[0]

    n_i = _round_up(max(1, int(ni_w.max())), align)
    n_j = _round_up(max(1, int(nj_w.max())), align)
    return WindowBatch(
        edge_i=out_i, edge_j=out_j, valid=valid, n_edges=n_edges, n_sgrs=n_sgrs,
        cum_sgrs=cum_sgrs, n_i=n_i, n_j=n_j, window_end_tau=window_end_tau,
        n_i_per_window=ni_w, n_j_per_window=nj_w, stream_ids=stream_ids,
        edge_mult=out_m, sample_uid=sample_uid,
    )


def windowize(
    tau: np.ndarray,
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    nt_w: int,
    *,
    capacity: int | None = None,
    align: int = 128,
    drop_partial: bool = True,
    dedupe: bool = True,
) -> WindowBatch:
    """Compile a time-ordered sgr stream into padded window tensors
    (adaptive tumbling windows -> :func:`pack_windows`)."""
    tau = np.asarray(tau)
    edge_i = np.asarray(edge_i, dtype=np.int64)
    edge_j = np.asarray(edge_j, dtype=np.int64)
    bounds = window_bounds(tau, nt_w, drop_partial=drop_partial)
    n_win = bounds.shape[0]
    per_edges = [np.stack([edge_i[s:e], edge_j[s:e]], axis=1) for s, e in bounds]
    n_sgrs = bounds[:, 1] - bounds[:, 0] if n_win else np.zeros(0, np.int64)
    end_tau = (tau[bounds[:, 1] - 1].astype(np.float64) if n_win
               else np.zeros(0, np.float64))
    return pack_windows(
        per_edges, n_sgrs=n_sgrs, cum_sgrs=np.cumsum(n_sgrs),
        window_end_tau=end_tau, capacity=capacity, align=align, dedupe=dedupe,
    )


def adaptive_window_stream(
    records: Iterator[tuple[float, int, int]],
    nt_w: int,
    *,
    drop_partial: bool = True,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Online variant of Algorithm 3: yields (tau, edge_i, edge_j) arrays as
    each adaptive window closes.  Used by the true-streaming examples; the
    batched :func:`windowize` path is used for replayed/benchmark streams.

    ``drop_partial`` matches :func:`window_bounds`' contract: a trailing
    window that reached its full ``nt_w``-unique-timestamp quota is always
    emitted at stream end, and a trailing *partial* window (fewer than
    ``nt_w`` uniques) is emitted iff ``drop_partial=False`` — so for either
    setting the yielded windows are exactly the rows of
    ``window_bounds(tau, nt_w, drop_partial=...)``.
    """
    buf_tau: list[float] = []
    buf_i: list[int] = []
    buf_j: list[int] = []
    uniq: set[float] = set()
    pending_close = False
    for tau, i, j in records:
        if pending_close and tau not in uniq:
            # nt_w-th unique timestamp fully drained; window closes *before*
            # the first sgr of a new timestamp beyond the quota.
            yield (np.array(buf_tau), np.array(buf_i), np.array(buf_j))
            buf_tau, buf_i, buf_j = [], [], []
            uniq = set()
            pending_close = False
        buf_tau.append(tau)
        buf_i.append(i)
        buf_j.append(j)
        uniq.add(tau)
        if len(uniq) == nt_w:
            pending_close = True
    if pending_close or (buf_tau and not drop_partial):
        # either the final window reached its quota exactly at stream end
        # (always complete, always emitted), or it is a trailing partial
        # window and the caller asked to keep it
        yield (np.array(buf_tau), np.array(buf_i), np.array(buf_j))
