"""Per-stream engine state as flat numpy leaves + the pure windowizer.

The port's copy of ``repro.streams.state``.  :class:`StreamState` holds the
open-window edge buffer, the unique-timestamp quota progress, the cumulative
``|E|`` and the estimator carry (including the adapted alpha of Algorithm 5)
as a flat dataclass of numpy leaves with a leading stream axis; the
single-stream engine is the ``n_streams=1`` case.  The reference registers
the dataclass as a JAX pytree; the port has no use for that, and the leaves
are otherwise the same, so the engines' checkpoints carry across.

:func:`windowizer_push` closes adaptive windows online: one vectorized pass
over a tagged ``(stream_id, tau, i, j)`` micro-batch computes every record's
unique-timestamp rank and window offset, then a per-stream epilogue that is
O(windows closed) splits the chunk at window boundaries.  The mb=1 scalar
fast path (:func:`_push_one_record`) is bit-identical to the vector path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .wire import OP_DELETE, OP_INSERT, normalize_records

__all__ = [
    "StreamState",
    "stream_state_init",
    "estimator_carry",
    "set_estimator_carry",
    "windowizer_push",
    "windowizer_close_tail",
    "resolve_window",
    "OP_INSERT",
    "OP_DELETE",
    "NO_TAU",
]

NO_TAU = float("nan")  # sentinel: no timestamp observed yet

# dynamic wire format: per-record op codes, defined once in
# repro_torch.streams.wire (re-exported here for compatibility).  A record is
# (op, stream_id, tau, i, j); op=None on push means all-insert (the static
# wire format, unchanged).  Internally every record carries a *delta* lane
# instead: +1 insert, -1 applied delete, 0 no-op (a delete dropped under
# on_missing_delete="ignore" — kept as a record so the unique-timestamp
# quota and |E_k| bookkeeping see exactly the pushed stream).  The imported
# OP_INSERT / OP_DELETE bindings above stay in __all__ — this module is the
# historical home of the constants.


@dataclass
class StreamState:
    """Per-stream engine state, leading axis = stream (see module doc).

    buf_i / buf_j  : int64   [n_streams, buf_capacity]  open-window buffer
    buf_op         : int8    [n_streams, buf_capacity]  per-record delta:
                     +1 insert, -1 applied delete, 0 ignored no-op record
    buf_len        : int64   [n_streams]   live sgrs in each buffer row
    buf_last_tau   : float64 [n_streams]   last tau in the open buffer
    uniq           : int64   [n_streams]   unique timestamps in the open window
    last_tau       : float64 [n_streams]   last tau ever seen (order check)
    total_sgrs     : int64   [n_streams]   cumulative |E| over counted windows
    finalized      : bool    [n_streams]
    carry_cum / carry_alpha / carry_err : float32 [n_streams]  estimator carry
    carry_sup      : bool    [n_streams]   (Alg. 5 supervision latch)
    res_seed       : int64   [n_streams]   per-stream reservoir seed: the
                     high 32 bits of every window's sampling uid for the
                     ``sampled`` executor tier, so co-batched tenants draw
                     decorrelated coins.  Carried (and checkpointed) even
                     under exact tiers — it is stream identity, not tier
                     state.
    """

    buf_i: np.ndarray
    buf_j: np.ndarray
    buf_op: np.ndarray
    buf_len: np.ndarray
    buf_last_tau: np.ndarray
    uniq: np.ndarray
    last_tau: np.ndarray
    total_sgrs: np.ndarray
    finalized: np.ndarray
    carry_cum: np.ndarray
    carry_alpha: np.ndarray
    carry_err: np.ndarray
    carry_sup: np.ndarray
    res_seed: np.ndarray

    @property
    def n_streams(self) -> int:
        return self.buf_len.shape[0]

    @property
    def buf_capacity(self) -> int:
        return self.buf_i.shape[1]


def stream_state_init(n_streams: int, alpha0, *,
                      buf_capacity: int = 256,
                      seed: int = 0) -> StreamState:
    """Fresh fleet state: empty buffers, quota at zero, estimator carry at
    ``estimator_init(alpha0)``.  ``alpha0`` is a scalar (shared) or a length-
    ``n_streams`` sequence (per-tenant initial exponent).  ``seed`` offsets
    the per-stream reservoir seeds (``res_seed = seed + arange``), so tenant
    s of a fleet draws the same sampled-tier coins as a dedicated engine
    constructed with ``seed + s``."""
    if n_streams < 1:
        raise ValueError("n_streams must be >= 1")
    if isinstance(seed, bool) or not isinstance(seed, (int, np.integer)):
        raise ValueError(f"seed must be an int, got {seed!r}")
    alpha = np.broadcast_to(
        np.asarray(alpha0, dtype=np.float32), (n_streams,)).copy()
    return StreamState(
        buf_i=np.zeros((n_streams, buf_capacity), dtype=np.int64),
        buf_j=np.zeros((n_streams, buf_capacity), dtype=np.int64),
        buf_op=np.ones((n_streams, buf_capacity), dtype=np.int8),
        buf_len=np.zeros(n_streams, dtype=np.int64),
        buf_last_tau=np.full(n_streams, NO_TAU, dtype=np.float64),
        uniq=np.zeros(n_streams, dtype=np.int64),
        last_tau=np.full(n_streams, NO_TAU, dtype=np.float64),
        total_sgrs=np.zeros(n_streams, dtype=np.int64),
        finalized=np.zeros(n_streams, dtype=bool),
        carry_cum=np.zeros(n_streams, dtype=np.float32),
        carry_alpha=alpha,
        carry_err=np.zeros(n_streams, dtype=np.float32),
        carry_sup=np.zeros(n_streams, dtype=bool),
        res_seed=int(seed) + np.arange(n_streams, dtype=np.int64),
    )


def estimator_carry(state: StreamState, s: int) -> tuple:
    """Stream ``s``'s estimator carry as the ``(cumB, alpha, prev_err,
    prev_supervised)`` scalar tuple :func:`repro_torch.core.sgrapp.estimator_step`
    consumes."""
    return (state.carry_cum[s], state.carry_alpha[s],
            state.carry_err[s], state.carry_sup[s])


def set_estimator_carry(state: StreamState, s: int, carry) -> None:
    cum, alpha, err, sup = (np.asarray(c) for c in carry)
    state.carry_cum[s] = cum
    state.carry_alpha[s] = alpha
    state.carry_err[s] = err
    state.carry_sup[s] = sup


# ---------------------------------------------------------------------------
# buffer rows
# ---------------------------------------------------------------------------

def _buf_append(state: StreamState, s: int, ei: np.ndarray,
                ej: np.ndarray, dl: np.ndarray | None = None) -> None:
    """Append a chunk to stream s's open-window buffer row, doubling the
    shared row capacity when it overflows (amortized O(1) per sgr).
    ``dl`` is the per-record delta lane (+1/-1/0); ``None`` means all
    inserts (+1), the static-stream fast path."""
    n = ei.shape[0]
    if n == 0:
        return
    pos = int(state.buf_len[s])
    need = pos + n
    cap = state.buf_capacity
    if need > cap:
        while cap < need:
            cap *= 2
        grow = cap - state.buf_capacity
        pad = ((0, 0), (0, grow))
        state.buf_i = np.pad(state.buf_i, pad)
        state.buf_j = np.pad(state.buf_j, pad)
        # pad value 0 is fine: slots beyond buf_len are dead until written
        state.buf_op = np.pad(state.buf_op, pad)
    state.buf_i[s, pos:need] = ei
    state.buf_j[s, pos:need] = ej
    state.buf_op[s, pos:need] = 1 if dl is None else dl
    state.buf_len[s] = need


def _buf_take(state: StreamState, s: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drain stream s's buffer row: copies of the live prefix, row reset."""
    n = int(state.buf_len[s])
    ei = state.buf_i[s, :n].copy()
    ej = state.buf_j[s, :n].copy()
    op = state.buf_op[s, :n].copy()
    state.buf_len[s] = 0
    return ei, ej, op


def _norm_ops(dl: np.ndarray) -> np.ndarray | None:
    """Collapse an all-insert delta lane to ``None`` — the marker the whole
    downstream pipeline (flush packing, duplicate-policy resolution) keys its
    static-stream fast path on, keeping insert-only windows bit-identical to
    the pre-dynamic wire format."""
    return None if bool((dl == 1).all()) else dl


def resolve_window(edge_i: np.ndarray, edge_j: np.ndarray,
                   op: np.ndarray | None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resolve a closed window's record list against its deletions: returns
    ``(edge_i, edge_j, mult)`` — the unique surviving edges with net
    multiplicity > 0, in packed-key order.  ``op`` is the per-record delta
    lane (+1/-1/0; ``None`` = all inserts).  Deletions resolve *here*, at
    window close, because tumbling windows renew the graph (Alg. 4 line 19):
    a delete can only ever target an insert of the same window, so a fully
    retracted window resolves to zero edges and packs as ``n_edges=0``
    without breaking bucket routing."""
    from ..core.butterfly import _check_id_range_np

    ei = np.asarray(edge_i, dtype=np.int64)
    ej = np.asarray(edge_j, dtype=np.int64)
    _check_id_range_np(np.stack([ei, ej], axis=1) if ei.size
                       else np.zeros((0, 2), np.int64))
    key = ei << 32 | ej
    uk, inv = np.unique(key, return_inverse=True)
    net = np.zeros(uk.shape[0], dtype=np.int64)
    np.add.at(net, inv,
              np.ones(ei.shape[0], np.int64) if op is None
              else np.asarray(op, dtype=np.int64))
    keep = net > 0
    uk = uk[keep]
    return uk >> 32, uk & 0xFFFFFFFF, net[keep]


def _apply_missing_delete_policy(
    state: StreamState, s: int, ei: np.ndarray, ej: np.ndarray,
    w_off: np.ndarray, dl: np.ndarray, on_missing_delete: str,
) -> np.ndarray:
    """Validate a chunk's deletes against their windows *before any state
    mutation*: a delete targets the net content of its own window (open
    buffer + earlier chunk records for offset 0; earlier chunk records only
    for later offsets — tumbling windows renew the graph).

    ``"raise"``: any delete whose edge has net multiplicity 0 at its arrival
    raises ``ValueError`` (never-inserted, already-deleted, or fully
    retracted edge) and the whole push is rejected untouched.
    ``"ignore"``: such deletes are zeroed to no-op records (delta 0) — the
    clamped-at-zero walk.  Returns the (possibly rewritten) delta lane.

    Vectorized: records group by (window offset, i, j) via a stable lexsort;
    within each group the running sum S of deltas is the edge's net
    multiplicity after each record.  ``raise`` triggers iff any S < 0.  For
    ``ignore``, by Skorokhod reflection the clamped walk ignores exactly the
    deletes where S drops below the running floor ``min(0, min_{l<k} S_l)``
    of the *unclamped* walk — so one pass computes every ignored position
    without replaying the clamp sequentially.  Buffer records precede chunk
    records in their group and were cleaned by earlier pushes, so their
    prefix sums are non-negative by induction and only chunk positions can
    flag."""
    nb = int(state.buf_len[s])
    nc = ei.shape[0]
    ii = np.concatenate([state.buf_i[s, :nb], ei])
    jj = np.concatenate([state.buf_j[s, :nb], ej])
    ww = np.concatenate([np.zeros(nb, np.int64),
                         np.asarray(w_off, dtype=np.int64)])
    dd = np.concatenate([state.buf_op[s, :nb].astype(np.int64),
                         dl.astype(np.int64)])
    src = np.concatenate([np.full(nb, -1, np.int64), np.arange(nc)])
    order = np.lexsort((jj, ii, ww))  # stable: arrival order within a group
    ii, jj, ww, dd, src = ii[order], jj[order], ww[order], dd[order], src[order]
    n = nb + nc
    head = np.empty(n, dtype=bool)
    head[0] = True
    head[1:] = (ww[1:] != ww[:-1]) | (ii[1:] != ii[:-1]) | (jj[1:] != jj[:-1])
    starts = np.flatnonzero(head)
    sizes = np.diff(np.r_[starts, n])
    cum = np.cumsum(dd)
    base = np.repeat(np.r_[0, cum[starts[1:] - 1]], sizes)
    S = cum - base  # segmented running net multiplicity
    if on_missing_delete == "raise":
        neg = S < 0
        if neg.any():
            p = int(np.argmax(neg))
            raise ValueError(
                f"stream {s}: delete of edge ({int(ii[p])}, {int(jj[p])}) "
                "targets an edge absent from its window (never inserted, "
                "already deleted, or fully retracted); pass "
                "on_missing_delete='ignore' to drop such deletes")
        return dl
    # ignore: running floor of the unclamped walk, segmented via the
    # group-offset trick (BIG separates groups; min-accumulate crosses
    # group boundaries monotonically because offsets only decrease)
    gid = np.cumsum(head) - 1
    BIG = np.int64(n + 2)
    A = np.minimum(S, 0) - gid * BIG
    M = np.minimum.accumulate(A) + gid * BIG  # min(0, min_{l<=k} S_l) per group
    prev = np.empty(n, dtype=np.int64)
    prev[0] = 0
    prev[1:] = M[:-1]
    prev[head] = 0  # first record of a group has an empty past
    ignored = (dd == -1) & (S < prev)
    if not ignored.any():
        return dl
    out = dl.copy()
    out[src[ignored]] = 0
    return out


# ---------------------------------------------------------------------------
# the windowizer (paper Algorithm 3, vectorized over a tagged micro-batch)
# ---------------------------------------------------------------------------

def _ingest_ranked(
    state: StreamState, s: int, tau: np.ndarray, ei: np.ndarray,
    ej: np.ndarray, uniq_idx_last: int, w_off: np.ndarray, nt_w: int,
    closed: list[tuple[int, np.ndarray, np.ndarray, np.ndarray | None,
                       int, float]],
    dl: np.ndarray | None = None,
) -> None:
    """Shared per-stream ingest epilogue: given a chunk of stream ``s``'s
    records with their window offsets (``w_off``; 0 = still the open
    window) already computed, split at window boundaries, emit closed
    windows onto ``closed``, and update the stream's buffer/quota rows.
    Both the single-stream fast path and the grouped multi-stream path end
    here — the window-boundary subtleties (empty completing segment,
    quota rollover) have exactly one implementation.

    ``dl`` is the validated per-record delta lane (``None`` = all inserts).
    Closed windows are emitted as ``(stream, edge_i, edge_j, ops, n_sgrs,
    end_tau)`` with ``ops=None`` for all-insert windows (the static fast
    path) and ``n_sgrs`` the window's *net* count (inserts minus applied
    deletes — identical to the record count for insert-only streams)."""
    n = tau.shape[0]
    w_max = int(w_off[-1])
    if w_max == 0:
        # appends copy into the buffer row, so the caller's arrays are
        # never aliased (middle-segment fancy indexing below never aliases
        # either)
        _buf_append(state, s, ei, ej, dl)
    else:
        cuts = np.searchsorted(w_off, np.arange(1, w_max + 1), side="left")
        segs = np.split(np.arange(n), cuts)
        # segment 0 completes the open window
        s0 = segs[0]
        _buf_append(state, s, ei[s0], ej[s0],
                    None if dl is None else dl[s0])
        end_tau = (float(tau[s0[-1]]) if s0.shape[0]
                   else float(state.buf_last_tau[s]))
        bi, bj, bop = _buf_take(state, s)
        closed.append((s, bi, bj, _norm_ops(bop), int(bop.sum()), end_tau))
        # middle segments are whole windows in their own right
        for seg in segs[1:-1]:
            ops = None if dl is None else _norm_ops(dl[seg])
            m = int(seg.shape[0]) if ops is None else int(ops.sum())
            closed.append((s, ei[seg], ej[seg], ops, m, float(tau[seg[-1]])))
        # the last segment becomes the new open window
        _buf_append(state, s, ei[segs[-1]], ej[segs[-1]],
                    None if dl is None else dl[segs[-1]])
    state.uniq[s] = uniq_idx_last - w_max * nt_w + 1
    state.buf_last_tau[s] = float(tau[-1])
    state.last_tau[s] = float(tau[-1])


def _push_one_stream(
    state: StreamState, s: int, tau: np.ndarray, ei: np.ndarray,
    ej: np.ndarray, nt_w: int, dl: np.ndarray | None = None,
    on_missing_delete: str = "raise",
) -> list[tuple[int, np.ndarray, np.ndarray, np.ndarray | None, int, float]]:
    """Single-stream fast path of :func:`windowizer_push`: the whole chunk
    belongs to stream ``s``, so no grouping pass runs — this is the
    per-push hot loop of serving (micro-batches of one are common), kept
    as lean as the pre-fleet engine's."""
    if not 0 <= s < state.n_streams:
        raise ValueError(f"stream_id out of range [0, {state.n_streams})")
    if not np.isfinite(tau).all():
        # a NaN would alias the NO_TAU sentinel, slip past the order
        # check (NaN < x is False) and count as a new unique timestamp
        # per record — reject it loudly, same contract as windowize
        raise ValueError("timestamps must be finite")
    last = state.last_tau[s]
    if np.any(np.diff(tau) < 0) or (
            not np.isnan(last) and tau[0] < last):
        raise ValueError("timestamps must be non-decreasing (stream order)")
    if state.finalized[s]:
        raise RuntimeError("push after finalize(); stream already ended")

    # unique-timestamp rank of each record, continuing the open window
    uniq0 = int(state.uniq[s])
    prev = state.buf_last_tau[s] if uniq0 else NO_TAU
    n = tau.shape[0]
    is_new = np.empty(n, dtype=np.int64)
    is_new[0] = 1 if (np.isnan(prev) or tau[0] != prev) else 0
    is_new[1:] = tau[1:] != tau[:-1]
    uniq_idx = uniq0 - 1 + np.cumsum(is_new)   # 0-based within window run
    w_off = uniq_idx // nt_w                   # 0 = still the open window

    if dl is not None and (dl == -1).any():
        # still pre-mutation: a raise here leaves the stream untouched
        dl = _apply_missing_delete_policy(state, s, ei, ej, w_off, dl,
                                          on_missing_delete)

    closed: list[tuple[int, np.ndarray, np.ndarray, np.ndarray | None,
                       int, float]] = []
    _ingest_ranked(state, s, tau, ei, ej, int(uniq_idx[-1]), w_off, nt_w,
                   closed, dl=dl)
    return closed

def _push_one_record(
    state: StreamState, s: int, tau: float, ei: int, ej: int, nt_w: int,
) -> list[tuple[int, np.ndarray, np.ndarray, np.ndarray | None, int, float]]:
    """Scalar fast path of :func:`windowizer_push`: ONE insert record, all
    arithmetic in plain Python.  mb=1 serving spends its whole budget here —
    the vector path's array round-trips (``normalize_records``, ``diff``,
    ``cumsum``) cost ~40us per call, two orders of magnitude more than the
    one comparison and three buffer writes a single record actually needs.
    Bit-identical to the vector path by construction: same validation
    messages, same close rule (a record whose unique-timestamp rank hits
    ``nt_w`` ends the open window and seeds the next), same closed-window
    tuples (``_buf_take`` copies, ``_norm_ops`` collapse, net count)."""
    buf_len = state.buf_len
    if not 0 <= s < buf_len.shape[0]:
        raise ValueError(f"stream_id out of range [0, {buf_len.shape[0]})")
    tau = float(tau)
    if not math.isfinite(tau):
        raise ValueError("timestamps must be finite")
    if tau < state.last_tau[s]:  # NaN (no record yet) compares False,
        # exactly as the array path's explicit isnan guard
        raise ValueError("timestamps must be non-decreasing (stream order)")
    if state.finalized[s]:
        raise RuntimeError("push after finalize(); stream already ended")

    buf_last_tau = state.buf_last_tau
    uniq0 = int(state.uniq[s])
    prev = float(buf_last_tau[s]) if uniq0 else NO_TAU
    is_new = 1 if (math.isnan(prev) or tau != prev) else 0
    uniq_idx = uniq0 - 1 + is_new
    closed: list[tuple[int, np.ndarray, np.ndarray, np.ndarray | None,
                       int, float]] = []
    if uniq_idx >= nt_w:
        # rank nt_w: the open window is complete and this record opens the
        # next one (the vector path's empty completing segment)
        end_tau = float(buf_last_tau[s])
        bi, bj, bop = _buf_take(state, s)
        closed.append((s, bi, bj, _norm_ops(bop), int(bop.sum()), end_tau))
        uniq_idx -= nt_w
    pos = int(buf_len[s])
    cap = state.buf_i.shape[1]
    if pos >= cap:
        pad = ((0, 0), (0, cap))  # double, as _buf_append
        state.buf_i = np.pad(state.buf_i, pad)
        state.buf_j = np.pad(state.buf_j, pad)
        state.buf_op = np.pad(state.buf_op, pad)
    state.buf_i[s, pos] = ei
    state.buf_j[s, pos] = ej
    state.buf_op[s, pos] = 1
    buf_len[s] = pos + 1
    state.uniq[s] = uniq_idx + 1
    buf_last_tau[s] = tau
    state.last_tau[s] = tau
    return closed


# scalar types the fast path accepts without an array round-trip; 0-d
# arrays and lists take the vector path (correct, just not hot)
_SCALAR_TAU = (int, float, np.integer, np.floating)
_SCALAR_ID = (int, np.integer)
# native dtype descriptors are interned, so the hot path can compare with
# ``is`` (byte-swapped or casting inputs miss and take the vector path)
_DT_F64 = np.dtype(np.float64)
_DT_I64 = np.dtype(np.int64)


def windowizer_push(
    state: StreamState,
    stream_ids: np.ndarray,
    tau: np.ndarray,
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    nt_w: int,
    *,
    op: np.ndarray | None = None,
    on_missing_delete: str = "raise",
) -> list[tuple[int, np.ndarray, np.ndarray, np.ndarray | None, int, float]]:
    """Ingest a tagged micro-batch, closing adaptive windows online.

    Returns the closed windows as ``(stream, edge_i, edge_j, ops, n_sgrs,
    end_tau)`` tuples in per-stream close order (cross-stream order follows
    ascending stream id — irrelevant to any consumer, since streams are
    independent).  ``ops`` is the window's per-record delta lane, ``None``
    for all-insert windows; ``n_sgrs`` is the window's net count (= record
    count for insert-only).  Mutates ``state`` in place.  All validation
    happens *before* any mutation, so a rejected batch leaves the fleet
    untouched.

    ``op`` is the dynamic wire format's per-record op lane: 0 =
    :data:`OP_INSERT`, 1 = :data:`OP_DELETE` (``None`` = all inserts, the
    static wire format).  A delete retracts one multiplicity of its edge
    from its *own* window — tumbling windows renew the graph, so deletes
    never reach back into closed windows.  A delete whose edge has net
    multiplicity 0 follows ``on_missing_delete``: ``"raise"`` (default,
    loud) or ``"ignore"`` (dropped as a no-op record).

    The unique-timestamp rank of every record — for every stream in the
    batch — is computed in one vectorized pass: records stably group by
    stream id (arrival order preserved within a stream), a chunk-global
    ``is_new`` diff marks fresh timestamps, segment starts patch in each
    stream's open-buffer boundary, and a segmented cumsum yields the
    within-stream rank.  Only the window-boundary splits (O(windows
    closed)) run per stream.
    """
    if on_missing_delete not in ("raise", "ignore"):
        raise ValueError(
            "on_missing_delete must be 'raise' or 'ignore', got "
            f"{on_missing_delete!r}")
    if op is None and isinstance(stream_ids, _SCALAR_ID):
        # one insert record — the mb=1 serving hot path; no deletes, so
        # on_missing_delete never applies.  Two shapes land here: bare
        # scalars, and the wire format's length-1 columns (already
        # normalized to float64/int64 — anything else takes the vector
        # path through normalize_records)
        if (type(tau) is np.ndarray and tau.shape == (1,)
                and tau.dtype is _DT_F64
                and type(edge_i) is np.ndarray and edge_i.shape == (1,)
                and edge_i.dtype is _DT_I64
                and type(edge_j) is np.ndarray and edge_j.shape == (1,)
                and edge_j.dtype is _DT_I64):
            return _push_one_record(state, int(stream_ids), tau[0],
                                    int(edge_i[0]), int(edge_j[0]), nt_w)
        if (isinstance(tau, _SCALAR_TAU) and isinstance(edge_i, _SCALAR_ID)
                and isinstance(edge_j, _SCALAR_ID)):
            return _push_one_record(state, int(stream_ids), tau,
                                    int(edge_i), int(edge_j), nt_w)
    # the shared wire schema owns shape/dtype/op-range normalization
    # (repro_torch.streams.wire); an all-insert op lane comes back as rb.op=None
    rb = normalize_records(tau, edge_i, edge_j, op=op, stream_id=stream_ids)
    tau, ei, ej = rb.tau, rb.edge_i, rb.edge_j
    # wire op (0 insert / 1 delete) -> internal delta lane (+1 / -1)
    dl = None if rb.op is None else (1 - 2 * rb.op).astype(np.int8)
    if rb.single_stream:
        # scalar tag: the whole batch is one stream's — the dominant
        # serving shape (and the single-stream engine's only shape), so it
        # skips the grouping machinery entirely
        if tau.size == 0:
            return []
        return _push_one_stream(state, int(rb.stream_id), tau, ei, ej, nt_w,
                                dl, on_missing_delete)
    sid = rb.stream_id
    if tau.size == 0:
        return []
    if sid[0] == sid[-1] and (sid == sid[0]).all():
        return _push_one_stream(state, int(sid[0]), tau, ei, ej, nt_w,
                                dl, on_missing_delete)
    if sid.min() < 0 or sid.max() >= state.n_streams:
        raise ValueError(
            f"stream_id out of range [0, {state.n_streams})")
    if not np.isfinite(tau).all():
        # a NaN would alias the NO_TAU sentinel, slip past the order
        # check (NaN < x is False) and count as a new unique timestamp
        # per record — reject it loudly, same contract as windowize
        raise ValueError("timestamps must be finite")

    # stable grouping: per-stream contiguous segments, arrival order kept
    order = np.argsort(sid, kind="stable")
    if np.array_equal(order, np.arange(order.shape[0])):
        t, gi, gj, gs = tau, ei, ej, sid  # already grouped (common case)
        gdl = dl
    else:
        t, gi, gj, gs = tau[order], ei[order], ej[order], sid[order]
        gdl = None if dl is None else dl[order]
    n = t.shape[0]
    seg_start = np.concatenate(
        ([0], np.flatnonzero(gs[1:] != gs[:-1]) + 1))
    seg_end = np.concatenate((seg_start[1:], [n]))
    seg_sid = gs[seg_start]

    # per-stream validation (before any mutation)
    bad = np.diff(t) < 0
    bad[seg_start[1:] - 1] = False  # stream boundaries may go backwards
    if bad.any():
        raise ValueError("timestamps must be non-decreasing (stream order)")
    first = t[seg_start]
    prev_seen = state.last_tau[seg_sid]
    if np.any(~np.isnan(prev_seen) & (first < prev_seen)):
        raise ValueError("timestamps must be non-decreasing (stream order)")
    if state.finalized[seg_sid].any():
        raise RuntimeError("push after finalize(); stream already ended")

    # unique-timestamp rank of each record, continuing each open window:
    # record r is "new" when its tau differs from its predecessor (the
    # stream's last buffered tau at segment starts — close boundaries
    # always fall on a strictly increasing tau, so the diff is exact)
    is_new = np.empty(n, dtype=np.int64)
    is_new[1:] = t[1:] != t[:-1]
    prev = np.where(state.uniq[seg_sid] > 0,
                    state.buf_last_tau[seg_sid], NO_TAU)
    is_new[seg_start] = np.isnan(prev) | (first != prev)
    # segmented cumsum -> within-stream unique rank, then window offset
    cum = np.cumsum(is_new)
    base = np.zeros(n, dtype=np.int64)
    base[seg_start] = np.r_[0, cum[seg_start[1:] - 1]]
    base = np.maximum.accumulate(base)
    rank = cum - base                                # 1-based within segment
    uniq_idx = state.uniq[gs] - 1 + rank             # 0-based within window run
    w_off = uniq_idx // nt_w                         # 0 = still the open window

    # per-stream missing-delete policy, still pre-mutation: an offending
    # segment raises before ANY stream's state changes
    seg_dl: list[np.ndarray | None] = []
    for a, b, s in zip(seg_start, seg_end, seg_sid):
        d = None if gdl is None else gdl[a:b]
        if d is not None and (d == -1).any():
            d = _apply_missing_delete_policy(
                state, int(s), gi[a:b], gj[a:b], w_off[a:b], d,
                on_missing_delete)
        seg_dl.append(d)

    closed: list[tuple[int, np.ndarray, np.ndarray, np.ndarray | None,
                       int, float]] = []
    for a, b, s, d in zip(seg_start, seg_end, seg_sid, seg_dl):
        _ingest_ranked(state, int(s), t[a:b], gi[a:b], gj[a:b],
                       int(uniq_idx[b - 1]), w_off[a:b], nt_w, closed, dl=d)
    return closed


def windowizer_close_tail(
    state: StreamState, s: int, nt_w: int, *, drop_partial: bool,
) -> tuple[int, np.ndarray, np.ndarray, np.ndarray | None, int, float] | None:
    """End stream ``s``: close the trailing window (kept if it filled its
    quota, else per ``drop_partial``) and mark the stream finalized.
    Returns the closed window tuple (same 6-tuple shape as
    :func:`windowizer_push`), or None if the tail was dropped or empty."""
    out = None
    if int(state.buf_len[s]) and (int(state.uniq[s]) >= nt_w
                                  or not drop_partial):
        bi, bj, bop = _buf_take(state, s)
        out = (s, bi, bj, _norm_ops(bop), int(bop.sum()),
               float(state.buf_last_tau[s]))
    state.buf_len[s] = 0
    state.uniq[s] = 0
    state.finalized[s] = True
    return out
