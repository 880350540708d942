"""Multi-tenant stream serving: N independent sgr streams through ONE engine.

The port's copy of ``repro.streams.multi``.  :class:`MultiStreamSGrapp`
serves N concurrent tenants, each an independent bipartite edge stream with
its own clock, window quota progress, estimator carry and (optionally)
supervised ground-truth prefix, through one shared pipeline::

    push(stream_id, tau, i, j)          tagged micro-batches, any interleaving
          │
          v
    vectorized windowizer               one pass ranks every record's unique
    (streams.state.windowizer_push)     timestamp for ALL streams at once;
          │                             windows close per stream
          v
    per-stream pending closed windows   (fleet-wide flush_every batching)
          │
          v
    pack_windows(stream_ids=...)  ──>  ONE WindowExecutor: windows of
          │                            different tenants share bucket chunks
          v                            (one K1 launch, or K2 for multiset,
    counts scatter back per tenant     per chunk on the pallas tier)
          │
          v
    advance_estimator per tenant, the single-stream engine's step

**Bit-identical to dedicated engines.**  Each tenant's estimates equal a
:class:`~repro_torch.streams.engine.StreamingSGrapp` on the same stream:
same windowizer, same packer, same counts (co-batching never changes an
integer count), and the same float32 scalar step per window through the
shared :func:`~repro_torch.streams.engine.advance_estimator`.

**Checkpointing.**  :meth:`state_dict` is the reference's fleet schema (v4):
per-stream scalars become ``[N]`` lanes, the ragged open-window buffers and
histories concatenate with ``[N+1]`` offset lanes.  :meth:`restore` is
strict and migrates v1-v3 fleet dicts forward, and a restored fleet resumes
every tenant bit for bit.
"""
from __future__ import annotations

import numpy as np

from ..core.executor import WindowExecutor
from ..core.sgrapp import SGrappResult, estimator_step
from ..core.windows import pack_windows
from .config import (
    _UNSET,
    EngineConfig,
    resolve_engine_config,
    resolve_sync_dispatch,
)
from .engine import (
    STATE_DICT_VERSION,
    advance_estimator,
    check_state_dict_keys,
    config_from_bytes,
    config_to_bytes,
    migrate_state_dict_to_latest,
    resolve_pending_window,
)
from .state import (
    OP_DELETE,
    StreamState,
    estimator_carry,
    set_estimator_carry,
    stream_state_init,
    windowizer_close_tail,
    windowizer_push,
)

__all__ = ["MultiStreamSGrapp"]

# the reference's fleet schemas: v1 insert-only; v2 adds the flat "buf_op"
# lane (aligned with "buf_i" through "buf_offsets"); v3 the per-stream
# "res_seed" lane; v4 the fleet identity, "config" (EngineConfig JSON as
# uint8) and "alpha0" ([N] float64)
_MULTI_STATE_DICT_KEYS_V1 = frozenset({
    "version", "n_streams", "nt_w", "buf_i", "buf_j", "buf_offsets",
    "buf_last_tau", "buf_len", "uniq", "last_tau", "total_sgrs", "finalized",
    "counts", "estimates", "cum_sgrs", "end_tau", "hist_offsets",
    "carry_cum", "carry_alpha", "carry_err", "carry_sup",
})
_MULTI_STATE_DICT_KEYS_V2 = _MULTI_STATE_DICT_KEYS_V1 | {"buf_op"}
_MULTI_STATE_DICT_KEYS_V3 = _MULTI_STATE_DICT_KEYS_V2 | {"res_seed"}
_MULTI_STATE_DICT_KEYS = _MULTI_STATE_DICT_KEYS_V3 | {"config", "alpha0"}
_MULTI_STATE_DICT_SCHEMAS = {1: _MULTI_STATE_DICT_KEYS_V1,
                             2: _MULTI_STATE_DICT_KEYS_V2,
                             3: _MULTI_STATE_DICT_KEYS_V3,
                             4: _MULTI_STATE_DICT_KEYS}


def _ragged_concat(parts: list, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate per-stream ragged arrays into (flat, offsets[N+1])."""
    offsets = np.zeros(len(parts) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(p) for p in parts])
    flat = (np.concatenate([np.asarray(p, dtype=dtype) for p in parts])
            if offsets[-1] else np.zeros(0, dtype=dtype))
    return flat, offsets


class MultiStreamSGrapp:
    """Online sGrapp / sGrapp-x over N concurrent tenant streams.

    Parameters
    ----------
    n_streams : number of tenants; stream ids are ``0 .. n_streams-1``.
    nt_w : window quota, shared by every tenant.
    alpha0 : initial inter-window exponent, a scalar (shared) or one per
        tenant.
    truths : ``None`` (plain sGrapp for every tenant) or one entry per
        tenant: its cumulative ground-truth prefix, or ``None``.
    config : an :class:`EngineConfig` carrying every shared knob (tier,
        flush batching, duplicate and delete semantics, sampling knobs,
        device, the ``devices`` / ``mesh`` sharding); the per-knob
        keyword arguments remain a deprecated shim, as for the
        single-stream engine.  ``flush_every`` counts the
        pending windows of all tenants together.  Tenant ``s`` gets the
        reservoir seed ``seed + s``.
    executor : a prebuilt :class:`WindowExecutor` serving every tenant.
    """

    def __init__(self, n_streams: int, nt_w: int, alpha0, *, truths=None,
                 config: EngineConfig | None = None,
                 executor: WindowExecutor | None = None,
                 tol=_UNSET, step=_UNSET, tier=_UNSET, device=_UNSET,
                 devices=_UNSET, mesh=_UNSET, flush_every=_UNSET,
                 drop_partial=_UNSET, align=_UNSET, dup_policy=_UNSET,
                 on_missing_delete=_UNSET, seed=_UNSET):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if nt_w <= 0:
            raise ValueError("nt_w must be positive")
        cfg = resolve_engine_config(config, dict(
            tol=tol, step=step, tier=tier, device=device, devices=devices,
            mesh=mesh, flush_every=flush_every, drop_partial=drop_partial,
            align=align, dup_policy=dup_policy,
            on_missing_delete=on_missing_delete, seed=seed))
        self.config = cfg
        if truths is not None and len(truths) != n_streams:
            raise ValueError(
                f"truths must have one entry per stream ({n_streams}), "
                f"got {len(truths)}")
        self.nt_w = int(nt_w)
        if np.ndim(alpha0) == 0:
            self.alpha0: float | list[float] = float(alpha0)
        else:
            alphas = [float(a) for a in np.asarray(alpha0).ravel()]
            if len(alphas) != n_streams:
                raise ValueError(
                    f"alpha0 must be a scalar or one entry per stream "
                    f"({n_streams}), got {len(alphas)}")
            self.alpha0 = alphas
        self.truths = (None if truths is None else
                       [None if t is None else np.asarray(t, dtype=np.float64)
                        for t in truths])
        self.flush_every = cfg.flush_every
        self.drop_partial = cfg.drop_partial
        self.align = cfg.align
        self.dup_policy = cfg.dup_policy
        self.on_missing_delete = cfg.on_missing_delete
        self.seed = cfg.seed
        self.executor = cfg.make_executor(executor)
        self.device = self.executor.device
        self._step_fn = estimator_step(cfg.tol, cfg.step, self.device)
        self.sync_dispatch = resolve_sync_dispatch(cfg)
        # owner-driven dispatch, as the single-stream engine: push() skips
        # the flush_every self-submit so the owner schedules submit/reap
        self.defer_dispatch = False
        if cfg.warmup:
            self.executor.warmup(
                cfg.warmup, multiset=(cfg.dup_policy == "multiset"))

        n = int(n_streams)
        self._state: StreamState = stream_state_init(n, self.alpha0,
                                                     seed=cfg.seed)
        # per-stream closed-but-uncounted windows, in close order, and the
        # set of streams that have any
        self._pending: list[list[tuple]] = [[] for _ in range(n)]
        self._pending_streams: set[int] = set()
        self._n_pending_total = 0
        # the one in-flight flush: (streams, n_per_stream, handle, cum,
        # end_tau)
        self._inflight: tuple | None = None
        self._counts: list[list[float]] = [[] for _ in range(n)]
        self._estimates: list[list[np.float32]] = [[] for _ in range(n)]
        self._cum_sgrs: list[list[int]] = [[] for _ in range(n)]
        self._end_tau: list[list[float]] = [[] for _ in range(n)]

    # -- introspection -------------------------------------------------------

    @property
    def n_streams(self) -> int:
        return self._state.n_streams

    @property
    def tier(self) -> str:
        return self.executor.tier

    @property
    def n_pending(self) -> int:
        """Closed-but-uncounted windows across the fleet: awaiting dispatch
        + in flight."""
        return self._n_pending_total + self.n_inflight

    @property
    def n_inflight(self) -> int:
        """Windows inside the submitted-but-unreaped dispatch."""
        if self._inflight is None:
            return 0
        return sum(self._inflight[1])

    def _inflight_for(self, s: int) -> int:
        if self._inflight is None:
            return 0
        streams, n_per_stream = self._inflight[0], self._inflight[1]
        return n_per_stream[streams.index(s)] if s in streams else 0

    def n_windows(self, stream_id: int | None = None) -> int:
        """Windows closed so far (counted, in flight, or pending), for one
        tenant or, with ``stream_id=None``, the whole fleet."""
        if stream_id is not None:
            s = self._check_stream(stream_id)
            return (len(self._counts[s]) + len(self._pending[s])
                    + self._inflight_for(s))
        return sum(len(c) for c in self._counts) + self.n_pending

    def alpha(self, stream_id: int) -> float:
        """A tenant's current (possibly adapted) alpha."""
        return float(self._state.carry_alpha[self._check_stream(stream_id)])

    def cum_sgrs(self, stream_id: int) -> int:
        """A tenant's |E|: total sgrs in its counted windows."""
        return int(self._state.total_sgrs[self._check_stream(stream_id)])

    def n_counted(self, stream_id: int) -> int:
        """Windows already counted for one tenant."""
        return len(self._counts[self._check_stream(stream_id)])

    def history(self, stream_id: int, start: int = 0) -> dict:
        """One tenant's counted-window history from window ``start`` (no
        flush), as plain-Python parallel lists: ``window``, ``count``,
        ``estimate``, ``cum_sgrs``, ``end_tau``."""
        s = self._check_stream(stream_id)
        if start < 0:
            raise ValueError(f"start must be >= 0, got {start}")
        return {
            "window": list(range(start, len(self._counts[s]))),
            "count": [float(c) for c in self._counts[s][start:]],
            "estimate": [float(e) for e in self._estimates[s][start:]],
            "cum_sgrs": [int(c) for c in self._cum_sgrs[s][start:]],
            "end_tau": [float(t) for t in self._end_tau[s][start:]],
        }

    def _check_stream(self, stream_id) -> int:
        s = int(stream_id)
        if not 0 <= s < self.n_streams:
            raise ValueError(
                f"stream_id {s} out of range [0, {self.n_streams})")
        return s

    # -- ingestion -----------------------------------------------------------

    def push(self, stream_id, tau, edge_i, edge_j, op=None) -> int:
        """Ingest a tagged micro-batch: ``stream_id`` is a scalar (the whole
        batch is one tenant's) or one id per record (interleaved tenants;
        records group stably per stream).  Returns the number of windows
        closed fleet-wide.  Timestamps must be non-decreasing per stream; a
        violating batch raises before any state changes.  ``op``: 0 =
        insert, 1 = delete (``None`` = all inserts)."""
        if op is not None and self.tier == "sampled":
            if np.any(np.atleast_1d(np.asarray(op)) == OP_DELETE):
                raise NotImplementedError(
                    "the sampled tier does not support edge deletions: "
                    "reservoir estimates are insert-only (FLEET)")
        closed = windowizer_push(self._state, stream_id, tau, edge_i, edge_j,
                                 self.nt_w, op=op,
                                 on_missing_delete=self.on_missing_delete)
        for s, ei, ej, ops, m, end_tau in closed:
            self._pending[s].append((ei, ej, ops, m, end_tau))
            self._pending_streams.add(s)
        self._n_pending_total += len(closed)
        if (self._n_pending_total >= self.flush_every
                and not self.defer_dispatch):
            if self.sync_dispatch:
                self.flush()
            else:
                self._reap_flush()
                self._submit_flush()
        return len(closed)

    # -- counting + estimation ----------------------------------------------

    def _submit_flush(self) -> bool:
        """Pack every tenant's pending windows into ONE batch (with the
        stream-id provenance lane) and dispatch ONE bucketed count without
        waiting; returns True iff a dispatch is now in flight."""
        if self._n_pending_total == 0:
            return False
        if self._inflight is not None:
            raise RuntimeError("reap the in-flight flush first")
        streams = sorted(self._pending_streams)
        per_edges: list[np.ndarray] = []
        per_mult: list[np.ndarray | None] = []
        n_sgrs: list[int] = []
        end_tau: list[float] = []
        cum: list[int] = []
        sids: list[int] = []
        for s in streams:
            c = int(self._state.total_sgrs[s])
            for ei, ej, ops, m, t in self._pending[s]:
                e, mu = resolve_pending_window(ei, ej, ops, self.dup_policy)
                per_edges.append(e)
                per_mult.append(mu)
                n_sgrs.append(m)
                end_tau.append(t)
                c += m
                cum.append(c)
                sids.append(s)
        # each window's sampling uid: its tenant's res_seed over its |E_k|,
        # packed as the single-stream engine packs it
        rs = self._state.res_seed[np.asarray(sids, dtype=np.int64)]
        hi = (rs & np.int64(0xFFFFFFFF)).astype(np.uint64)
        lo = (np.asarray(cum, dtype=np.int64) & np.int64(0xFFFFFFFF)) \
            .astype(np.uint64)
        uid = ((hi << np.uint64(32)) + lo).astype(np.int64)
        multiset = self.dup_policy == "multiset"
        batch = pack_windows(
            per_edges, n_sgrs=np.asarray(n_sgrs, dtype=np.int64),
            cum_sgrs=np.asarray(cum, dtype=np.int64),
            window_end_tau=np.asarray(end_tau, dtype=np.float64),
            align=self.align, stream_ids=np.asarray(sids, dtype=np.int32),
            dedupe=not multiset,
            per_window_mult=per_mult if multiset else None,
            sample_uid=uid)
        handle = self.executor.window_counts_submit(batch)
        # windows stay pending until dispatched: a packing error raises
        # above with every pending list intact
        n_per_stream = [len(self._pending[s]) for s in streams]
        for s in streams:
            self._pending[s] = []
        self._pending_streams.clear()
        self._n_pending_total = 0
        self._inflight = (streams, n_per_stream, handle, cum, end_tau)
        return True

    def _reap_flush(self) -> int:
        """Wait for the in-flight counts, scatter them back per tenant (each
        tenant's windows are one contiguous slice, in close order) and
        advance each tenant's estimator; the only place any tenant's
        estimator advances."""
        if self._inflight is None:
            return 0
        streams, n_per_stream, handle, cum, end_tau = self._inflight
        counts = handle.reap()
        self._inflight = None
        off = 0
        for s, n_new in zip(streams, n_per_stream):
            sl = slice(off, off + n_new)
            tr = self.truths[s] if self.truths is not None else None
            carry = advance_estimator(
                self._step_fn, estimator_carry(self._state, s), tr,
                counts[sl], cum[sl], end_tau[sl], self._counts[s],
                self._estimates[s], self._cum_sgrs[s], self._end_tau[s],
                device=self.device)
            set_estimator_carry(self._state, s, carry)
            self._state.total_sgrs[s] = int(cum[off + n_new - 1])
            off += n_new
        return len(counts)

    def flush(self) -> int:
        """Count every closed-but-uncounted window fleet-wide (in flight and
        pending) in one dispatch and advance each tenant's estimator;
        returns the number of windows settled."""
        n = self._reap_flush()
        if self._submit_flush():
            n += self._reap_flush()
        return n

    def _close_tail(self, s: int) -> None:
        if self._state.finalized[s]:
            return
        tail = windowizer_close_tail(self._state, s, self.nt_w,
                                     drop_partial=self.drop_partial)
        if tail is not None:
            _, ei, ej, ops, m, end_tau = tail
            self._pending[s].append((ei, ej, ops, m, end_tau))
            self._pending_streams.add(s)
            self._n_pending_total += 1

    def finalize(self) -> list[SGrappResult]:
        """End every stream (trailing windows close per ``drop_partial``),
        flush, and return one :class:`SGrappResult` per tenant."""
        for s in range(self.n_streams):
            self._close_tail(s)
        return self.results()

    def finalize_stream(self, stream_id: int) -> SGrappResult:
        """End ONE tenant's stream without touching the others; equal to a
        dedicated engine's ``finalize()``."""
        s = self._check_stream(stream_id)
        self._close_tail(s)
        return self.result(s)

    def result(self, stream_id: int) -> SGrappResult:
        """One tenant's estimate so far (flushes the fleet first)."""
        s = self._check_stream(stream_id)
        self.flush()
        return SGrappResult(
            estimates=np.array(self._estimates[s], dtype=np.float32),
            window_counts=np.array(self._counts[s], dtype=np.float64),
            cum_edges=np.array(self._cum_sgrs[s], dtype=np.float64),
            alpha_final=float(self._state.carry_alpha[s]),
            truths=self.truths[s] if self.truths is not None else None,
        )

    def results(self) -> list[SGrappResult]:
        """Every tenant's result, indexed by stream id."""
        self.flush()
        return [self.result(s) for s in range(self.n_streams)]

    # -- checkpointing -------------------------------------------------------

    def state_dict(self) -> dict:
        """Whole-fleet state as the reference's v4 fleet dict of numpy
        leaves (pending windows are flushed first, which changes no
        estimate)."""
        self.flush()
        st = self._state
        n = self.n_streams
        lens = [int(st.buf_len[s]) for s in range(n)]
        buf_i, buf_off = _ragged_concat(
            [st.buf_i[s, :lens[s]] for s in range(n)], np.int64)
        buf_j, _ = _ragged_concat(
            [st.buf_j[s, :lens[s]] for s in range(n)], np.int64)
        buf_op, _ = _ragged_concat(
            [st.buf_op[s, :lens[s]] for s in range(n)], np.int8)
        counts, hist_off = _ragged_concat(self._counts, np.float64)
        estimates, _ = _ragged_concat(self._estimates, np.float32)
        cum_sgrs, _ = _ragged_concat(self._cum_sgrs, np.int64)
        end_tau, _ = _ragged_concat(self._end_tau, np.float64)
        return {
            "version": np.int64(STATE_DICT_VERSION),
            "n_streams": np.int64(n),
            "nt_w": np.int64(self.nt_w),
            "buf_i": buf_i,
            "buf_j": buf_j,
            "buf_op": buf_op,
            "buf_offsets": buf_off,
            "buf_last_tau": st.buf_last_tau.copy(),
            "buf_len": st.buf_len.copy(),
            "uniq": st.uniq.copy(),
            "last_tau": st.last_tau.copy(),
            "total_sgrs": st.total_sgrs.copy(),
            "finalized": st.finalized.copy(),
            "counts": counts,
            "estimates": estimates,
            "cum_sgrs": cum_sgrs,
            "end_tau": end_tau,
            "hist_offsets": hist_off,
            "carry_cum": st.carry_cum.copy(),
            "carry_alpha": st.carry_alpha.copy(),
            "carry_err": st.carry_err.copy(),
            "carry_sup": st.carry_sup.copy(),
            "res_seed": st.res_seed.copy(),
            "config": config_to_bytes(self.config),
            "alpha0": np.broadcast_to(
                np.asarray(self.alpha0, dtype=np.float64), (n,)).copy(),
        }

    def restore(self, state: dict) -> "MultiStreamSGrapp":
        """Load a :meth:`state_dict` of any supported version (v1-v3
        migrate forward); the fleet's config comes from the constructor.
        Strict: key drift, an unknown version or an ``nt_w`` /
        ``n_streams`` mismatch raise.  Returns ``self``."""
        version = check_state_dict_keys(state, _MULTI_STATE_DICT_SCHEMAS,
                                        schema="MultiStreamSGrapp")
        state = migrate_state_dict_to_latest(state, version)
        if int(state["nt_w"]) != self.nt_w:
            raise ValueError(
                f"checkpoint nt_w={int(state['nt_w'])} != engine "
                f"nt_w={self.nt_w}")
        if int(state["n_streams"]) != self.n_streams:
            raise ValueError(
                f"checkpoint n_streams={int(state['n_streams'])} != engine "
                f"n_streams={self.n_streams}")
        n = self.n_streams
        buf_off = np.asarray(state["buf_offsets"], dtype=np.int64)
        buf_i = np.asarray(state["buf_i"], dtype=np.int64)
        buf_j = np.asarray(state["buf_j"], dtype=np.int64)
        buf_op = np.asarray(state["buf_op"], dtype=np.int8)
        buf_len = np.asarray(state["buf_len"], dtype=np.int64)
        cap = max(256, int(buf_len.max()))
        st = stream_state_init(n, self.alpha0, buf_capacity=cap,
                               seed=self.seed)
        for s in range(n):
            a, b = int(buf_off[s]), int(buf_off[s + 1])
            st.buf_i[s, :b - a] = buf_i[a:b]
            st.buf_j[s, :b - a] = buf_j[a:b]
            st.buf_op[s, :b - a] = buf_op[a:b]
        st.buf_len[:] = buf_len
        st.buf_last_tau[:] = np.asarray(state["buf_last_tau"], np.float64)
        st.uniq[:] = np.asarray(state["uniq"], np.int64)
        st.last_tau[:] = np.asarray(state["last_tau"], np.float64)
        st.total_sgrs[:] = np.asarray(state["total_sgrs"], np.int64)
        st.finalized[:] = np.asarray(state["finalized"], bool)
        st.carry_cum[:] = np.asarray(state["carry_cum"], np.float32)
        st.carry_alpha[:] = np.asarray(state["carry_alpha"], np.float32)
        st.carry_err[:] = np.asarray(state["carry_err"], np.float32)
        st.carry_sup[:] = np.asarray(state["carry_sup"], bool)
        # the checkpoint's reservoir seeds win: each tenant's uid sequence
        # continues the saving fleet's coins
        st.res_seed[:] = np.asarray(state["res_seed"], np.int64)
        self._state = st
        hist_off = np.asarray(state["hist_offsets"], dtype=np.int64)
        counts = np.asarray(state["counts"], np.float64)
        estimates = np.asarray(state["estimates"], np.float32)
        cum_sgrs = np.asarray(state["cum_sgrs"], np.int64)
        end_tau = np.asarray(state["end_tau"], np.float64)
        for s in range(n):
            a, b = int(hist_off[s]), int(hist_off[s + 1])
            self._counts[s] = [float(c) for c in counts[a:b]]
            self._estimates[s] = [np.float32(e) for e in estimates[a:b]]
            self._cum_sgrs[s] = [int(c) for c in cum_sgrs[a:b]]
            self._end_tau[s] = [float(t) for t in end_tau[a:b]]
        self._pending = [[] for _ in range(n)]
        self._pending_streams = set()
        self._n_pending_total = 0
        self._inflight = None
        return self

    @classmethod
    def from_state_dict(cls, state: dict, *, truths=None,
                        config: EngineConfig | None = None,
                        executor: WindowExecutor | None = None,
                        device=None) -> "MultiStreamSGrapp":
        """Rebuild a fleet from a self-describing (v4) :meth:`state_dict`
        alone: ``n_streams``, ``nt_w``, per-stream ``alpha0`` and the
        embedded config come from the dict.  ``config=`` overrides the
        embedded config; ``device=`` says where the fleet runs.  A pre-v4
        dict carries no config and raises unless ``config=`` is given."""
        version = check_state_dict_keys(state, _MULTI_STATE_DICT_SCHEMAS,
                                        schema="MultiStreamSGrapp")
        state = migrate_state_dict_to_latest(state, version)
        if config is None:
            payload = config_from_bytes(state["config"])
            if not payload:
                raise ValueError(
                    "checkpoint carries no EngineConfig (pre-v4 schema "
                    "migrated forward): construct the fleet explicitly "
                    "and call restore(), or pass config=")
            config = EngineConfig.from_json(payload, device=device)
        elif device is not None:
            config = config.replace(device=device)
        alpha0 = [float(a) for a in np.asarray(state["alpha0"],
                                               dtype=np.float64)]
        fleet = cls(int(state["n_streams"]), int(state["nt_w"]), alpha0,
                    truths=truths, config=config, executor=executor)
        return fleet.restore(state)
