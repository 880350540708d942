"""Online streaming ingestion engine: push sgrs, get estimates (paper Alg. 3+5).

The port's ``StreamingSGrapp`` (single stream; ``distinct`` or ``multiset``
duplicate policy, inserts and deletes)::

    push(tau, i, j) ──> online windowizer ──> pending closed windows
                                               │  (flush_every batching)
                                               v
            pack_windows  ──>  persistent WindowExecutor  ──>  exact counts
                                               │
                                               v
            the shared estimator step per window, on the executor's device

* **Bit-identical to replay.**  The same stream pushed in micro-batches of
  any size gives exactly the estimates of ``run_sgrapp`` / ``run_sgrapp_x``
  over ``windowize`` on the same device: same packer, same exact counts,
  same float32 step through the one loop
  :func:`repro_torch.core.sgrapp.estimator_run`.
* **Overlapped flushes.**  ``push`` submits a flush without waiting for the
  device and reaps it at the next flush point; the estimator advances only
  at reap, in close order, so flush timing never changes an estimate.
* **Checkpoints that carry across.**  :meth:`StreamingSGrapp.state_dict` is
  the reference's schema v4, a flat dict of numpy leaves with the
  :class:`EngineConfig` as JSON bytes: a dict written by either package
  restores into the other and continues to the same counts.  Older dicts
  (v1-v3) migrate forward on restore through the reference's chain
  (:func:`migrate_state_dict_to_latest`), shared with
  :class:`repro_torch.streams.multi.MultiStreamSGrapp`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.executor import WindowExecutor
from ..core.sgrapp import SGrappResult, estimator_run, estimator_step
from ..core.windows import pack_windows
from .config import (
    DUP_POLICIES,
    EngineConfig,
    _UNSET,
    resolve_engine_config,
    resolve_sync_dispatch,
)
from .state import (
    OP_DELETE,
    StreamState,
    estimator_carry,
    resolve_window,
    set_estimator_carry,
    stream_state_init,
    windowizer_close_tail,
    windowizer_push,
)

__all__ = ["StreamingSGrapp", "STATE_DICT_VERSION", "DUP_POLICIES",
           "EngineConfig", "config_to_bytes", "config_from_bytes",
           "advance_estimator", "check_state_dict_keys",
           "migrate_state_dict_v1", "migrate_state_dict_v2",
           "migrate_state_dict_v3", "migrate_state_dict_to_latest"]

# the reference's schema versions: v1 insert-only; v2 adds the open
# window's op lane "buf_op"; v3 the reservoir seed "res_seed"; v4 the
# engine identity "config" (EngineConfig JSON as uint8) and "alpha0"
STATE_DICT_VERSION = 4

_STATE_DICT_KEYS_V1 = frozenset({
    "version", "nt_w", "buf_i", "buf_j", "buf_last_tau", "buf_len", "uniq",
    "last_tau", "total_sgrs", "finalized", "counts", "estimates", "cum_sgrs",
    "end_tau", "carry_cum", "carry_alpha", "carry_err", "carry_sup",
})
_STATE_DICT_KEYS_V2 = _STATE_DICT_KEYS_V1 | {"buf_op"}
_STATE_DICT_KEYS_V3 = _STATE_DICT_KEYS_V2 | {"res_seed"}
_STATE_DICT_KEYS = _STATE_DICT_KEYS_V3 | {"config", "alpha0"}
_STATE_DICT_SCHEMAS = {1: _STATE_DICT_KEYS_V1, 2: _STATE_DICT_KEYS_V2,
                       3: _STATE_DICT_KEYS_V3, 4: _STATE_DICT_KEYS}


def config_to_bytes(config: EngineConfig) -> np.ndarray:
    """The checkpoint encoding of an :class:`EngineConfig`: UTF-8 JSON as a
    uint8 lane (the reference's encoding)."""
    return np.frombuffer(config.to_json().encode("utf-8"),
                         dtype=np.uint8).copy()


def config_from_bytes(lane) -> str:
    """Inverse of :func:`config_to_bytes`; empty lane -> empty string."""
    lane = np.asarray(lane, dtype=np.uint8)
    return bytes(lane.tobytes()).decode("utf-8") if lane.size else ""


def advance_estimator(step_fn, carry, truths, new_counts, new_cums,
                      new_end_taus, counts, estimates, cum_sgrs, end_tau,
                      *, device) -> tuple:
    """Advance ONE stream's estimator over its newly counted windows in
    close order on ``device``, appending to its history lists in place;
    returns the new carry as host scalars.  ``carry`` is the stream's
    :func:`~repro_torch.streams.state.estimator_carry`; window k is
    supervised while ``k < len(truths)``.  Both engines' reaps call it, so
    a tenant of a fleet runs the single-stream engine's arithmetic."""
    n = len(new_counts)
    k0 = len(counts)
    ks = np.arange(k0, k0 + n)
    truth = np.zeros(n, dtype=np.float64)
    has_truth = np.zeros(n, dtype=bool)
    if truths is not None:
        has_truth = ks < len(truths)
        truth[has_truth] = truths[ks[has_truth]]
    dev_carry = tuple(torch.tensor(c, device=device) for c in carry)
    dev_carry, est = estimator_run(step_fn, dev_carry, new_counts, new_cums,
                                   truth, has_truth, k0)
    counts.extend(float(c) for c in new_counts)
    estimates.extend(est.cpu().numpy())
    cum_sgrs.extend(int(c) for c in new_cums)
    end_tau.extend(float(t) for t in new_end_taus)
    return tuple(c.cpu().numpy() for c in dev_carry)


def check_state_dict_keys(state: dict, expected: dict,
                          *, schema: str) -> int:
    """Strict schema check shared by both engines' ``restore``: the dict's
    key set must equal its own version's schema (``expected`` maps each
    supported version to its key set); returns the version, for the
    migrations.  A dict with no ``version`` reports its drift against the
    newest schema."""
    got = set(state)
    latest = expected[max(expected)]
    if "version" not in got:
        raise ValueError(
            f"{schema} state_dict key mismatch: "
            f"missing={sorted(latest - got)} "
            f"unknown={sorted(got - latest)}")
    version = int(np.asarray(state["version"]))
    if version not in expected:
        raise ValueError(
            f"{schema} state_dict version {version} != supported "
            f"{sorted(expected)}")
    keys = expected[version]
    missing = sorted(keys - got)
    unknown = sorted(got - keys)
    if missing or unknown:
        raise ValueError(
            f"{schema} state_dict key mismatch (version {version}): "
            f"missing={missing} unknown={unknown}")
    return version


def migrate_state_dict_v1(state: dict) -> dict:
    """v1 -> v2, both engines: a v1 engine was insert-only, so the open
    window's op lane is all ones, aligned with ``buf_i``.  Returns a new
    dict; the input is not mutated."""
    out = dict(state)
    out["buf_op"] = np.ones(np.asarray(state["buf_i"]).shape[0],
                            dtype=np.int8)
    out["version"] = np.int64(2)
    return out


def migrate_state_dict_v2(state: dict) -> dict:
    """v2 -> v3, both engines: v2 engines behaved as ``seed=0`` ones, so
    ``res_seed`` is 0 for the single-stream schema and ``arange`` for the
    fleet's (told apart by its ``n_streams`` key).  Returns a new dict."""
    out = dict(state)
    if "n_streams" in state:
        out["res_seed"] = np.arange(int(np.asarray(state["n_streams"])),
                                    dtype=np.int64)
    else:
        out["res_seed"] = np.int64(0)
    out["version"] = np.int64(3)
    return out


def migrate_state_dict_v3(state: dict) -> dict:
    """v3 -> v4, both engines: ``config`` becomes the empty byte lane
    (knobs unknown: the restoring constructor supplies them) and ``alpha0``
    is back-filled from the adapted ``carry_alpha``.  Returns a new dict."""
    out = dict(state)
    out["config"] = np.zeros(0, dtype=np.uint8)
    if "n_streams" in state:
        out["alpha0"] = np.asarray(state["carry_alpha"], dtype=np.float64)
    else:
        out["alpha0"] = np.float64(np.asarray(state["carry_alpha"]))
    out["version"] = np.int64(4)
    return out


def migrate_state_dict_to_latest(state: dict, version: int) -> dict:
    """The forward migration chain from ``version`` to
    :data:`STATE_DICT_VERSION`, shared by both engines."""
    if version == 1:
        state = migrate_state_dict_v1(state)
        version = 2
    if version == 2:
        state = migrate_state_dict_v2(state)
        version = 3
    if version == 3:
        state = migrate_state_dict_v3(state)
    return state


def resolve_pending_window(ei: np.ndarray, ej: np.ndarray,
                           ops: np.ndarray | None, dup_policy: str
                           ) -> tuple[np.ndarray, np.ndarray | None]:
    """One closed window's record list as the ``pack_windows`` inputs its
    duplicate policy calls for: ``(edges, mult)``.

    ``distinct`` with all inserts (``ops is None``): the raw records, for
    the packer's keep-first dedupe, and no multiplicities.  ``distinct``
    with deletes: the net surviving edges (present iff their net
    multiplicity is > 0), multiplicities dropped.  ``multiset``: the net
    surviving edges *with* their multiplicities -- every window resolves,
    because even an insert-only window's duplicates carry weight."""
    if dup_policy == "distinct":
        if ops is None:
            return np.stack([ei, ej], axis=1), None
        ri, rj, _ = resolve_window(ei, ej, ops)
        return np.stack([ri, rj], axis=1), None
    ri, rj, mult = resolve_window(ei, ej, ops)
    return np.stack([ri, rj], axis=1), mult


class StreamingSGrapp:
    """Online sGrapp / sGrapp-x over a pushed sgr stream.

    Parameters
    ----------
    nt_w : window quota -- a window closes after ``nt_w`` unique timestamps
        (Algorithm 3, whole-timestamp semantics as ``windowize``).
    alpha0 : initial inter-window exponent.
    truths : optional cumulative ground-truth counts of the supervised
        prefix (sGrapp-x); ``None`` is plain sGrapp.
    config : an :class:`EngineConfig`; the per-knob keyword arguments remain
        as a deprecated shim that builds one (mixing both raises).
        ``devices`` / ``mesh`` shard each flush's window axis; counts and
        estimates equal the unsharded engine's bit for bit.
    executor : a prebuilt :class:`WindowExecutor` to share.
    """

    def __init__(self, nt_w: int, alpha0: float, *, truths=None,
                 config: EngineConfig | None = None,
                 executor: WindowExecutor | None = None,
                 tol=_UNSET, step=_UNSET, tier=_UNSET, device=_UNSET,
                 devices=_UNSET, mesh=_UNSET, flush_every=_UNSET,
                 drop_partial=_UNSET, align=_UNSET, dup_policy=_UNSET,
                 on_missing_delete=_UNSET, seed=_UNSET):
        if nt_w <= 0:
            raise ValueError("nt_w must be positive")
        cfg = resolve_engine_config(config, dict(
            tol=tol, step=step, tier=tier, device=device, devices=devices,
            mesh=mesh, flush_every=flush_every, drop_partial=drop_partial,
            align=align, dup_policy=dup_policy,
            on_missing_delete=on_missing_delete, seed=seed))
        self.config = cfg
        self.nt_w = int(nt_w)
        self.alpha0 = float(alpha0)
        self.truths = (None if truths is None
                       else np.asarray(truths, dtype=np.float64))
        self.flush_every = cfg.flush_every
        self.drop_partial = cfg.drop_partial
        self.align = cfg.align
        self.on_missing_delete = cfg.on_missing_delete
        self.dup_policy = cfg.dup_policy
        self.executor = cfg.make_executor(executor)
        self.device = self.executor.device
        self._step_fn = estimator_step(cfg.tol, cfg.step, self.device)
        self.sync_dispatch = resolve_sync_dispatch(cfg)
        # owner-driven dispatch: when True, push() never self-submits at the
        # flush_every threshold; the engine's owner (the server's deadline
        # coalescer) schedules _submit_flush / _reap_flush itself.  Runtime
        # attribute, never serialized; flush()/finalize()/state_dict()
        # settle everything regardless.
        self.defer_dispatch = False
        if cfg.warmup:
            self.executor.warmup(cfg.warmup,
                                 multiset=(cfg.dup_policy == "multiset"))
        self._state: StreamState = stream_state_init(1, alpha0, seed=cfg.seed)
        # closed-but-uncounted windows: (edge_i, edge_j, ops, n_sgrs, end_tau)
        self._pending: list[tuple[np.ndarray, np.ndarray,
                                  np.ndarray | None, int, float]] = []
        # the one in-flight flush: (n_windows, PendingCounts, cum, end_tau)
        self._inflight: tuple | None = None
        self._counts: list[float] = []
        self._estimates: list[np.float32] = []
        self._cum_sgrs: list[int] = []
        self._end_tau: list[float] = []

    # -- introspection -------------------------------------------------------

    @property
    def tier(self) -> str:
        return self.executor.tier

    @property
    def n_windows(self) -> int:
        """Windows closed so far (counted, in flight, or pending)."""
        return len(self._counts) + self.n_pending

    @property
    def n_pending(self) -> int:
        """Closed windows not yet counted: awaiting dispatch + in flight."""
        return len(self._pending) + self.n_inflight

    @property
    def n_inflight(self) -> int:
        return 0 if self._inflight is None else self._inflight[0]

    @property
    def alpha(self) -> float:
        """Current (possibly adapted) alpha; lags pending windows."""
        return float(self._state.carry_alpha[0])

    @property
    def cum_sgrs(self) -> int:
        """|E|: total sgrs in counted windows."""
        return int(self._state.total_sgrs[0])

    # -- ingestion -----------------------------------------------------------

    def push(self, tau, edge_i, edge_j, op=None) -> int:
        """Ingest a micro-batch of sgrs (scalars or equal-length arrays),
        closing adaptive windows online; returns the number of windows this
        call closed.  ``op``: 0 = insert, 1 = delete (``None`` = all
        inserts).  Timestamps must be non-decreasing across the stream."""
        if self._state.finalized[0]:
            raise RuntimeError("push after finalize(); stream already ended")
        if op is not None and self.tier == "sampled":
            if np.any(np.atleast_1d(np.asarray(op)) == OP_DELETE):
                # before windowizer_push: the batch must not mutate state
                raise NotImplementedError(
                    "sampled tier does not support delete ops: a subsampled "
                    "window has no retraction semantics; use an exact tier "
                    "for dynamic streams")
        closed = windowizer_push(self._state, 0, tau, edge_i, edge_j,
                                 self.nt_w, op=op,
                                 on_missing_delete=self.on_missing_delete)
        for _, ei, ej, ops, m, end_tau in closed:
            self._pending.append((ei, ej, ops, m, end_tau))
        if len(self._pending) >= self.flush_every and not self.defer_dispatch:
            if self.sync_dispatch:
                self.flush()
            else:
                self._reap_flush()
                self._submit_flush()
        return len(closed)

    # -- counting + estimation ----------------------------------------------

    def _submit_flush(self) -> bool:
        """Pack every pending window and dispatch one bucketed count without
        waiting; returns True iff a dispatch is now in flight."""
        if not self._pending:
            return False
        if self._inflight is not None:
            raise RuntimeError("reap the in-flight flush first")
        pending = self._pending
        resolved = [resolve_pending_window(ei, ej, ops, self.dup_policy)
                    for ei, ej, ops, _, _ in pending]
        per_edges = [e for e, _ in resolved]
        n_sgrs = np.array([m for _, _, _, m, _ in pending], dtype=np.int64)
        end_tau = np.array([t for _, _, _, _, t in pending], dtype=np.float64)
        cum = int(self._state.total_sgrs[0]) + np.cumsum(n_sgrs)
        # the reference stamps each window's sampling uid (res_seed over
        # |E_k|); exact tiers never read it, so it is carried the same way
        hi = np.uint64(int(self._state.res_seed[0]) & 0xFFFFFFFF)
        uid = ((hi << np.uint64(32))
               + (cum.astype(np.uint64) & np.uint64(0xFFFFFFFF))
               ).astype(np.int64)
        # multiset: resolved edges are unique already, and the multiplicity
        # lane routes every tier through its weighted twin
        multiset = self.dup_policy == "multiset"
        batch = pack_windows(per_edges, n_sgrs=n_sgrs, cum_sgrs=cum,
                             window_end_tau=end_tau, align=self.align,
                             dedupe=not multiset,
                             per_window_mult=([m for _, m in resolved]
                                              if multiset else None),
                             sample_uid=uid)
        handle = self.executor.window_counts_submit(batch)
        self._pending = []
        self._inflight = (len(pending), handle, cum, end_tau)
        return True

    def _reap_flush(self) -> int:
        """Wait for the in-flight counts and advance the estimator over its
        windows in close order -- the only place the estimator advances."""
        if self._inflight is None:
            return 0
        n, handle, cum, end_tau = self._inflight
        counts = handle.reap()
        self._inflight = None
        carry = advance_estimator(
            self._step_fn, estimator_carry(self._state, 0), self.truths,
            counts, cum, end_tau, self._counts, self._estimates,
            self._cum_sgrs, self._end_tau, device=self.device)
        set_estimator_carry(self._state, 0, carry)
        self._state.total_sgrs[0] = int(cum[-1])
        return n

    def flush(self) -> int:
        """Count every closed-but-uncounted window (in flight and pending)
        and advance the estimator over them; returns the number settled."""
        n = self._reap_flush()
        if self._submit_flush():
            n += self._reap_flush()
        return n

    def finalize(self) -> SGrappResult:
        """End the stream: close the trailing window (kept if it filled its
        quota, else per ``drop_partial``), flush, and return the result."""
        if not self._state.finalized[0]:
            tail = windowizer_close_tail(self._state, 0, self.nt_w,
                                         drop_partial=self.drop_partial)
            if tail is not None:
                _, ei, ej, ops, m, end_tau = tail
                self._pending.append((ei, ej, ops, m, end_tau))
        return self.result()

    def result(self) -> SGrappResult:
        """Snapshot of the estimate so far (flushes pending windows first)."""
        self.flush()
        return SGrappResult(
            estimates=np.array(self._estimates, dtype=np.float32),
            window_counts=np.array(self._counts, dtype=np.float64),
            cum_edges=np.array(self._cum_sgrs, dtype=np.float64),
            alpha_final=float(self._state.carry_alpha[0]),
            truths=self.truths,
        )

    # -- checkpointing -------------------------------------------------------

    def state_dict(self) -> dict:
        """Full engine state as the reference's v4 flat dict of numpy leaves
        (pending windows are flushed first, which changes no estimate)."""
        self.flush()
        st = self._state
        n = int(st.buf_len[0])
        return {
            "version": np.int64(STATE_DICT_VERSION),
            "nt_w": np.int64(self.nt_w),
            "buf_i": st.buf_i[0, :n].copy(),
            "buf_j": st.buf_j[0, :n].copy(),
            "buf_op": st.buf_op[0, :n].copy(),
            "buf_last_tau": np.float64(st.buf_last_tau[0]),
            "buf_len": np.int64(n),
            "uniq": np.int64(st.uniq[0]),
            "last_tau": np.float64(st.last_tau[0]),
            "total_sgrs": np.int64(st.total_sgrs[0]),
            "finalized": np.bool_(st.finalized[0]),
            "counts": np.array(self._counts, dtype=np.float64),
            "estimates": np.array(self._estimates, dtype=np.float32),
            "cum_sgrs": np.array(self._cum_sgrs, dtype=np.int64),
            "end_tau": np.array(self._end_tau, dtype=np.float64),
            "carry_cum": np.float32(st.carry_cum[0]),
            "carry_alpha": np.float32(st.carry_alpha[0]),
            "carry_err": np.float32(st.carry_err[0]),
            "carry_sup": np.bool_(st.carry_sup[0]),
            "res_seed": np.int64(st.res_seed[0]),
            "config": config_to_bytes(self.config),
            "alpha0": np.float64(self.alpha0),
        }

    def restore(self, state: dict) -> "StreamingSGrapp":
        """Load a :meth:`state_dict` of any supported version (from either
        package; v1-v3 migrate forward); the engine's own config stays.
        Strict: a key-set drift or an unknown version raises.  Returns
        ``self``."""
        version = check_state_dict_keys(state, _STATE_DICT_SCHEMAS,
                                        schema="StreamingSGrapp")
        state = migrate_state_dict_to_latest(state, version)
        if int(state["nt_w"]) != self.nt_w:
            raise ValueError(
                f"checkpoint nt_w={int(state['nt_w'])} != engine nt_w={self.nt_w}")
        ei = np.asarray(state["buf_i"], dtype=np.int64)
        ej = np.asarray(state["buf_j"], dtype=np.int64)
        st = stream_state_init(1, self.alpha0,
                               buf_capacity=max(256, ei.size))
        st.buf_i[0, :ei.size] = ei
        st.buf_j[0, :ej.size] = ej
        st.buf_op[0, :ei.size] = np.asarray(state["buf_op"], dtype=np.int8)
        st.buf_len[0] = int(state["buf_len"])
        st.buf_last_tau[0] = float(state["buf_last_tau"])
        st.uniq[0] = int(state["uniq"])
        st.last_tau[0] = float(state["last_tau"])
        st.total_sgrs[0] = int(state["total_sgrs"])
        st.finalized[0] = bool(state["finalized"])
        st.carry_cum[0] = np.float32(state["carry_cum"])
        st.carry_alpha[0] = np.float32(state["carry_alpha"])
        st.carry_err[0] = np.float32(state["carry_err"])
        st.carry_sup[0] = np.bool_(state["carry_sup"])
        st.res_seed[0] = int(state["res_seed"])
        self._state = st
        self._counts = [float(c) for c in np.asarray(state["counts"])]
        self._estimates = [np.float32(e) for e in np.asarray(state["estimates"])]
        self._cum_sgrs = [int(c) for c in np.asarray(state["cum_sgrs"])]
        self._end_tau = [float(t) for t in np.asarray(state["end_tau"])]
        self._pending = []
        self._inflight = None
        return self

    @classmethod
    def from_state_dict(cls, state: dict, *, truths=None,
                        config: EngineConfig | None = None,
                        executor: WindowExecutor | None = None,
                        device=None) -> "StreamingSGrapp":
        """Rebuild an engine from a self-describing (v4) :meth:`state_dict`
        alone: ``nt_w``, ``alpha0`` and the embedded config come from the
        dict.  ``config=`` overrides the embedded config; ``device=`` says
        where the rebuilt engine runs (it is never serialized).  A pre-v4
        dict carries no config and raises unless ``config=`` is given."""
        version = check_state_dict_keys(state, _STATE_DICT_SCHEMAS,
                                        schema="StreamingSGrapp")
        state = migrate_state_dict_to_latest(state, version)
        if config is None:
            payload = config_from_bytes(state["config"])
            if not payload:
                raise ValueError(
                    "checkpoint carries no EngineConfig (pre-v4 schema "
                    "migrated forward): construct the engine explicitly "
                    "and call restore(), or pass config=")
            config = EngineConfig.from_json(payload, device=device)
        elif device is not None:
            config = config.replace(device=device)
        eng = cls(int(state["nt_w"]), float(state["alpha0"]), truths=truths,
                  config=config, executor=executor)
        return eng.restore(state)
