"""Network-facing multi-tenant serving front end for `MultiStreamSGrapp`.

The port's copy of ``repro.streams.server``: the same protocol, admission,
metrics, durability (WAL + checkpoints, files compatible with the
reference's) and supervision, with the fleet engine counting on the card
(K1 for distinct tenants, K2 for multiset tenants on the ``pallas`` tier).

The ROADMAP's "millions of users" story as a subsystem: many concurrent
clients push tagged edge batches over TCP, one fleet engine counts them,
and per-tenant window estimates stream back — with admission, backpressure,
metrics and crash recovery designed in rather than bolted on.  Stdlib only
(asyncio + json + logging); the full protocol/operational contract lives in
``docs/serving.md``.

Data plane
----------

::

    client ──hello {token}──────────────► auth: token -> TenantPolicy
           ──push {records}─────────────► admission (draining? well-formed?
                                          oversized? rate quota?) then a
                                          BOUNDED ingress queue — QueueFull
                                          is an explicit `backpressure`
                                          reject, never an unbounded buffer
                                 ┌────────┴────────┐
                                 │ coalescer task  │  first record waits, then
                                 │ (latency budget)│  gathers ≤ flush_ms /
                                 └────────┬────────┘  ≤ max_coalesce_records
                                          ▼
                            ONE executor thread: per-item engine.push()
                            in arrival order + ONE reap+submit cycle — so
                            windows closed by different tenants in the same
                            cycle co-batch through one bucketed dispatch
                                          ▼
           ◄──ack {windows_closed}──────  per-item futures resolve
           ◄──estimate {...} (subscribed) counted windows fan out at reap

Every engine touch (push/flush/result/finalize/state_dict) runs on that one
``ThreadPoolExecutor(max_workers=1)`` thread (recovery included): the engine
needs no locks, the event loop never blocks on the device (kernel launches,
staging copies, the reap's wait on its CUDA event), and cross-tenant
co-batching — the whole point of the fleet engine — is preserved at the
dispatch level.  That thread binds the engine's CUDA device when it starts
(torch keeps the current device per thread) and uses the device's default
stream, as every other thread does; no side stream is chosen anywhere.

The engine cycle rides the engine layer's async flush pipeline
(``docs/architecture.md``): each cycle *reaps* the previous cycle's
in-flight dispatch (blocking only for compute that already overlapped this
cycle's admission + WAL work) and *submits* the windows closed now without
materializing their counts.  ``latency_budget_ms > 0`` additionally defers
the submit while the oldest pending window is younger than the budget, so
windows closed by different tenants within the deadline fuse into one
bucketed dispatch; a follow-up reap task publishes estimates as soon as the
counts land, and a deadline timer fires the deferred dispatch even when no
new traffic arrives.  ``EngineConfig.sync_dispatch`` (or
``SGRAPP_SYNC_DISPATCH=1``) restores the old blocking flush-per-cycle.
Acks never wait on counts (``windows_closed`` is known at push time) and
still resolve only after the WAL group-commit fsync.

Tenancy: the hello token maps to a ``stream_id``; ``stream_id`` never
travels on the wire (see :mod:`repro_torch.streams.wire`), so a tenant cannot
write into another tenant's stream.  Per-tenant admission is a token-bucket
rate limit (records/s + burst) plus an oversized-batch cap.

Observability: per-tenant and aggregate counters, a push-latency histogram
(p50/p99 over a sliding reservoir), and queue depth — exported as JSON on
``GET /metrics`` of a second (HTTP) port, with ``GET /healthz`` for
liveness.  Request handling emits structured JSON logs on the
``repro_torch.streams.server`` logger.

Durability: every admitted push is appended to a per-tenant write-ahead log
(:mod:`repro_torch.streams.wal`) keyed by its monotonic ``seq`` and
group-commit fsynced *before* its ack leaves the server; periodic +
``stop()`` checkpoints (``repro_torch.train.checkpoint``, CRC-verified)
record the engine's
v4 ``state_dict`` plus the per-tenant seq watermarks.  ``start()`` restores
the newest *valid* checkpoint (corrupt steps are skipped — degraded mode)
and replays WAL records past its watermark, so an acked record survives
SIGKILL at any instant and a client retry of an applied seq acks
idempotently — exactly-once, bit-identical recovery (docs/serving.md).

Supervision: the coalescer and checkpoint loops run under a watchdog that
isolates per-item failures, restarts crashed loops with bounded backoff and
surfaces degraded mode on ``/healthz`` + ``/metrics``.  The deterministic
fault-injection points threaded through this module
(:mod:`repro_torch.streams.faults`) are how the crash-recovery suite lands
kills exactly between WAL-fsync and ack, or mid-checkpoint-rename.
"""
from __future__ import annotations

import asyncio
import bisect
import json
import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import torch

from ..train.checkpoint import (
    CheckpointCorruption,
    gc_tmp_dirs,
    latest_step,
    restore_latest_valid,
    save_checkpoint,
)
from ..train.fault import fault_point
from .config import EngineConfig, ServingConfig
from .multi import MultiStreamSGrapp
from .wal import FleetWAL, WALCorruption, WALError
from .wire import RecordBatch, normalize_seq, records_from_json

__all__ = ["StreamServer", "TenantPolicy", "ServerMetrics"]

log = logging.getLogger("repro_torch.streams.server")

# push rejection reasons, in admission-check order (docs/serving.md)
REJECT_DRAINING = "draining"
REJECT_FINALIZED = "finalized"
REJECT_BAD_RECORDS = "bad_records"
REJECT_BAD_SEQ = "bad_seq"
REJECT_OVERSIZED = "oversized"
REJECT_QUOTA = "quota"
REJECT_BACKPRESSURE = "backpressure"
REJECT_ENGINE = "engine_reject"
REJECT_WAL = "wal_error"
REJECT_INTERNAL = "internal"

_LATENCY_BOUNDS_MS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                      500.0, 1000.0)


@dataclass(frozen=True)
class TenantPolicy:
    """Admission policy of one tenant (token -> this, at construction).

    stream_id : the tenant's engine stream.
    max_batch_records : largest single push accepted (oversized reject).
    max_records_per_s : token-bucket refill rate; ``None`` = unlimited.
    burst : bucket capacity; defaults to 2s of refill (or the batch cap
        when unlimited).
    """

    stream_id: int
    max_batch_records: int = 4096
    max_records_per_s: float | None = None
    burst: int | None = None


class _TokenBucket:
    def __init__(self, rate: float | None, burst: int):
        self.rate = rate
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last = time.monotonic()

    def admit(self, n: int) -> bool:
        if self.rate is None:
            return True
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens + (now - self.last) * self.rate)
        self.last = now
        if n > self.tokens:
            return False
        self.tokens -= n
        return True


@dataclass
class _TenantCounters:
    edges_accepted: int = 0
    edges_rejected: int = 0
    batches_accepted: int = 0
    batches_rejected: int = 0
    windows_closed: int = 0
    rejects: dict = field(default_factory=dict)

    def reject(self, reason: str, n_edges: int) -> None:
        self.batches_rejected += 1
        self.edges_rejected += n_edges
        self.rejects[reason] = self.rejects.get(reason, 0) + 1


class ServerMetrics:
    """Aggregate + per-tenant serving counters and the push-latency
    histogram.  ``snapshot()`` is the ``/metrics`` JSON body — the schema is
    documented in docs/serving.md and pinned by the serving tests."""

    def __init__(self, stream_ids):
        self.tenants = {int(s): _TenantCounters() for s in stream_ids}
        self.auth_rejected = 0
        self.pushes = 0                       # engine dispatch cycles
        self.coalesced_items = 0              # push batches applied
        # durability + supervision counters (docs/serving.md)
        self.duplicate_acks = 0               # idempotent duplicate-seq acks
        self.engine_errors = 0                # unexpected engine exceptions
        self.flush_errors = 0                 # engine.flush() failures
        self.internal_errors = 0              # dispatch cycles that blew up
        self.wal_errors = 0                   # WAL append/sync failures
        self.checkpoint_failures = 0          # failed checkpoint attempts
        self.checkpoint_fallbacks = 0         # corrupt steps skipped at boot
        # async flush pipeline observability
        self.dispatch_count = 0               # async bucketed dispatches
        self.windows_dispatched = 0           # windows across them
        self._reap_count = 0
        self._reap_sum_ms = 0.0
        self._reap_recent = deque(maxlen=4096)
        self._lat_count = 0
        self._lat_sum_ms = 0.0
        self._lat_max_ms = 0.0
        self._lat_buckets = [0] * (len(_LATENCY_BOUNDS_MS) + 1)
        self._lat_recent = deque(maxlen=4096)  # sliding p50/p99 reservoir

    def observe_push_latency(self, ms: float, n_items: int) -> None:
        self.pushes += 1
        self.coalesced_items += n_items
        self._lat_count += 1
        self._lat_sum_ms += ms
        self._lat_max_ms = max(self._lat_max_ms, ms)
        self._lat_buckets[bisect.bisect_left(_LATENCY_BOUNDS_MS, ms)] += 1
        self._lat_recent.append(ms)

    def observe_dispatch(self, n_windows: int) -> None:
        self.dispatch_count += 1
        self.windows_dispatched += int(n_windows)

    def observe_reap_wait(self, ms: float) -> None:
        self._reap_count += 1
        self._reap_sum_ms += ms
        self._reap_recent.append(ms)

    @staticmethod
    def _pct(recent, q: float) -> float:
        if not recent:
            return 0.0
        xs = sorted(recent)
        k = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
        return float(xs[k])

    def percentile(self, q: float) -> float:
        return self._pct(self._lat_recent, q)

    def reap_percentile(self, q: float) -> float:
        return self._pct(self._reap_recent, q)

    def snapshot(self, **extra) -> dict:
        buckets = {f"<={b}ms": c for b, c in
                   zip(_LATENCY_BOUNDS_MS, self._lat_buckets)}
        buckets[f">{_LATENCY_BOUNDS_MS[-1]}ms"] = self._lat_buckets[-1]
        agg = _TenantCounters()
        for t in self.tenants.values():
            agg.edges_accepted += t.edges_accepted
            agg.edges_rejected += t.edges_rejected
            agg.batches_accepted += t.batches_accepted
            agg.batches_rejected += t.batches_rejected
            agg.windows_closed += t.windows_closed
            for r, c in t.rejects.items():
                agg.rejects[r] = agg.rejects.get(r, 0) + c
        out = {
            "aggregate": {
                "edges_accepted": agg.edges_accepted,
                "edges_rejected": agg.edges_rejected,
                "batches_accepted": agg.batches_accepted,
                "batches_rejected": agg.batches_rejected,
                "windows_closed": agg.windows_closed,
                "auth_rejected": self.auth_rejected,
                "pushes": self.pushes,
                "coalesced_items": self.coalesced_items,
                "duplicate_acks": self.duplicate_acks,
                "engine_errors": self.engine_errors,
                "flush_errors": self.flush_errors,
                "internal_errors": self.internal_errors,
                "dispatch_count": self.dispatch_count,
                "windows_dispatched": self.windows_dispatched,
                "coalesced_windows_per_dispatch": (
                    self.windows_dispatched / self.dispatch_count
                    if self.dispatch_count else 0.0),
                "reap_wait_ms": {
                    "count": self._reap_count,
                    "mean": (self._reap_sum_ms / self._reap_count
                             if self._reap_count else 0.0),
                    "p50": self.reap_percentile(0.50),
                    "p99": self.reap_percentile(0.99),
                },
                "push_latency_ms": {
                    "count": self._lat_count,
                    "mean": (self._lat_sum_ms / self._lat_count
                             if self._lat_count else 0.0),
                    "p50": self.percentile(0.50),
                    "p99": self.percentile(0.99),
                    "max": self._lat_max_ms,
                    "buckets": buckets,
                },
            },
            "tenants": {
                str(s): {
                    "edges_accepted": t.edges_accepted,
                    "edges_rejected": t.edges_rejected,
                    "batches_accepted": t.batches_accepted,
                    "batches_rejected": t.batches_rejected,
                    "windows_closed": t.windows_closed,
                    "rejects": dict(t.rejects),
                } for s, t in sorted(self.tenants.items())
            },
        }
        out.update(extra)
        return out


class _Item:
    """One admitted push riding the ingress queue to the coalescer.
    ``seq`` is the tenant's durability sequence number (client-supplied or
    server-assigned at admission) — it keys the WAL record and duplicate
    detection."""

    __slots__ = ("stream_id", "rb", "future", "t_enqueue", "seq")

    def __init__(self, stream_id: int, rb: RecordBatch, future, t_enqueue,
                 seq: int):
        self.stream_id = stream_id
        self.rb = rb
        self.future = future
        self.t_enqueue = t_enqueue
        self.seq = seq


_STOP = object()   # coalescer shutdown sentinel (rides the queue last)


class StreamServer:
    """Asyncio NDJSON-over-TCP serving front end (see module doc +
    docs/serving.md for the protocol).

    Parameters
    ----------
    nt_w, alpha0, truths : the fleet engine's stream parameters.
    tenants : ``{token: stream_id}`` or ``{token: TenantPolicy}``; the
        stream ids must be exactly ``0..N-1``.
    config : shared :class:`EngineConfig` for the fleet engine; its
        ``device`` (default ``cuda``) is where the fleet counts, and the
        server raises without a card unless it says ``cpu``.
    host, port : TCP data plane bind (``port=0`` = ephemeral; the bound
        port is ``self.port`` after :meth:`start`).
    http_port : ``/healthz`` + ``/metrics`` bind (also ephemeral at 0).
    queue_limit : bounded ingress queue length, in push batches; a full
        queue rejects with ``backpressure`` instead of buffering unbounded.
    flush_ms : coalescing latency budget — after the first queued item, the
        coalescer keeps gathering until this deadline (or the record cap)
        before dispatching the micro-batch.
    max_coalesce_records : record cap per dispatch cycle.
    latency_budget_ms : deadline for the opportunistic same-dispatch window
        coalescer.  0 (default) submits every cycle's closed windows to the
        executor immediately (still asynchronously — the event loop never
        blocks on the device).  > 0 defers the submit while the oldest pending
        window is younger than the budget, so windows closed by different
        tenants within the deadline fuse into ONE bucketed dispatch; a
        deadline timer fires the deferred dispatch even without new
        traffic.  Unlike ``flush_ms`` (which delays *acks* by gathering
        push items), this never delays an ack — only count materialization
        and estimate fanout (docs/serving.md).
    checkpoint_dir : durability root (``None`` disables checkpointing);
        :meth:`start` recovers from the newest *valid* checkpoint found
        there (corrupt steps are skipped — degraded mode), then replays
        the WAL past its watermark.
    checkpoint_every_s : periodic background checkpoint interval
        (``None`` = only on :meth:`stop`).
    serving : :class:`ServingConfig` — WAL + supervision knobs
        (docs/serving.md durability contract).
    wal_dir : override for the write-ahead-log root; defaults to
        ``<checkpoint_dir>/wal`` when checkpointing is on and
        ``serving.wal`` is true.
    """

    def __init__(self, *, nt_w: int, alpha0, tenants: dict,
                 config: EngineConfig | None = None, truths=None,
                 host: str = "127.0.0.1", port: int = 0, http_port: int = 0,
                 queue_limit: int = 64, flush_ms: float = 2.0,
                 max_coalesce_records: int = 65536,
                 latency_budget_ms: float = 0.0,
                 checkpoint_dir: str | None = None,
                 checkpoint_every_s: float | None = None,
                 serving: ServingConfig | None = None,
                 wal_dir: str | None = None):
        if config is None:
            config = EngineConfig()
        if not isinstance(config, EngineConfig):
            raise TypeError(f"config must be an EngineConfig, "
                            f"got {type(config).__name__}")
        if not tenants:
            raise ValueError("tenants must map at least one token")
        pols = {}
        for token, pol in tenants.items():
            if not isinstance(pol, TenantPolicy):
                pol = TenantPolicy(stream_id=int(pol))
            pols[str(token)] = pol
        sids = sorted(p.stream_id for p in pols.values())
        if sids != list(range(len(sids))):
            raise ValueError(
                f"tenant stream_ids must be exactly 0..N-1 with no "
                f"duplicates, got {sids}")
        if queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        if not (float(flush_ms) >= 0.0):
            raise ValueError("flush_ms must be >= 0")
        if not (float(latency_budget_ms) >= 0.0):
            raise ValueError("latency_budget_ms must be >= 0")
        self.tenants = pols
        self.n_streams = len(sids)
        self.config = config
        self.engine = MultiStreamSGrapp(self.n_streams, nt_w, alpha0,
                                        truths=truths, config=config)
        self.host = host
        self._want_port = int(port)
        self._want_http_port = int(http_port)
        self.port: int | None = None
        self.http_port: int | None = None
        self.queue_limit = int(queue_limit)
        self.flush_ms = float(flush_ms)
        self.max_coalesce_records = int(max_coalesce_records)
        self.latency_budget_ms = float(latency_budget_ms)
        if self.latency_budget_ms > 0.0 and not self.engine.sync_dispatch:
            # the deadline coalescer owns dispatch scheduling: suppress the
            # engine's own flush_every self-submit so windows from several
            # cycles actually fuse into one dispatch instead of the engine
            # submitting each cycle's windows as push() closes them
            self.engine.defer_dispatch = True
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_s = checkpoint_every_s
        if serving is None:
            serving = ServingConfig()
        if not isinstance(serving, ServingConfig):
            raise TypeError(f"serving must be a ServingConfig, "
                            f"got {type(serving).__name__}")
        self.serving = serving
        if wal_dir is None and checkpoint_dir is not None and serving.wal:
            wal_dir = os.path.join(checkpoint_dir, "wal")
        self.wal_dir = wal_dir
        self.metrics = ServerMetrics(range(self.n_streams))

        self._buckets = {
            tok: _TokenBucket(
                p.max_records_per_s,
                p.burst if p.burst is not None else (
                    max(1, int(2 * p.max_records_per_s))
                    if p.max_records_per_s is not None
                    else p.max_batch_records))
            for tok, p in pols.items()}
        # ONE engine thread: every engine touch serializes here (no engine
        # locks, co-batching preserved, event loop never blocks on the
        # device); it binds the engine's device as it starts
        dev = self.engine.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="sgrapp-engine",
                                        initializer=_bind_device,
                                        initargs=(dev,))
        # published-window high-water marks per stream; read/written ONLY on
        # the engine thread (history lists mutate there), shipped to the
        # loop as plain dicts
        self._published = [0] * self.n_streams
        self._subscribers: dict[int, set[asyncio.StreamWriter]] = {
            s: set() for s in range(self.n_streams)}
        self._queue: asyncio.Queue | None = None
        self._tcp = None
        self._http = None
        self._coalescer_task = None
        self._ckpt_task = None
        # async dispatch state: when the windows pending on the engine were
        # first deferred (engine-thread-written, loop-read — GIL-atomic
        # float/None peek), and the one follow-up reap task
        self._pending_since: float | None = None
        self._reap_task: asyncio.Task | None = None
        self._draining = False
        self._stopped = False
        self._stop_done: asyncio.Event | None = None
        self._started_at: float | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        # durability state (engine-thread-owned after start(); admission
        # reads are GIL-atomic int/list peeks)
        self._wal: FleetWAL | None = None
        self._watermarks = [0] * self.n_streams   # last applied seq
        self._seq_hwm = [0] * self.n_streams      # highest admitted seq
        # WAL GC lags one checkpoint generation: segments are deleted only
        # once the PREVIOUS checkpoint covers them, so recovery still works
        # when the newest step turns out corrupt and we fall back
        self._gc_marks = [0] * self.n_streams
        self._last_ack: list[dict | None] = [None] * self.n_streams
        # supervision state
        self._degraded: dict[str, str] = {}       # reason -> detail
        self._task_restarts: dict[str, int] = {}
        self._last_ckpt_t: float | None = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "StreamServer":
        """Bind both listeners, recover (newest *valid* checkpoint + WAL
        replay past its watermark, GC of stale tmp dirs and covered WAL
        segments) and start the supervised loops.  Returns self;
        ``self.port`` / ``self.http_port`` are the bound ports."""
        self._loop = asyncio.get_running_loop()
        self._queue = asyncio.Queue(maxsize=self.queue_limit)
        if self.wal_dir is not None:
            self._wal = FleetWAL(self.wal_dir, self.n_streams,
                                 segment_bytes=self.serving.wal_segment_bytes,
                                 fsync=self.serving.wal_fsync)
        if self.engine.device.type == "cuda" and self.engine.tier == "pallas":
            # the kernel library loads (or builds) now, before the ports
            # open, never while a client waits on its first window
            await self._loop.run_in_executor(self._pool, _load_kernels)
        if self.checkpoint_dir is not None or self._wal is not None:
            await self._loop.run_in_executor(self._pool, self._recover)
        self._tcp = await asyncio.start_server(
            self._handle_conn, self.host, self._want_port)
        self.port = self._tcp.sockets[0].getsockname()[1]
        self._http = await asyncio.start_server(
            self._handle_http, self.host, self._want_http_port)
        self.http_port = self._http.sockets[0].getsockname()[1]
        self._coalescer_task = asyncio.create_task(
            self._supervised("coalescer", self._coalesce_loop))
        if self.checkpoint_dir is not None and self.checkpoint_every_s:
            self._ckpt_task = asyncio.create_task(
                self._supervised("checkpoint", self._checkpoint_loop))
        self._started_at = time.monotonic()
        self._last_ckpt_t = time.monotonic()
        self._log("start", port=self.port, http_port=self.http_port,
                  n_streams=self.n_streams, recovered=self._recovered,
                  wal=self._wal is not None)
        return self

    _recovered = False

    def _recover(self) -> None:
        """Recovery = newest valid checkpoint + WAL replay.  Runs on the
        engine thread before the listeners bind."""
        state, extra, step = None, {}, None
        if self.checkpoint_dir is not None:
            for tmp in gc_tmp_dirs(self.checkpoint_dir):
                self._log("gc_tmp_checkpoint", path=tmp)
            try:
                state, extra, step, skipped = restore_latest_valid(
                    self.checkpoint_dir, self.engine.state_dict(), host=True)
            except FileNotFoundError:
                skipped = []
            except CheckpointCorruption as e:
                # steps exist but none is loadable: fresh engine + full WAL
                # replay is the best remaining truth — surface loudly
                skipped = []
                self.metrics.checkpoint_fallbacks += 1
                self._set_degraded("checkpoint_fallback", str(e))
                self._log("recover_no_valid_checkpoint", error=str(e))
            if skipped:
                self.metrics.checkpoint_fallbacks += len(skipped)
                self._set_degraded(
                    "checkpoint_fallback",
                    f"skipped corrupt steps {skipped}, restored {step}")
                self._log("recover_fallback", skipped=skipped, step=step)
        if state is not None:
            self.engine.restore(state)
            marks = extra.get("watermarks")
            if marks is not None:
                self._watermarks = [int(w) for w in marks]
            self._recovered = True
            self._log("recover", step=int(step),
                      watermarks=list(self._watermarks),
                      windows=[self.engine.n_counted(s)
                               for s in range(self.n_streams)])
        if self._wal is not None:
            self._replay_wal()
        # published marks restart at the recovered history lengths: new
        # subscribers replay nothing stale, result RPCs return everything
        self._published = [self.engine.n_counted(s)
                           for s in range(self.n_streams)]
        self._seq_hwm = list(self._watermarks)

    def _replay_wal(self) -> None:
        """Apply WAL records past the checkpoint watermark, per tenant in
        seq order — engine determinism across micro-batch cuts makes the
        result bit-identical to the crash-free run.  Rejected records
        re-reject identically; torn tails are repaired; segments fully
        covered by the checkpoint are GC'd."""
        ckpt_marks = list(self._watermarks)   # GC bound: checkpoint only
        n_replayed = 0
        for s in range(self.n_streams):
            try:
                for seq, rb in self._wal.replay(s):
                    if seq <= self._watermarks[s]:
                        continue          # covered by the checkpoint
                    out = self._apply_records(s, rb)
                    self._watermarks[s] = seq
                    self._last_ack[s] = out
                    n_replayed += 1
            except WALCorruption as e:
                self._set_degraded("wal_corruption", str(e))
                self._log("wal_corruption", stream_id=s, error=str(e))
        if n_replayed:
            self.engine.flush()
            self._recovered = True
        removed = self._wal.gc(ckpt_marks)
        self._gc_marks = list(ckpt_marks)
        self._log("wal_replay", replayed=n_replayed,
                  watermarks=list(self._watermarks), segments_gc=removed)

    async def stop(self, *, finalize: bool = False,
                   checkpoint: bool = True) -> None:
        """Graceful drain: stop accepting pushes, let the coalescer apply
        everything already admitted, flush the engine (``finalize=True``
        additionally ends every stream — true end-of-stream only, since a
        finalized checkpoint cannot be pushed to after recovery), publish
        the final estimates, checkpoint, and close both listeners.

        Idempotent: a second ``stop()`` (signal race, test teardown) waits
        for the first to finish and returns.  A drain that exceeds
        ``serving.drain_timeout_s`` is cancelled and every still-queued
        item's future resolves with a ``draining`` reject — no client
        coroutine is left hanging on an orphaned future."""
        if self._stop_done is not None:
            await self._stop_done.wait()
            return
        self._stop_done = asyncio.Event()
        try:
            self._draining = True
            if self._tcp is not None:
                # close() only — on >=3.12.1 wait_closed() also waits for
                # live client handlers, which would deadlock the drain while
                # a subscriber keeps its connection open
                self._tcp.close()
            if self._queue is not None:
                try:   # FIFO: the sentinel lands after admitted items
                    await asyncio.wait_for(self._queue.put(_STOP),
                                           self.serving.drain_timeout_s)
                except asyncio.TimeoutError:
                    pass   # coalescer wedged; the cancel below cleans up
            if self._coalescer_task is not None:
                try:
                    await asyncio.wait_for(
                        asyncio.shield(self._coalescer_task),
                        self.serving.drain_timeout_s)
                except asyncio.TimeoutError:
                    self._coalescer_task.cancel()
                    try:
                        await self._coalescer_task
                    except asyncio.CancelledError:
                        pass
            if self._ckpt_task is not None:
                self._ckpt_task.cancel()
                try:
                    await self._ckpt_task
                except asyncio.CancelledError:
                    pass
            if self._reap_task is not None and not self._reap_task.done():
                # the drain flush below reaps everything; don't let the
                # follow-up touch the pool after shutdown
                self._reap_task.cancel()
                try:
                    await self._reap_task
                except asyncio.CancelledError:
                    pass
            self._drain_queue_rejects()
            try:
                if finalize:
                    updates = await self._loop.run_in_executor(
                        self._pool, self._engine_finalize_all)
                else:
                    updates = await self._loop.run_in_executor(
                        self._pool, self._engine_flush)
                self._fanout_estimates(updates)
            except Exception as e:
                self.metrics.flush_errors += 1
                self._log("stop_flush_error", error=repr(e))
            if checkpoint and self.checkpoint_dir is not None:
                try:
                    await self._loop.run_in_executor(
                        self._pool, self._save_checkpoint)
                except Exception as e:
                    self.metrics.checkpoint_failures += 1
                    self._log("stop_checkpoint_error", error=repr(e))
            if self._wal is not None:
                self._wal.close()
            if self._http is not None:
                self._http.close()
            for subs in self._subscribers.values():
                subs.clear()
            self._pool.shutdown(wait=True)
            self._stopped = True
            self._log("stop", finalize=finalize, checkpoint=checkpoint)
        finally:
            self._stop_done.set()

    def _drain_queue_rejects(self) -> None:
        """Resolve every future still riding the queue with a ``draining``
        reject — a timed-out drain or a crash-restarted coalescer must not
        leave client coroutines awaiting forever."""
        if self._queue is None:
            return
        n = 0
        while True:
            try:
                item = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if item is _STOP:
                continue
            if not item.future.done():
                item.future.set_result({
                    "ok": False, "reason": REJECT_DRAINING,
                    "detail": "server stopped before applying this batch"})
                n += 1
        if n:
            self._log("drain_rejects", n_items=n)

    async def serve_forever(self) -> None:
        """Run until cancelled (the launcher wires SIGINT/SIGTERM to a
        graceful ``stop()``)."""
        await self._tcp.serve_forever()

    # -- engine-thread helpers (EVERY engine touch lives here) ---------------

    def _collect_updates(self) -> dict:
        ups = {}
        for s in range(self.n_streams):
            n = self.engine.n_counted(s)
            if n > self._published[s]:
                ups[s] = self.engine.history(s, self._published[s])
                self._published[s] = n
        return ups

    def _apply_records(self, s: int, rb: RecordBatch) -> dict:
        """Apply one batch on the engine and return its ack outcome.
        Shared by the live path and WAL replay, so replay reproduces the
        original outcomes — deterministic engine rejects re-reject
        identically, which is what lets the watermark advance over them."""
        try:
            closed = self.engine.push(s, rb.tau, rb.edge_i, rb.edge_j,
                                      op=rb.op)
            return {"ok": True, "accepted": rb.n, "windows_closed": closed}
        except (ValueError, RuntimeError, NotImplementedError) as e:
            return {"ok": False, "reason": REJECT_ENGINE, "detail": str(e)}

    def _apply_one(self, it: _Item) -> dict:
        """WAL-append + engine-apply one admitted item, with broad per-item
        exception isolation: a poisoned batch rejects (``internal``) instead
        of killing the coalescer for every tenant."""
        s = it.stream_id
        if self._wal is not None:
            try:
                self._wal.append(s, it.seq, it.rb)
            except WALError as e:
                # nothing acked durable: reject so the client retries after
                # the disk recovers; watermark does NOT advance
                self.metrics.wal_errors += 1
                self._set_degraded("wal", str(e))
                return {"ok": False, "reason": REJECT_WAL, "detail": str(e)}
        try:
            fault_point("engine_apply_raise")
            out = self._apply_records(s, it.rb)
        except Exception as e:
            self.metrics.engine_errors += 1
            self._log("engine_error", stream_id=s, error=repr(e))
            out = {"ok": False, "reason": REJECT_INTERNAL, "detail": repr(e)}
        # the watermark advances for applied AND engine-rejected outcomes
        # (replay re-rejects deterministically) but not for wal/internal
        # errors, which the client should retry under the same seq
        if out["ok"] or out["reason"] == REJECT_ENGINE:
            self._watermarks[s] = it.seq
            self._last_ack[s] = dict(out)
        return out

    def _engine_apply(self, items: list) -> tuple[list, dict]:
        outs = []
        for it in items:
            s = it.stream_id
            if it.seq <= self._watermarks[s]:
                # duplicate already durably applied (a client retry raced
                # its own in-flight original): idempotent ack from the cache
                cached = (self._last_ack[s]
                          if it.seq == self._watermarks[s] else None)
                out = (dict(cached) if cached is not None
                       else {"ok": True, "accepted": 0, "windows_closed": 0})
                out["duplicate"] = True
                outs.append(out)
                continue
            outs.append(self._apply_one(it))
        fault_point("post_ack_pre_wal")
        # batched group commit: ONE fsync covers the whole cycle, and it
        # lands before any of the acks above reach a socket
        wal_failed = any(not o.get("ok") and o.get("reason") == REJECT_WAL
                         for o in outs)
        if self._wal is not None:
            try:
                self._wal.sync()
                if not wal_failed:   # a clean full cycle clears degraded
                    self._clear_degraded("wal")
            except WALError as e:
                # the records ARE applied — acks stand; durability degrades
                # to checkpoint-only until the disk recovers
                self.metrics.wal_errors += 1
                self._set_degraded("wal", str(e))
        try:
            # ONE reap+submit cycle: windows closed by different tenants
            # above co-batch through one bucketed executor dispatch, and the
            # dispatch is asynchronous — acks above never wait on counts
            self._engine_dispatch()
        except Exception as e:
            self.metrics.flush_errors += 1
            self._log("flush_error", error=repr(e))
        return outs, self._collect_updates()

    def _reap_now(self) -> int:
        """Reap the in-flight dispatch (engine thread).  The measured wait
        is exactly the non-overlapped remainder of the device compute."""
        if not self.engine.n_inflight:
            return 0
        t0 = time.monotonic()
        n = self.engine._reap_flush()
        self.metrics.observe_reap_wait((time.monotonic() - t0) * 1e3)
        return n

    def _engine_dispatch(self) -> None:
        """One overlapped flush cycle on the engine thread: settle the
        previous cycle's dispatch, then submit the windows pending now —
        unless ``latency_budget_ms`` says to keep gathering so later cycles
        fuse into the same dispatch."""
        if self.engine.sync_dispatch:
            self.engine.flush()
            self._pending_since = None
            return
        self._reap_now()
        # n_inflight is 0 after the reap, so n_pending == awaiting-dispatch
        if self.engine.n_pending == 0:
            self._pending_since = None
            return
        now = time.monotonic()
        if self._pending_since is None:
            self._pending_since = now
        budget_s = self.latency_budget_ms / 1000.0
        if budget_s > 0.0 and (now - self._pending_since) < budget_s:
            return   # defer: the coalescer's deadline timer fires us later
        if self.engine._submit_flush():
            self.metrics.observe_dispatch(self.engine.n_inflight)
        self._pending_since = None

    def _engine_dispatch_collect(self) -> dict:
        self._engine_dispatch()
        return self._collect_updates()

    def _engine_reap_collect(self) -> dict:
        """Follow-up reap (engine thread): materialize the counts of the
        last submitted dispatch so estimates publish without waiting for
        the next push cycle."""
        self._reap_now()
        return self._collect_updates()

    def _engine_flush(self) -> dict:
        self.engine.flush()
        self._pending_since = None
        return self._collect_updates()

    def _engine_result(self, s: int) -> tuple:
        res = self.engine.result(s)
        return res, self._collect_updates()

    def _engine_finalize_stream(self, s: int) -> tuple:
        res = self.engine.finalize_stream(s)
        return res, self._collect_updates()

    def _engine_finalize_all(self) -> dict:
        self.engine.finalize()
        return self._collect_updates()

    def _save_checkpoint(self) -> None:
        prev = latest_step(self.checkpoint_dir)
        step = 0 if prev is None else int(prev) + 1
        # state_dict + watermarks snapshot on the same (engine) thread, so
        # the saved watermark is exactly the state's last applied seq
        save_checkpoint(self.checkpoint_dir, step, self.engine.state_dict(),
                        extra={"published": list(self._published),
                               "watermarks": list(self._watermarks)})
        self._last_ckpt_t = time.monotonic()
        if self._wal is not None:
            removed = self._wal.gc(self._gc_marks)
            if removed:
                self._log("wal_gc", segments=removed,
                          watermarks=list(self._gc_marks))
        self._gc_marks = list(self._watermarks)
        self._log("checkpoint", step=step)

    # -- coalescer -----------------------------------------------------------

    async def _coalesce_loop(self) -> None:
        stop = False
        while not stop:
            deadline_s = self._dispatch_deadline_s()
            if deadline_s is None:
                item = await self._queue.get()
            else:
                try:
                    item = await asyncio.wait_for(self._queue.get(),
                                                  deadline_s)
                except asyncio.TimeoutError:
                    # latency budget expired with no new traffic: fire the
                    # deferred dispatch and publish once its counts land
                    updates = await self._loop.run_in_executor(
                        self._pool, self._engine_dispatch_collect)
                    self._fanout_estimates(updates)
                    self._maybe_reap_later()
                    continue
            if item is _STOP:
                break
            batch = [item]
            total = item.rb.n
            deadline = self._loop.time() + self.flush_ms / 1000.0
            while total < self.max_coalesce_records:
                timeout = deadline - self._loop.time()
                if timeout <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
                total += nxt.rb.n
            t0 = time.monotonic()
            try:
                outs, updates = await self._loop.run_in_executor(
                    self._pool, self._engine_apply, batch)
                self._clear_degraded("coalescer")
            except asyncio.CancelledError:
                # drain timeout cancelled us mid-dispatch: the batch's
                # futures must not be orphaned — clients would await forever
                for it in batch:
                    if not it.future.done():
                        it.future.set_result({
                            "ok": False, "reason": REJECT_DRAINING,
                            "detail": "server stopped before acking this "
                                      "batch"})
                raise
            except Exception as e:
                # the whole dispatch cycle blew up: resolve every future so
                # no client hangs, then keep coalescing
                self.metrics.internal_errors += 1
                self._set_degraded("coalescer", repr(e))
                self._log("dispatch_error", error=repr(e),
                          n_items=len(batch))
                outs = [{"ok": False, "reason": REJECT_INTERNAL,
                         "detail": repr(e)}] * len(batch)
                updates = {}
            dt_ms = (time.monotonic() - t0) * 1e3
            self.metrics.observe_push_latency(dt_ms, len(batch))
            # kill here = WAL synced + applied but nothing acked: the
            # client's retry must dedupe (exactly-once leg of the contract)
            fault_point("pre_ack")
            for it, out in zip(batch, outs):
                t = self.metrics.tenants[it.stream_id]
                if out.get("duplicate"):
                    self.metrics.duplicate_acks += 1
                elif out["ok"]:
                    t.edges_accepted += it.rb.n
                    t.batches_accepted += 1
                    t.windows_closed += out["windows_closed"]
                else:
                    t.reject(out["reason"], it.rb.n)
                if not it.future.done():
                    it.future.set_result(out)
            self._fanout_estimates(updates)
            # the cycle's dispatch is still in flight (counts un-materialized
            # by design): a follow-up reap publishes its estimates without
            # waiting for the next push cycle
            self._maybe_reap_later()

    def _dispatch_deadline_s(self) -> float | None:
        """Remaining latency budget of the deferred dispatch (None = nothing
        deferred / no budget): caps the coalescer's idle wait so the
        deadline fires even when no new traffic arrives."""
        since = self._pending_since
        if since is None or self.latency_budget_ms <= 0.0:
            return None
        return max(1e-4,
                   self.latency_budget_ms / 1000.0
                   - (time.monotonic() - since))

    def _maybe_reap_later(self) -> None:
        if self._draining or not self.engine.n_inflight:
            return
        if self._reap_task is not None and not self._reap_task.done():
            return   # one follow-up at a time; it reaps whatever is in flight
        self._reap_task = asyncio.create_task(self._reap_and_publish())

    async def _reap_and_publish(self) -> None:
        try:
            updates = await self._loop.run_in_executor(
                self._pool, self._engine_reap_collect)
            self._fanout_estimates(updates)
        except Exception as e:
            self.metrics.flush_errors += 1
            self._log("reap_error", error=repr(e))

    def _fanout_estimates(self, updates: dict) -> None:
        for s, h in updates.items():
            if not self._subscribers[s]:
                continue
            lines = []
            for k, est, cnt, ce, et in zip(h["window"], h["estimate"],
                                           h["count"], h["cum_sgrs"],
                                           h["end_tau"]):
                lines.append(_encode({
                    "type": "estimate", "window": k, "estimate": est,
                    "count": cnt, "cum_sgrs": ce, "end_tau": et}))
            payload = b"".join(lines)
            dead = []
            for w in self._subscribers[s]:
                try:
                    w.write(payload)
                except (ConnectionError, RuntimeError):
                    dead.append(w)
            for w in dead:
                self._subscribers[s].discard(w)

    # -- data-plane protocol -------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        token: str | None = None
        pol: TenantPolicy | None = None
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    msg = json.loads(line)
                    if not isinstance(msg, dict):
                        raise ValueError("message must be a JSON object")
                except ValueError:
                    await self._send(writer, {"type": "error",
                                              "reason": "bad_json"})
                    continue
                mtype = msg.get("type")
                if mtype == "hello":
                    tok = str(msg.get("token"))
                    p = self.tenants.get(tok)
                    if p is None:
                        self.metrics.auth_rejected += 1
                        self._log("auth_reject", peer=str(peer))
                        await self._send(writer, {"type": "error",
                                                  "reason": "auth"})
                        break   # unauthenticated connections drop
                    token, pol = tok, p
                    await self._send(writer, {
                        "type": "hello_ok", "stream_id": p.stream_id,
                        "nt_w": self.engine.nt_w,
                        "max_batch_records": p.max_batch_records,
                        # durable watermark + 1: a reconnecting client
                        # resumes its seq lane here (docs/serving.md)
                        "next_seq": self._watermarks[p.stream_id] + 1})
                    continue
                if pol is None:
                    await self._send(writer, {"type": "error",
                                              "reason": "hello_required"})
                    continue
                if mtype == "push":
                    await self._handle_push(token, pol, msg, writer)
                elif mtype == "subscribe":
                    self._subscribers[pol.stream_id].add(writer)
                    await self._send(writer, {
                        "type": "subscribed",
                        "next_window": self._published[pol.stream_id]})
                elif mtype == "result":
                    res, updates = await self._loop.run_in_executor(
                        self._pool, self._engine_result, pol.stream_id)
                    self._fanout_estimates(updates)
                    await self._send(writer, _result_msg(res))
                elif mtype == "finalize":
                    res, updates = await self._loop.run_in_executor(
                        self._pool, self._engine_finalize_stream,
                        pol.stream_id)
                    self._fanout_estimates(updates)
                    self._log("finalize", stream_id=pol.stream_id,
                              windows=len(res.estimates))
                    await self._send(writer, _result_msg(res,
                                                         type="finalized"))
                elif mtype == "ping":
                    await self._send(writer, {"type": "pong"})
                else:
                    await self._send(writer, {"type": "error",
                                              "reason": "unknown_type",
                                              "detail": str(mtype)})
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            if pol is not None:
                self._subscribers[pol.stream_id].discard(writer)
            writer.close()

    async def _handle_push(self, token: str, pol: TenantPolicy, msg: dict,
                           writer: asyncio.StreamWriter) -> None:
        t0 = time.monotonic()
        tag = msg.get("id")
        s = pol.stream_id
        tcnt = self.metrics.tenants[s]

        async def reject(reason: str, n_edges: int, detail: str = "") -> None:
            tcnt.reject(reason, n_edges)
            self._log("push_reject", stream_id=s, reason=reason,
                      n_edges=n_edges)
            out = {"type": "reject", "reason": reason}
            if tag is not None:
                out["id"] = tag
            if detail:
                out["detail"] = detail
            await self._send(writer, out)

        if self._draining:
            await reject(REJECT_DRAINING, 0)
            return
        try:
            rb = records_from_json(msg.get("records"), stream_id=s)
        except ValueError as e:
            await reject(REJECT_BAD_RECORDS, 0, detail=str(e))
            return
        try:
            seq = normalize_seq(msg.get("seq"))
        except ValueError as e:
            await reject(REJECT_BAD_SEQ, rb.n, detail=str(e))
            return
        if seq is not None and seq <= self._watermarks[s]:
            # already durably applied (client retry after a lost ack):
            # idempotent duplicate ack, bypassing oversized/quota — the
            # records were admitted and charged the first time
            self.metrics.duplicate_acks += 1
            cached = (self._last_ack[s]
                      if seq == self._watermarks[s] else None)
            out = (dict(cached) if cached is not None
                   else {"ok": True, "accepted": 0, "windows_closed": 0})
            reply = self._push_reply(out, seq, duplicate=True)
            if tag is not None:
                reply["id"] = tag
            self._log("push_duplicate", stream_id=s, seq=seq)
            await self._send(writer, reply)
            return
        if seq is not None and seq > self._seq_hwm[s] + 1:
            await reject(REJECT_BAD_SEQ, rb.n,
                         detail=f"seq {seq} skips ahead (highest admitted "
                                f"is {self._seq_hwm[s]})")
            return
        if rb.n > pol.max_batch_records:
            await reject(REJECT_OVERSIZED, rb.n,
                         detail=f"{rb.n} > max_batch_records="
                                f"{pol.max_batch_records}")
            return
        if not self._buckets[token].admit(rb.n):
            await reject(REJECT_QUOTA, rb.n)
            return
        if seq is None:
            seq = self._seq_hwm[s] + 1   # legacy client: server-assigned
        fut = self._loop.create_future()
        try:
            self._queue.put_nowait(_Item(s, rb, fut, t0, seq))
        except asyncio.QueueFull:
            # hwm intentionally NOT advanced: a backpressure reject must
            # not burn the seq the client will retry with
            await reject(REJECT_BACKPRESSURE, rb.n,
                         detail=f"ingress queue full "
                                f"(queue_limit={self.queue_limit})")
            return
        self._seq_hwm[s] = max(self._seq_hwm[s], seq)
        out = await fut     # resolves when the engine applied the item
        ms = (time.monotonic() - t0) * 1e3
        reply = self._push_reply(out, seq,
                                 duplicate=bool(out.get("duplicate")))
        if out["ok"]:
            self._log("push", stream_id=s, n_edges=rb.n, seq=seq,
                      windows_closed=out["windows_closed"],
                      latency_ms=round(ms, 3))
        else:
            self._log("push_reject", stream_id=s, reason=out["reason"],
                      n_edges=rb.n)
        if tag is not None:
            reply["id"] = tag
        await self._send(writer, reply)

    @staticmethod
    def _push_reply(out: dict, seq: int, *, duplicate: bool = False) -> dict:
        if out["ok"]:
            reply = {"type": "ack", "accepted": out["accepted"],
                     "windows_closed": out["windows_closed"], "seq": seq}
        else:
            reply = {"type": "reject", "reason": out["reason"],
                     "detail": out.get("detail", ""), "seq": seq}
        if duplicate:
            reply["duplicate"] = True
        return reply

    @staticmethod
    async def _send(writer: asyncio.StreamWriter, obj: dict) -> None:
        writer.write(_encode(obj))
        try:
            await writer.drain()
        except ConnectionError:
            pass

    # -- control plane (minimal HTTP/1.1: /healthz + /metrics) ---------------

    async def _handle_http(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            req = await reader.readline()
            while True:   # drain headers; we never read a body
                h = await reader.readline()
                if not h or h in (b"\r\n", b"\n"):
                    break
            parts = req.decode("ascii", "replace").split()
            path = parts[1] if len(parts) >= 2 else "/"
            if path == "/healthz":
                degraded = self._degraded_reasons()
                status, body = 200, {
                    "status": ("draining" if self._draining
                               else "degraded" if degraded else "ok"),
                    "degraded": degraded,
                    "uptime_s": round(time.monotonic() - self._started_at, 3),
                    "n_streams": self.n_streams,
                }
            elif path == "/metrics":
                # gauge first (what was in flight when asked), then settle
                # the dispatch on the engine thread so windows_counted and
                # the estimator-derived numbers below are consistent — the
                # endpoint is a natural reap point, and without it a scrape
                # racing the follow-up reap task reads stale counts
                inflight = self.engine.n_inflight
                if inflight and not self._stopped:
                    try:
                        self._fanout_estimates(
                            await self._loop.run_in_executor(
                                self._pool, self._engine_reap_collect))
                    except RuntimeError:
                        pass   # pool shut down mid-stop: snapshot as-is
                status, body = 200, self.metrics.snapshot(
                    queue_depth=self._queue.qsize(),
                    queue_limit=self.queue_limit,
                    dispatch_inflight=inflight,
                    uptime_s=round(time.monotonic() - self._started_at, 3),
                    windows_counted=[self.engine.n_counted(s)
                                     for s in range(self.n_streams)],
                    degraded=self._degraded_reasons(),
                    supervision={
                        "task_restarts": dict(self._task_restarts),
                        "checkpoint_failures":
                            self.metrics.checkpoint_failures,
                        "checkpoint_fallbacks":
                            self.metrics.checkpoint_fallbacks,
                        "last_checkpoint_age_s": (
                            round(time.monotonic() - self._last_ckpt_t, 3)
                            if self._last_ckpt_t is not None else None),
                    },
                    wal=self._wal_stats(),
                    watermarks=list(self._watermarks),
                )
            else:
                status, body = 404, {"error": "not found",
                                     "paths": ["/healthz", "/metrics"]}
            payload = json.dumps(body).encode()
            phrase = {200: "OK", 404: "Not Found"}[status]
            writer.write(
                f"HTTP/1.1 {status} {phrase}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n".encode() + payload)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    # -- supervision ---------------------------------------------------------

    async def _supervised(self, name: str, factory) -> None:
        """Run ``factory()`` to completion, restarting it on unexpected
        exceptions with bounded exponential backoff (unbounded restarts —
        the loops are load-bearing; a wedged loop is worse than a thrashing
        one).  A clean return (graceful drain) or cancellation ends
        supervision.  Restarts count into ``/metrics`` supervision stats and
        flag degraded mode until the loop runs a healthy cycle again."""
        backoff = self.serving.restart_backoff
        attempt = 0
        while True:
            t0 = time.monotonic()
            try:
                await factory()
                return
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if time.monotonic() - t0 > 5.0:
                    attempt = 0     # ran healthy for a while: reset backoff
                self._task_restarts[name] = \
                    self._task_restarts.get(name, 0) + 1
                self._set_degraded(name, f"restarted after {e!r}")
                self._log("task_restart", task=name, error=repr(e),
                          restarts=self._task_restarts[name])
                await asyncio.sleep(backoff.delay(attempt))
                attempt += 1

    # -- periodic checkpoint -------------------------------------------------

    async def _checkpoint_loop(self) -> None:
        retry = self.serving.checkpoint_retry
        while True:
            await asyncio.sleep(self.checkpoint_every_s)
            attempt = 0
            while True:     # retry in place: a full disk must not silently
                try:        # end periodic checkpointing for the process
                    await self._loop.run_in_executor(
                        self._pool, self._save_checkpoint)
                    self._clear_degraded("checkpoint")
                    break
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    self.metrics.checkpoint_failures += 1
                    self._set_degraded("checkpoint", repr(e))
                    self._log("checkpoint_error", error=repr(e),
                              failures=self.metrics.checkpoint_failures)
                    await asyncio.sleep(retry.delay(attempt))
                    attempt += 1

    # -- degraded mode -------------------------------------------------------

    def _set_degraded(self, reason: str, detail: str) -> None:
        if reason not in self._degraded:
            self._log("degraded", reason=reason, detail=detail)
        self._degraded[reason] = detail

    def _clear_degraded(self, reason: str) -> None:
        if self._degraded.pop(reason, None) is not None:
            self._log("degraded_clear", reason=reason)

    def _degraded_reasons(self) -> list[str]:
        """Persistent degraded reasons plus the transient staleness check:
        a checkpoint older than ``degraded_checkpoint_age_factor`` intervals
        means periodic durability is behind even if no attempt failed yet."""
        reasons = sorted(self._degraded)
        if (self.checkpoint_every_s and self._last_ckpt_t is not None
                and not self._stopped):
            age = time.monotonic() - self._last_ckpt_t
            if (age > self.serving.degraded_checkpoint_age_factor
                    * self.checkpoint_every_s
                    and "checkpoint_stale" not in reasons):
                reasons.append("checkpoint_stale")
        return reasons

    def _wal_stats(self) -> dict:
        out = {"enabled": self._wal is not None,
               "errors": self.metrics.wal_errors}
        if self._wal is not None:
            out.update(self._wal.stats())
        return out

    # -- structured logs -----------------------------------------------------

    def _log(self, event: str, **kv) -> None:
        log.info("%s", json.dumps({"event": event, **kv}, sort_keys=True))


def _bind_device(device: torch.device) -> None:
    """The engine thread's initializer: make ``device`` its current CUDA
    device (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


def _load_kernels() -> None:
    """Load the butterfly kernel library (K1, K2), building it first only
    where no build of the same sources exists."""
    from ..kernels.butterfly.build import load_library

    load_library()


def _encode(obj: dict) -> bytes:
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode()


def _result_msg(res, *, type: str = "result") -> dict:
    return {
        "type": type,
        "estimates": [float(e) for e in res.estimates],
        "counts": [float(c) for c in res.window_counts],
        "cum_sgrs": [float(c) for c in res.cum_edges],
        "alpha_final": float(res.alpha_final),
    }
