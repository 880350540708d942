"""Window executor: tier-selectable, bucket-batched window counting in torch.

The estimators need one number per closed window: its exact in-window
butterfly count.  As in ``repro.core.executor``, the executor

1. **buckets** windows by their per-window compact sizes: ``n_edges`` climbs
   the geometric ladder ``align * growth**k`` and the id-space sizes
   ``(n_i, n_j)`` the linear ladder of multiples of ``align``
   (:func:`bucket_capacity`, :func:`id_capacity`); windows sharing all rungs
   form one bucket, and with ``snap`` a bucket runs at its windows' actual
   maximum sizes rounded to a multiple of ``snap``;
2. **batches** each bucket through a Python loop over chunks of ``chunk``
   windows: within a chunk every window counts in one batched scatter and
   one batched Gram (``dense``) or one launch of K1 (``pallas``), so peak
   device memory stays near ``chunk * cap_i * cap_j`` floats;
3. **routes** through a tier:

   ========  ==========================================================
   tier      implementation
   ========  ==========================================================
   numpy     host wedge-hash oracle (``count_butterflies_np``), int64
   dense     torch scatter + batched ``torch.matmul`` Gram, float32
   pallas    the hand-written CUDA kernel K1 (``repro_torch.kernels.
             butterfly``): one launch per bucket chunk; the name is the
             reference's, so configs and checkpoints map one to one
   ========  ==========================================================

   Every exact tier returns identical integer-valued counts while partial
   sums stay below 2**24.  The reference's other tier names (``tiled``,
   ``sparse``, ``auto``, ``sampled``) are accepted by the config but raise
   ``NotImplementedError`` here until their ROADMAP item is ported.

**Submit / reap.**  :meth:`WindowExecutor.window_counts_submit` stages each
bucket's lanes through pinned host buffers (a ring of two per bucket shape),
copies them to the device without blocking, dispatches every chunk, and
queues one non-blocking copy of all counts back into pinned host memory
behind a CUDA event.  :meth:`PendingCounts.reap` waits on that event, so the
host can windowize the next flush while the card counts this one.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from .butterfly import build_biadjacency, count_butterflies_dense, count_butterflies_np
from .fleet import check_sampling_knobs
from .windows import WindowBatch

__all__ = ["TIERS", "PORTED_TIERS", "WindowExecutor", "ExecutorResult",
           "Bucket", "PendingCounts", "bucket_capacity", "id_capacity"]

TIERS = ("numpy", "dense", "tiled", "pallas", "sparse", "auto", "sampled")
PORTED_TIERS = ("numpy", "dense", "pallas")
_NOT_PORTED = {
    "tiled": "ROADMAP Queue 1 item 6 (remaining exact tiers)",
    "sparse": "ROADMAP Queue 1 item 6 (remaining exact tiers)",
    "auto": "ROADMAP Queue 1 item 6 (remaining exact tiers)",
    "sampled": "ROADMAP Queue 1 item 7 (sampling)",
}


def bucket_capacity(n: int, *, align: int = 128, growth: int = 2) -> int:
    """Smallest ladder rung ``align * growth**k`` >= max(n, 1)."""
    cap = align
    n = max(int(n), 1)
    while cap < n:
        cap *= growth
    return cap


def id_capacity(n: int, *, align: int = 64) -> int:
    """Smallest multiple of ``align`` >= max(n, 1): the *linear* ladder the
    id-space capacities (cap_i / cap_j) climb -- they size the Gram
    quadratically, so power-of-2 rungs would nearly double its work in
    padding."""
    n = max(int(n), 1)
    return -(-n // align) * align


@dataclass(frozen=True)
class Bucket:
    """One static-shape unit: same-capacity windows."""

    cap_e: int                      # edge-lane capacity
    cap_i: int                      # i-side id-space capacity
    cap_j: int                      # j-side id-space capacity
    windows: np.ndarray = field(compare=False)  # window indices in the batch

    @property
    def n_windows(self) -> int:
        return len(self.windows)


@dataclass
class ExecutorResult:
    """Per-window counts plus the stream bookkeeping the estimators consume
    (tumbling mode: ``counts[k]`` is the exact in-window count of window k,
    ``cum_sgrs[k]`` is |E_k|)."""

    counts: np.ndarray
    cum_sgrs: np.ndarray
    tier: str
    mode: str = "tumbling"
    stream_ids: np.ndarray | None = None

    @property
    def n_windows(self) -> int:
        return len(self.counts)


class PendingCounts:
    """Handle for an in-flight bucketed window count.

    Holds the window indices of every dispatched bucket, in dispatch order,
    and a host tensor that the counts are being copied into (pinned memory
    behind ``event`` on CUDA; already filled on the CPU and for the
    ``numpy`` tier).  :meth:`reap` waits on the event, scatters the counts
    back into window order as float64 and caches the result, so it is
    idempotent.  The host tensor is allocated per submit and never reused,
    so a handle never reads a buffer that a later submit rewrites.
    """

    def __init__(self, n_windows: int, index: np.ndarray, host,
                 event: torch.cuda.Event | None = None):
        self._n = int(n_windows)
        self._index = index
        self._host = host
        self._event = event
        self._out: np.ndarray | None = None

    @property
    def done(self) -> bool:
        """Whether :meth:`reap` already materialized this handle."""
        return self._out is not None

    def reap(self) -> np.ndarray:
        """Block until the counts are on the host; return the window-ordered
        ``[n_windows] float64`` counts (cached)."""
        if self._out is None:
            if self._event is not None:
                self._event.synchronize()
            out = np.zeros(self._n, dtype=np.float64)
            host = self._host
            if isinstance(host, torch.Tensor):
                host = host.numpy()
            out[self._index] = np.asarray(host, dtype=np.float64)
            self._host = self._event = None
            self._out = out
        return self._out


class WindowExecutor:
    """Counts closed windows through one tier (see module doc).

    Parameters
    ----------
    tier : "numpy" | "dense" | "pallas" (the reference's other tier names
        raise ``NotImplementedError``).
    align, growth : capacity-ladder geometry (edge lanes geometric, id
        spaces linear), as the reference.
    chunk : windows of a bucket counted together in one batched dispatch;
        counts are identical for every chunk size.
    snap : run each bucket at its windows' actual max id-space sizes rounded
        to a multiple of ``snap`` (0 = at the rung itself, which the engine
        uses).
    block_i : K1's tile edge (clamped per bucket, as the reference clamps).
    capacity, gamma, seed, memory_budget, target_mape : the sampled tier's
        knobs, validated as the reference validates them (the tier itself is
        not ported yet).
    device : where device tiers count and the estimators run; default
        ``cuda``.  Without a card, only an explicit ``device="cpu"`` runs
        (the plain torch path).
    """

    def __init__(self, tier: str = "dense", *, align: int = 64,
                 growth: int = 2, chunk: int = 32, snap: int = 16,
                 block_i: int = 256, capacity: int = 8192,
                 gamma: float = 0.7, seed: int = 0,
                 memory_budget: int | None = None,
                 target_mape: float | None = None, device=None):
        if tier not in TIERS:
            raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
        if tier not in PORTED_TIERS:
            raise NotImplementedError(
                f"tier {tier!r} is not ported to torch yet: "
                f"{_NOT_PORTED[tier]}; ported tiers are {PORTED_TIERS}")
        if align < 1 or growth < 2:
            raise ValueError("align must be >= 1 and growth >= 2")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if snap < 0:
            raise ValueError("snap must be >= 0 (0 disables cap snapping)")
        if block_i < 8 or block_i % 8:
            raise ValueError("block_i must be a positive multiple of 8")
        check_sampling_knobs(capacity, gamma, seed)
        if memory_budget is not None and (
                isinstance(memory_budget, bool)
                or not isinstance(memory_budget, (int, np.integer))
                or int(memory_budget) <= 0):
            raise ValueError(
                f"memory_budget must be a positive int or None, "
                f"got {memory_budget!r}")
        if target_mape is not None and not (float(target_mape) > 0.0):
            raise ValueError(
                f"target_mape must be positive or None, got {target_mape!r}")
        self.device = resolve_device(device)
        self.tier = tier
        self.align = align
        self.growth = growth
        self.chunk = chunk
        self.snap = snap
        self.block_i = block_i
        self.capacity = int(capacity)
        self.gamma = float(gamma)
        self.seed = int(seed)
        self.memory_budget = (None if memory_budget is None
                              else int(memory_budget))
        self.target_mape = (None if target_mape is None
                            else float(target_mape))
        # chunks dispatched to a device tier so far (one K1 launch each on
        # the pallas tier)
        self.chunks_dispatched = 0
        self._plan_cache: tuple[weakref.ref, list[Bucket]] | None = None
        # pinned staging per (bucket shape, n windows): [slot_a, slot_b,
        # cursor], each slot [host lanes, event of its last copy]
        self._staging: dict[tuple, list] = {}

    # -- planning -----------------------------------------------------------

    def plan(self, batch: WindowBatch) -> list[Bucket]:
        """Group windows into static-capacity buckets (stable window order
        within a bucket), exactly as the reference plans an exact tier.  The
        last batch's plan is memoized by identity."""
        if self._plan_cache is not None and self._plan_cache[0]() is batch:
            return self._plan_cache[1]
        groups: dict[tuple[int, int, int], list[int]] = {}
        for k in range(batch.n_windows):
            # every rung clamps to the batch's own padded capacity
            key = (
                min(bucket_capacity(int(batch.n_edges[k]), align=self.align,
                                    growth=self.growth), batch.capacity),
                min(id_capacity(int(batch.n_i_per_window[k]),
                                align=self.align), max(batch.n_i, 1)),
                min(id_capacity(int(batch.n_j_per_window[k]),
                                align=self.align), max(batch.n_j, 1)),
            )
            groups.setdefault(key, []).append(k)
        buckets = []
        for (cap_e, cap_i, cap_j), idx in sorted(groups.items()):
            win = np.asarray(idx, dtype=np.int64)
            if self.snap:
                cap_e = min(id_capacity(
                    int(batch.n_edges[win].max()), align=self.align), cap_e)
                cap_i = min(id_capacity(
                    int(batch.n_i_per_window[win].max()), align=self.snap),
                    cap_i)
                cap_j = min(id_capacity(
                    int(batch.n_j_per_window[win].max()), align=self.snap),
                    cap_j)
            buckets.append(Bucket(cap_e, cap_i, cap_j, win))
        self._plan_cache = (weakref.ref(batch), buckets)
        return buckets

    # -- counting -----------------------------------------------------------

    def _chunk_counts(self, b: Bucket, ei: torch.Tensor, ej: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
        """``[c, cap_e]`` lanes of one chunk -> ``[c]`` float32 counts."""
        if self.tier == "dense":
            return count_butterflies_dense(
                build_biadjacency(ei, ej, v, b.cap_i, b.cap_j))
        from ..kernels.butterfly.ops import (
            butterfly_count_pallas_windows,
            oriented_biadjacency,
        )

        adjs = oriented_biadjacency(ei, ej, v, b.cap_i, b.cap_j)
        return butterfly_count_pallas_windows(adjs, block_i=self.block_i)

    def _counter(self, b: Bucket):
        """The counter for one bucket: ``(edge_i, edge_j, valid)`` device
        lanes ``[n, cap_e]`` -> ``[n]`` float32 counts, counted ``chunk``
        windows at a time in stream order.  A short last chunk simply runs
        short: nothing is padded, so nothing is sliced off."""
        def run(ei, ej, v):
            n = ei.shape[0]
            c = max(1, min(self.chunk, n))
            outs = []
            for s in range(0, n, c):
                outs.append(self._chunk_counts(b, ei[s:s + c], ej[s:s + c],
                                               v[s:s + c]))
                self.chunks_dispatched += 1
            return torch.cat(outs)
        return run

    def _staged_lanes(self, batch: WindowBatch, b: Bucket) -> tuple:
        """Stage one bucket's ``(edge_i, edge_j, valid)`` lanes on the
        device.  On CUDA the lanes are gathered into pinned host buffers and
        copied without blocking; an event recorded after the copy guards the
        buffer, which is rewritten (by the submit after next that shares the
        bucket shape) only once its event has completed."""
        cap, win = b.cap_e, b.windows
        key = (b.cap_e, b.cap_i, b.cap_j, len(win))
        cuda = self.device.type == "cuda"
        ring = self._staging.get(key)
        if ring is None:
            def make():
                shape = (len(win), cap)
                lanes = (torch.empty(shape, dtype=torch.int32, pin_memory=cuda),
                         torch.empty(shape, dtype=torch.int32, pin_memory=cuda),
                         torch.empty(shape, dtype=torch.bool, pin_memory=cuda))
                return [lanes, None]
            ring = [make(), make(), 0]
            self._staging[key] = ring
        slot = ring[ring[2]]
        ring[2] ^= 1
        lanes, event = slot
        if event is not None:
            event.synchronize()
        np.take(batch.edge_i[:, :cap], win, axis=0, out=lanes[0].numpy())
        np.take(batch.edge_j[:, :cap], win, axis=0, out=lanes[1].numpy())
        np.take(batch.valid[:, :cap], win, axis=0, out=lanes[2].numpy())
        if not cuda:
            return lanes
        dev = tuple(h.to(self.device, non_blocking=True) for h in lanes)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return dev

    def window_counts_submit(self, batch: WindowBatch) -> PendingCounts:
        """Stage and dispatch every bucket of ``batch`` and return a
        :class:`PendingCounts` handle without waiting for the device.  The
        ``numpy`` tier counts on the host at submit."""
        if batch.edge_mult is not None:
            raise NotImplementedError(
                "multiset counting (dup_policy='multiset') needs kernel K2, "
                "which is not ported yet (ROADMAP Queue 2)")
        if batch.n_windows == 0:
            return PendingCounts(0, np.zeros(0, np.int64),
                                 np.zeros(0, np.float64))
        buckets = self.plan(batch)
        index = np.concatenate([b.windows for b in buckets])
        if self.tier == "numpy":
            counts = np.empty(len(index), dtype=np.float64)
            pos = 0
            for b in buckets:
                for k in b.windows:
                    v = batch.valid[k]
                    counts[pos] = count_butterflies_np(np.stack(
                        [batch.edge_i[k][v], batch.edge_j[k][v]], axis=1))
                    pos += 1
            return PendingCounts(batch.n_windows, index, counts)
        parts = [self._counter(b)(*self._staged_lanes(batch, b))
                 for b in buckets]
        dev = torch.cat(parts)
        if self.device.type != "cuda":
            return PendingCounts(batch.n_windows, index, dev)
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return PendingCounts(batch.n_windows, index, host, event)

    def window_counts(self, batch: WindowBatch) -> np.ndarray:
        """Exact in-window count per window, ``[n_windows]`` float64:
        ``window_counts_submit(batch).reap()``."""
        return self.window_counts_submit(batch).reap()

    def warmup(self, rungs) -> int:
        """Run one all-invalid window through each ``(cap_e, cap_i, cap_j)``
        rung before the first push, so the first real flush pays no one-time
        cost (on the pallas tier: building and loading K1).  Blocks until
        done; returns the number of rungs run (0 for the ``numpy`` tier)."""
        if self.tier == "numpy":
            return 0
        done = 0
        for rung in rungs:
            cap_e, cap_i, cap_j = (int(x) for x in rung)
            b = Bucket(cap_e, cap_i, cap_j, np.arange(1, dtype=np.int64))
            z = torch.zeros((1, cap_e), dtype=torch.int32, device=self.device)
            v = torch.zeros((1, cap_e), dtype=torch.bool, device=self.device)
            self._counter(b)(z, z, v).cpu()
            done += 1
        return done
