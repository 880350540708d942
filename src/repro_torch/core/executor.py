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
   one batched Gram (``dense``), one launch of K1 (``pallas``), or one
   batched wedge sort (``sparse``), so peak device memory stays near
   ``chunk * cap_i * cap_j`` floats (``chunk * (cap_e + cap_w)`` for
   ``sparse``);
3. **routes** through a tier:

   ========  ==========================================================
   tier      implementation
   ========  ==========================================================
   numpy     host wedge-hash oracle (``count_butterflies_np``), int64
   dense     torch scatter + batched ``torch.matmul`` Gram, float32
   tiled     the Gram in row-block pairs (``count_butterflies_tiled``)
   pallas    the hand-written CUDA kernels (``repro_torch.kernels.
             butterfly``): K1, or K2 on the lanes' uint8 limb planes for
             multiset batches, one launch per bucket chunk; the name is
             the reference's, so configs and checkpoints map one to one
   sparse    wedge sort + rank aggregation (``count_butterflies_sparse``);
             O(cap_e + cap_w) memory per window, no biadjacency
   auto      per-bucket cost model (:func:`route_tier`): ``sparse`` when
             the wedge-sort work beats the dense Gram flops, ``dense``
             otherwise
   ========  ==========================================================

   A batch that carries the multiplicity lane (``edge_mult``, the
   ``multiset`` duplicate policy) runs every tier's multiplicity-weighted
   twin.  Every exact tier returns identical integer-valued counts while
   partial sums stay below 2**24.  The ``sampled`` tier name is accepted by
   the config but raises ``NotImplementedError`` until its ROADMAP item is
   ported.

**Submit / reap.**  :meth:`WindowExecutor.window_counts_submit` stages each
bucket's lanes through pinned host buffers (a ring of two per bucket shape),
copies them to the device without blocking, dispatches every chunk, and
queues one non-blocking copy of all counts back into pinned host memory
behind a CUDA event.  :meth:`PendingCounts.reap` waits on that event, so the
host can windowize the next flush while the card counts this one.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from .butterfly import (
    build_biadjacency,
    build_biadjacency_multiset,
    count_butterflies_dense,
    count_butterflies_dense_multiset,
    count_butterflies_multiset_np,
    count_butterflies_np,
    count_butterflies_sparse,
    count_butterflies_sparse_multiset,
    count_butterflies_tiled,
    count_butterflies_tiled_multiset,
    window_wedge_counts_np,
)
from .fleet import check_sampling_knobs
from .windows import WindowBatch

__all__ = ["TIERS", "PORTED_TIERS", "WindowExecutor", "ExecutorResult",
           "Bucket", "PendingCounts", "bucket_capacity", "id_capacity",
           "route_tier"]

TIERS = ("numpy", "dense", "tiled", "pallas", "sparse", "auto", "sampled")
PORTED_TIERS = ("numpy", "dense", "tiled", "pallas", "sparse", "auto")
_NOT_PORTED = {"sampled": "ROADMAP Queue 1 item 7 (sampling)"}

# tiers that need a per-bucket wedge capacity (host-side wedge counting)
_WEDGE_TIERS = ("sparse", "auto")
# the ``tiled`` tier's row-block edge (clamped to the bucket)
_TILE = 512
# the ``auto`` router's modelled cost of one sort element in dense-Gram
# flops: the reference's calibration (see :func:`route_tier`)
_SORT_COST = 96.0


def route_tier(cap_e: int, cap_i: int, cap_j: int, cap_w: int,
               *, sort_cost: float = _SORT_COST) -> str:
    """The ``auto`` tier's per-bucket density cost model, the reference's.

    Dense counting pays the Gram matmul, ``cap_i * cap_j * min(cap_i,
    cap_j)`` flops per window; sparse counting pays the edge sort
    ``cap_e log cap_e`` and the wedge sort ``cap_w log cap_w``, each element
    costing ``sort_cost`` dense flops.  Routes to ``sparse`` exactly when
    its modelled work is cheaper.  The default 96 is the reference's
    calibration, kept so that ``auto`` routes as the reference does;
    ``chip_smoke.py`` measures the card's own crossover.
    """
    hi = max(cap_i, cap_j)
    if (cap_i + 2) * (hi + 2) >= 2**31:
        # beyond the sparse tier's key-packing bound it would refuse: never
        # route into a raise
        return "dense"
    dense_flops = float(cap_i) * float(cap_j) * float(min(cap_i, cap_j))
    sort_ops = (cap_e * max(math.log2(max(cap_e, 2)), 1.0)
                + cap_w * max(math.log2(max(cap_w, 2)), 1.0))
    return "sparse" if sort_cost * sort_ops < dense_flops else "dense"


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
    """One static-shape unit: same-capacity windows.  ``cap_w`` is the
    wedge capacity, the ladder rung over the bucket's largest deduped
    per-window wedge count; it is computed (non-zero) only for the
    ``sparse`` and ``auto`` tiers, where it sizes the wedge sort and feeds
    the router's cost model."""

    cap_e: int                      # edge-lane capacity
    cap_i: int                      # i-side id-space capacity
    cap_j: int                      # j-side id-space capacity
    windows: np.ndarray = field(compare=False)  # window indices in the batch
    cap_w: int = 0                  # wedge capacity (sparse/auto tiers only)

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


def _mult_range(batch: WindowBatch, b: Bucket) -> tuple[int, int]:
    """A multiset bucket's bounds, read on the host so that the device
    never waits: (its largest multiplicity, the largest sum of squared
    multiplicities at one vertex of one of its windows, either side).  K2
    sizes its limb planes from the first and refuses a bucket by the
    second."""
    cap, win = b.cap_e, b.windows
    m = np.where(batch.valid[win, :cap], batch.edge_mult[win, :cap],
                 0).astype(np.int64)
    if m.size == 0:
        return 0, 0
    sq = (m * m).ravel().astype(np.float64)      # exact: sums stay below 2**53
    rows = np.arange(len(win))[:, None]
    top = 0.0
    for ids, n in ((batch.edge_i, b.cap_i), (batch.edge_j, b.cap_j)):
        key = rows * n + np.clip(ids[win, :cap], 0, n - 1)
        top = max(top, np.bincount(key.ravel(), weights=sq).max())
    return int(m.max()), int(top)


class WindowExecutor:
    """Counts closed windows through one tier (see module doc).

    Parameters
    ----------
    tier : "numpy" | "dense" | "tiled" | "pallas" | "sparse" | "auto"
        (``"sampled"`` raises ``NotImplementedError``).
    align, growth : capacity-ladder geometry (edge lanes geometric, id
        spaces linear), as the reference.
    chunk : windows of a bucket counted together in one batched dispatch;
        counts are identical for every chunk size.
    snap : run each bucket at its windows' actual max id-space sizes rounded
        to a multiple of ``snap`` (0 = at the rung itself, which the engine
        uses).
    block_i : the kernels' tile edge (clamped per bucket, as the reference
        clamps).
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
        # chunks dispatched to a device tier so far (one K1 or K2 launch
        # each on the pallas tier)
        self.chunks_dispatched = 0
        self._plan_cache: tuple[weakref.ref, list[Bucket]] | None = None
        # pinned staging per (bucket shape, n windows): [slot_a, slot_b,
        # cursor], each slot [host lanes, event of its last copy]
        self._staging: dict[tuple, list] = {}

    # -- planning -----------------------------------------------------------

    def plan(self, batch: WindowBatch) -> list[Bucket]:
        """Group windows into static-capacity buckets (stable window order
        within a bucket), exactly as the reference plans: the ``sparse``
        and ``auto`` tiers add each window's wedge rung to the key, and
        ``auto`` fuses dense-routed groups that differ only in that rung.
        The last batch's plan is memoized by identity."""
        if self._plan_cache is not None and self._plan_cache[0]() is batch:
            return self._plan_cache[1]
        wedges = (window_wedge_counts_np(batch.edge_i, batch.edge_j,
                                         batch.valid)
                  if self.tier in _WEDGE_TIERS else None)
        groups: dict[tuple[int, int, int, int], list[int]] = {}
        for k in range(batch.n_windows):
            # every rung clamps to the batch's own padded capacity
            key = (
                min(bucket_capacity(int(batch.n_edges[k]), align=self.align,
                                    growth=self.growth), batch.capacity),
                min(id_capacity(int(batch.n_i_per_window[k]),
                                align=self.align), max(batch.n_i, 1)),
                min(id_capacity(int(batch.n_j_per_window[k]),
                                align=self.align), max(batch.n_j, 1)),
                (bucket_capacity(int(wedges[k]), align=self.align,
                                 growth=self.growth)
                 if wedges is not None else 0),
            )
            groups.setdefault(key, []).append(k)
        if self.tier == "auto":
            # a dense-routed bucket never reads cap_w, so dense-routed groups
            # that differ only in it fuse (carrying the largest rung);
            # sparse-routed groups keep their own tight wedge capacity
            fused: dict[tuple[int, int, int], int] = {}
            wins: dict[tuple[int, int, int], list[int]] = {}
            kept: dict[tuple[int, int, int, int], list[int]] = {}
            for (cap_e, cap_i, cap_j, cap_w), idx in sorted(groups.items()):
                if route_tier(cap_e, cap_i, cap_j, cap_w,
                              sort_cost=_SORT_COST) == "dense":
                    k3 = (cap_e, cap_i, cap_j)
                    fused[k3] = max(fused.get(k3, 0), cap_w)
                    wins.setdefault(k3, []).extend(idx)
                else:
                    kept[(cap_e, cap_i, cap_j, cap_w)] = idx
            for k3, cap_w in fused.items():
                kept[k3 + (cap_w,)] = sorted(wins[k3])
            groups = kept
        buckets = []
        for (cap_e, cap_i, cap_j, cap_w), idx in sorted(groups.items()):
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
            buckets.append(Bucket(cap_e, cap_i, cap_j, win, cap_w=cap_w))
        self._plan_cache = (weakref.ref(batch), buckets)
        return buckets

    def bucket_tier(self, b: Bucket) -> str:
        """The device tier a bucket runs: the configured tier, or under
        ``auto`` the cost model's pick (:func:`route_tier`), which depends
        only on the bucket's static capacities."""
        if self.tier == "auto":
            return route_tier(b.cap_e, b.cap_i, b.cap_j, b.cap_w,
                              sort_cost=_SORT_COST)
        return self.tier

    # -- counting -----------------------------------------------------------

    def _chunk_counts(self, b: Bucket, ei: torch.Tensor, ej: torch.Tensor,
                      mm: torch.Tensor | None, v: torch.Tensor,
                      mult_range: tuple[int, int]) -> torch.Tensor:
        """``[c, cap_e]`` lanes of one chunk -> ``[c]`` float32 counts;
        ``mm`` is the multiplicity lane of a multiset batch, else None, and
        ``mult_range`` the bucket's :func:`_mult_range` (read by K2)."""
        tier = self.bucket_tier(b)
        ci, cj = b.cap_i, b.cap_j
        if tier == "sparse":
            cap_w = max(b.cap_w, 1)
            if mm is not None:
                return count_butterflies_sparse_multiset(ei, ej, mm, v, ci, cj,
                                                         cap_w)
            return count_butterflies_sparse(ei, ej, v, ci, cj, cap_w)
        if tier == "pallas":
            from ..kernels.butterfly import ops

            if mm is not None:
                max_mult, max_vertex_sq = mult_range
                return ops.butterfly_count_pallas_windows_multiset_lanes(
                    ei, ej, mm, v, ci, cj, max_mult=max_mult,
                    max_vertex_sq=max_vertex_sq, block_i=self.block_i)
            return ops.butterfly_count_pallas_windows(
                ops.oriented_biadjacency(ei, ej, v, ci, cj),
                block_i=self.block_i)
        adj = (build_biadjacency_multiset(ei, ej, mm, v, ci, cj)
               if mm is not None else build_biadjacency(ei, ej, v, ci, cj))
        if tier == "tiled":
            tile = min(_TILE, ci, cj)
            return (count_butterflies_tiled_multiset(adj, tile=tile)
                    if mm is not None else
                    count_butterflies_tiled(adj, tile=tile))
        return (count_butterflies_dense_multiset(adj) if mm is not None
                else count_butterflies_dense(adj))

    def _counter(self, b: Bucket, mult_range: tuple[int, int] = (0, 0)):
        """The counter for one bucket: device lanes ``(edge_i, edge_j,
        [edge_mult,] valid)`` ``[n, cap_e]`` -> ``[n]`` float32 counts,
        counted ``chunk`` windows at a time in stream order.  A short last
        chunk simply runs short: nothing is padded, so nothing is sliced
        off.  ``mult_range`` bounds a multiset bucket's multiplicities
        (:func:`_mult_range`)."""
        def run(*lanes):
            ei, ej = lanes[0], lanes[1]
            mm = lanes[2] if len(lanes) == 4 else None
            v = lanes[-1]
            n = ei.shape[0]
            c = max(1, min(self.chunk, n))
            outs = []
            for s in range(0, n, c):
                outs.append(self._chunk_counts(
                    b, ei[s:s + c], ej[s:s + c],
                    None if mm is None else mm[s:s + c], v[s:s + c],
                    mult_range))
                self.chunks_dispatched += 1
            return torch.cat(outs)
        return run

    def _staged_lanes(self, batch: WindowBatch, b: Bucket,
                      multiset: bool) -> tuple:
        """Stage one bucket's ``(edge_i, edge_j, [edge_mult,] valid)``
        lanes on the device.  On CUDA the lanes are gathered into pinned
        host buffers and copied without blocking; an event recorded after
        the copy guards the buffer, which is rewritten (by the submit after
        next that shares the bucket shape) only once its event has
        completed."""
        cap, win = b.cap_e, b.windows
        key = (b.cap_e, b.cap_i, b.cap_j, b.cap_w, len(win), multiset)
        cuda = self.device.type == "cuda"
        srcs = [batch.edge_i, batch.edge_j]
        if multiset:
            srcs.append(batch.edge_mult)
        srcs.append(batch.valid)
        ring = self._staging.get(key)
        if ring is None:
            def make():
                shape = (len(win), cap)
                lanes = tuple(torch.empty(shape, dtype=(
                    torch.bool if src is batch.valid else torch.int32),
                    pin_memory=cuda) for src in srcs)
                return [lanes, None]
            ring = [make(), make(), 0]
            self._staging[key] = ring
        slot = ring[ring[2]]
        ring[2] ^= 1
        lanes, event = slot
        if event is not None:
            event.synchronize()
        for src, dst in zip(srcs, lanes):
            np.take(src[:, :cap], win, axis=0, out=dst.numpy())
        if not cuda:
            return lanes
        dev = tuple(h.to(self.device, non_blocking=True) for h in lanes)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return dev

    def window_counts_submit(self, batch: WindowBatch) -> PendingCounts:
        """Stage and dispatch every bucket of ``batch`` and return a
        :class:`PendingCounts` handle without waiting for the device.  A
        batch carrying the multiplicity lane (``batch.edge_mult``) routes
        every tier through its multiplicity-weighted twin.  The ``numpy``
        tier counts on the host at submit."""
        if batch.n_windows == 0:
            return PendingCounts(0, np.zeros(0, np.int64),
                                 np.zeros(0, np.float64))
        multiset = batch.edge_mult is not None
        buckets = self.plan(batch)
        index = np.concatenate([b.windows for b in buckets])
        if self.tier == "numpy":
            counts = np.empty(len(index), dtype=np.float64)
            for pos, k in enumerate(index):
                v = batch.valid[k]
                e = np.stack([batch.edge_i[k][v], batch.edge_j[k][v]], axis=1)
                counts[pos] = (count_butterflies_multiset_np(
                    e, batch.edge_mult[k][v]) if multiset
                    else count_butterflies_np(e))
            return PendingCounts(batch.n_windows, index, counts)
        parts = [self._counter(
                     b, _mult_range(batch, b) if multiset else (0, 0))(
                     *self._staged_lanes(batch, b, multiset))
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

    def warmup(self, rungs, *, multiset: bool = False) -> int:
        """Run one all-invalid window through each ``(cap_e, cap_i, cap_j)``
        rung before the first push, so the first real flush pays no one-time
        cost (on the pallas tier: building and loading the kernels).
        ``multiset`` runs the multiplicity-weighted counters.  Blocks until
        done; returns the number of rungs run (0 for the ``numpy`` tier).
        Wedge-capacity buckets (``sparse``, and ``auto``'s sparse-routed
        groups) key additionally on ``cap_w`` and are not covered by
        3-tuple rungs."""
        if self.tier == "numpy":
            return 0
        done = 0
        for rung in rungs:
            cap_e, cap_i, cap_j = (int(x) for x in rung)
            b = Bucket(cap_e, cap_i, cap_j, np.arange(1, dtype=np.int64))
            z = torch.zeros((1, cap_e), dtype=torch.int32, device=self.device)
            v = torch.zeros((1, cap_e), dtype=torch.bool, device=self.device)
            lanes = (z, z, z, v) if multiset else (z, z, v)
            self._counter(b)(*lanes).cpu()
            done += 1
        return done
