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
   sampled   FLEET subsample-and-scale (``count_butterflies_sampled_from_
             edges``): jax's threefry coins per edge, the dense counter on
             the survivors, ``p**-4`` scaling; windows that fit
             ``capacity`` count exactly; the budget router
             (:meth:`WindowExecutor.bucket_tier`) may send a bucket to
             ``dense``
   ========  ==========================================================

   A batch that carries the multiplicity lane (``edge_mult``, the
   ``multiset`` duplicate policy) runs every tier's multiplicity-weighted
   twin (``sampled`` refuses it).  Every exact tier returns identical
   integer-valued counts while partial sums stay below 2**24.

**Entries.**  :meth:`WindowExecutor.run` (and the module-level :func:`run`)
counts a batch in ``tumbling`` mode, or in ``sliding`` mode as the prefix
difference of the pane counts over ``span`` panes;
:meth:`WindowExecutor.count_edges` counts one online window from raw edge
ids; :meth:`WindowExecutor.decrement_window_counts` applies late deletions
to counted windows, per window on the host (:func:`butterfly_delta_np`) or
by one bucketed recount of the survivors (:func:`route_decrement`).

**Submit / reap.**  :meth:`WindowExecutor.window_counts_submit` stages each
bucket's lanes through pinned host buffers (a ring of two per bucket shape),
copies them to the device without blocking, dispatches every chunk, and
queues one non-blocking copy of all counts back into pinned host memory
behind a CUDA event.  :meth:`PendingCounts.reap` waits on that event, so the
host can windowize the next flush while the card counts this one.

**Sharding.**  ``devices=`` / ``mesh=`` split each bucket's window axis over
the devices of a mesh's data-parallel axes (``launch.mesh``,
``distributed.sharding.batch_partition_axes``), as the reference's
``shard_map`` does: the bucket is staged once, padded with all-invalid
windows to a multiple of the shard count, and each shard's contiguous slice
goes to its device, where the same chunk loop counts it (K1 or K2 per shard
on ``pallas``); a shard whose slice holds only pad windows (a bucket of
fewer windows than shards) is not dispatched, so a bucket of one window
launches once however many shards there are.  Every shard is dispatched
before anything is read back, so
distinct cards count concurrently; :meth:`PendingCounts.reap` gathers the
shards' counts in window order and drops the pad windows.  A mesh may name
one device more than once (the CPU tests, one card): shards are keyed by
their index.  Counts equal the unsharded ones bit for bit on every tier,
``sampled`` included (its coins are keyed by window).  The mesh's first
device is the executor's home ``device``, where ``count_edges`` counts and
the estimators run.

**Counters.**  A bucket's counter (the chunk loop of one bucket
configuration: routed tier, id capacities, wedge capacity, chunk, tile
edge, sampling knobs) is memoized for the process, as the reference
memoizes its compiled per-bucket programs, so every executor and every
flush shares one per configuration; a sharded executor's counter is keyed
on its shard devices too.  The port compiles nothing per configuration
(each kernel builds once per source), so the memo saves no compile; it
keeps the reference's contract that steady-state streaming adds no new
configuration, which :func:`compiled_bucket_cache_info` reports under the
reference's keys.
"""
from __future__ import annotations

import functools
import math
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import on_device, resolve_device, same_device
from .butterfly import (
    _check_id_range_np,
    build_biadjacency,
    build_biadjacency_multiset,
    butterfly_delta_np,
    count_butterflies_dense,
    count_butterflies_dense_multiset,
    count_butterflies_multiset_np,
    count_butterflies_np,
    count_butterflies_sampled_from_edges,
    count_butterflies_sparse,
    count_butterflies_sparse_multiset,
    count_butterflies_tiled,
    count_butterflies_tiled_multiset,
    window_wedge_counts_np,
)
from .fleet import check_sampling_knobs
from .windows import WindowBatch, pack_windows

__all__ = ["TIERS", "MODES", "WindowExecutor", "ExecutorResult", "Bucket",
           "PendingCounts", "run", "route_tier", "route_decrement",
           "bucket_capacity", "id_capacity", "expected_mape",
           "compiled_bucket_cache_info"]

TIERS = ("numpy", "dense", "tiled", "pallas", "sparse", "auto", "sampled")
MODES = ("tumbling", "sliding")

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


def expected_mape(cap_e: int, capacity: int, gamma: float,
                  *, k_err: float = 8.0) -> float:
    """The reference's surrogate for the sampled tier's expected relative
    error at a bucket rung: each butterfly survives with probability
    ``p**4`` (p the gamma rung a ``cap_e``-edge window settles at), so the
    error scales like ``sqrt((p**-4 - 1) / capacity)``; ``k_err`` is the
    reference's empirical calibration.  0.0 when the window fits the
    reservoir (sampling is exact there)."""
    if cap_e <= capacity:
        return 0.0
    k = max(0, math.ceil(math.log(capacity / cap_e) / math.log(gamma)))
    p = float(gamma) ** k
    return k_err * math.sqrt(max(p ** -4 - 1.0, 0.0) / max(capacity, 1))


def route_decrement(n_edges: int, n_deleted: int,
                    *, delta_frac: float = 0.25) -> str:
    """Decremental router: patch a window's prior count per deletion on the
    host (``"delta"``) while at most ``delta_frac`` of its edges retract,
    else recount its survivors on the device (``"recount"``).  A static
    host-side decision, as the reference's."""
    if n_edges < 0 or n_deleted < 0:
        raise ValueError("edge/delete counts must be non-negative")
    return "delta" if n_deleted <= delta_frac * n_edges else "recount"


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
    """Per-output-window counts plus the stream bookkeeping the estimators
    consume.  Tumbling mode: ``counts[k]`` is the exact in-window count of
    pane k.  Sliding mode: the prefix difference of pane counts over
    ``span`` panes (butterflies straddling panes stay the estimator's
    inter-window term).  ``cum_sgrs[k]`` is |E_k|; ``n_shards`` is the
    number of shards each bucket's windows were split over (1 unsharded and
    on the ``numpy`` tier); ``stream_ids`` the batch's provenance lane, if
    it had one."""

    counts: np.ndarray
    cum_sgrs: np.ndarray
    tier: str
    mode: str = "tumbling"
    span: int = 1
    n_shards: int = 1
    stream_ids: np.ndarray | None = None

    @property
    def n_windows(self) -> int:
        return len(self.counts)


class PendingCounts:
    """Handle for an in-flight bucketed window count.

    Holds one host tensor per shard that its counts are being copied into
    (pinned memory behind one CUDA event each; already filled on the CPU
    and for the ``numpy`` tier), and ``index``: the window of each count
    of the shards' concatenation, -1 for a pad window.  :meth:`reap` waits
    on the events, scatters the counts back into window order as float64
    and caches the result, so it is idempotent.  The host tensors are
    allocated per submit and never reused, so a handle never reads a buffer
    that a later submit rewrites.
    """

    def __init__(self, n_windows: int, index: np.ndarray, hosts: list,
                 events: list | tuple = ()):
        self._n = int(n_windows)
        self._index = index
        self._hosts = hosts
        self._events = events
        self._out: np.ndarray | None = None

    @property
    def done(self) -> bool:
        """Whether :meth:`reap` already materialized this handle."""
        return self._out is not None

    def reap(self) -> np.ndarray:
        """Block until the counts are on the host; return the window-ordered
        ``[n_windows] float64`` counts (cached)."""
        if self._out is None:
            for event in self._events:
                event.synchronize()
            out = np.zeros(self._n, dtype=np.float64)
            counts = np.concatenate([
                np.asarray(h.numpy() if isinstance(h, torch.Tensor) else h,
                           dtype=np.float64) for h in self._hosts])
            real = self._index >= 0
            out[self._index[real]] = counts[real]
            self._hosts = self._events = None
            self._out = out
        return self._out


def _resolve_window_mesh(devices, mesh) -> tuple:
    """Normalize the ``devices=`` / ``mesh=`` knobs (mutually exclusive) to
    ``(mesh | None, shard devices)``: one device per shard, in the mesh's
    order over its data-parallel axes (``batch_partition_axes``), at index
    0 of every other axis (the reference replicates over those).
    ``devices`` is an int (the first N cards) or a device sequence
    (``launch.mesh.make_window_mesh``)."""
    if devices is not None and mesh is not None:
        raise ValueError("pass devices= or mesh=, not both")
    if mesh is None:
        if devices is None:
            return None, ()
        from ..launch.mesh import make_window_mesh

        mesh = make_window_mesh(devices)
    from ..distributed.sharding import batch_partition_axes

    axes = batch_partition_axes(mesh)
    grid = np.moveaxis(mesh.devices,
                       [mesh.axis_names.index(a) for a in axes],
                       list(range(len(axes))))
    n_shards = math.prod(grid.shape[:len(axes)])
    return mesh, tuple(grid.reshape(n_shards, -1)[:, 0])


def _pad_window_axis(*arrays: np.ndarray, multiple: int) -> tuple:
    """Pad the leading (window) axis to a multiple of the shard count with
    all-invalid windows, which every tier counts as 0; their counts are
    dropped on the host.  Variadic over the per-window lanes."""
    pad = (-arrays[0].shape[0]) % multiple
    if pad == 0:
        return arrays
    return tuple(np.concatenate(
        [a, np.zeros((pad,) + a.shape[1:], dtype=a.dtype)]) for a in arrays)


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


def _chunk_counts(tier: str, cap_i: int, cap_j: int, cap_w: int,
                  block_i: int, sampled: tuple | None, ei: torch.Tensor,
                  ej: torch.Tensor, mm: torch.Tensor | None, v: torch.Tensor,
                  mult_range: tuple[int, int]) -> torch.Tensor:
    """``[c, cap_e]`` lanes of one chunk -> ``[c]`` float32 counts through
    the routed ``tier``; ``mm`` is the multiplicity lane of a multiset batch
    or the ``[c, 2]`` uid halves of a sampled bucket, else None,
    ``mult_range`` the bucket's :func:`_mult_range` (read by K2) and
    ``sampled`` the ``(capacity, gamma, seed)`` of a sampled bucket."""
    if tier == "sampled":
        capacity, gamma, seed = sampled
        return count_butterflies_sampled_from_edges(
            ei, ej, v, mm[:, 0], mm[:, 1], cap_i, cap_j,
            capacity=capacity, gamma=gamma, seed=seed)
    if tier == "sparse":
        cap_w = max(cap_w, 1)
        if mm is not None:
            return count_butterflies_sparse_multiset(ei, ej, mm, v, cap_i,
                                                     cap_j, cap_w)
        return count_butterflies_sparse(ei, ej, v, cap_i, cap_j, cap_w)
    if tier == "pallas":
        from ..kernels.butterfly import ops

        if mm is not None:
            max_mult, max_vertex_sq = mult_range
            return ops.butterfly_count_pallas_windows_multiset_lanes(
                ei, ej, mm, v, cap_i, cap_j, max_mult=max_mult,
                max_vertex_sq=max_vertex_sq, block_i=block_i)
        return ops.butterfly_count_pallas_windows(
            ops.oriented_biadjacency(ei, ej, v, cap_i, cap_j),
            block_i=block_i)
    adj = (build_biadjacency_multiset(ei, ej, mm, v, cap_i, cap_j)
           if mm is not None else build_biadjacency(ei, ej, v, cap_i, cap_j))
    if tier == "tiled":
        tile = min(_TILE, cap_i, cap_j)
        return (count_butterflies_tiled_multiset(adj, tile=tile)
                if mm is not None else
                count_butterflies_tiled(adj, tile=tile))
    return (count_butterflies_dense_multiset(adj) if mm is not None
            else count_butterflies_dense(adj))


def _count_chunks(key: tuple, lanes, mult_range) -> torch.Tensor:
    """A bucket's device lanes ``(edge_i, edge_j, [edge_mult | uid,]
    valid)`` ``[n, cap_e]`` -> ``[n]`` float32 counts, counted ``chunk``
    windows at a time in stream order (``key``: :meth:`WindowExecutor.
    _bucket_key`).  A short last chunk simply runs short: nothing is
    padded, so nothing is sliced off."""
    tier, cap_i, cap_j, cap_w, chunk, block_i, sampled = key
    ei, ej, v = lanes[0], lanes[1], lanes[-1]
    mm = lanes[2] if len(lanes) == 4 else None
    c = _chunk_size(chunk, ei.shape[0])
    return torch.cat([_chunk_counts(
        tier, cap_i, cap_j, cap_w, block_i, sampled, ei[s:s + c],
        ej[s:s + c], None if mm is None else mm[s:s + c], v[s:s + c],
        mult_range) for s in range(0, ei.shape[0], c)])


def _chunk_size(chunk: int, n: int) -> int:
    return max(1, min(chunk, n))


@functools.lru_cache(maxsize=None)
def _bucket_counter(*key):
    """The counter of one bucket configuration on one device, memoized on
    ``key`` (:meth:`WindowExecutor._bucket_key`): ``run(*lanes,
    mult_range)`` -> ``[n]`` float32 counts."""
    def run(*lanes, mult_range=(0, 0)):
        return _count_chunks(key, lanes, mult_range)
    return run


@functools.lru_cache(maxsize=None)
def _sharded_bucket_counter(*key_and_devices):
    """The sharded twin of :func:`_bucket_counter`, memoized on the key and
    the shard devices (the last item): ``run(shards, mult_range)`` counts
    each shard's lanes on its device, every shard queued before anything
    is read back, and returns the shards' counts."""
    key, devices = key_and_devices[:-1], key_and_devices[-1]

    def run(shards, mult_range=(0, 0)):
        outs = []
        for dev, lanes in zip(devices, shards):
            with on_device(dev):
                outs.append(_count_chunks(key, lanes, mult_range))
        return outs
    return run


def compiled_bucket_cache_info() -> dict:
    """Sizes of the process-wide bucket-counter memos, under the
    reference's keys: ``single_device`` (unsharded executors) and
    ``sharded``.  A recurring bucket shape reuses its counter, so the
    sizes stay flat across the flushes of a stream whose shapes recur
    (``tests/test_torch_engine.py``)."""
    return {
        "single_device": _bucket_counter.cache_info().currsize,
        "sharded": _sharded_bucket_counter.cache_info().currsize,
    }


class WindowExecutor:
    """Counts closed windows through one tier (see module doc).

    Parameters
    ----------
    tier : "numpy" | "dense" | "tiled" | "pallas" | "sparse" | "auto" |
        "sampled".
    align, growth : capacity-ladder geometry (edge lanes geometric, id
        spaces linear), as the reference.
    chunk : windows of a bucket counted together in one batched dispatch;
        counts are identical for every chunk size.
    snap : run each bucket at its windows' actual max id-space sizes rounded
        to a multiple of ``snap`` (0 = at the rung itself, which the engine
        uses).
    block_i : the kernels' tile edge (clamped per bucket, as the reference
        clamps).
    capacity, gamma, seed : the ``sampled`` tier's FLEET reservoir capacity
        (most edges counted per window), gamma schedule factor and threefry
        seed.  Windows that fit ``capacity`` count exactly.
    memory_budget, target_mape : the ``sampled`` tier's budget router
        (:meth:`bucket_tier`): a bucket whose edge rung fits
        ``memory_budget``, or whose modelled error (:func:`expected_mape`)
        passes ``target_mape``, counts on ``dense``.
    device : where device tiers count and the estimators run; default
        ``cuda``.  Without a card, only an explicit ``device="cpu"`` runs
        (the plain torch path).
    devices : an int (the first N cards) or a device sequence, which may
        repeat a device: shard each bucket's window axis over a 1-D
        "data" mesh of those devices (module doc).  Counts stay equal to
        the unsharded ones bit for bit.
    mesh : a prebuilt ``launch.mesh.Mesh`` (not with ``devices``); windows
        shard over its data-parallel axes.  With either knob the home
        ``device`` is the mesh's first device, and a ``device=`` that names
        another raises.  The ``numpy`` tier counts on the host, shards
        nothing and reports ``n_shards == 1``.
    """

    def __init__(self, tier: str = "dense", *, align: int = 64,
                 growth: int = 2, chunk: int = 32, snap: int = 16,
                 block_i: int = 256, capacity: int = 8192,
                 gamma: float = 0.7, seed: int = 0,
                 memory_budget: int | None = None,
                 target_mape: float | None = None, device=None,
                 devices=None, mesh=None):
        if tier not in TIERS:
            raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
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
        self.mesh, shards = _resolve_window_mesh(devices, mesh)
        if self.mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = self.mesh.devices.flat[0]
            if device is not None and not same_device(device, self.device):
                raise ValueError(
                    f"device={device!r} conflicts with the mesh's first "
                    f"device {self.device}")
        if tier == "numpy" or not shards:
            shards = (self.device,)
        # the devices each bucket's windows split over, one per shard
        self.shard_devices: tuple[torch.device, ...] = shards
        self.n_shards = len(shards)
        self._pinned = any(d.type == "cuda" for d in shards)
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
        # count_edges: its sampled windows' uid sequence
        self._online_seq = 0
        self._plan_cache: tuple[weakref.ref, list[Bucket]] | None = None
        # pinned staging per (bucket shape, n windows): [slot_a, slot_b,
        # cursor], each slot [host lanes, events of its last copies]
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

    def _sampled_route(self, cap_e: int) -> str:
        """The ``sampled`` tier's per-rung budget router: ``dense`` when the
        rung fits ``memory_budget`` or its modelled error
        (:func:`expected_mape`) passes ``target_mape``, else ``sampled``."""
        if self.memory_budget is not None and cap_e <= self.memory_budget:
            return "dense"
        if self.target_mape is not None and expected_mape(
                cap_e, self.capacity, self.gamma) > self.target_mape:
            return "dense"
        return "sampled"

    def bucket_tier(self, b: Bucket) -> str:
        """The device tier a bucket runs: the configured tier, the cost
        model's pick (:func:`route_tier`) under ``auto``, or the budget
        router's (:meth:`_sampled_route`) under ``sampled``; each depends
        only on the bucket's static capacities."""
        if self.tier == "auto":
            return route_tier(b.cap_e, b.cap_i, b.cap_j, b.cap_w,
                              sort_cost=_SORT_COST)
        if self.tier == "sampled":
            return self._sampled_route(b.cap_e)
        return self.tier

    # -- counting -----------------------------------------------------------

    def _bucket_key(self, b: Bucket) -> tuple:
        """What a bucket's counter depends on: its routed tier, its id
        capacities, its wedge capacity (``sparse``), the chunk, the tile
        edge (``pallas``) and the sampling knobs (``sampled``)."""
        tier = self.bucket_tier(b)
        return (tier, b.cap_i, b.cap_j, b.cap_w if tier == "sparse" else 0,
                self.chunk, self.block_i if tier == "pallas" else 0,
                (self.capacity, self.gamma, self.seed) if tier == "sampled"
                else None)

    def _count_shards(self, b: Bucket, shards: list[tuple],
                      mult_range: tuple[int, int] = (0, 0),
                      devices: tuple | None = None) -> list[torch.Tensor]:
        """Count bucket ``b``'s lanes, one lane tuple per shard on
        ``devices`` (default the executor's shard devices; a tuple of one
        counts unsharded), through the memoized counter; returns each
        shard's ``[n]`` float32 counts.  ``mult_range`` bounds a multiset
        bucket's multiplicities (:func:`_mult_range`); a sampled bucket's
        lanes carry its ``[n, 2]`` uid halves in place of the
        multiplicities."""
        devices = self.shard_devices if devices is None else devices
        key = self._bucket_key(b)
        if len(devices) > 1:
            outs = _sharded_bucket_counter(*key, devices)(shards, mult_range)
        else:
            with on_device(devices[0]):
                outs = [_bucket_counter(*key)(*shards[0],
                                              mult_range=mult_range)]
        for lanes in shards:
            n = lanes[0].shape[0]
            self.chunks_dispatched += -(-n // _chunk_size(self.chunk, n))
        return outs

    def _staged_lanes(self, batch: WindowBatch, b: Bucket, multiset: bool,
                      uids: np.ndarray | None) -> list[tuple]:
        """Stage one bucket's ``(edge_i, edge_j, [edge_mult | uid,] valid)``
        lanes once and return one lane tuple per shard that holds a window
        of the bucket, on its device (``uids``: the batch's
        ``[n_windows, 2]`` uid halves, staged for a sampled bucket).  The
        lanes are gathered into host buffers of ``n_shards`` equal slices,
        padded with all-invalid windows (zeros, never written), and each
        slice goes to its shard's device; a trailing slice of pad windows
        only stays on the host (nothing would count in it).  With a
        card the buffers are pinned and copied without blocking; an event
        recorded after each copy guards the buffer, which is rewritten (by
        the submit after next that shares the bucket shape) only once its
        events have completed."""
        cap, win = b.cap_e, b.windows
        sampled = uids is not None and self.bucket_tier(b) == "sampled"
        key = (b.cap_e, b.cap_i, b.cap_j, b.cap_w, len(win), multiset,
               sampled)
        per = -(-len(win) // self.n_shards)
        # (source rows, dtype) per lane
        srcs = [(batch.edge_i[:, :cap], torch.int32),
                (batch.edge_j[:, :cap], torch.int32)]
        if multiset:
            srcs.append((batch.edge_mult[:, :cap], torch.int32))
        if sampled:
            srcs.append((uids, torch.int64))
        srcs.append((batch.valid[:, :cap], torch.bool))
        ring = self._staging.get(key)
        if ring is None:
            def make():
                lanes = tuple(torch.zeros((per * self.n_shards, src.shape[1]),
                                          dtype=dtype, pin_memory=self._pinned)
                              for src, dtype in srcs)
                return [lanes, ()]
            ring = [make(), make(), 0]
            self._staging[key] = ring
        slot = ring[ring[2]]
        ring[2] ^= 1
        lanes, events = slot
        for event in events:
            event.synchronize()
        for (src, _), dst in zip(srcs, lanes):
            np.take(src, win, axis=0, out=dst.numpy()[:len(win)])
        shards, events = [], []
        live = -(-len(win) // per)
        for k, dev in enumerate(self.shard_devices[:live]):
            part = tuple(h[k * per:(k + 1) * per] for h in lanes)
            if dev.type == "cuda":
                with on_device(dev):
                    part = tuple(h.to(dev, non_blocking=True) for h in part)
                    events.append(torch.cuda.Event())
                    events[-1].record()
            shards.append(part)
        slot[1] = events
        return shards

    @staticmethod
    def _batch_uids(batch: WindowBatch) -> np.ndarray:
        """Per-window sampling uids as ``[n_windows, 2]`` int64 (hi, lo)
        uint32 halves.  The batch's own ``sample_uid`` lane wins (the
        engines stamp ``(res_seed << 32) + cum_sgrs``); a lane-less batch
        derives ``(stream_id << 32) + (cum_sgrs & 0xFFFFFFFF)`` (stream 0
        for a single-stream batch), which is what a seed-0 engine stamps,
        so streaming equals replay on the sampled tier too."""
        uid = batch.sample_uid
        if uid is None:
            sid = (batch.stream_ids.astype(np.int64)
                   if batch.stream_ids is not None
                   else np.zeros(batch.n_windows, np.int64))
            uid = (sid << np.int64(32)) + (
                np.asarray(batch.cum_sgrs, np.int64) & np.int64(0xFFFFFFFF))
        uid = np.asarray(uid, np.int64)
        return np.stack([(uid >> np.int64(32)) & np.int64(0xFFFFFFFF),
                         uid & np.int64(0xFFFFFFFF)], axis=1)

    def window_counts_submit(self, batch: WindowBatch) -> PendingCounts:
        """Stage and dispatch every bucket of ``batch`` and return a
        :class:`PendingCounts` handle without waiting for the device.  A
        batch carrying the multiplicity lane (``batch.edge_mult``) routes
        every tier through its multiplicity-weighted twin (the ``sampled``
        tier refuses it).  The ``numpy`` tier counts on the host at
        submit.  On a sharded executor each bucket's windows split over the
        shards (module doc)."""
        if batch.n_windows == 0:
            return PendingCounts(0, np.zeros(0, np.int64), [np.zeros(0)])
        multiset = batch.edge_mult is not None
        if multiset and self.tier == "sampled":
            raise NotImplementedError(
                "sampled tier does not support dup_policy='multiset': the "
                "subsample-and-scale identity assumes distinct edges (a "
                "multiplicity-weighted butterfly is not a p**4 event); use "
                "an exact tier for multiset streams")
        uids = self._batch_uids(batch) if self.tier == "sampled" else None
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
            return PendingCounts(batch.n_windows, index, [counts])
        counts: list[list[torch.Tensor]] = [[] for _ in self.shard_devices]
        index: list[list[np.ndarray]] = [[] for _ in self.shard_devices]
        for b in buckets:
            shards = self._staged_lanes(batch, b, multiset, uids)
            per = shards[0][0].shape[0]
            win = np.concatenate([b.windows, np.full(
                per * self.n_shards - len(b.windows), -1, np.int64)])
            # every shard holding a window is dispatched before anything is
            # read back
            outs = self._count_shards(
                b, shards, _mult_range(batch, b) if multiset else (0, 0))
            for k, out in enumerate(outs):
                counts[k].append(out)
                index[k].append(win[k * per:(k + 1) * per])
        hosts, events = [], []
        for dev, parts in zip(self.shard_devices, counts):
            if not parts:
                continue
            dev_counts = torch.cat(parts)
            if dev.type != "cuda":
                hosts.append(dev_counts)
                continue
            with on_device(dev):
                host = torch.empty(dev_counts.shape, dtype=dev_counts.dtype,
                                   pin_memory=True)
                host.copy_(dev_counts, non_blocking=True)
                events.append(torch.cuda.Event())
                events[-1].record()
            hosts.append(host)
        return PendingCounts(batch.n_windows,
                             np.concatenate([np.concatenate(p) for p in index
                                             if p]),
                             hosts, events)

    def window_counts(self, batch: WindowBatch) -> np.ndarray:
        """Exact in-window count per window, ``[n_windows]`` float64:
        ``window_counts_submit(batch).reap()``."""
        return self.window_counts_submit(batch).reap()

    def warmup(self, rungs, *, multiset: bool = False) -> int:
        """Run one all-invalid window through each ``(cap_e, cap_i, cap_j)``
        rung before the first push, so the first real flush pays no one-time
        cost (on the pallas tier: building and loading the kernels).
        ``multiset`` runs the multiplicity-weighted counters; a sampled
        rung runs with a zero uid; a sharded executor runs each rung on
        every shard.  Blocks until done; returns the number of rungs run (0
        for the ``numpy`` tier).
        Wedge-capacity buckets (``sparse``, and ``auto``'s sparse-routed
        groups) key additionally on ``cap_w`` and are not covered by
        3-tuple rungs."""
        if self.tier == "numpy":
            return 0
        if multiset and self.tier == "sampled":
            raise NotImplementedError(
                "sampled tier does not support dup_policy='multiset'")
        done = 0
        for rung in rungs:
            cap_e, cap_i, cap_j = (int(x) for x in rung)
            b = Bucket(cap_e, cap_i, cap_j, np.arange(1, dtype=np.int64))
            lanes = [np.zeros((1, cap_e), np.int32)] * 2
            if multiset:
                lanes.append(np.zeros((1, cap_e), np.int32))
            elif self.bucket_tier(b) == "sampled":
                lanes.append(np.zeros((1, 2), np.int64))
            lanes.append(np.zeros((1, cap_e), bool))
            lanes = _pad_window_axis(*lanes, multiple=self.n_shards)
            shards = [tuple(torch.from_numpy(a[k:k + 1]).to(dev)
                            for a in lanes)
                      for k, dev in enumerate(self.shard_devices)]
            for out in self._count_shards(b, shards):
                out.cpu()
            done += 1
        return done

    def decrement_window_counts(self, per_window_edges, per_window_deletes,
                                prior_counts, *, delta_frac: float = 0.25
                                ) -> np.ndarray:
        """Late deletions in already-counted windows (sliding mode's
        decremental path): from each window's distinct edge set, the edges
        retracted from it and its prior exact count, the updated exact
        counts.

        :func:`route_decrement` picks each window's route: ``"delta"``
        subtracts :func:`butterfly_delta_np` from the prior count on the
        host; ``"recount"`` drops the deleted edges and recounts every
        recount-routed window's survivors in ONE bucketed dispatch through
        :meth:`window_counts` (K1 on the ``pallas`` tier).  Both routes
        raise on a deletion of an edge absent from its window, the same
        edge twice included."""
        if self.tier == "sampled":
            raise NotImplementedError(
                "sampled tier cannot decrement prior counts: a subsampled "
                "estimate has no per-edge ledger to patch and recounting "
                "survivors would redraw the coins; use an exact tier for "
                "streams with deletions")
        prior = np.asarray(prior_counts, dtype=np.float64)
        n = len(per_window_edges)
        if len(per_window_deletes) != n or prior.shape[0] != n:
            raise ValueError(
                "per_window_edges, per_window_deletes and prior_counts must "
                f"align: got {n}, {len(per_window_deletes)}, "
                f"{prior.shape[0]}")
        out = prior.copy()
        recount_edges: list[np.ndarray] = []
        recount_idx: list[int] = []
        for k in range(n):
            e = np.asarray(per_window_edges[k], dtype=np.int64).reshape(-1, 2)
            d = np.asarray(per_window_deletes[k],
                           dtype=np.int64).reshape(-1, 2)
            if d.shape[0] == 0:
                continue
            if route_decrement(e.shape[0], d.shape[0],
                               delta_frac=delta_frac) == "delta":
                out[k] = prior[k] - butterfly_delta_np(e, d)
                continue
            _check_id_range_np(e)
            _check_id_range_np(d)
            ke = e[:, 0] << 32 | e[:, 1]
            kd = d[:, 0] << 32 | d[:, 1]
            if (np.unique(kd).shape[0] != kd.shape[0]
                    or not np.isin(kd, ke).all()):
                raise ValueError(
                    f"window {k}: cannot delete an edge absent from the "
                    "window (never inserted, or already deleted)")
            recount_edges.append(e[~np.isin(ke, kd)])
            recount_idx.append(k)
        if recount_idx:
            m = len(recount_idx)
            nb = pack_windows(
                recount_edges, n_sgrs=np.zeros(m, np.int64),
                cum_sgrs=np.zeros(m, np.int64),
                window_end_tau=np.zeros(m, np.float64),
                align=self.align, dedupe=True)
            out[np.asarray(recount_idx)] = self.window_counts(nb)
        return out

    def count_edges(self, edge_i, edge_j) -> float:
        """Count one online window from raw, possibly duplicated, edge ids
        of any int64 range.  Relabels to a compact id space (before the tier
        branch, so every tier takes the same ids), picks the window's
        bucket and dispatches it as a batch of one (on ``pallas``: K1 on a
        ``[1, cap_i, cap_j]`` uint8 stack) through the memoized counter of
        its configuration, so a run of same-rung windows reuses one.  On
        ``sampled`` each call draws its own coins: a per-executor sequence
        number is the window's uid."""
        ei = np.asarray(edge_i, dtype=np.int64)
        ej = np.asarray(edge_j, dtype=np.int64)
        if ei.size == 0:
            return 0.0
        ui, inv_i = np.unique(ei, return_inverse=True)
        uj, inv_j = np.unique(ej, return_inverse=True)
        if self.tier == "numpy":
            return float(count_butterflies_np(np.stack([inv_i, inv_j],
                                                       axis=1)))
        cap_e = bucket_capacity(len(ei), align=self.align, growth=self.growth)
        cap_i = id_capacity(len(ui), align=self.align)
        cap_j = id_capacity(len(uj), align=self.align)
        cap_w = 0
        if self.tier in _WEDGE_TIERS:
            d = np.bincount(
                np.unique(inv_i * (len(uj) + 1) + inv_j) % (len(uj) + 1))
            cap_w = bucket_capacity(int((d * (d - 1) // 2).sum()),
                                    align=self.align, growth=self.growth)
        b = Bucket(cap_e, cap_i, cap_j, np.arange(1, dtype=np.int64),
                   cap_w=cap_w)
        dev = self.device
        pi = torch.zeros((1, cap_e), dtype=torch.int32)
        pj = torch.zeros((1, cap_e), dtype=torch.int32)
        pv = torch.zeros((1, cap_e), dtype=torch.bool)
        pi[0, :len(ei)] = torch.from_numpy(inv_i.astype(np.int32))
        pj[0, :len(ej)] = torch.from_numpy(inv_j.astype(np.int32))
        pv[0, :len(ei)] = True
        lanes = [pi.to(dev), pj.to(dev)]
        if self.tier == "sampled":
            uid = self._online_seq
            self._online_seq += 1
            if self.bucket_tier(b) == "sampled":
                lanes.append(torch.tensor(
                    [[(uid >> 32) & 0xFFFFFFFF, uid & 0xFFFFFFFF]],
                    dtype=torch.int64, device=dev))
        lanes.append(pv.to(dev))
        out, = self._count_shards(b, [tuple(lanes)], devices=(dev,))
        return float(out[0])

    # -- the single entry point ---------------------------------------------

    def run(self, batch: WindowBatch, *, mode: str = "tumbling",
            span: int = 1) -> ExecutorResult:
        """Count every window of ``batch`` through the configured tier.
        ``mode="tumbling"`` gives the paper's disjoint pane counts;
        ``mode="sliding"`` the counts of windows spanning ``span`` panes, by
        prefix difference.  Sliding mode refuses a multi-stream batch
        before any dispatch: a prefix over panes of different tenants would
        mix their counts."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "sliding":
            if span < 1:
                raise ValueError("sliding span must be >= 1")
            if batch.stream_ids is not None and len(
                    np.unique(batch.stream_ids)) > 1:
                raise ValueError(
                    "sliding mode over a multi-stream batch is ambiguous; "
                    "slide each tenant's panes separately")
        counts = self.window_counts(batch)
        cum = np.asarray(batch.cum_sgrs, dtype=np.float64)
        if mode == "tumbling":
            return ExecutorResult(counts, cum, self.tier, mode,
                                  n_shards=self.n_shards,
                                  stream_ids=batch.stream_ids)
        prefix = np.concatenate([[0.0], np.cumsum(counts)])
        lo = np.maximum(np.arange(len(counts)) - span + 1, 0)
        sliding = prefix[1:] - prefix[lo]
        return ExecutorResult(sliding, cum, self.tier, mode, span,
                              n_shards=self.n_shards,
                              stream_ids=batch.stream_ids)


def run(batch: WindowBatch, *, tier: str = "dense", mode: str = "tumbling",
        span: int = 1, **kwargs) -> ExecutorResult:
    """One-shot convenience: ``WindowExecutor(tier, **kwargs).run(batch,
    mode=mode, span=span)``."""
    return WindowExecutor(tier, **kwargs).run(batch, mode=mode, span=span)
