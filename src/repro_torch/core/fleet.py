"""FLEET baselines and the sampled tier's coins (the port's copy of
``repro.core.fleet``).

FLEET (Sanei-Mehri et al., CIKM 2019) keeps a reservoir R of capacity M.
Each arriving edge is admitted with probability p (initially 1); when |R|
exceeds M every reservoir edge is retained with probability gamma and
p <- p * gamma, so all reservoir edges are present independently with the
current p.  FLEET1 recounts the reservoir at every sub-sampling round,
FLEET2 adds ``incident(e, R) / p**4`` per admitted edge, FLEET3 adds
``incident(e, R) / p**3`` per arriving edge.  :class:`FleetState`,
:func:`fleet_run` and :func:`fleet_run_chunked` are those sequential
per-edge algorithms, host numpy and Python, copied from the reference: they
draw numpy coins, so the same seed gives the reference's estimates.

**The device reservoir** (:class:`ReservoirState`, :func:`reservoir_run`)
is the vectorized FLEET-3 gamma schedule behind the executor's ``sampled``
tier.  Each edge owns one content-keyed uniform
``u(e) = U(fold_in(fold_in(key, i), j))``; the admission probability is the
gamma ladder ``p = gamma**k``; a chunk subsamples in one shot, advancing
``k`` to the smallest rung whose ``p`` keeps at most M edges strictly below
it.  Because ``u`` depends only on the edge and the seed, any chunking of a
stream gives the same reservoir.

**The coins are jax's coins.**  :func:`prng_key`, :func:`fold_in` and
:func:`uniform_bits` reproduce ``jax.random.PRNGKey``, ``fold_in`` and the
32-bit draw of ``jax.random.uniform`` for a scalar key: threefry2x32 with
20 rounds, on int64 tensors masked to 32 bits (torch's ``uint32`` lacks
shifts and products on some backends).  The draw is the *partitionable*
one (``o1 ^ o2`` of ``threefry2x32(key, (0, 0))``), which jax takes by
default since 0.5; under ``jax_threefry_partitionable=False`` jax draws
``o1`` instead and the coins differ.

**The ladder's powers are a table.**  ``gamma**k`` in float32 comes from
one host table per gamma (:func:`gamma_powers`, float64 powers rounded
once to float32), looked up on the device, so the card and the CPU pick
the same ``p`` for the same ``t``; the rung search mirrors the
reference's (an analytic rung from float32 ``log``, probed one rung below
and two above).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["FleetState", "fleet_run", "fleet_run_chunked",
           "ReservoirState", "reservoir_init", "reservoir_ingest",
           "reservoir_run", "edge_uniforms", "subsample_cutoff",
           "gamma_ladder", "sample_keep_mask", "check_sampling_knobs",
           "prng_key", "fold_in", "uniform_bits", "threefry2x32",
           "gamma_powers"]


def check_sampling_knobs(capacity, gamma, seed) -> None:
    """Reject bad sampling knobs loudly *before any state exists or
    mutates*.  ``capacity`` must be a positive int (bools are ints in
    Python — rejected), ``gamma`` must lie strictly inside (0, 1), and
    ``seed`` must be an int (a float seed would silently truncate)."""
    if isinstance(capacity, bool) or not isinstance(
            capacity, (int, np.integer)):
        raise ValueError(f"capacity must be an int, got {capacity!r}")
    if int(capacity) <= 0:
        raise ValueError(f"capacity must be positive, got {int(capacity)}")
    if not (0.0 < float(gamma) < 1.0):
        raise ValueError(
            f"gamma must lie strictly in (0, 1), got {float(gamma)}")
    if isinstance(seed, bool) or not isinstance(seed, (int, np.integer)):
        raise ValueError(f"seed must be an int, got {seed!r}")


# ---------------------------------------------------------------------------
# FLEET1-3: sequential host baselines (the reference's code)
# ---------------------------------------------------------------------------

@dataclass
class FleetState:
    variant: int                      # 1, 2 or 3
    capacity: int                     # M
    gamma: float
    seed: int = 0
    p: float = 1.0
    estimate: float = 0.0
    adj_i: dict = field(default_factory=dict)   # i -> set(j)
    adj_j: dict = field(default_factory=dict)   # j -> set(i)
    n_edges: int = 0
    rng: np.random.Generator = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.variant not in (1, 2, 3):
            raise ValueError(f"variant must be 1, 2 or 3, got {self.variant!r}")
        check_sampling_knobs(self.capacity, self.gamma, self.seed)
        self.rng = np.random.default_rng(self.seed)

    # -- reservoir graph ops ------------------------------------------------
    def _incident_butterflies(self, i: int, j: int) -> int:
        """#butterflies the edge (i, j) completes against the reservoir."""
        ni = self.adj_i.get(i)
        nj = self.adj_j.get(j)
        if not ni or not nj:
            return 0
        total = 0
        for i2 in nj:
            if i2 == i:
                continue
            n2 = self.adj_i.get(i2)
            if not n2:
                continue
            common = ni & n2
            total += len(common) - (1 if j in common else 0)
        return total

    def _insert(self, i: int, j: int) -> None:
        self.adj_i.setdefault(i, set()).add(j)
        self.adj_j.setdefault(j, set()).add(i)
        self.n_edges += 1

    def _contains(self, i: int, j: int) -> bool:
        s = self.adj_i.get(i)
        return bool(s) and j in s

    def _subsample(self) -> None:
        edges = [(i, j) for i, js in self.adj_i.items() for j in js]
        keep = self.rng.random(len(edges)) < self.gamma
        self.adj_i.clear()
        self.adj_j.clear()
        self.n_edges = 0
        for (i, j), k in zip(edges, keep):
            if k:
                self._insert(i, j)
        self.p *= self.gamma

    def _exact_count(self) -> int:
        """Exact butterflies in the reservoir via wedge aggregation."""
        from .butterfly import count_butterflies_np

        edges = np.array(
            [(i, j) for i, js in self.adj_i.items() for j in js], dtype=np.int64
        ).reshape(-1, 2)
        return count_butterflies_np(edges)

    # -- stream ingestion ----------------------------------------------------
    def ingest(self, i: int, j: int) -> None:
        if self._contains(i, j):
            return  # duplicate edges ignored (paper SS2.1 semantics)
        if self.variant == 3:
            self.estimate += self._incident_butterflies(i, j) / self.p**3
        admitted = self.rng.random() < self.p
        if admitted:
            if self.variant == 2:
                self.estimate += self._incident_butterflies(i, j) / self.p**4
            self._insert(i, j)
            if self.n_edges > self.capacity:
                self._subsample()
                if self.variant == 1:
                    self.estimate = self._exact_count() / self.p**4


def fleet_run(
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    *,
    variant: int,
    capacity: int,
    gamma: float = 0.7,
    seed: int = 0,
    checkpoints: np.ndarray | None = None,
) -> tuple[np.ndarray, FleetState]:
    """Run FLEET over a stream; return estimates at ``checkpoints`` (sgr
    indices, exclusive) and the final state.  FLEET1 reports an exact
    reservoir recount at each checkpoint."""
    st = FleetState(variant=variant, capacity=capacity, gamma=gamma, seed=seed)
    cps = np.asarray(checkpoints if checkpoints is not None else [len(edge_i)])
    out = np.zeros(len(cps), dtype=np.float64)
    ci = 0
    for t in range(len(edge_i)):
        while ci < len(cps) and cps[ci] == t:
            out[ci] = st._exact_count() / st.p**4 if variant == 1 else st.estimate
            ci += 1
        st.ingest(int(edge_i[t]), int(edge_j[t]))
    while ci < len(cps):
        out[ci] = st._exact_count() / st.p**4 if variant == 1 else st.estimate
        ci += 1
    return out, st


def fleet_run_chunked(
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    *,
    variant: int,
    capacity: int,
    gamma: float = 0.7,
    seed: int = 0,
    chunk: int = 4096,
) -> float:
    """Throughput-oriented FLEET: admission coins drawn per chunk of
    ``chunk`` arrivals (statistically equivalent admissions; incident
    counting stays per edge, FLEET's actual cost model)."""
    st = FleetState(variant=variant, capacity=capacity, gamma=gamma, seed=seed)
    n = len(edge_i)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        coins = st.rng.random(e - s)
        for k in range(e - s):
            i, j = int(edge_i[s + k]), int(edge_j[s + k])
            if st._contains(i, j):
                continue
            if st.variant == 3:
                st.estimate += st._incident_butterflies(i, j) / st.p**3
            if coins[k] < st.p:
                if st.variant == 2:
                    st.estimate += st._incident_butterflies(i, j) / st.p**4
                st._insert(i, j)
                if st.n_edges > st.capacity:
                    st._subsample()
                    if st.variant == 1:
                        st.estimate = st._exact_count() / st.p**4
    return st.estimate if variant != 1 else st._exact_count() / st.p**4


# ---------------------------------------------------------------------------
# jax's threefry2x32 coins in torch integer ops
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block cipher, 20 rounds, as jax's
    ``_threefry2x32_lowering``: key ``(k1, k2)`` and counts ``(x1, x2)``
    are int64 tensors (or ints) holding uint32 values, broadcast together;
    returns the two uint32 output words as int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``a`` and ``b`` name one device (``cuda`` is the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or (a.index is not None and b.index is not None):
        return a.index == b.index
    return (a.index if a.index is not None else b.index) \
        == torch.cuda.current_device()


def _u32(x, device: torch.device) -> torch.Tensor:
    """``x`` as uint32 values in an int64 tensor on ``device``.  A tensor
    must already lie there: the coins never move lanes between devices.
    Host values (ints, numpy arrays) are placed on ``device``."""
    if isinstance(x, torch.Tensor):
        if not _same_device(x.device, device):
            raise ValueError(f"data lies on {x.device} but the key on "
                             f"{device}: put both on one device")
        return x.to(torch.int64) & _M32
    if isinstance(x, (int, np.integer)):
        return torch.full((), int(x) & _M32, dtype=torch.int64,
                          device=device)
    return torch.as_tensor(np.asarray(x, dtype=np.int64) & _M32,
                           device=device)


def prng_key(seed: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.PRNGKey(seed)`` as two 0-d int64 tensors ``(hi, lo)``
    on ``device`` (the card unless the caller passes ``device="cpu"``):
    the seed's low 32 bits, and its high 32 bits where it has them (0 for
    a negative seed, as jax's logical shift of a 32-bit seed gives)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    seed = int(seed)
    hi = (seed >> 32) & _M32 if seed >= 0 else 0
    return (torch.full((), hi, dtype=torch.int64, device=dev),
            torch.full((), seed & _M32, dtype=torch.int64, device=dev))


def fold_in(key: tuple, data) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in(key, data)`` elementwise: ``data`` (cast to
    uint32 as jax casts it) becomes the counts ``(0, data)`` of one
    threefry2x32 block under ``key``, whose two words are the new key.
    A ``data`` tensor must lie on the key's device: this raises
    otherwise."""
    k1, k2 = key
    if not _same_device(k1.device, k2.device):
        raise ValueError(f"key halves lie on {k1.device} and {k2.device}")
    d = _u32(data, k1.device)
    return threefry2x32(k1, k2, torch.zeros_like(d), d)


def uniform_bits(key: tuple) -> torch.Tensor:
    """The 32 random bits of ``jax.random.uniform(key, (), float32)`` under
    the partitionable draw: ``o1 ^ o2`` of ``threefry2x32(key, (0, 0))``."""
    k1, k2 = key
    z = torch.zeros_like(torch.broadcast_tensors(k1, k2)[0])
    o1, o2 = threefry2x32(k1, k2, z, z)
    return o1 ^ o2


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """jax's float32 uniform in [0, 1) from 32 random bits: the top 23
    bits as the mantissa of a number in [1, 2), less 1 (exact)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def edge_uniforms(key: tuple, edge_i: torch.Tensor,
                  edge_j: torch.Tensor) -> torch.Tensor:
    """Per-edge content-keyed float32 uniforms in [0, 1): fold the edge
    endpoints into ``key`` (0-d, or broadcastable over the lanes, as one
    key per window) and draw one uniform per lane.  Duplicate edges share
    their uniform."""
    k = fold_in(fold_in(key, edge_i), edge_j)
    return _bits_to_unit(uniform_bits(k))


def subsample_cutoff(u: torch.Tensor, valid: torch.Tensor,
                     capacity: int) -> torch.Tensor:
    """Per row of ``u`` (``[..., n]``): the (capacity+1)-th smallest valid
    uniform, or +inf when the row cannot hold more than ``capacity`` lanes.
    Any p <= cutoff keeps at most ``capacity`` lanes strictly below p."""
    if u.shape[-1] <= capacity:         # statically cannot overflow
        return torch.full(u.shape[:-1], float("inf"), dtype=torch.float32,
                          device=u.device)
    masked = torch.where(valid, u, torch.full_like(u, float("inf")))
    return torch.sort(masked, dim=-1).values[..., capacity]


# ladder rung used when even p=0 is needed (pathological t=0); gamma**_K_MAX
# is 0 in float32, so the keep mask goes empty and the inverse scale is 0
_K_MAX = 1_000_000


@functools.lru_cache(maxsize=None)
def _power_table(gamma: float) -> np.ndarray:
    g = np.float64(np.float32(gamma))
    # past this rung gamma**k is below half the smallest float32 subnormal
    n = int(np.ceil(-150.0 * np.log(2.0) / np.log(g))) + 2
    powers = (g ** np.arange(n, dtype=np.float64)).astype(np.float32)
    # flush subnormal powers to 0, as XLA does on the CPU and the TPU
    powers[powers < np.finfo(np.float32).tiny] = 0
    return powers[:int(np.argmax(powers == 0)) + 1]


@functools.lru_cache(maxsize=None)
def _ladder_consts(gamma: float, device: torch.device) -> tuple:
    """The ladder's device constants, copied or computed once per (gamma,
    device): the power table, ``log(float32(gamma))`` by the device's own
    float32 ``log``, and the probe offsets -1..2."""
    table = torch.from_numpy(_power_table(gamma)).to(device)
    g = torch.full((), float(np.float32(gamma)), dtype=torch.float32,
                   device=device)
    offs = torch.arange(-1.0, 3.0, dtype=torch.float32, device=device)
    return table, torch.log(g), offs


def gamma_powers(gamma: float, device=None) -> torch.Tensor:
    """``float32(gamma)**k`` for k = 0, 1, ... up to the first rung that
    is 0 in float32, on ``device`` (the card unless the caller passes
    ``device="cpu"``): float64 powers of the float32 gamma, each rounded
    once to float32, with subnormal powers flushed to 0 (on the host, so
    every device reads the same table).  Rungs past the table are 0."""
    from ..device import resolve_device

    return _ladder_consts(float(gamma), resolve_device(device))[0]


def _rung_powers(ks: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``gamma**ks`` for integer-valued float32 rungs: the table's entry,
    or 0 past its end."""
    idx = ks.to(torch.int64)
    inside = idx < table.shape[0]
    vals = table[torch.clamp(idx, max=table.shape[0] - 1)]
    return torch.where(inside, vals, torch.zeros_like(vals))


def gamma_ladder(t: torch.Tensor, gamma: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest integer rung k >= 0 with ``gamma**k <= t`` in float32,
    elementwise over ``t``.  Returns ``(k, p)`` (int32, float32) with
    ``p = gamma**k``; ``t >= 1`` (+inf included) gives ``(0, 1.0)`` and
    ``t = 0`` gives ``(_K_MAX, 0.0)``, as the reference.  The analytic rung
    ``ceil(log t / log gamma)`` is probed one rung below and two above, and
    the powers come from :func:`gamma_powers`.  ``t`` is a tensor, and the
    ladder runs on its device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"t must be a torch tensor, got {type(t).__name__}")
    t = t.to(torch.float32)
    table, log_g, offs = _ladder_consts(float(gamma), t.device)
    raw = torch.log(t) / log_g                     # +inf -> -inf, 0 -> +inf
    k0 = torch.ceil(raw)
    ks = torch.clamp(k0.unsqueeze(-1) + offs, 0.0, float(_K_MAX))
    pvals = _rung_powers(ks, table)               # non-increasing in k
    ok = pvals <= t.unsqueeze(-1)
    idx = torch.argmax(ok.to(torch.int8), dim=-1, keepdim=True)
    any_ok = ok.any(dim=-1)
    k = torch.where(any_ok, torch.gather(ks, -1, idx).squeeze(-1),
                    torch.full_like(t, float(_K_MAX))).to(torch.int32)
    p = torch.where(any_ok, torch.gather(pvals, -1, idx).squeeze(-1),
                    torch.zeros_like(t))
    return k, p


def window_keys(uid_hi, uid_lo, seed: int, device=None) -> tuple:
    """Each window's sampling key ``fold_in(fold_in(PRNGKey(seed), uid_hi),
    uid_lo)`` from its uid halves (any shape), on ``device`` (the card
    unless the caller passes ``device="cpu"``); uid tensors must lie there
    already."""
    base = prng_key(seed, device)
    return fold_in(fold_in(base, uid_hi), uid_lo)


def sample_keep_mask(edge_i: torch.Tensor, edge_j: torch.Tensor,
                     valid: torch.Tensor, uid_hi, uid_lo, *, capacity: int,
                     gamma: float, seed: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-shot subsample-and-scale mask for padded windows (``[cap_e]``
    lanes with scalar uid halves, or ``[B, cap_e]`` with ``[B]`` halves):
    ``(keep, p)`` with at most ``capacity`` lanes kept per window and every
    valid lane kept independently with probability exactly
    ``p = gamma**k``.  ``uid_hi`` / ``uid_lo`` are the uint32 halves of the
    window's sampling uid."""
    dev = edge_i.device
    k1, k2 = window_keys(uid_hi, uid_lo, seed, dev)
    key = (k1.unsqueeze(-1), k2.unsqueeze(-1)) if edge_i.dim() > k1.dim() \
        else (k1, k2)
    u = edge_uniforms(key, edge_i, edge_j)
    t = subsample_cutoff(u, valid, capacity)
    _, p = gamma_ladder(t, gamma)
    keep = valid & (u < p.unsqueeze(-1))
    return keep, p


# ---------------------------------------------------------------------------
# the device reservoir
# ---------------------------------------------------------------------------

@dataclass
class ReservoirState:
    """Static-capacity FLEET reservoir of fixed-shape device tensors.

    Lanes hold (edge_i, edge_j, u) with a validity mask; ``k`` is the gamma
    rung, so the admission probability is always ``gamma**k`` from the
    integer rung.  Invariant: the valid lanes are exactly the *distinct*
    ingested edges with ``u < gamma**k``, at most ``capacity`` of them."""
    edge_i: torch.Tensor   # int32 [capacity]
    edge_j: torch.Tensor   # int32 [capacity]
    u: torch.Tensor        # float32 [capacity]; +inf on invalid lanes
    valid: torch.Tensor    # bool [capacity]
    k: torch.Tensor        # int32 scalar gamma rung

    @property
    def capacity(self) -> int:
        return int(self.edge_i.shape[0])


def reservoir_init(capacity: int, device=None) -> ReservoirState:
    from ..device import resolve_device

    check_sampling_knobs(capacity, 0.5, 0)
    dev = resolve_device(device)
    return ReservoirState(
        edge_i=torch.zeros(capacity, dtype=torch.int32, device=dev),
        edge_j=torch.zeros(capacity, dtype=torch.int32, device=dev),
        u=torch.full((capacity,), float("inf"), dtype=torch.float32,
                     device=dev),
        valid=torch.zeros(capacity, dtype=torch.bool, device=dev),
        k=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _stable_lexsort(keys) -> torch.Tensor:
    """``np.lexsort`` order (last key primary) from stable sorts."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def reservoir_ingest(res: ReservoirState, edge_i: torch.Tensor,
                     edge_j: torch.Tensor, valid: torch.Tensor,
                     u: torch.Tensor, *, gamma: float,
                     dedupe: bool = True) -> ReservoirState:
    """Ingest one padded chunk: admission-filter at the current rung, merge
    with the resident lanes, advance the rung just far enough that at most
    ``capacity`` lanes survive, and compact survivors to the front.

    The rung never decreases (``max(k, ladder(t))``): un-advancing it would
    re-admit edges whose coins were already spent.  With ``dedupe`` the
    merged lanes keep one lane per distinct ``(i, j)`` (duplicates share
    their ``u``); ``dedupe=False`` is for callers whose lanes are distinct
    across the whole stream.  Every sort is stable, as jax's, so ties
    resolve as in the reference."""
    capacity = res.capacity
    table = _ladder_consts(float(gamma), u.device)[0]
    inf = float("inf")
    p_cur = _rung_powers(res.k.to(torch.float32), table)
    v = valid & (u < p_cur)

    mi = torch.cat([res.edge_i, edge_i.to(torch.int32)])
    mj = torch.cat([res.edge_j, edge_j.to(torch.int32)])
    mu = torch.cat([res.u, torch.where(v, u, inf)])
    mv = torch.cat([res.valid, v])

    if dedupe:
        order_d = _stable_lexsort((mj, mi, ~mv))
        si, sj, sv = mi[order_d], mj[order_d], mv[order_d]
        dup_sorted = torch.cat([
            torch.zeros(1, dtype=torch.bool, device=mv.device),
            (si[1:] == si[:-1]) & (sj[1:] == sj[:-1]) & sv[1:] & sv[:-1]])
        dup = torch.zeros_like(mv)
        dup[order_d] = dup_sorted
        mv = mv & ~dup
        mu = torch.where(mv, mu, inf)

    # one stable argsort serves the cutoff and the compaction: invalid lanes
    # carry u = +inf and sink to the tail
    s_mu, order = torch.sort(mu, stable=True)
    t = s_mu[capacity] if s_mu.shape[0] > capacity \
        else torch.full((), inf, device=u.device)
    k_new, _ = gamma_ladder(t, gamma)
    k_new = torch.maximum(res.k, k_new)
    p_new = _rung_powers(k_new.to(torch.float32), table)
    top = order[:capacity]
    u_top = s_mu[:capacity]
    keep = u_top < p_new
    return ReservoirState(
        edge_i=mi[top],
        edge_j=mj[top],
        u=torch.where(keep, u_top, inf),
        valid=keep,
        k=k_new,
    )


def reservoir_run(
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    *,
    capacity: int,
    gamma: float = 0.7,
    seed: int = 0,
    chunk: int = 8192,
    device=None,
) -> tuple[float, ReservoirState]:
    """FLEET butterfly estimate of a whole stream through the device
    reservoir: a loop of :func:`reservoir_ingest` over ``chunk``-sized
    slabs (the reference's ``lax.scan``), then an exact host count of the
    surviving edges scaled by ``p**-4``.  Returns ``(estimate,
    final_state)``.  The estimate does not depend on ``chunk``."""
    from ..device import resolve_device
    from .butterfly import count_butterflies_np

    check_sampling_knobs(capacity, gamma, seed)
    if isinstance(chunk, bool) or not isinstance(chunk, (int, np.integer)) \
            or int(chunk) <= 0:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    edge_i = np.asarray(edge_i).ravel()
    edge_j = np.asarray(edge_j).ravel()
    if edge_i.shape != edge_j.shape:
        raise ValueError("edge_i and edge_j must have the same length")
    dev = resolve_device(device)
    res = reservoir_init(capacity, dev)
    if len(edge_i):
        # repeat arrivals share the original's coin and never change the
        # reservoir, so only first occurrences are fed (dedupe=False)
        ei, ej = edge_i, edge_j
        if not (np.issubdtype(ei.dtype, np.integer)
                and np.issubdtype(ej.dtype, np.integer)
                and ei.min() >= 0 and ej.min() >= 0
                and ei.max() < 2**32 and ej.max() < 2**32):
            _, ei = np.unique(ei, return_inverse=True)
            _, ej = np.unique(ej, return_inverse=True)
        pk = (ei.astype(np.uint64) << np.uint64(32)) | ej.astype(np.uint64)
        _, first = np.unique(pk, return_index=True)
        first.sort()
        # compact the distinct set so lanes fit int32
        _, ci = np.unique(ei[first], return_inverse=True)
        _, cj = np.unique(ej[first], return_inverse=True)
        n = len(first)
        chunk = int(chunk)
        n_chunks = -(-n // chunk)
        pad = n_chunks * chunk - n
        lane_i = torch.from_numpy(np.concatenate(
            [ci.astype(np.int32), np.zeros(pad, np.int32)])).to(dev)
        lane_j = torch.from_numpy(np.concatenate(
            [cj.astype(np.int32), np.zeros(pad, np.int32)])).to(dev)
        lane_v = torch.from_numpy(np.concatenate(
            [np.ones(n, bool), np.zeros(pad, bool)])).to(dev)
        key = prng_key(int(seed), dev)
        for c in range(n_chunks):
            s = slice(c * chunk, (c + 1) * chunk)
            u = edge_uniforms(key, lane_i[s], lane_j[s])
            res = reservoir_ingest(res, lane_i[s], lane_j[s], lane_v[s], u,
                                   gamma=float(gamma), dedupe=False)
    valid = res.valid.cpu().numpy()
    survivors = np.stack(
        [res.edge_i.cpu().numpy()[valid], res.edge_j.cpu().numpy()[valid]],
        axis=1).astype(np.int64)
    count = count_butterflies_np(survivors)
    p = float(gamma) ** int(res.k)
    estimate = float(count) / p**4 if p > 0.0 else 0.0
    return estimate, res
