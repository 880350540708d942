"""Synthetic bipartite temporal graph generators (paper SS3.1).

The paper builds BA-bipartite baselines by (1) generating a unipartite
Barabasi-Albert graph whose average i-degree and |E| match a target real
graph, (2) projecting to bipartite mode by treating directed-edge sources as
i-vertices and destinations as j-vertices (the "simple projection" that
preserves |E| and scale-freeness), and (3) assigning timestamps either
uniformly at random over the real range ("BA+random stamps") or by permuting
the real graph's timestamps onto arbitrary edges ("BA+real stamps").

Real KONECT datasets are not shipped offline; `synthetic_rating_stream`
produces rating-graph-like streams (power-law item popularity, bursts of user
activity, configurable temporal distribution) whose ground truth we compute
exactly — these drive the SS5 reproduction benches.
"""
from __future__ import annotations

import numpy as np

from .stream import SgrStream
from .wire import as_columns

__all__ = ["ba_unipartite_edges", "ba_bipartite_stream", "assign_timestamps",
           "synthetic_rating_stream", "bipartite_pa_stream",
           "dynamic_sgr_stream"]


def ba_unipartite_edges(n: int, m: int, *, m0: int | None = None, seed: int = 0) -> np.ndarray:
    """Directed BA preferential-attachment edge list ((source=new, dest=old)).

    Starts from a complete graph on m0 vertices, then attaches each new vertex
    to ``m`` existing vertices with probability proportional to degree
    (repeated-nodes implementation, no per-step renormalization loop).
    """
    m0 = m if m0 is None else m0
    if m > m0:
        raise ValueError("m must be <= m0")
    rng = np.random.default_rng(seed)
    src, dst = [], []
    # initial complete graph on m0 vertices
    for u in range(m0):
        for v in range(u + 1, m0):
            src.append(u)
            dst.append(v)
    # degree-proportional target pool (each edge endpoint appears once)
    pool = src + dst
    for u in range(m0, n):
        targets: set[int] = set()
        while len(targets) < m:
            t = pool[rng.integers(len(pool))]
            targets.add(int(t))
        for t in targets:
            src.append(u)
            dst.append(t)
            pool.extend([u, t])
    return np.stack([np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64)], axis=1)


def assign_timestamps(
    n_edges: int,
    *,
    mode: str = "random",
    real_tau: np.ndarray | None = None,
    t_range: tuple[float, float] = (0.0, 1.0e6),
    n_unique: int | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Timestamp assignment (paper SS3.1 step 3).

    mode="random": uniform over ``t_range`` (BA+random stamps), optionally
    quantized to ``n_unique`` distinct values.
    mode="real":   permutation of ``real_tau`` onto edges (BA+real stamps) —
    guarantees identical temporal distribution to the reference stream.
    """
    rng = np.random.default_rng(seed)
    if mode == "real":
        if real_tau is None:
            raise ValueError("mode='real' requires real_tau")
        tau = rng.permutation(np.asarray(real_tau, dtype=np.float64))[:n_edges]
        if tau.shape[0] < n_edges:
            tau = np.r_[tau, rng.choice(real_tau, n_edges - tau.shape[0])]
        return tau
    lo, hi = t_range
    tau = rng.uniform(lo, hi, size=n_edges)
    if n_unique is not None:
        grid = np.sort(rng.uniform(lo, hi, size=n_unique))
        tau = grid[rng.integers(0, n_unique, size=n_edges)]
    return tau


def ba_bipartite_stream(
    *,
    n: int,
    m: int,
    mode: str = "random",
    real_tau: np.ndarray | None = None,
    t_range: tuple[float, float] = (0.0, 1.0e6),
    n_unique: int | None = None,
    seed: int = 0,
) -> SgrStream:
    """BA + simple projection + timestamps => time-ordered bipartite stream.

    Sources of directed BA edges become i-vertices, destinations j-vertices
    (paper's |E|-preserving projection; j-degree distribution stays
    scale-free).
    """
    e = ba_unipartite_edges(n, m, seed=seed)
    tau = assign_timestamps(
        e.shape[0], mode=mode, real_tau=real_tau, t_range=t_range,
        n_unique=n_unique, seed=seed + 1,
    )
    return SgrStream(tau, e[:, 0], e[:, 1])


def bipartite_pa_stream(
    n_edges: int,
    *,
    new_user_p: float = 0.15,
    new_item_p: float = 0.10,
    temporal: str = "uniform",
    n_unique: int | None = None,
    burst_factor: float = 8.0,
    seed: int = 0,
) -> SgrStream:
    """Bipartite preferential attachment — the rating-graph work-alike.

    Each sgr either introduces a new user/item (prob ``new_*_p``) or reuses an
    existing one proportionally to its past activity (rich-get-richer on both
    sides).  This produces the old-hub-dominated, bursty butterfly emergence
    the paper measures on Epinions/MovieLens (SS3.3) and is the stream family
    on which sGrapp's MAPE matches the paper's reported regime.
    """
    rng = np.random.default_rng(seed)
    eu = np.zeros(n_edges, dtype=np.int64)
    ei = np.zeros(n_edges, dtype=np.int64)
    n_u, n_i = 1, 1
    coins = rng.random((n_edges, 2))
    picks = rng.integers(0, n_edges, size=(n_edges, 2))
    for t in range(1, n_edges):
        if coins[t, 0] < new_user_p:
            eu[t] = n_u
            n_u += 1
        else:
            eu[t] = eu[picks[t, 0] % t]
        if coins[t, 1] < new_item_p:
            ei[t] = n_i
            n_i += 1
        else:
            ei[t] = ei[picks[t, 1] % t]

    if temporal == "uniform":
        tau = np.sort(rng.uniform(0, 1e6, n_edges))
    elif temporal == "bursty":
        gaps = rng.exponential(1.0, size=n_edges)
        burst = rng.random(n_edges) < 0.05
        gaps = np.where(burst, gaps * burst_factor, gaps * 0.1)
        tau = np.cumsum(gaps)
    else:
        raise ValueError(f"unknown temporal mode {temporal!r}")
    if n_unique is not None:
        qs = np.quantile(tau, np.linspace(0, 1, n_unique))
        tau = qs[np.clip(np.searchsorted(qs, tau), 0, n_unique - 1)]
    return SgrStream(tau, eu, ei)


def dynamic_sgr_stream(
    n_records: int,
    nt_w: int,
    *,
    delete_frac: float = 0.1,
    dup_frac: float = 0.1,
    n_i: int = 64,
    n_j: int = 64,
    new_tau_p: float = 0.3,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Dynamic wire-format stream ``(tau, edge_i, edge_j, op)`` whose deletes
    are always valid under ``on_missing_delete="raise"``.

    The generator tracks the net multiplicity of every edge in the *open*
    window by simulating the Algorithm-3 close rule for the given ``nt_w``
    (a window closes at the ``nt_w + 1``-th unique timestamp, clearing the
    ledger — tumbling windows renew the graph), so a delete record is only
    ever emitted against an edge with net multiplicity > 0 in its own
    window.  ``delete_frac`` is the target fraction of delete records,
    ``dup_frac`` the fraction of inserts that duplicate a live edge;
    ``delete_frac=0, dup_frac=0`` degenerates to a plain insert stream.
    Timestamps advance by 1 with probability ``new_tau_p`` per record, so
    windows hold ~``nt_w / new_tau_p`` records each.
    """
    if not 0.0 <= delete_frac < 1.0:
        raise ValueError("delete_frac must be in [0, 1)")
    if not 0.0 <= dup_frac <= 1.0:
        raise ValueError("dup_frac must be in [0, 1]")
    rng = np.random.default_rng(seed)
    taus = np.zeros(n_records, dtype=np.float64)
    ei = np.zeros(n_records, dtype=np.int64)
    ej = np.zeros(n_records, dtype=np.int64)
    ops = np.zeros(n_records, dtype=np.int64)
    live: dict[tuple[int, int], int] = {}
    t, uniq, prev_tau = 0.0, 0, None
    for k in range(n_records):
        if prev_tau is not None and rng.random() < new_tau_p:
            t += 1.0
        if prev_tau is None or t != prev_tau:
            if uniq == nt_w:   # window closes; its ledger is unreachable now
                live.clear()
                uniq = 0
            uniq += 1
        prev_tau = t
        deletable = [e for e, m in live.items() if m > 0]
        if deletable and rng.random() < delete_frac:
            e = deletable[rng.integers(len(deletable))]
            live[e] -= 1
            op = 1
        else:
            if live and rng.random() < dup_frac:
                keys = list(live)
                e = keys[rng.integers(len(keys))]
            else:
                e = (int(rng.integers(0, n_i)), int(rng.integers(0, n_j)))
            live[e] = live.get(e, 0) + 1
            op = 0
        taus[k], ei[k], ej[k], ops[k] = t, e[0], e[1], op
    # canonicalize through the shared wire schema — generators return the
    # same column convention push()/the oracle consume (an op lane is always
    # materialized here so consumers can slice it uniformly)
    return as_columns(taus, ei, ej, ops)


def synthetic_rating_stream(
    *,
    n_users: int,
    n_items: int,
    n_edges: int,
    item_exponent: float = 1.2,
    user_exponent: float = 1.1,
    temporal: str = "uniform",
    n_unique: int | None = None,
    burst_factor: float = 8.0,
    seed: int = 0,
) -> SgrStream:
    """Rating-graph-like stream: Zipfian user activity and item popularity.

    temporal="uniform": timestamps uniform over [0, 1e6) — the regime where
    the paper reports sGrapp MAPE < 0.05.
    temporal="bursty":  timestamps drawn from a self-exciting mixture — the
    non-uniform regime where sGrapp-x earns its keep.
    temporal="wave":    sinusoidal-intensity arrivals (wiki-edit-like).
    """
    rng = np.random.default_rng(seed)
    # Zipf-ish discrete power laws, truncated to the universe sizes.
    users = (rng.zipf(user_exponent, size=4 * n_edges) - 1) % n_users
    items = (rng.zipf(item_exponent, size=4 * n_edges) - 1) % n_items
    # drop duplicate pairs, keep first n_edges
    key = users.astype(np.int64) << 32 | items.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    idx = np.sort(idx)[:n_edges]
    users, items = users[idx], items[idx]
    n = users.shape[0]

    if temporal == "uniform":
        tau = np.sort(rng.uniform(0, 1e6, size=n))
    elif temporal == "bursty":
        # clustered arrivals: exponential gaps with occasional heavy bursts
        gaps = rng.exponential(1.0, size=n)
        burst = rng.random(n) < 0.05
        gaps = np.where(burst, gaps * burst_factor, gaps * 0.1)
        tau = np.cumsum(gaps)
    elif temporal == "wave":
        base = np.sort(rng.uniform(0, 1e6, size=n))
        tau = base + 5e4 * np.sin(base / 5e4)
        tau = np.sort(tau - tau.min())
    else:
        raise ValueError(f"unknown temporal mode {temporal!r}")

    if n_unique is not None:
        qs = np.quantile(tau, np.linspace(0, 1, n_unique))
        tau = qs[np.clip(np.searchsorted(qs, tau), 0, n_unique - 1)]
    return SgrStream(tau, users.astype(np.int64), items.astype(np.int64))
