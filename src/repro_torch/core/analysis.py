"""Empirical analysis toolkit of paper SS3 (graph characteristics), the
port's copy of ``repro.core.analysis``.

- polynomial / power-law fits of the temporal butterfly frequency (Fig 5-6,
  Table 3) -> the *butterfly densification power law* B(t) ~ |E(t)|^eta
- hub statistics: hub membership fractions in butterflies (Tables 4-5),
  degree <-> butterfly-support Pearson correlation (Table 6), normalized hub
  connection fractions over time (Figs 9-10), young/old hub evolution
  (Figs 11-12)
- inter-arrival distribution of butterfly edge pairs (Figs 7-8)
- alpha = P(t) hub-probability exponent (Table 7 connection)

All of it is host numpy over stream prefixes (the paper caps them at about
5000 sgrs for the same computational reason), the reference's arithmetic
step for step, so both packages give equal results.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .butterfly import (
    butterfly_support_np,
    count_butterflies_np,
    enumerate_butterflies_np,
)

__all__ = [
    "butterfly_growth_curve",
    "PolyFit",
    "fit_polynomials",
    "fit_power_law",
    "hub_mask",
    "butterfly_hub_fractions",
    "degree_support_correlation",
    "hub_connection_fraction",
    "young_old_hubs",
    "interarrival_distribution",
    "hub_probability_exponent",
]


# ---------------------------------------------------------------------------
# SS3.2 -- butterfly emergence / densification power law
# ---------------------------------------------------------------------------

def butterfly_growth_curve(
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    *,
    max_edges: int = 5000,
    stride: int = 50,
) -> tuple[np.ndarray, np.ndarray]:
    """Eager-computation model of Fig 5: B(t) after each ``stride`` insertions.

    Returns (t_points, B(t)).  t is the number of sgrs applied (the paper's
    time axis for this analysis).
    """
    n = min(max_edges, len(edge_i))
    ts = np.arange(stride, n + 1, stride)
    edges = np.stack([edge_i[:n], edge_j[:n]], axis=1)
    counts = np.array([count_butterflies_np(edges[:t]) for t in ts], dtype=np.float64)
    return ts.astype(np.float64), counts


@dataclass
class PolyFit:
    degree: int
    coeffs: np.ndarray
    r2: float
    rmse: float
    increasing: bool


def fit_polynomials(x: np.ndarray, y: np.ndarray, degrees=range(1, 11)) -> list[PolyFit]:
    """Table 3: fit degree-1..10 polynomials, report R^2 / RMSE / monotonicity."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xs = x / x.max()  # condition the Vandermonde
    out = []
    for d in degrees:
        c = np.polyfit(xs, y, d)
        pred = np.polyval(c, xs)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum()) or 1.0
        r2 = 1.0 - ss_res / ss_tot
        rmse = float(np.sqrt(ss_res / len(y)))
        increasing = bool(np.all(np.diff(pred) >= -1e-9 * max(1.0, np.abs(pred).max())))
        out.append(PolyFit(d, c, r2, rmse, increasing))
    return out


def fit_power_law(edges_seen: np.ndarray, counts: np.ndarray) -> tuple[float, float, float]:
    """Fit B = c * E^eta by least squares in log-log space.

    Returns (eta, c, r2).  The densification power law claims eta > 1.
    """
    m = (np.asarray(counts) > 0) & (np.asarray(edges_seen) > 0)
    lx = np.log(np.asarray(edges_seen, dtype=np.float64)[m])
    ly = np.log(np.asarray(counts, dtype=np.float64)[m])
    if lx.size < 2:
        return float("nan"), float("nan"), float("nan")
    eta, logc = np.polyfit(lx, ly, 1)
    pred = eta * lx + logc
    ss_res = float(((ly - pred) ** 2).sum())
    ss_tot = float(((ly - ly.mean()) ** 2).sum()) or 1.0
    return float(eta), float(np.exp(logc)), 1.0 - ss_res / ss_tot


# ---------------------------------------------------------------------------
# SS3.3 -- hubs
# ---------------------------------------------------------------------------

def hub_mask(degrees: np.ndarray) -> np.ndarray:
    """Hub = vertex whose degree exceeds the average of *unique* degrees
    (the paper's definition)."""
    d = np.asarray(degrees)
    seen = d[d > 0]
    if seen.size == 0:
        return np.zeros_like(d, dtype=bool)
    thresh = np.unique(seen).mean()
    return d > thresh


def _degrees(edge_i, edge_j, n_i, n_j):
    di = np.bincount(edge_i, minlength=n_i)
    dj = np.bincount(edge_j, minlength=n_j)
    return di, dj


def butterfly_hub_fractions(
    edge_i: np.ndarray, edge_j: np.ndarray, n_i: int, n_j: int
) -> dict:
    """Tables 4 & 5: fraction of butterflies containing 0..4 hubs and
    0..2 i-hubs / j-hubs.  Edges are the (deduped) prefix snapshot."""
    edges = np.stack([edge_i, edge_j], axis=1)
    quads = enumerate_butterflies_np(edges)
    di, dj = _degrees(edge_i, edge_j, n_i, n_j)
    hi, hj = hub_mask(di), hub_mask(dj)
    if quads.shape[0] == 0:
        return {
            "n_butterflies": 0,
            "hubs_0_4": np.zeros(5),
            "i_hubs_0_2": np.zeros(3),
            "j_hubs_0_2": np.zeros(3),
        }
    n_ihub = hi[quads[:, 0]].astype(int) + hi[quads[:, 1]].astype(int)
    n_jhub = hj[quads[:, 2]].astype(int) + hj[quads[:, 3]].astype(int)
    tot = n_ihub + n_jhub
    return {
        "n_butterflies": quads.shape[0],
        "hubs_0_4": np.bincount(tot, minlength=5)[:5] / quads.shape[0],
        "i_hubs_0_2": np.bincount(n_ihub, minlength=3)[:3] / quads.shape[0],
        "j_hubs_0_2": np.bincount(n_jhub, minlength=3)[:3] / quads.shape[0],
    }


def degree_support_correlation(
    edge_i: np.ndarray, edge_j: np.ndarray, n_i: int, n_j: int
) -> tuple[float, float]:
    """Table 6: Pearson correlation of degree vs butterfly support (eq. 1)."""
    edges = np.stack([edge_i, edge_j], axis=1)
    sup_i, sup_j = butterfly_support_np(edges, n_i, n_j)
    di, dj = _degrees(edge_i, edge_j, n_i, n_j)

    def pearson(a, b):
        m = (a > 0)  # only vertices seen in the snapshot
        a, b = a[m].astype(np.float64), b[m].astype(np.float64)
        if a.size < 2 or a.std() == 0 or b.std() == 0:
            return float("nan")
        return float(np.corrcoef(a, b)[0, 1])

    return pearson(di, sup_i), pearson(dj, sup_j)


def hub_connection_fraction(degrees: np.ndarray, n_edges: int) -> float:
    """Figs 9-10 quantity: sum(deg(hub)) / (|E(t)| * N_hub(t))."""
    h = hub_mask(degrees)
    n_hub = int(h.sum())
    if n_hub == 0 or n_edges == 0:
        return 0.0
    return float(degrees[h].sum()) / (n_edges * n_hub)


def young_old_hubs(
    degrees: np.ndarray,
    vertex_ts: np.ndarray,
    seen_unique_ts: np.ndarray,
    *,
    quantile: float = 0.25,
) -> tuple[int, int]:
    """Figs 11-12: # young / old hubs.  A hub is young (old) when its first-
    arrival timestamp is in the last (first) ``quantile`` of the ordered set
    of already-seen unique timestamps."""
    h = hub_mask(degrees)
    if h.sum() == 0 or seen_unique_ts.size == 0:
        return 0, 0
    ts = np.sort(seen_unique_ts)
    lo = ts[min(int(np.floor(quantile * (ts.size - 1))), ts.size - 1)]
    hi = ts[max(int(np.ceil((1 - quantile) * (ts.size - 1))), 0)]
    vts = vertex_ts[h]
    young = int((vts >= hi).sum())
    old = int((vts <= lo).sum())
    return young, old


# ---------------------------------------------------------------------------
# SS3.3 -- bursty formation (inter-arrival)
# ---------------------------------------------------------------------------

def interarrival_distribution(
    tau: np.ndarray, edge_i: np.ndarray, edge_j: np.ndarray, *, max_edges: int = 5000
) -> np.ndarray:
    """Figs 7-8: |tau_1 - tau_2| for every pair of edges co-existing in a
    butterfly (lazy computation at t = max_edges).  Returns the flat sample.
    """
    n = min(max_edges, len(edge_i))
    edges = np.stack([edge_i[:n], edge_j[:n]], axis=1)
    # timestamp of an edge = first arrival of that (i, j) pair
    key = edges[:, 0].astype(np.int64) << 32 | edges[:, 1].astype(np.int64)
    first = {}
    for t in range(n):
        first.setdefault(int(key[t]), float(tau[t]))
    quads = enumerate_butterflies_np(edges)
    if quads.shape[0] == 0:
        return np.zeros(0)
    out = []
    for i1, i2, j1, j2 in quads:
        e = [
            first.get((int(a) << 32) | int(b))
            for a, b in ((i1, j1), (i1, j2), (i2, j1), (i2, j2))
        ]
        for a in range(4):
            for b in range(a + 1, 4):
                out.append(abs(e[a] - e[b]))
    return np.asarray(out)


# ---------------------------------------------------------------------------
# SS5.1 -- alpha = P(t): hub probability exponent (Table 7)
# ---------------------------------------------------------------------------

def hub_probability_exponent(
    edge_i: np.ndarray, edge_j: np.ndarray, n_i: int, n_j: int, t: int
) -> float:
    """alpha = P(N_ihub >= 1) + P(N_jhub >= 1) over butterflies at prefix t.

    P(N_ihub>=1) = P(1 i-hub) + P(2 i-hubs) etc., per the paper's formula.
    """
    fr = butterfly_hub_fractions(edge_i[:t], edge_j[:t], n_i, n_j)
    if fr["n_butterflies"] == 0:
        return float("nan")
    pi = fr["i_hubs_0_2"][1] + fr["i_hubs_0_2"][2]
    pj = fr["j_hubs_0_2"][1] + fr["j_hubs_0_2"][2]
    return float(pi + pj)
