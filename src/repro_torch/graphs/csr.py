"""Padded CSR construction (host-side) for neighbor sampling and analytics
(the port's numpy copy of ``repro.graphs.csr``)."""
from __future__ import annotations

import numpy as np

__all__ = ["build_csr_padded", "build_csr"]


def build_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """CSR over outgoing edges: returns (indptr [n+1], indices [m])."""
    order = np.argsort(src, kind="stable")
    indices = dst[order]
    counts = np.bincount(src, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices


def build_csr_padded(src: np.ndarray, dst: np.ndarray, n_nodes: int, max_degree: int):
    """Fixed-width neighbor table [n_nodes, max_degree] + validity mask.

    Degrees above ``max_degree`` are truncated (a documented cap: the large
    graph shapes budget their neighbours explicitly).
    """
    indptr, indices = build_csr(src, dst, n_nodes)
    table = np.zeros((n_nodes, max_degree), dtype=np.int64)
    mask = np.zeros((n_nodes, max_degree), dtype=bool)
    for v in range(n_nodes):
        s, e = indptr[v], indptr[v + 1]
        k = min(int(e - s), max_degree)
        table[v, :k] = indices[s : s + k]
        mask[v, :k] = True
    return table, mask
