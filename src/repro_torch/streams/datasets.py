"""Real-dataset ingestion: KONECT-style edge lists (when present on disk).

The port's copy of ``repro.streams.datasets`` (host-only).

The paper's six datasets come from the KONECT repository, which is not
bundled offline.  When a deployment has them, `load_konect` ingests the
standard ``out.<name>`` TSV format (``i j [weight [timestamp]]`` with %
comment headers) into an SgrStream; everything downstream (windowizer,
estimators, benches) is format-agnostic.  `available_datasets` scans a
directory so benches can auto-pick real data over synthetic.
"""
from __future__ import annotations

import os

import numpy as np

from .stream import SgrStream

__all__ = ["load_konect", "load_edge_tsv", "available_datasets"]


def load_edge_tsv(path: str, *, has_timestamps: bool = True,
                  max_edges: int | None = None) -> SgrStream:
    """Parse ``i j [w] [t]`` rows (KONECT out.* / generic TSV).

    Column handling is per row: 4+ columns are the full KONECT layout
    ``i j weight timestamp``.  3 columns are ambiguous — temporal datasets
    ship weightless ``i j timestamp`` rows, non-temporal weighted ones ship
    ``i j weight`` — so the third column is accepted as the timestamp only
    when the collected values are non-decreasing in file order AND take
    more than one value (KONECT temporal dumps are time-sorted; a 1-5 star
    rating column jumps around, and the ubiquitous all-ones weight column
    is constant).  Otherwise, as for 2-column rows and
    ``has_timestamps=False``, synthetic arrival-index timestamps preserve
    stream order.
    """
    ii, jj, tt3, tt4 = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith(("%", "#")) or not line.strip():
                continue
            parts = line.split()
            ii.append(int(parts[0]))
            jj.append(int(parts[1]))
            if has_timestamps and len(parts) >= 4:
                tt4.append(float(parts[3]))
            elif has_timestamps and len(parts) == 3:
                tt3.append(float(parts[2]))
            if max_edges is not None and len(ii) >= max_edges:
                break
    ii = np.asarray(ii, dtype=np.int64)
    jj = np.asarray(jj, dtype=np.int64)
    if len(tt4) == len(ii):
        tau = np.asarray(tt4, dtype=np.float64)
    elif (len(tt3) == len(ii) and len(tt3) > 0
          and not np.any(np.diff(tt3) < 0) and tt3[0] != tt3[-1]):
        # non-decreasing, so constant <=> first == last
        tau = np.asarray(tt3, dtype=np.float64)
    else:  # 2-column / mixed / weight-like third column: arrival order
        tau = np.arange(len(ii), dtype=np.float64)
    # KONECT ids are 1-based; compact both sides to dense 0-based ids
    _, ii = np.unique(ii, return_inverse=True)
    _, jj = np.unique(jj, return_inverse=True)
    return SgrStream(tau, ii, jj)


def load_konect(root: str, name: str, **kw) -> SgrStream:
    """Load a KONECT dataset directory (<root>/<name>/out.<name>)."""
    path = os.path.join(root, name, f"out.{name}")
    if not os.path.exists(path):
        candidates = [p for p in os.listdir(os.path.join(root, name))
                      if p.startswith("out.")] if os.path.isdir(
                          os.path.join(root, name)) else []
        if not candidates:
            raise FileNotFoundError(path)
        path = os.path.join(root, name, candidates[0])
    return load_edge_tsv(path, **kw)


def available_datasets(root: str) -> list[str]:
    if not os.path.isdir(root):
        return []
    out = []
    for d in sorted(os.listdir(root)):
        full = os.path.join(root, d)
        if os.path.isdir(full) and any(p.startswith("out.") for p in os.listdir(full)):
            out.append(d)
    return out
