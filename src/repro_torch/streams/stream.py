"""Streaming-graph record (sgr) containers.

An sgr is r = (tau, payload) with payload an edge + operation (paper Def 2.1).
This repo restricts operations to edge insertions (paper SS2.1); deletions are
carried structurally (op codes) so the window machinery generalizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

OP_INSERT = 0
OP_DELETE = 1

__all__ = ["SgrStream", "dedupe_stream", "stream_chunks", "OP_INSERT", "OP_DELETE"]


@dataclass
class SgrStream:
    """A materialized, time-ordered sgr sequence (columnar layout).

    tau    : float64 [n]   event timestamps (data-source assigned)
    edge_i : int64   [n]   i-vertex (user) ids
    edge_j : int64   [n]   j-vertex (item) ids
    op     : int8    [n]   OP_INSERT / OP_DELETE
    """

    tau: np.ndarray
    edge_i: np.ndarray
    edge_j: np.ndarray
    op: np.ndarray | None = None

    def __post_init__(self):
        self.tau = np.asarray(self.tau, dtype=np.float64)
        self.edge_i = np.asarray(self.edge_i, dtype=np.int64)
        self.edge_j = np.asarray(self.edge_j, dtype=np.int64)
        if self.op is None:
            self.op = np.zeros(len(self.tau), dtype=np.int8)
        if not (len(self.tau) == len(self.edge_i) == len(self.edge_j) == len(self.op)):
            raise ValueError("ragged sgr columns")
        if np.any(np.diff(self.tau) < 0):
            order = np.argsort(self.tau, kind="stable")
            self.tau = self.tau[order]
            self.edge_i = self.edge_i[order]
            self.edge_j = self.edge_j[order]
            self.op = self.op[order]

    def __len__(self) -> int:
        return len(self.tau)

    @property
    def n_i(self) -> int:
        return int(self.edge_i.max()) + 1 if len(self) else 0

    @property
    def n_j(self) -> int:
        return int(self.edge_j.max()) + 1 if len(self) else 0

    @property
    def n_unique_timestamps(self) -> int:
        return int(np.unique(self.tau).shape[0])

    def prefix(self, n: int) -> "SgrStream":
        return SgrStream(self.tau[:n], self.edge_i[:n], self.edge_j[:n], self.op[:n])

    def edges(self) -> np.ndarray:
        return np.stack([self.edge_i, self.edge_j], axis=1)

    def windowize(self, nt_w: int, **kwargs):
        """Compile this stream into padded adaptive-window tensors
        (``repro_torch.core.windows.windowize``) ready for the window executor."""
        from ..core.windows import windowize as _windowize

        return _windowize(self.tau, self.edge_i, self.edge_j, nt_w, **kwargs)

    def records(self):
        """Iterate (tau, i, j) triples — the online-windowizer wire format."""
        return zip(self.tau.tolist(), self.edge_i.tolist(), self.edge_j.tolist())


def dedupe_stream(s: SgrStream) -> SgrStream:
    """Drop repeat (i, j) arrivals, keeping the first (paper SS2.1)."""
    key = s.edge_i << 32 | (s.edge_j & 0xFFFFFFFF)
    _, idx = np.unique(key, return_index=True)
    idx = np.sort(idx)
    return SgrStream(s.tau[idx], s.edge_i[idx], s.edge_j[idx], s.op[idx])


def stream_chunks(s: SgrStream, chunk: int) -> Iterator[SgrStream]:
    for a in range(0, len(s), chunk):
        yield SgrStream(
            s.tau[a : a + chunk],
            s.edge_i[a : a + chunk],
            s.edge_j[a : a + chunk],
            s.op[a : a + chunk],
        )
