"""Fanout neighbor sampler (GraphSAGE-style) — host-side, static output shapes
(the port's numpy copy of ``repro.graphs.sampler``: the same
``default_rng(seed)`` draws, so the same blocks).

``minibatch_lg`` shapes need a real sampler: given seed nodes and per-hop
fanouts, sample a k-hop padded subgraph.  The device step consumes fixed
[n_seeds, fanout_1], [n_seeds*fanout_1, fanout_2], ... blocks, so every
batch of a run has the same shapes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["fanout_sample", "SampledBlocks"]


@dataclass
class SampledBlocks:
    """Per-hop padded sampled neighborhoods.

    seeds      : int64 [n_seeds]
    nbr[h]     : int64 [n_dst_h, fanout_h]  sampled source nodes per dst
    nbr_mask[h]: bool  [n_dst_h, fanout_h]
    The hop-h destination set is the flattened hop-(h-1) frontier.
    """

    seeds: np.ndarray
    nbr: list[np.ndarray]
    nbr_mask: list[np.ndarray]

    @property
    def frontier_sizes(self) -> list[int]:
        return [self.seeds.shape[0]] + [n.shape[0] * n.shape[1] for n in self.nbr]


def fanout_sample(
    indptr: np.ndarray,
    indices: np.ndarray,
    seeds: np.ndarray,
    fanouts: list[int],
    *,
    seed: int = 0,
    replace: bool = True,
) -> SampledBlocks:
    rng = np.random.default_rng(seed)
    nbr, nbr_mask = [], []
    frontier = np.asarray(seeds, dtype=np.int64)
    for f in fanouts:
        n = frontier.shape[0]
        out = np.zeros((n, f), dtype=np.int64)
        msk = np.zeros((n, f), dtype=bool)
        deg = indptr[frontier + 1] - indptr[frontier]
        for r, v in enumerate(frontier):
            d = int(deg[r])
            if d == 0:
                continue
            if replace or d < f:
                pick = rng.integers(0, d, size=f)
            else:
                pick = rng.choice(d, size=f, replace=False)
            out[r] = indices[indptr[v] + pick]
            msk[r] = True
        nbr.append(out)
        nbr_mask.append(msk)
        frontier = out.reshape(-1)
    return SampledBlocks(np.asarray(seeds, dtype=np.int64), nbr, nbr_mask)
