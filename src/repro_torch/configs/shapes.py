"""Assigned input-shape sets + padded-size policy (the port's copy of
``repro.configs.shapes``, plain Python).

All device arrays are padded so every sharded leading dim divides the largest
data-parallel domain (pod x data = 32 shards; we align to 2048 which also
covers TPU lane quanta).  Budgets for the combinatorial blowup regimes
(DimeNet triplets, EquiformerV2 edge rounds on web-scale graphs) are explicit
config numbers, documented in DESIGN.md SSArch notes — the cell is defined,
not skipped.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "SGRAPP_SHAPES",
           "pad_to", "GNNShape"]


def pad_to(x: int, m: int = 2048) -> int:
    return -(-x // m) * m


# -- LM: seq_len x global_batch -------------------------------------------------

LM_SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),   # skipped for full-attention archs
}


# -- GNN ------------------------------------------------------------------------

@dataclass(frozen=True)
class GNNShape:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: int
    batched: bool = False           # molecule: many small graphs
    n_graphs: int = 1
    # padded (device) sizes
    @property
    def n_nodes_pad(self) -> int:
        return pad_to(self.n_nodes)

    @property
    def n_edges_pad(self) -> int:
        return pad_to(self.n_edges)


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full_graph_sm", 2_708, 10_556, 1_433),
    # reddit minibatch: 1024 seeds, fanout 15-10 -> padded sampled subgraph
    "minibatch_lg": GNNShape("minibatch_lg", 1_024 * (1 + 15 + 150),
                             1_024 * 15 + 15_360 * 10, 602),
    "ogb_products": GNNShape("ogb_products", 2_449_029, 61_859_140, 100),
    "molecule": GNNShape("molecule", 30 * 128, 64 * 128, 16, batched=True,
                         n_graphs=128),
}

# combinatorial budgets (see DESIGN.md): triplets per edge / edge rounds
TRIPLET_BUDGET = {
    "full_graph_sm": 4,     # x n_edges_pad
    "minibatch_lg": 2,
    "ogb_products": 1,      # capped: web-scale graphs process triplet rounds
    "molecule": 4,
}
EQV2_EDGE_BUDGET = {
    # edges processed per device step (host schedules cluster rounds beyond
    # this — Cluster-GCN [arXiv:1905.07953] style; see DESIGN.md SSArch)
    "full_graph_sm": None,
    "minibatch_lg": None,
    "ogb_products": 2048 * 1024,       # 2.1M edges + 512k-node block per round
    "molecule": None,
}

# cluster-round budgets for web-scale full-batch shapes: the gather of
# node/edge state across shards otherwise all-gathers tens of GB per layer
# (the flat-sharded baseline measured it — SSPerf iteration 2).  The device
# step processes one node block + halo; the host scheduler sweeps rounds.
GNN_ROUND_BUDGET = {
    # arch -> {shape: (n_nodes_round, n_edges_round)}
    "graphcast": {"ogb_products": (1_048_576, 4 * 2048 * 1024)},
    "dimenet": {"ogb_products": (1_048_576, 4 * 2048 * 1024)},
}


# -- recsys ----------------------------------------------------------------------

RECSYS_SHAPES = {
    # name: (batch, kind)
    "train_batch": (65_536, "train"),
    "serve_p99": (512, "serve"),
    "serve_bulk": (262_144, "serve"),
    "retrieval_cand": (1_000_000, "retrieval"),
}


# -- sGrapp (the paper's own workload) ---------------------------------------------

SGRAPP_SHAPES = {
    # name: (n_windows, capacity, n_i, n_j)
    "win_8k": (32, 8_192, 4_096, 8_192),
    "win_64k": (32, 65_536, 32_768, 65_536),
    "estimator": (512, 8_192, 4_096, 8_192),  # full sGrapp-x scan over windows
}
