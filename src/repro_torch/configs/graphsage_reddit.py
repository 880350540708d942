"""graphsage-reddit [arXiv:1706.02216]: 2L d_hidden=128 mean aggregator,
sample sizes 25-10 (the minibatch_lg shape uses the 15-10 fanout sampler)."""
from ..models.gnn import SAGEConfig
from .registry import Arch, gnn_cells, register


def full_config() -> SAGEConfig:
    return SAGEConfig(name="graphsage-reddit", n_layers=2, d_hidden=128,
                      d_in=602, n_classes=41, aggregator="mean")


def smoke_config() -> SAGEConfig:
    return SAGEConfig(name="graphsage-reddit", n_layers=2, d_hidden=16,
                      d_in=16, n_classes=5)


register(Arch("graphsage-reddit", "gnn", full_config, smoke_config,
              lambda cfg: gnn_cells("graphsage", cfg)))
