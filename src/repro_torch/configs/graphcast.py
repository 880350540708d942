"""graphcast [arXiv:2212.12794]: n_layers=16 d_hidden=512 mesh_refinement=6
aggregator=sum n_vars=227 — encoder-processor-decoder mesh GNN.

On the assigned generic graph shapes d_in follows the shape's d_feat (the
weather deployment's n_vars=227 stays the output width); the grid and the
mesh collapse into one node set (``models/gnn/graphcast.py``)."""
from ..models.gnn import GraphCastConfig
from .registry import Arch, gnn_cells, register


def full_config() -> GraphCastConfig:
    return GraphCastConfig(name="graphcast", n_layers=16, d_hidden=512,
                           d_in=227, d_out=227, mesh_refinement=6)


def smoke_config() -> GraphCastConfig:
    return GraphCastConfig(name="graphcast", n_layers=2, d_hidden=32,
                           d_in=16, d_out=16)


register(Arch("graphcast", "gnn", full_config, smoke_config,
              lambda cfg: gnn_cells("graphcast", cfg)))
