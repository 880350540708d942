"""The GNN family of the port (the counterpart of ``repro.models.gnn``):
GraphSAGE, GraphCast, DimeNet and EquiformerV2 over edge lists, with the
halo-exchange losses of GraphSAGE and EquiformerV2.  Parameters are the
reference's trees (dicts and lists of tensors, layer leaves stacked on
``[L]``); ``params_from_reference`` carries the reference's weights
across."""
from ..common import params_from_reference, params_to_reference
from .graphsage import SAGEConfig, init_sage, sage_forward, sage_loss, sage_loss_halo
from .graphcast import GraphCastConfig, init_graphcast, graphcast_forward, graphcast_loss
from .dimenet import DimeNetConfig, init_dimenet, dimenet_forward, dimenet_loss
from .equiformer_v2 import (
    EqV2Config,
    eqv2_forward,
    eqv2_loss,
    eqv2_loss_halo,
    init_eqv2,
)

__all__ = [
    "SAGEConfig", "init_sage", "sage_forward", "sage_loss", "sage_loss_halo",
    "GraphCastConfig", "init_graphcast", "graphcast_forward", "graphcast_loss",
    "DimeNetConfig", "init_dimenet", "dimenet_forward", "dimenet_loss",
    "EqV2Config", "init_eqv2", "eqv2_forward", "eqv2_loss", "eqv2_loss_halo",
    "params_from_reference", "params_to_reference",
]
