"""Arch registry of the port: the LMs (dense GQA, MoE and MLA), the GNNs
(GraphSAGE, GraphCast, DimeNet, EquiformerV2), xDeepFM and the paper's own
``sgrapp`` workload -- the reference's 11 archs; importing a module
registers its arch.  ``--arch <id>`` in the launchers resolves through
:data:`ARCHS`."""
from . import (  # noqa: F401
    phi4_mini_3_8b,
    granite_8b,
    minicpm3_4b,
    phi3_5_moe_42b,
    dbrx_132b,
    dimenet,
    graphcast,
    equiformer_v2,
    graphsage_reddit,
    xdeepfm,
    sgrapp_paper,
)
from .registry import ARCHS, Arch, Cell, get_arch, list_cells, register

__all__ = ["ARCHS", "Arch", "Cell", "get_arch", "list_cells", "register"]
