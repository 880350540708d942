"""Arch registry of the port: the LMs (dense GQA, MoE and MLA) and the
paper's own ``sgrapp`` workload; importing a module registers its arch.
``--arch <id>`` in the launchers resolves through :data:`ARCHS`."""
from . import (  # noqa: F401
    dbrx_132b,
    granite_8b,
    minicpm3_4b,
    phi3_5_moe_42b,
    phi4_mini_3_8b,
    sgrapp_paper,
)
from .registry import ARCHS, Arch, Cell, get_arch, list_cells, register

__all__ = ["ARCHS", "Arch", "Cell", "get_arch", "list_cells", "register"]
