"""Arch registry of the port: the LMs, dense GQA, MoE and MLA (importing a
module registers its arch)."""
from . import (  # noqa: F401
    dbrx_132b,
    granite_8b,
    minicpm3_4b,
    phi3_5_moe_42b,
    phi4_mini_3_8b,
)
from .registry import ARCHS, Arch, get_arch, register

__all__ = ["ARCHS", "Arch", "get_arch", "register"]
