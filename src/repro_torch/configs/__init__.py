"""Arch registry of the port: the dense GQA LMs (importing a module
registers its arch)."""
from . import granite_8b, phi4_mini_3_8b  # noqa: F401
from .registry import ARCHS, Arch, get_arch, register

__all__ = ["ARCHS", "Arch", "get_arch", "register"]
