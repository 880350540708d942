"""Arch registry: ``--arch <id>`` in the launchers resolves through
:data:`ARCHS`.  The reference's ``Cell`` / ``lm_cells`` dry-run machinery is
not ported yet."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["Arch", "ARCHS", "register", "get_arch"]


@dataclass
class Arch:
    arch_id: str
    family: str
    full_config: Callable[[], Any]
    smoke_config: Callable[[], Any]


ARCHS: dict[str, Arch] = {}


def register(arch: Arch) -> Arch:
    ARCHS[arch.arch_id] = arch
    return arch


def get_arch(arch_id: str) -> Arch:
    return ARCHS[arch_id]
