"""dimenet [arXiv:2003.03123]: n_blocks=6 d_hidden=128 n_bilinear=8
n_spherical=7 n_radial=6 — directional (triplet) message passing."""
from ..models.gnn import DimeNetConfig
from .registry import Arch, gnn_cells, register


def full_config() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6)


def smoke_config() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet", n_blocks=2, d_hidden=16,
                         n_bilinear=4, n_spherical=3, n_radial=3)


register(Arch("dimenet", "gnn", full_config, smoke_config,
              lambda cfg: gnn_cells("dimenet", cfg)))
