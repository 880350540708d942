"""equiformer-v2 [arXiv:2306.12059]: n_layers=12 d_hidden=128 l_max=6 m_max=2
n_heads=8 — SO(2)-eSCN equivariant graph attention."""
from ..models.gnn import EqV2Config
from .registry import Arch, gnn_cells, register


def full_config() -> EqV2Config:
    return EqV2Config(name="equiformer-v2", n_layers=12, d_hidden=128,
                      l_max=6, m_max=2, n_heads=8, d_out=47)


def smoke_config() -> EqV2Config:
    # float32, as the reference's smoke config
    return EqV2Config(name="equiformer-v2", n_layers=2, d_hidden=16,
                      l_max=2, m_max=1, n_heads=2, d_in=16, d_out=4,
                      dtype="float32")


register(Arch("equiformer-v2", "gnn", full_config, smoke_config,
              lambda cfg: gnn_cells("equiformer", cfg)))
