"""xdeepfm [arXiv:1803.05170]: n_sparse=39 embed_dim=10 CIN 200-200-200
MLP 400-400 — CIN feature interaction over Criteo-scale embedding tables."""
from ..models.recsys import XDeepFMConfig
from .registry import Arch, register, xdeepfm_cells


def full_config() -> XDeepFMConfig:
    return XDeepFMConfig(name="xdeepfm", n_sparse=39, embed_dim=10,
                         cin_layers=(200, 200, 200), mlp_dims=(400, 400),
                         vocab_per_field=1_000_000)


def smoke_config() -> XDeepFMConfig:
    return XDeepFMConfig(name="xdeepfm", n_sparse=8, embed_dim=4,
                         cin_layers=(16, 16), mlp_dims=(32,),
                         vocab_per_field=128)


register(Arch("xdeepfm", "recsys", full_config, smoke_config, xdeepfm_cells))
