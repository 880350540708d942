"""granite-8b [arXiv:2405.04324; hf]: 36L d=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 -- llama-arch, code."""
from ..models.transformer.config import LMConfig
from .registry import Arch, lm_cells, register


def full_config() -> LMConfig:
    return LMConfig(
        name="granite-8b", n_layers=36, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14_336, vocab_size=49_152, head_dim=128,
        rope_theta=10_000_000.0,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="granite-8b", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=320, vocab_size=512, head_dim=32, attn_chunk_q=64, attn_chunk_k=64,
    )


register(Arch("granite-8b", "lm", full_config, smoke_config,
              lambda cfg: lm_cells(cfg, n_microbatches=8)))
