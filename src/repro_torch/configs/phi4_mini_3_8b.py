"""phi4-mini-3.8b [arXiv:2412.08905; hf]: 32L d=3072 24H (GQA kv=8)
d_ff=8192 vocab=200064 -- RoPE SwiGLU GQA."""
from ..models.transformer.config import LMConfig
from .registry import Arch, lm_cells, register


def full_config() -> LMConfig:
    return LMConfig(
        name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=8192, vocab_size=200_064, head_dim=128,
        rope_theta=10_000.0,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="phi4-mini-3.8b", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
        attn_chunk_q=64, attn_chunk_k=64,
    )


register(Arch("phi4-mini-3.8b", "lm", full_config, smoke_config,
              lambda cfg: lm_cells(cfg, n_microbatches=8)))
