"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]: 32L d=4096 32H
(GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2."""
from ..models.transformer.config import LMConfig, MoEConfig
from .registry import Arch, lm_cells, register


def full_config() -> LMConfig:
    return LMConfig(
        name="phi3.5-moe-42b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=6400, vocab_size=32_064, head_dim=128,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="phi3.5-moe-42b", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
        attn_chunk_q=64, attn_chunk_k=64,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
    )


register(Arch("phi3.5-moe-42b", "lm", full_config, smoke_config,
              lambda cfg: lm_cells(cfg, n_microbatches=8)))
