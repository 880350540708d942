"""dbrx-132b [hf:databricks/dbrx-base; unverified]: 40L d=6144 48H (GQA kv=8)
d_ff=10752 vocab=100352, MoE 16 experts top-4 (fine-grained)."""
from ..models.transformer.config import LMConfig, MoEConfig
from .registry import Arch, lm_cells, register


def full_config() -> LMConfig:
    return LMConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=10_752, vocab_size=100_352, head_dim=128,
        rope_theta=500_000.0,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10_752),
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="dbrx-132b", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, attn_chunk_q=64, attn_chunk_k=64,
        moe=MoEConfig(n_experts=4, top_k=4, d_ff_expert=128),
    )


register(Arch("dbrx-132b", "lm", full_config, smoke_config,
              lambda cfg: lm_cells(cfg, n_microbatches=8)))
