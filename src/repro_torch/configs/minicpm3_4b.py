"""minicpm3-4b [hf:openbmb/MiniCPM3-4B]: 62L d=2560 40H d_ff=6400
vocab=73448 -- MLA (q_lora 768, kv_lora 256, nope 64, rope 32, v 64)."""
from ..models.transformer.config import LMConfig, MLAConfig
from .registry import Arch, lm_cells, register


def full_config() -> LMConfig:
    return LMConfig(
        name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
        n_kv_heads=40, d_ff=6400, vocab_size=73_448, head_dim=96,
        rope_theta=10_000.0,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                      qk_rope_head_dim=32, v_head_dim=64),
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="minicpm3-4b", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512, head_dim=32, attn_chunk_q=64, attn_chunk_k=64,
        mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
    )


register(Arch("minicpm3-4b", "lm", full_config, smoke_config,
              lambda cfg: lm_cells(cfg, n_microbatches=8)))
