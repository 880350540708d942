"""LM architecture configuration (the port's copy of the reference's pure
dataclasses)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    rope_theta: float = 10_000.0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    dtype: str = "bfloat16"
    remat: bool = True
    # distribution knobs (see distributed/sharding.py)
    seq_shard_attn_cache: bool = True   # decode KV cache sharded over seq
    fsdp: bool = True                   # ZeRO-3: params/moments also over 'data'
    vocab_pad_to: int = 256
    attn_chunk_q: int = 1024
    attn_chunk_k: int = 1024

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab_size // m) * m

    @property
    def is_mla(self) -> bool:
        return self.mla is not None

    @property
    def q_out_dim(self) -> int:
        if self.is_mla:
            return self.n_heads * (self.mla.qk_nope_head_dim + self.mla.qk_rope_head_dim)
        return self.n_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS in the roofline)."""
        d, L, V = self.d_model, self.n_layers, self.padded_vocab
        n = V * d * 2  # embed + head
        if self.is_mla:
            m = self.mla
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        else:
            attn = (
                d * self.n_heads * self.head_dim
                + 2 * d * self.n_kv_heads * self.head_dim
                + self.n_heads * self.head_dim * d
            )
        if self.moe is not None:
            ffn = d * self.moe.n_experts + self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        else:
            ffn = 3 * d * self.d_ff
        return n + L * (attn + ffn + 2 * d)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        ffn_all = L * self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        ffn_act = L * self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return full - ffn_all + ffn_act
