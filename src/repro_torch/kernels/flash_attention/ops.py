"""The ``[B, S, H, hd]`` entry with GQA: key/value heads are shared by
stride, not repeated (the reference repeats them with ``jnp.repeat`` and
transposes to ``[B*H, S, hd]``)."""
from __future__ import annotations

import torch

from .flash_kernel import check_blocks, flash_attention_bshd

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """q ``[B, Sq, H, hd]``; k/v ``[B, Skv, Hkv, hd]`` (GQA groups
    broadcast) -> ``[B, Sq, H, hd]``.  Raises ``ValueError`` when a length
    does not divide its block, as the reference does."""
    check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    return flash_attention_bshd(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k)
