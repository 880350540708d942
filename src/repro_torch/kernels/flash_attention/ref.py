"""Full-softmax oracle for the flash-attention kernel (fp32 math)."""
from __future__ import annotations

import torch

from ...core.butterfly import full_fp32_matmul

__all__ = ["attention_ref"]

_NEG = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q [B, Sq, H, hd], k/v [B, Skv, H, hd] -> [B, Sq, H, hd]: the whole
    score matrix in fp32, masked to ``row >= col`` when ``causal``, a full
    softmax, output in ``q.dtype``."""
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32))
    with full_fp32_matmul():
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale.to(q.device)
        if causal:
            sq, sk = q.shape[1], k.shape[1]
            rows = torch.arange(sq, device=q.device)[:, None]
            cols = torch.arange(sk, device=q.device)[None, :]
            s = torch.where(rows >= cols, s, torch.full((), _NEG, device=q.device))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
