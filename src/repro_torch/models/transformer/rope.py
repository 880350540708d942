"""Rotary position embeddings."""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[*, head_dim/2]`` (float32) for integer positions
    ``[*]``."""
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32,
                       device=positions.device)
    inv = 1.0 / (theta ** (idx / head_dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x ``[..., S, H, hd]``; cos/sin ``[S, hd/2]`` (broadcast over batch and
    heads).  A bfloat16 ``x`` times the float32 tables promotes to float32,
    as in the reference, and the result is cast back to ``x.dtype``."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
