"""Attention of the dense GQA transformer: chunked prefill attention (K4 on
the card) and single-token decode attention.

``gqa_attention_chunked`` is the reference's online-softmax prefill
attention (``repro.models.transformer.attention``), the XLA twin of the
flash-attention kernel's schedule.  On a CUDA tensor it launches K4, which
reads the key/value heads by stride and masks ragged lengths itself, so
nothing is repeated or padded; on a CPU tensor it runs the same chunked
online softmax in torch (K4's plain version at ``chunk_q`` x ``chunk_k``
blocks).  Decode attention stays plain torch, as the reference computes it
outside any kernel.  MLA is a later slice.
"""
from __future__ import annotations

import torch

from ...core.butterfly import full_fp32_matmul
from ...kernels.flash_attention.flash_kernel import flash_attention_bshd

__all__ = ["gqa_attention_chunked", "gqa_decode_attention", "mla_attention",
           "mla_decode_attention"]

_NEG = -1e30


def gqa_attention_chunked(
    q: torch.Tensor,            # [B, Sq, H, hd]
    k: torch.Tensor,            # [B, Skv, Hkv, hd]
    v: torch.Tensor,            # [B, Skv, Hkv, hd]
    *,
    causal: bool = True,
    q_offset: int = 0,          # global position of q[0] (chunked prefill)
    chunk_q: int = 1024,
    chunk_k: int = 1024,
) -> torch.Tensor:
    """Softmax attention ``[B, Sq, H, hd]`` in ``q.dtype``: fp32 scores,
    the causal mask by global position with ``-1e30``, an fp32 online
    softmax and ``acc / max(l, 1e-30)``.  ``chunk_q`` / ``chunk_k`` are the
    blocks of the CPU path."""
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError(
            "hd_v != hd (MLA's value head dim) is not ported (a later slice)")
    return flash_attention_bshd(q, k, v, causal=causal, q_offset=q_offset,
                                block_q=chunk_q, block_k=chunk_k)


def gqa_decode_attention(
    q: torch.Tensor,            # [B, H, hd] single new token
    k_cache: torch.Tensor,      # [B, S, Hkv, hd]
    v_cache: torch.Tensor,      # [B, S, Hkv, hd]
    cache_len,                  # int, or [B] valid prefix lengths
) -> torch.Tensor:
    """One query token per sequence against the cache's valid prefix: fp32
    scores and softmax, positions at or past ``cache_len`` masked with
    ``-1e30``; output ``[B, H, hd]`` in ``q.dtype``."""
    b, h, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    groups = h // hkv
    # the reference's float32 1/sqrt(hd), as a Python float: no host-to-device
    # copy (and so no synchronization) per call
    scale = float(1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32)))
    qg = q.reshape(b, hkv, groups, hd).float()
    with full_fp32_matmul():
        scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float())
    scores = scores * scale
    pos = torch.arange(s, device=q.device)
    if isinstance(cache_len, torch.Tensor) and cache_len.dim():
        valid = pos[None, :] < cache_len.to(q.device)[:, None]
    else:
        valid = (pos < int(cache_len))[None, :].expand(b, s)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), _NEG, device=q.device))
    p = torch.softmax(scores, dim=-1)
    with full_fp32_matmul():
        out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def mla_attention(*args, **kwargs):
    """Multi-head latent attention: not ported (``hd_v != hd``; a later
    slice)."""
    raise NotImplementedError("MLA attention is not ported (a later slice)")


def mla_decode_attention(*args, **kwargs):
    """Absorbed-matrix MLA decode: not ported (a later slice)."""
    raise NotImplementedError("MLA decode attention is not ported (a later slice)")
