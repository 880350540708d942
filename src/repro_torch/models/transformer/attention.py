"""Attention of the transformer: chunked prefill attention (K4 on the card),
single-token decode attention, and MLA's prefill and absorbed decode.

``gqa_attention_chunked`` is the reference's online-softmax prefill
attention (``repro.models.transformer.attention``), the XLA twin of the
flash-attention kernel's schedule.  On a CUDA tensor it launches K4, which
reads the key/value heads by stride and masks ragged lengths itself, so
nothing is repeated or padded; on a CPU tensor it runs the same chunked
online softmax in torch (K4's plain version at ``chunk_q`` x ``chunk_k``
blocks).  The value head dim may differ from the query's (MLA).  MLA's
prefill expands its latents and calls ``gqa_attention_chunked`` (K4 on the
card); decode attention, dense and MLA, stays plain torch, as the reference
computes it outside any kernel.

Training differentiates ``gqa_attention_chunked``: it is an autograd
function whose forward is K4 (the plain version on the CPU) and whose
backward (:func:`attention_backward`) recomputes the softmax in float32
torch ops one query chunk at a time, the function ``jax.grad`` of the
reference's chunked scan computes.  No kernel of the reference runs a
backward, so none is ported for it.
"""
from __future__ import annotations

import torch

from ...core.butterfly import full_fp32_matmul
from ...kernels.flash_attention.flash_kernel import flash_attention_bshd
from .rope import apply_rope, rope_freqs

__all__ = ["attention_backward", "attention_scale", "gqa_attention_chunked",
           "gqa_attention_heads", "gqa_decode_attention", "kv_heads_of",
           "mla_attention", "mla_decode_attention"]

_NEG = -1e30


def attention_scale(hd: int) -> float:
    """The reference's ``1 / sqrt(float32(hd))``, rounded in float32, as a
    Python float: no host-to-device copy (and so no synchronization) per
    call.  At hd = 96 it is one float32 ulp below the double
    ``1 / hd ** 0.5`` rounded to float32."""
    return float(1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32)))


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       d_out: torch.Tensor, *, causal: bool, q_offset: int,
                       chunk_q: int, scale: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of ``gqa_attention_chunked`` for the output's
    cotangent ``d_out [B, Sq, H, hd_v]``, each in its input's dtype, on the
    inputs' device.  Per query chunk of ``chunk_q`` rows, in float32 with
    no TF32: the scores ``q k^T * scale``, masked by global position with
    ``-1e30``, and their softmax ``P``; ``dV += P^T dO``, ``dP = dO V^T``,
    ``dS = P * (dP - rowsum(dO * O))`` (``rowsum(dO * O)`` computed as
    ``rowsum(P * dP)``, the same sum since ``O = P V``), ``dQ = dS K *
    scale`` and ``dK += dS^T Q * scale``; a query head's gradients are
    summed onto its key/value head.  Under a causal mask a chunk reads only
    the keys at or before its last row: the ones after it weigh exactly 0."""
    b, sq, h, hd = q.shape
    skv, hkv, hd_v = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    dev = q.device
    # [B, Hkv, G, S, .]: query heads grouped under their key/value head
    qf = q.float().reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4)
    dof = d_out.float().reshape(b, sq, hkv, g, hd_v).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, hkv, skv, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, hkv, skv, hd_v), dtype=torch.float32, device=dev)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
    cq = max(1, min(chunk_q, sq))
    with full_fp32_matmul():
        for q0 in range(0, sq, cq):
            n = min(cq, sq - q0)
            kend = min(skv, q_offset + q0 + n) if causal else skv
            if kend <= 0:
                continue
            qb, dob = qf[..., q0:q0 + n, :], dof[..., q0:q0 + n, :]
            kb, vb = kf[..., :kend, :], vf[..., :kend, :]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            if causal:
                rows = q_offset + q0 + torch.arange(n, device=dev)
                cols = torch.arange(kend, device=dev)
                s = torch.where(rows[:, None] >= cols[None, :], s, neg)
            p = torch.softmax(s, dim=-1)
            del s
            dv[:, :, :kend] += torch.einsum("bhgqk,bhgqd->bhkd", p, dob)
            ds = torch.matmul(dob, vb.transpose(-1, -2))
            ds = ds.sub_((p * ds).sum(dim=-1, keepdim=True)).mul_(p)
            del p
            dq[..., q0:q0 + n, :] = torch.matmul(ds, kb) * scale
            dk[:, :, :kend] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qb) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _ChunkedAttention(torch.autograd.Function):
    """Forward: K4's wrapper.  Backward: :func:`attention_backward` on the
    saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, chunk_q, chunk_k, scale):
        ctx.save_for_backward(q, k, v)
        ctx.conf = dict(causal=causal, q_offset=q_offset, chunk_q=chunk_q,
                        scale=scale)
        return flash_attention_bshd(q, k, v, causal=causal, q_offset=q_offset,
                                    block_q=chunk_q, block_k=chunk_k,
                                    scale=scale)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        # a profiler span, so that a profiled step shows this backward's
        # share of its device time
        with torch.profiler.record_function("attention_backward"):
            dq, dk, dv = attention_backward(q, k, v, d_out, **ctx.conf)
        return dq, dk, dv, None, None, None, None, None


def gqa_attention_chunked(
    q: torch.Tensor,            # [B, Sq, H, hd]
    k: torch.Tensor,            # [B, Skv, Hkv, hd]
    v: torch.Tensor,            # [B, Skv, Hkv, hd_v]
    *,
    causal: bool = True,
    q_offset: int = 0,          # global position of q[0] (chunked prefill)
    chunk_q: int = 1024,
    chunk_k: int = 1024,
) -> torch.Tensor:
    """Softmax attention ``[B, Sq, H, hd_v]`` in ``q.dtype``: fp32 scores
    scaled by the reference's float32 ``1/sqrt(hd)``, the causal mask by
    global position with ``-1e30``, an fp32 online softmax and
    ``acc / max(l, 1e-30)``.  ``chunk_q`` / ``chunk_k`` are the blocks of
    the CPU path; ``chunk_q`` is also the backward's query chunk.
    Differentiable in ``q``, ``k`` and ``v`` (:func:`attention_backward`)."""
    return _ChunkedAttention.apply(q, k, v, causal, q_offset, chunk_q,
                                   chunk_k, attention_scale(q.shape[-1]))


def kv_heads_of(k: torch.Tensor, v: torch.Tensor, first: int, h: int,
                n_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The key/value heads (dim 2 of ``k`` and ``v``, all ``Hkv`` of a
    layer) that query heads ``first .. first + h`` of ``n_heads`` read:
    where the slice is whole groups, their key/value heads as a block (the
    layer's group size); where it straddles a group, each query head's own
    (group size 1)."""
    g = n_heads // k.shape[2]
    if first % g == 0 and h % g == 0:
        return (k[:, :, first // g:(first + h) // g],
                v[:, :, first // g:(first + h) // g])
    idx = torch.arange(first, first + h, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def gqa_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        first: int, n_heads: int, *, chunk_q: int = 1024,
                        chunk_k: int = 1024) -> torch.Tensor:
    """Causal :func:`gqa_attention_chunked` on a slice of a layer's query
    heads: ``q [B, S, h, hd]`` holds heads ``first .. first + h`` of
    ``n_heads``, which read key/value head ``head // (n_heads // Hkv)`` of
    ``k`` and ``v`` (all ``Hkv`` of them).  Where the slice is whole groups
    the kernel takes their key/value heads as a block at the layer's
    group size; where it straddles a group, each query head's own
    key/value head (group size 1).  q, k and v reach the kernel
    contiguous, so that K4 reads them through TMA as they lie.  No head:
    an empty ``[B, S, 0, hd_v]``."""
    b, s, h, _ = q.shape
    if h == 0:
        return q.new_empty((b, s, 0, v.shape[3]))
    k, v = kv_heads_of(k, v, first, h, n_heads)
    return gqa_attention_chunked(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True,
                                 chunk_q=chunk_q, chunk_k=chunk_k)


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
    scale = attention_scale(hd)
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


def mla_attention(
    x: torch.Tensor,            # [B, S, D]
    p,                          # the layer: wq_down wq_up wkv_down wk_rope wk_up wv_up wo
    cfg,                        # LMConfig with .mla set
    positions: torch.Tensor,    # [S]
    *,
    causal: bool = True,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Prefill MLA: ``(out [B, S, D], (c_kv [B, S, kv_rank], k_rope [B, S,
    rope]))``, the latents the cache keeps.  The latents are expanded to
    full heads (queries and keys of ``nope + rope``, values of ``v_head_dim``)
    and attended by ``gqa_attention_chunked``, which is K4 on the card."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q = ((x @ p.wq_down) @ p.wq_up).reshape(
        b, s, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    c_kv = x @ p.wkv_down
    k_rope = (x @ p.wk_rope).reshape(b, s, 1, m.qk_rope_head_dim)
    cos, sin = rope_freqs(m.qk_rope_head_dim, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    k_nope = (c_kv @ p.wk_up).reshape(b, s, h, m.qk_nope_head_dim)
    v = (c_kv @ p.wv_up).reshape(b, s, h, m.v_head_dim)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)],
                   dim=-1)
    out = gqa_attention_chunked(qf, kf, v, causal=causal,
                                chunk_q=cfg.attn_chunk_q,
                                chunk_k=cfg.attn_chunk_k)
    out = out.reshape(b, s, h * m.v_head_dim) @ p.wo
    return out, (c_kv, k_rope[:, :, 0, :])


def mla_decode_attention(
    x: torch.Tensor,            # [B, D] one token
    p,
    cfg,
    ckv_cache: torch.Tensor,    # [B, S, kv_rank]
    krope_cache: torch.Tensor,  # [B, S, rope]
    cache_len,                  # int, or [B] valid prefix lengths
    position: int,              # the new token's position
) -> torch.Tensor:
    """Absorbed-matrix MLA decode, ``[B, D]``: ``q_nope`` is folded through
    ``wk_up`` so the scores run against the cached latents, all in float32
    (``1/sqrt(float32(nope + rope))``, positions at or past ``cache_len``
    masked with ``-1e30``), and ``wv_up`` is applied to the attended latent
    on the way out before ``wo`` in ``x.dtype``."""
    m = cfg.mla
    b = x.shape[0]
    h, r = cfg.n_heads, m.kv_lora_rank
    q = ((x @ p.wq_down) @ p.wq_up).reshape(
        b, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    cos, sin = rope_freqs(m.qk_rope_head_dim, cfg.rope_theta, torch.arange(
        position, position + 1, device=x.device))
    q_rope = apply_rope(q_rope[:, None], cos, sin)[:, 0]
    wk_up = p.wk_up.reshape(r, h, m.qk_nope_head_dim).float()
    ckv = ckv_cache.float()
    with full_fp32_matmul():
        q_abs = torch.einsum("bhn,rhn->bhr", q_nope.float(), wk_up)
        s_lat = torch.einsum("bhr,bsr->bhs", q_abs, ckv)
        s_rope = torch.einsum("bhr,bsr->bhs", q_rope.float(),
                              krope_cache.float())
    scores = (s_lat + s_rope) * attention_scale(
        m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = ckv_cache.shape[1]
    pos = torch.arange(s, device=x.device)
    if isinstance(cache_len, torch.Tensor) and cache_len.dim():
        valid = pos[None, :] < cache_len.to(x.device)[:, None]
    else:
        valid = (pos < int(cache_len))[None, :].expand(b, s)
    scores = torch.where(valid[:, None, :], scores,
                         torch.full((), _NEG, device=x.device))
    pattn = torch.softmax(scores, dim=-1)
    wv_up = p.wv_up.reshape(r, h, m.v_head_dim).float()
    with full_fp32_matmul():
        out_lat = torch.einsum("bhs,bsr->bhr", pattn, ckv)
        out = torch.einsum("bhr,rhv->bhv", out_lat, wv_up)
    return out.reshape(b, h * m.v_head_dim).to(x.dtype) @ p.wo
