"""Transformer LM: init, forward, prefill and decode with a KV cache (the
port of ``repro.models.transformer.model``), for every attention and FFN
the reference serves: GQA or MLA attention, a dense SwiGLU or a top-k MoE.

The parameters live in a :class:`TransformerLM` module under the
reference's names and ``[d_in, d_out]`` layout (``embed``, ``head``,
``ln_f`` and, per layer, ``ln_attn ln_mlp``, the attention's ``wq wk wv
wo`` or MLA's ``wq_down wq_up wkv_down wk_rope wk_up wv_up wo``, and the
FFN's ``wi wg wo_mlp`` or the ``moe`` subtree ``w_router wi wg wo``).  The
reference stacks layers on an ``[L]`` axis and scans; here the layers are
a ``ModuleList`` walked by a Python loop.  Prefill attention is
``gqa_attention_chunked`` (K4 on the card), MLA's included.  Serving runs
under ``torch.inference_mode()``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ..common import Split, dense_init, rms_norm
from .attention import (
    gqa_attention_chunked,
    gqa_decode_attention,
    mla_attention,
    mla_decode_attention,
)
from .config import LMConfig
from .moe import MOE_KEYS, init_moe, moe_apply
from .rope import apply_rope, rope_freqs

__all__ = ["TransformerLM", "Block", "init_lm_params", "lm_forward",
           "prefill", "decode_step", "init_cache", "layer_keys"]

GQA_KEYS = ("wq", "wk", "wv", "wo")
MLA_KEYS = ("wq_down", "wq_up", "wkv_down", "wk_rope", "wk_up", "wv_up", "wo")
FFN_KEYS = ("wi", "wg", "wo_mlp")


def layer_keys(cfg: LMConfig) -> tuple[str, ...]:
    """The names of a layer's tensors under ``cfg`` (an MoE layer's
    ``moe`` subtree holds :data:`~.moe.MOE_KEYS`)."""
    attn = MLA_KEYS if cfg.is_mla else GQA_KEYS
    ffn = ("moe",) if cfg.moe is not None else FFN_KEYS
    return ("ln_attn", "ln_mlp") + attn + ffn


def _dt(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Block(nn.Module):
    """A layer's tensors under the reference's names, as parameters that
    take no gradient; a nested dict (the ``moe`` subtree) becomes a
    sub-module of its own."""

    def __init__(self, params: dict):
        super().__init__()
        for name, t in params.items():
            if isinstance(t, dict):
                self.add_module(name, Block(t))
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))


class TransformerLM(nn.Module):
    """The parameters of an LM: ``embed [Vp, d]``, ``head [d, Vp]``,
    ``ln_f [d]`` and a ``ModuleList`` of :class:`Block`, each with the
    tensors :func:`layer_keys` names."""

    def __init__(self, cfg: LMConfig, embed: torch.Tensor, head: torch.Tensor,
                 ln_f: torch.Tensor, layers: list[dict]):
        super().__init__()
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer config")
        want = set(layer_keys(cfg))
        for i, p in enumerate(layers):
            if set(p) != want or ("moe" in p and set(p["moe"]) != set(MOE_KEYS)):
                raise ValueError(f"layer {i} holds {sorted(p)}, not the "
                                 f"{sorted(want)} of {cfg.name}")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.head = nn.Parameter(head, requires_grad=False)
        self.ln_f = nn.Parameter(ln_f, requires_grad=False)
        self.layers = nn.ModuleList(Block(p) for p in layers)


def _init_layer(gen: torch.Generator, cfg: LMConfig) -> dict:
    ks = Split(gen)
    d, dt, dev = cfg.d_model, _dt(cfg), gen.device
    p: dict = {"ln_attn": torch.ones((d,), dtype=dt, device=dev),
               "ln_mlp": torch.ones((d,), dtype=dt, device=dev)}
    if cfg.is_mla:
        m, h = cfg.mla, cfg.n_heads
        p.update(
            wq_down=dense_init(ks(), d, m.q_lora_rank, dtype=dt),
            wq_up=dense_init(ks(), m.q_lora_rank,
                             h * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                             dtype=dt),
            wkv_down=dense_init(ks(), d, m.kv_lora_rank, dtype=dt),
            wk_rope=dense_init(ks(), d, m.qk_rope_head_dim, dtype=dt),
            wk_up=dense_init(ks(), m.kv_lora_rank, h * m.qk_nope_head_dim,
                             dtype=dt),
            wv_up=dense_init(ks(), m.kv_lora_rank, h * m.v_head_dim, dtype=dt),
            wo=dense_init(ks(), h * m.v_head_dim, d, dtype=dt),
        )
    else:
        hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        p.update(wq=dense_init(ks(), d, hq, dtype=dt),
                 wk=dense_init(ks(), d, hkv, dtype=dt),
                 wv=dense_init(ks(), d, hkv, dtype=dt),
                 wo=dense_init(ks(), hq, d, dtype=dt))
    if cfg.moe is not None:
        p["moe"] = init_moe(ks(), d, cfg.moe, dtype=dt)
    else:
        p.update(wi=dense_init(ks(), d, cfg.d_ff, dtype=dt),
                 wg=dense_init(ks(), d, cfg.d_ff, dtype=dt),
                 wo_mlp=dense_init(ks(), cfg.d_ff, d, dtype=dt))
    return p


def init_lm_params(cfg: LMConfig, *, seed: int = 0, device=None) -> TransformerLM:
    """Random parameters with the reference's distributions
    (``model.py`` ``init_lm_params``): dense weights ``N(0, 1/d_in)``, the
    experts ``N(0, 1/d_in)`` with a float32 router, the embedding
    ``N(0, 0.02**2)``, norms 1.  Drawn from a torch generator seeded with
    ``seed`` on the device, so the numbers differ from the reference's
    threefry draws."""
    dev = resolve_device(device)
    ks = Split(torch.Generator(device=dev).manual_seed(seed))
    dt = _dt(cfg)
    layer_gens = Split(ks())
    layers = [_init_layer(layer_gens(), cfg) for _ in range(cfg.n_layers)]
    embed = dense_init(ks(), cfg.padded_vocab, cfg.d_model, scale=0.02, dtype=dt)
    head = dense_init(ks(), cfg.d_model, cfg.padded_vocab, dtype=dt)
    ln_f = torch.ones((cfg.d_model,), dtype=dt, device=dev)
    return TransformerLM(cfg, embed, head, ln_f, layers)


def _ffn(p: Block, h2: torch.Tensor, cfg: LMConfig
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The FFN on ``h2 [..., d]``: ``(out, aux)``, aux None for a dense
    SwiGLU.  An MoE routes the flattened tokens."""
    if cfg.moe is None:
        return (F.silu(h2 @ p.wi) * (h2 @ p.wg)) @ p.wo_mlp, None
    y, aux = moe_apply(p.moe, h2.reshape(-1, cfg.d_model), cfg.moe)
    return y.reshape(h2.shape), aux


def _block(p: Block, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor,
           rope) -> tuple[torch.Tensor, torch.Tensor | None, tuple]:
    """One layer over ``x [B, S, d]``: ``(x, aux, cache)``, the cache the
    rotated keys and values ``(k, v)`` or MLA's latents ``(c_kv, k_rope)``.
    ``rope`` is the ``(cos, sin)`` of a GQA layer (MLA builds its own at
    ``qk_rope_head_dim``)."""
    b, s, _ = x.shape
    h = rms_norm(x, p.ln_attn)
    if cfg.is_mla:
        attn_out, cache = mla_attention(h, p, cfg, positions)
    else:
        cos, sin = rope
        q = (h @ p.wq).reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = (h @ p.wk).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ p.wv).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = gqa_attention_chunked(q, k, v, causal=True,
                                     chunk_q=cfg.attn_chunk_q,
                                     chunk_k=cfg.attn_chunk_k)
        attn_out = attn.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p.wo
        cache = (k, v)
    x = x + attn_out
    out, aux = _ffn(p, rms_norm(x, p.ln_mlp), cfg)
    return x + out, aux, cache


def _trunk(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig,
           positions: torch.Tensor | None, sink
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logits [B, S, Vp], aux)`` over all positions, aux summed over
    the layers; ``sink(layer, cache)``, when given, receives each layer's
    cache entries."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    rope = None if cfg.is_mla else rope_freqs(cfg.head_dim, cfg.rope_theta,
                                              positions)
    x = params.embed[tokens]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i, p in enumerate(params.layers):
        x, a, cache = _block(p, x, cfg, positions, rope)
        if a is not None:
            aux = aux + a
        if sink is not None:
            sink(i, cache)
    return rms_norm(x, params.ln_f) @ params.head, aux


@torch.inference_mode()
def lm_forward(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig, *,
               positions: torch.Tensor | None = None,
               collect_cache: bool = False):
    """tokens ``[B, S]`` -> ``(logits [B, S, Vp], aux)``; with
    ``collect_cache`` also each layer's cache stacked on ``[L]``: ``(k, v)``,
    each ``[L, B, S, Hkv, hd]``, or MLA's ``(c_kv [L, B, S, kv_rank],
    k_rope [L, B, S, rope])``.  ``aux`` is the MoE balance term summed over
    the layers (0 for a dense FFN)."""
    caches = []
    logits, aux = _trunk(params, tokens, cfg, positions,
                         (lambda i, c: caches.append(c)) if collect_cache else None)
    if collect_cache:
        return logits, aux, tuple(torch.stack(t) for t in zip(*caches))
    return logits, aux


def _cache_names(cfg: LMConfig) -> tuple[str, str]:
    return ("ckv", "krope") if cfg.is_mla else ("k", "v")


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """A zero cache: ``{"k", "v": [L, B, max_len, Hkv, hd], "len": 0}``, or
    for MLA the latents ``{"ckv": [L, B, max_len, kv_rank], "krope": [L, B,
    max_len, rope], "len": 0}``; ``len`` is a Python int."""
    dev = resolve_device(device)
    dt = dtype or _dt(cfg)
    lead = (cfg.n_layers, batch, max_len)
    if cfg.is_mla:
        m = cfg.mla
        shapes = (lead + (m.kv_lora_rank,), lead + (m.qk_rope_head_dim,))
    else:
        shapes = (lead + (cfg.n_kv_heads, cfg.head_dim),) * 2
    cache = {name: torch.zeros(shape, dtype=dt, device=dev)
             for name, shape in zip(_cache_names(cfg), shapes)}
    cache["len"] = 0
    return cache


@torch.inference_mode()
def prefill(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Run the prompts ``[B, S]`` through the trunk (logits over all
    positions, as the reference computes them), write each layer's cache
    entries into a cache padded to ``max_len``, and return the last
    position's logits ``[B, Vp]`` and the cache (``len = S``)."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    names = _cache_names(cfg)

    def sink(i, entries):
        for name, t in zip(names, entries):
            cache[name][i, :, :s] = t

    logits, _ = _trunk(params, tokens, cfg, None, sink)
    cache["len"] = s
    return logits[:, -1], cache


@torch.inference_mode()
def decode_step(params: TransformerLM, cache: dict, tokens: torch.Tensor,
                cfg: LMConfig) -> tuple[torch.Tensor, dict]:
    """One token for every sequence in the batch (``tokens [B]``): returns
    ``(logits [B, Vp], cache)`` with the new cache entries written at
    position ``cache["len"]`` and ``len`` advanced by one.  The cache's
    tensors are updated in place (the reference donates them)."""
    first, second = _cache_names(cfg)
    cache_len = int(cache["len"])
    if cache_len >= cache[first].shape[2]:
        raise ValueError(f"the cache is full ({cache_len} positions)")
    b = tokens.shape[0]
    x = params.embed[tokens]
    rot = cfg.mla.qk_rope_head_dim if cfg.is_mla else cfg.head_dim
    cos, sin = rope_freqs(rot, cfg.rope_theta, torch.arange(
        cache_len, cache_len + 1, device=tokens.device))
    for i, p in enumerate(params.layers):
        h = rms_norm(x, p.ln_attn)
        if cfg.is_mla:
            new_krope = (h @ p.wk_rope).reshape(b, 1, 1, rot)
            cache[first][i, :, cache_len] = h @ p.wkv_down
            cache[second][i, :, cache_len] = apply_rope(new_krope, cos,
                                                        sin)[:, 0, 0]
            attn_out = mla_decode_attention(h, p, cfg, cache[first][i],
                                            cache[second][i], cache_len + 1,
                                            cache_len)
        else:
            q = (h @ p.wq).reshape(b, 1, cfg.n_heads, cfg.head_dim)
            k = (h @ p.wk).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
            v = (h @ p.wv).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
            q = apply_rope(q, cos, sin)[:, 0]
            cache[first][i, :, cache_len] = apply_rope(k, cos, sin)[:, 0]
            cache[second][i, :, cache_len] = v[:, 0]
            attn = gqa_decode_attention(q, cache[first][i], cache[second][i],
                                        cache_len + 1)
            attn_out = attn.reshape(b, cfg.n_heads * cfg.head_dim) @ p.wo
        x = x + attn_out
        out, _ = _ffn(p, rms_norm(x, p.ln_mlp), cfg)
        x = x + out
    logits = rms_norm(x, params.ln_f) @ params.head
    return logits, {**cache, "len": cache_len + 1}
