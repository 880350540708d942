"""Dense GQA transformer LM: init, forward, prefill and decode with a KV
cache (the port of ``repro.models.transformer.model``).

The parameters live in a :class:`TransformerLM` module under the
reference's names and ``[d_in, d_out]`` layout (``embed``, ``head``,
``ln_f`` and, per layer, ``ln_attn ln_mlp wq wk wv wo wi wg wo_mlp``).  The
reference stacks layers on an ``[L]`` axis and scans; here the layers are a
``ModuleList`` walked by a Python loop.  Prefill attention is
``gqa_attention_chunked`` (K4 on the card).  Serving runs under
``torch.inference_mode()``.  MoE and MLA configurations raise
``NotImplementedError`` (later slices).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ..common import Split, dense_init, rms_norm
from .attention import gqa_attention_chunked, gqa_decode_attention
from .config import LMConfig
from .rope import apply_rope, rope_freqs

__all__ = ["TransformerLM", "init_lm_params", "lm_forward", "prefill",
           "decode_step", "init_cache", "LAYER_KEYS"]

LAYER_KEYS = ("ln_attn", "ln_mlp", "wq", "wk", "wv", "wo", "wi", "wg", "wo_mlp")


def _dt(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_dense(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported "
                                  "(a later slice)")
    if cfg.is_mla:
        raise NotImplementedError(f"{cfg.name}: MLA attention is not ported "
                                  "(a later slice)")


class Block(nn.Module):
    """One layer's parameters under the reference's names."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        for name in LAYER_KEYS:
            self.register_parameter(
                name, nn.Parameter(params[name], requires_grad=False))


class TransformerLM(nn.Module):
    """The parameters of a dense GQA LM: ``embed [Vp, d]``, ``head [d, Vp]``,
    ``ln_f [d]`` and a ``ModuleList`` of :class:`Block`."""

    def __init__(self, cfg: LMConfig, embed: torch.Tensor, head: torch.Tensor,
                 ln_f: torch.Tensor, layers: list[dict[str, torch.Tensor]]):
        super().__init__()
        _check_dense(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer config")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.head = nn.Parameter(head, requires_grad=False)
        self.ln_f = nn.Parameter(ln_f, requires_grad=False)
        self.layers = nn.ModuleList(Block(p) for p in layers)


def _init_layer(gen: torch.Generator, cfg: LMConfig) -> dict[str, torch.Tensor]:
    ks = Split(gen)
    d, dt, dev = cfg.d_model, _dt(cfg), gen.device
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {
        "ln_attn": torch.ones((d,), dtype=dt, device=dev),
        "ln_mlp": torch.ones((d,), dtype=dt, device=dev),
        "wq": dense_init(ks(), d, hq, dtype=dt),
        "wk": dense_init(ks(), d, hkv, dtype=dt),
        "wv": dense_init(ks(), d, hkv, dtype=dt),
        "wo": dense_init(ks(), hq, d, dtype=dt),
        "wi": dense_init(ks(), d, cfg.d_ff, dtype=dt),
        "wg": dense_init(ks(), d, cfg.d_ff, dtype=dt),
        "wo_mlp": dense_init(ks(), cfg.d_ff, d, dtype=dt),
    }


def init_lm_params(cfg: LMConfig, *, seed: int = 0, device=None) -> TransformerLM:
    """Random parameters with the reference's distributions
    (``model.py`` ``init_lm_params``): dense weights ``N(0, 1/d_in)``, the
    embedding ``N(0, 0.02**2)``, norms 1.  Drawn from a torch generator
    seeded with ``seed`` on the device, so the numbers differ from the
    reference's threefry draws."""
    _check_dense(cfg)
    dev = resolve_device(device)
    ks = Split(torch.Generator(device=dev).manual_seed(seed))
    dt = _dt(cfg)
    layer_gens = Split(ks())
    layers = [_init_layer(layer_gens(), cfg) for _ in range(cfg.n_layers)]
    embed = dense_init(ks(), cfg.padded_vocab, cfg.d_model, scale=0.02, dtype=dt)
    head = dense_init(ks(), cfg.d_model, cfg.padded_vocab, dtype=dt)
    ln_f = torch.ones((cfg.d_model,), dtype=dt, device=dev)
    return TransformerLM(cfg, embed, head, ln_f, layers)


def _block(p: Block, x: torch.Tensor, cfg: LMConfig, cos: torch.Tensor,
           sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h = rms_norm(x, p.ln_attn)
    q = (h @ p.wq).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ p.wk).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p.wv).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = gqa_attention_chunked(q, k, v, causal=True, chunk_q=cfg.attn_chunk_q,
                                 chunk_k=cfg.attn_chunk_k)
    x = x + attn.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p.wo
    h2 = rms_norm(x, p.ln_mlp)
    x = x + (F.silu(h2 @ p.wi) * (h2 @ p.wg)) @ p.wo_mlp
    return x, k, v


def _trunk(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig,
           positions: torch.Tensor | None, sink) -> torch.Tensor:
    """Logits ``[B, S, Vp]`` over all positions; ``sink(layer, k, v)``, when
    given, receives each layer's rotated keys and values."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
    x = params.embed[tokens]
    for i, p in enumerate(params.layers):
        x, k, v = _block(p, x, cfg, cos, sin)
        if sink is not None:
            sink(i, k, v)
    return rms_norm(x, params.ln_f) @ params.head


@torch.inference_mode()
def lm_forward(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig, *,
               positions: torch.Tensor | None = None,
               collect_cache: bool = False):
    """tokens ``[B, S]`` -> ``(logits [B, S, Vp], aux)``, with
    ``collect_cache`` also ``(k, v)``, each ``[L, B, S, Hkv, hd]``.  ``aux``
    is the MoE balance loss of the reference, 0 for a dense model."""
    _check_dense(cfg)
    ks, vs = [], []
    sink = (lambda i, k, v: (ks.append(k), vs.append(v))) if collect_cache else None
    logits = _trunk(params, tokens, cfg, positions, sink)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if collect_cache:
        return logits, aux, (torch.stack(ks), torch.stack(vs))
    return logits, aux


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """A zero KV cache ``{"k", "v": [L, B, max_len, Hkv, hd], "len": 0}``;
    ``len`` is a Python int."""
    _check_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or _dt(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "len": 0}


@torch.inference_mode()
def prefill(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Run the prompts ``[B, S]`` through the trunk (logits over all
    positions, as the reference computes them), write each layer's keys and
    values into a cache padded to ``max_len``, and return the last
    position's logits ``[B, Vp]`` and the cache (``len = S``)."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    cache = init_cache(cfg, b, max_len, device=tokens.device)

    def sink(i, k, v):
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v

    logits = _trunk(params, tokens, cfg, None, sink)
    cache["len"] = s
    return logits[:, -1], cache


@torch.inference_mode()
def decode_step(params: TransformerLM, cache: dict, tokens: torch.Tensor,
                cfg: LMConfig) -> tuple[torch.Tensor, dict]:
    """One token for every sequence in the batch (``tokens [B]``): returns
    ``(logits [B, Vp], cache)`` with the new keys and values written at
    position ``cache["len"]`` and ``len`` advanced by one.  The cache's
    tensors are updated in place (the reference donates them)."""
    _check_dense(cfg)
    cache_len = int(cache["len"])
    if cache_len >= cache["k"].shape[2]:
        raise ValueError(f"the cache is full ({cache_len} positions)")
    b = tokens.shape[0]
    x = params.embed[tokens]
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, torch.arange(
        cache_len, cache_len + 1, device=tokens.device))
    for i, p in enumerate(params.layers):
        h = rms_norm(x, p.ln_attn)
        q = (h @ p.wq).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        k = (h @ p.wk).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ p.wv).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)[:, 0]
        k = apply_rope(k, cos, sin)
        cache["k"][i, :, cache_len] = k[:, 0]
        cache["v"][i, :, cache_len] = v[:, 0]
        attn = gqa_decode_attention(q, cache["k"][i], cache["v"][i], cache_len + 1)
        x = x + attn.reshape(b, cfg.n_heads * cfg.head_dim) @ p.wo
        h2 = rms_norm(x, p.ln_mlp)
        x = x + (F.silu(h2 @ p.wi) * (h2 @ p.wg)) @ p.wo_mlp
    logits = rms_norm(x, params.ln_f) @ params.head
    return logits, {**cache, "len": cache_len + 1}
