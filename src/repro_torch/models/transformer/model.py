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

The parameters take no gradient until asked (``params.requires_grad_()``,
which the train step does).  :func:`lm_loss` is the training loss: the
trunk with each block under ``torch.utils.checkpoint`` when ``cfg.remat``
(the reference's ``jax.checkpoint`` with nothing saveable), so the
attention's forward, K4 on the card, runs twice a step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from ..common import Split, cross_entropy, dense_init, rms_norm
from .attention import (
    gqa_attention_chunked,
    gqa_decode_attention,
    mla_attention,
    mla_decode_attention,
)
from .config import LMConfig
from .moe import MOE_KEYS, init_moe, moe_apply, moe_param_specs
from .rope import apply_rope, rope_freqs

__all__ = ["TransformerLM", "Block", "init_lm_params", "lm_forward",
           "lm_loss", "prefill", "decode_step", "init_cache", "layer_keys",
           "param_shapes", "lm_param_specs", "cache_shapes", "cache_specs"]

# what the loss writes over the vocabulary padding's logits
_NEG_LOGIT = -1e30


def layer_keys(cfg: LMConfig) -> tuple[str, ...]:
    """The names of a layer's tensors under ``cfg`` (an MoE layer's
    ``moe`` subtree holds :data:`~.moe.MOE_KEYS`)."""
    moe = ("moe",) if cfg.moe is not None else ()
    return ("ln_attn", "ln_mlp") + tuple(_matrix_shapes(cfg)) + moe


def _dt(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Block(nn.Module):
    """A layer's tensors under the reference's names, as parameters that
    take no gradient until asked; a nested dict (the ``moe`` subtree)
    becomes a sub-module of its own."""

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


def _matrix_shapes(cfg: LMConfig) -> dict[str, tuple[int, int]]:
    """A layer's ``[d_in, d_out]`` matrices in the order the initializer
    draws them: the attention's, then a dense FFN's (an MoE's experts are
    :func:`~.moe.init_moe`'s)."""
    d = cfg.d_model
    if cfg.is_mla:
        m, h = cfg.mla, cfg.n_heads
        out = {"wq_down": (d, m.q_lora_rank),
               "wq_up": (m.q_lora_rank,
                         h * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
               "wkv_down": (d, m.kv_lora_rank),
               "wk_rope": (d, m.qk_rope_head_dim),
               "wk_up": (m.kv_lora_rank, h * m.qk_nope_head_dim),
               "wv_up": (m.kv_lora_rank, h * m.v_head_dim),
               "wo": (h * m.v_head_dim, d)}
    else:
        hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        out = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d)}
    if cfg.moe is None:
        out.update(wi=(d, cfg.d_ff), wg=(d, cfg.d_ff), wo_mlp=(cfg.d_ff, d))
    return out


def _init_layer(gen: torch.Generator, cfg: LMConfig) -> dict:
    ks = Split(gen)
    d, dt, dev = cfg.d_model, _dt(cfg), gen.device
    p: dict = {"ln_attn": torch.ones((d,), dtype=dt, device=dev),
               "ln_mlp": torch.ones((d,), dtype=dt, device=dev)}
    for name, shape in _matrix_shapes(cfg).items():
        p[name] = dense_init(ks(), *shape, dtype=dt)
    if cfg.moe is not None:
        p["moe"] = init_moe(ks(), d, cfg.moe, dtype=dt)
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


def param_shapes(cfg: LMConfig) -> dict:
    """The reference's parameter tree as ``(shape, dtype)`` pairs, layers
    stacked on ``[L]``: what ``jax.eval_shape(init_lm_params)`` gives,
    allocating nothing."""
    d, L, dt = cfg.d_model, cfg.n_layers, _dt(cfg)
    layers = {name: ((L, *shape), dt)
              for name, shape in _matrix_shapes(cfg).items()}
    layers["ln_attn"] = layers["ln_mlp"] = ((L, d), dt)
    if cfg.moe is not None:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        layers["moe"] = {"w_router": ((L, d, e), torch.float32),
                         "wi": ((L, e, d, f), dt), "wg": ((L, e, d, f), dt),
                         "wo": ((L, e, f, d), dt)}
    return {"embed": ((cfg.padded_vocab, d), dt),
            "head": ((d, cfg.padded_vocab), dt), "ln_f": ((d,), dt),
            "layers": layers}


def lm_param_specs(cfg: LMConfig) -> dict:
    """Logical-axis tuples mirroring the reference's parameter tree (its
    ``lm_param_specs``): Megatron TP on 'model', and with ``cfg.fsdp`` the
    complementary dim over 'data'."""
    dp = "data" if cfg.fsdp else None
    if cfg.is_mla:
        attn = {"wq_down": (None, dp, "model"), "wq_up": (None, dp, "model"),
                "wkv_down": (None, dp, "model"), "wk_rope": (None, dp, None),
                "wk_up": (None, dp, "model"), "wv_up": (None, dp, "model"),
                "wo": (None, "model", dp)}
    else:
        attn = {"wq": (None, dp, "model"), "wk": (None, dp, "model"),
                "wv": (None, dp, "model"), "wo": (None, "model", dp)}
    if cfg.moe is not None:
        # one layer's specs under the stacked layer axis; with FSDP each
        # expert weight's d_model dim (wi's and wg's rows, wo's columns)
        # also over "data"
        ffn = {"moe": {}}
        for k, spec in moe_param_specs().items():
            spec = list(spec)
            if k != "w_router":
                spec[1 if k in ("wi", "wg") else 2] = dp
            ffn["moe"][k] = (None, *spec)
    else:
        ffn = {"wi": (None, dp, "model"), "wg": (None, dp, "model"),
               "wo_mlp": (None, "model", dp)}
    return {"embed": ("model", dp) if cfg.fsdp else (None, "model"),
            "head": (dp, "model"), "ln_f": (None,),
            "layers": {"ln_attn": (None, None), "ln_mlp": (None, None),
                       **attn, **ffn}}


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
           positions: torch.Tensor | None, sink, remat: bool = False
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logits [B, S, Vp], aux)`` over all positions, aux summed over
    the layers; ``sink(layer, cache)``, when given, receives each layer's
    cache entries.  ``remat`` runs each block under a non-reentrant
    ``checkpoint``: its activations are recomputed in the backward."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    rope = None if cfg.is_mla else rope_freqs(cfg.head_dim, cfg.rope_theta,
                                              positions)
    x = params.embed[tokens]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i, p in enumerate(params.layers):
        if remat:
            x, a, cache = checkpoint(_block, p, x, cfg, positions, rope,
                                     use_reentrant=False)
        else:
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


def lm_loss(params: TransformerLM, batch: dict, cfg: LMConfig,
            shard=None) -> torch.Tensor:
    """The reference's training loss: the trunk's logits with the
    vocabulary padding set to ``-1e30`` (in ``logits.dtype``), the float32
    token cross entropy against ``batch["labels"]`` (masked by
    ``batch["mask"]`` when given) plus ``0.01 * aux``.  Differentiable in
    the parameters once they take a gradient; ``cfg.remat`` checkpoints
    each block.  ``shard`` is a ``distributed.Sharder``: without a mesh it
    does nothing; on a mesh the loss runs over its positions
    (:func:`.sharded_train.loss_on_mesh`: ``params`` the reference's tree
    of ``ShardedTensor`` leaves, the logits vocabulary-split) and comes
    back as a float32 scalar at the mesh's first position."""
    if shard is not None and shard.mesh is not None:
        from .sharded_train import loss_on_mesh

        return loss_on_mesh(params, batch, cfg, shard)
    logits, aux = _trunk(params, batch["tokens"], cfg, None, None, cfg.remat)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = _NEG_LOGIT
    loss = cross_entropy(logits, batch["labels"], mask=batch.get("mask"))
    return loss + 0.01 * aux


def _cache_names(cfg: LMConfig) -> tuple[str, str]:
    return ("ckv", "krope") if cfg.is_mla else ("k", "v")


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """A zero cache: ``{"k", "v": [L, B, max_len, Hkv, hd], "len": 0}``, or
    for MLA the latents ``{"ckv": [L, B, max_len, kv_rank], "krope": [L, B,
    max_len, rope], "len": 0}``; ``len`` is a Python int."""
    dev = resolve_device(device)
    cache = {name: torch.zeros(shape, dtype=dtype or dt, device=dev)
             for name, (shape, dt) in cache_shapes(cfg, batch, max_len).items()
             if name != "len"}
    cache["len"] = 0
    return cache


def cache_shapes(cfg: LMConfig, batch: int, max_len: int) -> dict:
    """The reference's ``init_cache`` as ``(shape, dtype)`` pairs (its
    ``len`` an int32 scalar), allocating nothing."""
    dt, lead = _dt(cfg), (cfg.n_layers, batch, max_len)
    if cfg.is_mla:
        m = cfg.mla
        shapes = (lead + (m.kv_lora_rank,), lead + (m.qk_rope_head_dim,))
    else:
        shapes = (lead + (cfg.n_kv_heads, cfg.head_dim),) * 2
    out = {name: (shape, dt) for name, shape in zip(_cache_names(cfg), shapes)}
    out["len"] = ((), torch.int32)
    return out


def cache_specs(cfg: LMConfig) -> dict:
    """Logical shardings of the cache (the reference's ``cache_specs``:
    sequence over 'model' when ``cfg.seq_shard_attn_cache``)."""
    seq_ax = "model" if cfg.seq_shard_attn_cache else None
    rest = (None,) if cfg.is_mla else (None, None)
    out = {name: (None, "batch", seq_ax) + rest for name in _cache_names(cfg)}
    out["len"] = ()
    return out


@torch.inference_mode()
def prefill(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig,
            max_len: int, shard=None) -> tuple[torch.Tensor, dict]:
    """Run the prompts ``[B, S]`` through the trunk (logits over all
    positions, as the reference computes them), write each layer's cache
    entries into a cache padded to ``max_len``, and return the last
    position's logits ``[B, Vp]`` and the cache (``len = S``).

    ``shard`` is a ``distributed.Sharder``: on a mesh the trunk runs over
    its positions (:func:`.sharded.prefill_on_mesh`; ``params`` may then
    also be the reference's tree) and the logits and the cache's leaves
    come back as ``ShardedTensor`` leaves; without one it does nothing."""
    if shard is not None and shard.mesh is not None:
        from .sharded import prefill_on_mesh

        return prefill_on_mesh(params, tokens, cfg, max_len, shard)
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
                cfg: LMConfig, shard=None) -> tuple[torch.Tensor, dict]:
    """One token for every sequence in the batch (``tokens [B]``): returns
    ``(logits [B, Vp], cache)`` with the new cache entries written at
    position ``cache["len"]`` and ``len`` advanced by one.  The cache's
    tensors are updated in place (the reference donates them).

    ``shard`` is a ``distributed.Sharder``: on a mesh the step runs over
    its positions (:func:`.sharded.decode_on_mesh`; ``params`` may then
    also be the reference's tree, the cache's leaves ``ShardedTensor`` ones
    as prefill returns them) and the logits come back as a
    ``ShardedTensor``; without one it does nothing."""
    if shard is not None and shard.mesh is not None:
        from .sharded import decode_on_mesh

        return decode_on_mesh(params, cache, tokens, cfg, shard)
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
