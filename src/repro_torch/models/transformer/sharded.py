"""The LM's prefill and decode over a mesh: the programs the reference's
GSPMD makes of ``prefill`` and ``decode_step`` with a ``Sharder`` on a
mesh, run in one process position by position
(``models.transformer.model.prefill(..., shard=)``, ``decode_step(...,
shard=)``).

A mesh position ``p`` is a (data group ``g``, "model" column ``m``) pair:
``axis_groups(mesh, "model")`` row ``g``, entry ``m``.  The parameters are
placed by ``lm_param_specs`` (:meth:`Sharder.place`) and each layer's are
gathered over the data axes where ``cfg.fsdp`` splits them (``Sharder.act``
of the spec without "data": the all-gather XLA makes inside the scan).
The activations follow the reference's ``shard.act`` calls:

* tokens and the residual stream ``x [b_g, S, d]``: the batch over the
  data axes, whole along "model" (``act(x, "batch", "seq", None)``);
* the embedding: ``embed`` is ``("model", dp)``, so each position looks up
  the tokens in its rows of the vocabulary and an all-reduce over "model"
  adds the positions' rows (one of them non-zero: exact);
* attention: q, k and v column-parallel; k and v all-gathered over
  "model" and rotated after the gather (rope pairs dims inside a head,
  which a column block may cut); q re-split to whole heads (``ceil(H /
  M)`` a position, the last short or empty: the uneven split of
  ``act(q, "batch", None, "model", None)``) and rotated there; K4 on each
  position's heads with the key/value heads they index; the output
  re-split to ``wo``'s row blocks where heads and rows do not line up
  (all-to-all), a float32 partial product and an all-reduce over "model";
* the FFN: ``wi`` and ``wg`` column-parallel, ``wo_mlp`` row-parallel with
  an all-reduce; an MoE by :func:`.moe.moe_apply_mesh`;
* the head: ``(dp, "model")``, vocabulary-split logits over all positions
  (``act(logits, "batch", "seq", "model")``), of which the last is kept;
* the cache: each position's block of ``cache_specs`` (the sequence over
  "model" where ``cfg.seq_shard_attn_cache``), padded to ``max_len``.

Decode (:func:`decode_on_mesh`) takes the cache laid out by ``cache_specs``
(what prefill returns) and follows the same rules for the one new token a
sequence; where the cache's sequence lies over "model"
(``cfg.seq_shard_attn_cache``, every arch's default) each position attends
all heads over its block of positions, the reference's ``act(scores,
"batch", None, None, "model")`` (MLA: ``("batch", None, "model")``), with
the softmax split over "model" (:func:`_split_softmax`).

Row-parallel products are summed in float32 and rounded once to the
model's dtype, as the unsharded product accumulates (on the card
``torch.mm(..., out_dtype=torch.float32)``, on the CPU a float32 product
of the widened operands; differentiable, for training's trunk in
:mod:`.sharded_train`).  The MoE balance term, which prefill and decode
discard, is computed only there (``_ffn(..., with_aux=True)``).  Each position's work runs inside ``observe.at_position`` and
every move is reported, so the dry-run's cost model sees each position's
flops, bytes and collectives.

Sequence parallelism (``Sharder.for_mesh(mesh, seq_parallel=True)``)
resolves ``"seq"`` to "model" where the mesh has that axis, so the
reference's logits layout ``act(logits, "batch", "seq", "model")`` names
"model" twice and jax refuses it (``DuplicateSpecError``): its prefill and
loss fail on such a mesh and its decode, which never resolves ``"seq"``,
runs unchanged.  The port does the same: prefill (and the loss) resolve
that layout before any work and raise :class:`DuplicateSpecError` there,
run as without the flag on a mesh without "model" (``"seq"`` resolves to
None), and decode ignores the flag.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...device import on_device
from ...core.butterfly import full_fp32_matmul
from ...distributed.collectives import (
    all_gather,
    axis_groups,
    pmax,
    psum,
    resplit,
    row_split_lookup,
)
from ...distributed.observe import at_position
from ...distributed.sharding import ShardedTensor, shard_bounds
from ..common import rms_norm
from .attention import (
    _NEG,
    attention_scale,
    gqa_attention_chunked,
    gqa_attention_heads,
    gqa_decode_attention,
    kv_heads_of,
)
from .moe import MOE_KEYS, moe_apply_mesh
from .rope import apply_rope, rope_freqs

__all__ = ["cache_len_of", "decode_on_mesh", "prefill_on_mesh"]


class _Layout:
    """Where each position sits: its data group and "model" column."""

    def __init__(self, shard):
        self.shard, self.mesh = shard, shard.mesh
        self.model = shard.model_axis
        self.devs = self.mesh.devices.ravel()
        rows = axis_groups(self.mesh, self.model)
        self.n_groups, self.n_cols = rows.shape
        self.group = [0] * self.mesh.size
        self.col = [0] * self.mesh.size
        for g, row in enumerate(rows):
            for m, p in enumerate(row):
                self.group[int(p)], self.col[int(p)] = g, m

    @property
    def positions(self) -> range:
        return range(self.mesh.size)

    @contextlib.contextmanager
    def at(self, p: int):
        with on_device(self.devs[p]), at_position(p):
            yield

    def each(self, fn, *lists) -> list:
        """``fn(p, *(l[p] for l in lists))`` at every position."""
        out = []
        for p in self.positions:
            with self.at(p):
                out.append(fn(p, *(lst[p] for lst in lists)))
        return out

    def heads(self, n: int) -> list[tuple[int, int]]:
        """Each position's ``[first, stop)`` of ``n`` heads split over
        "model" as an activation splits."""
        bounds = shard_bounds(n, self.n_cols)
        return [bounds[self.col[p]] for p in self.positions]

    def gather(self, xs: list) -> list:
        """Column blocks over "model" -> whole along the last dim."""
        return all_gather(xs, self.mesh, self.model, -1)

    def resplit(self, xs: list, sizes: list) -> list:
        """The last dim re-split over "model" to ``sizes`` (one per
        column)."""
        return resplit(xs, self.mesh, self.model, -1, sizes)

    def reduce(self, partials: list, dtype) -> list:
        """The all-reduce over "model" of float32 partials, rounded once to
        ``dtype``."""
        return self.each(lambda p, y: y.to(dtype),
                         psum(partials, self.mesh, self.model))


class _PartialMM(torch.autograd.Function):
    """``torch.mm(a, w, out_dtype=float32)`` of 2-d ``a`` and ``w`` in the
    model's dtype; the backward takes the float32 cotangent rounded to
    that dtype, as the unsharded product's backward sees it, and returns
    ``g wᵀ`` and ``aᵀ g`` in that dtype (each accumulated in float32 and
    rounded once)."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, w = ctx.saved_tensors
        g = grad.to(a.dtype)
        return g @ w.t(), a.t() @ g


def _partial(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` accumulated and kept in float32: a row-parallel block's
    share of a sum.  Differentiable."""
    if a.device.type == "cpu":
        return a.float() @ w.float()
    if a.dtype == torch.float32:
        return a @ w
    flat = a.reshape(-1, a.shape[-1])
    if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        out = _PartialMM.apply(flat, w)
    else:
        out = torch.mm(flat, w, out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], w.shape[-1])


def _without_data(spec: tuple) -> tuple:
    return tuple(None if a == "data" else a for a in spec)


def _weights(lay: _Layout, spec_tree: dict, tree: dict) -> dict:
    """``tree``'s tensors placed by ``spec_tree`` and gathered over the data
    axes: name -> one tensor per position (a nested dict for the MoE)."""
    return _gathered(lay, spec_tree, lay.shard.place(spec_tree, tree))


def _gathered(lay: _Layout, spec_tree: dict, placed: dict) -> dict:
    """``placed``'s ``ShardedTensor`` leaves (laid out by ``spec_tree``)
    gathered over the data axes: name -> one tensor per position (a nested
    dict for the MoE)."""
    def gather(spec, st):
        if isinstance(st, dict):
            return {k: gather(spec[k], v) for k, v in st.items()}
        return list(lay.shard.act(st, *_without_data(spec)).shards)
    return {k: gather(spec_tree[k], v) for k, v in placed.items()}


def _trees(params, cfg) -> tuple[dict, list[dict]]:
    """``(embed/head/ln_f, per-layer trees)`` of a ``TransformerLM`` or of
    the reference's tree (layers stacked on ``[L]``)."""
    from .model import TransformerLM, layer_keys

    if isinstance(params, TransformerLM):
        top = {k: getattr(params, k) for k in ("embed", "head", "ln_f")}
        layers = []
        for block in params.layers:
            t = {k: getattr(block, k) for k in layer_keys(cfg) if k != "moe"}
            if cfg.moe is not None:
                t["moe"] = {k: getattr(block.moe, k) for k in MOE_KEYS}
            layers.append(t)
        return top, layers

    def index(t, i):
        return {k: index(v, i) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return ({k: params[k] for k in ("embed", "head", "ln_f")},
            [index(params["layers"], i) for i in range(cfg.n_layers)])


def _layer_specs(specs: dict) -> dict:
    return {k: _layer_specs(v) if isinstance(v, dict) else v[1:]
            for k, v in specs.items()}


def _embed(lay: _Layout, table: list, spec: tuple, tokens: list) -> list:
    """The embedding lookup of each position's tokens from its block of
    the table: rows over "model" (a vocabulary-parallel lookup and an
    all-reduce) or columns over "model" (a local lookup and an
    all-gather)."""
    if spec[0] != "model":
        return lay.gather(lay.each(lambda p, t, tok: t[tok], table, tokens))
    return row_split_lookup(table, tokens, lay.mesh, lay.model)


def _gqa(lay: _Layout, w: dict, h: list, cfg, rope: dict):
    """Attention over the positions: ``(out, (k, v))``, ``k`` and ``v``
    each position's whole rotated keys and values."""
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = lay.each(lambda p, x, wq: x @ wq, h, w["wq"])
    k = lay.gather(lay.each(lambda p, x, wk: x @ wk, h, w["wk"]))
    v = lay.gather(lay.each(lambda p, x, wv: x @ wv, h, w["wv"]))
    heads = lay.heads(n_h)
    q = lay.resplit(q, [(b - a) * hd for a, b in
                        shard_bounds(n_h, lay.n_cols)])

    def attend(p, qp, kp, vp):
        b, s = qp.shape[:2]
        cos, sin = rope[lay.devs[p]]
        first, stop = heads[p]
        qp = apply_rope(qp.reshape(b, s, stop - first, hd), cos, sin)
        kp = apply_rope(kp.reshape(b, s, n_kv, hd), cos, sin)
        vp = vp.reshape(b, s, n_kv, hd)
        o = gqa_attention_heads(qp, kp, vp, first, n_h, chunk_q=cfg.attn_chunk_q,
                                chunk_k=cfg.attn_chunk_k)
        return o.reshape(b, s, (stop - first) * hd), (kp, vp)
    attn, cache = zip(*lay.each(attend, q, k, v))
    return _row_parallel(lay, list(attn), w["wo"], n_h * hd), list(cache)


def _mla(lay: _Layout, w: dict, h: list, cfg, rope: dict):
    """MLA over the positions: ``(out, (c_kv, k_rope))``, the latents
    whole at each position."""
    m, n_h = cfg.mla, cfg.n_heads
    nope, rot, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    sizes = shard_bounds(n_h, lay.n_cols)
    heads = lay.heads(n_h)
    q_lat = lay.gather(lay.each(lambda p, x, wd: x @ wd, h, w["wq_down"]))
    q = lay.resplit(lay.each(lambda p, x, wu: x @ wu, q_lat, w["wq_up"]),
                    [(b - a) * (nope + rot) for a, b in sizes])
    ckv = lay.gather(lay.each(lambda p, x, wd: x @ wd, h, w["wkv_down"]))
    k_nope = lay.resplit(lay.each(lambda p, c, wu: c @ wu, ckv, w["wk_up"]),
                         [(b - a) * nope for a, b in sizes])
    v = lay.resplit(lay.each(lambda p, c, wu: c @ wu, ckv, w["wv_up"]),
                    [(b - a) * dv for a, b in sizes])

    def attend(p, x, qp, kp, vp, wr, c):
        b, s = x.shape[:2]
        nh = heads[p][1] - heads[p][0]
        cos, sin = rope[lay.devs[p]]
        q_nope, q_rope = torch.split(qp.reshape(b, s, nh, nope + rot),
                                     [nope, rot], dim=-1)
        q_rope = apply_rope(q_rope, cos, sin)
        k_rope = apply_rope((x @ wr).reshape(b, s, 1, rot), cos, sin)
        if nh:
            qf = torch.cat([q_nope, q_rope], dim=-1)
            kf = torch.cat([kp.reshape(b, s, nh, nope),
                            k_rope.expand(b, s, nh, rot)], dim=-1)
            o = gqa_attention_chunked(qf, kf, vp.reshape(b, s, nh, dv),
                                      chunk_q=cfg.attn_chunk_q,
                                      chunk_k=cfg.attn_chunk_k)
        else:
            o = x.new_empty((b, s, 0, dv))
        return o.reshape(b, s, nh * dv), (c, k_rope[:, :, 0, :])
    attn, cache = zip(*lay.each(attend, h, q, k_nope, v, w["wk_rope"], ckv))
    return _row_parallel(lay, list(attn), w["wo"], n_h * dv), list(cache)


def _row_parallel(lay: _Layout, xs: list, wo: list, n: int) -> list:
    """``xs`` (each position's columns of an ``n``-wide activation) moved to
    ``wo``'s row blocks, times ``wo``, summed over "model"."""
    xs = lay.resplit(xs, [b - a for a, b in shard_bounds(n, lay.n_cols)])
    parts = lay.each(lambda p, x, w: _partial(x, w), xs, wo)
    return lay.reduce(parts, xs[0].dtype)


def _ffn(lay: _Layout, w: dict, h2: list, cfg, first: list,
         n_tokens: int, with_aux: bool = False):
    """The FFN over the positions; with ``with_aux`` ``(out, aux)``, aux
    an MoE's balance term (None for a dense FFN)."""
    if cfg.moe is None:
        hid = lay.each(lambda p, x, wi, wg: F.silu(x @ wi) * (x @ wg),
                       h2, w["wi"], w["wg"])
        parts = lay.each(lambda p, x, wo: _partial(x, wo), hid, w["wo_mlp"])
        out = lay.reduce(parts, h2[0].dtype)
        return (out, None) if with_aux else out
    d = cfg.d_model
    ps = [{k: w["moe"][k][p] for k in MOE_KEYS} for p in lay.positions]
    ys = moe_apply_mesh(ps, [x.reshape(-1, d) for x in h2], cfg.moe,
                        lay.mesh, model_axis=lay.model, first=first,
                        n_tokens=n_tokens, with_aux=with_aux)
    ys, aux = ys if with_aux else (ys, None)
    out = [y.reshape(x.shape) for y, x in zip(ys, h2)]
    return (out, aux) if with_aux else out


def prefill_on_mesh(params, tokens: torch.Tensor, cfg, max_len: int, shard
                    ) -> tuple[ShardedTensor, dict]:
    """``prefill`` over ``shard.mesh`` (see the module docstring):
    ``params`` a ``TransformerLM`` or the reference's tree of tensors,
    whole; ``tokens [B, S]`` whole.  Returns the last position's logits
    ``[B, Vp]`` and the cache's leaves as a :class:`ShardedTensor` each, laid
    out by the cell's out specs (``("batch", "model")``, ``cache_specs``;
    split unevenly where a dim does not divide), with ``len = S``."""
    from .model import _cache_names, _dt, cache_shapes, cache_specs, \
        lm_param_specs

    # the logits' layout, resolved first as the reference's trace resolves
    # it: DuplicateSpecError under sequence parallelism on a "model" axis
    shard.named("batch", "seq", "model")
    lay = _Layout(shard)
    b_all, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    tok = shard.act(tokens, "batch", None).shards
    first = [shard_bounds(b_all, lay.n_groups)[lay.group[p]][0] * s
             for p in lay.positions]
    top, layers = _trees(params, cfg)
    specs = lm_param_specs(cfg)
    per_layer = _layer_specs(specs["layers"])
    rot = cfg.mla.qk_rope_head_dim if cfg.is_mla else cfg.head_dim
    rope = {}
    for dev in lay.devs:
        if dev not in rope:
            rope[dev] = rope_freqs(rot, cfg.rope_theta,
                                   torch.arange(s, device=dev))

    embed = _weights(lay, {"embed": specs["embed"]}, {"embed": top["embed"]})
    x = _embed(lay, embed["embed"], specs["embed"], list(tok))
    del embed
    # the cache: each position's block of cache_specs, zero past S
    names = _cache_names(cfg)
    shapes = cache_shapes(cfg, b_all, max_len)
    layout, cache = {}, {}
    for name in names:
        sharding = shard.named(*cache_specs(cfg)[name]).fitted(
            shapes[name][0])
        layout[name] = sharding
        cache[name] = []
        for p in lay.positions:
            idx = sharding.shard_slices(p, shapes[name][0])
            with lay.at(p):
                cache[name].append(torch.zeros(
                    tuple(i.stop - i.start for i in idx), dtype=_dt(cfg),
                    device=lay.devs[p]))

    for i, tree in enumerate(layers):
        w = _weights(lay, per_layer, tree)
        h = lay.each(lambda p, xp, ln: rms_norm(xp, ln), x, w["ln_attn"])
        attn, kv = (_mla if cfg.is_mla else _gqa)(lay, w, h, cfg, rope)
        x = lay.each(lambda p, xp, a: xp + a, x, attn)
        h2 = lay.each(lambda p, xp, ln: rms_norm(xp, ln), x, w["ln_mlp"])
        out = _ffn(lay, w, h2, cfg, first, b_all * s)
        x = lay.each(lambda p, xp, o: xp + o, x, out)
        for j, name in enumerate(names):
            for p in lay.positions:
                seq = layout[name].shard_slices(p, shapes[name][0])[2]
                lo, hi = seq.start, min(seq.stop, s)
                if hi > lo:
                    with lay.at(p):
                        cache[name][p][i, :, :hi - lo] = kv[p][j][:, lo:hi]
        del w, h, attn, kv, h2, out

    final = _weights(lay, {"ln_f": specs["ln_f"], "head": specs["head"]},
                     {"ln_f": top["ln_f"], "head": top["head"]})

    def last_logits(p, xp, ln, head):
        # all positions' logits, as the reference computes them; the last
        # row kept (a copy, so that the rest is freed)
        return (rms_norm(xp, ln) @ head)[:, -1].clone()
    last = lay.each(last_logits, x, final["ln_f"], final["head"])
    shape = (b_all, cfg.padded_vocab)
    out_sharding = shard.named("batch", "model").fitted(shape)
    out = {name: ShardedTensor(layout[name], shapes[name][0],
                               tuple(cache[name])) for name in names}
    out["len"] = s
    return ShardedTensor(out_sharding, shape, tuple(last)), out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def cache_len_of(length, max_len: int) -> int:
    """The cache's ``len`` as an int: a Python int, or a scalar tensor (or a
    ``ShardedTensor`` of one) read on its device.  On ``meta`` it has no
    value, and the dry-run's trace takes the stand-in ``max_len - 1``, the
    last slot: the step with the most positions to attend."""
    if isinstance(length, ShardedTensor):
        length = length.shards[0]
    if isinstance(length, torch.Tensor) and length.device.type == "meta":
        return max_len - 1
    return int(length)


def _decode_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  first: int, n_heads: int, length: int) -> torch.Tensor:
    """:func:`.attention.gqa_decode_attention` of query heads ``first ..
    first + h`` of ``n_heads`` (``q [b, h, hd]``) against the whole cache
    ``k``, ``v [b, S, Hkv, hd]`` (:func:`.attention.kv_heads_of`)."""
    b, h, _ = q.shape
    if h == 0:
        return q.new_empty((b, 0, v.shape[3]))
    return gqa_decode_attention(q, *kv_heads_of(k, v, first, h, n_heads),
                                length)


class _Step(NamedTuple):
    """What every layer of one decode step shares: the slot written, each
    device's rope tables for it, each position's mask of the cache's
    positions past the new entry (its block, or the whole sequence), and
    whether the cache's sequence lies over "model"."""
    slot: int
    rope: dict
    masks: list
    seq: bool


def _split_softmax(lay: _Layout, scores: list) -> list:
    """The softmax over the last dim of scores split over "model" (each
    position's float32 block): the block's max, ``pmax``; ``exp``, the
    block's sum, ``psum``; ``e / sum``: the reference's softmax, its sum
    added block by block.  An empty block adds nothing."""
    def block_max(p, s):
        return s.amax(-1) if s.shape[-1] else s.new_full(s.shape[:-1], _NEG)
    top = pmax(lay.each(block_max, scores), lay.mesh, lay.model)
    e = lay.each(lambda p, s, m: torch.exp(s - m[..., None]), scores, top)
    total = psum(lay.each(lambda p, x: x.sum(-1), e), lay.mesh, lay.model)
    return lay.each(lambda p, x, t: x / t[..., None], e, total)


def _own_rows(lay: _Layout, xs: list, wo: list, dtype) -> list:
    """``xs`` whole at every position times ``wo`` row-parallel: each
    position's row block (``wo``'s rows split evenly over "model"), a
    float32 partial, summed over "model" and rounded once to ``dtype``."""
    bounds = shard_bounds(xs[0].shape[-1], lay.n_cols)

    def part(p, x, w):
        lo, hi = bounds[lay.col[p]]
        return _partial(x[..., lo:hi], w)
    return lay.reduce(lay.each(part, xs, wo), dtype)


def _write(lay: _Layout, leaf, i: int, slot: int, new: list) -> None:
    """Layer ``i``'s entry at ``slot`` of ``leaf`` (a ``ShardedTensor``
    ``[L, B, S, ...]``) from ``new[p]`` ``[b_g, ...]``, in place at each
    position whose block of the sequence holds the slot."""
    for p in lay.positions:
        seq = leaf.sharding.shard_slices(p, leaf.shape)[2]
        if seq.start <= slot < seq.stop:
            with lay.at(p):
                shard = leaf.shards[p]
                shard[i, :, slot - seq.start] = new[p].to(shard.dtype)


def _gqa_decode(lay: _Layout, w: dict, h: list, cfg, cache: dict, i: int,
                at: _Step) -> list:
    """Layer ``i``'s attention for one token a sequence over the positions:
    the new k and v written at ``at.slot``; ``at.seq`` (the cache's
    sequence over "model"): all heads against each position's block with
    the softmax split over "model"; else each position's heads against the
    whole cache."""
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    seq = at.seq
    q = lay.each(lambda p, x, wq: x @ wq, h, w["wq"])
    k = lay.gather(lay.each(lambda p, x, wk: x @ wk, h, w["wk"]))
    v = lay.gather(lay.each(lambda p, x, wv: x @ wv, h, w["wv"]))
    heads = [(0, n_h)] * lay.mesh.size if seq else lay.heads(n_h)
    q = lay.gather(q) if seq else lay.resplit(
        q, [(b - a) * hd for a, b in shard_bounds(n_h, lay.n_cols)])

    def rotate(p, qp, kp):
        b = qp.shape[0]
        cos, sin = at.rope[lay.devs[p]]
        first, stop = heads[p]
        qp = apply_rope(qp.reshape(b, 1, stop - first, hd), cos, sin)[:, 0]
        kp = apply_rope(kp.reshape(b, 1, n_kv, hd), cos, sin)[:, 0]
        return qp, kp
    q, k = map(list, zip(*lay.each(rotate, q, k)))
    v = [x.reshape(x.shape[0], n_kv, hd) for x in v]
    kc, vc = cache["k"], cache["v"]
    _write(lay, kc, i, at.slot, k)
    _write(lay, vc, i, at.slot, v)
    if not seq:
        attn = lay.each(lambda p, qp, kp, vp: _decode_heads(
            qp, kp[i], vp[i], heads[p][0], n_h, at.slot + 1).reshape(
                qp.shape[0], qp.shape[1] * hd), q, kc.shards, vc.shards)
        return _row_parallel(lay, attn, w["wo"], n_h * hd)

    scale = attention_scale(hd)

    def scores(p, qp, kp):
        qg = qp.reshape(qp.shape[0], n_kv, n_h // n_kv, hd).float()
        with full_fp32_matmul():
            s = torch.einsum("bhgd,bshd->bhgs", qg, kp[i].float())
        return (s * scale).masked_fill_(at.masks[p], _NEG)

    def attend(p, pr, vp):
        with full_fp32_matmul():
            o = torch.einsum("bhgs,bshd->bhgd", pr, vp[i].float())
        return o.reshape(o.shape[0], n_h * hd)
    probs = _split_softmax(lay, lay.each(scores, q, kc.shards))
    out = psum(lay.each(attend, probs, vc.shards), lay.mesh, lay.model)
    out = lay.each(lambda p, o: o.to(h[0].dtype), out)
    return _own_rows(lay, out, w["wo"], h[0].dtype)


def _mla_decode(lay: _Layout, w: dict, h: list, cfg, cache: dict, i: int,
                at: _Step) -> list:
    """Layer ``i``'s absorbed MLA decode over the positions
    (:func:`.attention.mla_decode_attention`): the latents ``c_kv`` and the
    rotated ``k_rope`` written at ``at.slot``; ``wk_up`` and ``wv_up``
    gathered whole over "model"; ``at.seq``: ``q_abs`` and ``q_rope`` of
    all heads against each position's block with the softmax split over
    "model", ``out_lat`` summed over "model"; else each position's heads
    against the whole cache."""
    m, n_h = cfg.mla, cfg.n_heads
    nope, rot, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    r = m.kv_lora_rank
    seq = at.seq
    q_lat = lay.gather(lay.each(lambda p, x, wd: x @ wd, h, w["wq_down"]))
    q = lay.gather(lay.each(lambda p, x, wu: x @ wu, q_lat, w["wq_up"]))
    ckv = lay.gather(lay.each(lambda p, x, wd: x @ wd, h, w["wkv_down"]))
    wk_up, wv_up = lay.gather(w["wk_up"]), lay.gather(w["wv_up"])
    heads = [(0, n_h)] * lay.mesh.size if seq else lay.heads(n_h)

    def queries(p, x, qp, wr, wk):
        b = x.shape[0]
        cos, sin = at.rope[lay.devs[p]]
        first, stop = heads[p]
        q_nope, q_rope = torch.split(qp.reshape(b, n_h, nope + rot)[
            :, first:stop], [nope, rot], dim=-1)
        q_rope = apply_rope(q_rope[:, None], cos, sin)[:, 0]
        k_rope = apply_rope((x @ wr).reshape(b, 1, 1, rot), cos, sin)[:, 0, 0]
        wk = wk.reshape(r, n_h, nope)[:, first:stop].float()
        with full_fp32_matmul():
            q_abs = torch.einsum("bhn,rhn->bhr", q_nope.float(), wk)
        return q_abs, q_rope.float(), k_rope
    q_abs, q_rope, k_rope = map(list, zip(*lay.each(
        queries, h, q, w["wk_rope"], wk_up)))
    cc, kr = cache["ckv"], cache["krope"]
    _write(lay, cc, i, at.slot, ckv)
    _write(lay, kr, i, at.slot, k_rope)
    scale = attention_scale(nope + rot)

    def scores(p, qa, qr, cp, kp):
        with full_fp32_matmul():
            s = torch.einsum("bhr,bsr->bhs", qa, cp[i].float()) + torch.einsum(
                "bhr,bsr->bhs", qr, kp[i].float())
        return (s * scale).masked_fill_(at.masks[p], _NEG)
    s = lay.each(scores, q_abs, q_rope, cc.shards, kr.shards)
    probs = _split_softmax(lay, s) if seq else lay.each(
        lambda p, x: torch.softmax(x, dim=-1), s)

    def latent(p, pr, cp):
        with full_fp32_matmul():
            return torch.einsum("bhs,bsr->bhr", pr, cp[i].float())
    out_lat = lay.each(latent, probs, cc.shards)
    if seq:
        out_lat = psum(out_lat, lay.mesh, lay.model)

    def values(p, ol, wv):
        first, stop = heads[p]
        wv = wv.reshape(r, n_h, dv)[:, first:stop].float()
        with full_fp32_matmul():
            o = torch.einsum("bhr,rhv->bhv", ol, wv)
        return o.reshape(o.shape[0], (stop - first) * dv).to(h[0].dtype)
    out = lay.each(values, out_lat, wv_up)
    if seq:
        return _own_rows(lay, out, w["wo"], h[0].dtype)
    return _row_parallel(lay, out, w["wo"], n_h * dv)


def decode_on_mesh(params, cache: dict, tokens, cfg, shard
                   ) -> tuple[ShardedTensor, dict]:
    """``decode_step`` over ``shard.mesh`` (see the module docstring):
    ``params`` a ``TransformerLM`` or the reference's tree of tensors,
    whole; ``cache`` laid out by ``cache_specs`` (a ``ShardedTensor`` a
    leaf, what :func:`prefill_on_mesh` returns; a whole tensor is placed by
    ``Sharder.act``), its leaves written in place; ``tokens [B]`` whole.
    Returns the logits ``[B, Vp]`` (``("batch", "model")``) and the cache
    with ``len`` advanced by one."""
    from .model import _cache_names, cache_specs, lm_param_specs

    lay = _Layout(shard)
    names = _cache_names(cfg)
    specs_c = cache_specs(cfg)
    placed = {name: shard.act(cache[name], *specs_c[name]) for name in names}
    max_len = placed[names[0]].shape[2]
    slot = cache_len_of(cache["len"], max_len)
    if slot >= max_len:
        raise ValueError(f"the cache is full ({slot} positions)")
    b_all = tokens.shape[0]
    tok = shard.act(tokens, "batch").shards
    first = [shard_bounds(b_all, lay.n_groups)[lay.group[p]][0]
             for p in lay.positions]
    top, layers = _trees(params, cfg)
    specs = lm_param_specs(cfg)
    per_layer = _layer_specs(specs["layers"])
    rot = cfg.mla.qk_rope_head_dim if cfg.is_mla else cfg.head_dim
    rope = {}
    for dev in lay.devs:
        if dev not in rope:
            rope[dev] = rope_freqs(rot, cfg.rope_theta, torch.arange(
                slot, slot + 1, device=dev))
    leaf = placed[names[0]]

    def past(p, _):
        seq = leaf.sharding.shard_slices(p, leaf.shape)[2]
        return torch.arange(seq.start, seq.stop, device=lay.devs[p]) > slot
    at = _Step(slot, rope, lay.each(past, lay.positions),
               cfg.seq_shard_attn_cache)

    embed = _weights(lay, {"embed": specs["embed"]}, {"embed": top["embed"]})
    x = _embed(lay, embed["embed"], specs["embed"], list(tok))
    del embed
    for i, tree in enumerate(layers):
        w = _weights(lay, per_layer, tree)
        h = lay.each(lambda p, xp, ln: rms_norm(xp, ln), x, w["ln_attn"])
        attn = (_mla_decode if cfg.is_mla else _gqa_decode)(
            lay, w, h, cfg, placed, i, at)
        x = lay.each(lambda p, xp, a: xp + a, x, attn)
        h2 = lay.each(lambda p, xp, ln: rms_norm(xp, ln), x, w["ln_mlp"])
        out = _ffn(lay, w, h2, cfg, first, b_all)
        x = lay.each(lambda p, xp, o: xp + o, x, out)
        del w, h, attn, h2, out

    final = _weights(lay, {"ln_f": specs["ln_f"], "head": specs["head"]},
                     {"ln_f": top["ln_f"], "head": top["head"]})
    logits = lay.each(lambda p, xp, ln, head: rms_norm(xp, ln) @ head,
                      x, final["ln_f"], final["head"])
    shape = (b_all, cfg.padded_vocab)
    out_sharding = shard.named("batch", "model").fitted(shape)
    return ShardedTensor(out_sharding, shape, tuple(logits)), \
        {**placed, "len": slot + 1}
