"""The LM's prefill over a mesh: the program the reference's GSPMD makes
of ``prefill`` with a ``Sharder`` on a mesh, run in one process position
by position (``models.transformer.model.prefill(..., shard=)``).

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

Row-parallel products are summed in float32 and rounded once to the
model's dtype, as the unsharded product accumulates (on the card
``torch.mm(..., out_dtype=torch.float32)``, on the CPU a float32 product
of the widened operands).  The MoE balance term, which prefill discards, is not
computed.  Each position's work runs inside ``observe.at_position`` and
every move is reported, so the dry-run's cost model sees each position's
flops, bytes and collectives.  Sequence parallelism (``Sharder(
seq_parallel=True)``) is not ported.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ...device import on_device
from ...distributed.collectives import all_gather, axis_groups, psum, resplit
from ...distributed.observe import at_position
from ...distributed.sharding import ShardedTensor, shard_bounds
from ..common import rms_norm
from .attention import gqa_attention_chunked, gqa_attention_heads
from .moe import MOE_KEYS, moe_apply_mesh
from .rope import apply_rope, rope_freqs

__all__ = ["prefill_on_mesh"]


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


def _partial(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` accumulated and kept in float32: a row-parallel block's
    share of a sum."""
    if a.device.type == "cpu":
        return a.float() @ w.float()
    if a.dtype == torch.float32:
        return a @ w
    out = torch.mm(a.reshape(-1, a.shape[-1]), w, out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], w.shape[-1])


def _without_data(spec: tuple) -> tuple:
    return tuple(None if a == "data" else a for a in spec)


def _weights(lay: _Layout, spec_tree: dict, tree: dict) -> dict:
    """``tree``'s tensors placed by ``spec_tree`` and gathered over the data
    axes: name -> one tensor per position (a nested dict for the MoE)."""
    placed = lay.shard.place(spec_tree, tree)

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

    def lookup(p, t, tok):
        # the rows split evenly, as a parameter's must
        local = tok - lay.col[p] * t.shape[0]
        inside = (local >= 0) & (local < t.shape[0])
        rows = t[local.clamp(0, max(t.shape[0] - 1, 0))]
        return torch.where(inside[..., None], rows, rows.new_zeros(()))
    return psum(lay.each(lookup, table, tokens), lay.mesh, lay.model)


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
         n_tokens: int) -> list:
    if cfg.moe is None:
        hid = lay.each(lambda p, x, wi, wg: F.silu(x @ wi) * (x @ wg),
                       h2, w["wi"], w["wg"])
        parts = lay.each(lambda p, x, wo: _partial(x, wo), hid, w["wo_mlp"])
        return lay.reduce(parts, h2[0].dtype)
    d = cfg.d_model
    ps = [{k: w["moe"][k][p] for k in MOE_KEYS} for p in lay.positions]
    ys = moe_apply_mesh(ps, [x.reshape(-1, d) for x in h2], cfg.moe,
                        lay.mesh, model_axis=lay.model, first=first,
                        n_tokens=n_tokens)
    return [y.reshape(x.shape) for y, x in zip(ys, h2)]


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

    if shard.seq_parallel:
        raise NotImplementedError(
            "prefill with sequence parallelism over a mesh is not ported")
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
