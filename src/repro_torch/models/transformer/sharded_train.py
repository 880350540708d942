"""The LM's training loss over a mesh: the program the reference's GSPMD
makes of ``lm_loss`` with a ``Sharder`` on a mesh, run in one process
position by position (``models.transformer.model.lm_loss(..., shard=)``),
differentiable in each position's shards of the parameters.

The trunk is :mod:`.sharded`'s prefill code under autograd, laid out as
there (the residual stream over the data axes and whole along "model",
attention and FFN column- and row-parallel over "model", an MoE's experts
over "model"), with each layer's weights gathered over the data axes
(``Sharder.act``: FSDP's all-gather) inside the layer's checkpoint when
``cfg.remat``, so that the recompute of the backward gathers them again,
as XLA gathers inside the remat'd scan, and no gathered layer lives on
into the backward.  Every move is ``sharding.send``: the backward's
gradients go back by the dual collective (the gathers' by reduce-scatter)
and are reported as they move.

The loss keeps the logits vocabulary-split, ``act(logits, "batch", "seq",
"model")``: each position holds ``[b_g, S, Vp / M]``, the padding columns
``>= vocab_size`` set to ``-1e30`` in the logits' dtype in whichever
block they fall.  The log-sum-exp is split over "model" (the block's max
and ``pmax``, held constant as ``logsumexp`` holds it; ``exp`` and the
block's sum, ``psum``), the gold logit comes from the one block that holds
the label (``psum`` of the blocks' picks, all zero but one), and each data
group's negative log-likelihoods are summed once, at its "model" column 0,
and added at the mesh's first position with the token count (or the mask's
sum): the mean over the global tokens.  An MoE's balance term
(:func:`.moe.moe_apply_mesh` ``with_aux``) is summed over the layers there
and added as ``0.01 * aux``.  The one scalar differentiated lies at the
first position.  Under sequence parallelism the loss resolves the logits'
layout first, as prefill does (:mod:`.sharded`): ``DuplicateSpecError`` on
a mesh with "model", the step without the flag on one without.

Under ``train.loop.traced_layers(k)`` (the dry-run's trace) the trunk runs
its first ``k`` layers only and has the observer count layer
:data:`SCALED_LAYER` as each of the ``n_layers - k`` layers not run: every
layer has the same shapes and work, and layer 1 is a middle one, whose
forward adds its MoE term to the layers' sum (layer 0's starts it) and
whose backward adds its gradients to the buffers the last layer's
started.  Its forward is marked from before its weights are taken to
before the next layer's (``observe.note_stage``, ``note_repeat``); its
backward, with the checkpoint's recompute, by hooks on the last tensor
its forward made and on the last its predecessor made (the MoE sum, or
the last position's output): the autograd engine runs the nodes of one
graph task from the newest down, so the nodes between those two hooks
are the layer's forward's.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ...distributed.collectives import pmax, psum
from ...distributed.observe import note_repeat, note_stage
from ...distributed.sharding import NamedSharding, ShardedTensor, Sharder, \
    send, shard_bounds
from ...train.loop import scaled_layers
from ..common import rms_norm
from .attention import _NEG
from .rope import rope_freqs
from .sharded import (
    _embed,
    _ffn,
    _gathered,
    _gqa,
    _Layout,
    _layer_specs,
    _mla,
)

__all__ = ["SCALED_LAYER", "loss_on_mesh", "predicted_gathers"]

# what the loss writes over the vocabulary padding's logits
_NEG_LOGIT = -1e30
# the layer a trace under ``traced_layers`` counts for the layers not run
SCALED_LAYER = 1


def _as_sharded(shard, specs: dict, params) -> dict:
    """The reference's tree of ``ShardedTensor`` leaves laid out by
    ``specs``: ``params`` itself where its leaves are, a tree of whole
    tensors placed (``Sharder.place``)."""
    if not isinstance(params, dict):
        raise TypeError("the loss over a mesh takes the reference's tree of "
                        f"parameters, not a {type(params).__name__}")
    if isinstance(params["ln_f"], ShardedTensor):
        return params
    return shard.place(specs, params)


def _layer_of(layers: dict, i: int) -> dict:
    """Layer ``i`` of a tree of ``[L, ...]`` ``ShardedTensor`` leaves (the
    layer dim whole at every position): each position's shard indexed at
    ``i``."""
    def one(st):
        if isinstance(st, dict):
            return {k: one(v) for k, v in st.items()}
        sh = st.sharding
        return ShardedTensor(NamedSharding(sh.mesh, sh.spec[1:], sh.uneven),
                             st.shape[1:], tuple(s[i] for s in st.shards))
    return one(layers)


def _block(lay: _Layout, cfg, rope: dict, first: list, n_tokens: int,
           specs: dict, layer: dict, x: list) -> tuple[list, object]:
    """One layer over the positions: ``(x, aux)``, its weights gathered
    over the data axes here."""
    w = _gathered(lay, specs, layer)
    h = lay.each(lambda p, xp, ln: rms_norm(xp, ln), x, w["ln_attn"])
    attn, _ = (_mla if cfg.is_mla else _gqa)(lay, w, h, cfg, rope)
    x = lay.each(lambda p, xp, a: xp + a, x, attn)
    h2 = lay.each(lambda p, xp, ln: rms_norm(xp, ln), x, w["ln_mlp"])
    out, aux = _ffn(lay, w, h2, cfg, first, n_tokens, with_aux=True)
    return lay.each(lambda p, xp, o: xp + o, x, out), aux


def _nll_sums(lay: _Layout, cfg, logits: list, labels: list, mask: list | None
              ) -> tuple[list, list]:
    """Each data group's summed negative log-likelihood (masked) and its
    token count (the mask's sum), at its "model" column 0, from the
    vocabulary-split float32 logits ``[b_g, S, Vp / M]``."""
    width = cfg.padded_vocab // lay.n_cols

    def block_max(p, lf):
        if not lf.shape[-1]:
            return lf.new_full(lf.shape[:-1], _NEG)
        return lf.detach().amax(-1)
    top = pmax(lay.each(block_max, logits), lay.mesh, lay.model)
    sums = psum(lay.each(lambda p, lf, m: torch.exp(lf - m[..., None]).sum(-1),
                         logits, top), lay.mesh, lay.model)

    def pick(p, lf, lab):
        local = lab.long() - lay.col[p] * width
        inside = (local >= 0) & (local < lf.shape[-1])
        got = lf.gather(-1, local.clamp(0, max(lf.shape[-1] - 1, 0))[..., None])
        return torch.where(inside, got[..., 0], 0.0)
    gold = psum(lay.each(pick, logits, labels), lay.mesh, lay.model)
    totals, counts = [], []
    for p in lay.positions:
        if lay.col[p]:
            continue
        with lay.at(p):
            nll = top[p] + torch.log(sums[p]) - gold[p]
            if mask is None:
                totals.append((p, nll.sum()))
                counts.append((p, float(nll.numel())))
            else:
                mk = mask[p].float()
                totals.append((p, (nll * mk).sum()))
                counts.append((p, mk.sum()))
    return totals, counts


def loss_on_mesh(params, batch: dict, cfg, shard) -> torch.Tensor:
    """``lm_loss`` over ``shard.mesh`` (see the module docstring):
    ``params`` the reference's tree (layers stacked on ``[L]``) of
    ``ShardedTensor`` leaves laid out by ``lm_param_specs``, as the train
    step and ``restore_checkpoint(..., shardings=)`` hold them (a tree of
    whole tensors is placed first);
    ``batch`` ``tokens`` and ``labels`` ``[B, S]`` (and ``mask``, when
    given), whole or ``ShardedTensor`` leaves.  Returns the float32 loss,
    a scalar at the mesh's first position, differentiable in each
    position's shards."""
    from .model import lm_param_specs

    shard.named("batch", "seq", "model")    # as prefill_on_mesh
    lay = _Layout(shard)
    specs = lm_param_specs(cfg)
    tree = _as_sharded(shard, specs, params)
    tokens = shard.act(batch["tokens"], "batch", None)
    labels = shard.act(batch["labels"], "batch", None)
    mask = batch.get("mask")
    if mask is not None:
        mask = list(shard.act(mask, "batch", None).shards)
    b_all, s = tokens.shape
    first = [shard_bounds(b_all, lay.n_groups)[lay.group[p]][0] * s
             for p in lay.positions]
    rot = cfg.mla.qk_rope_head_dim if cfg.is_mla else cfg.head_dim
    rope = {}
    for dev in lay.devs:
        if dev not in rope:
            rope[dev] = rope_freqs(rot, cfg.rope_theta,
                                   torch.arange(s, device=dev))
    per_layer = _layer_specs(specs["layers"])

    embed = _gathered(lay, {"embed": specs["embed"]}, {"embed": tree["embed"]})
    x = _embed(lay, embed["embed"], specs["embed"], list(tokens.shards))
    del embed
    aux = None
    k = scaled_layers(cfg.n_layers)
    if k is not None and k < SCALED_LAYER + 2:
        raise ValueError(f"a trace of {k} layers has no middle layer to "
                         f"scale: trace at least {SCALED_LAYER + 2}")
    extra = 0 if k is None else cfg.n_layers - k
    for i in range(cfg.n_layers - extra):
        if extra and i == SCALED_LAYER:
            note_stage("layer")
        elif extra and i == SCALED_LAYER + 1:
            note_repeat("layer", extra)
        layer = _layer_of(tree["layers"], i)
        args = (lay, cfg, rope, first, b_all * s, per_layer, layer, x)
        if cfg.remat:
            x, a = checkpoint(_block, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _block(*args)
        if a is not None:
            aux = a if aux is None else aux + a
        # the last tensor this layer's forward made: the backward's mark
        last = aux if a is not None and i else x[-1]
        # each layer's term freed in its own layer, layer 0's (the sum's
        # start) in layer 1's: layer 1 leaves what every later one leaves
        del a
        if extra and i == SCALED_LAYER:
            last.register_hook(lambda _: note_stage("back"))
        elif extra and i == SCALED_LAYER - 1:
            last.register_hook(lambda _: note_repeat("back", extra))

    final = _gathered(lay, {"ln_f": specs["ln_f"], "head": specs["head"]},
                      {"ln_f": tree["ln_f"], "head": tree["head"]})
    width = cfg.padded_vocab // lay.n_cols

    def logits(p, xp, ln, head):
        lg = rms_norm(xp, ln) @ head
        cols = torch.arange(lay.col[p] * width, lay.col[p] * width
                            + lg.shape[-1], device=lg.device)
        return lg.masked_fill(cols >= cfg.vocab_size, _NEG_LOGIT).float()
    lf = lay.each(logits, x, final["ln_f"], final["head"])
    del x, final
    totals, counts = _nll_sums(lay, cfg, lf, list(labels.shards), mask)
    del lf
    home = totals[0][0]
    dev = lay.devs[home]
    with lay.at(home):
        total = count = None
        for (p, t), (_, c) in zip(totals, counts):
            t = send(t, p, home, "all-reduce", dev)
            if isinstance(c, torch.Tensor):
                c = send(c, p, home, "all-reduce", dev)
            total = t if total is None else total + t
            count = c if count is None else count + c
        if mask is None:
            loss = total / count
        else:
            loss = total / torch.clamp_min(count, 1.0)
        if aux is not None:
            # the balance term lies at the first group's column 0: here
            loss = loss + 0.01 * aux
    return loss


def predicted_gathers(cfg, mesh, batch: int, seq: int, n_micro: int) -> dict:
    """The all-gather and reduce-scatter bytes (received, summed over the
    positions) of one train step of ``cfg`` over ``mesh`` on ``batch`` x
    ``seq`` tokens in ``n_micro`` microbatches, as the specs imply them.
    Per microbatch, each position receives:

    * FSDP: of each leaf that ``lm_param_specs`` splits over the data axes,
      the part of its block along "model" that it does not hold (the
      gathered block less its shard), once for ``embed`` and ``head`` and,
      under ``cfg.remat``, twice for each layer's (the forward and the
      recompute), all-gathers; once each, the backward's reduce-scatters;
    * the activations gathered over "model" in each layer, the other
      columns' blocks of its group's rows: GQA's ``k`` and ``v``, MLA's
      ``q`` and ``kv`` latents (twice as all-gathers, once as the
      backward's reduce-scatters, GQA's only at positions whose column
      holds query heads, where MLA's ``wk_rope`` alone goes back);
    * an MoE's routing: the first choices of the other groups' tokens
      that share a dispatch with its group's, int64 (twice, as
      all-gathers; they take no gradient).

    Only gradients that exist go back: an MoE's experts at a data group
    with no tokens in a microbatch take none where the capacity's slots
    do not split over the groups."""
    from .model import _dt, lm_param_specs, param_shapes
    from .moe import SLAB, _capacity

    shard = Sharder.for_mesh(mesh)
    lay = _Layout(shard)
    isz = torch.empty((), dtype=_dt(cfg)).element_size()
    mb = batch // n_micro
    rows = [b - a for a, b in shard_bounds(mb, lay.n_groups)]
    specs, shapes = lm_param_specs(cfg), param_shapes(cfg)

    def fsdp(spec, shape_dtype, skip_layer: bool) -> list[int]:
        """Each position's bytes of one leaf's gather over the data axes."""
        shape, dtype = shape_dtype
        if skip_layer:
            spec, shape = spec[1:], shape[1:]
        named = shard.named(*spec)
        gathered = shard.named(*(None if a == "data" else a for a in spec))
        el = torch.empty((), dtype=dtype).element_size()
        size = lambda idx: math.prod(i.stop - i.start for i in idx)
        return [(size(gathered.shard_slices(p, shape))
                 - size(named.shard_slices(p, shape))) * el
                for p in lay.positions]

    def tree_sum(spec_tree, shape_tree, skip_layer) -> list[int]:
        out = [0] * mesh.size
        for k in spec_tree:
            got = tree_sum(spec_tree[k], shape_tree[k], skip_layer) \
                if isinstance(spec_tree[k], dict) \
                else fsdp(spec_tree[k], shape_tree[k], skip_layer)
            out = [a + b for a, b in zip(out, got)]
        return out
    top = sum(tree_sum({k: specs[k] for k in ("embed", "head", "ln_f")},
                       shapes, False))
    layers = dict(specs["layers"])
    experts = [0] * mesh.size
    if cfg.moe is not None:
        experts = tree_sum(layers.pop("moe"), shapes["layers"]["moe"], True)
    layer = sum(tree_sum(layers, shapes["layers"], True))
    # a position whose column holds no query heads attends with none: MLA's
    # k_rope there takes no gradient, nor does the gathered wk_rope
    heads = shard_bounds(cfg.n_heads, lay.n_cols)
    headless = [p for p in lay.positions
                if heads[lay.col[p]][0] == heads[lay.col[p]][1]]
    layer_rs = layer
    if cfg.is_mla:
        rope = fsdp(layers["wk_rope"], shapes["layers"]["wk_rope"], True)
        layer_rs -= sum(rope[p] for p in headless)
    # an MoE's experts at a group without tokens serve only the other
    # groups' slots, which it uses only where the slots split over the
    # groups: elsewhere their weights take no gradient, and nothing goes
    # back
    n_tok = mb * seq
    per = SLAB if n_tok > SLAB and n_tok % SLAB == 0 else n_tok
    split = cfg.moe is not None and lay.n_groups > 1 \
        and _capacity(per, cfg.moe) >= 1024
    back = sum(e for p, e in enumerate(experts)
               if rows[lay.group[p]] or split)
    if cfg.is_mla:
        widths = (cfg.mla.q_lora_rank, cfg.mla.kv_lora_rank)
    else:
        widths = (cfg.n_kv_heads * cfg.head_dim,) * 2
    # GQA's k and v are used only for a position's query heads: where its
    # column holds none (more columns than heads a layer, as on the
    # production meshes), they take no gradient and nothing goes back;
    # MLA's latents feed every column's block of the up-projections
    act_ag = act_rs = 0
    for p in lay.positions:
        for w in widths:
            a, b = shard_bounds(w, lay.n_cols)[lay.col[p]]
            got = (w - (b - a)) * rows[lay.group[p]] * seq * isz
            act_ag += got
            if cfg.is_mla or p not in headless:
                act_rs += got
    if not cfg.fsdp:
        for p in lay.positions:
            a, b = shard_bounds(cfg.d_model, lay.n_cols)[lay.col[p]]
            top += (cfg.d_model - (b - a)) * rows[lay.group[p]] * seq * isz
    route = 0
    if cfg.moe is not None:
        starts = [a * seq for a, _ in shard_bounds(mb, lay.n_groups)]
        spans = [(t0, t0 + r * seq) for t0, r in zip(starts, rows)]
        for p in lay.positions:
            t0, t1 = spans[lay.group[p]]
            if t1 == t0:
                continue
            lo, hi = t0 // per * per, -(-t1 // per) * per
            for h, (u0, u1) in enumerate(spans):
                if h != lay.group[p]:
                    route += max(0, min(hi, u1) - max(lo, u0)) \
                        * cfg.moe.top_k * 8
    passes = 2 if cfg.remat else 1
    per_micro_ag = top + cfg.n_layers * passes * (layer + sum(experts)
                                                  + act_ag + route)
    per_micro_rs = top + cfg.n_layers * (layer_rs + back + act_rs)
    return {"all-gather": n_micro * per_micro_ag,
            "reduce-scatter": n_micro * per_micro_rs}
