"""xDeepFM over a mesh: the program the reference's GSPMD makes of
``xdeepfm_forward``, ``xdeepfm_loss`` and ``xdeepfm_score_candidates``
with a ``Sharder`` on a mesh, run in one process position by position and
differentiable in each position's shards of the parameters.

The reference's layout (``xdeepfm_param_specs``, the registry's cells):
``table`` and ``linear`` row-split over "model" and replicated over the
data axes, ``cin_w``, ``cin_out``, ``mlp`` and ``bias`` replicated; the
ids, the embedding and each CIN stack over "batch" (the data axes), whole
along "model".  A position is a (data group, "model" column) pair, a row
and an entry of ``axis_groups(mesh, "model")``.  The port does what GSPMD
does there:

* the lookups: vocabulary-parallel (``embedding.fused_field_lookup`` over
  a mesh: each position looks its group's ids up in its block of rows, and
  an all-reduce over "model" adds the columns' lookups, one of them
  non-zero), so that the embedding lies over "batch" as the reference's
  ``act(emb, "batch", None, None)`` lays it, with nothing more to move;
* the CIN, the MLP, the linear sum and the logits: at every position on
  its group's rows, the same at each of a group's columns, as GSPMD
  repeats work whose weights are replicated and whose activation is whole
  along "model";
* the loss: each group's BCE sum taken once, at its column 0, the groups'
  sums added at the mesh's first position in position order and divided
  by the global batch (``models.transformer.sharded_train``'s
  convention: the groups may be split unevenly, so their means are not
  averaged).  The one scalar differentiated lies there, so the backward
  reaches each group's column 0 and, back through the lookups'
  all-reduces, every block of the tables; the train step sums the
  replicas' partial gradients (``train.loop._reduce_replicas``);
* serving: the logits ``[B]`` over "batch", a ``ShardedTensor``;
* retrieval: the candidates over "batch", each data group scoring its own
  block in slabs of ``ceil(chunk / G)`` rows (``G`` data groups), as many
  slabs as the reference's ``ceil(n_cand / chunk)`` (a group's last slabs
  short or empty).  The s-th slabs of the groups are ``chunk`` candidates
  laid out over "batch", as each of the reference's slabs is, and no id
  or score moves; the scores lie over "batch".  The reference's
  ``lax.map(...).reshape(-1)`` leaves that layout to XLA; the values are
  the same, since each row's score depends on that row alone.

A block may be short or empty (GSPMD's ``ceil(n / k)`` a block), so the
math spells out its widths and sums where it would average.  Every move
is ``sharding.send``, so the backward moves each gradient back by the
dual collective.  The math is written once (``xdeepfm._logits``) against
the ops :class:`Whole` (one device) and :class:`OnMesh` (one value per
position, in position order).
"""
from __future__ import annotations

import torch

from ...device import on_device
from ...distributed.collectives import axis_groups, each_position
from ...distributed.observe import at_position
from ...distributed.sharding import ShardedTensor, Sharder, send
from ...train.checkpoint import tree_flatten, tree_map
from ..common import bce_terms, bce_with_logits

__all__ = ["OnMesh", "Whole", "mesh_ops", "predicted_moves"]


class Whole:
    """The ops of the unsharded forward: plain tensors on one device."""

    shard = None

    def params(self, params, specs):
        return params

    def rows(self, x, split: bool = True):
        return x

    def map(self, fn, *args):
        return fn(*args)

    def slab(self, cand, s: int, chunk: int):
        return cand[s * chunk:(s + 1) * chunk]

    def bce(self, logits, clicks) -> torch.Tensor:
        return bce_with_logits(logits, clicks)

    def result(self, x):
        return x


class OnMesh:
    """The ops over ``shard.mesh``: every value a list of one tensor per
    position (see the module docstring)."""

    def __init__(self, shard: Sharder):
        self.shard, self.mesh = shard, shard.mesh
        self.groups = axis_groups(self.mesh, shard.model_axis)
        self.devs = self.mesh.devices.ravel()

    def params(self, params, specs) -> list:
        """Each position's tree of ``params``' shards, a tree placed by
        ``specs`` first where its leaves are whole tensors."""
        if not isinstance(tree_flatten(params)[0][0], ShardedTensor):
            params = self.shard.place(specs, params)
        return [tree_map(lambda st: st.shards[p], params)
                for p in range(self.mesh.size)]

    def rows(self, x, split: bool = True) -> list:
        """Each position's block of ``x``'s rows over "batch"
        (``Sharder.act``), or, not ``split``, ``x`` whole at each."""
        first = "batch" if split else None
        return list(self.shard.act(x, first, *(None,) * (len(x.shape) - 1))
                    .shards)

    def map(self, fn, *args) -> list:
        """``fn`` at each position on its device, on the position's entry
        of each argument."""
        return each_position(self.mesh, fn, *args)

    def slab(self, cand: list, s: int, chunk: int) -> list:
        """Slab ``s`` at each position: rows ``[s c, (s + 1) c)`` of its
        group's block, ``c = ceil(chunk / G)``."""
        c = -(-chunk // len(self.groups))
        return [x[s * c:(s + 1) * c] for x in cand]

    def bce(self, logits: list, clicks: list) -> torch.Tensor:
        """The mean BCE over the global batch, a scalar at the first
        position: each group's sum at its column 0, added there in
        position order."""
        homes = [int(row[0]) for row in self.groups]
        sums = {}
        for h in homes:
            with on_device(self.devs[h]), at_position(h):
                sums[h] = bce_terms(logits[h], clicks[h]).sum()
        dev = self.devs[0]
        with on_device(dev), at_position(0):
            total = None
            for h in homes:
                t = send(sums[h], h, 0, "all-reduce", dev)
                total = t if total is None else total + t
            return total / sum(clicks[h].shape[0] for h in homes)

    def result(self, x: list) -> ShardedTensor:
        """Per-row values over "batch" as one ``ShardedTensor``."""
        n = sum(x[int(row[0])].shape[0] for row in self.groups)
        spec = self.shard.named("batch").fitted((n,))
        return ShardedTensor(spec, (n,), tuple(x))


def mesh_ops(shard: Sharder | None):
    """:class:`Whole` without a mesh, :class:`OnMesh` on one."""
    if shard is None or shard.mesh is None:
        return Whole()
    return OnMesh(shard)


def predicted_moves(cfg, shape, mesh) -> dict:
    """The all-reduce bytes (received, summed over the positions) of one
    xDeepFM step at ``cfg`` over ``mesh``, forward and backward, as the
    layout implies them; ``shape`` a registry shape name (its rows; a
    retrieval's padded as its cell pads them) or a ``(kind, rows)`` pair.
    With ``G`` data groups of ``M`` "model" columns:

    * each lookup (``table`` and ``linear``) of ``n`` rows of ``w`` bytes:
      ``2 (M - 1) n w``, each column's lookup to its group's column 0 and
      the sum back; a train step's backward ``(M - 1) n w`` more, the
      gradient from column 0 back to each column (no other column's
      logits reach the loss).  Retrieval's slabs add up to its rows;
    * a train step's loss: each group's sum to the first position and its
      gradient back, ``2 (G - 1)`` times 4 bytes;
    * its optimizer: each float32 gradient all-reduced over its replicas,
      the tables' blocks over the ``G`` groups (``2 (G - 1)`` times the
      tables' bytes) and the replicated nets over every position
      (``2 (GM - 1)`` times theirs), and the global norm's squares
      (``2 (GM - 1)`` times 4 bytes).
    """
    from ...configs.shapes import RECSYS_SHAPES, pad_to
    from .xdeepfm import init_xdeepfm

    if isinstance(shape, str):
        rows, kind = RECSYS_SHAPES[shape]
        if kind == "retrieval":
            rows = pad_to(rows)
    else:
        kind, rows = shape
    g, m = axis_groups(mesh, Sharder.for_mesh(mesh).model_axis).shape
    f32 = 4
    width = cfg.n_sparse * (cfg.embed_dim + 1) * f32
    moved = 2 * (m - 1) * rows * width
    if kind == "train":
        n = mesh.size
        params = init_xdeepfm(cfg, device="meta")
        tables = sum(params[k].numel() for k in ("table", "linear"))
        nets = sum(t.numel() for t in tree_flatten(params)[0]) - tables
        moved += (m - 1) * rows * width + 2 * (g - 1) * f32
        moved += 2 * (g - 1) * tables * f32 + 2 * (n - 1) * (nets + 1) * f32
    return {"all-reduce": moved}
